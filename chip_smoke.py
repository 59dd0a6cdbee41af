#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card (an H100) end to end.

    python3 chip_smoke.py            # from the repository root

Phases, one flushed line each with the elapsed seconds:
  1. build: one nvcc call compiles every kernel source (csrc/*.cu);
  2. kernel checks: every kernel instantiation on the main path (and the
     survey scorer's, off it) against its plain PyTorch version on the card,
     at the full shared-set shapes (128 instances of 4-SAT, n=100,
     alpha=9: E=524,288 padded / 460,800 real edges, V=16,384). Flags and
     counts must match exactly, float sums to rtol 1e-5 / atol 1e-6 (the
     plain version sums in another order), walksat_block bit for bit for
     eps=-1 and eps=0.5; each is then timed (CUDA events) beside its plain
     version and its bound;
     The [E, d] segment sum and gather of the neural modules (kernels 6
     and 7) are checked at the np-nd-np shapes (d = 50): the sum to rtol
     1e-5 / atol 1e-5 (the plain index_add_ on the card sums in atomic
     order), the gather and the gather-minus-self bit for bit;
  3. p-d-p path: compacting_solve at the headline settings (tolerance
     0.08, t_max 50, 1000 iterations, 1000 WalkSAT flips, restart schedule
     0.35/0.35/0.3, chunk 50, simplify_rounds 1) on the shared set
     (fingerprint d3cba04af19db12d), every solution verified with numpy
     against its CNF; the solved fraction must be >= 0.60 and every kernel
     of the path launched at least once;
  4. np-nd-np path: compacting_solve with the trained r3 checkpoint at
     full width (hidden 150; 1000 iterations, 1000 WalkSAT flips, chunk
     50) on the same set, every solution verified with numpy; the solved
     fraction must be >= 0.45 and kernels 6 and 7 launched at least once;
  5. the {"kernels": [...]} line, the card's name and power limit, and as
     the last line {"ok": true, "device": {...}}.

Every launch count is set to 0 just before each path and read just after
it; a kernel's row carries the count of the path it serves.

Any failure exits non-zero without the last line. Without a CUDA card, or
run outside the repository, it exits 2 and prints no result.
"""

import json
import os
import subprocess
import sys
import time

T0 = time.time()
ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and f32 (non-tensor)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# the JAX package's records at the headline settings: 70.1% (seeds
# 69.5-71.1%); the port draws other random message inits
MIN_SOLVED = 0.60
# np-nd-np with the r3 weights: the JAX records are 0.516-0.602 (seeds 0-2,
# docs/r5_solver_table.json); WalkSAT from a random fill alone solves 0.117
MIN_SOLVED_NEURAL = 0.45
REDUCE2D_TOL = dict(rtol=1e-5, atol=1e-5)
HIDDEN_AGG = 50      # np-nd-np's mem_agg_hidden_dim: the width kernels 6/7 see
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)
# functors whose outputs are flags or small integer counts
EXACT_FNS = {"em_ae", "em", "ae", "sround", "cnf_chain", "ws_chain"}
PALLAS_FUSED = "pdp_solver_tpu/ops/pallas_fused.py"
PALLAS_2D = "pdp_solver_tpu/ops/pallas_reduce2d.py"


def log(msg):
    print(f"[chip_smoke {time.time() - T0:8.2f}s] {msg}", flush=True)


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def fn_inputs(fn, batch, seed):
    """Seeded inputs at the batch's shapes, each drawn like the column its
    name says it is (0/1 masks are 0 on padding)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    sizes = {"V": batch.num_vars, "F": batch.num_clauses,
             "E": batch.num_edges}
    real = {"V": batch.var_mask, "F": batch.clause_mask,
            "E": batch.edge_mask}
    out = []
    for kind, name in zip(fn.layout, fn.inputs):
        u = torch.rand(sizes[kind], generator=g).to(batch.device)
        if name == "sign":
            x = batch.edge_sign
        elif name in ("mask", "bmask"):
            x = batch.edge_mask
        elif name in ("force", "sa"):
            x = torch.where(u > 0.5, 1.0, -1.0) * real[kind]
        elif name in ("em", "av", "abv", "ac", "cm"):
            x = (u > 0.2).float() * real[kind]
        elif name == "sol":
            x = torch.floor(u * 3.0) / 2.0
        elif name in ("pos", "neg"):
            x = -5.0 * u
        else:
            x = u * 0.96 + 0.02
        out.append(x.contiguous())
    return out


def fused_bytes(fn, batch, chained):
    sizes = {"V": batch.num_vars, "F": batch.num_clauses,
             "E": batch.num_edges}
    E, V, F, B = (batch.num_edges, batch.num_vars, batch.num_clauses,
                  batch.batch_size)
    n = sum(sizes[k] for k in fn.layout) * 4
    if chained:
        n += 2 * E * 4                              # edge_var, edge_clause
        n += F * 4 if fn.n_ired else 0              # clause_batch
        n += (fn.n_cout * F + fn.n_vred * V + fn.n_eout * E
              + fn.n_ired * B) * 4
    else:
        uses_v = "V" in fn.layout or fn.side == "var"
        uses_f = "F" in fn.layout or fn.side == "clause"
        n += (uses_v + uses_f) * E * 4
        seg = {"var": V, "clause": F, "none": 0}[fn.side]
        n += (fn.n_red * seg + fn.n_eout * E) * 4
    return n


def check_kernels(batch, torch, np):
    from pdp_solver_tpu_torch.ops import fused, walksat
    rows = {}
    for fn in fused.FUSED_FNS + fused.CHAINED_FNS:
        chained = fn in fused.CHAINED_FNS
        call = fused.chained_edge_pass if chained else fused.fused_edge_pass
        plain = (fused.chained_edge_pass_plain if chained
                 else fused.fused_edge_pass_plain)
        ins = fn_inputs(fn, batch, seed=len(rows) + 1)
        ref = plain(fn, batch, ins)
        got = call(fn, batch, ins)
        torch.cuda.synchronize()
        err = 0.0
        refs, gots = [], []
        for r, o in zip(ref, got):
            if isinstance(r, tuple):
                refs += list(r)
                gots += list(o)
            elif r is not None:
                refs.append(r)
                gots.append(o)
            else:
                require(o is None, f"{fn.name}: unexpected output")
        for r, o in zip(refs, gots):
            require(r.shape == o.shape, f"{fn.name}: shape {tuple(o.shape)}"
                    f" != {tuple(r.shape)}")
            require(bool(torch.isfinite(o).all()), f"{fn.name}: non-finite")
            err = max(err, float((o - r).abs().max()))
            if fn.name in EXACT_FNS:
                require(torch.equal(o, r), f"{fn.name}: not exact "
                        f"(max abs err {err})")
            else:
                ok = torch.allclose(o, r, **FLOAT_TOL)
                require(ok, f"{fn.name}: max abs err {err} beyond "
                        f"rtol {FLOAT_TOL['rtol']} / atol "
                        f"{FLOAT_TOL['atol']}")
        ms = cuda_ms(lambda: call(fn, batch, ins), reps=50)
        plain_ms = cuda_ms(lambda: plain(fn, batch, ins), reps=10)
        # one PyTorch call computes the same function only for the plain
        # gather `ae` (an index_select); the others have none
        library_ms = (cuda_ms(lambda: ins[0][batch.edge_var], reps=50)
                      if fn.name == "ae" else None)
        b_ms, b_by = bound_ms(fused_bytes(fn, batch, chained),
                              fn.flops * batch.num_edges)
        name = ("chained_edge_pass" if chained else "fused_edge_pass")
        rows[fn.name] = {
            "name": f"{name}[{fn.name}]", "route": "cuda",
            "source": "pdp_solver_tpu_torch/csrc/edge_pass.cu",
            "replaces": f"{PALLAS_FUSED}:{442 if chained else 553}",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}
        log(f"kernel {rows[fn.name]['name']}: ok, max abs err {err:.3g}, "
            f"{ms:.4f} ms (plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms)")

    # walksat_block: bit for bit, greedy and seeded, K = 8 as on the path
    g = torch.Generator().manual_seed(7)
    av = batch.var_mask * (torch.rand(batch.num_vars, generator=g)
                           > 0.1).float().cuda()
    ac = batch.clause_mask * (torch.rand(batch.num_clauses, generator=g)
                              > 0.2).float().cuda()
    assign = av * (torch.randint(0, 2, (batch.num_vars,), generator=g)
                   .float().cuda() * 2 - 1)
    em = batch.edge_mask * av[batch.edge_var] * ac[batch.edge_clause]
    kw = dict(batch=batch, active_vars=av, active_clauses=ac, em=em, K=8)
    for eps, seed in ((-1.0, 11), (0.5, -123456789)):
        a_ref, e_ref = walksat.walksat_block_plain(assign, seed=seed,
                                                   eps=eps, **kw)
        a_got, e_got = walksat.walksat_block(assign, seed=seed, eps=eps,
                                             **kw)
        torch.cuda.synchronize()
        same = (np.array_equal(a_got.cpu().numpy().view(np.int32),
                               a_ref.cpu().numpy().view(np.int32))
                and torch.equal(e_got, e_ref))
        require(same, f"walksat_block (eps={eps}): not bit-exact, "
                f"{int((a_got != a_ref).sum())} variables and "
                f"{int((e_got != e_ref).sum())} energies differ")
        require(float(e_ref.sum()) > 0, "walksat check had nothing to flip")
    econst = walksat.walksat_edge_constants(batch, av)
    ms = cuda_ms(lambda: walksat.walksat_block(
        assign, seed=5, eps=0.5, edge_constants=econst, **kw), reps=20)
    plain_ms = cuda_ms(lambda: walksat.walksat_block_plain(
        assign, seed=5, eps=0.5, edge_constants=econst, **kw), reps=3)
    E, V, F, B = (batch.num_edges, batch.num_vars, batch.num_clauses,
                  batch.batch_size)
    nbytes = (4 * E + 2 * F + 5 * V + B) * 4   # w dm em ev | ac cb | ...
    b_ms, b_by = bound_ms(nbytes, 8 * 10 * batch.num_real_edges)
    rows["walksat_block"] = {
        "name": "walksat_block", "route": "cuda",
        "source": "pdp_solver_tpu_torch/csrc/walksat.cu",
        "replaces": "pdp_solver_tpu/ops/pallas_walksat.py:285",
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    log(f"kernel walksat_block: bit-exact (eps -1 and 0.5), {ms:.4f} ms "
        f"per 8 iterations (plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms)")
    return rows


def check_reduce2d(batch, torch):
    """Kernels 6 and 7 at the np-nd-np shapes against their plain versions,
    timed beside them, the one-call library version and the bound."""
    from pdp_solver_tpu_torch.ops import reduce2d
    E, V, d = batch.num_edges, batch.num_vars, HIDDEN_AGG
    e = batch.num_real_edges
    g = torch.Generator().manual_seed(17)
    x = torch.randn(E, d, generator=g).cuda()
    nodes = torch.randn(V, d, generator=g).cuda()
    ev = batch.edge_var
    rows = {}

    def seg():
        return reduce2d.segment_sum_2d(x, ev, V, e, batch.var_ptr,
                                       batch.var_perm)

    def seg_plain():
        return reduce2d.segment_sum_2d_plain(x, ev, V, e)

    got, ref = seg(), seg_plain()
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    require(bool(torch.isfinite(got).all()), "segment_sum_2d: non-finite")
    require(torch.allclose(got, ref, **REDUCE2D_TOL),
            f"segment_sum_2d: max abs err {err} beyond rtol "
            f"{REDUCE2D_TOL['rtol']} / atol {REDUCE2D_TOL['atol']}")
    out = torch.zeros(V, d, device="cuda")
    x_real, ev_real = x[:e], ev[:e]
    library_ms = cuda_ms(lambda: out.index_add_(0, ev_real, x_real), reps=50)
    # rows of the real edges, the permutation and offsets read once, the
    # sums written once; one add per element read
    b_ms, b_by = bound_ms((e * d + e + V + 1 + V * d) * 4, e * d)
    rows["segment_sum_2d"] = {
        "name": "segment_sum_2d", "route": "cuda",
        "source": "pdp_solver_tpu_torch/csrc/reduce2d.cu",
        "replaces": f"{PALLAS_2D}:109", "max_abs_err": err,
        "ms": cuda_ms(seg, reps=50), "plain_ms": cuda_ms(seg_plain, reps=20),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
        "library": "index_add_ over the real edges"}

    for minus in (None, x):
        got = reduce2d.gather_2d(nodes, ev, minus)
        ref = reduce2d.gather_2d_plain(nodes, ev, minus)
        torch.cuda.synchronize()
        require(torch.equal(got, ref), "gather_2d (minus "
                f"{minus is not None}): not bit-exact, max abs err "
                f"{float((got - ref).abs().max())}")
    # the path's form subtracts each edge's own row (aggregate minus self)
    b_ms, b_by = bound_ms((E * d + 2 * E + V * d + E * d) * 4, E * d)
    rows["gather_2d"] = {
        "name": "gather_2d", "route": "cuda",
        "source": "pdp_solver_tpu_torch/csrc/reduce2d.cu",
        "replaces": f"{PALLAS_2D}:120", "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: reduce2d.gather_2d(nodes, ev, x), reps=50),
        "plain_ms": cuda_ms(lambda: reduce2d.gather_2d_plain(nodes, ev, x),
                            reps=20),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: nodes.index_select(0, ev), reps=50),
        "library": "index_select (the gather without the subtract)",
        "ms_without_minus": cuda_ms(lambda: reduce2d.gather_2d(nodes, ev),
                                    reps=50)}
    for r in rows.values():
        log(f"kernel {r['name']}: ok, max abs err {r['max_abs_err']:.3g}, "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms)")
    return rows


def reset_counts():
    from pdp_solver_tpu_torch.ops import fused, reduce2d, walksat
    fused.fused_edge_pass.launches = 0
    fused.fused_edge_pass.launches_by_fn = {}
    fused.chained_edge_pass.launches = 0
    fused.chained_edge_pass.launches_by_fn = {}
    walksat.walksat_block.launches = 0
    reduce2d.segment_sum_2d.launches = 0
    reduce2d.gather_2d.launches = 0


def read_counts():
    from pdp_solver_tpu_torch.ops import fused, reduce2d, walksat
    launches = dict(fused.fused_edge_pass.launches_by_fn)
    launches.update(fused.chained_edge_pass.launches_by_fn)
    launches["walksat_block"] = walksat.walksat_block.launches
    launches["segment_sum_2d"] = reduce2d.segment_sum_2d.launches
    launches["gather_2d"] = reduce2d.gather_2d.launches
    return launches


def run_path(solve):
    """One path with every launch count set to 0 just before and read
    just after."""
    reset_counts()
    try:
        res = solve()
    except RuntimeError as e:
        raise SmokeFailure(str(e))
    return res, read_counts()


def main():
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible to torch", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "pdp_solver_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from pdp_solver_tpu_torch.fg.batch import pack_instances
    from pdp_solver_tpu_torch.ops import _build
    from pdp_solver_tpu_torch.utils.benchdata import (
        SHARED_SET_FINGERPRINT, dataset_fingerprint, make_ksat_set)

    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")
    try:
        path, secs, _ = _build.build(force=True)
        log(f"phase 1 build: one nvcc call, {secs:.1f} s -> "
            f"{os.path.relpath(path, ROOT)}")

        insts = make_ksat_set()
        fp = dataset_fingerprint(insts)
        require(fp == SHARED_SET_FINGERPRINT, f"fingerprint {fp}")
        batch = pack_instances(insts, device="cuda")
        log(f"shared set {fp}: E={batch.num_edges} ({batch.num_real_edges} "
            f"real) V={batch.num_vars} F={batch.num_clauses} "
            f"B={batch.batch_size}")
        rows = check_kernels(batch, torch, np)
        rows.update(check_reduce2d(batch, torch))
        log("phase 2 kernel checks: all kernels match their plain versions")
        del batch

        from pdp_solver_tpu_torch.utils.headline import solve_headline
        res, launches = run_path(lambda: solve_headline(insts, seed=0))
        frac = res["solved_fraction"]
        log(f"phase 3 p-d-p path: solved {frac:.4f} ({res['solved']}/"
            f"{len(insts)}, verified with numpy) in {res['wall_s']:.2f} s; "
            f"attempts {res['attempt_solved']}, pdp {res['pdp_wall_s']} s, "
            f"walksat {res['ls_wall_s']} s, {res['compactions']} "
            "compactions")
        log(f"launches on the p-d-p path: {json.dumps(launches)}")
        require(frac >= MIN_SOLVED,
                f"solved fraction {frac} < {MIN_SOLVED}")

        from pdp_solver_tpu_torch.utils.neural import solve_np_nd_np
        require(not torch.backends.cuda.matmul.allow_tf32,
                "TF32 matrix products are on")
        nres, nlaunches = run_path(lambda: solve_np_nd_np(insts, seed=0))
        nfrac = nres["solved_fraction"]
        log(f"phase 4 np-nd-np path: solved {nfrac:.4f} ({nres['solved']}/"
            f"{len(insts)}, verified with numpy) in {nres['wall_s']:.2f} s; "
            f"loop {nres['loop_wall_s']} s, walksat {nres['ls_wall_s']} s, "
            f"{nres['chunks']} chunks, {nres['compactions']} compactions, "
            f"progress {nres['progress']}")
        log(f"launches on the np-nd-np path: {json.dumps(nlaunches)}")
        require(nfrac >= MIN_SOLVED_NEURAL,
                f"np-nd-np solved fraction {nfrac} < {MIN_SOLVED_NEURAL}")

        path_rows = []
        for name, row in rows.items():
            path = (nlaunches if name in ("segment_sum_2d", "gather_2d")
                    else launches)
            n = path.get(name, 0)
            if name == "scorer":
                log(f"{row['name']}: checked, not on the main path")
                continue
            require(n > 0, f"{row['name']} never launched on its path")
            path_rows.append(dict(row, launches=n))
    except SmokeFailure as e:
        log(f"FAILED: {e}")
        return 1

    print(json.dumps({"kernels": path_rows}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi unavailable: {smi.stderr.strip()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
