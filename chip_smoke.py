#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card (an H100) end to end.

    python3 chip_smoke.py            # from the repository root

Phases, one flushed line each with the elapsed seconds:
  1. build: one nvcc call compiles every kernel source (csrc/*.cu);
  2. kernel checks: every kernel instantiation against its plain PyTorch
     version on the card, at the full shared-set shapes (128 instances of
     4-SAT, n=100, alpha=9: E=524,288 padded / 460,800 real edges,
     V=16,384). Flags and counts must match exactly, float sums to rtol
     1e-5 / atol 1e-6 (the plain version sums in another order),
     walksat_block bit for bit for eps=-1 and eps=0.5; each is then timed
     (CUDA events) beside its plain version and its bound;
     The [E, d] segment sum and gather of the neural modules (kernels 6
     and 7) are checked at the np-nd-np shapes (d = 50): the sum to rtol
     1e-5 / atol 1e-5 (the plain index_add_ on the card sums in atomic
     order), the gather and the gather-minus-self bit for bit;
     The multi-column segment sum (kernel 4; C = 1 and 2 over the var CSR,
     C = 1 over the clause CSR), the same kernel on a ragged batch of
     mixed clause widths (kernel 5's function) and over sorted ids
     (kernel 8's function), exact on integer columns and to rtol 1e-5 /
     atol 1e-6 on floats, timed beside index_add_ and kernel 6; the
     one-launch SP sweep (kernel 9) for pi = 0 and 0.01 against its plain
     version and against the two launches it replaces (rtol 1e-5 / atol
     1e-6), timed beside both;
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
  5. walk-sat path: compacting_solve at the solver table's settings (1000
     WalkSAT flips from a random fill, epsilon 0.5), every solution
     verified with numpy; >= 7/128 solved;
  6. reinforce path: the same with REINFORCE (pi 0.01, decimation
     probability 0.5, 1000 iterations); >= 5/128 solved, kernel 4 and
     fused_edge_pass[scorer] launched. Then the REINFORCE forward from one
     injected state at full size, on the card and on the CPU (p = 1):
     after 1 iteration forces, predictions and active flags equal except
     at variables whose CPU |score| < 1e-5 (counted), SP messages to rtol
     1e-5 / atol 1e-6; after 10 iterations under 1% of the forces differ;
  7. p-d-p with PDP_SP_SWEEP=on: phase 3's solve through the one-launch
     sweep; >= 0.60 solved and kernel 9 launched once per iteration;
  8. the {"kernels": [...]} line, the card's name and power limit, and as
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
# walk-sat and reinforce at the solver table's settings: the JAX records
# are 13-16 and 11-17 of 128 (seeds 0-2, docs/r5_solver_table.json); a
# broken WalkSAT solves 0
MIN_SOLVED_WALK_SAT = 7
MIN_SOLVED_REINFORCE = 5
# card-vs-CPU REINFORCE forward: variables whose CPU |score| is below this
# may take either sign; the share of differing forces after 10 iterations
SCORE_TIE = 1e-5
MAX_FORCE_DIFF_SHARE = 0.01
REDUCE2D_TOL = dict(rtol=1e-5, atol=1e-5)
HIDDEN_AGG = 50      # np-nd-np's mem_agg_hidden_dim: the width kernels 6/7 see
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)
# functors whose outputs are flags or small integer counts
EXACT_FNS = {"em_ae", "em", "ae", "sround", "cnf_chain", "ws_chain"}
PALLAS_FUSED = "pdp_solver_tpu/ops/pallas_fused.py"
PALLAS_2D = "pdp_solver_tpu/ops/pallas_reduce2d.py"
REDUCE_CU = "pdp_solver_tpu_torch/csrc/reduce.cu"


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


def ragged_batch(np, seed=5, count=128, n=100, m=900):
    """A batch of the shared set's size whose clauses have mixed widths
    (2-6, mean 4): no uniform width, so every clause-direction sum walks
    the clause CSR; its variable ids fail the TPU window invariant's
    uniform layout."""
    from pdp_solver_tpu_torch.fg.batch import pack_instances
    rng = np.random.default_rng(seed)
    insts = []
    for _ in range(count):
        widths = rng.integers(2, 7, size=m)
        ev = rng.integers(0, n, size=int(widths.sum())).astype(np.int32)
        ec = np.repeat(np.arange(m, dtype=np.int32), widths)
        signs = (2.0 * rng.integers(0, 2, size=ev.shape[0]) - 1.0).astype(
            np.float32)
        insts.append((n, m, np.stack([ev, ec]), signs, -1.0))
    return pack_instances(insts, device="cuda")


def _check_sum(torch, name, got, ref, exact):
    require(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} != "
            f"{tuple(ref.shape)}")
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite")
    err = float((got - ref).abs().max())
    if exact:
        require(torch.equal(got, ref), f"{name}: not exact ({err})")
    else:
        require(torch.allclose(got, ref, **FLOAT_TOL),
                f"{name}: max abs err {err} beyond rtol "
                f"{FLOAT_TOL['rtol']} / atol {FLOAT_TOL['atol']}")
    return err


def check_reduce(batch, torch, np):
    """Kernel 4 (csrc/reduce.cu) at the shared-set shapes, on a ragged
    batch (kernel 5's function) and over sorted ids (kernel 8's)."""
    from pdp_solver_tpu_torch.ops import reduce, reduce2d
    E, V, F = batch.num_edges, batch.num_vars, batch.num_clauses
    e = batch.num_real_edges
    g = torch.Generator().manual_seed(23)
    rows = {}

    # signed integer-valued columns must sum exactly; float columns are
    # non-negative, as the path's are (the smooth-max numerator and
    # denominator), so rtol bounds the atomic-order error of the plain
    # index_add_
    def cols_of(C, E_, integer):
        return [(torch.randint(-3, 4, (E_,), generator=g).float() if integer
                 else torch.rand(E_, generator=g)).cuda() for _ in range(C)]

    def csr_bytes(C, n, e_, perm):
        return (C * e_ + (e_ if perm else 0) + n + 1 + C * n) * 4

    # the path's shapes: [E, 2] rows over the var CSR (the convergence
    # test's smooth-max), one column over the var CSR (the predictor), and
    # one column over the clause CSR
    shapes = {}
    for label, C, ids, n, ptr, perm in (
            ("var C=2", 2, batch.edge_var, V, batch.var_ptr, batch.var_perm),
            ("var C=1", 1, batch.edge_var, V, batch.var_ptr, batch.var_perm),
            ("clause C=1", 1, batch.edge_clause, F, batch.clause_ptr,
             None)):
        err = 0.0
        for integer in (True, False):
            cols = cols_of(C, E, integer)
            ref = reduce.segment_sum_cols_plain(cols, ids, n, e)
            got = reduce.segment_sum_cols(cols, ids, n, e, ptr, perm)
            torch.cuda.synchronize()
            err = max(err, _check_sum(torch, f"segment_sum_cols[{label}]",
                                      got, ref, integer))
        x = torch.stack(cols, 1).contiguous()
        got = reduce.segment_sum(x, ids, n, e, ptr, perm)
        torch.cuda.synchronize()
        require(torch.equal(got.reshape(n, C).T, reduce.segment_sum_cols(
            cols, ids, n, e, ptr, perm)), f"segment_sum[{label}]: [E, C] "
            "and column forms differ")
        xs = torch.stack([c[:e] for c in cols])
        out = torch.zeros(C, n, device="cuda")
        ids_real = ids[:e]
        b_ms, b_by = bound_ms(csr_bytes(C, n, e, perm is not None), C * e)
        shapes[label] = {
            "max_abs_err": err,
            "ms": cuda_ms(lambda: reduce.segment_sum(x, ids, n, e, ptr, perm)
                          if C > 1 else reduce.segment_sum_cols(
                              cols, ids, n, e, ptr, perm), reps=50),
            "plain_ms": cuda_ms(lambda: reduce.segment_sum_cols_plain(
                cols, ids, n, e), reps=20),
            "library_ms": cuda_ms(lambda: out.index_add_(1, ids_real, xs),
                                  reps=50),
            "kernel6_ms": cuda_ms(lambda: reduce2d.segment_sum_2d(
                x, ids, n, e, ptr, perm), reps=50),
            "bound_ms": b_ms, "bound_by": b_by}
        log(f"kernel segment_sum_cols [{label}]: ok, max abs err {err:.3g}, "
            f"{shapes[label]['ms']:.4f} ms (plain "
            f"{shapes[label]['plain_ms']:.4f}, index_add_ "
            f"{shapes[label]['library_ms']:.4f}, kernel 6 "
            f"{shapes[label]['kernel6_ms']:.4f}, bound {b_ms:.5f} ms)")
    main = shapes["var C=2"]
    rows["segment_sum_cols"] = dict(
        {"name": "segment_sum_cols", "route": "cuda", "source": REDUCE_CU,
         "replaces": "pdp_solver_tpu/ops/pallas_reduce.py:224",
         "library": "index_add_ of the stacked real edges", "shapes": shapes},
        **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms",
                                "library_ms", "bound_ms", "bound_by")})

    # kernel 5's function: a batch that fails the window invariant
    rb = ragged_batch(np)
    require(rb.clause_width == 0, "the ragged batch has a uniform width")
    Er, er = rb.num_edges, rb.num_real_edges
    err = 0.0
    for integer in (True, False):
        cols = cols_of(3, Er, integer)
        for ids, n, ptr, perm in (
                (rb.edge_var, rb.num_vars, rb.var_ptr, rb.var_perm),
                (rb.edge_clause, rb.num_clauses, rb.clause_ptr, None)):
            ref = reduce.segment_sum_cols_plain(cols, ids, n, er)
            got = reduce.segment_sum_cols(cols, ids, n, er, ptr, perm)
            torch.cuda.synchronize()
            err = max(err, _check_sum(torch, "segment_sum_cols[ragged]",
                                      got, ref, integer))
    xs = torch.stack([c[:er] for c in cols])
    out = torch.zeros(3, rb.num_vars, device="cuda")
    ids_real = rb.edge_var[:er]
    b_ms, b_by = bound_ms(csr_bytes(3, rb.num_vars, er, True), 3 * er)
    args = (rb.edge_var, rb.num_vars, er, rb.var_ptr, rb.var_perm)
    rows["segment_sum_cols[ragged]"] = {
        "name": "segment_sum_cols[ragged]", "route": "cuda",
        "source": REDUCE_CU,
        "replaces": "pdp_solver_tpu/ops/pallas_reduce.py:209",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: reduce.segment_sum_cols(cols, *args), reps=50),
        "plain_ms": cuda_ms(lambda: reduce.segment_sum_cols_plain(
            cols, rb.edge_var, rb.num_vars, er), reps=20),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: out.index_add_(1, ids_real, xs),
                              reps=50),
        "library": "index_add_ of the stacked real edges",
        "note": f"C = 3 over the var CSR of a batch of mixed clause widths "
                f"(E = {Er}, {er} real)"}
    del rb

    # kernel 8's function: one column over sorted ids, the real edges'
    # clause ids (the padding edges would put 63,488 edges in the last
    # clause, and one thread walks each segment)
    ids = batch.edge_clause[:e]
    x = torch.randint(-3, 4, (e,), generator=g).float().cuda()
    got = reduce.sorted_segment_sum(x, ids, F)
    ref = reduce.sorted_segment_sum_plain(x, ids, F)
    torch.cuda.synchronize()
    _check_sum(torch, "sorted_segment_sum", got, ref, True)
    xf = torch.rand(e, generator=g).cuda()
    err = _check_sum(torch, "sorted_segment_sum",
                     reduce.sorted_segment_sum(xf, ids, F),
                     reduce.sorted_segment_sum_plain(xf, ids, F), False)
    out = torch.zeros(F, device="cuda")
    b_ms, b_by = bound_ms((e + 2 * e + F) * 4, e)   # x, i64 ids, sums
    rows["sorted_segment_sum"] = {
        "name": "sorted_segment_sum", "route": "cuda", "source": REDUCE_CU,
        "replaces": "pdp_solver_tpu/ops/pallas_segment.py:120",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: reduce.sorted_segment_sum(xf, ids, F),
                      reps=50),
        "plain_ms": cuda_ms(lambda: reduce.sorted_segment_sum_plain(
            xf, ids, F), reps=20),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: out.index_add_(0, ids, xf), reps=50),
        "library": "index_add_",
        "note": "kernel checks only: on no solve path, in the JAX package "
                "either; its CUDA kernel is segment_sum_cols, whose "
                "launches on the reinforce path `launches` counts"}
    for name in ("segment_sum_cols[ragged]", "sorted_segment_sum"):
        r = rows[name]
        log(f"kernel {name}: ok, max abs err {r['max_abs_err']:.3g}, "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
            f"{r['library_ms']:.4f}, bound {r['bound_ms']:.5f} ms)")
    return rows


def sweep_inputs(batch, torch, seed, pi):
    g = torch.Generator().manual_seed(seed)
    E = batch.num_edges

    def u(lo=0.0, hi=1.0):
        return (torch.rand(E, generator=g) * (hi - lo) + lo).cuda()

    v = torch.rand(E, 3, generator=g)
    v = (v / v.sum(1, keepdim=True)).cuda()
    return dict(u_like=u(0.01, 1.0), eta_in=u(0.0, 0.99),
                em=batch.edge_mask * (u() > 0.1).float(),
                mask=(u() > 0.2).float(), eta_state=u(), sign=batch.edge_sign,
                force=(torch.where(u() > 0.5, 1.0, -1.0) if pi
                       else torch.zeros(E, device="cuda")),
                v0=v[:, 0].contiguous(), v1=v[:, 1].contiguous(),
                v2=v[:, 2].contiguous())


def check_sp_sweep(batch, torch):
    """Kernel 9 against its plain version and the two launches it
    replaces, for pi = 0 (p-d-p) and 0.01 (reinforce)."""
    from pdp_solver_tpu_torch.ops import fused, sp_sweep
    E, V, F, B = (batch.num_edges, batch.num_vars, batch.num_clauses,
                  batch.batch_size)
    e = batch.num_real_edges
    per_pi = {}
    for pi in (0.0, 0.01):
        kw = sweep_inputs(batch, torch, 31, pi)
        cols = tuple(kw.values())

        def one():
            return sp_sweep.sp_full_sweep(batch, pi=pi, **kw)

        def two():
            _, pn, (eta,), _ = fused.chained_edge_pass(
                fused.SP_CHAIN, batch, cols[:6])
            _, q = fused.fused_edge_pass(
                fused.SP_PASS_C, batch,
                (pn[0], pn[1]) + cols[1:2] + cols[2:4] + cols[5:],
                scalar=pi)
            return (eta,) + tuple(q)

        got = one()
        ref = sp_sweep.sp_full_sweep_plain(batch, cols, pi)
        twin = two()
        torch.cuda.synchronize()
        err = err_two = 0.0
        for a, b, c in zip(got, ref, twin):
            err = max(err, _check_sum(torch, "sp_full_sweep", a, b, False))
            err_two = max(err_two, _check_sum(
                torch, "sp_full_sweep vs the two launches", a, c, False))
        bits = all(torch.equal(a, c) for a, c in zip(got, twin))
        per_pi[pi] = {
            "max_abs_err": err, "max_abs_diff_two_launch": err_two,
            "bit_equal_two_launch": bits,
            "ms": cuda_ms(one, reps=50),
            "plain_ms": cuda_ms(
                lambda: sp_sweep.sp_full_sweep_plain(batch, cols, pi),
                reps=10),
            "two_launch_ms": cuda_ms(two, reps=50)}
        log(f"kernel sp_full_sweep (pi {pi}): ok, max abs err {err:.3g} vs "
            f"plain, {err_two:.3g} vs the two launches (bit-equal {bits}); "
            f"{per_pi[pi]['ms']:.4f} ms (plain {per_pi[pi]['plain_ms']:.4f}"
            f", two launches {per_pi[pi]['two_launch_ms']:.4f} ms)")
    # 10 edge columns in, 4 out; edge_var, var_perm, the padding edges'
    # clause ids and the CSR offsets read once
    nbytes = ((10 + 4 + 1) * E + e + (E - e) + (V + 1) + (F + 1)
              + 2 * (B + 1)) * 4
    b_ms, b_by = bound_ms(nbytes, (fused.SP_CHAIN.flops
                                   + fused.SP_PASS_C.flops) * E)
    main = per_pi[0.0]
    return {"sp_full_sweep": {
        "name": "sp_full_sweep", "route": "cuda",
        "source": "pdp_solver_tpu_torch/csrc/sp_sweep.cu",
        "replaces": "pdp_solver_tpu/ops/pallas_sp.py:166",
        "max_abs_err": max(r["max_abs_err"] for r in per_pi.values()),
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None,
        "two_launch_ms": main["two_launch_ms"],
        "by_pi": {str(k): v for k, v in per_pi.items()}}}


def reinforce_card_vs_cpu(insts, torch):
    """The REINFORCE forward from one injected state at full size, on the
    card and on the CPU, p = 1 (the coin always taken)."""
    from pdp_solver_tpu_torch.fg.batch import pack_instances
    from pdp_solver_tpu_torch.modules.predict import survey_scorer_apply
    from pdp_solver_tpu_torch.solvers.base import PDPSolver, SolverConfig
    from pdp_solver_tpu_torch.utils.classical import REINFORCE
    solver = PDPSolver(SolverConfig(model_type="reinforce",
                                    pi=REINFORCE["pi"],
                                    decimation_probability=1.0))
    runs = {}
    for dev in ("cuda", "cpu"):
        batch = pack_instances(insts, device=dev)
        gen = torch.Generator().manual_seed(0)
        state = solver.get_init_state(gen, batch, randomized=True)
        _, s1, c1 = solver.forward({}, gen, batch, state, 1,
                                   check_termination=True, finalize=False)
        runs[dev] = (batch, s1, c1)
    bg, sg, cg = runs["cuda"]
    bc, sc, cc = runs["cpu"]
    score = survey_scorer_apply(solver.scorer_cfg, bc, sc.prop, cc[0])[0][:, 0]
    tie_v = (score.abs() < SCORE_TIE) & (bc.var_mask > 0)
    n_tie = int(tie_v.sum())
    real = bc.edge_mask > 0
    ok_e = real & ~tie_v[bc.edge_var]
    ok_v = (bc.var_mask > 0) & ~tie_v
    tie_b = torch.zeros(bc.batch_size, dtype=torch.bool)
    tie_b[bc.var_batch[tie_v]] = True
    force_g = sg.dec.fn[1].cpu()
    require(torch.equal(force_g[ok_e], sc.dec.fn[1][ok_e]),
            f"reinforce card vs cpu: {int((force_g != sc.dec.fn[1])[ok_e].sum())}"
            " forces differ after 1 iteration")
    require(torch.equal(cg[0].solution.cpu()[ok_v], cc[0].solution[ok_v]),
            "reinforce card vs cpu: predictions differ after 1 iteration")
    require(torch.equal(cg[1].cpu()[~tie_b], cc[1][~tie_b]),
            "reinforce card vs cpu: active flags differ after 1 iteration")
    msg_err = 0.0
    for a, b in zip(sg.prop.var + sg.prop.fn, sc.prop.var + sc.prop.fn):
        a = a.cpu()
        msg_err = max(msg_err, float((a[real] - b[real]).abs().max()))
        require(torch.allclose(a[real], b[real], **FLOAT_TOL),
                f"reinforce card vs cpu: SP messages differ by {msg_err}")
    # nine more iterations from there, each side on its own
    _, sg10, _ = solver.forward({}, torch.Generator().manual_seed(1), bg, sg,
                                9, check_termination=True, carry=cg,
                                finalize=False)
    _, sc10, _ = solver.forward({}, torch.Generator().manual_seed(1), bc, sc,
                                9, check_termination=True, carry=cc,
                                finalize=False)
    share = float((sg10.dec.fn[1].cpu() != sc10.dec.fn[1])[real]
                  .float().mean())
    require(share < MAX_FORCE_DIFF_SHARE,
            f"reinforce card vs cpu: {share:.4%} of the forces differ after "
            "10 iterations")
    return {"score_ties": n_tie, "message_max_abs_err": msg_err,
            "force_diff_share_10": share}


def reset_counts():
    from pdp_solver_tpu_torch.ops import (
        fused, reduce, reduce2d, sp_sweep, walksat)
    fused.fused_edge_pass.launches = 0
    fused.fused_edge_pass.launches_by_fn = {}
    fused.chained_edge_pass.launches = 0
    fused.chained_edge_pass.launches_by_fn = {}
    walksat.walksat_block.launches = 0
    reduce2d.segment_sum_2d.launches = 0
    reduce2d.gather_2d.launches = 0
    reduce.segment_sum_cols.launches = 0
    reduce.segment_sum_cols.launches_by_form = {}
    sp_sweep.sp_full_sweep.launches = 0


def read_counts():
    from pdp_solver_tpu_torch.ops import (
        fused, reduce, reduce2d, sp_sweep, walksat)
    launches = dict(fused.fused_edge_pass.launches_by_fn)
    launches.update(fused.chained_edge_pass.launches_by_fn)
    launches["walksat_block"] = walksat.walksat_block.launches
    launches["segment_sum_2d"] = reduce2d.segment_sum_2d.launches
    launches["gather_2d"] = reduce2d.gather_2d.launches
    launches["segment_sum_cols"] = reduce.segment_sum_cols.launches
    launches["segment_sum_cols_by_form"] = dict(
        reduce.segment_sum_cols.launches_by_form)
    launches["sp_full_sweep"] = sp_sweep.sp_full_sweep.launches
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
        rows.update(check_reduce(batch, torch, np))
        rows.update(check_sp_sweep(batch, torch))
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

        from pdp_solver_tpu_torch.utils.classical import (
            solve_reinforce, solve_walk_sat)
        wres, wlaunches = run_path(lambda: solve_walk_sat(insts, seed=0))
        log(f"phase 5 walk-sat path: solved {wres['solved']}/{len(insts)} "
            f"(verified with numpy) in {wres['wall_s']:.2f} s; walksat "
            f"{wres['ls_wall_s']} s")
        log(f"launches on the walk-sat path: {json.dumps(wlaunches)}")
        require(wres["solved"] >= MIN_SOLVED_WALK_SAT,
                f"walk-sat solved {wres['solved']} < {MIN_SOLVED_WALK_SAT}")
        require(wlaunches["walksat_block"] > 0,
                "walk-sat never launched walksat_block")

        rres, rlaunches = run_path(lambda: solve_reinforce(insts, seed=0))
        log(f"phase 6 reinforce path: solved {rres['solved']}/{len(insts)} "
            f"(verified with numpy; {rres['loop_solved']} by the REINFORCE "
            f"loop before WalkSAT) in {rres['wall_s']:.2f} s; loop "
            f"{rres['loop_wall_s']} s, walksat {rres['ls_wall_s']} s, "
            f"{rres['chunks']} chunks, progress {rres['progress']}")
        log(f"launches on the reinforce path: {json.dumps(rlaunches)}")
        require(rres["solved"] >= MIN_SOLVED_REINFORCE,
                f"reinforce solved {rres['solved']} < "
                f"{MIN_SOLVED_REINFORCE}")
        cmp = reinforce_card_vs_cpu(insts, torch)
        log(f"phase 6 reinforce card vs cpu: forces, predictions and flags "
            f"equal after 1 iteration except at {cmp['score_ties']} "
            f"variables with |score| < {SCORE_TIE}; SP messages max abs err "
            f"{cmp['message_max_abs_err']:.3g}; "
            f"{cmp['force_diff_share_10']:.4%} of the forces differ after "
            "10 iterations")

        os.environ["PDP_SP_SWEEP"] = "on"
        try:
            sres, slaunches = run_path(lambda: solve_headline(insts, seed=0))
        finally:
            os.environ.pop("PDP_SP_SWEEP")
        sfrac = sres["solved_fraction"]
        log(f"phase 7 p-d-p with PDP_SP_SWEEP=on: solved {sfrac:.4f} "
            f"({sres['solved']}/{len(insts)}, verified with numpy; the two-"
            f"launch run solved {res['solved']}: "
            f"{'reproduced' if sres['solved'] == res['solved'] else 'not reproduced'}"
            f") in {sres['wall_s']:.2f} s")
        log(f"launches on the p-d-p sweep path: {json.dumps(slaunches)}")
        require(sfrac >= MIN_SOLVED, f"p-d-p with the one-launch sweep "
                f"solved {sfrac} < {MIN_SOLVED}")
        # one sweep and one decimator pass per iteration, no two-launch
        # sweep left
        require(slaunches["sp_full_sweep"] == slaunches.get("smax_scorer")
                and slaunches.get("sp_chain", 0) == 0
                and slaunches.get("sp_pass_c", 0) == 0,
                "the one-launch sweep did not replace every sweep: "
                f"{slaunches['sp_full_sweep']} launches for "
                f"{slaunches.get('smax_scorer')} iterations")

        # each row carries the launches of the path it serves
        serves = {"segment_sum_2d": nlaunches, "gather_2d": nlaunches,
                  "scorer": rlaunches, "segment_sum_cols": rlaunches,
                  "segment_sum_cols[ragged]": rlaunches,
                  "sorted_segment_sum": rlaunches,
                  "sp_full_sweep": slaunches}
        path_rows = []
        for name, row in rows.items():
            path = serves.get(name, launches)
            # rows 5 and 8 run the CUDA kernel of row 4
            key = ("segment_sum_cols" if name.startswith(
                ("segment_sum_cols", "sorted_segment_sum")) else name)
            n = path.get(key, 0)
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
