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
     atol 1e-6 on floats, timed beside index_add_ and kernel 6. Kernels
     4, 5, 8 and kernel 1's var side run the group walk (csrc/common.cuh):
     each gives the same bits on two calls, and kernels 4, 5 and 8 the
     bits of the walk's order emulated in PyTorch (ops/reduce.py
     walk_order_sum). Kernels 1, 4, 5 and 8 and their PyTorch calls are
     timed three ways (utils/bench_kernels.py timed): ms / call with CUDA
     events, host us / call with perf_counter and no synchronize, device
     us / call from the profiler; and again at a compacted shape (the 8
     instances of a 32,768-edge bucket) and at high degree (a var CSR
     with one 63,488-edge node; kernel 8 over the shared set's clause ids
     with the padding's 63,488-edge last run), whose float sums are held
     against the plain version in float64; the
     one-launch SP sweep (kernel 9) for pi = 0 and 0.01 against its plain
     version and against the two launches it replaces (rtol 1e-5 / atol
     1e-6), timed beside both, and in its log-input form (login=True,
     p-nd-np's) bit for bit against its two launches (`sp_chain_login`,
     checked above with the other functors, and `sp_pass_c`);
     the verification with the freeze and the next masks in one launch
     (kernel 10) exactly against its plain version and the split path it
     replaces (cnf_chain, the freeze, em_ae), on the shared set's graphs
     with planted signs, some variables and clauses inactive, some
     instances stopped and a prediction that solves half of them, timed
     beside both;
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
  8. p-nd-np path: compacting_solve with the trained r4 checkpoint at full
     width (hidden 150; 1000 iterations, 1000 WalkSAT flips, chunk 50),
     every solution verified with numpy; >= 28/128 solved and the log-input
     sweep, kernel 6, the verification, the masks and WalkSAT launched;
  9. p-nd-np with PDP_SP_SWEEP=on PDP_VERIFY_MASKS=on: phase 8's solve
     through kernel 9 (login) and kernel 10, each launched once per
     iteration (equal counts) and no `sp_chain_login` or `em_ae` left;
     >= 28/128 solved, printed beside phase 8's count;
 10. seeds 1 and 2 of p-d-p and reinforce, printed with seed 0 beside
     the counts from before the group walk;
 11. the {"kernels": [...]} line, the card's name and power limit, and as
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
# p-nd-np with the r4 weights: the JAX records are 38, 45 and 43 of 128
# (seeds 0-2, docs/r5_solver_table.json); WalkSAT alone solves about 15
MIN_SOLVED_P_ND_NP = 28
# the kernels p-nd-np's path must launch: the SP sweep with log input,
# the predictor's per-variable sum (kernel 6; the predictor keeps the
# variable rows, so kernel 7's gather back to the edges is not on this
# path, in the JAX package either), the verification, the masks, WalkSAT
P_ND_NP_KERNELS = ("sp_chain_login", "sp_pass_c", "segment_sum_2d",
                   "cnf_chain", "em_ae", "walksat_block")
# solved counts of seeds 0-2 on an H100 when kernels 1 and 4 walked one
# thread a node (utils/profile_solve.py --seeds 0 1 2 on that tree)
PRIOR_SOLVED = {"p-d-p": [86, 84, 87], "reinforce": [12, 16, 10]}
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


def timing_note(t):
    return (f"{t['ms']:.4f} ms, host {t['host_us']:.1f} us, device "
            f"{t['device_us']:.2f} us")


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
        elif name == "log_u_in":
            x = torch.log(u * 0.96 + 0.02)
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
    from pdp_solver_tpu_torch.utils.bench_kernels import timed
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
        extra = {}
        if chained:
            ms = cuda_ms(lambda: call(fn, batch, ins), reps=50)
        else:
            if fn.side == "var":
                # the group walk: the same bits on a second call
                require(torch.equal(call(fn, batch, ins)[0], got[0]),
                        f"{fn.name}: two calls differ")
                extra["twice_equal"] = True
            extra.update(timed(lambda: call(fn, batch, ins)))
            ms = extra.pop("ms")
        plain_ms = cuda_ms(lambda: plain(fn, batch, ins), reps=10)
        # one PyTorch call computes the same function only for the plain
        # gather `ae` (an index_select); the others have none
        library_ms = None
        if fn.name == "ae":
            lib = timed(lambda: ins[0][batch.edge_var])
            library_ms = lib["ms"]
            extra.update(library_host_us=lib["host_us"],
                         library_device_us=lib["device_us"])
        b_ms, b_by = bound_ms(fused_bytes(fn, batch, chained),
                              fn.flops * batch.num_edges)
        name = ("chained_edge_pass" if chained else "fused_edge_pass")
        rows[fn.name] = dict({
            "name": f"{name}[{fn.name}]", "route": "cuda",
            "source": "pdp_solver_tpu_torch/csrc/edge_pass.cu",
            "replaces": f"{PALLAS_FUSED}:{442 if chained else 553}",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms},
            **extra)
        more = ("" if chained else f", host {extra['host_us']:.1f} us, "
                f"device {extra['device_us']:.2f} us")
        lib = ("" if library_ms is None else f", library {library_ms:.4f} ms"
               f" (host {extra['library_host_us']:.1f} us, device "
               f"{extra['library_device_us']:.2f} us)")
        log(f"kernel {rows[fn.name]['name']}: ok, max abs err {err:.3g}, "
            f"{ms:.4f} ms{more} (plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.5f} ms{lib})")

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


def walk_reference(torch, x, ids, ptr=None, perm=None, n=None):
    """The sums of x f32[C, E] in the group walk's order, emulated in
    PyTorch (ops/reduce.py walk_order_sum): over the CSR (ptr, perm), or
    over the runs of sorted ids when ptr is None."""
    from pdp_solver_tpu_torch.ops import _build, reduce
    if ptr is not None:
        lo, hi = reduce.csr_bounds(ptr)
        slot_edge = None if perm is None else perm.long()
        n_slots = int(ptr[-1])
    else:
        lo, hi = reduce.sorted_bounds(ids, n)
        n_slots, slot_edge = ids.shape[0], None
    gw = _build.group_width(n_slots, lo.shape[0])
    return reduce.walk_order_sum(x, lo, hi, slot_edge, gw)


def check_walk_sum(torch, name, call, x, ids, **csr):
    """A group-walk sum: the same bits on two calls and the bits of the
    walk's order emulated in PyTorch."""
    got, again = call(), call()
    ref = walk_reference(torch, x, ids, **csr)
    torch.cuda.synchronize()
    require(torch.equal(got, again), f"{name}: two calls differ")
    require(torch.equal(got, ref), f"{name}: not the walk's order (max "
            f"abs diff {float((got - ref).abs().max()):.3g})")


def check_reduce(batch, torch, np):
    """Kernel 4 (csrc/reduce.cu) at the shared-set shapes, on a ragged
    batch (kernel 5's function) and over sorted ids (kernel 8's)."""
    from pdp_solver_tpu_torch.ops import reduce, reduce2d
    from pdp_solver_tpu_torch.utils.bench_kernels import timed
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
    for label, C, ids, n, ptr, perm, md in (
            ("var C=2", 2, batch.edge_var, V, batch.var_ptr, batch.var_perm,
             batch.var_max_degree),
            ("var C=1", 1, batch.edge_var, V, batch.var_ptr, batch.var_perm,
             batch.var_max_degree),
            ("clause C=1", 1, batch.edge_clause, F, batch.clause_ptr,
             None, batch.clause_max_degree)):
        err = 0.0
        for integer in (True, False):
            cols = cols_of(C, E, integer)
            ref = reduce.segment_sum_cols_plain(cols, ids, n, e)
            got = reduce.segment_sum_cols(cols, ids, n, e, ptr, perm,
                                          max_degree=md)
            torch.cuda.synchronize()
            err = max(err, _check_sum(torch, f"segment_sum_cols[{label}]",
                                      got, ref, integer))
        check_walk_sum(torch, f"segment_sum_cols[{label}]",
                       lambda: reduce.segment_sum_cols(
                           cols, ids, n, e, ptr, perm, max_degree=md),
                       torch.stack(cols), ids, ptr=ptr, perm=perm)
        # the same bits when the launch does not know the largest degree
        # (its anchored blocks then look for heavy nodes and find none)
        require(torch.equal(got, reduce.segment_sum_cols(
            cols, ids, n, e, ptr, perm)), f"segment_sum_cols[{label}]: "
            "other bits without max_degree")
        x = torch.stack(cols, 1).contiguous()
        got = reduce.segment_sum(x, ids, n, e, ptr, perm, max_degree=md)
        torch.cuda.synchronize()
        require(torch.equal(got.reshape(n, C).T, reduce.segment_sum_cols(
            cols, ids, n, e, ptr, perm)), f"segment_sum[{label}]: [E, C] "
            "and column forms differ")
        xs = torch.stack([c[:e] for c in cols])
        out = torch.zeros(C, n, device="cuda")
        ids_real = ids[:e]
        b_ms, b_by = bound_ms(csr_bytes(C, n, e, perm is not None), C * e)
        kern = timed(lambda: reduce.segment_sum(
            x, ids, n, e, ptr, perm, max_degree=md) if C > 1
            else reduce.segment_sum_cols(cols, ids, n, e, ptr, perm,
                                         max_degree=md))
        lib = timed(lambda: out.index_add_(1, ids_real, xs))
        shapes[label] = dict(
            kern, max_abs_err=err, twice_equal=True, walk_order_bits=True,
            plain_ms=cuda_ms(lambda: reduce.segment_sum_cols_plain(
                cols, ids, n, e), reps=20),
            library_ms=lib["ms"], library_host_us=lib["host_us"],
            library_device_us=lib["device_us"],
            kernel6_ms=cuda_ms(lambda: reduce2d.segment_sum_2d(
                x, ids, n, e, ptr, perm), reps=50),
            bound_ms=b_ms, bound_by=b_by)
        log(f"kernel segment_sum_cols [{label}]: ok, max abs err {err:.3g}, "
            f"twice the same bits, the walk's order; {timing_note(kern)} "
            f"(plain {shapes[label]['plain_ms']:.4f}, index_add_ "
            f"{timing_note(lib)}, kernel 6 "
            f"{shapes[label]['kernel6_ms']:.4f}, bound {b_ms:.5f} ms)")
    main = shapes["var C=2"]
    rows["segment_sum_cols"] = dict(
        {"name": "segment_sum_cols", "route": "cuda", "source": REDUCE_CU,
         "replaces": "pdp_solver_tpu/ops/pallas_reduce.py:224",
         "library": "index_add_ of the stacked real edges", "shapes": shapes},
        **{k: main[k] for k in ("max_abs_err", "ms", "host_us", "device_us",
                                "plain_ms", "library_ms", "library_host_us",
                                "library_device_us", "bound_ms",
                                "bound_by")})

    # kernel 5's function: a batch that fails the window invariant
    rb = ragged_batch(np)
    require(rb.clause_width == 0, "the ragged batch has a uniform width")
    Er, er = rb.num_edges, rb.num_real_edges
    err = 0.0
    for integer in (True, False):
        cols = cols_of(3, Er, integer)
        for ids, n, ptr, perm, md in (
                (rb.edge_var, rb.num_vars, rb.var_ptr, rb.var_perm,
                 rb.var_max_degree),
                (rb.edge_clause, rb.num_clauses, rb.clause_ptr, None,
                 rb.clause_max_degree)):
            ref = reduce.segment_sum_cols_plain(cols, ids, n, er)
            got = reduce.segment_sum_cols(cols, ids, n, er, ptr, perm,
                                          max_degree=md)
            torch.cuda.synchronize()
            err = max(err, _check_sum(torch, "segment_sum_cols[ragged]",
                                      got, ref, integer))
            check_walk_sum(torch, "segment_sum_cols[ragged]",
                           lambda: reduce.segment_sum_cols(
                               cols, ids, n, er, ptr, perm, max_degree=md),
                           torch.stack(cols), ids, ptr=ptr, perm=perm)
    xs = torch.stack([c[:er] for c in cols])
    out = torch.zeros(3, rb.num_vars, device="cuda")
    ids_real = rb.edge_var[:er]
    b_ms, b_by = bound_ms(csr_bytes(3, rb.num_vars, er, True), 3 * er)
    args = (rb.edge_var, rb.num_vars, er, rb.var_ptr, rb.var_perm)
    kern = timed(lambda: reduce.segment_sum_cols(
        cols, *args, max_degree=rb.var_max_degree))
    lib = timed(lambda: out.index_add_(1, ids_real, xs))
    rows["segment_sum_cols[ragged]"] = dict(
        kern, name="segment_sum_cols[ragged]", route="cuda",
        source=REDUCE_CU,
        replaces="pdp_solver_tpu/ops/pallas_reduce.py:209",
        max_abs_err=err, twice_equal=True, walk_order_bits=True,
        plain_ms=cuda_ms(lambda: reduce.segment_sum_cols_plain(
            cols, rb.edge_var, rb.num_vars, er), reps=20),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib["ms"],
        library_host_us=lib["host_us"], library_device_us=lib["device_us"],
        library="index_add_ of the stacked real edges",
        note=f"C = 3 over the var CSR of a batch of mixed clause widths "
             f"(E = {Er}, {er} real)")
    del rb

    # kernel 8's function: one column over sorted ids, the real edges'
    # clause ids (the padding's 63,488-edge run is check_walk's case)
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
    check_walk_sum(torch, "sorted_segment_sum",
                   lambda: reduce.sorted_segment_sum(xf, ids, F)[None],
                   xf[None], ids, n=F)
    out = torch.zeros(F, device="cuda")
    b_ms, b_by = bound_ms((e + 2 * e + F) * 4, e)   # x, i64 ids, sums
    kern = timed(lambda: reduce.sorted_segment_sum(xf, ids, F))
    lib = timed(lambda: out.index_add_(0, ids, xf))
    rows["sorted_segment_sum"] = dict(
        kern, name="sorted_segment_sum", route="cuda", source=REDUCE_CU,
        replaces="pdp_solver_tpu/ops/pallas_segment.py:120",
        max_abs_err=err, twice_equal=True, walk_order_bits=True,
        plain_ms=cuda_ms(lambda: reduce.sorted_segment_sum_plain(
            xf, ids, F), reps=20),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib["ms"],
        library_host_us=lib["host_us"], library_device_us=lib["device_us"],
        library="index_add_",
        note="kernel checks only: on no solve path, in the JAX package "
             "either; its CUDA kernel is segment_sum_cols, whose launches "
             "on the reinforce path `launches` counts")
    for name in ("segment_sum_cols[ragged]", "sorted_segment_sum"):
        r = rows[name]
        log(f"kernel {name}: ok, max abs err {r['max_abs_err']:.3g}, twice "
            f"the same bits, the walk's order; {timing_note(r)} (plain "
            f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f} ms, host "
            f"{r['library_host_us']:.1f} us, device "
            f"{r['library_device_us']:.2f} us; bound {r['bound_ms']:.5f} ms)")
    return rows


def check_walk(insts, torch, np):
    """The redesigned forms (kernel 4 over the var and clause CSRs,
    kernel 8, kernel 1's var side and `ae`) at a compacted shape, the 8
    instances that a 32,768-edge bucket holds, and at high degree: a var
    CSR with one 63,488-edge node, and kernel 8 over all E edges of the
    shared set, whose last run holds the 63,488 padding edges. Each is
    checked (exact on integer columns, rtol 1e-5 / atol 1e-6 on floats,
    the same bits twice, the walk's order where it is a plain sum) and
    timed beside its PyTorch call. At high degree the float sums are held
    against the plain version taken in float64: a float32 index_add_ of
    63,488 terms in atomic order is itself ~1e-5 off, the walk's
    tree ~1e-6. Returns {row: {case: numbers}}."""
    from pdp_solver_tpu_torch.fg.batch import pack_instances
    from pdp_solver_tpu_torch.ops import fused, reduce
    from pdp_solver_tpu_torch.utils.bench_kernels import hub_batch, timed
    g = torch.Generator().manual_seed(29)

    def plain64(cols, ids, n, e):
        out = torch.zeros((len(cols), n), dtype=torch.float64, device="cuda")
        return out.index_add_(1, ids[:e], torch.stack(
            [c[:e].double() for c in cols])).float()

    cases = {"segment_sum_cols": {}, "sorted_segment_sum": {},
             "smax_scorer": {}, "scorer": {}, "ae": {}}
    compacted = pack_instances(insts[:8], device="cuda")
    require(compacted.num_edges == 32768, "the compacted batch has "
            f"{compacted.num_edges} edges")
    hub = hub_batch()
    for label, b in (("compacted", compacted), ("high_degree", hub)):
        E, e = b.num_edges, b.num_real_edges
        for form, C, ids, n, ptr, perm, md in (
                ("var C=2", 2, b.edge_var, b.num_vars, b.var_ptr,
                 b.var_perm, b.var_max_degree),
                ("var C=1", 1, b.edge_var, b.num_vars, b.var_ptr,
                 b.var_perm, b.var_max_degree),
                ("clause C=1", 1, b.edge_clause, b.num_clauses,
                 b.clause_ptr, None, b.clause_max_degree)):
            if label == "high_degree" and form.startswith("clause"):
                continue
            name = f"segment_sum_cols[{label} {form}]"
            icols = [torch.randint(-3, 4, (E,), generator=g).float().cuda()
                     for _ in range(C)]
            _check_sum(torch, name, reduce.segment_sum_cols(
                icols, ids, n, e, ptr, perm, max_degree=md),
                reduce.segment_sum_cols_plain(icols, ids, n, e), True)
            cols = [torch.rand(E, generator=g).cuda() for _ in range(C)]
            plain = (plain64 if label == "high_degree"
                     else reduce.segment_sum_cols_plain)
            err = _check_sum(torch, name, reduce.segment_sum_cols(
                cols, ids, n, e, ptr, perm, max_degree=md),
                plain(cols, ids, n, e), False)
            check_walk_sum(torch, name, lambda: reduce.segment_sum_cols(
                cols, ids, n, e, ptr, perm, max_degree=md),
                torch.stack(cols), ids, ptr=ptr, perm=perm)
            x = torch.stack(cols, 1).contiguous()
            xs = torch.stack([c[:e] for c in cols])
            out = torch.zeros(C, n, device="cuda")
            kern = timed(lambda: reduce.segment_sum(
                x, ids, n, e, ptr, perm, max_degree=md) if C > 1
                else reduce.segment_sum_cols(cols, ids, n, e, ptr, perm,
                                             max_degree=md))
            lib = timed(lambda: out.index_add_(1, ids[:e], xs))
            cases["segment_sum_cols"][f"{label} {form}"] = dict(
                kern, max_abs_err=err, edges=E, max_degree=int(
                    (ptr[1:] - ptr[:-1]).max()),
                library_ms=lib["ms"], library_host_us=lib["host_us"],
                library_device_us=lib["device_us"])
            log(f"{name}: ok, twice the same bits, the walk's order; "
                f"{timing_note(kern)} (index_add_ {timing_note(lib)})")
        for fn in (fused.SMAX_SCORER, fused.SCORER):
            name = f"fused_edge_pass[{fn.name}] {label}"
            ins = fn_inputs(fn, b, seed=41)
            if label == "high_degree":
                terms, _ = fn.plain([x.double() for x in ins], b.edge_var,
                                    b.edge_clause, 0.0)
                ref = plain64(terms, b.edge_var, b.num_vars, e)
            else:
                ref, _ = fused.fused_edge_pass_plain(fn, b, ins)
            got, _ = fused.fused_edge_pass(fn, b, ins)
            again, _ = fused.fused_edge_pass(fn, b, ins)
            torch.cuda.synchronize()
            err = _check_sum(torch, name, got, ref, False)
            require(torch.equal(got, again), f"{name}: two calls differ")
            kern = timed(lambda: fused.fused_edge_pass(fn, b, ins))
            cases[fn.name][label] = dict(kern, max_abs_err=err, edges=E)
            log(f"{name}: ok, max abs err {err:.3g}, twice the same bits; "
                f"{timing_note(kern)}")
    # ae and kernel 8 at the compacted shape
    b = compacted
    (abv,) = fn_inputs(fused.AE, b, seed=43)
    require(torch.equal(fused.fused_edge_pass(fused.AE, b, (abv,))[1][0],
                        abv[b.edge_var]), "ae (compacted): not exact")
    kern = timed(lambda: fused.fused_edge_pass(fused.AE, b, (abv,)))
    lib = timed(lambda: abv[b.edge_var])
    cases["ae"]["compacted"] = dict(
        kern, library_ms=lib["ms"], library_host_us=lib["host_us"],
        library_device_us=lib["device_us"], edges=b.num_edges)
    log(f"fused_edge_pass[ae] compacted: exact; {timing_note(kern)} "
        f"(index gather {timing_note(lib)})")
    full = pack_instances(insts, device="cuda")
    last = full.num_real_clauses - 1
    for label, ids, n in (
            ("compacted", b.edge_clause[:b.num_real_edges], b.num_clauses),
            ("high_degree", full.edge_clause, full.num_clauses)):
        name = f"sorted_segment_sum[{label}]"
        xi = torch.randint(-3, 4, ids.shape, generator=g).float().cuda()
        _check_sum(torch, name, reduce.sorted_segment_sum(xi, ids, n),
                   reduce.sorted_segment_sum_plain(xi, ids, n), True)
        xf = torch.rand(ids.shape, generator=g).cuda()
        ref = (plain64([xf], ids, n, ids.shape[0])[0]
               if label == "high_degree"
               else reduce.sorted_segment_sum_plain(xf, ids, n))
        err = _check_sum(torch, name, reduce.sorted_segment_sum(xf, ids, n),
                         ref, False)
        check_walk_sum(torch, name,
                       lambda: reduce.sorted_segment_sum(xf, ids, n)[None],
                       xf[None], ids, n=n)
        out = torch.zeros(n, device="cuda")
        kern = timed(lambda: reduce.sorted_segment_sum(xf, ids, n))
        lib = timed(lambda: out.index_add_(0, ids, xf))
        cases["sorted_segment_sum"][label] = dict(
            kern, max_abs_err=err, edges=int(ids.shape[0]),
            longest_run=int((ids == last).sum()) if label == "high_degree"
            else None, library_ms=lib["ms"], library_host_us=lib["host_us"],
            library_device_us=lib["device_us"])
        log(f"{name}: ok, twice the same bits, the walk's order; "
            f"{timing_note(kern)} (index_add_ {timing_note(lib)})")
    return cases


def sweep_inputs(batch, torch, seed, pi, login=False):
    """The sweep's columns; with login, u is handed over as log u (p-nd-np's
    adaptors)."""
    g = torch.Generator().manual_seed(seed)
    E = batch.num_edges

    def u(lo=0.0, hi=1.0):
        return (torch.rand(E, generator=g) * (hi - lo) + lo).cuda()

    v = torch.rand(E, 3, generator=g)
    v = (v / v.sum(1, keepdim=True)).cuda()
    u_like = u(0.01, 1.0)
    return dict(u_like=torch.log(u_like) if login else u_like,
                eta_in=u(0.0, 0.99),
                em=batch.edge_mask * (u() > 0.1).float(),
                mask=(u() > 0.2).float(), eta_state=u(), sign=batch.edge_sign,
                force=(torch.where(u() > 0.5, 1.0, -1.0) if pi
                       else torch.zeros(E, device="cuda")),
                v0=v[:, 0].contiguous(), v1=v[:, 1].contiguous(),
                v2=v[:, 2].contiguous())


def check_sp_sweep(batch, torch):
    """Kernel 9 against its plain version and the two launches it
    replaces, for pi = 0 (p-d-p) and 0.01 (reinforce), and in its
    log-input form at pi = 0 (p-nd-np), which must give the two login
    launches' bits."""
    from pdp_solver_tpu_torch.ops import fused, sp_sweep
    E, V, F, B = (batch.num_edges, batch.num_vars, batch.num_clauses,
                  batch.batch_size)
    e = batch.num_real_edges
    per_case = {}
    for pi, login in ((0.0, False), (0.01, False), (0.0, True)):
        kw = sweep_inputs(batch, torch, 31, pi, login)
        cols = tuple(kw.values())
        chain = fused.SP_CHAIN_LOGIN if login else fused.SP_CHAIN

        def one():
            return sp_sweep.sp_full_sweep(batch, pi=pi, login=login, **kw)

        def two():
            _, pn, (eta,), _ = fused.chained_edge_pass(chain, batch,
                                                       cols[:6])
            _, q = fused.fused_edge_pass(
                fused.SP_PASS_C, batch,
                (pn[0], pn[1]) + cols[1:2] + cols[2:4] + cols[5:],
                scalar=pi)
            return (eta,) + tuple(q)

        def plain():
            return sp_sweep.sp_full_sweep_plain(batch, cols, pi, login)

        got, ref, twin = one(), plain(), two()
        torch.cuda.synchronize()
        err = err_two = 0.0
        for a, b, c in zip(got, ref, twin):
            err = max(err, _check_sum(torch, "sp_full_sweep", a, b, False))
            err_two = max(err_two, _check_sum(
                torch, "sp_full_sweep vs the two launches", a, c, False))
        bits = all(torch.equal(a, c) for a, c in zip(got, twin))
        require(bits or not login, "sp_full_sweep(login=True): not "
                f"bit-equal to the two login launches ({err_two:.3g})")
        case = f"login, pi {pi}" if login else f"pi {pi}"
        per_case[case] = {
            "max_abs_err": err, "max_abs_diff_two_launch": err_two,
            "bit_equal_two_launch": bits,
            "ms": cuda_ms(one, reps=50), "plain_ms": cuda_ms(plain, reps=10),
            "two_launch_ms": cuda_ms(two, reps=50)}
        r = per_case[case]
        log(f"kernel sp_full_sweep ({case}): ok, max abs err {err:.3g} vs "
            f"plain, {err_two:.3g} vs the two launches (bit-equal {bits}); "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, two launches "
            f"{r['two_launch_ms']:.4f} ms)")
    # 10 edge columns in, 4 out; edge_var, var_perm, the padding edges'
    # clause ids and the CSR offsets read once
    nbytes = ((10 + 4 + 1) * E + e + (E - e) + (V + 1) + (F + 1)
              + 2 * (B + 1)) * 4
    rows = {}
    for name, chain, case in (
            ("sp_full_sweep", fused.SP_CHAIN, "pi 0.0"),
            ("sp_full_sweep[login]", fused.SP_CHAIN_LOGIN, "login, pi 0.0")):
        b_ms, b_by = bound_ms(nbytes, (chain.flops
                                       + fused.SP_PASS_C.flops) * E)
        main = per_case[case]
        cases = {k: v for k, v in per_case.items()
                 if k.startswith("login") == name.endswith("[login]")}
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "pdp_solver_tpu_torch/csrc/sp_sweep.cu",
            "replaces": "pdp_solver_tpu/ops/pallas_sp.py:166",
            "max_abs_err": max(r["max_abs_err"] for r in cases.values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "library": "none exists; two_launch_ms times the two launches "
                       "it replaces",
            "two_launch_ms": main["two_launch_ms"], "cases": cases}
    return rows


def planted_like(insts, np, seed):
    """The instances with the same graphs and each a random assignment
    that satisfies it (a clause the assignment leaves unsatisfied gets the
    sign of its first literal flipped), and those assignments (0/1)."""
    rng = np.random.default_rng(seed)
    out, xs = [], []
    for n, m, gmap, signs, label in insts:
        x = rng.integers(0, 2, size=n)
        v, c = gmap[0], gmap[1]
        s = np.asarray(signs, np.float32).reshape(-1).copy()
        true = (s > 0) == (x[v] > 0)
        sat = np.bincount(c, weights=true, minlength=m) > 0
        _, first = np.unique(c, return_index=True)
        flip = first[~sat[c[first]]]
        s[flip] = -s[flip]
        out.append((n, m, gmap, s, label))
        xs.append(x.astype(np.float32))
    return out, xs


def check_verify(insts, torch, np):
    """Kernel 10 at the shared-set shapes against its plain version and
    the split path it replaces, exactly on all four outputs: the shared
    set's graphs with planted signs, some variables and clauses inactive,
    every fourth instance already stopped, and a prediction that solves
    the even instances (so some stopped instances are solved, and some
    active ones are frozen by this verification)."""
    from pdp_solver_tpu_torch.fg.batch import pack_instances
    from pdp_solver_tpu_torch.ops import verify
    from pdp_solver_tpu_torch.problem.state import (
        edge_masks_pair, init_problem_state)
    from pdp_solver_tpu_torch.train.loss import cnf_evaluate
    planted, xs = planted_like(insts, np, 41)
    batch = pack_instances(planted, device="cuda")
    require(verify.use_verify_masks(batch), "verify_and_masks: the "
            "planted batch is not eligible")
    g = torch.Generator().manual_seed(43)
    V, F, B, E = (batch.num_vars, batch.num_clauses, batch.batch_size,
                  batch.num_edges)
    pred = torch.rand(V, generator=g)
    off = 0
    for b, x in enumerate(xs):
        if b % 2 == 0:
            pred[off:off + len(x)] = torch.from_numpy(x)
        off += len(x)
    p = pred.cuda()[:, None]
    problem = init_problem_state(batch)
    av = problem.active_vars * (torch.rand(V, generator=g) > 0.1).float(
        ).cuda()
    ac = problem.active_clauses * (torch.rand(F, generator=g) > 0.1).float(
        ).cuda()
    problem = problem.replace(active_vars=av, active_clauses=ac)
    act = batch.instance_mask.clone()
    act[::4] = 0.0

    def one():
        return verify.verify_and_masks(batch, problem, act, p)

    def plain():
        return verify.verify_and_masks_plain(batch, av, ac, act, p[:, 0])

    def split():
        solved, unsat = cnf_evaluate(batch, p)
        return (solved, unsat) + edge_masks_pair(
            batch, problem, act * (solved <= 0.5).float())

    got, ref, two = one(), plain(), split()
    torch.cuda.synchronize()
    for name, a, b, c in zip(("solved", "unsat", "em", "ae"), got, ref,
                             two):
        require(torch.equal(a, b), f"verify_and_masks: {name} differs "
                "from the plain version")
        require(torch.equal(a, c), f"verify_and_masks: {name} differs "
                "from the split path")
    n_inst = len(insts)
    solved = got[0][:n_inst].cpu()
    frozen = int(((act[:n_inst].cpu() > 0) & (solved > 0)).sum())
    require(int(solved.sum()) == (n_inst + 1) // 2 and frozen > 0,
            f"verify_and_masks: {int(solved.sum())} solved, {frozen} "
            "frozen; the check needs both")
    e = batch.num_real_edges
    # ev, sign and edge_mask, the prediction and av, ac and cm, the clause
    # and instance offsets, the instance flags read once; em and ae, solved
    # and unsat written once; a few operations an edge
    nbytes = (3 * E + 2 * V + 3 * F + 1 + 2 * (B + 1) + 2 * E + 2 * B) * 4
    b_ms, b_by = bound_ms(nbytes, 8 * e)
    row = {
        "name": "verify_and_masks", "route": "cuda",
        "source": "pdp_solver_tpu_torch/csrc/verify.cu",
        "replaces": "pdp_solver_tpu/ops/pallas_verify.py:170",
        "max_abs_err": 0.0, "ms": cuda_ms(one, reps=50),
        "plain_ms": cuda_ms(plain, reps=10), "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None,
        "library": "none exists; split_path_ms times the split path it "
                   "replaces (cnf_chain, the freeze, em_ae)",
        "split_path_ms": cuda_ms(split, reps=50),
        "solved": int(solved.sum()), "frozen_by_this_call": frozen}
    log(f"kernel verify_and_masks: exact against the plain version and the "
        f"split path ({row['solved']} of {n_inst} solved, {frozen} frozen "
        f"by this call); {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, "
        f"split path {row['split_path_ms']:.4f}, bound {b_ms:.5f} ms)")
    return {"verify_and_masks": row}


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
        fused, reduce, reduce2d, sp_sweep, verify, walksat)
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
    sp_sweep.sp_full_sweep.launches_by_form = {}
    verify.verify_and_masks.launches = 0


def read_counts():
    from pdp_solver_tpu_torch.ops import (
        fused, reduce, reduce2d, sp_sweep, verify, walksat)
    launches = dict(fused.fused_edge_pass.launches_by_fn)
    launches.update(fused.chained_edge_pass.launches_by_fn)
    launches["walksat_block"] = walksat.walksat_block.launches
    launches["segment_sum_2d"] = reduce2d.segment_sum_2d.launches
    launches["gather_2d"] = reduce2d.gather_2d.launches
    launches["segment_sum_cols"] = reduce.segment_sum_cols.launches
    launches["segment_sum_cols_by_form"] = dict(
        reduce.segment_sum_cols.launches_by_form)
    launches["sp_full_sweep"] = sp_sweep.sp_full_sweep.launches
    launches["sp_full_sweep[login]"] = (
        sp_sweep.sp_full_sweep.launches_by_form.get("login", 0))
    launches["verify_and_masks"] = verify.verify_and_masks.launches
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
        for name, per_case in check_walk(insts, torch, np).items():
            rows[name]["walk_cases"] = per_case
        rows.update(check_sp_sweep(batch, torch))
        del batch
        rows.update(check_verify(insts, torch, np))
        log("phase 2 kernel checks: all kernels match their plain versions")

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

        from pdp_solver_tpu_torch.utils.neural import solve_p_nd_np
        pres, plaunches = run_path(lambda: solve_p_nd_np(insts, seed=0))
        log(f"phase 8 p-nd-np path: solved {pres['solved']}/{len(insts)} "
            f"(verified with numpy) in {pres['wall_s']:.2f} s; loop "
            f"{pres['loop_wall_s']} s, walksat {pres['ls_wall_s']} s, "
            f"{pres['chunks']} chunks, {pres['compactions']} compactions, "
            f"progress {pres['progress']}")
        log(f"launches on the p-nd-np path: {json.dumps(plaunches)}")
        require(pres["solved"] >= MIN_SOLVED_P_ND_NP,
                f"p-nd-np solved {pres['solved']} < {MIN_SOLVED_P_ND_NP}")
        for name in P_ND_NP_KERNELS:
            require(plaunches.get(name, 0) > 0,
                    f"p-nd-np never launched {name}")

        os.environ.update(PDP_SP_SWEEP="on", PDP_VERIFY_MASKS="on")
        try:
            qres, qlaunches = run_path(lambda: solve_p_nd_np(insts, seed=0))
        finally:
            os.environ.pop("PDP_SP_SWEEP")
            os.environ.pop("PDP_VERIFY_MASKS")
        log(f"phase 9 p-nd-np with PDP_SP_SWEEP=on PDP_VERIFY_MASKS=on: "
            f"solved {qres['solved']}/{len(insts)} (verified with numpy; "
            f"phase 8 solved {pres['solved']}: "
            f"{'reproduced' if qres['solved'] == pres['solved'] else 'not reproduced'}"
            f") in {qres['wall_s']:.2f} s; loop {qres['loop_wall_s']} s, "
            f"progress {qres['progress']}")
        log(f"launches on the p-nd-np one-launch path: "
            f"{json.dumps(qlaunches)}")
        require(qres["solved"] >= MIN_SOLVED_P_ND_NP,
                f"p-nd-np with the one-launch kernels solved "
                f"{qres['solved']} < {MIN_SOLVED_P_ND_NP}")
        # one login sweep and one verification per iteration; no two-launch
        # sweep and no split verification left in the loop
        n_sweep = qlaunches["sp_full_sweep[login]"]
        require(n_sweep > 0 and n_sweep == qlaunches["verify_and_masks"]
                and qlaunches.get("sp_chain_login", 0) == 0
                and qlaunches.get("em_ae", 0) == 0,
                "the one-launch kernels did not replace every sweep and "
                f"verification: {n_sweep} sweeps, "
                f"{qlaunches['verify_and_masks']} verifications, "
                f"{qlaunches.get('sp_chain_login', 0)} sp_chain_login, "
                f"{qlaunches.get('em_ae', 0)} em_ae")

        # seeds 0-2 of p-d-p and reinforce beside earlier counts (seed 0
        # is phases 3 and 6)
        pdp = [res["solved"]] + [solve_headline(insts, seed=k)["solved"]
                                 for k in (1, 2)]
        rnf = [rres["solved"]] + [solve_reinforce(insts, seed=k)["solved"]
                                  for k in (1, 2)]
        log(f"seeds 0-2 (of {len(insts)}, verified with numpy): p-d-p "
            f"{pdp} (before the walk: {PRIOR_SOLVED['p-d-p']}); reinforce "
            f"{rnf} (before the walk: {PRIOR_SOLVED['reinforce']})")

        # each row carries the launches of the path it serves
        serves = {"segment_sum_2d": nlaunches, "gather_2d": nlaunches,
                  "scorer": rlaunches, "segment_sum_cols": rlaunches,
                  "segment_sum_cols[ragged]": rlaunches,
                  "sorted_segment_sum": rlaunches,
                  "sp_full_sweep": slaunches, "sp_chain_login": plaunches,
                  "sp_full_sweep[login]": qlaunches,
                  "verify_and_masks": qlaunches}
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
