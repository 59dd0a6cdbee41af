#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card (an H100) end to end.

    python3 chip_smoke.py            # from the repository root

Phases, one flushed line each with the elapsed seconds:
  1. build: one nvcc call compiles every kernel source (csrc/*.cu);
  2. kernel checks: every kernel instantiation against its plain PyTorch
     version on the card, at the full shared-set shapes (128 instances of
     4-SAT, n=100, alpha=9: E=524,288 padded / 460,800 real edges,
     V=16,384). Flags and counts must match exactly, float sums to rtol
     1e-5 / atol 1e-6 (the plain version sums in another order); each is
     then timed (CUDA events) beside its plain version and its bound;
     WalkSAT (kernel 3: walksat_walk, one launch for a whole walk) bit for
     bit against its plain version for 1, 8 and 25 blocks of 8
     iterations, eps -1 and 0.5, from a problem with some variables and
     clauses inactive and from a random fill (every instance unsat), on
     the shared set, a compacted batch (8 instances), the hub (one
     variable in 63,488 clauses: its edges in global memory) and a large
     banded instance (30,000 variables: its variables too), the one-block
     and 25-block forms then timed three ways on each, their bounds
     counting the operations of each instance's iterations up to its
     stop (every clause in the first, the flipped variable's after);
     The [E, d] segment sum and gather of the neural modules (kernels 6
     and 7) are checked at the np-nd-np shapes (d = 50): the sum to rtol
     1e-5 / atol 1e-5 (the plain index_add_ on the card sums in atomic
     order), the gather and the gather-minus-self bit for bit with i32
     and i64 ids; and on bf16 rows (compute_dtype="bfloat16") on the
     shared set and a compacted batch, in the aggregators' forms: bf16
     rows into f32 sums over both CSRs to rtol 1e-5 / atol 1e-5, f32 sums
     minus bf16 rows bit for bit with i32 and i64 ids, timed beside
     index_add_ and index_select on bf16;
     The multi-column segment sum (kernel 4; C = 1 and 2 over the var CSR,
     C = 1 over the clause CSR), the same kernel on a ragged batch of
     mixed clause widths (kernel 5's function) and over sorted ids
     (kernel 8's function), exact on integer columns and to rtol 1e-5 /
     atol 1e-6 on floats, timed beside index_add_ and kernel 6. Kernels
     4, 5, 8, kernel 1's var side and kernel 2's var phase run the group
     walk (csrc/common.cuh): each gives the same bits on two calls, and
     kernels 4, 5, 8 and kernel 2's variable sums the bits of the walk's
     order emulated in PyTorch (ops/reduce.py walk_order_sum, over the
     plain f3 terms for kernel 2). Kernels 1, 2, 4, 5, 6, 7, 8 and 9 and
     their PyTorch calls are timed three ways (utils/bench_kernels.py
     timed): ms / call with CUDA events, host us / call with perf_counter
     and no synchronize, device us / call from the profiler; and kernels
     1, 2, 4, 7, 8 and 9 again at a compacted shape (the 8 instances of a
     32,768-edge bucket), kernels 1, 2 and 4 at high degree (a var CSR
     with one 63,488-edge node; kernel 8 over the shared set's clause ids
     with the padding's 63,488-edge last run), whose float sums are held
     against the plain version in float64; the one-launch SP sweep
     (kernel 9) for pi = 0 and 0.01 and in its log-input form (login=True,
     p-nd-np's) against its plain version (rtol 1e-5 / atol 1e-6) and bit
     for bit against the two launches it replaces (`sp_chain` or
     `sp_chain_login`, then `sp_pass_c`), on the shared set and the
     compacted batch, and on both replicated twice;
     kernels 1 and 2 on the replicated layout: every fused and chained
     functor on the shared set and the compacted batch replicated twice
     (replica 0's padding edges, clauses, variables and rows inside the
     prefix the kernels treat as real), held as above on every output
     row, the SP passes' mask 1 on padding edges as the solver's is;
     the verification with the freeze and the next masks in one launch
     (kernel 10) exactly against its plain version and the split path it
     replaces (cnf_chain, the freeze, em_ae), on the shared set's graphs
     with planted signs, some variables and clauses inactive, some
     instances stopped and a prediction that solves half of them, timed
     beside both; the replicated walk (kernel 3 with R = 2: a launch a
     block, a done flag on the card) bit for bit against the plain walk
     with its replica stop on the shared set and a compacted batch,
     replicated, from a random fill and from a problem where every
     instance gets a solved replica before the last block, timed per call
     and per block; np-d-np's decimator pass (`smax`, kernel 1) with the
     other functors;
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
 10. np-d-np path: compacting_solve with the trained r4 checkpoint at
     full width (hidden 150; 1000 iterations, 1000 WalkSAT flips,
     tolerance 0.02, t_max 10, chunk 50) on the shared set, every solution
     verified with numpy and printed beside the JAX package's 5, 5 and 1
     of 128; the decimator's pass (`smax`, kernel 1), kernels 6 and 7, the
     masks, the simplification, the verification and WalkSAT launched;
 11. np-d-np on the medium 3-SAT band (48 instances, n 60, alpha 3.5, 300
     iterations, decimation only), trained and from a fresh init, every
     solution verified with numpy: the trained run solves >= 29/48 (JAX
     0.8125) and at least 0.30 more than the fresh init (JAX 0.083);
 12. p-d-p compacting_solve(replicas=2) at the headline settings: >= 0.60
     solved, printed beside phase 3's count;
 13. p-d-p forward(replication=2) on the shared set (300 iterations, 200
     WalkSAT flips, check_termination): every deduplicated solution
     verified with numpy and against the solver's flags, and the
     replicated walk launched once a block (25 launches). Then the same
     forward from one injected state on the card and on the CPU: after 1
     iteration every state column on every edge to rtol 1e-5 / atol
     1e-6 and the carry (the problem, the flags, the edge mask) exactly;
     after 30 under 1% of the variables' flags or values differ;
 14. seeds 1 and 2 of p-d-p and reinforce, printed with seed 0 beside
     the counts from before kernel 2's var phase took the walk's order;
 15. np-nd-np in bf16 (compute_dtype="bfloat16"): phase 4's solve, >=
     0.45 solved (the f32 gate), printed beside phase 4's count; the bf16
     kernels 6 and 7 launched and their f32 instantiations never. Then
     the JAX package's own bf16 test (tests/test_bf16.py, hidden 16,
     fresh parameters, 5 iterations) on the card: f32 against bf16 max
     |prediction difference| <= 0.05, its tolerance. Then np-nd-np with
     the r3 weights from one numpy state on 16 4-SAT instances
     (neural.BF16_CHECK; 4 solved within 10 iterations), after 5 and 10
     iterations: the card's and the CPU's bf16 active flags equal, and
     the card's f32-against-bf16 max |prediction difference| and its bf16
     predictions' difference from the CPU's each <= 1.5 times JAX's own
     f32-against-bf16 difference from that state (0.0408 and 0.0610,
     which tests/test_torch_bf16.py recomputes);
 16. p-nd-np in bf16: phase 8's solve, >= 28/128, beside phase 8's count;
 17. np-d-np in bf16 on phase 11's 3-SAT band: >= 29/48, beside phase
     11's count;
 18. the flagship serving config (config/Predict/PDP-np-nd-np-trained.yaml:
     np-nd-np with trained-models/np-nd-np-full in bf16, 100 iterations,
     100 flips, epsilon 0.5) on the shared set, every solution verified
     with numpy; the solved count and the wall time recorded;
 19. the {"kernels": [...]} line, the card's name and power limit, and as
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
                   "cnf_chain", "em_ae", "walksat_walk")
# solved counts of seeds 0-2 on an H100 before kernel 2's var phase took
# the group walk's order (the same before and after kernels 1 and 4 took
# it; utils/profile_solve.py --seeds 0 1 2)
PRIOR_SOLVED = {"p-d-p": [86, 84, 87], "reinforce": [12, 16, 10]}
# card-vs-CPU REINFORCE forward: variables whose CPU |score| is below this
# may take either sign; the share of differing forces after 10 iterations
SCORE_TIE = 1e-5
MAX_FORCE_DIFF_SHARE = 0.01
# np-d-np with the r4 weights: the JAX records on the shared set are 5, 5
# and 1 of 128 (seeds 0-2, docs/r5_solver_table.json); on the medium
# 3-SAT band (decimation only) 0.8125 trained, 0.0833 untrained
# (np_d_np_3sat there). The band's gates: at least 0.60 trained, and at
# least 0.30 above a fresh init
JAX_NP_D_NP = [5, 5, 1]
JAX_BAND = {"trained": 0.8125, "untrained": 0.0833}
MIN_BAND_SOLVED = 29
MIN_BAND_GAIN = 0.30
# the kernels np-d-np's path must launch: its decimator's pass (smax), the
# masks, the simplification, the verification, the aggregators' sum and
# gather (kernels 6, 7) and WalkSAT
NP_D_NP_KERNELS = ("smax", "em", "em_ae", "sround", "cnf_chain",
                   "segment_sum_2d", "gather_2d", "walksat_walk")
# the replicated p-d-p forward of phase 13
REP_ITERATIONS, REP_FLIPS = 300, 200
# its card-against-CPU comparison: iterations run on each side (the
# headline decimator's first fixes come after ~20)
REP_CMP_ITERATIONS = 30
REDUCE2D_TOL = dict(rtol=1e-5, atol=1e-5)
# compute_dtype="bfloat16" (phases 15-18). JAX's own test of bf16
# (tests/test_bf16.py: np-nd-np at these widths with fresh parameters,
# three random 3-SAT instances of 10 variables and 25 clauses, 5
# iterations) run on the card, with its tolerance on the f32-against-bf16
# prediction difference (:34); the check at the r3 weights from one state
# is neural.BF16_CHECK's
BF16 = "bfloat16"
BF16_SMALL = dict(hidden_dim=16, mem_hidden_dim=8, agg_hidden_dim=8,
                  mem_agg_hidden_dim=8, classifier_dim=8)
BF16_SMALL_ITERATIONS = 5
MAX_BF16_PRED_DIFF = 0.05
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


def fn_inputs(fn, batch, seed, active_mask=False):
    """Seeded inputs at the batch's shapes, each drawn like the column its
    name says it is (0/1 masks are 0 on padding). With active_mask the SP
    passes' `mask` is drawn as the solver's active-edge flag, which is 1
    on padding edges too (their variable's instance is active)."""
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
        elif name == "mask" and active_mask and fn.name.startswith("sp_"):
            x = (u > 0.2).float()
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


def _flat(outs):
    """The tensors of a pass's outputs, edge outputs unpacked."""
    flat = []
    for o in outs:
        if isinstance(o, tuple):
            flat += list(o)
        elif o is not None:
            flat.append(o)
    return flat


def hold_pass(fn, batch, ins, torch, label=""):
    """One fused or chained pass on the card against its plain version on
    the same inputs, on every output row (flags and counts exactly, else
    FLOAT_TOL); where it walks the variables, the same bits on a second
    call; a chained pass's variable sums the bits of the walk's order over
    the plain terms. Returns (max abs err, the checks beyond the plain
    version that held)."""
    from pdp_solver_tpu_torch.ops import fused
    chained = fn in fused.CHAINED_FNS
    call = fused.chained_edge_pass if chained else fused.fused_edge_pass
    plain = (fused.chained_edge_pass_plain if chained
             else fused.fused_edge_pass_plain)
    what = f"{fn.name}{label}"
    ref = plain(fn, batch, ins)
    got = call(fn, batch, ins)
    torch.cuda.synchronize()
    err = 0.0
    for r, o in zip(ref, got):
        require((r is None) == (o is None), f"{what}: unexpected output")
    refs, gots = _flat(ref), _flat(got)
    for r, o in zip(refs, gots):
        require(r.shape == o.shape, f"{what}: shape {tuple(o.shape)}"
                f" != {tuple(r.shape)}")
        require(bool(torch.isfinite(o).all()), f"{what}: non-finite")
        err = max(err, float((o - r).abs().max()))
        if fn.name in EXACT_FNS:
            require(torch.equal(o, r), f"{what}: not exact "
                    f"(max abs err {err})")
        else:
            ok = torch.allclose(o, r, **FLOAT_TOL)
            require(ok, f"{what}: max abs err {err} beyond "
                    f"rtol {FLOAT_TOL['rtol']} / atol "
                    f"{FLOAT_TOL['atol']}")
    extra = {}
    if chained or fn.side == "var":
        # the group walk: the same bits on a second call
        again = call(fn, batch, ins)
        torch.cuda.synchronize()
        require(all(torch.equal(o, a) for o, a in zip(
            gots, _flat(again))), f"{what}: two calls differ")
        extra["twice_equal"] = True
    if chained and fn.n_vred:
        # the variable sums in the walk's order over the plain terms
        emu = fused.chained_vred_walk_order(fn, batch, ins)
        torch.cuda.synchronize()
        require(torch.equal(got[1], emu), f"{what}: not the walk's "
                f"order (max abs diff "
                f"{float((got[1] - emu).abs().max()):.3g})")
        extra["walk_order_bits"] = True
    return err, extra


def check_kernels(batch, torch, np):
    from pdp_solver_tpu_torch.ops import fused
    from pdp_solver_tpu_torch.utils.bench_kernels import timed
    rows = {}
    for fn in fused.FUSED_FNS + fused.CHAINED_FNS:
        chained = fn in fused.CHAINED_FNS
        call = fused.chained_edge_pass if chained else fused.fused_edge_pass
        plain = (fused.chained_edge_pass_plain if chained
                 else fused.fused_edge_pass_plain)
        ins = fn_inputs(fn, batch, seed=len(rows) + 1)
        err, extra = hold_pass(fn, batch, ins, torch)
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
        lib = ("" if library_ms is None else f", library {library_ms:.4f} ms"
               f" (host {extra['library_host_us']:.1f} us, device "
               f"{extra['library_device_us']:.2f} us)")
        checks = "".join(f", {k.replace('_', ' ')}" for k in (
            "twice_equal", "walk_order_bits") if k in extra)
        log(f"kernel {rows[fn.name]['name']}: ok, max abs err {err:.3g}"
            f"{checks}; {timing_note(dict(extra, ms=ms))} (plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms{lib})")

    return rows


def check_kernels_replicated(insts, torch):
    """Kernels 1 and 2 on the replicated layout (`replicate_batch`, R =
    2): every fused and chained functor on the shared set and on a
    compacted batch (8 instances of 128 rows), each replicated twice, so
    that the prefix the kernels treat as real holds replica 0's padding
    edges, clauses, variables and rows. Each is held as in phase 2
    (`hold_pass`, every output row, padding included), the SP passes'
    mask drawn as the solver's active-edge flag (1 on padding edges).
    Returns {functor: {shape: max abs err}}."""
    from pdp_solver_tpu_torch.fg.batch import pack_instances, replicate_batch
    from pdp_solver_tpu_torch.ops import fused
    errs = {}
    for label, sub in (("shared", insts), ("compacted", insts[:8])):
        b = replicate_batch(pack_instances(sub, device="cuda"), 2)
        require(b.inner_padding, f"replicated {label}: no padding inside "
                "the real prefix")
        for i, fn in enumerate(fused.FUSED_FNS + fused.CHAINED_FNS):
            ins = fn_inputs(fn, b, seed=100 + i, active_mask=True)
            err, extra = hold_pass(fn, b, ins, torch,
                                   label=f" (replicated {label})")
            errs.setdefault(fn.name, {})[label] = err
        log(f"kernels 1-2 on the replicated {label} batch (E={b.num_edges},"
            f" {b.num_real_edges - b.real.num_edges} padding edges inside "
            f"the prefix): every functor matches its plain version")
    return errs


# the numbers of blocks each WalkSAT shape is checked at: one, the old
# launch's 8 iterations a block run 8 times, and a 200-flip chunk
WALK_BLOCKS = (1, 8, 25)
# operations an edge of a clause and a variable of one WalkSAT iteration
WALK_EDGE_OPS, WALK_VAR_OPS = 10, 20


def walk_steps(walksat, batch, assign, kw, seeds, K, eps):
    """The plain walk one iteration at a time (block j's iteration kk is
    a one-iteration block salted seeds[j] + kk * 1000003): {blocks:
    (assign, energy)} after each of WALK_BLOCKS; the iterations each row
    runs in the kernel (up to and including the first whose entering
    energy is not positive); and the operations those iterations need
    a row. The clause phase of a row's first iteration takes every
    clause; each later one takes only the clauses of the variable the
    iteration before flipped (its real edges, times the clause width),
    since no other clause changed. The selection takes every variable,
    in the iterations that flip. The variables, clauses and edges are the
    rows' real ones (`batch.real`), which the kernel walks."""
    import torch
    dev = assign.device
    real = batch.real
    ivp = batch.inst_var_ptr[:-1].long()
    icp = batch.inst_clause_ptr[:-1].long()
    var_deg = (real.var_ptr[1:] - real.var_ptr[:-1]).double()
    vb = batch.var_batch.long()
    k = batch.clause_width
    every_clause = (WALK_EDGE_OPS * k
                    * (real.clause_end.long() - icp)).double()
    select = (WALK_VAR_OPS * (real.var_end.long() - ivp)).double()
    B = batch.batch_size
    snaps = {}
    count = torch.zeros(B, dtype=torch.int64, device=dev)
    ops = torch.zeros(B, dtype=torch.float64, device=dev)
    entering = torch.ones(B, dtype=torch.bool, device=dev)
    clause_ops = every_clause
    a = assign
    for j, seed in enumerate(seeds):
        for kk in range(K):
            a_next, e = walksat.walksat_block_plain(
                a, K=1, seed=walksat.wrap32(seed + kk * 1000003), eps=eps,
                **kw)
            run = entering & (e > 0)
            count += entering.long()
            ops += entering.double() * clause_ops + run.double() * select
            flipped = torch.zeros(B, dtype=torch.float64, device=dev)
            flipped.index_add_(0, vb, var_deg * (a_next != a).double())
            clause_ops = WALK_EDGE_OPS * k * flipped
            entering = run
            a = a_next
        if j + 1 in WALK_BLOCKS:
            snaps[j + 1] = (a, e)
    return snaps, count, ops


def walk_bound(batch, ops, n_blocks):
    """bound_ms of one walk: its inputs read once (ev, w, dm, em a real
    edge, ac a real clause, assign and av a variable, seeds) and its
    outputs written once (the assignment, the energies), or the
    operations (walk_steps) its instances' live iterations need. The real
    clauses and edges are the rows' (`batch.real`): a replicated batch's
    padding inside the prefix is none of the walk's work."""
    V, F, E = batch.num_vars, batch.real.num_clauses, batch.real.num_edges
    nbytes = 16 * E + 4 * F + 12 * V + 4 * batch.batch_size + 4 * n_blocks
    return bound_ms(nbytes, float(ops.sum()))


def check_walksat(insts, torch, np):
    """WalkSAT (kernel 3): one walksat_walk launch of 1, 8 and 25 blocks
    of K = 8 bit for bit against its plain version (assignments as int32
    views, energies exactly), greedy and eps 0.5, from two inputs (a
    problem with some variables and clauses inactive and a random
    prediction; a random fill of every variable, all active, every
    instance unsat, as the WalkSAT phase starts) on four shapes: the
    shared set, a compacted batch, the hub (one variable in 63,488
    clauses: edges in global memory) and a large banded instance (30,000
    variables: variables in global memory too). The one-block and
    25-block forms are then timed three ways on each shape. Returns the
    rows "walksat_block" (one block, shared set, the first input) and
    "walksat_walk" (25 blocks, shared set, the fill)."""
    from pdp_solver_tpu_torch.fg.batch import pack_instances
    from pdp_solver_tpu_torch.ops import walksat
    from pdp_solver_tpu_torch.utils.bench_kernels import (
        WALK_SEEDS, hub_batch, large_instance, timed, walk_inputs)
    K = 8
    shapes = {"shared": pack_instances(insts, device="cuda"),
              "compacted": pack_instances(insts[:8], device="cuda"),
              "hub": hub_batch(),
              "large": pack_instances([large_instance()], device="cuda")}
    g = torch.Generator().manual_seed(13)
    rows, cases = {}, {}
    for label, b in shapes.items():
        require(walksat.use_walksat_block(b), f"walksat: {label} is not "
                "taken by the block rule")
        shape = walksat.launch_shape(b)
        n = b.num_instances
        for fill in ("half", "unsat"):
            assign, av, ac, em = walk_inputs(b, fill)
            kw = dict(batch=b, active_vars=av, active_clauses=ac, em=em)
            for eps in (-1.0, 0.5):
                # the first seed: the one-block checks of earlier slices
                first = 11 if eps < 0 else -123456789
                seeds = [first] + [int(x) for x in torch.randint(
                    -(1 << 31), 1 << 31, (WALK_BLOCKS[-1] - 1,),
                    generator=g)]
                snaps, _, _ = walk_steps(walksat, b, assign, kw, seeds,
                                         K, eps)
                for nb in WALK_BLOCKS:
                    a_got, e_got = walksat.walksat_walk(
                        assign, seeds=seeds[:nb], K=K, eps=eps, **kw)
                    torch.cuda.synchronize()
                    a_ref, e_ref = snaps[nb]
                    same = (np.array_equal(
                        a_got.cpu().numpy().view(np.int32),
                        a_ref.cpu().numpy().view(np.int32))
                        and torch.equal(e_got, e_ref))
                    require(same, f"walksat_walk ({label}, {fill}, eps "
                            f"{eps}, {nb} blocks): not bit-exact, "
                            f"{int((a_got != a_ref).sum())} variables and "
                            f"{int((e_got != e_ref).sum())} energies differ")
                e_first = snaps[1][1][:n]
                if fill == "unsat":
                    _, e0 = walksat.walksat_block_plain(
                        assign, K=1, seed=0, eps=eps, **kw)
                    require(bool((e0[:n] > 0).all()), f"walksat ({label}):"
                            " the fill left an instance satisfied")
                require(float(e_first.sum()) > 0,
                        f"walksat ({label}, {fill}) had nothing to flip")
            # timing: eps 0.5, as the solver table's settings
            econst = walksat.walksat_edge_constants(b, av)
            tkw = dict(kw, K=K, eps=0.5, edge_constants=econst)
            reps = dict(reps=5, host_reps=5) if n == 1 else {}
            for form, seeds in (("block", [5]), ("walk", WALK_SEEDS)):
                t = timed(lambda: walksat.walksat_walk(
                    assign, seeds=seeds, **tkw), **reps)
                _, live, ops = walk_steps(walksat, b, assign, kw, seeds,
                                          K, 0.5)
                b_ms, b_by = walk_bound(b, ops, len(seeds))
                t.update(bound_ms=b_ms, bound_by=b_by,
                         live_iterations=int(live[:n].sum()),
                         instances=n)
                cases[f"{label} {fill} {form}"] = t
                if label == "shared" and (form, fill) in (
                        ("block", "half"), ("walk", "unsat")):
                    plain_ms = cuda_ms(lambda: walksat.walksat_walk_plain(
                        assign, seeds=seeds, **tkw), reps=1, warmup=1)
                    name = ("walksat_block" if form == "block"
                            else "walksat_walk")
                    rows[name] = dict({
                        "name": name, "route": "cuda",
                        "source": "pdp_solver_tpu_torch/csrc/walksat.cu",
                        "replaces": "pdp_solver_tpu/ops/pallas_walksat.py:285",
                        "max_abs_err": 0.0, "plain_ms": plain_ms,
                        "library_ms": None, "blocks": len(seeds)}, **t)
                log(f"walksat {label} ({shape[0]} threads, staged vars "
                    f"{shape[1]}, edges {shape[2]}) {fill} {form} "
                    f"({len(seeds)} blocks): bit-exact; {timing_note(t)}, "
                    f"{int(live[:n].sum())} live iterations, bound "
                    f"{b_ms:.5f} ms ({b_by})")
    rows["walksat_walk"]["cases"] = cases
    return rows


def check_walksat_replicated(insts, torch, np):
    """The replicated walk (kernel 3 with R = 2: a launch a block, each
    CTA returning at once once the device's done flag is set) bit for bit
    against the plain walk with its replica stop (assignments as int32
    views, energies exactly), 25 blocks of K = 8 at eps 0.5, on the shared
    set and on a compacted batch (8 instances of 128 rows: padding rows
    and variables between the replicas), from a random fill (every
    instance unsat) and from a problem with most clauses inactive, where
    every instance has a solved replica before the last block. The
    shared set's random fill is then timed three ways, per call and per
    block, its bound counting each row's live iterations up to the stop.
    Returns the row "walksat_walk[replicas=2]"."""
    from pdp_solver_tpu_torch.fg.batch import pack_instances, replicate_batch
    from pdp_solver_tpu_torch.ops import walksat
    from pdp_solver_tpu_torch.utils.bench_kernels import (
        WALK_SEEDS, timed, walk_inputs)
    K, R, seeds = 8, 2, WALK_SEEDS
    g = torch.Generator().manual_seed(19)
    row, cases = None, {}
    for label, sub in (("shared", insts), ("compacted", insts[:8])):
        b = replicate_batch(pack_instances(sub, device="cuda"), R)
        require(walksat.use_walksat_block(b), f"walksat replicated: {label}"
                " is not taken by the block rule")
        for fill in ("unsat", "easy"):
            assign, av, ac, em = walk_inputs(b, "unsat")
            if fill == "easy":
                ac = ac * (torch.rand(b.num_clauses, generator=g)
                           > 0.8).float().cuda()
                em = b.edge_mask * av[b.edge_var] * ac[b.edge_clause]
            kw = dict(batch=b, active_vars=av, active_clauses=ac, em=em,
                      K=K, eps=0.5)
            a, stop = assign, None
            for j, seed in enumerate(seeds):
                a, e = walksat.walksat_block_plain(a, seed=seed, **kw)
                if walksat.replicas_done(b, e, R) > 0:
                    stop = j
                    break
            n0 = walksat.walksat_walk.launches
            got_a, got_e = walksat.walksat_walk(assign, seeds=seeds,
                                                replicas=R, **kw)
            torch.cuda.synchronize()
            require(walksat.walksat_walk.launches - n0 == len(seeds),
                    "walksat replicated: not one launch a block")
            same = (np.array_equal(got_a.cpu().numpy().view(np.int32),
                                   a.cpu().numpy().view(np.int32))
                    and torch.equal(got_e, e))
            require(same, f"walksat replicated ({label}, {fill}): not "
                    f"bit-exact, {int((got_a != a).sum())} variables differ")
            if fill == "easy":
                require(stop is not None and stop < len(seeds) - 1,
                        f"walksat replicated ({label}): the walk never "
                        "stopped early")
            n_run = len(seeds) if stop is None else stop + 1
            log(f"walksat replicated {label} {fill} (R = {R}, "
                f"{b.num_instances} rows launched): bit-exact, every "
                f"instance solved by a replica after "
                f"{'no' if stop is None else stop + 1} of {len(seeds)} "
                "blocks")
            if (label, fill) != ("shared", "unsat"):
                continue
            t = timed(lambda: walksat.walksat_walk(assign, seeds=seeds,
                                                   replicas=R, **kw))
            _, live, ops = walk_steps(walksat, b, assign, dict(
                batch=b, active_vars=av, active_clauses=ac, em=em),
                seeds[:n_run], K, 0.5)
            b_ms, b_by = walk_bound(b, ops, len(seeds))
            plain_ms = cuda_ms(lambda: walksat.walksat_walk_plain(
                assign, seeds=seeds, replicas=R, **kw), reps=1, warmup=1)
            row = dict({
                "name": "walksat_walk[replicas=2]", "route": "cuda",
                "source": "pdp_solver_tpu_torch/csrc/walksat.cu",
                "replaces": "pdp_solver_tpu/ops/pallas_walksat.py:285",
                "max_abs_err": 0.0, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "blocks": len(seeds), "launches_per_call": len(seeds),
                "blocks_run": n_run, "live_iterations": int(live.sum())},
                **t)
            row["ms_per_block"] = row["ms"] / len(seeds)
            log(f"walksat replicated shared unsat ({len(seeds)} blocks, "
                f"{len(seeds)} launches): {timing_note(t)}, "
                f"{row['ms_per_block']:.4f} ms a block, plain "
                f"{plain_ms:.2f} ms, bound {b_ms:.5f} ms ({b_by})")
            cases[f"{label} {fill}"] = t
    row["cases"] = cases
    return {"walksat_walk[replicas=2]": row}


def check_reduce2d(batch, torch):
    """Kernels 6 and 7 at the np-nd-np shapes against their plain versions,
    timed beside them, the one-call library version and the bound."""
    from pdp_solver_tpu_torch.ops import reduce2d
    from pdp_solver_tpu_torch.utils.bench_kernels import timed
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
    lib = timed(lambda: out.index_add_(0, ev_real, x_real))
    # rows of the real edges, the permutation and offsets read once, the
    # sums written once; one add per element read
    b_ms, b_by = bound_ms((e * d + e + V + 1 + V * d) * 4, e * d)
    rows["segment_sum_2d"] = dict(
        timed(seg), name="segment_sum_2d", route="cuda",
        source="pdp_solver_tpu_torch/csrc/reduce2d.cu",
        replaces=f"{PALLAS_2D}:109", max_abs_err=err,
        plain_ms=cuda_ms(seg_plain, reps=20), bound_ms=b_ms, bound_by=b_by,
        library_ms=lib["ms"], library_host_us=lib["host_us"],
        library_device_us=lib["device_us"],
        library="index_add_ over the real edges")

    # the path's ids are i32 (edge_var32); i64 ids give the same bits
    ev32 = batch.edge_var32
    for ids in (ev32, ev):
        for minus in (None, x):
            got = reduce2d.gather_2d(nodes, ids, minus)
            ref = reduce2d.gather_2d_plain(nodes, ev, minus)
            torch.cuda.synchronize()
            require(torch.equal(got, ref), f"gather_2d (minus "
                    f"{minus is not None}, {ids.dtype}): not bit-exact, max "
                    f"abs err {float((got - ref).abs().max())}")
    # the path's form subtracts each edge's own row (aggregate minus self):
    # the subtrahend and the output, the node rows and i32 ids
    b_ms, b_by = bound_ms((E * d + E + V * d + E * d) * 4, E * d)
    b_plain, _ = bound_ms((E + V * d + E * d) * 4, 0)
    kern = timed(lambda: reduce2d.gather_2d(nodes, ev32, x))
    plain_gather = timed(lambda: reduce2d.gather_2d(nodes, ev32))
    lib = timed(lambda: nodes.index_select(0, ev))
    rows["gather_2d"] = dict(
        kern, name="gather_2d", route="cuda",
        source="pdp_solver_tpu_torch/csrc/reduce2d.cu",
        replaces=f"{PALLAS_2D}:120", max_abs_err=0.0,
        plain_ms=cuda_ms(lambda: reduce2d.gather_2d_plain(nodes, ev, x),
                         reps=20),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib["ms"],
        library_host_us=lib["host_us"], library_device_us=lib["device_us"],
        library="index_select (the gather without the subtract, i64 ids)",
        without_minus=dict(plain_gather, bound_ms=b_plain),
        ms_i64_ids=cuda_ms(lambda: reduce2d.gather_2d(nodes, ev, x),
                           reps=50),
        without_minus_ms_i64_ids=cuda_ms(
            lambda: reduce2d.gather_2d(nodes, ev), reps=50))
    for r in rows.values():
        log(f"kernel {r['name']}: ok, max abs err {r['max_abs_err']:.3g}, "
            f"{timing_note(r)} (plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, host {r['library_host_us']:.1f} us, "
            f"device {r['library_device_us']:.2f} us; bound "
            f"{r['bound_ms']:.5f} ms)")
    log(f"kernel gather_2d without the subtract: "
        f"{timing_note(plain_gather)}, bound {b_plain:.5f} ms")
    return rows


def check_reduce2d_bf16(batch, compacted, torch):
    """Kernels 6 and 7 on bf16 rows (compute_dtype="bfloat16") at d = 50,
    on the shared set and a compacted batch, in the only forms either
    package takes (JAX's f32 edge mask makes its sums f32): bf16 rows into
    f32 sums over both CSRs to REDUCE2D_TOL of the plain version, and f32
    sums minus bf16 rows bit for bit with i32 and i64 ids; no f32 launch
    counted. Timed at the shared set beside the plain versions, the bf16
    PyTorch calls (index_add_ on bf16, which rounds at every add: a time
    only) and the bound."""
    from pdp_solver_tpu_torch.ops import reduce2d
    from pdp_solver_tpu_torch.utils.bench_kernels import timed
    d, bf16 = HIDDEN_AGG, torch.bfloat16
    f32_launches = (reduce2d.segment_sum_2d.launches,
                    reduce2d.gather_2d.launches)
    errs = {}
    for label, b in (("shared", batch), ("compacted", compacted)):
        g = torch.Generator().manual_seed(19)
        x = torch.randn(b.num_edges, d, generator=g).cuda().to(bf16)
        nodes = torch.randn(b.num_vars, d, generator=g).cuda()
        e = b.num_real_edges
        for side, ids, n, ptr, perm in (
                ("var", b.edge_var, b.num_vars, b.var_ptr, b.var_perm),
                ("clause", b.edge_clause, b.num_clauses, b.clause_ptr,
                 None)):
            got = reduce2d.segment_sum_2d(x, ids, n, e, ptr, perm)
            ref = reduce2d.segment_sum_2d_plain(x, ids, n, e)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            errs[f"{label}_{side}"] = err
            require(got.dtype == torch.float32
                    and torch.allclose(got, ref, **REDUCE2D_TOL),
                    f"segment_sum_2d[bf16] {label} {side}: max abs err "
                    f"{err}")
        for ids in (b.edge_var32, b.edge_var):
            got = reduce2d.gather_2d(nodes, ids, x)
            ref = reduce2d.gather_2d_plain(nodes, b.edge_var, x)
            torch.cuda.synchronize()
            require(got.dtype == torch.float32 and torch.equal(got, ref),
                    f"gather_2d[bf16] {label} ({ids.dtype}): not bit-exact")
    require((reduce2d.segment_sum_2d.launches,
             reduce2d.gather_2d.launches) == f32_launches,
            "a bf16 call launched an f32 kernel")

    E, V, e = batch.num_edges, batch.num_vars, batch.num_real_edges
    F = batch.num_clauses
    g = torch.Generator().manual_seed(19)
    x = torch.randn(E, d, generator=g).cuda().to(bf16)
    nodes = torch.randn(V, d, generator=g).cuda()
    ev, ev32 = batch.edge_var, batch.edge_var32
    rows = {}

    def seg():
        return reduce2d.segment_sum_2d(x, ev, V, e, batch.var_ptr,
                                       batch.var_perm)

    out = torch.zeros(V, d, device="cuda", dtype=bf16)
    x_real, ev_real = x[:e], ev[:e]
    lib = timed(lambda: out.index_add_(0, ev_real, x_real))
    # bf16 rows of the real edges, the permutation and offsets read once,
    # the f32 sums written once; one add per element read
    b_ms, b_by = bound_ms(e * d * 2 + (e + V + 1) * 4 + V * d * 4, e * d)
    b_clause, _ = bound_ms(e * d * 2 + (F + 1) * 4 + F * d * 4, e * d)
    rows["segment_sum_2d[bf16]"] = dict(
        timed(seg), name="segment_sum_2d[bf16]", route="cuda",
        source="pdp_solver_tpu_torch/csrc/reduce2d.cu",
        replaces=f"{PALLAS_2D}:109", max_abs_err=max(errs.values()),
        max_abs_err_by_case=errs,
        plain_ms=cuda_ms(lambda: reduce2d.segment_sum_2d_plain(
            x, ev, V, e), reps=20),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib["ms"],
        library_host_us=lib["host_us"], library_device_us=lib["device_us"],
        library="index_add_ on bf16 over the real edges (bf16 sums "
                "rounded at every add: a time, not the same function)",
        form="bf16 rows, f32 sums, var CSR",
        clause_csr=dict(timed(lambda: reduce2d.segment_sum_2d(
            x, batch.edge_clause, F, e, batch.clause_ptr)),
            bound_ms=b_clause))
    # f32 sums minus the bf16 rows, f32 out, i32 ids: the subtrahend, the
    # ids, the node rows read once and the output written once
    b_ms, b_by = bound_ms(E * d * 2 + E * 4 + V * d * 4 + E * d * 4, E * d)
    nb = nodes.to(bf16)
    lib = timed(lambda: nb.index_select(0, ev))
    rows["gather_2d[bf16]"] = dict(
        timed(lambda: reduce2d.gather_2d(nodes, ev32, x)),
        name="gather_2d[bf16]", route="cuda",
        source="pdp_solver_tpu_torch/csrc/reduce2d.cu",
        replaces=f"{PALLAS_2D}:120", max_abs_err=0.0,
        plain_ms=cuda_ms(lambda: reduce2d.gather_2d_plain(nodes, ev, x),
                         reps=20),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib["ms"],
        library_host_us=lib["host_us"], library_device_us=lib["device_us"],
        library="index_select on bf16 nodes (the gather without the "
                "subtract, i64 ids)",
        form="f32 sums minus bf16 rows, f32 out, i32 ids")
    for r in rows.values():
        log(f"kernel {r['name']} ({r['form']}): ok, max abs err "
            f"{r['max_abs_err']:.3g}, {timing_note(r)} (plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"host {r['library_host_us']:.1f} us, device "
            f"{r['library_device_us']:.2f} us; bound {r['bound_ms']:.5f} ms)")
    c = rows["segment_sum_2d[bf16]"]["clause_csr"]
    log(f"kernel segment_sum_2d[bf16] over the clause CSR: "
        f"{timing_note(c)}, bound {c['bound_ms']:.5f} ms")
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


def check_chained_walk(fn, b, label, torch):
    """One chained functor on a compacted or high-degree batch: against
    its plain version (exact for the integer functors; at high degree the
    SP sums against float64), the same bits twice, the walk's order, and
    timed."""
    from pdp_solver_tpu_torch.ops import fused
    from pdp_solver_tpu_torch.utils.bench_kernels import timed
    name = f"chained_edge_pass[{fn.name}] {label}"
    ins = fn_inputs(fn, b, seed=47)
    got = fused.chained_edge_pass(fn, b, ins)
    again = fused.chained_edge_pass(fn, b, ins)
    ref = list(fused.chained_edge_pass_plain(fn, b, ins))
    exact = fn.name in EXACT_FNS
    if label == "high_degree" and fn.n_vred and not exact:
        ref[1] = fused.chained_edge_pass_plain(
            fn, b, [t.double() for t in ins])[1].float()
    torch.cuda.synchronize()
    err = 0.0
    for o, a, r in zip(_flat(got), _flat(again), _flat(ref)):
        err = max(err, _check_sum(torch, name, o, r, exact))
        require(torch.equal(o, a), f"{name}: two calls differ")
    if fn.n_vred:
        emu = fused.chained_vred_walk_order(fn, b, ins)
        torch.cuda.synchronize()
        require(torch.equal(got[1], emu), f"{name}: not the walk's order")
    kern = timed(lambda: fused.chained_edge_pass(fn, b, ins))
    order = ", the walk's order" if fn.n_vred else ""
    log(f"{name}: ok, max abs err {err:.3g}, twice the same bits{order}; "
        f"{timing_note(kern)}")
    return dict(kern, max_abs_err=err, edges=b.num_edges,
                max_degree=b.var_max_degree)


def check_walk(insts, torch, np):
    """The redesigned forms (kernel 4 over the var and clause CSRs,
    kernel 8, kernel 1's var side and `ae`, kernel 2's five functors) at a
    compacted shape, the 8 instances that a 32,768-edge bucket holds, and
    at high degree: a var CSR with one 63,488-edge node, and kernel 8 over
    all E edges of the shared set, whose last run holds the 63,488 padding
    edges; kernel 7 at the compacted shape. Each is
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
    cases.update({fn.name: {} for fn in fused.CHAINED_FNS})
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
        for fn in fused.CHAINED_FNS:
            cases[fn.name][label] = check_chained_walk(fn, b, label, torch)
    # kernel 7 at the compacted shape, the path's form (i32 ids, minus)
    from pdp_solver_tpu_torch.ops import reduce2d
    b = compacted
    nodes = torch.randn(b.num_vars, HIDDEN_AGG, generator=g).cuda()
    x = torch.randn(b.num_edges, HIDDEN_AGG, generator=g).cuda()
    require(torch.equal(reduce2d.gather_2d(nodes, b.edge_var32, x),
                        reduce2d.gather_2d_plain(nodes, b.edge_var, x)),
            "gather_2d (compacted): not bit-exact")
    kern = timed(lambda: reduce2d.gather_2d(nodes, b.edge_var32, x))
    lib = timed(lambda: nodes.index_select(0, b.edge_var))
    cases["gather_2d"] = {"compacted": dict(
        kern, library_ms=lib["ms"], library_host_us=lib["host_us"],
        library_device_us=lib["device_us"], edges=b.num_edges)}
    log(f"gather_2d compacted: exact; {timing_note(kern)} (index_select "
        f"{timing_note(lib)})")
    # ae and kernel 8 at the compacted shape
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


def check_sp_sweep(batch, compacted, torch):
    """Kernel 9 against its plain version and, bit for bit, against the
    two launches it replaces (its variable sums take the chained pass's
    walk order), for pi = 0 (p-d-p), 0.01 (reinforce) and in its
    log-input form at pi = 0 (p-nd-np), at the shared-set shapes, on a
    compacted batch, on the hub batch (one 63,488-edge variable, cut
    in pieces over a cluster of 16 CTAs) and on the shared set and the
    compacted batch replicated twice (replica 0's padding inside the
    prefix, the mask 1 on padding edges as the solver's active-edge flag
    is). On the hub the plain version is
    taken in float64 and held at an absolute 5e-5 (a float32 sum of
    63,488 terms in any order is itself ~1e-5 off; a wrong sum is off by
    a whole term, ~1e-2 or more), beside the two launches' bits."""
    from pdp_solver_tpu_torch.fg.batch import replicate_batch
    from pdp_solver_tpu_torch.ops import fused, sp_sweep
    from pdp_solver_tpu_torch.utils.bench_kernels import hub_batch, timed
    E, V, F, B = (batch.num_edges, batch.num_vars, batch.num_clauses,
                  batch.batch_size)
    e = batch.num_real_edges
    shapes = (("shared", batch), ("compacted", compacted),
              ("high_degree", hub_batch()),
              ("shared_replicated", replicate_batch(batch, 2)),
              ("compacted_replicated", replicate_batch(compacted, 2)))
    per_case = {}
    for pi, login in ((0.0, False), (0.01, False), (0.0, True)):
        case = f"login, pi {pi}" if login else f"pi {pi}"
        for label, b in shapes:
            kw = sweep_inputs(b, torch, 31, pi, login)
            cols = tuple(kw.values())
            chain = fused.SP_CHAIN_LOGIN if login else fused.SP_CHAIN

            def one():
                return sp_sweep.sp_full_sweep(b, pi=pi, login=login, **kw)

            def two():
                _, pn, (eta,), _ = fused.chained_edge_pass(chain, b,
                                                           cols[:6])
                _, q = fused.fused_edge_pass(
                    fused.SP_PASS_C, b, (pn[0], pn[1]) + cols[1:4]
                    + cols[5:], scalar=pi)
                return (eta,) + tuple(q)

            def plain():
                return sp_sweep.sp_full_sweep_plain(b, cols, pi, login)

            got, twin = one(), two()
            if label != "high_degree":
                ref = plain()
                torch.cuda.synchronize()
                err = max(_check_sum(torch, "sp_full_sweep", a, r, False)
                          for a, r in zip(got, ref))
            else:
                # one sum of 63,488 log terms: the walk's float32 order
                # against the float64 plain version
                ref = sp_sweep.sp_full_sweep_plain(
                    b, tuple(c.double() for c in cols), pi, login)
                torch.cuda.synchronize()
                require(all(bool(torch.isfinite(a).all()) for a in got),
                        "sp_full_sweep (high_degree): non-finite")
                err = max(float((a.double() - r).abs().max())
                          for a, r in zip(got, ref))
                require(err <= 5e-5, f"sp_full_sweep ({case}, high_degree): "
                        f"max abs err {err:.3g} against float64 > 5e-5")
            bits = all(torch.equal(a, c) for a, c in zip(got, twin))
            require(bits, f"sp_full_sweep ({case}, {label}): not bit-equal "
                    "to its two launches")
            cluster = sp_sweep._plan(b).args.cluster
            if label == "shared":
                per_case[case] = dict(
                    timed(one), max_abs_err=err, bit_equal_two_launch=True,
                    cluster=cluster, plain_ms=cuda_ms(plain, reps=10),
                    two_launch_ms=cuda_ms(two, reps=50))
                r = per_case[case]
            else:
                r = per_case[case][label] = dict(
                    timed(one), max_abs_err=err, cluster=cluster,
                    two_launch_ms=cuda_ms(two, reps=50), edges=b.num_edges)
            log(f"kernel sp_full_sweep ({case}, {label}): ok, max abs err "
                f"{err:.3g} vs plain, bit-equal to the two launches, "
                f"clusters of {cluster}; {timing_note(r)} (two launches "
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
            "max_abs_err": max(max([r["max_abs_err"]] + [
                r[k]["max_abs_err"] for k in ("compacted", "shared_replicated",
                                              "compacted_replicated")])
                for r in cases.values()),
            "ms": main["ms"], "host_us": main["host_us"],
            "device_us": main["device_us"], "cluster": main["cluster"],
            "plain_ms": main["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
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
    """Kernel 10 against its plain version and the split path it
    replaces, exactly on all four outputs: the shared set's graphs with
    planted signs, some variables and clauses inactive, every fourth
    instance already stopped, and a prediction that solves the even
    instances (so some stopped instances are solved, and some active ones
    are frozen by this verification); the same for a compacted batch (the
    first 8 of them) and for the hub instance (one 63,488-edge variable).
    Timed three ways beside the split path."""
    from pdp_solver_tpu_torch.fg.batch import pack_instances
    from pdp_solver_tpu_torch.ops import verify
    from pdp_solver_tpu_torch.problem.state import (
        edge_masks_pair, init_problem_state)
    from pdp_solver_tpu_torch.train.loss import cnf_evaluate
    from pdp_solver_tpu_torch.utils.bench_kernels import hub_instance, timed
    cases = {}
    for label, source in (("shared", insts), ("compacted", insts[:8]),
                          ("high_degree", [hub_instance()])):
        planted, xs = planted_like(source, np, 41)
        batch = pack_instances(planted, device="cuda")
        require(verify.use_verify_masks(batch), "verify_and_masks: the "
                f"planted {label} batch is not eligible")
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
        av = problem.active_vars * (torch.rand(V, generator=g) > 0.1
                                    ).float().cuda()
        ac = problem.active_clauses * (torch.rand(F, generator=g) > 0.1
                                       ).float().cuda()
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
            require(torch.equal(a, b), f"verify_and_masks ({label}): {name} "
                    "differs from the plain version")
            require(torch.equal(a, c), f"verify_and_masks ({label}): {name} "
                    "differs from the split path")
        n_inst = len(source)
        solved = got[0][:n_inst].cpu()
        frozen = int(((act[:n_inst].cpu() > 0) & (solved > 0)).sum())
        require(int(solved.sum()) == (n_inst + 1) // 2 and (
            frozen > 0 or n_inst == 1), f"verify_and_masks ({label}): "
            f"{int(solved.sum())} solved, {frozen} frozen; the check needs "
            "both")
        e = batch.num_real_edges
        # ev, sign and edge_mask, the prediction and av, ac and cm, the
        # clause and instance offsets, the instance flags read once; em and
        # ae, solved and unsat written once; a few operations an edge
        nbytes = (3 * E + 2 * V + 3 * F + 1 + 2 * (B + 1) + 2 * E + 2 * B) * 4
        b_ms, b_by = bound_ms(nbytes, 8 * e)
        split_t = timed(split)
        cases[label] = dict(
            timed(one), cluster=verify._plan(batch).args.cluster,
            bound_ms=b_ms, bound_by=b_by, plain_ms=cuda_ms(plain, reps=10),
            split_path_ms=split_t["ms"], split_path_host_us=split_t["host_us"],
            split_path_device_us=split_t["device_us"],
            solved=int(solved.sum()), frozen_by_this_call=frozen,
            edges=E)
        r = cases[label]
        log(f"kernel verify_and_masks ({label}): exact against the plain "
            f"version and the split path ({r['solved']} of {n_inst} solved, "
            f"{frozen} frozen by this call), clusters of {r['cluster']}; "
            f"{timing_note(r)} (plain {r['plain_ms']:.4f} ms, split path "
            f"{timing_note(split_t)}; bound {b_ms:.5f} ms)")
    main = cases.pop("shared")
    row = {
        "name": "verify_and_masks", "route": "cuda",
        "source": "pdp_solver_tpu_torch/csrc/verify.cu",
        "replaces": "pdp_solver_tpu/ops/pallas_verify.py:170",
        "max_abs_err": 0.0, "library_ms": None,
        "library": "none exists; split_path_ms times the split path it "
                   "replaces (cnf_chain, the freeze, em_ae)"}
    row.update((k, main[k]) for k in (
        "ms", "host_us", "device_us", "cluster", "plain_ms", "bound_ms",
        "bound_by", "split_path_ms", "split_path_host_us",
        "split_path_device_us", "solved", "frozen_by_this_call"))
    row["cases"] = cases
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


def replicated_forward(insts, torch):
    """p-d-p's forward(replication=2) on the shared set at the headline
    settings with REP_ITERATIONS iterations and REP_FLIPS WalkSAT flips,
    check_termination on: every instance's deduplicated solution verified
    with numpy against its CNF and against the solver's own verification
    (raises if they disagree)."""
    from pdp_solver_tpu_torch.fg.batch import pack_instances
    from pdp_solver_tpu_torch.solvers.base import WALKSAT_K
    from pdp_solver_tpu_torch.train.loss import cnf_evaluate
    from pdp_solver_tpu_torch.utils.headline import (
        HEADLINE, headline_solver, verify_solution)
    solver = headline_solver(dict(HEADLINE, ls=REP_FLIPS))
    batch = pack_instances(insts, device="cuda")
    gen = torch.Generator().manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.time()
    state = solver.get_init_state(gen, batch, randomized=True,
                                  replication=2)
    (pred, _), _ = solver.forward({}, gen, batch, state, REP_ITERATIONS,
                                  check_termination=True, replication=2)
    torch.cuda.synchronize()
    wall = time.time() - t0
    require(pred.shape == (batch.num_vars, 1), "the replicated forward's "
            f"prediction has shape {tuple(pred.shape)}")
    sol = (pred[:, 0] > 0.5).float().cpu().numpy()
    ok, off = [], 0
    for inst in insts:
        ok.append(verify_solution(inst, sol[off:off + inst[0]]))
        off += inst[0]
    flags = cnf_evaluate(batch, pred)[0][:len(insts)].cpu().numpy() > 0
    if ok != flags.tolist():
        raise RuntimeError("a solution the solver reports disagrees with "
                           "numpy")
    return {"solved": sum(ok), "wall_s": wall,
            "blocks": REP_FLIPS // WALKSAT_K}


def _tensors(x):
    """The tensors of a state or carry (dataclasses, tuples), in order."""
    import dataclasses
    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


def replicated_card_vs_cpu(insts, torch):
    """Phase 13's forward(replication=2) from one injected state at full
    size, on the card and on the CPU: after one iteration (the sequential
    decimator's first, which fixes nothing) every message and decimator
    column on every edge, padding included, to FLOAT_TOL, and the loop's
    carry (the problem's flags and solution, the active instances, the
    edge mask) exactly; then on to REP_CMP_ITERATIONS on each side from
    its own state, the decimator fixing variables, and the share of
    variables whose active flag or solution differs, which must stay
    under MAX_FORCE_DIFF_SHARE (a near tie of |score| that the order of a
    sum decides can send an instance another way)."""
    from pdp_solver_tpu_torch.fg.batch import pack_instances, replicate_batch
    from pdp_solver_tpu_torch.utils.headline import HEADLINE, headline_solver
    solver = headline_solver(dict(HEADLINE, ls=REP_FLIPS))
    runs = {}
    for dev in ("cuda", "cpu"):
        batch = pack_instances(insts, device=dev)
        gen = torch.Generator().manual_seed(0)
        state = solver.get_init_state(gen, batch, randomized=True,
                                      replication=2)
        _, s1, c1 = solver.forward({}, gen, batch, state, 1,
                                   check_termination=True, finalize=False,
                                   replication=2)
        runs[dev] = [replicate_batch(batch, 2), s1, c1]
    (bg, sg, cg), (bc, sc, cc) = runs["cuda"], runs["cpu"]
    msg_err = 0.0
    for a, b in zip(_tensors(sg), _tensors(sc)):
        a = a.cpu()
        require(a.shape == b.shape, "replicated card vs cpu: state shapes "
                "differ")
        if a.is_floating_point():
            msg_err = max(msg_err, float((a - b).abs().max()))
            require(torch.allclose(a, b, **FLOAT_TOL), "replicated card vs "
                    f"cpu: states differ by {msg_err} after 1 iteration")
    carry_g, carry_c = _tensors(cg), _tensors(cc)
    for a, b in zip(carry_g, carry_c):
        require(torch.equal(a.cpu(), b), "replicated card vs cpu: the "
                "problem, flags or edge mask differ after 1 iteration")
    for dev, run in runs.items():
        b, st, carry = run
        _, run[1], run[2] = solver.forward(
            {}, torch.Generator().manual_seed(1), b, st,
            REP_CMP_ITERATIONS - 1,
            check_termination=True, carry=carry, finalize=False,
            replication=2)
    pg, pc = runs["cuda"][2][0], runs["cpu"][2][0]
    real = bc.var_mask > 0
    differ = ((pg.active_vars.cpu() != pc.active_vars)
              | (pg.solution.cpu() != pc.solution)) & real
    share = float(differ.sum()) / float(real.sum())
    fixed = int(((pc.active_vars == 0) & real).sum())
    flags = int((runs["cuda"][2][1].cpu() != runs["cpu"][2][1]).sum())
    require(share < MAX_FORCE_DIFF_SHARE, f"replicated card vs cpu: "
            f"{share:.4%} of the variables differ after "
            f"{REP_CMP_ITERATIONS} iterations")
    return {"state_max_abs_err": msg_err, "var_diff_share": share,
            "inactive_vars": fixed, "flag_diffs": flags}


def neural_bf16_check(torch):
    """np-nd-np with the r3 weights on neural.BF16_CHECK's instances from
    one state drawn with numpy (neural.np_nd_np_state, the state the JAX
    package's figures were taken from), in f32 and bf16 on the card and
    in bf16 on the CPU, continued through neural.BF16_CHECK_HORIZONS (5
    and 10 iterations). At each: the card's and the CPU's active flags
    equal, and the card's f32-against-bf16 max |prediction difference|
    and its bf16 predictions' difference from the CPU's each at most
    neural.BF16_DRIFT_RATIO times JAX's own f32-against-bf16 difference
    there (neural.BF16_CHECK_JAX_DRIFT; two roundings of one function
    differ by no more than either differs from f32)."""
    from pdp_solver_tpu_torch.fg.batch import pack_instances
    from pdp_solver_tpu_torch.utils import neural
    from pdp_solver_tpu_torch.utils.benchdata import make_ksat_set
    insts = make_ksat_set(**neural.BF16_CHECK)
    runs = {}
    for dev, dtypes in (("cuda", ("float32", BF16)), ("cpu", (BF16,))):
        batch = pack_instances(insts, device=dev)
        state = neural.np_nd_np_state(batch.num_edges)
        params = neural.np_nd_np_params(dev)
        for dt in dtypes:
            runs[(dev, dt)] = neural.bf16_check_forward(params, batch, state,
                                                        dt)
    real = batch.var_mask > 0
    out = {}
    for i, h in enumerate(neural.BF16_CHECK_HORIZONS):
        (pf, _), (pb, ab), (pc, ac) = (
            runs[k][i] for k in (("cuda", "float32"), ("cuda", BF16),
                                 ("cpu", BF16)))
        jax_d = neural.BF16_CHECK_JAX_DRIFT[h]
        limit = neural.BF16_DRIFT_RATIO * jax_d
        drift = float((pf - pb)[real].abs().max())
        card_cpu = float((pb - pc)[real].abs().max())
        require(torch.equal(ab, ac), f"np-nd-np bf16 card vs cpu: active "
                f"flags differ after {h} iterations ({ab.tolist()} vs "
                f"{ac.tolist()})")
        require(drift <= limit, f"np-nd-np f32 against bf16 on the card: "
                f"max |prediction difference| {drift} > {limit} after {h} "
                f"iterations (JAX's own {jax_d})")
        require(card_cpu <= limit, f"np-nd-np bf16 card vs cpu: max "
                f"|prediction difference| {card_cpu} > {limit} after {h} "
                f"iterations")
        out[h] = dict(f32_bf16=drift, card_cpu=card_cpu, jax=jax_d,
                      limit=limit, solved=int((ab == 0).sum()))
    return out


def bf16_small_check(torch):
    """The JAX package's tests/test_bf16.py on the card: np-nd-np at
    BF16_SMALL's widths with fresh parameters (torch's default generator
    seeded with 0), three random 3-SAT instances of 10 variables and 25
    clauses, BF16_SMALL_ITERATIONS iterations with check_termination from
    one state in f32 and in bf16: the predictions finite and within
    MAX_BF16_PRED_DIFF of each other. Returns the max |difference|."""
    from pdp_solver_tpu_torch.fg.batch import pack_instances
    from pdp_solver_tpu_torch.solvers.base import PDPSolver, SolverConfig
    from pdp_solver_tpu_torch.utils.benchdata import make_ksat_set
    batch = pack_instances(make_ksat_set(seed=2, count=3, n=10, alpha=2.5,
                                         k=3), device="cuda")
    solvers = [PDPSolver(SolverConfig(model_type="np-nd-np",
                                      compute_dtype=dt, **BF16_SMALL))
               for dt in ("float32", BF16)]
    with torch.random.fork_rng(devices=[]):
        torch.random.default_generator.manual_seed(0)
        params = solvers[0].init_params("cuda")
    state = solvers[0].get_init_state(torch.Generator().manual_seed(1),
                                      batch, randomized=True)
    pred = [sv.forward(params, torch.Generator().manual_seed(2), batch,
                       state, BF16_SMALL_ITERATIONS,
                       check_termination=True)[0][0] for sv in solvers]
    diff = float((pred[0] - pred[1]).abs().max())
    require(pred[1].dtype == torch.float32
            and bool(torch.isfinite(pred[1]).all())
            and diff <= MAX_BF16_PRED_DIFF, f"tests/test_bf16.py's check on "
            f"the card: max |f32 - bf16 prediction| {diff} > "
            f"{MAX_BF16_PRED_DIFF} (or not finite)")
    return diff


def reset_counts():
    from pdp_solver_tpu_torch.ops import (
        fused, reduce, reduce2d, sp_sweep, verify, walksat)
    fused.fused_edge_pass.launches = 0
    fused.fused_edge_pass.launches_by_fn = {}
    fused.chained_edge_pass.launches = 0
    fused.chained_edge_pass.launches_by_fn = {}
    walksat.walksat_walk.launches = 0
    reduce2d.segment_sum_2d.launches = 0
    reduce2d.segment_sum_2d.launches_bf16 = 0
    reduce2d.gather_2d.launches = 0
    reduce2d.gather_2d.launches_bf16 = 0
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
    launches["walksat_walk"] = walksat.walksat_walk.launches
    launches["segment_sum_2d"] = reduce2d.segment_sum_2d.launches
    launches["gather_2d"] = reduce2d.gather_2d.launches
    launches["segment_sum_2d[bf16]"] = reduce2d.segment_sum_2d.launches_bf16
    launches["gather_2d[bf16]"] = reduce2d.gather_2d.launches_bf16
    launches["segment_sum_cols"] = reduce.segment_sum_cols.launches
    launches["segment_sum_cols_by_form"] = dict(
        reduce.segment_sum_cols.launches_by_form)
    launches["sp_full_sweep"] = sp_sweep.sp_full_sweep.launches
    launches["sp_full_sweep[login]"] = (
        sp_sweep.sp_full_sweep.launches_by_form.get("login", 0))
    launches["verify_and_masks"] = verify.verify_and_masks.launches
    return launches


def require_bf16_path(launches, what, gather):
    """A bf16 path went through kernels 6 (and 7) on bf16 rows and never
    through their f32 instantiations."""
    require(launches["segment_sum_2d[bf16]"] > 0
            and (launches["gather_2d[bf16]"] > 0 or not gather),
            f"{what} in bf16 never launched the bf16 kernels 6/7")
    require(launches["segment_sum_2d"] == 0 and launches["gather_2d"] == 0,
            f"{what} in bf16 launched an f32 [E, d] kernel")


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
        for name, errs in check_kernels_replicated(insts, torch).items():
            rows[name]["replicated_max_abs_err"] = errs
        rows.update(check_reduce2d(batch, torch))
        rows.update(check_reduce2d_bf16(
            batch, pack_instances(insts[:8], device="cuda"), torch))
        rows.update(check_reduce(batch, torch, np))
        for name, per_case in check_walk(insts, torch, np).items():
            rows[name]["walk_cases"] = per_case
        rows.update(check_walksat(insts, torch, np))
        rows.update(check_walksat_replicated(insts, torch, np))
        rows.update(check_sp_sweep(
            batch, pack_instances(insts[:8], device="cuda"), torch))
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
        require(wlaunches["walksat_walk"] > 0,
                "walk-sat never launched walksat_walk")

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

        from pdp_solver_tpu_torch.utils.neural import (
            np_d_np_3sat_band, np_d_np_params, solve_np_d_np)
        dparams = np_d_np_params()
        dres, dlaunches = run_path(lambda: solve_np_d_np(
            insts, seed=0, params=dparams))
        log(f"phase 10 np-d-np path: solved {dres['solved']}/{len(insts)} "
            f"(verified with numpy; the JAX package's records: "
            f"{JAX_NP_D_NP} of {len(insts)}, seeds 0-2) in "
            f"{dres['wall_s']:.2f} s; loop {dres['loop_wall_s']} s, walksat "
            f"{dres['ls_wall_s']} s, {dres['chunks']} chunks, "
            f"{dres['compactions']} compactions, progress "
            f"{dres['progress']}")
        log(f"launches on the np-d-np path: {json.dumps(dlaunches)}")
        for name in NP_D_NP_KERNELS:
            require(dlaunches.get(name, 0) > 0,
                    f"np-d-np never launched {name}")

        band = np_d_np_3sat_band(dparams)
        fresh = np_d_np_3sat_band(np_d_np_params(trained=False, seed=0))
        log(f"phase 11 np-d-np on the medium 3-SAT band (48 instances, n 60,"
            f" alpha 3.5, 300 iterations, decimation only): trained "
            f"{band['solved']}/48 = {band['solved_fraction']:.4f} (JAX "
            f"{JAX_BAND['trained']}), fresh init {fresh['solved']}/48 = "
            f"{fresh['solved_fraction']:.4f} (JAX untrained "
            f"{JAX_BAND['untrained']}), verified with numpy; "
            f"{band['wall_s']:.2f} s and {fresh['wall_s']:.2f} s")
        require(band["solved"] >= MIN_BAND_SOLVED,
                f"np-d-np solved {band['solved']}/48 of the band < "
                f"{MIN_BAND_SOLVED}")
        gain = band["solved_fraction"] - fresh["solved_fraction"]
        require(gain >= MIN_BAND_GAIN, "the trained np-d-np beats its "
                f"fresh init by {gain:.4f} < {MIN_BAND_GAIN}")

        xres, xlaunches = run_path(lambda: solve_headline(
            insts, seed=0, replicas=2))
        log(f"phase 12 p-d-p compacting_solve(replicas=2): solved "
            f"{xres['solved']}/{len(insts)} = {xres['solved_fraction']:.4f}"
            f" (verified with numpy; phase 3 with one slot an instance "
            f"solved {res['solved']}) in {xres['wall_s']:.2f} s; attempts "
            f"{xres['attempt_solved']}, pdp {xres['pdp_wall_s']} s, walksat "
            f"{xres['ls_wall_s']} s, {xres['compactions']} compactions")
        log(f"launches on the replicas=2 path: {json.dumps(xlaunches)}")
        require(xres["solved_fraction"] >= MIN_SOLVED,
                f"p-d-p with replicas=2 solved {xres['solved_fraction']} < "
                f"{MIN_SOLVED}")

        fres, flaunches = run_path(lambda: replicated_forward(insts, torch))
        log(f"phase 13 p-d-p forward(replication=2) on the shared set "
            f"({REP_ITERATIONS} iterations, {REP_FLIPS} flips, "
            f"check_termination): {fres['solved']}/{len(insts)} "
            f"deduplicated solutions verified with numpy (the solver's "
            f"flags agree) in {fres['wall_s']:.2f} s; "
            f"{flaunches['walksat_walk']} walk launches for "
            f"{fres['blocks']} blocks")
        log(f"launches on the replicated forward: {json.dumps(flaunches)}")
        require(flaunches["walksat_walk"] == fres["blocks"],
                f"the replicated walk launched {flaunches['walksat_walk']} "
                f"times for {fres['blocks']} blocks")
        rcmp = replicated_card_vs_cpu(insts, torch)
        log(f"phase 13 replicated card vs cpu: every state column on every "
            f"edge within rtol {FLOAT_TOL['rtol']} / atol "
            f"{FLOAT_TOL['atol']} (max abs err "
            f"{rcmp['state_max_abs_err']:.3g}) and the carry exact after 1 "
            f"iteration; after {REP_CMP_ITERATIONS}, "
            f"{rcmp['var_diff_share']:.4%} of the variables differ "
            f"({rcmp['inactive_vars']} inactive on the CPU), "
            f"{rcmp['flag_diffs']} instance flags differ")

        # seeds 0-2 of p-d-p and reinforce beside earlier counts (seed 0
        # is phases 3 and 6)
        pdp = [res["solved"]] + [solve_headline(insts, seed=k)["solved"]
                                 for k in (1, 2)]
        rnf = [rres["solved"]] + [solve_reinforce(insts, seed=k)["solved"]
                                  for k in (1, 2)]
        log(f"seeds 0-2 (of {len(insts)}, verified with numpy): p-d-p "
            f"{pdp} (before kernel 2's walk: {PRIOR_SOLVED['p-d-p']}); "
            f"reinforce {rnf} (before: {PRIOR_SOLVED['reinforce']})")

        from pdp_solver_tpu_torch.utils.neural import (
            flagship_settings, solve_flagship)
        hres, hlaunches = run_path(lambda: solve_np_nd_np(
            insts, seed=0, compute_dtype=BF16))
        hfrac = hres["solved_fraction"]
        log(f"phase 15 np-nd-np in bf16: solved {hfrac:.4f} "
            f"({hres['solved']}/{len(insts)}, verified with numpy; phase 4 "
            f"in f32 solved {nres['solved']}) in {hres['wall_s']:.2f} s; "
            f"loop {hres['loop_wall_s']} s, walksat {hres['ls_wall_s']} s, "
            f"{hres['chunks']} chunks, {hres['compactions']} compactions, "
            f"progress {hres['progress']}")
        log(f"launches on the np-nd-np bf16 path: {json.dumps(hlaunches)}")
        require(hfrac >= MIN_SOLVED_NEURAL, f"np-nd-np in bf16 solved "
                f"{hfrac} < {MIN_SOLVED_NEURAL}")
        require_bf16_path(hlaunches, "np-nd-np", gather=True)
        small = bf16_small_check(torch)
        log(f"phase 15 tests/test_bf16.py's check on the card (np-nd-np at "
            f"hidden 16, fresh parameters, 3 instances of 10 variables, "
            f"{BF16_SMALL_ITERATIONS} iterations): max |f32 - bf16 "
            f"prediction| {small:.4g} (gate {MAX_BF16_PRED_DIFF})")
        for h, c in neural_bf16_check(torch).items():
            log(f"phase 15 np-nd-np r3 from one state after {h} iterations "
                f"(16 instances, {c['solved']} solved, flags equal card vs "
                f"cpu): max |f32 - bf16 prediction| on the card "
                f"{c['f32_bf16']:.4g}, bf16 card vs cpu {c['card_cpu']:.4g}"
                f" (JAX's own f32 - bf16 {c['jax']}; gate {c['limit']:.4g})")

        p16, p16launches = run_path(lambda: solve_p_nd_np(
            insts, seed=0, compute_dtype=BF16))
        log(f"phase 16 p-nd-np in bf16: solved {p16['solved']}/{len(insts)}"
            f" (verified with numpy; phase 8 in f32 solved {pres['solved']})"
            f" in {p16['wall_s']:.2f} s; loop {p16['loop_wall_s']} s, "
            f"progress {p16['progress']}")
        log(f"launches on the p-nd-np bf16 path: {json.dumps(p16launches)}")
        require(p16["solved"] >= MIN_SOLVED_P_ND_NP, f"p-nd-np in bf16 "
                f"solved {p16['solved']} < {MIN_SOLVED_P_ND_NP}")
        require_bf16_path(p16launches, "p-nd-np", gather=False)

        band16, d16launches = run_path(lambda: np_d_np_3sat_band(
            np_d_np_params(), compute_dtype=BF16))
        log(f"phase 17 np-d-np in bf16 on the medium 3-SAT band: "
            f"{band16['solved']}/48 = {band16['solved_fraction']:.4f} "
            f"(verified with numpy; phase 11 in f32 {band['solved']}/48) in "
            f"{band16['wall_s']:.2f} s")
        log(f"launches on the np-d-np bf16 band: {json.dumps(d16launches)}")
        require(band16["solved"] >= MIN_BAND_SOLVED, f"np-d-np in bf16 "
                f"solved {band16['solved']}/48 of the band < "
                f"{MIN_BAND_SOLVED}")
        require_bf16_path(d16launches, "np-d-np", gather=True)

        gres, glaunches = run_path(lambda: solve_flagship(insts, seed=0))
        fs = flagship_settings()
        log(f"phase 18 the flagship config (PDP-np-nd-np-trained.yaml: "
            f"np-nd-np-full, bf16, {fs['iterations']} iterations, "
            f"{fs['ls']} flips, epsilon {fs['epsilon']}): solved "
            f"{gres['solved']}/{len(insts)} (verified with numpy; recorded "
            f"only) in {gres['wall_s']:.2f} s; loop {gres['loop_wall_s']} s,"
            f" walksat {gres['ls_wall_s']} s, progress {gres['progress']}")
        log(f"launches on the flagship path: {json.dumps(glaunches)}")
        require_bf16_path(glaunches, "the flagship", gather=True)

        # each row carries the launches of the path it serves
        serves = {"segment_sum_2d": nlaunches, "gather_2d": nlaunches,
                  "segment_sum_2d[bf16]": hlaunches,
                  "gather_2d[bf16]": hlaunches,
                  "scorer": rlaunches, "segment_sum_cols": rlaunches,
                  "segment_sum_cols[ragged]": rlaunches,
                  "sorted_segment_sum": rlaunches,
                  "sp_full_sweep": slaunches, "sp_chain_login": plaunches,
                  "sp_full_sweep[login]": qlaunches,
                  "verify_and_masks": qlaunches, "smax": dlaunches,
                  "walksat_walk[replicas=2]": flaunches}
        path_rows = []
        for name, row in rows.items():
            path = serves.get(name, launches)
            # rows 5 and 8 run the CUDA kernel of row 4; both WalkSAT
            # rows are walksat_walk's launches
            key = ("segment_sum_cols" if name.startswith(
                ("segment_sum_cols", "sorted_segment_sum"))
                else "walksat_walk" if name.startswith("walksat")
                else name)
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
