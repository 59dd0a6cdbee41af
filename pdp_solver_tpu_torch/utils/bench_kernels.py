"""Times the CSR segment sum (kernels 4, 5, 8), the fused and chained edge
passes (kernels 1, 2), WalkSAT (kernel 3), the one-launch SP sweep (kernel
9), the verification with masks (kernel 10) and the [E, d] sum and gather
(kernels 6 and 7) on one CUDA card, beside the PyTorch call for the same
function where there is one.

    python pdp_solver_tpu_torch/utils/bench_kernels.py [--label NAME]
        [--only STRING ...]

On the shared set (128 instances of 4-SAT, n=100, alpha=9: E = 524,288
padded / 460,800 real edges), on a compacted batch (its first 8
instances, a 32,768-edge bucket), at high degree (a var CSR with one
63,488-edge node; the shared set's clause ids over all E edges, whose
last run holds the 63,488 padding edges) and, for WalkSAT, on one large
banded instance (`large_instance`: 30,000 variables, 126,000 clauses), it
gives for each form:
  ms        ms / call, CUDA events over 50 back-to-back calls;
  host_us   host us / call, perf_counter over 500 calls with no
            synchronize, after a warm-up;
  device_us device us / call, the profiler's kernel times over 500 calls
            (and by kernel name).
The forms: "chained_edge_pass[name]" for the five chained functors;
"sp_full_sweep[pi 0]", "[pi 0.01]" and "[login]"; "verify_and_masks"
and "verify split" (the split path it replaces: cnf_evaluate, the freeze,
edge_masks_pair); "walksat_block" (K = 8, eps 0.5, from a problem with
some variables and clauses inactive and a random prediction), "walksat_block
unsat" (from a random fill, every instance unsat) and "walksat 25 blocks"
(a 200-flip chunk of the local search from that fill: one call where the
tree has `walksat_walk`, else 25 `walksat_block` calls; on one-instance
batches 5 calls instead of 50 and 500); "gather_2d" and
"gather_2d minus" at np-nd-np's width (d = 50) with i64 ids, the same
with " i32" ids (`edge_var32`), "gather_2d minus i32 bf16" (f32 node rows
minus bf16 rows, the bf16 aggregators' form), and "index_select", the
gather's PyTorch call; "segment_sum_2d var" (kernel 6 at d = 50, beside
index_add_), "segment_sum_2d var bf16" and "segment_sum_2d clause bf16"
(bf16 rows into f32 sums, over the var and the clause CSR). --only
keeps the forms whose names contain one of the strings given. It
prints one JSON line with the card's name and power limit. It uses
only the wrappers' public functions, so it times any tree of the
package that PYTHONPATH puts first: run it on two trees in one call to
compare them on one card (a form that a tree refuses, such as i32 ids
before they were taken, is recorded as its error). Needs a CUDA card;
exits 2 without one.
"""

import argparse
import inspect
import json
import subprocess
import sys
import time

import numpy as np
import torch

HOST_REPS = 500


def host_us(fn, reps=HOST_REPS):
    """Microseconds of host time a call: perf_counter over back-to-back
    calls with no synchronize, after a warm-up."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def device_us(fn, reps=HOST_REPS):
    """Microseconds of device time a call, and by kernel name: the
    profiler's kernel times over back-to-back calls (as
    utils/profile_solve.py reads them)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by = {}
    for evt in prof.key_averages():
        us = 0.0
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if getattr(evt, attr, None) is not None:
                us = float(getattr(evt, attr))
                break
        if us > 0 and "cuda" in str(getattr(evt, "device_type", "")).lower():
            by[evt.key[:90]] = round(us / reps, 3)
    return sum(by.values()), by


def cuda_ms(fn, reps=50, warmup=2):
    """ms / call: CUDA events around back-to-back calls."""
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


def timed(fn, reps=50, host_reps=HOST_REPS):
    """ms / call (CUDA events), host us / call and device us / call."""
    dev, by = device_us(fn, host_reps)
    return {"ms": cuda_ms(fn, reps=reps), "host_us": host_us(fn, host_reps),
            "device_us": dev, "device_kernels": by}


def hub_instance(degree=63488, n=300, k=3, seed=5):
    """One instance (n, m, graph map, signs, label) whose variable 0 sits
    in every one of its `degree` clauses."""
    rng = np.random.default_rng(seed)
    v = rng.integers(1, n, size=(degree, k))
    v[:, 0] = 0
    ec = np.repeat(np.arange(degree), k)
    signs = rng.choice([-1.0, 1.0], degree * k).astype(np.float32)
    return (n, degree, np.stack([v.reshape(-1), ec]).astype(np.int32), signs,
            -1.0)


def hub_batch(**kw):
    """hub_instance packed on the card: a var CSR with one node of
    `degree` edges."""
    from pdp_solver_tpu_torch.fg.batch import pack_instances
    return pack_instances([hub_instance(**kw)], device="cuda")


def large_instance(n=30000, alpha=4.2, k=3, window=512, seed=7):
    """One random k-SAT instance (n, m, graph map, signs, label) of n
    variables whose clause c draws its k distinct variables from a window
    of `window` variables sliding with c (a banded instance, as a
    bandwidth-reducing order leaves one): the windowed invariants hold, so
    the WalkSAT block rule takes it with n above what one CTA can hold in
    shared memory."""
    rng = np.random.default_rng(seed)
    m = int(n * alpha)
    lo = np.clip(np.arange(m) * n // m - window // 2, 0, n - window)
    off = rng.integers(0, window, size=(m, k))
    while True:
        srt = np.sort(off, axis=1)
        dup = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
        if not dup.any():
            break
        off[dup] = rng.integers(0, window, size=(int(dup.sum()), k))
    v = (lo[:, None] + off).reshape(-1)
    ec = np.repeat(np.arange(m), k)
    signs = rng.choice([-1.0, 1.0], m * k).astype(np.float32)
    return (n, m, np.stack([v, ec]).astype(np.int32), signs, -1.0)


# the block seeds of a timed WalkSAT chunk (200 flips: 25 blocks of 8)
WALK_SEEDS = [5 + 7919 * j for j in range(25)]


def walk_inputs(batch, fill):
    """WalkSAT's inputs (assign, active_vars, active_clauses, em) on a
    batch on the card. fill "half": _verify_inputs' problem state (some
    variables and clauses inactive) and its random prediction; "unsat": a
    random fill of every variable, all active, as the WalkSAT phase
    starts, which leaves every instance of these batches unsat."""
    if fill == "half":
        problem, _, pred = _verify_inputs(batch)
        av, ac = problem.active_vars, problem.active_clauses
        assign = av * (pred[:, 0] > 0.5).float() * 2 - av
    else:
        g = torch.Generator().manual_seed(11)
        av, ac = batch.var_mask, batch.clause_mask
        assign = av * (torch.randint(0, 2, (batch.num_vars,), generator=g)
                       .float().cuda() * 2 - 1)
    em = batch.edge_mask * av[batch.edge_var] * ac[batch.edge_clause]
    return assign, av, ac, em


HIDDEN_AGG = 50     # np-nd-np's mem_agg_hidden_dim, the gather's width


def _fused_inputs(fn, batch, seed):
    """Columns drawn like the ones they stand for: signs and masks of the
    batch, 0/1 activity flags, +-1 assignments, log u for the log-input
    sweep, floats in [0, 1) otherwise."""
    g = torch.Generator().manual_seed(seed)
    sizes = {"V": batch.num_vars, "F": batch.num_clauses,
             "E": batch.num_edges}
    out = []
    for kind, name in zip(fn.layout, fn.inputs):
        u = torch.rand(sizes[kind], generator=g).cuda()
        if name == "sign":
            u = batch.edge_sign
        elif name in ("mask", "bmask"):
            u = batch.edge_mask
        elif name in ("em", "av", "ac", "cm"):
            u = (u > 0.2).float()
        elif name == "sa":
            u = torch.where(u > 0.5, 1.0, -1.0)
        elif name == "log_u_in":
            u = torch.log(u * 0.96 + 0.02)
        out.append(u.contiguous())
    return out


def _sweep_inputs(batch, pi, login):
    g = torch.Generator().manual_seed(7)
    E = batch.num_edges

    def u():
        return torch.rand(E, generator=g).cuda()

    u_like = u() * 0.99 + 0.01
    v = torch.rand(E, 3, generator=g).cuda()
    v = v / v.sum(1, keepdim=True)
    return dict(u_like=torch.log(u_like) if login else u_like,
                eta_in=u() * 0.99, em=batch.edge_mask * (u() > 0.1).float(),
                mask=(u() > 0.2).float(), eta_state=u(),
                sign=batch.edge_sign,
                force=(torch.where(u() > 0.5, 1.0, -1.0) if pi
                       else torch.zeros(E, device="cuda")),
                v0=v[:, 0].contiguous(), v1=v[:, 1].contiguous(),
                v2=v[:, 2].contiguous())


def _verify_inputs(batch):
    """A problem state with some variables and clauses inactive, every
    fourth instance stopped and a random prediction f32[V, 1]."""
    from pdp_solver_tpu_torch.problem.state import init_problem_state
    g = torch.Generator().manual_seed(9)
    problem = init_problem_state(batch)
    av = problem.active_vars * (
        torch.rand(batch.num_vars, generator=g) > 0.1).float().cuda()
    ac = problem.active_clauses * (
        torch.rand(batch.num_clauses, generator=g) > 0.1).float().cuda()
    act = batch.instance_mask.clone()
    act[::4] = 0.0
    pred = torch.rand(batch.num_vars, 1, generator=g).cuda()
    return problem.replace(active_vars=av, active_clauses=ac), act, pred


def bench_batch(batch, forms, only=None):
    """{form: numbers} for the forms named (those that contain one of the
    strings `only`, when given), on one batch."""
    if only:
        forms = [f for f in forms if any(o in f for o in only)]
    from pdp_solver_tpu_torch.ops import fused, reduce, reduce2d, sp_sweep
    g = torch.Generator().manual_seed(3)
    E, e = batch.num_edges, batch.num_real_edges
    out = {}
    csr = {"var": (batch.edge_var, batch.num_vars, batch.var_ptr,
                   batch.var_perm),
           "clause": (batch.edge_clause, batch.num_clauses, batch.clause_ptr,
                      None)}
    for form in forms:
        reps = None
        if form.startswith("segment_sum_2d"):
            # "segment_sum_2d var", "segment_sum_2d var bf16" (bf16 rows,
            # f32 sums), "segment_sum_2d clause bf16"
            side = form.split()[1]
            ids, n, ptr, perm = csr[side]
            x2 = torch.rand(E, HIDDEN_AGG, generator=g).cuda()
            if form.endswith("bf16"):
                x2 = x2.to(torch.bfloat16)

            def call():
                return reduce2d.segment_sum_2d(x2, ids, n, e, ptr, perm)
            acc = torch.zeros(n, HIDDEN_AGG, device="cuda", dtype=x2.dtype)
            x_real, ids_real = x2[:e], ids[:e]

            def lib():
                return acc.index_add_(0, ids_real, x_real)
        elif form.startswith("segment_sum"):
            # "segment_sum var C=2" ([E, 2] rows), "segment_sum_cols var
            # C=1", "segment_sum_cols clause C=1"
            what, side, cc = form.split()
            C = int(cc[2:])
            ids, n, ptr, perm = csr[side]
            # the pack-time largest degree, as the solve path passes it,
            # where the tree's wrappers take it
            kw = ({"max_degree": getattr(batch, f"{side}_max_degree")}
                  if "max_degree" in inspect.signature(
                      reduce.segment_sum).parameters else {})
            x = torch.rand(E, C, generator=g).cuda()
            cols = [x[:, c].contiguous() for c in range(C)]
            if what == "segment_sum":
                def call():
                    return reduce.segment_sum(x, ids, n, e, ptr, perm, **kw)
            else:
                def call():
                    return reduce.segment_sum_cols(cols, ids, n, e, ptr,
                                                   perm, **kw)
            acc = torch.zeros(C, n, device="cuda")
            xs = torch.stack([c[:e] for c in cols])
            ids_real = ids[:e]

            def lib():
                return acc.index_add_(1, ids_real, xs)
        elif form.startswith("sorted_segment_sum"):
            # "sorted_segment_sum real" (the real edges' clause ids) or
            # "sorted_segment_sum all" (every edge, padding included)
            ids = (batch.edge_clause[:e] if form.endswith("real")
                   else batch.edge_clause)
            n = batch.num_clauses
            xf = torch.rand(ids.shape[0], generator=g).cuda()
            acc = torch.zeros(n, device="cuda")

            def call():
                return reduce.sorted_segment_sum(xf, ids, n)

            def lib():
                return acc.index_add_(0, ids, xf)
        elif form.startswith("sp_full_sweep"):
            # "sp_full_sweep[pi 0]", "[pi 0.01]", "[login]"
            case = form[len("sp_full_sweep["):-1]
            pi = 0.01 if case == "pi 0.01" else 0.0
            login = case == "login"
            kw = _sweep_inputs(batch, pi, login)

            def call():
                return sp_sweep.sp_full_sweep(batch, pi=pi, login=login,
                                              **kw)

            lib = None
        elif form.startswith("verify"):
            # "verify_and_masks" (kernel 10), "verify split" (the split
            # path it replaces)
            from pdp_solver_tpu_torch.ops import verify
            from pdp_solver_tpu_torch.problem.state import edge_masks_pair
            from pdp_solver_tpu_torch.train.loss import cnf_evaluate
            problem, act, pred = _verify_inputs(batch)
            if form == "verify_and_masks":
                def call():
                    return verify.verify_and_masks(batch, problem, act, pred)
            else:
                def call():
                    solved, _ = cnf_evaluate(batch, pred)
                    return edge_masks_pair(
                        batch, problem, act * (solved <= 0.5).float())
            lib = None
        elif form.startswith("walksat"):
            # "walksat_block" (K = 8 from walk_inputs' "half" fill),
            # "walksat_block unsat" (from the "unsat" fill) and "walksat
            # 25 blocks" (the fill's first WalkSAT chunk of 200 flips in
            # one walksat_walk call)
            from pdp_solver_tpu_torch.ops import walksat
            assign, av, ac, em = walk_inputs(
                batch, "half" if form == "walksat_block" else "unsat")
            kw = dict(batch=batch, active_vars=av, active_clauses=ac, em=em,
                      K=8, eps=0.5,
                      edge_constants=walksat.walksat_edge_constants(batch,
                                                                    av))
            if not form.endswith("25 blocks"):
                def call():
                    return walksat.walksat_block(assign, seed=5, **kw)
            else:
                def call():
                    return walksat.walksat_walk(assign, seeds=WALK_SEEDS,
                                                **kw)
            # one instance of 63,488 or 126,000 clauses walks for ms
            reps = 5 if batch.num_instances == 1 else None
            lib = None
        elif form.startswith(("gather_2d", "index_select")):
            # "gather_2d[ minus][ i32][ bf16]", "index_select"
            nodes = torch.rand(batch.num_vars, HIDDEN_AGG, generator=g).cuda()
            minus = (torch.rand(E, HIDDEN_AGG, generator=g).cuda()
                     if "minus" in form else None)
            if form.endswith("bf16"):
                minus = minus.to(torch.bfloat16)
            ids = batch.edge_var32 if " i32" in form else batch.edge_var
            if form == "index_select":
                def call():
                    return nodes.index_select(0, ids)
            else:
                def call():
                    return reduce2d.gather_2d(nodes, ids, minus)
            lib = None
        else:
            # "fused_edge_pass[name]", "chained_edge_pass[name]"
            kind, name = form[:-1].split("[")
            fn = getattr(fused, name.upper())
            ins = _fused_inputs(fn, batch, 5)
            wrapper = getattr(fused, kind)

            def call():
                return wrapper(fn, batch, ins)

            lib = None
            if fn.name == "ae":
                def lib():
                    return ins[0][batch.edge_var]
        try:
            row = (timed(call) if reps is None
                   else timed(call, reps=reps, host_reps=reps))
        except (RuntimeError, ValueError) as err:
            out[form] = {"error": str(err)[:200]}
            continue
        if lib is not None:
            row["library"] = timed(lib)
        out[form] = row
    return out


CHAINED_FORMS = tuple(f"chained_edge_pass[{name}]" for name in (
    "sp_chain", "sp_chain_login", "sround", "cnf_chain", "ws_chain"))
SWEEP_FORMS = ("sp_full_sweep[pi 0]", "sp_full_sweep[pi 0.01]",
               "sp_full_sweep[login]")
VERIFY_FORMS = ("verify_and_masks", "verify split")
WALK_FORMS = ("walksat_block", "walksat_block unsat", "walksat 25 blocks")
GATHER_FORMS = ("gather_2d", "gather_2d minus", "gather_2d i32",
                "gather_2d minus i32", "gather_2d minus i32 bf16",
                "index_select", "segment_sum_2d var",
                "segment_sum_2d var bf16", "segment_sum_2d clause bf16")
SHARED_FORMS = ("segment_sum var C=2", "segment_sum_cols var C=1",
                "segment_sum_cols clause C=1", "sorted_segment_sum real",
                "fused_edge_pass[ae]", "fused_edge_pass[em]",
                "fused_edge_pass[em_ae]", "fused_edge_pass[sp_pass_c]",
                "fused_edge_pass[smax_scorer]", "fused_edge_pass[scorer]") \
    + WALK_FORMS + CHAINED_FORMS + SWEEP_FORMS + VERIFY_FORMS \
    + GATHER_FORMS
COMPACTED_FORMS = ("segment_sum var C=2", "segment_sum_cols var C=1",
                   "segment_sum_cols clause C=1", "sorted_segment_sum real",
                   "fused_edge_pass[ae]", "fused_edge_pass[smax_scorer]",
                   "fused_edge_pass[scorer]") + WALK_FORMS + CHAINED_FORMS \
    + SWEEP_FORMS + VERIFY_FORMS + GATHER_FORMS


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="", help="a name for this tree")
    ap.add_argument("--only", nargs="*", help="time only the forms whose "
                    "names contain one of these strings")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA card", file=sys.stderr)
        return 2
    from pdp_solver_tpu_torch.fg.batch import pack_instances
    from pdp_solver_tpu_torch.ops import _build
    from pdp_solver_tpu_torch.utils.benchdata import make_ksat_set
    _build.library()
    insts = make_ksat_set()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    shared = pack_instances(insts, device="cuda")
    hub = hub_batch()
    out = {"label": args.label, "device": torch.cuda.get_device_name(0),
           "card": smi.stdout.strip().splitlines()[0] if smi.stdout else None,
           "torch": torch.__version__,
           "shared": bench_batch(shared, SHARED_FORMS, args.only),
           "compacted": bench_batch(pack_instances(insts[:8], device="cuda"),
                                    COMPACTED_FORMS, args.only),
           "high_degree": dict(
               bench_batch(hub, ("segment_sum var C=2",
                                 "segment_sum_cols var C=1",
                                 "fused_edge_pass[smax_scorer]")
                           + CHAINED_FORMS + SWEEP_FORMS + VERIFY_FORMS
                           + WALK_FORMS, args.only),
               **bench_batch(shared, ("sorted_segment_sum all",),
                             args.only)),
           "large": bench_batch(pack_instances([large_instance()],
                                               device="cuda"),
                                WALK_FORMS, args.only)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
