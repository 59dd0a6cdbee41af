"""Times the CSR segment sum (kernels 4, 5, 8) and the fused edge pass
(kernel 1) on one CUDA card, beside the PyTorch call for the same
function.

    python pdp_solver_tpu_torch/utils/bench_kernels.py [--label NAME]

On the shared set (128 instances of 4-SAT, n=100, alpha=9: E = 524,288
padded / 460,800 real edges), on a compacted batch (its first 8
instances, a 32,768-edge bucket) and at high degree (a var CSR with one
63,488-edge node; the shared set's clause ids over all E edges, whose
last run holds the 63,488 padding edges), it gives for each form:
  ms        ms / call, CUDA events over 50 back-to-back calls;
  host_us   host us / call, perf_counter over 500 calls with no
            synchronize, after a warm-up;
  device_us device us / call, the profiler's kernel times over 500 calls
            (and by kernel name).
It prints one JSON line with the card's name and power limit. It uses
only the wrappers' public functions, so it times any tree of the package
that PYTHONPATH puts first: run it on two trees in one call to compare
them on one card. Needs a CUDA card; exits 2 without one.
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


def timed(fn, reps=50):
    """ms / call (CUDA events), host us / call and device us / call."""
    dev, by = device_us(fn)
    return {"ms": cuda_ms(fn, reps=reps), "host_us": host_us(fn),
            "device_us": dev, "device_kernels": by}


def hub_batch(degree=63488, n=300, k=3, seed=5):
    """One instance whose variable 0 sits in every one of its `degree`
    clauses: a var CSR with one node of `degree` edges."""
    from pdp_solver_tpu_torch.fg.batch import pack_instances
    rng = np.random.default_rng(seed)
    v = rng.integers(1, n, size=(degree, k))
    v[:, 0] = 0
    ec = np.repeat(np.arange(degree), k)
    signs = rng.choice([-1.0, 1.0], degree * k).astype(np.float32)
    return pack_instances([(n, degree, np.stack(
        [v.reshape(-1), ec]).astype(np.int32), signs, -1.0)], device="cuda")


def _fused_inputs(fn, batch, seed):
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
        out.append(u.contiguous())
    return out


def bench_batch(batch, forms):
    """{form: numbers} for the forms named, on one batch."""
    from pdp_solver_tpu_torch.ops import fused, reduce
    g = torch.Generator().manual_seed(3)
    E, e = batch.num_edges, batch.num_real_edges
    out = {}
    csr = {"var": (batch.edge_var, batch.num_vars, batch.var_ptr,
                   batch.var_perm),
           "clause": (batch.edge_clause, batch.num_clauses, batch.clause_ptr,
                      None)}
    for form in forms:
        if form.startswith("segment_sum"):
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
        else:
            # "fused_edge_pass[name]"
            fn = getattr(fused, form[len("fused_edge_pass["):-1].upper())
            ins = _fused_inputs(fn, batch, 5)

            def call():
                return fused.fused_edge_pass(fn, batch, ins)

            lib = None
            if fn.name == "ae":
                def lib():
                    return ins[0][batch.edge_var]
        row = timed(call)
        if lib is not None:
            row["library"] = timed(lib)
        out[form] = row
    return out


SHARED_FORMS = ("segment_sum var C=2", "segment_sum_cols var C=1",
                "segment_sum_cols clause C=1", "sorted_segment_sum real",
                "fused_edge_pass[ae]", "fused_edge_pass[em]",
                "fused_edge_pass[em_ae]", "fused_edge_pass[sp_pass_c]",
                "fused_edge_pass[smax_scorer]", "fused_edge_pass[scorer]")
COMPACTED_FORMS = ("segment_sum var C=2", "segment_sum_cols var C=1",
                   "segment_sum_cols clause C=1", "sorted_segment_sum real",
                   "fused_edge_pass[ae]", "fused_edge_pass[smax_scorer]",
                   "fused_edge_pass[scorer]")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="", help="a name for this tree")
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
           "shared": bench_batch(shared, SHARED_FORMS),
           "compacted": bench_batch(pack_instances(insts[:8], device="cuda"),
                                    COMPACTED_FORMS),
           "high_degree": dict(
               bench_batch(hub, ("segment_sum var C=2",
                                 "segment_sum_cols var C=1",
                                 "fused_edge_pass[smax_scorer]")),
               **bench_batch(shared, ("sorted_segment_sum all",)))}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
