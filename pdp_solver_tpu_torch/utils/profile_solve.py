"""Where the time of the port's solves goes, on one CUDA card.

    python -m pdp_solver_tpu_torch.utils.profile_solve [--seeds 0 1 2]
        [--model p-d-p|np-d-np|np-nd-np|p-nd-np|walk-sat|reinforce]
        [--settings headline|reference] [--min-edges N] [--sp-sweep]
        [--verify-masks] [--replicas R] [--compute-dtype float32|bfloat16]
        [--no-profile]

On the shared set, with p-d-p at the headline settings (or, with
--settings reference, at the JAX solver table's reference settings),
np-nd-np with the r3 checkpoint, p-nd-np or np-d-np with its r4
checkpoint, or walk-sat and reinforce at the solver table's settings (the
settings of chip_smoke.py), it prints one JSON line with:
  - per seed: the numpy-verified solved fraction and the wall time of
    compacting_solve (split into the iteration loop and WalkSAT);
  - the hot loop at full size: ms per iteration over one 50-iteration
    chunk (host clock around synchronised work, after a warm-up chunk);
  - a torch.profiler trace of the same chunk run again: device busy time
    by kernel (the top 15, and every kernel of the port's own library
    with its microseconds a call), the kernel launches per iteration, and
    the device's idle share (1 - busy / the unprofiled wall), and the
    shares of the busy time taken by matrix products (cuBLAS), PyTorch's
    elementwise kernels and kernels 6 and 7 (the [E, d] sum and gather).
walk-sat has no hot loop: for it the trace covers one whole solve (seed
0, after a warm-up solve), giving the device busy time of a solve and the
launches and device ms of each of the port's kernels. --no-profile skips
the trace for any model. --min-edges sets p-d-p's compaction floor (the
headline settings use 32768; the JAX package's records 65536).
--sp-sweep and --verify-masks set PDP_SP_SWEEP=on and PDP_VERIFY_MASKS=on
for the whole run (the profiled chunk and the seeds' solves): the
one-launch sweep (kernel 9) and the one-launch verification with masks
(kernel 10). --replicas R gives every instance R slots: the seeds' solves
run compacting_solve(replicas=R), and the hot loop and the walk-sat trace
run on the batch it packs first (R copies of each instance side by
side). --compute-dtype bfloat16 runs a neural model's aggregators and GRU
cells in bf16 (SolverConfig.compute_dtype); the other models refuse it.
Needs a CUDA card; exits 2 without one.
"""

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time

import torch

from pdp_solver_tpu_torch.fg.batch import pack_instances
from pdp_solver_tpu_torch.utils.benchdata import (
    dataset_fingerprint, make_ksat_set)
from pdp_solver_tpu_torch.utils.classical import (
    CLASSICAL, REINFORCE, reinforce_solver, solve_reinforce, solve_walk_sat)
from pdp_solver_tpu_torch.utils.headline import (
    HEADLINE, REFERENCE, headline_solver, solve_headline)
from pdp_solver_tpu_torch.utils.neural import (
    NP_D_NP, NP_ND_NP, P_ND_NP, np_d_np_params, np_d_np_solver,
    np_nd_np_params, np_nd_np_solver, p_nd_np_params, p_nd_np_solver,
    solve_np_d_np, solve_np_nd_np, solve_p_nd_np)


# the neural models: settings, weights, solver, solve
NEURAL = {
    "np-d-np": (NP_D_NP, np_d_np_params, np_d_np_solver, solve_np_d_np),
    "np-nd-np": (NP_ND_NP, np_nd_np_params, np_nd_np_solver, solve_np_nd_np),
    "p-nd-np": (P_ND_NP, p_nd_np_params, p_nd_np_solver, solve_p_nd_np),
}


# kernel names by what they compute, for the shares of the busy time
SHARES = {
    "products": re.compile(r"gemm|nvjet|xmma|cutlass|cublas", re.I),
    "elementwise": re.compile(r"elementwise_kernel"),
    "kernels_6_7": re.compile(r"\b(segment_sum_2d|gather_2d)_kernel\b"),
}


def own_kernel_names():
    """The __global__ kernels of the port's CUDA sources."""
    csrc = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "csrc")
    names = set()
    for path in glob.glob(os.path.join(csrc, "*.cu")):
        with open(path) as f:
            names |= set(re.findall(
                r"__global__ void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                r"(\w+)", f.read()))
    return names


def _device_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def hot_loop(insts, solver, params, n=50):
    """ms per iteration of the full-size hot loop, and a profile of it."""
    from torch.profiler import ProfilerActivity, profile
    batch = pack_instances(insts, device="cuda")
    gen = torch.Generator().manual_seed(0)
    state = solver.get_init_state(gen, batch, randomized=True)
    _, state, carry = solver.forward(params, gen, batch, state, n,
                                     check_termination=True,
                                     finalize=False)
    torch.cuda.synchronize()
    t0 = time.time()
    solver.forward(params, gen, batch, state, n, check_termination=True,
                   carry=carry, finalize=False)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        solver.forward(params, gen, batch, state, n, check_termination=True,
                       carry=carry, finalize=False)
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    kernels = {}
    launches = 0
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and getattr(evt, "device_type", None) is not None and \
                "cuda" in str(evt.device_type).lower():
            kernels[evt.key] = (us, evt.count)
            launches += evt.count
    busy_us = sum(us for us, _ in kernels.values())
    shares = {k: sum(us for name, (us, _) in kernels.items()
                     if rx.search(name)) / max(busy_us, 1e-9)
              for k, rx in SHARES.items()}
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    own_names = own_kernel_names()
    own = sorted((k, v) for k, v in kernels.items()
                 if any(re.search(rf"\b{n}\b", k) for n in own_names))
    # the profiler slows the host, not the device: the idle share is the
    # profiled device time against the unprofiled wall of the same chunk
    return {
        "edges": batch.num_edges, "iterations": n,
        "ms_per_iteration": wall_ms / n,
        "profiled_wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "kernel_launches_per_iteration": launches / n,
        "busy_shares": shares,
        "top_kernels": [{"name": k[:80], "device_ms": us / 1e3,
                         "count": c} for k, (us, c) in top],
        "own_kernels": [{"name": k[:120], "device_ms": us / 1e3,
                         "count": c, "us_per_call": us / c}
                        for k, (us, c) in own],
    }


def solve_profile(solve):
    """A torch.profiler trace of one whole solve (after an unprofiled
    warm-up solve): device busy ms, the kernel launches, and the port's
    own kernels with their device ms and launches."""
    from torch.profiler import ProfilerActivity, profile
    solve()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solve()
        torch.cuda.synchronize()
    kernels = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and getattr(evt, "device_type", None) is not None and \
                "cuda" in str(evt.device_type).lower():
            kernels[evt.key] = (us, evt.count)
    own_names = own_kernel_names()
    return {
        "device_busy_ms": sum(us for us, _ in kernels.values()) / 1e3,
        "kernel_launches": sum(c for _, c in kernels.values()),
        "own_kernels": [{"name": k[:120], "device_ms": us / 1e3,
                         "count": c} for k, (us, c) in sorted(
                             kernels.items())
                        if any(re.search(rf"\b{n}\b", k)
                               for n in own_names)]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2],
                    help="the seeds to solve (none: only the hot loop)")
    ap.add_argument("--model", default="p-d-p",
                    choices=("p-d-p", "np-d-np", "np-nd-np", "p-nd-np",
                             "walk-sat", "reinforce"))
    ap.add_argument("--settings", choices=("headline", "reference"),
                    default="headline", help="p-d-p's settings")
    ap.add_argument("--sp-sweep", action="store_true",
                    help="PDP_SP_SWEEP=on: the one-launch SP sweep")
    ap.add_argument("--verify-masks", action="store_true",
                    help="PDP_VERIFY_MASKS=on: verification and masks in "
                         "one launch")
    ap.add_argument("--min-edges", type=int,
                    help="p-d-p's compaction floor (compacting_solve's "
                         "min_edges) in place of the settings' own")
    ap.add_argument("--replicas", type=int, default=1,
                    help="slots an instance (compacting_solve's replicas)")
    ap.add_argument("--compute-dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="a neural model's compute_dtype")
    ap.add_argument("--no-profile", action="store_true",
                    help="skip the hot-loop timing and trace")
    args = ap.parse_args(argv)
    dt = args.compute_dtype
    if dt != "float32" and args.model not in NEURAL:
        ap.error(f"--compute-dtype {dt} takes a neural model")
    for flag, name in ((args.sp_sweep, "PDP_SP_SWEEP"),
                       (args.verify_masks, "PDP_VERIFY_MASKS")):
        if flag:
            os.environ[name] = "on"
    if not torch.cuda.is_available():
        print("profile_solve: no CUDA card", file=sys.stderr)
        return 2
    insts = make_ksat_set()
    R = args.replicas
    # the batch compacting_solve(replicas=R) packs first
    slots = [i for i in insts for _ in range(R)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    out = {"device": torch.cuda.get_device_name(0),
           "card": smi.stdout.strip().splitlines()[0] if smi.stdout else None,
           "fingerprint": dataset_fingerprint(insts), "model": args.model,
           "replicas": R, "compute_dtype": dt,
           "env": {k: os.environ.get(k, "off")
                   for k in ("PDP_SP_SWEEP", "PDP_VERIFY_MASKS")}}
    profile = not args.no_profile
    if args.model == "p-d-p":
        h = REFERENCE if args.settings == "reference" else HEADLINE
        if args.min_edges is not None:
            h = dict(h, min_edges=args.min_edges)
        out["settings"] = dict(h, name=args.settings)
        if profile:
            out["hot_loop"] = hot_loop(slots, headline_solver(h), {})
        out["seeds"] = [solve_headline(insts, s, settings=h, replicas=R)
                        for s in args.seeds]
    elif args.model in NEURAL:
        settings, load, make, solve = NEURAL[args.model]
        params = load()
        out["settings"] = settings
        if profile:
            out["hot_loop"] = hot_loop(slots, make(compute_dtype=dt),
                                       params)
        out["seeds"] = [solve(insts, s, params=params, replicas=R,
                              compute_dtype=dt) for s in args.seeds]
    elif args.model == "reinforce":
        out["settings"] = dict(CLASSICAL, **REINFORCE)
        if profile:
            out["hot_loop"] = hot_loop(slots, reinforce_solver(), {})
        out["seeds"] = [solve_reinforce(insts, s, replicas=R)
                        for s in args.seeds]
    else:
        out["settings"] = CLASSICAL
        if profile:
            out["solve_profile"] = solve_profile(
                lambda: solve_walk_sat(insts, 0, replicas=R))
        out["seeds"] = [solve_walk_sat(insts, s, replicas=R)
                        for s in args.seeds]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
