"""Where the time of the port's solves goes, on one CUDA card.

    python -m pdp_solver_tpu_torch.utils.profile_solve [--seeds 0 1 2]
        [--model p-d-p|np-nd-np|walk-sat|reinforce]
        [--settings headline|reference] [--no-profile]

On the shared set, with p-d-p at the headline settings (or, with
--settings reference, at the JAX solver table's reference settings),
np-nd-np with the r3 checkpoint, or walk-sat and reinforce at the solver
table's settings (the settings of chip_smoke.py), it prints one JSON line
with:
  - per seed: the numpy-verified solved fraction and the wall time of
    compacting_solve (split into the iteration loop and WalkSAT);
  - the hot loop at full size: ms per iteration over one 50-iteration
    chunk (host clock around synchronised work, after a warm-up chunk);
  - a torch.profiler trace of the same chunk run again: device busy time
    by kernel, the kernel launches per iteration, and the device's idle
    share (1 - busy / the unprofiled wall).
walk-sat has no hot loop, and --no-profile skips it for any model.
Needs a CUDA card; exits 2 without one.
"""

import argparse
import json
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
    NP_ND_NP, np_nd_np_params, np_nd_np_solver, solve_np_nd_np)


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
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    # the profiler slows the host, not the device: the idle share is the
    # profiled device time against the unprofiled wall of the same chunk
    return {
        "edges": batch.num_edges, "iterations": n,
        "ms_per_iteration": wall_ms / n,
        "profiled_wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "kernel_launches_per_iteration": launches / n,
        "top_kernels": [{"name": k[:80], "device_ms": us / 1e3,
                         "count": c} for k, (us, c) in top],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--model", default="p-d-p",
                    choices=("p-d-p", "np-nd-np", "walk-sat", "reinforce"))
    ap.add_argument("--settings", choices=("headline", "reference"),
                    default="headline", help="p-d-p's settings")
    ap.add_argument("--no-profile", action="store_true",
                    help="skip the hot-loop timing and trace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_solve: no CUDA card", file=sys.stderr)
        return 2
    insts = make_ksat_set()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    out = {"device": torch.cuda.get_device_name(0),
           "card": smi.stdout.strip().splitlines()[0] if smi.stdout else None,
           "fingerprint": dataset_fingerprint(insts), "model": args.model}
    profile = not args.no_profile
    if args.model == "p-d-p":
        h = REFERENCE if args.settings == "reference" else HEADLINE
        out["settings"] = dict(h, name=args.settings)
        if profile:
            out["hot_loop"] = hot_loop(insts, headline_solver(h), {})
        out["seeds"] = [solve_headline(insts, s, settings=h)
                        for s in args.seeds]
    elif args.model == "np-nd-np":
        params = np_nd_np_params()
        out["settings"] = NP_ND_NP
        if profile:
            out["hot_loop"] = hot_loop(insts, np_nd_np_solver(), params)
        out["seeds"] = [solve_np_nd_np(insts, s, params=params)
                        for s in args.seeds]
    elif args.model == "reinforce":
        out["settings"] = dict(CLASSICAL, **REINFORCE)
        if profile:
            out["hot_loop"] = hot_loop(insts, reinforce_solver(), {})
        out["seeds"] = [solve_reinforce(insts, s) for s in args.seeds]
    else:
        out["settings"] = CLASSICAL
        out["seeds"] = [solve_walk_sat(insts, s) for s in args.seeds]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
