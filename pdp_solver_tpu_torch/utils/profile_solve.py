"""Where the time of the port's p-d-p solve goes, on one CUDA card.

    python -m pdp_solver_tpu_torch.utils.profile_solve [--seeds 0 1 2]

On the shared set at the headline settings (those of chip_smoke.py) it
prints one JSON line with:
  - per seed: the numpy-verified solved fraction and the wall time of
    compacting_solve (split into the decimation loop and WalkSAT);
  - the hot loop at full size: ms per iteration over one 50-iteration
    chunk (host clock around synchronised work, after a warm-up chunk);
  - a torch.profiler trace of the same chunk run again: device busy time
    by kernel, the kernel launches per iteration, and the device's idle
    share (1 - busy / the unprofiled wall).
Needs a CUDA card; exits 2 without one.
"""

import argparse
import json
import sys
import time

import torch

from pdp_solver_tpu_torch.fg.batch import pack_instances
from pdp_solver_tpu_torch.utils.benchdata import (
    dataset_fingerprint, make_ksat_set)
from pdp_solver_tpu_torch.utils.headline import (
    HEADLINE, headline_solver, solve_headline)


def _device_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def hot_loop(insts, n=50):
    """ms per iteration of the full-size hot loop, and a profile of it."""
    from torch.profiler import ProfilerActivity, profile
    solver = headline_solver()
    batch = pack_instances(insts, device="cuda")
    gen = torch.Generator().manual_seed(0)
    state = solver.get_init_state(gen, batch, randomized=True)
    _, state, carry = solver.forward({}, gen, batch, state, n,
                                     check_termination=True,
                                     finalize=False)
    torch.cuda.synchronize()
    t0 = time.time()
    solver.forward({}, gen, batch, state, n, check_termination=True,
                   carry=carry, finalize=False)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        solver.forward({}, gen, batch, state, n, check_termination=True,
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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_solve: no CUDA card", file=sys.stderr)
        return 2
    insts = make_ksat_set()
    out = {"device": torch.cuda.get_device_name(0),
           "fingerprint": dataset_fingerprint(insts),
           "settings": HEADLINE}
    out["hot_loop"] = hot_loop(insts)
    out["seeds"] = [solve_headline(insts, s) for s in args.seeds]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
