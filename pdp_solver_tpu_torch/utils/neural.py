"""The np-nd-np solve with the trained r3 checkpoint, run by the port.

The settings are those of the JAX package's solver table
(`tools/eval_solvers.py`: hidden 150, mem_hidden 100, agg_hidden 100,
mem_agg_hidden 50, classifier 50; 1000 iterations, 1000 WalkSAT flips,
epsilon 0.5, chunk 50, min_edges 131072, randomized init, one attempt).
chip_smoke.py and utils/profile_solve.py both run the solve through
`solve_np_nd_np`, which verifies every reported solution with numpy.
"""

import os
import time

import torch

from pdp_solver_tpu_torch.convert import (
    load_jax_checkpoint, params_from_jax)
from pdp_solver_tpu_torch.solvers.base import PDPSolver, SolverConfig
from pdp_solver_tpu_torch.solvers.compact import compacting_solve
from pdp_solver_tpu_torch.utils.headline import verify_solution

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CHECKPOINT = os.path.join(ROOT, "trained-models", "np-nd-np-r3", "best",
                          "np-nd-np-r3.npz")
NP_ND_NP = dict(hidden_dim=150, mem_hidden_dim=100, agg_hidden_dim=100,
                mem_agg_hidden_dim=50, classifier_dim=50, iterations=1000,
                ls=1000, epsilon=0.5, chunk=50, min_edges=131072)


def np_nd_np_solver():
    s = NP_ND_NP
    return PDPSolver(SolverConfig(
        model_type="np-nd-np", hidden_dim=s["hidden_dim"],
        mem_hidden_dim=s["mem_hidden_dim"],
        agg_hidden_dim=s["agg_hidden_dim"],
        mem_agg_hidden_dim=s["mem_agg_hidden_dim"],
        classifier_dim=s["classifier_dim"],
        local_search_iterations=s["ls"], epsilon=s["epsilon"]))


def np_nd_np_params(device="cuda"):
    """The r3 checkpoint's parameters on `device`."""
    return params_from_jax(load_jax_checkpoint(CHECKPOINT)["params"],
                           device)


def solve_np_nd_np(insts, seed, device="cuda", params=None):
    """compacting_solve with np-nd-np and the r3 weights; the wall time is
    a host clock around synchronised work (loading the weights excluded).
    Raises if a solution the solver reports disagrees with numpy."""
    s = NP_ND_NP
    if params is None:
        params = np_nd_np_params(device)
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.time()
    sols, solved, stats = compacting_solve(
        np_nd_np_solver(), params, torch.Generator().manual_seed(seed),
        insts, s["iterations"], ls_iterations=s["ls"], chunk=s["chunk"],
        min_edges=s["min_edges"], device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.time() - t0
    ok = [verify_solution(i, x) for i, x in zip(insts, sols)]
    if ok != [bool(x) for x in solved]:
        raise RuntimeError("a solution the solver reports disagrees with "
                           "numpy")
    return {"seed": seed, "solved_fraction": sum(ok) / len(insts),
            "solved": sum(ok), "wall_s": wall,
            "loop_wall_s": stats["pdp_wall_s"],
            "ls_wall_s": round(stats["ls_wall_s"], 3),
            "chunks": stats["chunks"],
            "compactions": len(stats["compactions"]),
            "progress": stats["attempts"][0]["progress"]}
