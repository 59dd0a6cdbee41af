"""The trained neural solves run by the port: np-nd-np with the r3
checkpoint and p-nd-np with the r4 checkpoint.

The settings are those of the JAX package's solver table
(`tools/eval_solvers.py:45-63`): np-nd-np at hidden 150, mem_hidden 100,
agg_hidden 100, mem_agg_hidden 50, classifier 50; p-nd-np at hidden 150
and 50 for the predictor's widths and the classifier; both with 1000
iterations, 1000 WalkSAT flips, epsilon 0.5, chunk 50, min_edges 131072,
randomized init, one attempt. (The table's p-nd-np row sets
has_meta_data, which never reaches the JAX SolverConfig: meta_dim stays
0, as the checkpoint's shapes show. Dropout acts in training only.)
chip_smoke.py and utils/profile_solve.py run the solves through
`solve_np_nd_np` and `solve_p_nd_np`, which verify every reported
solution with numpy.
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
P_ND_NP_CHECKPOINT = os.path.join(ROOT, "trained-models", "p-nd-np-r4",
                                  "best", "p-nd-np-r4.npz")
_RUN = dict(iterations=1000, ls=1000, epsilon=0.5, chunk=50,
            min_edges=131072)
NP_ND_NP = dict(hidden_dim=150, mem_hidden_dim=100, agg_hidden_dim=100,
                mem_agg_hidden_dim=50, classifier_dim=50, **_RUN)
P_ND_NP = dict(hidden_dim=150, mem_hidden_dim=50, agg_hidden_dim=50,
               mem_agg_hidden_dim=50, classifier_dim=50, **_RUN)


def _solver(model_type, s):
    return PDPSolver(SolverConfig(
        model_type=model_type, hidden_dim=s["hidden_dim"],
        mem_hidden_dim=s["mem_hidden_dim"],
        agg_hidden_dim=s["agg_hidden_dim"],
        mem_agg_hidden_dim=s["mem_agg_hidden_dim"],
        classifier_dim=s["classifier_dim"],
        local_search_iterations=s["ls"], epsilon=s["epsilon"]))


def np_nd_np_solver():
    return _solver("np-nd-np", NP_ND_NP)


def p_nd_np_solver():
    return _solver("p-nd-np", P_ND_NP)


def np_nd_np_params(device="cuda"):
    """The r3 checkpoint's parameters on `device`."""
    return params_from_jax(load_jax_checkpoint(CHECKPOINT)["params"],
                           device)


def p_nd_np_params(device="cuda"):
    """The r4 checkpoint's parameters on `device`."""
    return params_from_jax(
        load_jax_checkpoint(P_ND_NP_CHECKPOINT)["params"], device)


def solve_np_nd_np(insts, seed, device="cuda", params=None):
    """compacting_solve with np-nd-np and the r3 weights; see `_solve`."""
    if params is None:
        params = np_nd_np_params(device)
    return _solve(np_nd_np_solver(), NP_ND_NP, params, insts, seed, device)


def solve_p_nd_np(insts, seed, device="cuda", params=None):
    """compacting_solve with p-nd-np and the r4 weights; see `_solve`."""
    if params is None:
        params = p_nd_np_params(device)
    return _solve(p_nd_np_solver(), P_ND_NP, params, insts, seed, device)


def _solve(solver, s, params, insts, seed, device):
    """One compacting_solve at the settings `s`; the wall time is a host
    clock around synchronised work (loading the weights excluded). Raises
    if a solution the solver reports disagrees with numpy."""
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.time()
    sols, solved, stats = compacting_solve(
        solver, params, torch.Generator().manual_seed(seed),
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
