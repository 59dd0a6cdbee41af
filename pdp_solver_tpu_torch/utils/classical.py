"""The walk-sat and reinforce solves, run by the port.

The settings are those of the JAX package's solver table
(`tools/eval_solvers.py`, from the reference's config/Predict files):
epsilon 0.5 for both; pi 0.01 and decimation_probability 0.5 for
reinforce; 1000 iterations, 1000 WalkSAT flips, chunk 50, min_edges
131072, one attempt. chip_smoke.py and utils/profile_solve.py run the
solves through `solve_walk_sat` and `solve_reinforce`, which verify every
reported solution with numpy.

In `compacting_solve` every instance left unsolved by the iteration loop
goes to WalkSAT from a random fill of its active variables
(`solvers/compact.py`, as in the JAX package), so most of both rows'
solved instances come from WalkSAT; `solve_reinforce` also reports how
many the REINFORCE loop solved before that phase.
"""

import time

import torch

from pdp_solver_tpu_torch.solvers.base import PDPSolver, SolverConfig
from pdp_solver_tpu_torch.solvers.compact import compacting_solve
from pdp_solver_tpu_torch.utils.headline import verify_solution

CLASSICAL = dict(iterations=1000, ls=1000, epsilon=0.5, chunk=50,
                 min_edges=131072)
REINFORCE = dict(pi=0.01, decimation_probability=0.5)


def walk_sat_solver():
    return PDPSolver(SolverConfig(
        model_type="walk-sat", local_search_iterations=CLASSICAL["ls"],
        epsilon=CLASSICAL["epsilon"]))


def reinforce_solver():
    return PDPSolver(SolverConfig(
        model_type="reinforce", pi=REINFORCE["pi"],
        decimation_probability=REINFORCE["decimation_probability"],
        local_search_iterations=CLASSICAL["ls"],
        epsilon=CLASSICAL["epsilon"]))


def _solve(solver, insts, seed, device):
    """compacting_solve at CLASSICAL; the wall time is a host clock around
    synchronised work. Raises if a solution the solver reports disagrees
    with numpy."""
    s = CLASSICAL
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.time()
    sols, solved, stats = compacting_solve(
        solver, {}, torch.Generator().manual_seed(seed), insts,
        s["iterations"], ls_iterations=s["ls"], chunk=s["chunk"],
        min_edges=s["min_edges"], device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.time() - t0
    ok = [verify_solution(i, x) for i, x in zip(insts, sols)]
    if ok != [bool(x) for x in solved]:
        raise RuntimeError("a solution the solver reports disagrees with "
                           "numpy")
    progress = stats["attempts"][0]["progress"]
    return {"seed": seed, "solved_fraction": sum(ok) / len(insts),
            "solved": sum(ok), "wall_s": wall,
            "loop_wall_s": stats["pdp_wall_s"],
            "ls_wall_s": round(stats["ls_wall_s"], 3),
            # (iterations done, solved so far) when the loop last harvested
            "loop_solved": progress[-1][1] if progress else 0,
            "chunks": stats["chunks"],
            "compactions": len(stats["compactions"]),
            "progress": progress}


def solve_walk_sat(insts, seed, device="cuda"):
    """WalkSAT alone from the simplified problem (a random fill)."""
    return _solve(walk_sat_solver(), insts, seed, device)


def solve_reinforce(insts, seed, device="cuda"):
    """REINFORCE, then WalkSAT on what it leaves unsolved."""
    return _solve(reinforce_solver(), insts, seed, device)
