"""The headline p-d-p solve of bench.py, run by the port.

The settings are bench.py's headline defaults (HEADLINE), or the reference
settings of the JAX package's solver table (REFERENCE: tools/eval_solvers.py
and docs/r5_solver_table.json, one attempt at tolerance 0.02, t_max 100,
simplify_rounds 0). chip_smoke.py and utils/profile_solve.py both run the
solve through `solve_headline`, which verifies every reported solution
with numpy against its CNF.
"""

import time

import numpy as np
import torch

from pdp_solver_tpu_torch.solvers.base import PDPSolver, SolverConfig
from pdp_solver_tpu_torch.solvers.compact import compacting_solve

HEADLINE = dict(tolerance=0.08, t_max=50, iterations=1000, ls=1000,
                schedule=(0.35, 0.35, 0.3), chunk=50, simplify_rounds=1,
                epsilon=0.5, min_edges=32768)
REFERENCE = dict(tolerance=0.02, t_max=100, iterations=1000, ls=1000,
                 schedule=(1.0,), chunk=50, simplify_rounds=0, epsilon=0.5,
                 min_edges=131072)


def headline_solver(settings=HEADLINE):
    h = settings
    return PDPSolver(SolverConfig(
        model_type="p-d-p", tolerance=h["tolerance"], t_max=h["t_max"],
        local_search_iterations=h["ls"], epsilon=h["epsilon"],
        simplify_rounds=h["simplify_rounds"]))


def verify_solution(inst, sol01):
    """True iff the 0/1 assignment satisfies every clause of the instance
    tuple (n, m, graph_map, signs, label)."""
    n, m, gmap, signs, _ = inst
    lit = np.where(signs > 0, sol01[gmap[0]], 1.0 - sol01[gmap[0]])
    sat = np.zeros(m)
    np.add.at(sat, gmap[1], lit > 0.5)
    return bool((sat > 0).all())


def solve_headline(insts, seed, device="cuda", settings=HEADLINE):
    """compacting_solve at `settings` (the headline ones by default); the
    wall time is a host clock around synchronised work. Raises if a
    solution the solver reports disagrees with numpy."""
    h = settings
    schedule = [(int(h["iterations"] * f), int(h["ls"] * f))
                for f in h["schedule"]]
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.time()
    sols, solved, stats = compacting_solve(
        headline_solver(h), {}, torch.Generator().manual_seed(seed), insts,
        h["iterations"], ls_iterations=h["ls"], chunk=h["chunk"],
        min_edges=h["min_edges"], schedule=schedule, device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.time() - t0
    ok = [verify_solution(i, s) for i, s in zip(insts, sols)]
    if ok != [bool(x) for x in solved]:
        raise RuntimeError("a solution the solver reports disagrees with "
                           "numpy")
    return {"seed": seed, "solved_fraction": sum(ok) / len(insts),
            "solved": sum(ok), "wall_s": wall,
            "pdp_wall_s": stats["pdp_wall_s"],
            "ls_wall_s": round(stats["ls_wall_s"], 3),
            "attempt_solved": [a["solved"] for a in stats["attempts"]],
            "chunks": stats["chunks"],
            "compactions": len(stats["compactions"])}
