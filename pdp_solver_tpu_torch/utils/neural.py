"""The trained neural solves run by the port: np-nd-np with the r3
checkpoint, p-nd-np and np-d-np with their r4 checkpoints.

The settings are those of the JAX package's solver table
(`tools/eval_solvers.py:45-68`): np-nd-np at hidden 150, mem_hidden 100,
agg_hidden 100, mem_agg_hidden 50, classifier 50; p-nd-np at hidden 150
and 50 for the predictor's widths and the classifier; np-d-np at
np-nd-np's widths with the decimator's tolerance 0.02 and t_max 10 (not
in the checkpoint); all with 1000 iterations, 1000 WalkSAT flips,
epsilon 0.5, chunk 50, min_edges 131072, randomized init, one attempt.
(The table's p-nd-np row sets has_meta_data, which never reaches the JAX
SolverConfig: meta_dim stays 0, as the checkpoint's shapes show. Dropout
acts in training only.) chip_smoke.py and utils/profile_solve.py run the
solves through `solve_np_nd_np`, `solve_p_nd_np` and `solve_np_d_np`,
which verify every reported solution with numpy.

Each takes compute_dtype ("float32" or "bfloat16", the JAX package's
SolverConfig.compute_dtype), which the solver's config carries; the
parameters serve either.

The flagship serving config, `config/Predict/PDP-np-nd-np-trained.yaml`,
is `FLAGSHIP` (its keys as a dict, so that the card's machine needs no
PyYAML): np-nd-np with the shipped `trained-models/np-nd-np-full`
checkpoint in bf16, 100 iterations (its test_recurrence_num), 100 WalkSAT
flips, epsilon 0.5; `solve_flagship` runs it through `build_solver` at
the other solves' chunk and min_edges.

`np_d_np_3sat_band` is np-d-np at its reference operating point, the
JAX package's medium 3-SAT band (`tools/eval_npdnp_3sat.py`, the
protocol of `tools/train_family.py` solved_fraction :68-89): 48 uniform
3-SAT instances, n = 60, alpha = 3.5 (`make_ksat_set(seed=29, ...)`), one
forward of 300 iterations with check_termination from a randomized init,
decimation only (no local search).
"""

import os
import time

import numpy as np
import torch

from pdp_solver_tpu_torch.convert import (
    load_jax_checkpoint, params_from_jax)
from pdp_solver_tpu_torch.fg.batch import pack_instances
from pdp_solver_tpu_torch.solvers.base import (
    PDPSolver, SolverConfig, SolverState, build_solver)
from pdp_solver_tpu_torch.solvers.compact import compacting_solve
from pdp_solver_tpu_torch.train.loss import cnf_evaluate
from pdp_solver_tpu_torch.utils.benchdata import make_ksat_set
from pdp_solver_tpu_torch.utils.config import (
    apply_classical_overrides, validate)
from pdp_solver_tpu_torch.utils.headline import verify_solution

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CHECKPOINT = os.path.join(ROOT, "trained-models", "np-nd-np-r3", "best",
                          "np-nd-np-r3.npz")
P_ND_NP_CHECKPOINT = os.path.join(ROOT, "trained-models", "p-nd-np-r4",
                                  "best", "p-nd-np-r4.npz")
NP_D_NP_CHECKPOINT = os.path.join(ROOT, "trained-models", "np-d-np-r4",
                                  "best", "np-d-np-r4.npz")
_RUN = dict(iterations=1000, ls=1000, epsilon=0.5, chunk=50,
            min_edges=131072)
NP_ND_NP = dict(hidden_dim=150, mem_hidden_dim=100, agg_hidden_dim=100,
                mem_agg_hidden_dim=50, classifier_dim=50, **_RUN)
P_ND_NP = dict(hidden_dim=150, mem_hidden_dim=50, agg_hidden_dim=50,
               mem_agg_hidden_dim=50, classifier_dim=50, **_RUN)
NP_D_NP = dict(NP_ND_NP, tolerance=0.02, t_max=10)
# config/Predict/PDP-np-nd-np-trained.yaml, key for key
FLAGSHIP_YAML = os.path.join(ROOT, "config", "Predict",
                             "PDP-np-nd-np-trained.yaml")
FLAGSHIP = {
    "model_type": "np-nd-np", "has_meta_data": False,
    "model_name": "np-nd-np-full",
    "model_path": "trained-models/np-nd-np-full/best", "label_dim": 1,
    "edge_feature_dim": 1, "meta_feature_dim": 0, "prediction_dim": 1,
    "hidden_dim": 150, "mem_hidden_dim": 100, "agg_hidden_dim": 100,
    "mem_agg_hidden_dim": 50, "classifier_dim": 50, "dropout": 0.2,
    "compute_dtype": "bfloat16", "local_search_iteration": 100,
    "epsilon": 0.5, "verification_length": 100, "randomized": True,
    "test_recurrence_num": 100, "test_batch_limit": 40000000,
    "batch_replication": 1}
# the medium 3-SAT band and its protocol
BAND_3SAT = dict(seed=29, count=48, n=60, alpha=3.5, k=3)
BAND_ITERATIONS, BAND_SEED = 300, 7
# the bf16 check from one injected state (chip_smoke.py phase 15 and
# tests/test_torch_bf16.py): 16 random 4-SAT instances, n 60, alpha 7, of
# which np-nd-np r3 solves 4 within 10 iterations, from U(-1, 1) states
# drawn with numpy (`np_nd_np_state`), so that the JAX package can start
# from the same state; JAX's own max |f32 - bf16 prediction| there on the
# CPU after 5 and 10 iterations (the test recomputes it), and the factor of
# it that the port's may reach, on the CPU and on the card
BF16_CHECK = dict(seed=3, count=16, n=60, alpha=7.0, k=4)
BF16_CHECK_HORIZONS = (5, 10)
BF16_CHECK_JAX_DRIFT = {5: 0.0408, 10: 0.0610}
BF16_DRIFT_RATIO = 1.5


def _solver(model_type, s, ls=None, compute_dtype="float32"):
    extra = {k: s[k] for k in ("tolerance", "t_max") if k in s}
    return PDPSolver(SolverConfig(
        model_type=model_type, hidden_dim=s["hidden_dim"],
        mem_hidden_dim=s["mem_hidden_dim"],
        agg_hidden_dim=s["agg_hidden_dim"],
        mem_agg_hidden_dim=s["mem_agg_hidden_dim"],
        classifier_dim=s["classifier_dim"],
        local_search_iterations=s["ls"] if ls is None else ls,
        epsilon=s["epsilon"], compute_dtype=compute_dtype, **extra))


def np_nd_np_solver(compute_dtype="float32"):
    return _solver("np-nd-np", NP_ND_NP, compute_dtype=compute_dtype)


def p_nd_np_solver(compute_dtype="float32"):
    return _solver("p-nd-np", P_ND_NP, compute_dtype=compute_dtype)


def np_d_np_solver(ls=None, compute_dtype="float32"):
    """np-d-np at the solver table's settings (ls: another WalkSAT
    budget)."""
    return _solver("np-d-np", NP_D_NP, ls, compute_dtype)


def _checkpoint_params(path, device):
    return params_from_jax(load_jax_checkpoint(path)["params"], device)


def np_nd_np_params(device="cuda"):
    """The r3 checkpoint's parameters on `device`."""
    return _checkpoint_params(CHECKPOINT, device)


def p_nd_np_params(device="cuda"):
    """The r4 checkpoint's parameters on `device`."""
    return _checkpoint_params(P_ND_NP_CHECKPOINT, device)


def np_d_np_params(device="cuda", trained=True, seed=0):
    """The r4 checkpoint's parameters on `device`, or (trained=False) a
    fresh init drawn on the CPU from torch's default generator seeded
    with `seed`; the caller's generator state is left as it was."""
    if trained:
        return _checkpoint_params(NP_D_NP_CHECKPOINT, device)
    with torch.random.fork_rng(devices=[]):
        torch.random.default_generator.manual_seed(seed)
        return np_d_np_solver().init_params(device)


def solve_np_nd_np(insts, seed, device="cuda", params=None, replicas=1,
                   compute_dtype="float32"):
    """compacting_solve with np-nd-np and the r3 weights; see `_solve`."""
    if params is None:
        params = np_nd_np_params(device)
    return _solve(np_nd_np_solver(compute_dtype), NP_ND_NP, params, insts,
                  seed, device, replicas)


def solve_p_nd_np(insts, seed, device="cuda", params=None, replicas=1,
                  compute_dtype="float32"):
    """compacting_solve with p-nd-np and the r4 weights; see `_solve`."""
    if params is None:
        params = p_nd_np_params(device)
    return _solve(p_nd_np_solver(compute_dtype), P_ND_NP, params, insts,
                  seed, device, replicas)


def solve_np_d_np(insts, seed, device="cuda", params=None, replicas=1,
                  compute_dtype="float32"):
    """compacting_solve with np-d-np and the r4 weights; see `_solve`."""
    if params is None:
        params = np_d_np_params(device)
    return _solve(np_d_np_solver(compute_dtype=compute_dtype), NP_D_NP,
                  params, insts, seed, device, replicas)


def flagship_solver(config=None):
    """The solver of the flagship config (or of `config`, a dict with its
    keys), through the normal route: the reference's overrides, the check
    of its model type, build_solver."""
    return build_solver(validate(apply_classical_overrides(
        FLAGSHIP if config is None else config)))


def flagship_params(device="cuda"):
    """The flagship checkpoint's parameters (model_path/model_name.npz)."""
    c = FLAGSHIP
    path = os.path.join(ROOT, c["model_path"], c["model_name"] + ".npz")
    return _checkpoint_params(path, device)


def flagship_settings():
    """The flagship solve's settings in `_solve`'s keys: its iterations and
    flips, at the other solves' chunk and min_edges."""
    c = FLAGSHIP
    return dict(iterations=c["test_recurrence_num"],
                ls=c["local_search_iteration"], epsilon=c["epsilon"],
                chunk=_RUN["chunk"], min_edges=_RUN["min_edges"])


def solve_flagship(insts, seed, device="cuda", params=None):
    """compacting_solve with the flagship config; see `_solve`."""
    if params is None:
        params = flagship_params(device)
    return _solve(flagship_solver(), flagship_settings(), params, insts,
                  seed, device)


def np_d_np_3sat_band(params, device="cuda", seed=BAND_SEED,
                      compute_dtype="float32"):
    """np-d-np on the medium 3-SAT band, decimation only (the module
    docstring): the solved fraction, every solution verified with numpy
    (raises if the solver's count disagrees), and the wall time, a host
    clock around synchronised work."""
    insts = make_ksat_set(**BAND_3SAT)
    batch = pack_instances(insts, device=device)
    solver = np_d_np_solver(ls=0, compute_dtype=compute_dtype)
    gen = torch.Generator().manual_seed(seed)
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.time()
    state = solver.get_init_state(gen, batch, randomized=True)
    (pred, _), _ = solver.forward(params, gen, batch, state,
                                  BAND_ITERATIONS, check_termination=True)
    sol = (pred[:, 0] > 0.5).cpu().numpy()
    wall = time.time() - t0
    ok, off = [], 0
    for inst in insts:
        ok.append(verify_solution(inst, sol[off:off + inst[0]]))
        off += inst[0]
    solved = cnf_evaluate(batch, pred)[0][:len(insts)].cpu().numpy() > 0
    if ok != solved.tolist():
        raise RuntimeError("a solution the solver reports disagrees with "
                           "numpy")
    return {"seed": seed, "solved": sum(ok),
            "solved_fraction": sum(ok) / len(insts), "wall_s": wall}


def np_nd_np_state(num_edges, seed=0, hidden=NP_ND_NP["hidden_dim"]):
    """np-nd-np's U(-1, 1) states drawn with numpy from `seed`: four
    f32[num_edges, hidden] arrays, the propagator's (var, fn) and the
    decimator's (var, fn)."""
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (num_edges, hidden)).astype(np.float32)
            for _ in range(4)]


def bf16_check_forward(params, batch, state, compute_dtype):
    """np-nd-np with check_termination from `state` (np_nd_np_state's
    arrays), unfinalized, continued through BF16_CHECK_HORIZONS: at each,
    the predictions [V] and the instances' active flags, on the CPU."""
    t = [torch.from_numpy(a).to(batch.device) for a in state]
    st = SolverState(prop=(t[0], t[1]), dec=(t[2], t[3]), aux=())
    solver, carry, done, out = np_nd_np_solver(compute_dtype), None, 0, []
    for h in BF16_CHECK_HORIZONS:
        _, st, carry = solver.forward(
            params, torch.Generator().manual_seed(1), batch, st, h - done,
            check_termination=True, carry=carry, finalize=False)
        done = h
        out.append((carry[0].solution.cpu(),
                     carry[1][:batch.num_instances].cpu()))
    return out


def _solve(solver, s, params, insts, seed, device, replicas=1):
    """One compacting_solve at the settings `s` with `replicas` slots an
    instance; the wall time is a host clock around synchronised work
    (loading the weights excluded). Raises if a solution the solver
    reports disagrees with numpy."""
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.time()
    sols, solved, stats = compacting_solve(
        solver, params, torch.Generator().manual_seed(seed),
        insts, s["iterations"], ls_iterations=s["ls"], chunk=s["chunk"],
        min_edges=s["min_edges"], replicas=replicas, device=device)
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
