"""CNF verification with the freeze and the next edge masks in one call
(`ops/verify.py`, kernel 10 of PERF.md): the port against the JAX package's
`verify_and_masks` on the CPU, and against the port's own split path.

The JAX side runs the Pallas kernel in interpret mode; the port's wrapper
runs its plain version because the tensors lie on the CPU. Every output is
a count or a 0/1 flag and must match exactly, on every edge, padding edges
included. The batches hold planted instances, and the prediction is a
satisfying assignment on some of them, so both verdicts occur and the
freeze of `ae` is exercised; some variables and clauses are inactive and
one instance has already stopped.

The hot loop with PDP_VERIFY_MASKS=on must give the same active-flag
trajectory and the same solution as with it off, for p-d-p and p-nd-np.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import cnf_instance, random_ksat

from pdp_solver_tpu.fg.batch import pack_instances as jax_pack
from pdp_solver_tpu.ops import pallas_verify
from pdp_solver_tpu.problem.state import init_problem_state as jax_init

from pdp_solver_tpu_torch.fg.batch import pack_instances
from pdp_solver_tpu_torch.ops import verify
from pdp_solver_tpu_torch.problem.state import (
    edge_masks_pair, init_problem_state)
from pdp_solver_tpu_torch.solvers import base
from pdp_solver_tpu_torch.solvers.base import PDPSolver, SolverConfig
from pdp_solver_tpu_torch.train.loss import cnf_evaluate
from pdp_solver_tpu_torch.utils import neural


@pytest.fixture
def fused_env(monkeypatch):
    monkeypatch.setenv("PDP_FUSED_PASS", "on")
    monkeypatch.setenv("PDP_COMPILE_CACHE", "off")


def planted(rng, n, m, k):
    """A k-SAT clause list satisfied by a random assignment, and that
    assignment (0/1)."""
    x = rng.integers(0, 2, size=n)
    clauses = []
    while len(clauses) < m:
        c = random_ksat(rng, n, 1, k)[0]
        if any((lit > 0) == bool(x[abs(lit) - 1]) for lit in c):
            clauses.append(c)
    return clauses, x.astype(np.float32)


def _case(k, seed, n_inst=6, n=20):
    """Both packs, a problem state with some variables and clauses
    inactive, active flags with instance 2 stopped, and a prediction that
    satisfies instances 0, 1, 2 and 4 (numpy arrays)."""
    rng = np.random.default_rng(seed)
    m = 50 if k == 3 else 70
    cls, xs = zip(*[planted(rng, n, m, k) for _ in range(n_inst)])
    insts = [cnf_instance(n, c) for c in cls]
    jb, tb = jax_pack(insts), pack_instances(insts, device="cpu")
    av = np.asarray(jb.var_mask).copy()
    ac = np.asarray(jb.clause_mask).copy()
    av[[3, 47]] = 0.0
    ac[[7, 60]] = 0.0
    pred = rng.uniform(size=jb.num_vars).astype(np.float32)
    for b in (0, 1, 2, 4):
        pred[b * n:(b + 1) * n] = xs[b]
    active = np.asarray(jb.instance_mask).copy()
    active[2] = 0.0
    return jb, tb, av, ac, active, pred[:, None]


def _problem(tb, av, ac):
    return init_problem_state(tb).replace(
        active_vars=torch.from_numpy(av), active_clauses=torch.from_numpy(ac))


@pytest.mark.parametrize("k,seed", [(3, 0), (4, 1)])
def test_matches_jax_kernel(fused_env, k, seed):
    jb, tb, av, ac, active, pred = _case(k, seed)
    assert pallas_verify.use_verify_masks(jb) and verify.use_verify_masks(tb)
    jprob = jax_init(jb)._replace(active_vars=jnp.asarray(av),
                                  active_clauses=jnp.asarray(ac))
    ref = pallas_verify.verify_and_masks(
        jb, jprob, jnp.asarray(active), jnp.asarray(pred), interpret=True)
    got = verify.verify_and_masks(tb, _problem(tb, av, ac),
                                  torch.from_numpy(active),
                                  torch.from_numpy(pred))
    for name, r, g in zip(("solved", "unsat", "em", "ae"), ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=name)
    solved = got[0].numpy()[:len(active)]
    assert list(solved[:6]) == [1, 1, 1, 0, 1, 0]
    # the freeze: instance 0 was active and is solved now, its edges go 0
    assert got[3].numpy()[:tb.num_real_edges].min() == 0.0
    assert got[3].numpy()[:tb.num_real_edges].max() == 1.0
    assert tb.num_edges > tb.num_real_edges


@pytest.mark.parametrize("k,seed", [(3, 2), (4, 3)])
def test_matches_split_path(k, seed):
    """cnf_evaluate, the freeze and edge_masks_pair, exactly, on every
    edge."""
    _, tb, av, ac, active, pred = _case(k, seed, n_inst=5, n=24)
    problem = _problem(tb, av, ac)
    act = torch.from_numpy(active)
    p = torch.from_numpy(pred)
    got = verify.verify_and_masks(tb, problem, act, p)
    solved, unsat = cnf_evaluate(tb, p)
    em, ae = edge_masks_pair(tb, problem,
                             act * (solved <= 0.5).to(torch.float32))
    for name, r, g in zip(("solved", "unsat", "em", "ae"),
                          (solved, unsat, em, ae), got):
        assert torch.equal(g, r), name
    assert 0 < float(got[0][:5].sum()) < 5


def test_eligibility_follows_jax(fused_env):
    rng = np.random.default_rng(4)
    uniform = [cnf_instance(12, random_ksat(rng, 12, 40, 3))
               for _ in range(3)]
    mixed = [cnf_instance(12, [[1, -2], [2, 3, -4], [5, 6, 7, -8], [9]]),
             cnf_instance(10, random_ksat(rng, 10, 30, 3))]
    for insts, expect in ((uniform, True), (mixed, False)):
        assert (pallas_verify.use_verify_masks(jax_pack(insts))
                == verify.use_verify_masks(
                    pack_instances(insts, device="cpu")) is expect)


def test_bad_inputs_raise():
    _, tb, av, ac, active, pred = _case(3, 5)
    problem = _problem(tb, av, ac)
    act, p = torch.from_numpy(active), torch.from_numpy(pred)
    with pytest.raises(ValueError):
        verify.verify_and_masks(tb, problem, act, p[:, 0])
    with pytest.raises(ValueError):
        verify.verify_and_masks(tb, problem, act[:-1], p)
    with pytest.raises(ValueError):
        verify.verify_and_masks(tb, problem, act.double(), p)
    with pytest.raises(ValueError):
        verify.verify_and_masks(
            tb, problem.replace(active_clauses=problem.active_clauses[:-1]),
            act, p)


def _p_d_p():
    # a decimation every iteration, so instances are solved within the run
    return PDPSolver(SolverConfig(model_type="p-d-p", tolerance=1.0,
                                  t_max=1)), {}


def _p_nd_np():
    return neural.p_nd_np_solver(), neural.p_nd_np_params("cpu")


@pytest.mark.parametrize("make", [_p_d_p, _p_nd_np], ids=["p-d-p",
                                                           "p-nd-np"])
def test_forward_same_with_verify_masks(monkeypatch, make):
    """One iteration at a time: the active flags after each and the final
    solution are the same with PDP_VERIFY_MASKS on and off, and the on run
    went through verify_and_masks once per iteration."""
    solver, params = make()
    rng = np.random.default_rng(6)
    ns = (20, 24, 18, 22)
    insts = [cnf_instance(n, random_ksat(rng, n, int(n * 3.0), 4))
             for n in ns]
    tb = pack_instances(insts, device="cpu")
    assert verify.use_verify_masks(tb)
    calls = []
    real = base.verify_and_masks

    def spy(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(base, "verify_and_masks", spy)
    runs = {}
    for mode in ("off", "on"):
        monkeypatch.setenv("PDP_VERIFY_MASKS", mode)
        calls.clear()
        state = solver.get_init_state(torch.Generator().manual_seed(0), tb,
                                      randomized=True)
        gen = torch.Generator().manual_seed(1)
        carry, flags = None, []
        for _ in range(12):
            _, state, carry = solver.forward(
                params, gen, tb, state, 1, check_termination=True,
                carry=carry, finalize=False)
            flags.append(carry[1].clone())
        runs[mode] = (torch.stack(flags), carry[0].solution, len(calls))
    off, on = runs["off"], runs["on"]
    assert torch.equal(on[0], off[0])
    assert torch.equal(on[1], off[1])
    assert (off[2], on[2]) == (0, 12)
    # instances stop along the way, so the freeze is exercised
    stopped = (on[0][:, :len(ns)] == 0).sum(1)
    assert stopped[0] < stopped[-1], stopped


def test_verify_masks_needs_termination_and_eligibility(monkeypatch):
    monkeypatch.setenv("PDP_VERIFY_MASKS", "on")
    calls = []
    monkeypatch.setattr(base, "verify_and_masks",
                        lambda *a: calls.append(1))
    solver, params = _p_d_p()
    mixed = [cnf_instance(12, [[1, -2], [2, 3, -4], [5, 6, 7, -8], [9]]),
             cnf_instance(10, random_ksat(np.random.default_rng(7), 10, 30,
                                          3))]
    rng = np.random.default_rng(8)
    uniform = [cnf_instance(14, random_ksat(rng, 14, 50, 3))
               for _ in range(2)]
    for insts, check in ((mixed, True), (uniform, False)):
        tb = pack_instances(insts, device="cpu")
        state = solver.get_init_state(torch.Generator().manual_seed(0), tb,
                                      randomized=True)
        solver.forward(params, torch.Generator().manual_seed(1), tb, state,
                       2, check_termination=check, finalize=False)
    assert calls == []
