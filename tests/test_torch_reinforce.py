"""The walk-sat and reinforce assemblies: the port against the JAX package
on the CPU.

The JAX side runs its Pallas kernels in interpret mode (PDP_FUSED_PASS=on
for the edge passes, PDP_SEGMENT_BACKEND=windowed for the var-direction
column reduces of the convergence test and the predictor). States are
handed over with convert.state_from_jax. The REINFORCE coin is decided by
decimation_probability 0 or 1, so both packages take the same branch.
Tolerance: forces, active flags, predictions, the edge mask and the
problem state EQUAL. SP messages after one iteration to rtol 1e-5 / atol
1e-6 on the real edges (sums and logs taken in another order). Fed back
through many iterations they drift apart, because the SP map amplifies an
ulp: in the port alone, moving every initial eta by one ulp moves the
messages by 2.0e-4 after 5 iterations and eta by 9.7e-4 after 24. After
24 iterations the messages are held to atol 1e-2 on the real edges (the
measured gap to JAX is 1.4e-3 on eta, 1.6e-5 on the q triplet), while
every decision taken from them must still be equal.

walk-sat runs no hot loop: its forward goes straight to WalkSAT with the
state untouched. Both assemblies then solve a small set through
`compacting_solve`, every solution checked with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import cnf_instance, random_ksat

from pdp_solver_tpu.fg.batch import pack_instances as jax_pack
from pdp_solver_tpu.modules import decimate as jd
from pdp_solver_tpu.modules import predict as jpr
from pdp_solver_tpu.modules import propagate as jp
from pdp_solver_tpu.problem import state as js
from pdp_solver_tpu.problem.simplify import fused_simplify as jax_simplify
from pdp_solver_tpu.solvers import PDPSolver as JaxSolver
from pdp_solver_tpu.solvers import SolverConfig as JaxConfig

from pdp_solver_tpu_torch import convert
from pdp_solver_tpu_torch.fg.batch import pack_instances
from pdp_solver_tpu_torch.modules import decimate, predict
from pdp_solver_tpu_torch.problem import state as ts
from pdp_solver_tpu_torch.problem.simplify import fused_simplify
from pdp_solver_tpu_torch.solvers.base import (
    PDPSolver, SolverConfig, SolverState, build_solver)
from pdp_solver_tpu_torch.solvers.compact import (
    compacting_solve, instance_slices, remap_state)
from pdp_solver_tpu_torch.utils.benchdata import make_ksat_set
from pdp_solver_tpu_torch.utils.headline import verify_solution

REINFORCE = dict(model_type="reinforce", pi=0.01, epsilon=0.5,
                 local_search_iterations=0)


@pytest.fixture
def kernel_env(monkeypatch):
    monkeypatch.setenv("PDP_FUSED_PASS", "on")
    monkeypatch.setenv("PDP_SEGMENT_BACKEND", "windowed")
    monkeypatch.setenv("PDP_COMPILE_CACHE", "off")


def _instances(seed, n_inst=6, n=20, alpha=9.0, k=4):
    rng = np.random.default_rng(seed)
    return [cnf_instance(n, random_ksat(rng, n, int(n * alpha), k))
            for _ in range(n_inst)]


@pytest.fixture(scope="module")
def both():
    insts = _instances(0)
    jb = jax_pack(insts)
    assert jb.fast_var and jb.fast_clause
    return insts, jb, pack_instances(insts, device="cpu")


def _messages(rng, E):
    v = rng.uniform(0.01, 1.0, (E, 3)).astype(np.float32)
    v /= v.sum(1, keepdims=True)
    eta = rng.uniform(0.0, 0.99, E).astype(np.float32)
    force = rng.choice([-1.0, 0.0, 1.0], E).astype(np.float32)
    return jp.SPMessages(var=tuple(jnp.asarray(v[:, i]) for i in range(3)),
                         fn=(jnp.asarray(eta), jnp.asarray(force)))


@pytest.mark.parametrize("p,has_prev", [(0.0, 1.0), (1.0, 1.0),
                                        (1.0, 0.0)])
def test_decimator_from_injected_state(kernel_env, both, p, has_prev):
    _, jb, tb = both
    rng = np.random.default_rng(3)
    msgs = _messages(rng, jb.num_edges)
    # instances 0 and 1 have converged (|eta - prev| = 0.001), the others
    # have not; instance 2 is inactive already
    inst_e = np.asarray(jb.var_batch)[np.asarray(jb.edge_var)]
    eta = np.asarray(msgs.fn[0])
    noise = rng.uniform(0.0, 0.99, jb.num_edges).astype(np.float32)
    prev = np.where(inst_e < 2, eta + 0.001, noise).astype(np.float32)
    aux = jd.ReinforceDecimatorState(prev_eta=jnp.asarray(prev),
                                     has_prev=jnp.float32(has_prev))
    jprob = jax_simplify(jb, js.init_problem_state(jb))
    tprob = fused_simplify(tb, ts.init_problem_state(tb))
    active = np.asarray(jb.instance_mask).copy()
    active[2] = 0.0
    em = np.asarray(js.compute_edge_mask(jb, jprob))
    ae = np.asarray(js.edge_active_instance_mask(jb, jnp.asarray(active)))
    scfg = jpr.SurveyScorerConfig(pi=0.01)
    ref_aux, ref_msgs, ref_active = jd.reinforce_decimator_apply(
        jd.ReinforceDecimatorConfig(decimation_probability=p),
        lambda m, pr: jpr.survey_scorer_apply({}, scfg, jb, m, pr)[0],
        jax.random.PRNGKey(0), jb, aux, msgs, jprob, jnp.asarray(em),
        jnp.asarray(active), jnp.asarray(ae))
    got_aux, got_msgs, got_active = decimate.reinforce_decimator_apply(
        decimate.ReinforceDecimatorConfig(decimation_probability=p),
        predict.SurveyScorerConfig(pi=0.01), tb,
        convert.state_from_jax(jax.tree_util.tree_map(np.asarray, aux),
                               "cpu"),
        convert.state_from_jax(msgs, "cpu"), tprob,
        torch.from_numpy(em.copy()), torch.from_numpy(active),
        torch.from_numpy(ae.copy()), coin=p == 1.0)
    np.testing.assert_array_equal(got_active.numpy(), np.asarray(ref_active))
    for r, g in zip(ref_msgs.var + ref_msgs.fn, got_msgs.var + got_msgs.fn):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(got_aux.prev_eta.numpy(),
                                  np.asarray(ref_aux.prev_eta))
    assert float(got_aux.has_prev) == float(ref_aux.has_prev) == 1.0
    # the forces moved only under the coin, and the converged instances
    # stopped only with a previous eta to compare with
    moved = (got_msgs.fn[1].numpy() != np.asarray(msgs.fn[1])).any()
    assert moved == (p == 1.0)
    stopped = (active - got_active.numpy())[:jb.batch_size]
    assert stopped[[0, 1]].sum() == (2.0 if has_prev else 0.0)
    assert stopped[3:].sum() == 0


def test_predictor_exact(kernel_env, both):
    _, jb, tb = both
    rng = np.random.default_rng(4)
    msgs = _messages(rng, jb.num_edges)
    ref, _ = jpr.reinforce_predictor_apply(jb, msgs)
    got, _ = predict.reinforce_predictor_apply(
        tb, convert.state_from_jax(msgs, "cpu"))
    assert got.shape == (tb.num_vars, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < float(got.sum()) < tb.num_vars


@pytest.mark.parametrize("iters,msg_tol", [
    (1, dict(rtol=1e-5, atol=1e-6)), (24, dict(rtol=0, atol=1e-2))])
def test_forward_matches_jax_from_same_state(kernel_env, both, iters,
                                             msg_tol):
    """A whole REINFORCE forward from one injected state, p = 1 so the
    coin is always taken: check_termination, then finalize."""
    _, jb, tb = both
    cfg = dict(REINFORCE, decimation_probability=1.0)
    jsolver, tsolver = JaxSolver(JaxConfig(**cfg)), PDPSolver(
        SolverConfig(**cfg))
    jstate0 = jsolver.get_init_state(jax.random.PRNGKey(3), jb,
                                     randomized=True)
    tstate0 = convert.state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate0), "cpu")
    _, jstate, (jprob, jactive, jem) = jsolver.forward(
        {}, jax.random.PRNGKey(4), jb, jstate0, iters, is_training=False,
        check_termination=True, finalize=False)
    gen = torch.Generator().manual_seed(0)
    _, tstate, (tprob, tactive, tem) = tsolver.forward(
        {}, gen, tb, tstate0, iters, check_termination=True,
        finalize=False)
    for f in ("active_vars", "active_clauses", "solution", "is_sat"):
        np.testing.assert_array_equal(getattr(tprob, f).numpy(),
                                      np.asarray(getattr(jprob, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(tactive.numpy(), np.asarray(jactive))
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    m = np.asarray(jb.edge_mask) > 0
    np.testing.assert_array_equal(tstate.dec.fn[1].numpy()[m],
                                  np.asarray(jstate.dec.fn[1])[m])
    for r, g in zip(jstate.prop.var + jstate.prop.fn,
                    tstate.prop.var + tstate.prop.fn):
        np.testing.assert_allclose(g.numpy()[m], np.asarray(r)[m],
                                   **msg_tol)
    assert torch.equal(tstate.aux.prev_eta, tstate.prop.fn[0])
    if iters > 1:
        # instances converged and stopped on the way
        assert float(tactive.sum()) < 6

    (jpred, _), _ = jsolver.forward(
        {}, jax.random.PRNGKey(4), jb, jstate0, iters, is_training=False,
        check_termination=True)
    (tpred, _), _ = tsolver.forward({}, gen, tb, tstate0, iters,
                                    check_termination=True)
    np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))


def test_walk_sat_forward_leaves_state_and_reaches_walksat(kernel_env,
                                                           both):
    _, jb, tb = both
    jsolver = JaxSolver(JaxConfig(model_type="walk-sat", epsilon=0.5))
    tsolver = PDPSolver(SolverConfig(model_type="walk-sat", epsilon=0.5))
    state0 = tsolver.get_init_state(torch.Generator().manual_seed(0), tb,
                                    randomized=True)
    assert state0 == SolverState(prop=(), dec=(), aux=())
    jstate0 = jsolver.get_init_state(jax.random.PRNGKey(0), jb, True)
    _, jstate, (jprob, jactive, jem) = jsolver.forward(
        {}, jax.random.PRNGKey(1), jb, jstate0, 1000, is_training=False,
        check_termination=True, finalize=False)
    _, state, (prob, active, em) = tsolver.forward(
        {}, torch.Generator().manual_seed(0), tb, state0, 1000,
        check_termination=True, finalize=False)
    assert state is state0
    np.testing.assert_array_equal(active.numpy(), np.asarray(jactive))
    np.testing.assert_array_equal(em.numpy(), np.asarray(jem))
    for f in ("active_vars", "active_clauses", "solution", "is_sat"):
        np.testing.assert_array_equal(getattr(prob, f).numpy(),
                                      np.asarray(getattr(jprob, f)))

    # finalize: the random fill of the identity predictor, then WalkSAT,
    # exactly as the port's building blocks compose
    ls = 64
    solver = PDPSolver(SolverConfig(model_type="walk-sat", epsilon=0.5,
                                    local_search_iterations=ls))
    (pred, _), state = solver.forward(
        {}, torch.Generator().manual_seed(5), tb, state0, 1000,
        check_termination=True)
    assert state is state0
    gen = torch.Generator().manual_seed(5)
    problem = fused_simplify(tb, ts.init_problem_state(tb))
    fill, _ = predict.identity_predictor_apply(gen, problem, True, True)
    want = solver.local_search(gen, tb, problem, fill, ls)
    av = problem.active_vars[:, None]
    want = av * want + (1.0 - av) * problem.solution[:, None]
    assert torch.equal(pred, want)
    assert not torch.equal(pred, fill)


@pytest.mark.parametrize("model", ["walk-sat", "reinforce"])
def test_compacting_solve_verified(model):
    insts = make_ksat_set(count=16, n=50, alpha=8.0)
    cfg = dict(model_type=model, epsilon=0.5, local_search_iterations=300)
    if model == "reinforce":
        cfg.update(pi=0.01, decimation_probability=0.5)
    solver = PDPSolver(SolverConfig(**cfg))
    sols, solved, stats = compacting_solve(
        solver, {}, torch.Generator().manual_seed(0), insts, 200,
        ls_iterations=300, chunk=50, min_edges=1000, device="cpu")
    assert [verify_solution(i, s) for i, s in zip(insts, sols)] == solved
    assert sum(solved) >= 2
    assert stats["solved"] == sum(solved)
    if model == "reinforce":
        assert stats["attempts"][0]["progress"], "the loop never stopped"


def test_compaction_carries_reinforce_and_walk_sat_states():
    insts = _instances(1, n_inst=5, n=30, alpha=4.0, k=3)
    batch = pack_instances(insts, device="cpu")
    keep = [0, 2, 4]
    new_insts = [insts[i] for i in keep]
    small = pack_instances(new_insts, device="cpu")
    old_sl, new_sl = instance_slices(insts), instance_slices(new_insts)
    solver = PDPSolver(SolverConfig(**REINFORCE))
    state = solver.get_init_state(torch.Generator().manual_seed(0), batch,
                                  randomized=True)
    state.aux.prev_eta.uniform_()
    state.aux.has_prev.fill_(1.0)
    new = remap_state(state, keep, batch, small, old_sl, new_sl)
    assert isinstance(new.aux, decimate.ReinforceDecimatorState)
    assert new.aux.has_prev is state.aux.has_prev
    assert new.aux.prev_eta.shape == (small.num_edges,)
    for j, i in enumerate(keep):
        _, _, eo, _, _, n = old_sl[i]
        _, _, en, _, _, _ = new_sl[j]
        for a, b in ((state.aux.prev_eta, new.aux.prev_eta),
                     (state.prop.fn[0], new.prop.fn[0]),
                     (state.dec.var[2], new.dec.var[2])):
            assert torch.equal(b[en:en + n], a[eo:eo + n])
    assert float(new.aux.prev_eta[small.num_real_edges:].abs().sum()) == 0
    empty = SolverState(prop=(), dec=(), aux=())
    assert remap_state(empty, keep, batch, small, old_sl, new_sl) == empty


def test_build_solver_and_convert():
    solver = build_solver({"model_type": "reinforce", "pi": 0.01,
                           "decimation_probability": 0.25})
    assert (solver.cfg.pi, solver.cfg.decimation_probability) == (0.01,
                                                                  0.25)
    assert solver.prop_cfg.pi == solver.scorer_cfg.pi == 0.01
    assert solver.dec_cfg.decimation_probability == 0.25
    assert build_solver({"model_type": "walk-sat"}).dec_cfg is None
    # np-d-np is ported: the assembly builds, with its tanh scorer
    assert PDPSolver(SolverConfig(model_type="np-d-np")
                     ).scorer_cfg.classifier_kind == "tanh"
    # p-nd-np is ported: the assembly builds, with its SP adaptors
    assert PDPSolver(SolverConfig(model_type="p-nd-np")
                     ).prop_cfg.include_adaptors
    with pytest.raises(ValueError):
        PDPSolver(SolverConfig(model_type="walk-sat")).forward(
            {"x": 1}, None, None, None, 1)
    jb = jax_pack(_instances(2, n_inst=2))
    for t in ("reinforce", "walk-sat"):
        jstate = JaxSolver(JaxConfig(model_type=t)).get_init_state(
            jax.random.PRNGKey(0), jb, randomized=True)
        got = convert.state_from_jax(
            jax.tree_util.tree_map(np.asarray, jstate), "cpu")
        if t == "walk-sat":
            assert got == SolverState(prop=(), dec=(), aux=())
            continue
        assert isinstance(got.aux, decimate.ReinforceDecimatorState)
        assert got.aux.has_prev.shape == ()
        np.testing.assert_array_equal(got.dec.fn[0].numpy(),
                                      np.asarray(jstate.dec.fn[0]))
