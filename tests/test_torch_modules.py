"""SP sweep, survey scorer, sequential decimator, verification and edge
masks: the port against the JAX package from identical injected state.

The JAX side runs its Pallas kernels in interpret mode (PDP_FUSED_PASS=on).
Messages are floats summed in another order: rtol 1e-5 / atol 1e-6 on real
edges and variables. Decimator picks, the simplified problem, counters,
verification counts and masks are flags or small integers: exact.
"""

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
from pdp_solver_tpu.train import loss as jl

from pdp_solver_tpu_torch import convert
from pdp_solver_tpu_torch.fg.batch import pack_instances
from pdp_solver_tpu_torch.modules import decimate, predict, propagate
from pdp_solver_tpu_torch.problem import state as ts
from pdp_solver_tpu_torch.problem.simplify import fused_simplify
from pdp_solver_tpu_torch.train import loss

FLOAT = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def fused_env(monkeypatch):
    monkeypatch.setenv("PDP_FUSED_PASS", "on")


@pytest.fixture(scope="module")
def both():
    rng = np.random.default_rng(0)
    insts = [cnf_instance(20, random_ksat(rng, 20, 84, k=4))
             for _ in range(5)]
    jb = jax_pack(insts)
    tb = pack_instances(insts, device="cpu")
    assert jb.fast_var and jb.fast_clause
    return jb, tb


def _messages(rng, E):
    v = rng.uniform(0.01, 1.0, (E, 3)).astype(np.float32)
    v /= v.sum(1, keepdims=True)
    eta = rng.uniform(0.0, 0.99, E).astype(np.float32)
    force = np.zeros(E, np.float32)
    return jp.SPMessages(var=tuple(jnp.asarray(v[:, i]) for i in range(3)),
                         fn=(jnp.asarray(eta), jnp.asarray(force)))


def _np(x):
    return np.asarray(x)


def _real_close(jb, ref, got, tol=FLOAT):
    m = np.asarray(jb.edge_mask) > 0
    np.testing.assert_allclose(got.numpy()[m], _np(ref)[m], **tol)


@pytest.mark.parametrize("pi", [0.0, 0.2])
def test_sp_sweep_from_injected_messages(fused_env, both, pi):
    jb, tb = both
    rng = np.random.default_rng(1)
    prop, dec = _messages(rng, jb.num_edges), _messages(rng, jb.num_edges)
    if pi:
        force = np.sign(rng.normal(size=jb.num_edges)).astype(np.float32)
        dec = dec._replace(fn=(dec.fn[0], jnp.asarray(force)))
    em = (np.asarray(jb.edge_mask)
          * (rng.uniform(size=jb.num_edges) > 0.2)).astype(np.float32)
    ae = (rng.uniform(size=jb.num_edges) > 0.3).astype(np.float32)
    ref = jp.survey_propagator_apply(
        {}, jp.SurveyPropagatorConfig(pi=pi), jb, prop, dec,
        jnp.asarray(em), jnp.asarray(ae))
    got = propagate.survey_propagator_apply(
        propagate.SurveyPropagatorConfig(pi=pi), tb,
        convert.state_from_jax(prop, "cpu"),
        convert.state_from_jax(dec, "cpu"),
        torch.from_numpy(em), torch.from_numpy(ae))
    for r, g in zip(ref.var + ref.fn, got.var + got.fn):
        _real_close(jb, r, g)


def test_survey_scorer(fused_env, both):
    jb, tb = both
    rng = np.random.default_rng(2)
    msgs = _messages(rng, jb.num_edges)
    jprob = jax_simplify(jb, js.init_problem_state(jb))
    tprob = fused_simplify(tb, ts.init_problem_state(tb))
    ref, _ = jpr.survey_scorer_apply({}, jpr.SurveyScorerConfig(), jb, msgs,
                                     jprob)
    got, _ = predict.survey_scorer_apply(
        predict.SurveyScorerConfig(), tb, convert.state_from_jax(msgs, "cpu"),
        tprob)
    np.testing.assert_allclose(got.numpy(), _np(ref), **FLOAT)


@pytest.mark.parametrize("threshold,rounds", [(1.0, 1), (1.0, 0), (0.6, 1)])
def test_decimator_picks_from_injected_messages(fused_env, both, threshold,
                                                rounds):
    jb, tb = both
    rng = np.random.default_rng(3)
    msgs = _messages(rng, jb.num_edges)
    # instances 0 and 1 converged, 3 times out, 4 neither; 2 is inactive
    inst_e = np.asarray(jb.var_batch)[np.asarray(jb.edge_var)]
    eta = np.asarray(msgs.fn[0])
    noise = rng.uniform(0.0, 0.99, jb.num_edges).astype(np.float32)
    prev = np.where(inst_e < 2, eta + 0.001, noise).astype(np.float32)
    counters = np.array([0, 3, 9, 10, 0] + [0] * (jb.batch_size - 5),
                        np.float32)
    aux = jd.SeqDecimatorState(prev_eta=jnp.asarray(prev),
                               counters=jnp.asarray(counters),
                               has_prev=jnp.float32(1.0))
    jprob = jax_simplify(jb, js.init_problem_state(jb))
    tprob = fused_simplify(tb, ts.init_problem_state(tb))
    active = np.asarray(jb.instance_mask).copy()
    active[2] = 0.0
    em = js.compute_edge_mask(jb, jprob)
    cfg = dict(tolerance=0.08, t_max=10.0, decimation_threshold=threshold,
               simplify_rounds=rounds)
    scfg = jpr.SurveyScorerConfig()
    ref_aux, ref_prob, ref_active = jd.sequential_decimator_apply(
        jd.SeqDecimatorConfig(**cfg),
        lambda m, p: jpr.survey_scorer_apply({}, scfg, jb, m, p)[0],
        jb, aux, msgs, jprob, em, jnp.asarray(active),
        scorer_tail_fn=lambda agg: jpr.survey_scorer_tail(scfg, agg))
    got_aux, got_prob, got_active = decimate.sequential_decimator_apply(
        decimate.SeqDecimatorConfig(**cfg), predict.SurveyScorerConfig(),
        tb, convert.state_from_jax(aux, "cpu"),
        convert.state_from_jax(msgs, "cpu"), tprob,
        torch.from_numpy(np.array(em)), torch.from_numpy(active))
    for f in ("active_vars", "active_clauses", "solution", "is_sat"):
        np.testing.assert_array_equal(getattr(got_prob, f).numpy(),
                                      _np(getattr(ref_prob, f)), err_msg=f)
    np.testing.assert_array_equal(got_active.numpy(), _np(ref_active))
    np.testing.assert_array_equal(got_aux.counters.numpy(),
                                  _np(ref_aux.counters))
    # decimation really happened, in instances 0, 1 and 3 only
    fixed = _np(jprob.active_vars) - _np(ref_prob.active_vars)
    per_inst = np.bincount(np.asarray(jb.var_batch), weights=fixed,
                           minlength=5)
    assert (per_inst[[0, 1, 3]] > 0).all() and per_inst[[2, 4]].sum() == 0


def test_cnf_evaluate_exact(fused_env, both):
    jb, tb = both
    rng = np.random.default_rng(4)
    for p in (rng.uniform(size=(jb.num_vars, 1)),
              (rng.uniform(size=(jb.num_vars, 1)) > 0.5) * 1.0,
              np.ones((jb.num_vars, 1))):
        p = p.astype(np.float32)
        ref = jl.cnf_evaluate(jb, jnp.asarray(p))
        got = loss.cnf_evaluate(tb, torch.from_numpy(p))
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g.numpy(), _np(r))
    np.testing.assert_array_equal(
        loss.literal_values(tb, torch.from_numpy(p)).numpy(),
        _np(jl.literal_values(jb, jnp.asarray(p))))


def test_edge_mask_helpers(fused_env, both):
    jb, tb = both
    rng = np.random.default_rng(5)
    jprob = jax_simplify(jb, js.init_problem_state(jb))
    tprob = fused_simplify(tb, ts.init_problem_state(tb))
    active = (rng.uniform(size=jb.batch_size) > 0.4).astype(np.float32)
    ta = torch.from_numpy(active)
    _real_close(jb, js.compute_edge_mask(jb, jprob),
                ts.compute_edge_mask(tb, tprob), dict(rtol=0, atol=0))
    _real_close(jb, js.edge_active_instance_mask(jb, jnp.asarray(active)),
                ts.edge_active_instance_mask(tb, ta), dict(rtol=0, atol=0))
    for r, g in zip(js.edge_masks_pair(jb, jprob, jnp.asarray(active)),
                    ts.edge_masks_pair(tb, tprob, ta)):
        _real_close(jb, r, g, dict(rtol=0, atol=0))
