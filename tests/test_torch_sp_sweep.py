"""The one-launch SP sweep (`ops/sp_sweep.py`, kernel 9 of PERF.md): the
port against the JAX package's `sp_full_sweep` on the CPU.

The JAX side runs the Pallas kernel in interpret mode (PDP_FUSED_PASS=on,
PDP_SP_SWEEP=on); the port's wrapper runs its plain version (the two plain
steps of the propagator) because the tensors lie on the CPU. Tolerance:
rtol 1e-5 / atol 1e-6 on the real edges (sums of logs in another order;
the JAX kernel groups padding edges into clauses of its own, so their eta
differs by design). Frozen edges (mask 0) pass through bit for bit.

Several sweeps are chained in the JAX package, and the port's sweep is
held against each of them from the same input. XLA's CPU exp and log
differ from PyTorch's by an ulp, and the SP map amplifies that when each
package is fed its own output: after four sweeps at k = 3 one q_u of 1,080
was 1.8e-5 apart (the JAX kernel and the JAX XLA path, which share exp and
log, agree bit for bit). The port's own chain, through both of its
entry points, must agree with itself exactly.

One input is ill-conditioned in any float32 implementation: where eta_in
rounds to 1, log(1 - eta_in) is the clamp log(FLT_MIN) = -87.3, which
enters the edge's variable sum and is subtracted out again in `same`, so
`same`, and with it the q-triplet, is known only to about ulp(87.3) =
7.6e-6 (seen after three sweeps at k = 3, pi = 0.2: q_s 0.17896616 in JAX,
0.17897151 in the port, 0.17896591 in float64). The triplet of such an
edge is held to atol 4 * ulp(87.3) = 3.05e-5; every other value to the
tolerance above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import cnf_instance, random_ksat

from pdp_solver_tpu.fg.batch import pack_instances as jax_pack
from pdp_solver_tpu.modules import propagate as jp
from pdp_solver_tpu.ops import pallas_sp

from pdp_solver_tpu_torch import convert
from pdp_solver_tpu_torch.fg.batch import pack_instances
from pdp_solver_tpu_torch.modules import propagate
from pdp_solver_tpu_torch.ops import sp_sweep

FLOAT = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def sweep_env(monkeypatch):
    monkeypatch.setenv("PDP_FUSED_PASS", "on")
    monkeypatch.setenv("PDP_SP_SWEEP", "on")
    monkeypatch.setenv("PDP_COMPILE_CACHE", "off")


def _both(seed, k, n_inst=5, n=24, alpha=3.0):
    rng = np.random.default_rng(seed)
    insts = [cnf_instance(n, random_ksat(rng, n, int(n * alpha), k))
             for _ in range(n_inst)]
    return jax_pack(insts), pack_instances(insts, device="cpu")


def _state(jb, seed, pi):
    state = jp.survey_propagator_init_state(
        jax.random.PRNGKey(seed), jb.num_edges, randomized=True)
    if pi:
        force = jnp.sign(jax.random.normal(jax.random.PRNGKey(seed + 5),
                                           (jb.num_edges,)))
        state = jp.SPMessages(var=state.var, fn=(state.fn[0], force))
    return state


def _masks(jb, seed):
    rng = np.random.default_rng(seed)
    em = (np.asarray(jb.edge_mask)
          * (rng.uniform(size=jb.num_edges) > 0.1)).astype(np.float32)
    ae = (rng.uniform(size=jb.num_edges) > 0.2).astype(np.float32)
    return em, ae


SATURATED_ATOL = 4 * float(np.spacing(np.float32(87.3)))


def _real_close(jb, ref, got, eta_in=None, em=None):
    """The real edges to FLOAT; with eta_in and em given (a q column), the
    edges whose eta_in rounds to 1 to SATURATED_ATOL."""
    m = np.asarray(jb.edge_mask) > 0
    r, g = np.asarray(ref), got.numpy()
    if eta_in is not None:
        sat = (eta_in.numpy() >= 1.0) & (em > 0)
        np.testing.assert_allclose(g[m & sat], r[m & sat], rtol=1e-5,
                                   atol=SATURATED_ATOL)
        m = m & ~sat
    np.testing.assert_allclose(g[m], r[m], **FLOAT)


@pytest.mark.parametrize("k,pi", [(3, 0.0), (4, 0.0), (3, 0.2)])
def test_sweep_matches_jax_kernel_over_chained_sweeps(sweep_env, k, pi):
    jb, tb = _both(10 + k, k)
    assert pallas_sp.use_sp_sweep(jb) and sp_sweep.use_sp_sweep(tb)
    em, ae = _masks(jb, k)
    jcfg = jp.SurveyPropagatorConfig(pi=pi)
    tcfg = propagate.SurveyPropagatorConfig(pi=pi)
    js = _state(jb, 0, pi)
    ts = tt = convert.state_from_jax(
        jax.tree_util.tree_map(np.asarray, js), "cpu")
    f = jax.jit(lambda s: jp.survey_propagator_apply(
        {}, jcfg, jb, s, s, jnp.asarray(em), jnp.asarray(ae)))
    em_t, ae_t = torch.from_numpy(em), torch.from_numpy(ae)
    for _ in range(4):
        # one sweep of the port from the JAX chain's state
        src = convert.state_from_jax(
            jax.tree_util.tree_map(np.asarray, js), "cpu")
        js = f(js)
        got = propagate.survey_propagator_apply(tcfg, tb, src, src, em_t,
                                                ae_t)
        for r, g in zip(js.var, got.var):
            _real_close(jb, r, g, src.fn[0], em)
        for r, g in zip(js.fn, got.fn):
            _real_close(jb, r, g)
        # the port's own chain, through the propagator and through the
        # direct call with the JAX function's arguments
        ts = propagate.survey_propagator_apply(tcfg, tb, ts, ts, em_t, ae_t)
        out = sp_sweep.sp_full_sweep(
            tb, u_like=tt.var[0], eta_in=tt.fn[0], em=em_t, mask=ae_t,
            eta_state=tt.fn[0], sign=tb.edge_sign, force=tt.fn[1],
            v0=tt.var[0], v1=tt.var[1], v2=tt.var[2], pi=pi)
        tt = propagate.SPMessages(var=out[1:], fn=(out[0], tt.fn[1]))
    for g, d in zip(ts.var + ts.fn, tt.var + tt.fn):
        assert torch.equal(g, d)


@pytest.mark.parametrize("k,pi", [(3, 0.0), (4, 0.2)])
def test_sweep_matches_two_launch_path(sweep_env, monkeypatch, k, pi):
    """The JAX one-launch kernel against the JAX and the port two-launch
    paths (PDP_SP_SWEEP=off), one sweep from the same state."""
    jb, tb = _both(20 + k, k, n_inst=4, n=30, alpha=4.0)
    em, ae = _masks(jb, 3)
    js = _state(jb, 1, pi)
    ts = convert.state_from_jax(jax.tree_util.tree_map(np.asarray, js),
                                "cpu")
    ref = jp.survey_propagator_apply(
        {}, jp.SurveyPropagatorConfig(pi=pi), jb, js, js, jnp.asarray(em),
        jnp.asarray(ae))
    monkeypatch.setenv("PDP_SP_SWEEP", "off")
    two = propagate.survey_propagator_apply(
        propagate.SurveyPropagatorConfig(pi=pi), tb, ts, ts,
        torch.from_numpy(em), torch.from_numpy(ae))
    for r, g in zip(ref.var + ref.fn, two.var + two.fn):
        _real_close(jb, r, g)


def test_frozen_edges_pass_through(sweep_env):
    jb, tb = _both(42, 3)
    js = _state(jb, 1, 0.0)
    ts = convert.state_from_jax(jax.tree_util.tree_map(np.asarray, js),
                                "cpu")
    em = torch.from_numpy(np.asarray(jb.edge_mask))
    ae = torch.zeros(tb.num_edges)
    out = propagate.survey_propagator_apply(
        propagate.SurveyPropagatorConfig(), tb, ts, ts, em, ae)
    for o, s in zip(out.var + out.fn, ts.var + ts.fn):
        assert torch.equal(o, s)


def test_route_follows_env_and_eligibility(sweep_env, monkeypatch):
    """The propagator takes the one-launch sweep exactly when
    PDP_SP_SWEEP=on and the batch is eligible, as the JAX package does."""
    calls = []
    real = propagate.sp_full_sweep

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(propagate, "sp_full_sweep", spy)
    jb, tb = _both(7, 3, n_inst=2)
    rng = np.random.default_rng(3)
    mixed = [cnf_instance(12, [[1, -2], [2, 3, -4], [5, 6, 7, -8], [9]]),
             cnf_instance(10, random_ksat(rng, 10, 30, 3))]
    jm, tm = jax_pack(mixed), pack_instances(mixed, device="cpu")
    assert pallas_sp.use_sp_sweep(jm) == sp_sweep.use_sp_sweep(tm) is False
    assert pallas_sp.use_sp_sweep(jb) == sp_sweep.use_sp_sweep(tb) is True
    for batch, env, expect in ((tb, "on", 1), (tb, "off", 0),
                               (tm, "on", 0)):
        monkeypatch.setenv("PDP_SP_SWEEP", env)
        calls.clear()
        s = propagate.survey_propagator_init_state(
            torch.Generator().manual_seed(0), batch.num_edges, True, "cpu")
        propagate.survey_propagator_apply(
            propagate.SurveyPropagatorConfig(), batch, s, s,
            batch.edge_mask, torch.ones(batch.num_edges))
        assert len(calls) == expect, (env, batch.clause_width)


def test_login_and_bad_inputs_raise():
    _, tb = _both(1, 3, n_inst=2)
    z = torch.zeros(tb.num_edges)
    cols = dict(u_like=z, eta_in=z, em=z, mask=z, eta_state=z,
                sign=tb.edge_sign, force=z, v0=z, v1=z, v2=z)
    with pytest.raises(NotImplementedError, match="p-nd-np"):
        sp_sweep.sp_full_sweep(tb, login=True, **cols)
    with pytest.raises(ValueError):
        sp_sweep.sp_full_sweep(tb, **dict(cols, v2=z[:-1]))
