"""The p-nd-np assembly: the port against the JAX package on the CPU.

p-nd-np is Survey Propagation whose inputs are read off the neural
decimator's [E, 150] states through two learned adaptors (log u =
log_sigmoid(fn_proj), eta_in and force from var_proj), a GRU decimator
over the stacked SP columns ([E, 3] and [E, 2]) and the neural predictor.
Every test here runs the trained r4 checkpoint at full width (hidden 150),
read by each package's own loader, on small batches of uniform 3- and
4-SAT (n around 20), so the chained route is the one taken.

Tolerances:
- the adaptor propagator: rtol 1e-5 / atol 1e-6 against the JAX XLA path
  and against its chained Pallas path in interpret mode (the sums of logs
  are taken in another order); where eta_in rounds to 1 the clamp
  log(FLT_MIN) = -87.3 enters a variable's sum and is subtracted back, so
  the triplet of such an edge is known to ulp(87.3): 4 ulps of it (the
  note in ROADMAP.md section 3);
- the GRU decimator: rtol 1e-5 / atol 1e-5;
- a whole forward from one injected state: the active flags and the
  thresholded predictions exactly, the states and predictions to atol
  1e-4, as tests/test_torch_neural.py holds np-nd-np.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import check_assignment, cnf_instance, random_ksat

from pdp_solver_tpu.fg.batch import pack_instances as jax_pack
from pdp_solver_tpu.modules import decimate as JD
from pdp_solver_tpu.modules import propagate as JPR
from pdp_solver_tpu.solvers import PDPSolver as JaxSolver
from pdp_solver_tpu.solvers import SolverConfig as JaxConfig
from pdp_solver_tpu.solvers.compact import remap_state as jax_remap
from pdp_solver_tpu.train import checkpoint as jckpt
from pdp_solver_tpu.train.loss import cnf_evaluate as jax_cnf_evaluate

from pdp_solver_tpu_torch import convert
from pdp_solver_tpu_torch.fg.batch import pack_instances
from pdp_solver_tpu_torch.modules import propagate as PR
from pdp_solver_tpu_torch.modules.propagate import SPMessages
from pdp_solver_tpu_torch.solvers.base import (
    PDPSolver, SolverConfig, SolverState)
from pdp_solver_tpu_torch.solvers.compact import (
    compacting_solve, instance_slices, remap_state)
from pdp_solver_tpu_torch.train.loss import cnf_evaluate
from pdp_solver_tpu_torch.utils import neural

FLOAT = dict(rtol=1e-5, atol=1e-6)
SATURATED_ATOL = 4 * float(np.spacing(np.float32(87.3)))
R4 = dict(model_type="p-nd-np", hidden_dim=150, mem_hidden_dim=50,
          agg_hidden_dim=50, mem_agg_hidden_dim=50, classifier_dim=50)


@pytest.fixture
def windowed(monkeypatch):
    monkeypatch.setenv("PDP_SEGMENT_BACKEND", "windowed")
    monkeypatch.setenv("PDP_COMPILE_CACHE", "off")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def r4():
    """(JAX solver, JAX params, port params) with the r4 weights."""
    cfg = JaxConfig(name="p-nd-np-r4", **R4)
    jsolver = JaxSolver(cfg)
    template = {"params": jsolver.init_params(jax.random.PRNGKey(0)),
                "global_step": jnp.zeros((), jnp.float32)}
    jparams = jckpt.load_params(
        os.path.dirname(neural.P_ND_NP_CHECKPOINT), template,
        cfg.name)["params"]
    return jsolver, jparams, neural.p_nd_np_params("cpu")


def _instances(seed, k=4, ns=(20, 24, 18), alpha=4.0):
    rng = np.random.default_rng(seed)
    return [cnf_instance(n, random_ksat(rng, n, int(n * alpha), k))
            for n in ns]


def _masks(jb, seed):
    """A liveness mask (some edges dead) and a per-edge instance flag (one
    instance stopped), as numpy f32[E]."""
    rng = np.random.default_rng(seed)
    em = (np.asarray(jb.edge_mask)
          * (rng.uniform(size=jb.num_edges) > 0.2)).astype(np.float32)
    active_b = np.ones(jb.batch_size, np.float32)
    active_b[1] = 0.0
    ae = active_b[np.asarray(jb.var_batch)[np.asarray(jb.edge_var)]]
    return em, ae


def _close(jb, ref, got, eta_in=None, em=None):
    """The real edges to FLOAT; with eta_in and em given (a q column), the
    edges whose eta_in rounds to 1 to SATURATED_ATOL."""
    m = np.asarray(jb.edge_mask) > 0
    r, g = np.asarray(ref), got.numpy()
    if eta_in is not None:
        sat = (np.asarray(eta_in) >= 1.0) & (em > 0)
        np.testing.assert_allclose(g[m & sat], r[m & sat], rtol=1e-5,
                                   atol=SATURATED_ATOL)
        m = m & ~sat
    np.testing.assert_allclose(g[m], r[m], **FLOAT)


def _sp_state(jb, seed):
    return JPR.survey_propagator_init_state(jax.random.PRNGKey(seed),
                                            jb.num_edges, randomized=True)


def _dec_state(jb, seed, h=150):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-1, 1, (jb.num_edges, h)).astype(np.float32)
                 for _ in range(2))


@pytest.mark.parametrize("route", ["xla", "chained"])
@pytest.mark.parametrize("k", [3, 4])
def test_adaptor_propagator_matches_jax(monkeypatch, r4, route, k):
    """One sweep from the same SP messages and decimator states, against
    the JAX XLA path and its chained log-input Pallas kernel."""
    jsolver, jparams, tparams = r4
    monkeypatch.setenv("PDP_FUSED_PASS", "on" if route == "chained"
                       else "off")
    monkeypatch.setenv("PDP_COMPILE_CACHE", "off")
    insts = _instances(40 + k, k=k, alpha=4.0 if k == 3 else 8.0)
    jb, tb = jax_pack(insts), pack_instances(insts, device="cpu")
    assert tb.clause_width == k
    em, ae = _masks(jb, k)
    sp = _sp_state(jb, k)
    dec = _dec_state(jb, k)
    ref = JPR.survey_propagator_apply(
        jparams["prop"], jsolver.prop_cfg, jb, sp,
        tuple(map(jnp.asarray, dec)), jnp.asarray(em), jnp.asarray(ae))
    tdec = tuple(map(torch.from_numpy, dec))
    with torch.no_grad():
        got = PR.survey_propagator_apply(
            PR.SurveyPropagatorConfig(include_adaptors=True,
                                      decimator_dim=150), tb,
            convert.state_from_jax(_np(sp), "cpu"), tdec,
            torch.from_numpy(em), torch.from_numpy(ae),
            adaptors=tparams["prop"])
        _, eta_in, force = tparams["prop"](tdec)
    for r, g in zip(ref.var, got.var):
        _close(jb, r, g, eta_in, em)
    _close(jb, ref.fn[0], got.fn[0])
    # the forces are the signs of the projection
    np.testing.assert_array_equal(got.fn[1].numpy(), np.asarray(ref.fn[1]))
    assert torch.equal(got.fn[1], force)
    # frozen edges keep their messages
    frozen = ae == 0
    np.testing.assert_array_equal(got.var[0].numpy()[frozen],
                                  np.asarray(sp.var[0])[frozen])


def test_adaptors_need_parameters():
    tb = pack_instances(_instances(3), device="cpu")
    sp = PR.survey_propagator_init_state(torch.Generator().manual_seed(0),
                                         tb.num_edges, True, "cpu")
    dec = (torch.zeros(tb.num_edges, 150),) * 2
    with pytest.raises(ValueError):
        PR.survey_propagator_apply(
            PR.SurveyPropagatorConfig(include_adaptors=True,
                                      decimator_dim=150), tb, sp, dec,
            tb.edge_mask, tb.edge_mask)


def test_gru_decimator_on_stacked_columns(r4):
    """The GRU decimator over SP messages stacked to [E, 3] / [E, 2]."""
    jsolver, jparams, tparams = r4
    insts = _instances(5)
    jb, tb = jax_pack(insts), pack_instances(insts, device="cpu")
    _, ae = _masks(jb, 6)
    sp = _sp_state(jb, 7)
    dec = _dec_state(jb, 8)
    ref = JD.neural_decimator_apply(jparams["dec"], jsolver.dec_cfg, jb,
                                    tuple(map(jnp.asarray, dec)), sp,
                                    jnp.asarray(ae))
    with torch.no_grad():
        got = tparams["dec"](tb, tuple(map(torch.from_numpy, dec)),
                             convert.state_from_jax(_np(sp), "cpu"),
                             torch.from_numpy(ae))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)
    frozen = ae == 0
    np.testing.assert_array_equal(got[0].numpy()[frozen], dec[0][frozen])


@pytest.mark.parametrize("finalize", [False, True])
def test_forward_matches_jax_from_same_state(windowed, r4, finalize):
    """A 5-iteration forward with check_termination from one injected
    state (the JAX init state), with the r4 weights at full width."""
    jsolver, jparams, tparams = r4
    insts = _instances(12, ns=(24, 20, 26, 22), alpha=4.5)
    jb, tb = jax_pack(insts), pack_instances(insts, device="cpu")
    jstate0 = jsolver.get_init_state(jax.random.PRNGKey(4), jb,
                                     randomized=True)
    tstate0 = convert.state_from_jax(_np(jstate0), "cpu")
    jout = jsolver.forward(jparams, jax.random.PRNGKey(5), jb, jstate0, 5,
                           is_training=False, check_termination=True,
                           finalize=finalize)
    # no local search, as in the JAX solver built here
    tout = PDPSolver(SolverConfig(**R4)).forward(
        tparams, torch.Generator().manual_seed(0), tb, tstate0, 5,
        check_termination=True, finalize=finalize)
    if finalize:
        (jpred, _), jstate = jout
        (tpred, _), tstate = tout
    else:
        _, jstate, jcarry = jout
        _, tstate, tcarry = tout
        jpred = jcarry[0].solution[:, None]
        tpred = tcarry[0].solution[:, None]
        np.testing.assert_array_equal(tcarry[1].numpy(),
                                      np.asarray(jcarry[1]))
        assert 0 < tcarry[1].numpy()[:len(insts)].sum() < len(insts)
    np.testing.assert_array_equal(tpred.numpy() > 0.5,
                                  np.asarray(jpred) > 0.5)
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), rtol=0,
                               atol=1e-4)
    jsolved, _ = jax_cnf_evaluate(jb, jpred)
    tsolved, _ = cnf_evaluate(tb, tpred)
    np.testing.assert_array_equal(tsolved.numpy(), np.asarray(jsolved))
    real = np.asarray(jb.edge_mask) > 0
    for r, g in zip(jstate.prop.var + jstate.prop.fn + tuple(jstate.dec),
                    tstate.prop.var + tstate.prop.fn + tuple(tstate.dec)):
        np.testing.assert_allclose(g.numpy()[real], np.asarray(r)[real],
                                   rtol=0, atol=1e-4)


def test_params_from_jax_r4(r4):
    """The r4 tree loads into the p-nd-np modules, its widths read off the
    shapes; a missing, unknown or misshapen key raises."""
    jsolver, jparams, tparams = r4
    tree = _np(jparams)
    assert isinstance(tparams["prop"], PR.SurveyAdaptors)
    assert tparams["dec"].var_gru.weight_ih.shape == (450, 4)
    assert tparams["dec"].fn_gru.weight_ih.shape == (450, 3)
    n = sum(p.numel() for p in tparams.parameters())
    assert n == sum(np.size(x) for x in
                    jax.tree_util.tree_leaves(tree)) == 168150
    ckpt = convert.load_jax_checkpoint(neural.P_ND_NP_CHECKPOINT)
    assert set(ckpt) == {"params", "global_step", "opt"}
    for name, p in tparams.named_parameters():
        module, _, leaf = name.rpartition(".")
        node = ckpt["params"]
        for part in module.split("."):
            node = node[part]
        jleaf = {"weight": "w", "bias": "b", "weight_ih": "w_ih",
                 "weight_hh": "w_hh", "bias_ih": "b_ih",
                 "bias_hh": "b_hh"}[leaf]
        arr = node[jleaf]
        np.testing.assert_array_equal(
            p.detach().numpy(), arr.T if arr.ndim == 2 else arr)

    def edited(fn):
        t = jax.tree_util.tree_map(lambda x: x, tree)
        fn(t)
        return t

    def no_var_proj(t):
        del t["prop"]["var_proj"]

    def no_fn_proj_w(t):
        del t["prop"]["fn_proj"]["w"]

    def extra_bias(t):
        t["prop"]["var_proj"]["b"] = np.zeros(2, np.float32)

    def misshapen(t):
        t["prop"]["fn_proj"]["w"] = np.zeros((150, 2), np.float32)

    for fn, err in ((no_var_proj, KeyError), (no_fn_proj_w, KeyError),
                    (extra_bias, KeyError), (misshapen, ValueError)):
        with pytest.raises(err):
            convert.params_from_jax(edited(fn), "cpu")


def test_state_from_jax_and_remap_mixed_state(r4):
    """The mixed state (SP messages, an [E, h] pair, ()) converts, and
    compaction moves its leaves as the JAX package's remap_state does."""
    jsolver = r4[0]
    insts = _instances(15, ns=(150, 400, 140), alpha=4.0)
    jb = jax_pack(insts)
    jstate = jsolver.get_init_state(jax.random.PRNGKey(1), jb,
                                    randomized=True)
    tstate = convert.state_from_jax(_np(jstate), "cpu")
    assert isinstance(tstate, SolverState) and tstate.aux == ()
    assert isinstance(tstate.prop, SPMessages)
    assert tstate.dec[0].shape == (jb.num_edges, 150)
    np.testing.assert_array_equal(tstate.prop.var[1].numpy(),
                                  np.asarray(jstate.prop.var[1]))
    np.testing.assert_array_equal(tstate.dec[1].numpy(),
                                  np.asarray(jstate.dec[1]))
    keep = [0, 2]
    kept = [insts[i] for i in keep]
    old_t = pack_instances(insts, device="cpu")
    new_t = pack_instances(kept, device="cpu")
    new_j = jax_pack(kept)
    old_sl, new_sl = instance_slices(insts), instance_slices(kept)
    got = remap_state(tstate, keep, old_t, new_t, old_sl, new_sl)
    ref = jax_remap(_np(jstate), keep, jb, new_j, old_sl, new_sl)
    assert new_t.num_edges < old_t.num_edges
    assert isinstance(got.prop, SPMessages) and got.aux == ()
    for r, g in zip(ref.prop.var + ref.prop.fn + tuple(ref.dec),
                    got.prop.var + got.prop.fn + tuple(got.dec)):
        assert g.shape[0] == new_t.num_edges
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_assembly_builds():
    solver = PDPSolver(SolverConfig(**R4))
    assert solver.neural_dec and not solver.neural_prop
    assert solver.prop_cfg.include_adaptors
    assert (solver.dec_cfg.var_message_dim,
            solver.dec_cfg.fn_message_dim) == (3, 2)
    params = solver.init_params("cpu")
    assert set(params) == {"prop", "dec", "predictor"}
    assert params["prop"].var_proj.bias is None
    tb = pack_instances(_instances(2), device="cpu")
    state = solver.get_init_state(torch.Generator().manual_seed(0), tb,
                                  randomized=True)
    assert isinstance(state.prop, SPMessages) and state.aux == ()
    assert state.dec[0].shape == (tb.num_edges, 150)
    assert -1.0 <= float(state.dec[0].min()) < float(state.dec[0].max()) \
        <= 1.0
    with pytest.raises(ValueError):
        solver.forward({"dec": None}, None, tb, state, 1)
    # np-d-np is ported: its parameters are the propagator and the scorer
    assert set(PDPSolver(SolverConfig(model_type="np-d-np")).init_params(
        "cpu")) == {"prop", "scorer"}


def test_compacting_solve_with_r4(r4):
    """The trained model through compacting_solve on the CPU: every
    reported solution verifies with numpy, and the network solves
    instances before local search."""
    tparams = r4[2]
    rng = np.random.default_rng(14)
    ns = (20, 24, 18, 26, 22, 20, 30, 34)
    clauses = [random_ksat(rng, n, int(n * 5.0), 4) for n in ns]
    insts = [cnf_instance(n, c) for n, c in zip(ns, clauses)]
    sols, solved, stats = compacting_solve(
        neural.p_nd_np_solver(), tparams, torch.Generator().manual_seed(0),
        insts, 30, ls_iterations=0, chunk=10, min_edges=100000,
        device="cpu")
    for c, sol, ok in zip(clauses, sols, solved):
        assert check_assignment(c, sol) == ok
    assert sum(solved) >= 3
    assert stats["solved"] == sum(solved)
