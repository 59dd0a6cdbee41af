"""The np-nd-np assembly: the port against the JAX package on the CPU.

Parameters are made by the JAX package (random at small widths: hidden
32, mem/agg hidden 24, mem_agg and classifier 16; or the trained r3
checkpoint at full width) and handed over with convert.load_into /
convert.params_from_jax; states and inputs are made with numpy or by the
JAX package and handed over with convert.state_from_jax. The JAX side runs
kernels 6 and 7 in Pallas interpret mode (PDP_SEGMENT_BACKEND=windowed).

Tolerances: single modules to rtol 1e-5 / atol 1e-5 (the same f32 math,
matrix products and sums taken in another order); whole forwards to atol
1e-4 on the predictions and the states, with the active and solved flags
equal.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import cnf_instance, random_ksat

from pdp_solver_tpu.fg.batch import pack_instances as jax_pack
from pdp_solver_tpu.modules import decimate as JD
from pdp_solver_tpu.modules import mlp as jmlp
from pdp_solver_tpu.modules import predict as JP
from pdp_solver_tpu.modules import propagate as JPR
from pdp_solver_tpu.solvers import PDPSolver as JaxSolver
from pdp_solver_tpu.solvers import SolverConfig as JaxConfig
from pdp_solver_tpu.train import checkpoint as jckpt
from pdp_solver_tpu.train.loss import cnf_evaluate as jax_cnf_evaluate

from pdp_solver_tpu_torch import convert
from pdp_solver_tpu_torch.fg.batch import pack_instances
from pdp_solver_tpu_torch.modules import decimate as D
from pdp_solver_tpu_torch.modules import mlp
from pdp_solver_tpu_torch.modules import predict as P
from pdp_solver_tpu_torch.modules import propagate as PR
from pdp_solver_tpu_torch.solvers.base import PDPSolver, SolverConfig
from pdp_solver_tpu_torch.solvers.compact import compacting_solve
from pdp_solver_tpu_torch.train.loss import cnf_evaluate
from pdp_solver_tpu_torch.utils import neural

TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(model_type="np-nd-np", hidden_dim=32, mem_hidden_dim=24,
             agg_hidden_dim=24, mem_agg_hidden_dim=16, classifier_dim=16)


@pytest.fixture
def windowed(monkeypatch):
    monkeypatch.setenv("PDP_SEGMENT_BACKEND", "windowed")
    monkeypatch.setenv("PDP_COMPILE_CACHE", "off")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _instances(seed, ns=(24, 30, 20), alpha=5.0):
    rng = np.random.default_rng(seed)
    return [cnf_instance(n, random_ksat(rng, n, int(n * alpha), 4))
            for n in ns]


def _batches(seed, **kw):
    insts = _instances(seed, **kw)
    return insts, jax_pack(insts), pack_instances(insts, device="cpu")


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


def _cfg(cls, jcfg):
    """The port's config with the JAX config's values (the JAX configs
    also carry compute_dtype, whose bf16 path is not ported)."""
    return cls(**{f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(cls)})


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


@pytest.mark.parametrize("orient", ["var", "clause"])
@pytest.mark.parametrize("include_self", [False, True])
def test_aggregator_matches_jax(windowed, orient, include_self):
    _, jb, tb = _batches(1)
    cfg = jmlp.AggregatorConfig(
        input_dim=33, output_dim=32, mem_hidden_dim=24,
        mem_agg_hidden_dim=16, agg_hidden_dim=24,
        feature_dim=0 if include_self else 1, include_self=include_self)
    p = jmlp.aggregator_init(jax.random.PRNGKey(2), cfg)
    agg = convert.load_into(
        mlp.Aggregator(_cfg(mlp.AggregatorConfig, cfg)), _np(p))
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (jb.num_edges, 33)).astype(np.float32)
    feat = None if include_self else np.asarray(jb.edge_sign)[:, None]
    em, _ = _masks(jb, 4)
    ref = jmlp.aggregator_apply(p, cfg, jb, jnp.asarray(x),
                                None if feat is None else jnp.asarray(feat),
                                orient, jnp.asarray(em))
    with torch.no_grad():
        got = agg(tb, _t(x), None if feat is None else _t(feat), orient,
                  _t(em))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("head", ["perceptron", "perceptron_tanh", "mlp"])
def test_heads_match_jax(head):
    rng = np.random.default_rng(21)
    x = rng.uniform(-2, 2, (40, 12)).astype(np.float32)
    key = jax.random.PRNGKey(22)
    if head == "mlp":
        p = jmlp.mlp_init(key, [12, 9, 7, 3])
        ref = jmlp.mlp_apply(p, jnp.asarray(x))
        module = mlp.MLP([12, 9, 7, 3])
    else:
        p = jmlp.perceptron_init(key, 12, 9, 3)
        apply = (jmlp.perceptron_apply if head == "perceptron"
                 else jmlp.perceptron_tanh_apply)
        ref = apply(p, jnp.asarray(x))
        module = (mlp.Perceptron if head == "perceptron"
                  else mlp.PerceptronTanh)(12, 9, 3)
    with torch.no_grad():
        got = convert.load_into(module, _np(p))(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_instances_to_edges_matches_jax():
    from pdp_solver_tpu.modules import common as jcommon
    from pdp_solver_tpu_torch.modules import common
    _, jb, tb = _batches(23)
    x = np.random.default_rng(24).standard_normal(
        (jb.batch_size, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        common.instances_to_edges(tb, _t(x)).numpy(),
        np.asarray(jcommon.instances_to_edges(jb, jnp.asarray(x))))


def test_propagator_decimator_predictor_match_jax(windowed):
    _, jb, tb = _batches(5)
    h = 32
    pcfg = JPR.NeuralPropagatorConfig(
        edge_dim=1, decimator_dim=h, meta_dim=0, hidden_dim=h,
        mem_hidden_dim=24, mem_agg_hidden_dim=16, agg_hidden_dim=24,
        dropout=0.0)
    dcfg = JD.NeuralDecimatorConfig(
        var_message_dim=h, fn_message_dim=h, meta_dim=0, hidden_dim=h,
        edge_dim=1, dropout=0.0)
    rcfg = JP.NeuralPredictorConfig(
        decimator_dim=h, prediction_dim=1, edge_dim=1, meta_dim=0,
        mem_hidden_dim=24, agg_hidden_dim=24, mem_agg_hidden_dim=16,
        classifier_dim=16)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(6), 3)
    jp_prop = JPR.neural_propagator_init(k1, pcfg)
    jp_dec = JD.neural_decimator_init(k2, dcfg)
    jp_pred = JP.neural_predictor_init(k3, rcfg)
    prop = convert.load_into(
        PR.NeuralPropagator(_cfg(PR.NeuralPropagatorConfig, pcfg)),
        _np(jp_prop))
    dec = convert.load_into(
        D.NeuralDecimator(_cfg(D.NeuralDecimatorConfig, dcfg)), _np(jp_dec))
    pred = convert.load_into(
        P.NeuralPredictor(_cfg(P.NeuralPredictorConfig, rcfg)),
        _np(jp_pred))

    rng = np.random.default_rng(7)
    states = [rng.uniform(-1, 1, (jb.num_edges, h)).astype(np.float32)
              for _ in range(4)]
    em, ae = _masks(jb, 8)
    j = [jnp.asarray(s) for s in states]
    t = [_t(s) for s in states]
    with torch.no_grad():
        ref = JPR.neural_propagator_apply(
            jp_prop, pcfg, jax.random.PRNGKey(0), jb, (j[0], j[1]),
            (j[2], j[3]), jnp.asarray(em), jnp.asarray(ae), False)
        got = prop(tb, (t[0], t[1]), (t[2], t[3]), _t(em), _t(ae))
        for r, g in zip(ref, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
        # a stopped instance keeps its state
        frozen = ae == 0
        np.testing.assert_array_equal(got[0].numpy()[frozen],
                                      states[0][frozen])

        ref_d = JD.neural_decimator_apply(jp_dec, dcfg, jb, (j[2], j[3]),
                                          ref, jnp.asarray(ae))
        got_d = dec(tb, (t[2], t[3]), got, _t(ae))
        for r, g in zip(ref_d, got_d):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)

        ref_p, _ = JP.neural_predictor_apply(jp_pred, rcfg, jb,
                                             (j[2], j[3]), jnp.asarray(em))
        got_p, _ = pred(tb, (t[2], t[3]), _t(em))
        np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), **TOL)


def _forward_both(jsolver, jparams, tparams, insts, iters, seed,
                  finalize):
    jb = jax_pack(insts)
    tb = pack_instances(insts, device="cpu")
    tsolver = PDPSolver(SolverConfig(**{
        k: getattr(jsolver.cfg, k) for k in (
            "model_type", "hidden_dim", "mem_hidden_dim", "agg_hidden_dim",
            "mem_agg_hidden_dim", "classifier_dim")}))
    jstate0 = jsolver.get_init_state(jax.random.PRNGKey(seed), jb,
                                     randomized=True)
    tstate0 = convert.state_from_jax(_np(jstate0), "cpu")
    jout = jsolver.forward(jparams, jax.random.PRNGKey(seed + 1), jb,
                           jstate0, iters, is_training=False,
                           check_termination=True, finalize=finalize)
    tout = tsolver.forward(tparams, torch.Generator().manual_seed(0), tb,
                           tstate0, iters, check_termination=True,
                           finalize=finalize)
    return jb, tb, jout, tout


def _check_states(jstate, tstate):
    for jpair, tpair in ((jstate.prop, tstate.prop),
                         (jstate.dec, tstate.dec)):
        for r, g in zip(jpair, tpair):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                       atol=1e-4)


def test_forward_matches_jax_from_same_state(windowed):
    """10 iterations, check_termination=True, random small-width params."""
    jsolver = JaxSolver(JaxConfig(**SMALL))
    jparams = jsolver.init_params(jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(_np(jparams), "cpu")
    insts = _instances(11)
    jb, tb, (_, jstate, jcarry), (_, tstate, tcarry) = _forward_both(
        jsolver, jparams, tparams, insts, 10, 3, finalize=False)
    np.testing.assert_allclose(tcarry[0].solution.numpy(),
                               np.asarray(jcarry[0].solution), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(tcarry[1].numpy(), np.asarray(jcarry[1]))
    np.testing.assert_array_equal(tcarry[2].numpy(), np.asarray(jcarry[2]))
    jsolved, _ = jax_cnf_evaluate(jb, jcarry[0].solution[:, None])
    tsolved, _ = cnf_evaluate(tb, tcarry[0].solution[:, None])
    np.testing.assert_array_equal(tsolved.numpy(), np.asarray(jsolved))
    _check_states(jstate, tstate)


@pytest.fixture(scope="module")
def r3():
    """The r3 checkpoint read by each package's own loader."""
    cfg = JaxConfig(model_type="np-nd-np", name="np-nd-np-r3")
    jsolver = JaxSolver(cfg)
    template = {"params": jsolver.init_params(jax.random.PRNGKey(0)),
                "global_step": jnp.zeros((), jnp.float32)}
    jparams = jckpt.load_params(os.path.dirname(neural.CHECKPOINT),
                                template, cfg.name)["params"]
    return jsolver, jparams, neural.np_nd_np_params("cpu")


@pytest.mark.parametrize("finalize", [False, True])
def test_r3_checkpoint_forward_matches_jax(windowed, r3, finalize):
    """Full width (hidden 150) with the trained weights: one 6-iteration
    forward on a 4-instance batch, of which the network solves two. Without
    finalize: the in-loop predictions, the active flags and the states;
    with it: the prediction of the predictor's last call."""
    jsolver, jparams, tparams = r3
    assert tparams["dec"].var_gru.weight_hh.shape == (450, 150)
    n_params = sum(p.numel() for p in tparams.parameters())
    assert n_params == sum(np.size(x) for x in
                           jax.tree_util.tree_leaves(jparams)) == 401400
    insts = _instances(12, ns=(30, 26, 34, 22), alpha=6.0)
    jb, tb, jout, tout = _forward_both(jsolver, jparams, tparams, insts, 6,
                                       5, finalize=finalize)
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
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), rtol=0,
                               atol=1e-4)
    jsolved, _ = jax_cnf_evaluate(jb, jpred)
    tsolved, _ = cnf_evaluate(tb, tpred)
    np.testing.assert_array_equal(tsolved.numpy(), np.asarray(jsolved))
    _check_states(jstate, tstate)


def test_params_from_jax_rejects_bad_trees():
    jsolver = JaxSolver(JaxConfig(**SMALL))
    good = _np(jsolver.init_params(jax.random.PRNGKey(0)))
    assert len(convert.params_from_jax(good, "cpu")) == 3

    def edited(fn):
        tree = jax.tree_util.tree_map(lambda x: x, good)
        fn(tree)
        return tree

    def extra_leaf(t):
        t["dec"]["var_gru"]["w_xx"] = np.zeros((3, 3), np.float32)

    def extra_module(t):
        t["predictor"]["head2"] = {"w": np.zeros((16, 1), np.float32)}

    def missing(t):
        del t["dec"]["fn_gru"]["b_hh"]

    def misshapen(t):
        t["dec"]["fn_gru"]["w_hh"] = np.zeros((32, 97), np.float32)

    for fn, err in ((extra_leaf, KeyError), (extra_module, KeyError),
                    (missing, KeyError), (misshapen, ValueError)):
        with pytest.raises(err):
            convert.params_from_jax(edited(fn), "cpu")
    with pytest.raises(KeyError):
        convert.params_from_jax(dict(good, scorer={}), "cpu")
    with pytest.raises(ValueError):
        PDPSolver(SolverConfig(**SMALL)).forward(
            {"prop": None}, None, None, None, 1)


def test_checkpoint_keys_parse():
    tree = convert.load_jax_checkpoint(neural.CHECKPOINT)
    assert set(tree) == {"params", "global_step"}
    assert tree["params"]["dec"]["fn_gru"]["w_ih"].shape == (151, 450)


def test_chunked_forward_equals_single_shot():
    solver = PDPSolver(SolverConfig(**SMALL))
    torch.manual_seed(0)
    params = solver.init_params("cpu")
    tb = pack_instances(_instances(13), device="cpu")
    state0 = solver.get_init_state(torch.Generator().manual_seed(1), tb,
                                   randomized=True)
    _, s1, c1 = solver.forward(params, None, tb, state0, 9,
                               check_termination=True, finalize=False)
    state, carry = state0, None
    for n in (4, 5):
        _, state, carry = solver.forward(params, None, tb, state, n,
                                         check_termination=True,
                                         carry=carry, finalize=False)
    for a, b in zip(s1.prop + s1.dec, state.prop + state.dec):
        assert torch.equal(a, b)
    assert torch.equal(c1[0].solution, carry[0].solution)


def test_compacting_solve_with_r3(r3):
    """The trained model through compacting_solve on the CPU: every
    reported solution verifies, and the network solves instances before
    local search."""
    _, _, tparams = r3
    insts = _instances(14, ns=(20, 24, 18, 26, 22, 20, 30, 34), alpha=7.0)
    sols, solved, stats = compacting_solve(
        neural.np_nd_np_solver(), tparams, torch.Generator().manual_seed(0),
        insts, 30, ls_iterations=0, chunk=10, min_edges=100000,
        device="cpu")
    for inst, sol, ok in zip(insts, sols, solved):
        assert neural.verify_solution(inst, sol) == ok
    assert sum(solved) >= 4


def test_remap_state_carries_neural_states():
    """Compaction moves each kept instance's [E, h] rows to its new slots
    and zero-fills the new padding, as the JAX package's remap_state."""
    from pdp_solver_tpu.solvers.compact import remap_state as jax_remap
    from pdp_solver_tpu_torch.solvers.compact import (
        instance_slices, remap_state)
    insts = _instances(15, ns=(150, 200, 140), alpha=5.0)
    keep = [0, 2]
    kept = [insts[i] for i in keep]
    old_t, new_t = (pack_instances(insts, device="cpu"),
                    pack_instances(kept, device="cpu"))
    old_j, new_j = jax_pack(insts), jax_pack(kept)
    rng = np.random.default_rng(16)
    states = tuple(rng.uniform(-1, 1, (old_t.num_edges, 8)).astype(
        np.float32) for _ in range(2))
    old_sl, new_sl = instance_slices(insts), instance_slices(kept)
    got = remap_state(tuple(map(_t, states)), keep, old_t, new_t, old_sl,
                      new_sl)
    ref = jax_remap(states, keep, old_j, new_j, old_sl, new_sl)
    assert new_t.num_edges < old_t.num_edges
    for r, g in zip(ref, got):
        assert g.shape == (new_t.num_edges, 8)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
