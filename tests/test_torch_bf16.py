"""compute_dtype="bfloat16": the port's neural modules and assemblies
against the JAX package's bf16 path on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs kernels 6 and 7 in Pallas interpret mode
(PDP_SEGMENT_BACKEND=windowed) where the module reaches them. Both
packages follow the same dtype flow (`modules/mlp.py`'s docstring): the
first MLP of an aggregator and the GRU cells in bf16, the sums, the
gathers and the second MLP in f32 with bf16-rounded weights, every
classifier in f32.

Tolerances, and why: bf16 keeps 8 significant bits (a relative step of
2^-8 = 0.0039), and the two packages round at other places (XLA rounds
the product and the bias add separately and may keep an elementwise
chain in f32; torch's addmm adds the bias before it rounds once), so an
element can differ by an ulp or two of bf16 after each layer:
  - an aggregator's output (log-sigmoid values, |x| < ~5): atol 0.02;
  - a GRU cell's output (in (-1, 1), rounded to bf16 on output): atol
    0.02;
  - the propagator, decimator and predictor modules: atol 0.02 on states
    and 0.01 on the predictions (sigmoid outputs);
  - short forwards from one injected state: the active and solved flags
    equal, predictions within 0.05 (the bound of the JAX package's own
    tests/test_bf16.py:34); the [E, h] states, which feed back their
    rounding every iteration, to a mean |difference| under 0.005, 99.9% of
    the elements within 0.05 and all within 0.25 (the r3 and r4 weights
    on the CPU: mean 0.0011-0.0020, 99.9th percentile 0.017-0.039, max
    0.16, in a few GRU elements of p-nd-np's decimator);
  - the f32-against-bf16 distance of the predictions (max |difference|)
    from one state after 5 and 10 iterations (neural.BF16_CHECK): the
    port's at most neural.BF16_DRIFT_RATIO (1.5) times JAX's own on the
    same state (on the CPU the port's reads 0.76 and 1.19 times JAX's),
    and JAX's equal to the figures chip_smoke.py gates the card with
    (neural.BF16_CHECK_JAX_DRIFT) to 0.0005.
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
from pdp_solver_tpu.solvers.base import SolverState as JaxState
from pdp_solver_tpu.train import checkpoint as jckpt
from pdp_solver_tpu.train.loss import cnf_evaluate as jax_cnf_evaluate
from pdp_solver_tpu.utils import config as jconfig

from pdp_solver_tpu_torch import convert
from pdp_solver_tpu_torch.fg.batch import pack_instances
from pdp_solver_tpu_torch.modules import decimate as D
from pdp_solver_tpu_torch.modules import mlp
from pdp_solver_tpu_torch.modules import predict as P
from pdp_solver_tpu_torch.modules import propagate as PR
from pdp_solver_tpu_torch.solvers.base import (
    PDPSolver, SolverConfig, build_solver)
from pdp_solver_tpu_torch.train.loss import cnf_evaluate
from pdp_solver_tpu_torch.utils import config, neural
from pdp_solver_tpu_torch.utils.benchdata import make_ksat_set

BF16 = "bfloat16"
AGG_ATOL = 0.02
GRU_ATOL = 0.02
STATE_ATOL = 0.02
PRED_ATOL = 0.01
FORWARD_PRED_ATOL = 0.05
FORWARD_STATE = dict(mean=0.005, p999=0.05, max=0.25)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_CHECKPOINT = os.path.join(ROOT, neural.FLAGSHIP["model_path"],
                                   "np-nd-np-full.npz")


@pytest.fixture
def windowed(monkeypatch):
    monkeypatch.setenv("PDP_SEGMENT_BACKEND", "windowed")
    monkeypatch.setenv("PDP_COMPILE_CACHE", "off")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.tensor(np.asarray(x, dtype=np.float32))


def _instances(seed, ns=(24, 30, 20), alpha=5.0, k=4):
    rng = np.random.default_rng(seed)
    return [cnf_instance(n, random_ksat(rng, n, int(n * alpha), k))
            for n in ns]


def _batches(seed, **kw):
    insts = _instances(seed, **kw)
    return jax_pack(insts), pack_instances(insts, device="cpu")


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
    """The port's config with the JAX config's values."""
    return cls(**{f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(cls)})


def _close(got, ref, atol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("orient", ["var", "clause"])
@pytest.mark.parametrize("include_self", [False, True])
def test_aggregator_bf16_matches_jax(windowed, orient, include_self):
    jb, tb = _batches(1)
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
                                orient, jnp.asarray(em), dtype=jnp.bfloat16)
    with torch.no_grad():
        got = agg(tb, _t(x), None if feat is None else _t(feat), orient,
                  _t(em), torch.bfloat16)
        f32 = agg(tb, _t(x), None if feat is None else _t(feat), orient,
                  _t(em))
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    _close(got, ref, AGG_ATOL)
    # bf16 moved the result (it is not the f32 path under another name)
    assert float((got - f32).abs().max()) > 1e-4


def test_gru_cell_bf16_matches_jax():
    rng = np.random.default_rng(5)
    p = jmlp.gru_cell_init(jax.random.PRNGKey(6), 33, 32)
    cell = convert.load_into(mlp.GRUCell(33, 32), _np(p))
    x = rng.uniform(-1, 1, (300, 33)).astype(np.float32)
    h = rng.uniform(-1, 1, (300, 32)).astype(np.float32)
    ref = jmlp.gru_cell_apply(jmlp.cast_tree(p, jnp.bfloat16),
                              jnp.asarray(x, jnp.bfloat16),
                              jnp.asarray(h, jnp.bfloat16)).astype(
                                  jnp.float32)
    with torch.no_grad():
        got = cell(_t(x), _t(h), torch.bfloat16)
    assert got.dtype == torch.float32
    _close(got, ref, GRU_ATOL)
    # the output is a bf16 value widened to f32
    assert torch.equal(got, got.bfloat16().float())


def test_linear_rounds_its_weights_each_call():
    """mlp.linear with bf16: the weights rounded to bf16 on every call,
    held in the input's type (JAX's cast_tree and type promotion); the
    parameters stay f32 and a new value is read at once."""
    layer = torch.nn.Linear(4, 3)
    x = torch.linspace(-1, 1, 8).reshape(2, 4)
    with torch.no_grad():
        layer.weight.copy_(torch.ones(3, 4) / 3)
        got = mlp.linear(layer, x, torch.bfloat16)
        w, b = layer.weight.bfloat16().float(), layer.bias.bfloat16().float()
        assert got.dtype == torch.float32
        assert torch.equal(got, torch.nn.functional.linear(x, w, b))
        assert not torch.equal(got, layer(x))
        assert mlp.linear(layer, x.bfloat16(), torch.bfloat16).dtype == (
            torch.bfloat16)
        layer.weight.copy_(torch.ones(3, 4) / 7)
        again = mlp.linear(layer, x, torch.bfloat16)
    assert layer.weight.dtype == torch.float32
    assert torch.equal(again, torch.nn.functional.linear(
        x, layer.weight.bfloat16().float(), b))
    # under autograd the cast carries the gradient to the f32 master
    mlp.linear(layer, x, torch.bfloat16).sum().backward()
    assert layer.weight.grad is not None


def test_modules_bf16_match_jax(windowed):
    jb, tb = _batches(5)
    h = 32
    pcfg = JPR.NeuralPropagatorConfig(
        edge_dim=1, decimator_dim=h, meta_dim=0, hidden_dim=h,
        mem_hidden_dim=24, mem_agg_hidden_dim=16, agg_hidden_dim=24,
        dropout=0.0, compute_dtype=BF16)
    dcfg = JD.NeuralDecimatorConfig(
        var_message_dim=h, fn_message_dim=h, meta_dim=0, hidden_dim=h,
        edge_dim=1, dropout=0.0, compute_dtype=BF16)
    rcfg = JP.NeuralPredictorConfig(
        decimator_dim=h, prediction_dim=1, edge_dim=1, meta_dim=0,
        mem_hidden_dim=24, agg_hidden_dim=24, mem_agg_hidden_dim=16,
        classifier_dim=16, compute_dtype=BF16)
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
    assert prop.cfg.compute_dtype == dec.cfg.compute_dtype == BF16

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
            assert g.dtype == torch.float32
            _close(g, r, STATE_ATOL)
        frozen = ae == 0
        np.testing.assert_array_equal(got[0].numpy()[frozen],
                                      states[0][frozen])

        # the decimator from the same messages (JAX's own output)
        msgs = tuple(_t(r) for r in ref)
        ref_d = JD.neural_decimator_apply(jp_dec, dcfg, jb, (j[2], j[3]),
                                          ref, jnp.asarray(ae))
        got_d = dec(tb, (t[2], t[3]), msgs, _t(ae))
        for r, g in zip(ref_d, got_d):
            _close(g, r, STATE_ATOL)
        np.testing.assert_array_equal(got_d[1].numpy()[frozen],
                                      states[3][frozen])

        ref_p, _ = JP.neural_predictor_apply(jp_pred, rcfg, jb,
                                             (j[2], j[3]), jnp.asarray(em))
        got_p, _ = pred(tb, (t[2], t[3]), _t(em))
        assert got_p.dtype == torch.float32
        _close(got_p, ref_p, PRED_ATOL)


SMALL = dict(model_type="np-nd-np", hidden_dim=32, mem_hidden_dim=24,
             agg_hidden_dim=24, mem_agg_hidden_dim=16, classifier_dim=16)


def _forward(jsolver, jparams, tsolver, tparams, insts, iters, seed):
    """A forward with check_termination from one injected state (JAX's
    init state) in each package, unfinalized; returns the batches, the
    states and the carries."""
    jb, tb = jax_pack(insts), pack_instances(insts, device="cpu")
    jstate0 = jsolver.get_init_state(jax.random.PRNGKey(seed), jb,
                                     randomized=True)
    tstate0 = convert.state_from_jax(_np(jstate0), "cpu")
    _, jstate, jcarry = jsolver.forward(
        jparams, jax.random.PRNGKey(seed + 1), jb, jstate0, iters,
        is_training=False, check_termination=True, finalize=False)
    _, tstate, tcarry = tsolver.forward(
        tparams, torch.Generator().manual_seed(0), tb, tstate0, iters,
        check_termination=True, finalize=False)
    return jb, tb, jstate, tstate, jcarry, tcarry


def _check_forward(jb, tb, jstate, tstate, jcarry, tcarry):
    """Flags equal; predictions and the neural states within the
    forward tolerances."""
    np.testing.assert_array_equal(tcarry[1].numpy(), np.asarray(jcarry[1]))
    jpred = np.asarray(jcarry[0].solution)
    tpred = tcarry[0].solution.numpy()
    _close(tpred, jpred, FORWARD_PRED_ATOL)
    jsolved, _ = jax_cnf_evaluate(jb, jnp.asarray(jpred)[:, None])
    tsolved, _ = cnf_evaluate(tb, tcarry[0].solution[:, None])
    np.testing.assert_array_equal(tsolved.numpy(), np.asarray(jsolved))
    real = np.asarray(jb.edge_mask) > 0
    pairs = [(jstate.dec, tstate.dec)]
    if isinstance(tstate.prop, tuple):
        pairs.append((jstate.prop, tstate.prop))
    for jpair, tpair in pairs:
        for r, g in zip(jpair, tpair):
            assert g.dtype == torch.float32
            d = np.abs(g.numpy()[real] - np.asarray(r)[real])
            got = dict(mean=d.mean(), p999=np.quantile(d, 0.999),
                       max=d.max())
            assert all(got[k] <= v for k, v in FORWARD_STATE.items()), got


def test_np_nd_np_forward_bf16_matches_jax(windowed):
    """8 iterations at small widths with random parameters."""
    jsolver = JaxSolver(JaxConfig(compute_dtype=BF16, **SMALL))
    jparams = jsolver.init_params(jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(_np(jparams), "cpu")
    tsolver = PDPSolver(SolverConfig(compute_dtype=BF16, **SMALL))
    _check_forward(*_forward(jsolver, jparams, tsolver, tparams,
                             _instances(11), 8, 3))


@pytest.fixture(scope="module")
def checkpoints():
    """(JAX solver, JAX params, port solver, port params) in bf16 for the
    r3 np-nd-np, r4 p-nd-np and r4 np-d-np checkpoints and the flagship's
    np-nd-np-full at full width, each package reading the file with its
    own loader."""
    def load(name, path, **kw):
        cfg = JaxConfig(name=name, compute_dtype=BF16, **kw)
        jsolver = JaxSolver(cfg)
        template = {"params": jsolver.init_params(jax.random.PRNGKey(0)),
                    "global_step": jnp.zeros((), jnp.float32)}
        jparams = jckpt.load_params(os.path.dirname(path), template,
                                    name)["params"]
        tparams = convert.params_from_jax(
            convert.load_jax_checkpoint(path)["params"], "cpu")
        return (jsolver, jparams,
                PDPSolver(SolverConfig(compute_dtype=BF16, **kw)), tparams)

    widths = dict(hidden_dim=150, mem_hidden_dim=100, agg_hidden_dim=100,
                  mem_agg_hidden_dim=50, classifier_dim=50)
    return {
        "np-nd-np": load("np-nd-np-r3", neural.CHECKPOINT,
                         model_type="np-nd-np", **widths),
        "p-nd-np": load("p-nd-np-r4", neural.P_ND_NP_CHECKPOINT,
                        model_type="p-nd-np",
                        **dict(widths, mem_hidden_dim=50, agg_hidden_dim=50)),
        "np-d-np": load("np-d-np-r4", neural.NP_D_NP_CHECKPOINT,
                        model_type="np-d-np", tolerance=0.02, t_max=10,
                        **widths),
        "np-nd-np-full": load("np-nd-np-full", FLAGSHIP_CHECKPOINT,
                              model_type="np-nd-np", **widths),
    }


@pytest.mark.parametrize("model,iters,k,alpha", [
    ("np-nd-np", 6, 4, 6.0), ("p-nd-np", 5, 4, 4.5), ("np-d-np", 12, 3, 3.5),
    ("np-nd-np-full", 6, 4, 6.0)])
def test_checkpoint_forward_bf16_matches_jax(windowed, checkpoints, model,
                                             iters, k, alpha):
    """A short forward with the trained weights at full width from one
    injected state: np-d-np's decimator takes the argmax of |score|, whose
    near ties bf16 makes common, so its horizon is short (12 iterations,
    its first fixes); longer runs are held on solved counts (chip_smoke.py).
    np-nd-np-full is the flagship config's checkpoint (phase 18 of
    chip_smoke.py solves none of the shared set in its 100 iterations, so
    its forward is held here)."""
    jsolver, jparams, tsolver, tparams = checkpoints[model]
    insts = _instances(12, ns=(24, 20, 26, 22), alpha=alpha, k=k)
    out = _forward(jsolver, jparams, tsolver, tparams, insts, iters, 4)
    _check_forward(*out)
    if model == "np-d-np":
        # the window covers decimation: the same variables were fixed
        tb, jcarry, tcarry = out[1], out[4], out[5]
        np.testing.assert_array_equal(tcarry[0].active_vars.numpy(),
                                      np.asarray(jcarry[0].active_vars))
        assert float(tcarry[0].active_vars.sum()) < float(
            tb.var_mask.sum())


def test_solver_config_takes_compute_dtype():
    base = dict(model_type="np-nd-np", hidden_dim=8, mem_hidden_dim=8,
                agg_hidden_dim=8, mem_agg_hidden_dim=8, classifier_dim=8)
    assert SolverConfig(**base).compute_dtype == JaxConfig(
        **base).compute_dtype == "float32"
    s = build_solver(dict(base, compute_dtype=BF16))
    assert s.cfg.compute_dtype == BF16
    assert s.prop_cfg.compute_dtype == s.dec_cfg.compute_dtype == BF16
    assert s.pred_cfg.compute_dtype == BF16
    assert build_solver(base).cfg.compute_dtype == "float32"
    d = build_solver(dict(base, model_type="np-d-np", compute_dtype=BF16))
    assert d.prop_cfg.compute_dtype == d.scorer_cfg.compute_dtype == BF16
    p = build_solver(dict(base, model_type="p-nd-np", compute_dtype=BF16))
    assert p.dec_cfg.compute_dtype == p.pred_cfg.compute_dtype == BF16
    for bad in ("float16", "bf16", "tf32"):
        with pytest.raises(ValueError):
            build_solver(dict(base, compute_dtype=bad))
        with pytest.raises(ValueError):
            PDPSolver(SolverConfig(compute_dtype=bad, **base))
    # the parameters carry no precision: the same modules serve both
    # solvers, each in its own compute_dtype
    f32 = build_solver(base)
    params = f32.init_params("cpu")
    tb = pack_instances(_instances(13, ns=(12, 10)), device="cpu")
    state = f32.get_init_state(torch.Generator().manual_seed(0), tb, True)
    pred = [sv.forward(params, torch.Generator().manual_seed(1), tb, state,
                       2, check_termination=True, finalize=False)[2][0]
            .solution for sv in (f32, s)]
    assert not torch.equal(pred[0], pred[1])
    assert float((pred[0] - pred[1]).abs().max()) < FORWARD_PRED_ATOL


def test_flagship_dict_equals_the_yaml():
    path = neural.FLAGSHIP_YAML
    loaded = config.load_yaml_config(path)
    assert loaded == neural.FLAGSHIP
    assert loaded == jconfig.load_yaml_config(path)
    s = neural.flagship_solver(loaded)
    c = s.cfg
    assert (c.model_type, c.compute_dtype, c.hidden_dim,
            c.local_search_iterations, c.epsilon) == (
        "np-nd-np", BF16, 150, 100, 0.5)
    assert neural.flagship_settings()["iterations"] == 100


def test_config_helpers_match_jax():
    for yaml_cfg in (neural.FLAGSHIP,
                     dict(neural.FLAGSHIP, model_type="walk-sat"),
                     dict(neural.FLAGSHIP, model_type="p-d-p")):
        args = {"test_recurrence_num": 30, "epsilon": 0.4}
        merged = config.merge_config(yaml_cfg, args)
        assert merged == jconfig.merge_config(yaml_cfg, args)
        assert (config.apply_classical_overrides(merged)
                == jconfig.apply_classical_overrides(merged))
        assert config.validate(merged) is merged
    with pytest.raises(ValueError):
        config.validate({"model_type": "np-np"})


def test_flagship_checkpoint_loads():
    """np-nd-np-full.npz has the r3 file's keys and shapes and loads
    through params_from_jax; the parameters stay the file's f32 values."""
    tree = convert.load_jax_checkpoint(FLAGSHIP_CHECKPOINT)
    r3 = convert.load_jax_checkpoint(neural.CHECKPOINT)
    shapes = {k: v.shape for k, v in convert._flatten(tree["params"])}
    assert shapes == {k: v.shape for k, v in convert._flatten(r3["params"])}
    params = neural.flagship_params("cpu")
    assert all(p.dtype == torch.float32 for p in params.parameters())
    w = tree["params"]["dec"]["var_gru"]["w_ih"]
    np.testing.assert_array_equal(
        params["dec"].var_gru.weight_ih.detach().numpy(), w.T)
    neural.flagship_solver()._check_params(params)


@pytest.fixture(scope="module")
def bf16_check(checkpoints):
    """neural.BF16_CHECK from one numpy state in both packages, in f32 and
    in bf16: {(package, dtype): [(predictions, active flags) after each
    of neural.BF16_CHECK_HORIZONS]}."""
    jsolver, jparams, _, _ = checkpoints["np-nd-np"]
    insts = make_ksat_set(**neural.BF16_CHECK)
    jb, tb = jax_pack(insts), pack_instances(insts, device="cpu")
    state = neural.np_nd_np_state(tb.num_edges)
    jstate = JaxState(prop=(jnp.asarray(state[0]), jnp.asarray(state[1])),
                      dec=(jnp.asarray(state[2]), jnp.asarray(state[3])),
                      aux=())
    tparams = neural.np_nd_np_params("cpu")
    out = {"real": np.asarray(jb.var_mask) > 0}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PDP_SEGMENT_BACKEND", "windowed")
        mp.setenv("PDP_COMPILE_CACHE", "off")
        for dt in ("float32", BF16):
            js = JaxSolver(dataclasses.replace(jsolver.cfg, compute_dtype=dt))
            st, carry, done, runs = jstate, None, 0, []
            for h in neural.BF16_CHECK_HORIZONS:
                _, st, carry = js.forward(
                    jparams, jax.random.PRNGKey(1), jb, st, h - done,
                    is_training=False, check_termination=True, carry=carry,
                    finalize=False)
                done = h
                runs.append((np.asarray(carry[0].solution),
                             np.asarray(carry[1])[:len(insts)]))
            out[("jax", dt)] = runs
            out[("port", dt)] = [
                (p.numpy(), a.numpy()) for p, a in neural.bf16_check_forward(
                    tparams, tb, state, dt)]
    return out


def _drift(runs, real, a, b):
    """max |prediction difference| of runs a and b at each horizon."""
    return [float(np.abs(x[0] - y[0])[real].max())
            for x, y in zip(runs[a], runs[b])]


def test_bf16_drift_within_ratio_of_jax(bf16_check):
    """The port's f32-against-bf16 distance is at most BF16_DRIFT_RATIO
    times JAX's own from the same state, at each horizon."""
    real = bf16_check["real"]
    jax_d = _drift(bf16_check, real, ("jax", "float32"), ("jax", BF16))
    port_d = _drift(bf16_check, real, ("port", "float32"), ("port", BF16))
    for h, j, p in zip(neural.BF16_CHECK_HORIZONS, jax_d, port_d):
        assert 0 < p <= neural.BF16_DRIFT_RATIO * j, (h, p, j)


def test_bf16_check_figures_are_jax_own(bf16_check):
    """chip_smoke.py gates the card's distance with
    neural.BF16_CHECK_JAX_DRIFT: JAX's distance on this state."""
    jax_d = _drift(bf16_check, bf16_check["real"], ("jax", "float32"),
                   ("jax", BF16))
    for h, j in zip(neural.BF16_CHECK_HORIZONS, jax_d):
        assert abs(neural.BF16_CHECK_JAX_DRIFT[h] - j) <= 5e-4, (h, j)


def test_bf16_check_flags_match_jax(bf16_check):
    """The active flags of the bf16 forwards equal JAX's at each horizon
    (and f32's), with instances solved by the last: the card-against-CPU
    comparison of chip_smoke.py holds flags on these instances."""
    for i, _ in enumerate(neural.BF16_CHECK_HORIZONS):
        flags = {k: v[i][1] for k, v in bf16_check.items() if k != "real"}
        ref = flags[("jax", BF16)]
        for k, v in flags.items():
            np.testing.assert_array_equal(v, ref, err_msg=str(k))
    assert 0 < int((flags[("jax", BF16)] == 0).sum()) < len(ref)


def test_bf16_module_drift_matches_jax(windowed, checkpoints):
    """Where the f32-against-bf16 distance comes from, module by module,
    at the r3 weights on neural.BF16_CHECK's instances from its numpy
    state: each module in f32 and in bf16 from the same f32 input, in each
    package; the port's mean |difference| at most 1.25 times JAX's for
    the propagator's two states, the decimator's two and the predictor's
    aggregator (so the port rounds no more than JAX in any of them; the
    classifier, f32 in both, only spreads what reaches it)."""
    jsolver, jparams, _, _ = checkpoints["np-nd-np"]
    insts = make_ksat_set(**neural.BF16_CHECK)
    jb, tb = jax_pack(insts), pack_instances(insts, device="cpu")
    state = neural.np_nd_np_state(tb.num_edges)
    j = [jnp.asarray(a) for a in state]
    t = [torch.from_numpy(a) for a in state]
    tp = neural.np_nd_np_params("cpu")
    em, ae = jb.edge_mask, jnp.ones_like(jb.edge_mask)
    real = np.asarray(jb.edge_mask) > 0
    cfgs = {dt: JaxSolver(dataclasses.replace(jsolver.cfg, compute_dtype=dt))
            for dt in ("float32", BF16)}
    prop, dec, agg = {}, {}, {}
    for dt, js in cfgs.items():
        prop["jax", dt] = JPR.neural_propagator_apply(
            jparams["prop"], js.prop_cfg, jax.random.PRNGKey(0), jb,
            (j[0], j[1]), (j[2], j[3]), em, ae, False)
        dec["jax", dt] = JD.neural_decimator_apply(
            jparams["dec"], js.dec_cfg, jb, (j[2], j[3]), (j[0], j[1]), ae)
        pcfg = js.pred_cfg
        agg_in = jnp.concatenate([j[2], jb.edge_sign[:, None]], axis=1)
        agg["jax", dt] = jmlp.aggregator_apply(
            jparams["predictor"]["var_agg"], pcfg.aggregator_cfg(), jb,
            agg_in, None, "var", em,
            dtype=jnp.bfloat16 if dt == BF16 else None)
        with torch.no_grad():
            prop["port", dt] = tp["prop"](tb, (t[0], t[1]), (t[2], t[3]),
                                          _t(em), _t(ae), dt)
            dec["port", dt] = tp["dec"](tb, (t[2], t[3]), (t[0], t[1]),
                                        _t(ae), dt)
            agg["port", dt] = tp["predictor"].var_agg(
                tb, torch.cat([t[2], _t(jb.edge_sign)[:, None]], dim=1),
                None, "var", _t(em), mlp.COMPUTE_DTYPES[dt])

    def mean_drift(out, pkg, i, mask):
        a, b = out[pkg, "float32"], out[pkg, BF16]
        if i is not None:
            a, b = a[i], b[i]
        return float(np.abs(np.asarray(a, np.float32)
                            - np.asarray(b, np.float32))[mask].mean())
    vm = np.asarray(jb.var_mask) > 0
    for name, out, i, mask in (("prop var", prop, 0, real),
                               ("prop fn", prop, 1, real),
                               ("dec var", dec, 0, real),
                               ("dec fn", dec, 1, real),
                               ("predictor aggregator", agg, None, vm)):
        jd = mean_drift(out, "jax", i, mask)
        pd = mean_drift(out, "port", i, mask)
        assert 0 < pd <= 1.25 * jd, (name, pd, jd)
