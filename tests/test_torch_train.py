"""Training np-nd-np: the port against the JAX package on the CPU.

The same numpy-seeded instances go through both packages; parameters are
made by the JAX trainer and handed over with convert.load_into (and back
with params_to_jax). With PDP_SEGMENT_BACKEND=windowed the JAX batch takes
kernels 4, 6 and 7 in Pallas interpret mode, with their custom VJPs, so
those rules are what the port's autograd Functions are compared with.
Both sides draw nothing: randomized=False (zero init states) and dropout
0. JAX's value_and_grad of its loss is compiled once for the module
(one mixed-width shape, T = 2) and shared by every test that needs it.

Tolerances: the energy loss and its gradient wrt the prediction to rtol
1e-5 / atol 1e-7; the BPTT loss to rtol 1e-5 and each parameter's
gradient to ||g_port - g_jax|| <= 1e-5 ||g_jax|| + 1e-12 (the same f32
math, the sums and matrix products in another order: measured ~2e-7; a
few gradients are exactly 0 on both sides from zero states); parameters
after three optax-order steps to atol 1e-6 (three updates of lr 1e-3,
each exact to f32 rounding of Adam's normalised step); checkpoints
exactly.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pdp_solver_tpu.fg.batch import pack_instances as jax_pack
from pdp_solver_tpu.fg.generators import UniformCNFGenerator as JaxUniform
from pdp_solver_tpu.train import checkpoint as jckpt
from pdp_solver_tpu.train import loss as jloss
from pdp_solver_tpu.train.trainer import SatTrainer as JaxTrainer
from pdp_solver_tpu.utils import config as jconfig

from pdp_solver_tpu_torch import convert
from pdp_solver_tpu_torch.fg.batch import pack_instances
from pdp_solver_tpu_torch.fg.generators import UniformCNFGenerator
from pdp_solver_tpu_torch.fg.jsonfmt import instance_to_line
from pdp_solver_tpu_torch.modules.common import dropout
from pdp_solver_tpu_torch.train import checkpoint as ckpt
from pdp_solver_tpu_torch.train import loss
from pdp_solver_tpu_torch.train.trainer import (
    SatTrainer, clip_by_global_norm)
from pdp_solver_tpu_torch.utils import config, training

CFG = dict(model_type="np-nd-np", model_name="tt", hidden_dim=12,
           mem_hidden_dim=10, agg_hidden_dim=10, mem_agg_hidden_dim=8,
           classifier_dim=8, prediction_dim=1, dropout=0.0,
           train_outer_recurrence_num=2, train_inner_recurrence_num=1,
           learning_rate=1e-3, weight_decay=1e-4, clip_norm=0.65,
           exploration=0.1, loss_sharpness=5, randomized=False,
           batch_size=4, train_batch_limit=10 ** 6,
           test_batch_limit=10 ** 6, test_recurrence_num=5,
           local_search_iteration=0, epsilon=0.5, **{"lambda": 0.8})
STEP = 4.0   # global_step of the comparisons (coeff = 4^0.1)
PAD = (64, 256, 1024, 8)


def _instances(seed, count=5, k=(2, 5)):
    g = JaxUniform(6, 12, k[0], k[1], 2.0, 4.0, seed=seed)
    return [g.generate() for _ in range(count)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return jax.tree_util.tree_leaves(_np(tree))


def _port_trainer(cfg=CFG, params=None):
    tr = SatTrainer(cfg, device="cpu")
    if params is not None:
        convert.load_into(tr.params, _np(params))
    return tr


@pytest.fixture(scope="module")
def jax_side():
    """The JAX trainer, three mixed-width batches of one padded shape, and
    its value_and_grad and optax update, compiled once."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PDP_SEGMENT_BACKEND", "windowed")
    mp.setenv("PDP_COMPILE_CACHE", "off")
    # remat changes no value: off on this side only, for a shorter compile
    jt = JaxTrainer(dict(CFG, train_remat=False), seed=0)
    jt._make_optimizer()
    insts = [_instances(s) for s in (5, 6, 7)]
    jbs = [jax_pack(i, pad_v=PAD[0], pad_f=PAD[1], pad_e=PAD[2],
                    pad_b=PAD[3]) for i in insts]
    # one padded shape on JAX's windowed route for all three
    assert all(b.fast_var and b.fast_clause and b.clause_width == 0
               for b in jbs)
    vag = jax.jit(jax.value_and_grad(jt._loss_fn()))

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = jt._optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    yield dict(trainer=jt, insts=insts, jbs=jbs, vag=vag, update=update)
    mp.undo()


def _jax_step(js, params, opt_state, i):
    loss_v, grads = js["vag"](params, jax.random.PRNGKey(0), js["jbs"][i],
                              jnp.float32(STEP))
    params, opt_state = js["update"](grads, opt_state, params)
    return params, opt_state, loss_v


def _port_batch(js, i):
    return pack_instances(js["insts"][i], device="cpu", pad_v=PAD[0],
                          pad_f=PAD[1], pad_e=PAD[2], pad_b=PAD[3])


def _port_step(tr, ts, batch):
    ts = ts._replace(global_step=torch.tensor(STEP))
    return tr.train_step(ts, batch)


# ---------------------------------------------------------------- the loss

@pytest.mark.parametrize("widths", ["uniform", "mixed"])
def test_energy_loss_and_its_gradient_match_jax(monkeypatch, widths):
    monkeypatch.setenv("PDP_SEGMENT_BACKEND", "windowed")
    insts = _instances(3, k=(3, 3) if widths == "uniform" else (2, 5))
    jb, tb = jax_pack(insts), pack_instances(insts, device="cpu")
    assert (jb.clause_width == 3) == (widths == "uniform")
    # the JAX loss takes kernel 4 (windowed, with its VJP) on mixed
    # widths, the reshape on uniform ones
    assert jb.fast_clause and jb.fast_var
    pred = np.random.default_rng(4).uniform(
        0.02, 0.98, (jb.num_vars, 1)).astype(np.float32)
    for step in (0.0, 7.0):
        ref, ref_g = jax.value_and_grad(
            lambda p: jloss.energy_loss(jb, p, jnp.float32(step), 0.1, 5))(
            jnp.asarray(pred))
        p = torch.tensor(pred, requires_grad=True)
        got = loss.energy_loss(tb, p, torch.tensor(step), 0.1, 5)
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(ref),
                                   rtol=1e-5)
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_g),
                                   rtol=1e-5, atol=1e-7)


def test_loss_and_gradients_match_jax(jax_side):
    js = jax_side
    jb = js["jbs"][0]
    assert jb.clause_width == 0 and jb.fast_var and jb.fast_clause
    ref, ref_g = js["vag"](js["trainer"].params, jax.random.PRNGKey(0), jb,
                           jnp.float32(STEP))
    tr = _port_trainer(params=js["trainer"].params)
    got = tr.loss(tr.params, _port_batch(js, 0), torch.tensor(STEP))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    flat = jax.tree_util.tree_flatten_with_path(_np(ref_g))[0]
    mine = jax.tree_util.tree_leaves(convert.grads_to_jax(tr.params))
    assert len(flat) == len(mine) == 29
    for (path, a), b in zip(flat, mine):
        # (from zero states a few gradients are exactly 0 on both sides)
        err = np.linalg.norm(b - a)
        assert err <= 1e-5 * np.linalg.norm(a) + 1e-12, (
            jax.tree_util.keystr(path), err, np.linalg.norm(a))


def test_three_optax_steps_match_jax(jax_side):
    js = jax_side
    jt = js["trainer"]
    params, opt_state = jt.params, jt._optimizer.init(jt.params)
    tr = _port_trainer(params=params)
    ts = tr.init_train_state()
    for i in range(3):
        params, opt_state, ref = _jax_step(js, params, opt_state, i)
        ts, got = _port_step(tr, ts, _port_batch(js, i))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    for a, b in zip(_leaves(params),
                    jax.tree_util.tree_leaves(convert.params_to_jax(
                        ts.params))):
        np.testing.assert_allclose(b, a, atol=1e-6)
    adam = convert.adam_to_jax(ts.opt, ts.params)
    assert int(adam["count"]) == int(opt_state[2].count) == 3
    for a, b in zip(_leaves(opt_state[2].mu),
                    jax.tree_util.tree_leaves(adam["mu"])):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-9)


def test_clip_is_optax_rule():
    rng = np.random.default_rng(9)
    gs = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,))]
    for max_norm in (0.5, 100.0):
        ref = optax.clip_by_global_norm(max_norm).update(gs, None)[0]
        got = [torch.tensor(g) for g in gs]
        clip_by_global_norm(got, max_norm)
        for a, b in zip(ref, got):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    unchanged = [torch.tensor(g) for g in gs]
    clip_by_global_norm(unchanged, 100.0)
    assert all(np.array_equal(a.numpy(), g) for a, g in zip(unchanged, gs))


# ---------------------------------------------------------------- remat

def test_remat_and_dropout_masks_agree():
    """train_remat recomputes each outer step in the backward pass; its
    dropout masks come from a seed drawn outside the checkpoint, so the
    gradients equal those of the run without remat."""
    cfg = dict(CFG, dropout=0.3, randomized=True)
    batch = pack_instances(_instances(8), device="cpu")
    grads = []
    for remat in (True, False):
        tr = SatTrainer(dict(cfg, train_remat=remat), device="cpu")
        tr.params.train()
        tr.loss(tr.params, batch, torch.tensor(STEP)).backward()
        grads.append(jax.tree_util.tree_leaves(
            convert.grads_to_jax(tr.params)))
    for a, b in zip(*grads):
        np.testing.assert_array_equal(a, b)
    # and dropout acts: without it the gradients differ
    tr = SatTrainer(dict(cfg, dropout=0.0), device="cpu")
    tr.params.train()
    tr.loss(tr.params, batch, torch.tensor(STEP)).backward()
    plain = jax.tree_util.tree_leaves(convert.grads_to_jax(tr.params))
    assert any(not np.array_equal(a, b) for a, b in zip(grads[0], plain))


def test_dropout_scaling_and_keep_share():
    g = torch.Generator()
    g.manual_seed(3)
    x = torch.rand((400, 50), generator=g) + 0.5
    y = dropout(g, x, 0.2, True)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.8) < 0.01
    torch.testing.assert_close(y[kept], x[kept] / 0.8)
    assert dropout(g, x, 0.2, False) is x and dropout(g, x, 0.0, True) is x
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(5)
    g2.manual_seed(5)
    assert torch.equal(dropout(g1, x, 0.5, True), dropout(g2, x, 0.5, True))


def test_propagator_dropout_needs_a_generator():
    tr = SatTrainer(dict(CFG, dropout=0.2), device="cpu")
    tr.params.train()
    batch = pack_instances(_instances(8), device="cpu")
    state = tr.solver.get_init_state(tr._gen, batch, True)
    with pytest.raises(ValueError, match="generator"):
        tr.solver.forward(tr.params, None, batch, state, 1, is_training=True)


# ---------------------------------------------------------------- ckpt

def test_jax_checkpoint_loads_into_the_port_and_steps_alike(jax_side,
                                                            tmp_path):
    js = jax_side
    jt = js["trainer"]
    params, opt_state, _ = _jax_step(js, jt.params, jt._optimizer.init(
        jt.params), 0)
    jstate = jt.init_train_state()._replace(
        params=params, opt_state=opt_state, global_step=jnp.float32(3.0))
    jt._save_train_state(jstate, str(tmp_path))
    tr = _port_trainer()
    ts = tr._load_train_state(tr.init_train_state(), str(tmp_path))
    assert float(ts.global_step) == 3.0
    for a, b in zip(_leaves(params), jax.tree_util.tree_leaves(
            convert.params_to_jax(ts.params))):
        np.testing.assert_array_equal(a, b)
    adam = convert.adam_to_jax(ts.opt, ts.params)
    assert int(adam["count"]) == 1
    for k in ("mu", "nu"):
        for a, b in zip(_leaves(getattr(opt_state[2], k)),
                        jax.tree_util.tree_leaves(adam[k])):
            np.testing.assert_array_equal(a, b)
    params, opt_state, _ = _jax_step(js, params, opt_state, 1)
    ts, _ = _port_step(tr, ts, _port_batch(js, 1))
    for a, b in zip(_leaves(params), jax.tree_util.tree_leaves(
            convert.params_to_jax(ts.params))):
        np.testing.assert_allclose(b, a, atol=1e-6)


def test_port_checkpoint_loads_in_jax(jax_side, tmp_path):
    js = jax_side
    tr = _port_trainer(params=js["trainer"].params)
    ts = tr.init_train_state()
    for i in range(2):
        ts, _ = _port_step(tr, ts, _port_batch(js, i))
    ts = ts._replace(global_step=torch.tensor(6.0))
    tr._save_train_state(ts, str(tmp_path / "last"))
    jt = JaxTrainer(CFG, seed=1)
    jt._make_optimizer()
    jstate = jt._load_train_state(jt.init_train_state(),
                                  str(tmp_path / "last"))
    assert float(jstate.global_step) == 6.0
    assert int(jstate.opt_state[2].count) == 2
    for a, b in zip(_leaves(jstate.params), jax.tree_util.tree_leaves(
            convert.params_to_jax(ts.params))):
        np.testing.assert_array_equal(a, b)
    adam = convert.adam_to_jax(ts.opt, ts.params)
    for k in ("mu", "nu"):
        for a, b in zip(_leaves(getattr(jstate.opt_state[2], k)),
                        jax.tree_util.tree_leaves(adam[k])):
            np.testing.assert_array_equal(a, b)
    # the keys, letter for letter, and the JAX package's own reader
    keys = ckpt.checkpoint_keys(str(tmp_path / "last"), "tt")
    assert keys == jckpt.checkpoint_keys(str(tmp_path / "last"), "tt")
    assert "['opt'][2].mu['prop']['var_agg']['w1_m']['w']" in keys
    assert "['params']['dec']['fn_gru']['w_ih']" in keys


def test_r3_params_only_checkpoint_loads_with_a_fresh_adam():
    cfg = dict(training.FLAGSHIP_RECIPE)
    tr = SatTrainer(cfg, device="cpu")
    path = os.path.join(training.ROOT, "trained-models", "np-nd-np-r3",
                        "best")
    keys = ckpt.checkpoint_keys(path, "np-nd-np-r3")
    assert not any(k.startswith("['opt']") for k in keys)
    ts = tr._load_train_state(tr.init_train_state(), path)
    assert not ts.opt.state
    ref = convert.load_jax_checkpoint(os.path.join(path, "np-nd-np-r3.npz"))
    for a, b in zip(jax.tree_util.tree_leaves(ref["params"]),
                    jax.tree_util.tree_leaves(
                        convert.params_to_jax(ts.params))):
        np.testing.assert_array_equal(a, b)
    assert float(ts.global_step) == float(ref["global_step"])


def test_checkpoint_round_trip_of_nested_state(tmp_path):
    tree = {"params": {"b": np.arange(3, dtype=np.float32),
                       "a": {"w": np.ones((2, 2), np.float32)}},
            "opt": ckpt.opt_state({"count": np.int32(4),
                                   "mu": {"x": np.zeros(2, np.float32)},
                                   "nu": {"x": np.ones(2, np.float32)}}),
            "global_step": np.float32(2.0)}
    ckpt.save_params(str(tmp_path), tree, "m")
    assert ckpt.checkpoint_keys(str(tmp_path), "m") == [
        "['global_step']", "['opt'][2].count", "['opt'][2].mu['x']",
        "['opt'][2].nu['x']", "['params']['a']['w']", "['params']['b']"]
    back = ckpt.load_params(str(tmp_path), tree, "m")
    assert int(back["opt"][2].count) == 4
    np.testing.assert_array_equal(back["params"]["b"], tree["params"]["b"])
    with pytest.raises(KeyError):
        ckpt.load_params(str(tmp_path), {"nope": np.zeros(1)}, "m")


# ---------------------------------------------------------------- loop

def _write_dataset(path, insts):
    with open(path, "w") as f:
        for i in insts:
            f.write(instance_to_line(*i[:5]) + "\n")


def test_train_loop_writes_checkpoints_and_advances_per_macro_batch(
        tmp_path):
    cfg = dict(CFG, dropout=0.2, randomized=True, epoch_num=2,
               batch_size=6, train_batch_limit=2000)
    val = tmp_path / "val.json"
    _write_dataset(val, _instances(11, count=4))
    tr = SatTrainer(cfg, device="cpu")
    gen = UniformCNFGenerator(5, 10, 2, 4, 2.0, 3.5, seed=2)
    ts, errors, losses = tr.train(
        None, [str(val)], last_export_path=str(tmp_path / "last"),
        best_export_path=str(tmp_path / "best"), generator=gen,
        train_epoch_size=12)
    # 2 epochs of 2 macro-batches of 6 instances
    assert float(ts.global_step) == 4.0
    assert np.isfinite(losses).all() and errors.shape == (3, 2, 1)
    for d in ("last", "best"):
        assert os.path.exists(tmp_path / d / "tt.npz")
    assert np.load(tmp_path / "best" / "losses.npy").shape == (2, 1)
    assert int(convert.adam_to_jax(ts.opt, ts.params)["count"]) >= 4


def test_train_from_file_restores_last(tmp_path):
    cfg = dict(CFG, epoch_num=1, batch_size=4)
    data = tmp_path / "train.json"
    _write_dataset(data, _instances(12, count=6))
    tr = SatTrainer(cfg, device="cpu")
    last = str(tmp_path / "last")
    ts, _, _ = tr.train([str(data)], [str(data)], last_export_path=last)
    count = int(convert.adam_to_jax(ts.opt, ts.params)["count"])
    tr2 = SatTrainer(cfg, device="cpu", seed=9)
    ts2, _, _ = tr2.train([str(data)], [str(data)], last_export_path=last,
                          load_model="last", reset_step=True)
    assert int(convert.adam_to_jax(ts2.opt, ts2.params)["count"]) > count


# ---------------------------------------------------------------- config

def test_train_config_reaches_the_trainer():
    loaded = config.load_yaml_config(training.NP_ND_NP_4SAT_YAML)
    assert loaded == training.NP_ND_NP_4SAT
    assert loaded == jconfig.load_yaml_config(training.NP_ND_NP_4SAT_YAML)
    merged = config.merge_config(loaded, {"epoch_num": 1})
    tr = SatTrainer(merged, device="cpu")
    assert tr._config == merged
    assert tr.solver.cfg.dropout == 0.2 and tr.solver.cfg.hidden_dim == 150
    opt = tr.init_train_state().opt
    assert opt.defaults["lr"] == 1e-4 and opt.defaults["weight_decay"] == 1e-10
    assert tr._clip_norm == 0.65


def test_flagship_recipe_is_the_jax_run():
    path = os.path.join(training.ROOT, "tools", "train_flagship.py")
    with open(path) as f:
        src = f.read()
    assert '"TRAIN_DIMS", "8192,32768,131072,128"' in src
    start = src.index("CFG = dict(")
    ns = {}
    exec(compile(src[start:src.index("\n\n", start)], path, "exec"), ns)
    assert ns["CFG"] == training.FLAGSHIP_RECIPE
    assert training.FIXED_DIMS == (8192, 32768, 131072, 128)


def test_unported_parts_raise():
    with pytest.raises(NotImplementedError, match="item 9"):
        SatTrainer(dict(CFG, data_parallel=2), device="cpu").train(
            None, ["x"])
    tr = SatTrainer(CFG, device="cpu")
    for fn in (tr.test, tr.predict, tr._format_predictions,
               tr._parallel_solve_fn):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn()


def test_serving_forward_is_unchanged_by_training_mode():
    """forward without is_training stays under no_grad, and equal for
    modules in train mode at dropout 0."""
    tr = SatTrainer(CFG, device="cpu")
    batch = pack_instances(_instances(8), device="cpu")
    g = torch.Generator()
    outs = []
    for mode in ("eval", "train"):
        getattr(tr.params, mode)()
        g.manual_seed(0)
        st = tr.solver.get_init_state(g, batch, True)
        (pred, _), _ = tr.solver.forward(tr.params, g, batch, st, 3,
                                         check_termination=True)
        assert not pred.requires_grad
        outs.append(pred)
    assert torch.equal(*outs)
    assert dataclasses.is_dataclass(batch)
