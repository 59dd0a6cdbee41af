"""Per-instance meta features: the port against the JAX package on the CPU.

Case for case the counterpart of tests/test_meta_features.py: the JSON
row's meta vector -> `FGBatch.graph_feat` -> per-edge features inside the
neural modules, against JAX's outputs on the same numpy-seeded instances
and parameters (made by the JAX package, handed over with
convert.load_into). Zero init states, so neither side draws. Predictions
to atol 1e-5 (a 2-iteration serving forward at hidden 16).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from tests.helpers import cnf_instance, random_ksat

from pdp_solver_tpu.fg.batch import pack_instances as jax_pack
from pdp_solver_tpu.fg.batch import replicate_batch as jax_replicate
from pdp_solver_tpu.fg.batch import unpack_instances as jax_unpack
from pdp_solver_tpu.solvers import PDPSolver as JaxSolver
from pdp_solver_tpu.solvers import SolverConfig as JaxConfig

from pdp_solver_tpu_torch import convert
from pdp_solver_tpu_torch.fg.batch import (
    pack_instances, replicate_batch, unpack_instances)
from pdp_solver_tpu_torch.fg.jsonfmt import instance_to_line, parse_line
from pdp_solver_tpu_torch.fg.loader import BatchLoader
from pdp_solver_tpu_torch.solvers.base import PDPSolver, SolverConfig
from pdp_solver_tpu_torch.train.trainer import SatTrainer
from pdp_solver_tpu_torch.utils import config, training

SMALL = dict(hidden_dim=16, mem_hidden_dim=8, agg_hidden_dim=8,
             mem_agg_hidden_dim=8, classifier_dim=8)
NEURAL = ("np-nd-np", "p-nd-np")


def _meta_instances():
    rng = np.random.default_rng(0)
    insts = []
    for i in range(3):
        inst = cnf_instance(8, random_ksat(rng, 8, 12, k=3))
        insts.append(inst + ((f"id{i}",), np.array([0.5 * i, 1.0 - i],
                                                   np.float32)))
    return insts


def _plain_instances(seed=1):
    rng = np.random.default_rng(seed)
    return [cnf_instance(6, random_ksat(rng, 6, 9, k=3))]


def _solvers(model, meta_dim):
    """(JAX solver, its params, port solver, the same params)."""
    kw = dict(SMALL, model_type=model, meta_dim=meta_dim)
    js = JaxSolver(JaxConfig(**kw))
    jp = js.init_params(jax.random.PRNGKey(0))
    ps = PDPSolver(SolverConfig(**kw))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return js, jp, ps, convert.load_into(ps.init_params("cpu"), tree)


def _forwards(model, meta_dim, insts, graph_feat_delta=0.0):
    """The 2-iteration serving predictions of both packages from zero
    states."""
    js, jp, ps, pp = _solvers(model, meta_dim)
    key = jax.random.PRNGKey(0)
    jb = jax_pack(insts)
    tb = pack_instances(insts, device="cpu")
    if graph_feat_delta:
        jb = jb._replace(graph_feat=jb.graph_feat + graph_feat_delta)
        tb = dataclasses.replace(
            tb, graph_feat=tb.graph_feat + graph_feat_delta)
    jstate = js.get_init_state(key, jb, randomized=False)
    (jpred, _), _ = js.forward(jp, key, jb, jstate, 2, is_training=False)
    g = torch.Generator()
    g.manual_seed(0)
    state = ps.get_init_state(g, tb, randomized=False)
    (pred, _), _ = ps.forward(pp, g, tb, state, 2)
    return pred.numpy(), np.asarray(jpred)


def test_json_row_meta_roundtrip():
    line = '[[2, 1], [1, -2], [1, 1], -1, ["name"], [0.25, 0.75]]'
    out = parse_line(line)
    assert len(out) == 7
    np.testing.assert_allclose(out[6], [0.25, 0.75])


def test_pack_collects_graph_feat():
    insts = _meta_instances()
    batch, jb = pack_instances(insts, device="cpu"), jax_pack(insts)
    assert batch.graph_feat.shape == (batch.batch_size, 2)
    np.testing.assert_array_equal(batch.graph_feat.numpy(),
                                  np.asarray(jb.graph_feat))
    np.testing.assert_allclose(batch.graph_feat[1].numpy(), [0.5, 0.0])
    np.testing.assert_allclose(batch.graph_feat[3:].numpy(), 0.0)
    # one instance without meta: zero width, as in JAX
    mixed = insts[:2] + [insts[2][:5]]
    assert pack_instances(mixed, device="cpu").graph_feat.shape == (
        jax_pack(mixed).graph_feat.shape)
    assert pack_instances(_plain_instances(), device="cpu").graph_feat.shape[
        1] == 0

    B = batch.batch_size
    rep, jrep = replicate_batch(batch, 2), jax_replicate(jb, 2)
    assert rep.graph_feat.shape == (2 * B, 2)
    np.testing.assert_array_equal(rep.graph_feat.numpy(),
                                  np.asarray(jrep.graph_feat))
    np.testing.assert_array_equal(rep.graph_feat[B + 1].numpy(),
                                  batch.graph_feat[1].numpy())


def test_unpack_round_trip_gives_the_meta_back():
    insts = _meta_instances()
    got = unpack_instances(pack_instances(insts, device="cpu"))
    ref = jax_unpack(jax_pack(insts))
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        assert len(a) == len(b) == 7 and a[:2] == b[:2] and a[4] == b[4]
        for i in (2, 3, 6):
            np.testing.assert_array_equal(a[i], np.asarray(b[i]))
    again = pack_instances(got, device="cpu")
    assert torch.equal(again.graph_feat,
                       pack_instances(insts, device="cpu").graph_feat)


def test_loader_carries_meta_through_fixed_shape_segments(tmp_path):
    path = tmp_path / "meta.json"
    with open(path, "w") as f:
        for inst in _meta_instances():
            row = instance_to_line(*inst[:5], misc=list(inst[5]))
            f.write(row[:-1] + ", " + str(inst[6].tolist()) + "]\n")
    loader = BatchLoader(input_file=str(path), batch_size=2, device="cpu")
    feats = [b.graph_feat for b, _ in loader]
    assert len(feats) == 2 and feats[0].shape[1] == 2
    got = np.concatenate([f[:2].numpy() for f in feats])[:3]
    np.testing.assert_allclose(
        np.sort(got, axis=0),
        np.sort(np.stack([i[6] for i in _meta_instances()]), axis=0))


@pytest.mark.parametrize("model", NEURAL)
def test_meta_features_flow_into_neural_solver(model):
    insts = _meta_instances()
    pred, jpred = _forwards(model, 2, insts)
    assert np.all(np.isfinite(pred))
    np.testing.assert_allclose(pred, jpred, atol=1e-5)
    # different meta values change the prediction (the path is live)
    pred2, jpred2 = _forwards(model, 2, insts, graph_feat_delta=3.0)
    np.testing.assert_allclose(pred2, jpred2, atol=1e-5)
    assert not np.allclose(pred, pred2)


@pytest.mark.parametrize("model", NEURAL)
def test_meta_dim_without_dataset_meta_uses_zeros(model):
    pred, jpred = _forwards(model, 1, _plain_instances())
    assert np.all(np.isfinite(pred))
    np.testing.assert_allclose(pred, jpred, atol=1e-5)


def test_meta_dataset_with_non_meta_config_is_ignored():
    insts = _meta_instances()
    assert pack_instances(insts, device="cpu").graph_feat.shape[1] == 2
    pred, jpred = _forwards("np-nd-np", 0, insts)
    np.testing.assert_allclose(pred, jpred, atol=1e-5)
    bare, _ = _forwards("np-nd-np", 0, [i[:5] for i in insts])
    np.testing.assert_array_equal(pred, bare)


def test_meta_width_mismatch_raises():
    batch = pack_instances(_meta_instances(), device="cpu")   # width 2
    for train in (False, True):
        solver = PDPSolver(SolverConfig(model_type="np-nd-np", meta_dim=3,
                                        **SMALL))
        params = solver.init_params("cpu")
        g = torch.Generator()
        state = solver.get_init_state(g, batch, randomized=False)
        with pytest.raises(ValueError, match="meta feature width"):
            solver.forward(params, g, batch, state, 1, is_training=train)


@pytest.mark.parametrize("model", NEURAL)
def test_params_from_jax_reads_the_meta_width(model):
    _, jp, _, pp = _solvers(model, 2)
    back = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    for (k, a), (_, b) in zip(back.named_parameters(),
                              pp.named_parameters()):
        assert torch.equal(a, b), k
    tree = convert.params_to_jax(back)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_p_nd_np_cnf_3_10_config_builds_and_trains():
    """The shipped config/Train/p-nd-np-cnf-3-10.yaml (meta_feature_dim 1)
    through utils/config.py: its solver takes meta width 1, and one step
    with zeros injected (a dataset without meta) gives a finite loss."""
    loaded = config.load_yaml_config(training.P_ND_NP_CNF_3_10_YAML)
    assert loaded == training.P_ND_NP_CNF_3_10
    merged = config.merge_config(loaded, {"train_outer_recurrence_num": 2})
    tr = SatTrainer(merged, device="cpu")
    assert tr.solver.cfg.meta_dim == 1
    assert tr.solver.dec_cfg.meta_dim == 1
    batch = pack_instances(_plain_instances(), device="cpu")
    ts, loss = tr.train_step(tr.init_train_state(), batch)
    assert np.isfinite(float(loss))
    assert os.path.basename(training.P_ND_NP_CNF_3_10_YAML) == (
        "p-nd-np-cnf-3-10.yaml")
