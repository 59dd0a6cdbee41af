"""The data pipeline: the port's generators, JSON format and BatchLoader
against the JAX package's, on the CPU. The generators are numpy in both
packages, so the instances from one seed must be equal array for array;
the loaders must hand out the same segments (every array of every packed
batch), shapes and macro_done flags."""

import numpy as np
import pytest

from pdp_solver_tpu.fg import generators as jgen
from pdp_solver_tpu.fg import jsonfmt as jjson
from pdp_solver_tpu.fg import loader as jloader

from pdp_solver_tpu_torch.fg import generators as gen
from pdp_solver_tpu_torch.fg import jsonfmt
from pdp_solver_tpu_torch.fg import loader
from pdp_solver_tpu_torch.utils import training

# the arrays both FGBatch layouts share
FIELDS = ("edge_var", "edge_clause", "edge_sign", "var_batch",
          "clause_batch", "edge_mask", "var_mask", "clause_mask",
          "instance_mask", "label")
META = ("num_vars", "num_clauses", "num_edges", "batch_size",
        "clause_width", "fast_var", "fast_clause", "var_window")

CONFIGS = {
    "uniform": dict(generator="uniform", min_n=5, max_n=30, min_k=2,
                    max_k=6, min_alpha=2.0, max_alpha=5.0),
    "modular": dict(generator="modular", min_k=3, min_n=10, max_n=40,
                    min_q=0.5, max_q=0.9, min_c=2, max_c=5, min_alpha=2.0,
                    max_alpha=4.0),
    "v-modular": dict(generator="v-modular", min_k=2, max_k=5, min_n=10,
                      max_n=40, min_q=0.5, max_q=0.9, min_c=2, max_c=5,
                      min_alpha=2.0, max_alpha=4.0),
}


def _same_instance(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_generators_match_jax(kind):
    ours = gen.make_generator(CONFIGS[kind], seed=7)
    ref = jgen.make_generator(CONFIGS[kind], seed=7)
    assert ours.max_dims() == ref.max_dims()
    for _ in range(20):
        _same_instance(ours.generate(), ref.generate())
    ours.reseed(3)
    ref.reseed(3)
    _same_instance(ours.generate(), ref.generate())


def test_flagship_mixture_matches_jax():
    ours = training.flagship_stream(17)
    ref = jgen.MixtureCNFGenerator(
        [jgen.UniformCNFGenerator(4, 100, 2, 10, 2.0, 10.0),
         jgen.UniformCNFGenerator(4, 100, 3, 3, 2.0, 4.2),
         jgen.UniformCNFGenerator(5, 100, 4, 4, 7.0, 9.9)],
        weights=[0.5, 0.25, 0.25], seed=17)
    ref.reseed(17)
    assert ours.max_dims() == ref.max_dims()
    for _ in range(30):
        _same_instance(ours.generate(), ref.generate())


def test_label_instances_waits_for_its_queue_item():
    with pytest.raises(NotImplementedError, match="item 7"):
        gen.label_instances([])


def test_json_format_matches_jax(tmp_path):
    g = jgen.make_generator(CONFIGS["uniform"], seed=2)
    insts = [g.generate() for _ in range(6)]
    lines = [jsonfmt.instance_to_line(*i[:4], float(j), ["id%d" % j])
             for j, i in enumerate(insts)]
    assert lines == [jjson.instance_to_line(*i[:4], float(j), ["id%d" % j])
                     for j, i in enumerate(insts)]
    clauses = [[1, -2, 3], [-1, 4]]
    assert (jsonfmt.clauses_to_line(4, clauses, 1.0)
            == jjson.clauses_to_line(4, clauses, 1.0))
    path = tmp_path / "d.json"
    path.write_text("\n".join(lines) + "\n\n")
    for a, b in zip(jsonfmt.read_json_dataset(str(path)),
                    jjson.read_json_dataset(str(path))):
        _same_instance(a, b)
    meta = '[[2, 1], [1, -2], [1, 1], 0, ["x"], [0.5, 2.0]]'
    _same_instance(jsonfmt.parse_line(meta), jjson.parse_line(meta))


def _same_segments(ours, ref):
    ours, ref = list(ours), list(ref)
    assert len(ours) == len(ref) > 0
    for (b, misc, done), (jb, jmisc, jdone) in zip(ours, ref):
        assert done == jdone and misc == jmisc
        for f in META:
            assert getattr(b, f) == getattr(jb, f), f
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(b, f).numpy(),
                                          np.asarray(getattr(jb, f)),
                                          err_msg=f)


@pytest.mark.parametrize("fixed_dims", [None, (120, 600, 2000, 12)])
def test_generator_loader_matches_jax(fixed_dims):
    kw = dict(epoch_size=30, batch_size=12, limit=5000, hidden_dim=4,
              fixed_shape=True, fixed_dims=fixed_dims)
    ours = loader.BatchLoader(
        generator=gen.make_generator(CONFIGS["v-modular"], seed=4),
        device="cpu", **kw)
    ref = jloader.BatchLoader(
        generator=jgen.make_generator(CONFIGS["v-modular"], seed=4), **kw)
    assert len(ours) == len(ref) == 3
    _same_segments(ours.iter_segments(), ref.iter_segments())


@pytest.mark.parametrize("lazy", [False, True])
def test_file_loader_matches_jax(tmp_path, monkeypatch, lazy):
    g = jgen.make_generator(CONFIGS["uniform"], seed=5)
    path = tmp_path / "train.json"
    path.write_text("".join(
        jjson.instance_to_line(*g.generate()[:4], 1.0, ["i%d" % j]) + "\n"
        for j in range(25)))
    if lazy:
        monkeypatch.setattr(loader, "LAZY_FILE_BYTES", 0)
        monkeypatch.setattr(jloader, "LAZY_FILE_BYTES", 0)
    kw = dict(batch_size=10, limit=2000, hidden_dim=3, shuffle=True,
              seed=3)
    ours = loader.BatchLoader(input_file=str(path), device="cpu", **kw)
    ref = jloader.BatchLoader(input_file=str(path), **kw)
    assert isinstance(ours._instances, loader._LazyJsonDataset) == lazy
    # divide_batch cut the macro-batches into several segments
    segs = list(ours.iter_segments())
    assert sum(not done for _, _, done in segs) > 0
    _same_segments(segs, ref.iter_segments())
    _same_segments(((b, m, True) for b, m in ours),
                   ((b, m, True) for b, m in ref))


def test_divide_batch_matches_jax():
    g = jgen.make_generator(CONFIGS["uniform"], seed=6)
    insts = [g.generate() for _ in range(40)]
    for limit in (10 ** 9, 3000, 1):
        ours = loader.divide_batch(insts, limit, 5)
        ref = jloader.divide_batch(insts, limit, 5)
        assert [len(s) for s in ours] == [len(s) for s in ref]
        for a, b in zip(ours, ref):
            assert all(x is y for x, y in zip(a, b))


def test_fixed_dims_overflow_raises():
    ours = loader.BatchLoader(
        generator=gen.make_generator(CONFIGS["uniform"], seed=4),
        epoch_size=3, batch_size=3, fixed_shape=True,
        fixed_dims=(4, 4, 4, 2), device="cpu")
    with pytest.raises(ValueError, match="exceed fixed pad dims"):
        list(ours.iter_segments())
