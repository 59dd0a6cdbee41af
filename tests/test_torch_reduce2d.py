"""The [E, d] segment sum and gather (kernels 6 and 7): the port's plain
versions against the JAX package's windowed kernels, which run in Pallas
interpret mode here (PDP_SEGMENT_BACKEND=windowed).

Tolerances: the sum to rtol 1e-5 / atol 1e-5 (the JAX kernel contracts a
one-hot window on the matrix unit, the port adds in edge order); the
gather, with or without the fused subtract, exactly, padding rows
included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import cnf_instance, random_ksat

from pdp_solver_tpu.fg.batch import pack_instances as jax_pack
from pdp_solver_tpu.ops.pallas_reduce2d import (
    windowed_gather_2d, windowed_segment_sum_2d)

from pdp_solver_tpu_torch.fg.batch import pack_instances
from pdp_solver_tpu_torch.modules import common
from pdp_solver_tpu_torch.ops.reduce2d import gather_2d, segment_sum_2d

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def windowed(monkeypatch):
    monkeypatch.setenv("PDP_SEGMENT_BACKEND", "windowed")
    monkeypatch.setenv("PDP_COMPILE_CACHE", "off")


def _csr(ids, n):
    counts = np.bincount(ids, minlength=n)
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    perm = np.argsort(ids, kind="stable").astype(np.int32)
    return torch.from_numpy(ptr), torch.from_numpy(perm)


@pytest.fixture
def data():
    """The data of tests/test_reduce2d.py."""
    rng = np.random.default_rng(3)
    E, N, d = 700, 90, 50
    ids = np.sort(rng.integers(0, N, E)).astype(np.int32)
    x = rng.standard_normal((E, d)).astype(np.float32)
    nodes = rng.standard_normal((N, d)).astype(np.float32)
    return ids, x, nodes, E, N, d


def test_segment_sum_2d_matches_windowed_kernel(data):
    ids, x, nodes, E, N, d = data
    ref = np.asarray(windowed_segment_sum_2d(jnp.asarray(x),
                                             jnp.asarray(ids), N, True))
    ptr, perm = _csr(ids, N)
    got = segment_sum_2d(torch.from_numpy(x),
                         torch.from_numpy(ids.astype(np.int64)), N, E, ptr,
                         perm)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("minus", [False, True])
def test_gather_2d_matches_windowed_kernel(data, minus):
    ids, x, nodes, E, N, d = data
    ref = np.asarray(windowed_gather_2d(jnp.asarray(nodes),
                                        jnp.asarray(ids), E, True))
    got = gather_2d(torch.from_numpy(nodes),
                    torch.from_numpy(ids.astype(np.int64)),
                    torch.from_numpy(x) if minus else None)
    np.testing.assert_array_equal(got.numpy(), ref - x if minus else ref)


def _packed(seed):
    rng = np.random.default_rng(seed)
    insts = [cnf_instance(n, random_ksat(rng, n, int(n * 5.5), 4))
             for n in (30, 41, 25)]
    return jax_pack(insts), pack_instances(insts, device="cpu")


@pytest.mark.parametrize("d", [50, 24])
def test_packed_batch_with_padding(windowed, d):
    jb, tb = _packed(d)
    assert tb.num_edges > tb.num_real_edges, "no padding edges"
    assert jb.fast_var
    rng = np.random.default_rng(d)
    x = rng.standard_normal((tb.num_edges, d)).astype(np.float32)
    nodes = rng.standard_normal((tb.num_vars, d)).astype(np.float32)
    em = np.asarray(jb.edge_mask)

    ref = np.asarray(windowed_segment_sum_2d(
        jnp.asarray(x * em[:, None]), jb.edge_var, jb.num_vars, True))
    got = common.scatter_to_vars(tb, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)

    ref_g = np.asarray(windowed_gather_2d(jnp.asarray(nodes), jb.edge_var,
                                          jb.num_edges, True))
    got_g = common.gather_from_vars(tb, torch.from_numpy(nodes))
    np.testing.assert_array_equal(got_g.numpy(), ref_g)
    assert np.abs(ref_g[tb.num_real_edges:]).sum() > 0

    # aggregate minus self, padding rows included (JAX common.py:196)
    from pdp_solver_tpu.modules import common as jcommon
    ref_m = np.asarray(jcommon.aggregate_minus_self_var(jb, jnp.asarray(x)))
    got_m = common.aggregate_minus_self_var(tb, torch.from_numpy(x))
    np.testing.assert_allclose(got_m.numpy(), ref_m, **TOL)


def test_clause_side_matches_jax(windowed):
    from pdp_solver_tpu.modules import common as jcommon
    jb, tb = _packed(7)
    assert tb.clause_width == 4
    x = np.random.default_rng(8).standard_normal(
        (tb.num_edges, 16)).astype(np.float32)
    ref = np.asarray(jcommon.scatter_to_clauses(jb, jnp.asarray(x)))
    got = common.scatter_to_clauses(tb, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # a batch of mixed clause widths sums over the clause-major CSR
    rng = np.random.default_rng(9)
    insts = [cnf_instance(20, random_ksat(rng, 20, 50, k)) for k in (3, 4)]
    jb2, tb2 = jax_pack(insts), pack_instances(insts, device="cpu")
    assert tb2.clause_width == 0
    x2 = rng.standard_normal((tb2.num_edges, 8)).astype(np.float32)
    ref2 = np.asarray(jcommon.scatter_to_clauses(jb2, jnp.asarray(x2)))
    got2 = common.scatter_to_clauses(tb2, torch.from_numpy(x2))
    np.testing.assert_allclose(got2.numpy(), ref2, **TOL)
    np.testing.assert_array_equal(
        common.gather_from_clauses(tb2, got2).numpy(),
        np.asarray(jcommon.gather_from_clauses(jb2, jnp.asarray(ref2))))


def test_wrappers_reject_bad_inputs():
    x = torch.zeros(10, 4)
    ids = torch.zeros(10, dtype=torch.int64)
    ptr = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        segment_sum_2d(x.double(), ids, 2, 10, ptr)
    with pytest.raises(ValueError):
        segment_sum_2d(x, ids[:5], 2, 10, ptr)
    with pytest.raises(ValueError):
        gather_2d(x, ids, minus=torch.zeros(10, 5))
    with pytest.raises(ValueError):
        gather_2d(x.to("meta"), ids.to("meta"))
