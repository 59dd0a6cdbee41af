"""The multi-column segment sum (`ops/reduce.py`, kernels 4, 5 and 8 of
PERF.md) and the column reduces of `modules/common.py`: the port against
the JAX package on the CPU.

The JAX side runs its Pallas kernels in interpret mode
(`windowed_segment_sum_cols`, `windowed_segment_sum`, the based kernel
behind `_hybrid_to_vars_cols`, `sorted_segment_sum`), with
PDP_SEGMENT_BACKEND=windowed where it dispatches through `common`. The
port walks one CSR for all of them; on the CPU its wrappers run their
plain versions. Tolerance: sums of floats rtol 1e-5 / atol 1e-6 (another
summation order); sums of integer-valued columns exactly. The JAX kernels
take columns pre-masked by the caller; the port takes them unmasked and
must leave the padding edges out of every sum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import cnf_instance, random_ksat

from pdp_solver_tpu.fg.batch import pack_instances as jax_pack
from pdp_solver_tpu.modules import common as jcommon
from pdp_solver_tpu.ops import pallas_reduce, pallas_segment

from pdp_solver_tpu_torch.fg.batch import pack_instances
from pdp_solver_tpu_torch.modules import common
from pdp_solver_tpu_torch.ops import reduce

FLOAT = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def windowed(monkeypatch):
    monkeypatch.setenv("PDP_SEGMENT_BACKEND", "windowed")
    monkeypatch.setenv("PDP_COMPILE_CACHE", "off")


@pytest.fixture(scope="module")
def uniform():
    rng = np.random.default_rng(0)
    insts = [cnf_instance(40, random_ksat(rng, 40, 170, k=4))
             for _ in range(7)]
    jb = jax_pack(insts)
    assert jb.fast_var and jb.clause_width == 4
    return jb, pack_instances(insts, device="cpu")


def _ragged_instance(rng, n=3000, m=1100, outliers=0.1):
    """One instance of mixed clause widths (2-5) whose literals sit near a
    centre that walks over the variables, with `outliers` of them anywhere:
    its edge tiles span more variables than the window invariant allows."""
    clauses = []
    for c in range(m):
        centre = int(c * n / m)
        lits = set()
        for _ in range(int(rng.integers(2, 6))):
            v = (int(rng.integers(0, n)) if rng.random() < outliers
                 else min(n - 1, max(0, centre + int(rng.integers(-20, 21)))))
            lits.add(v)
        clauses.append([(v + 1) * int(rng.choice([-1, 1])) for v in lits])
    return cnf_instance(n, clauses)


@pytest.fixture(scope="module")
def ragged():
    rng = np.random.default_rng(1)
    insts = [_ragged_instance(rng)]
    jb = jax_pack(insts)
    assert not jb.fast_var and jb.hybrid_var and jb.clause_width == 0
    return jb, pack_instances(insts, device="cpu")


def _cols(rng, E, C, integer=False):
    if integer:
        return [rng.integers(-3, 4, E).astype(np.float32) for _ in range(C)]
    return [rng.normal(size=E).astype(np.float32) for _ in range(C)]


def _masked_jax(jb, cols):
    m = np.asarray(jb.edge_mask)
    return tuple(jnp.asarray(c * m) for c in cols)


@pytest.mark.parametrize("C", [1, 2, 4])
def test_segment_sum_cols_matches_windowed_kernel(uniform, C):
    jb, tb = uniform
    cols = _cols(np.random.default_rng(C), jb.num_edges, C)
    ref = pallas_reduce.windowed_segment_sum_cols(
        _masked_jax(jb, cols), jnp.asarray(jb.edge_var), jb.num_vars,
        interpret=True)
    got = reduce.segment_sum_cols(
        [torch.from_numpy(c) for c in cols], tb.edge_var, tb.num_vars,
        tb.num_real_edges, tb.var_ptr, tb.var_perm)
    assert got.shape == (C, tb.num_vars)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FLOAT)


def test_segment_sum_rows_matches_windowed_kernel(uniform):
    """The [E, C] form, and the 1-D one."""
    jb, tb = uniform
    rng = np.random.default_rng(5)
    x = rng.normal(size=(jb.num_edges, 2)).astype(np.float32)
    m = np.asarray(jb.edge_mask)[:, None]
    ref = pallas_reduce.windowed_segment_sum(
        jnp.asarray(x * m), jnp.asarray(jb.edge_var), jb.num_vars,
        interpret=True)
    args = (tb.edge_var, tb.num_vars, tb.num_real_edges, tb.var_ptr,
            tb.var_perm)
    got = reduce.segment_sum(torch.from_numpy(x), *args)
    assert got.shape == (tb.num_vars, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FLOAT)
    ref1 = pallas_reduce.windowed_segment_sum(
        jnp.asarray(x[:, 1] * m[:, 0]), jnp.asarray(jb.edge_var),
        jb.num_vars, interpret=True)
    got1 = reduce.segment_sum(torch.from_numpy(x[:, 1].copy()), *args)
    np.testing.assert_allclose(got1.numpy(), np.asarray(ref1), **FLOAT)


def test_common_var_reduces_match_jax(windowed, uniform):
    """scatter_to_vars (1-D and [E, 3]) and scatter_to_vars_cols through
    the JAX dispatch's windowed kernel; integer columns exactly."""
    jb, tb = uniform
    rng = np.random.default_rng(6)
    cols = _cols(rng, jb.num_edges, 3, integer=True)
    x3 = np.stack(cols, axis=1)
    ref = jcommon.scatter_to_vars_cols(jb, tuple(jnp.asarray(c)
                                                 for c in cols))
    got = common.scatter_to_vars_cols(tb, [torch.from_numpy(c)
                                           for c in cols])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ref = jcommon.scatter_to_vars(jb, jnp.asarray(x3))
    got = common.scatter_to_vars(tb, torch.from_numpy(x3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ref = jcommon.scatter_to_vars(jb, jnp.asarray(cols[0]))
    got = common.scatter_to_vars(tb, torch.from_numpy(cols[0]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("which", ["uniform", "ragged"])
def test_scatter_to_clauses_cols_matches_jax(windowed, uniform, ragged,
                                             which):
    """A reshape-sum for the uniform width, the clause CSR otherwise."""
    jb, tb = uniform if which == "uniform" else ragged
    cols = _cols(np.random.default_rng(7), jb.num_edges, 2)
    ref = jcommon.scatter_to_clauses_cols(jb, tuple(jnp.asarray(c)
                                                    for c in cols))
    got = common.scatter_to_clauses_cols(tb, [torch.from_numpy(c)
                                              for c in cols])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FLOAT)


def test_var_smooth_max_matches_jax(windowed, uniform):
    jb, tb = uniform
    rng = np.random.default_rng(8)
    x = (rng.uniform(0.0, 0.3, jb.num_edges)
         * np.asarray(jb.edge_mask)).astype(np.float32)
    ref = jcommon.var_smooth_max(jb, jnp.asarray(x))
    got = common.var_smooth_max(tb, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FLOAT)


@pytest.mark.parametrize("integer", [True, False])
def test_ragged_batch_matches_based_kernel(windowed, ragged, integer):
    """Kernel 5's function: on a batch that fails the window invariant the
    JAX package sums with the based kernel plus the residual scatter
    (_hybrid_to_vars_cols); the port walks the same CSR as ever."""
    jb, tb = ragged
    cols = _cols(np.random.default_rng(9), jb.num_edges, 3, integer)
    ref = jcommon._hybrid_to_vars_cols(jb, _masked_jax(jb, cols))
    assert np.asarray(jb.var_resid_mask).sum() > 0, "no residual edges"
    got = common.scatter_to_vars_cols(tb, [torch.from_numpy(c)
                                           for c in cols])
    if integer:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FLOAT)
    # the dispatch takes the based kernel too
    disp = jcommon.scatter_to_vars_cols(jb, tuple(jnp.asarray(c)
                                                  for c in cols))
    np.testing.assert_allclose(got.numpy(), np.asarray(disp), **FLOAT)


@pytest.mark.parametrize("case", ["ragged", "tile_boundary", "single"])
def test_sorted_segment_sum_matches_jax(case):
    """Kernel 8's function: C = 1 over a CSR of the sorted ids."""
    rng = np.random.default_rng(10)
    if case == "ragged":
        n = 700
        ids = np.repeat(np.arange(n), rng.integers(2, 6, size=n))
    elif case == "tile_boundary":
        n = 600
        ids = np.sort(rng.integers(0, n, size=2 * pallas_segment.TILE))
    else:
        n = 4
        ids = np.zeros(100, np.int64)
    ids = ids.astype(np.int32)
    x = (np.ones(len(ids)) if case == "single"
         else rng.integers(-4, 5, len(ids))).astype(np.float32)
    ref = pallas_segment.sorted_segment_sum(
        jnp.asarray(x), jnp.asarray(ids), n, interpret=True)
    got = reduce.sorted_segment_sum(torch.from_numpy(x),
                                    torch.from_numpy(ids.astype(np.int64)),
                                    n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_wrappers_refuse_bad_shapes(uniform):
    _, tb = uniform
    E, V = tb.num_edges, tb.num_vars
    args = (tb.edge_var, V, tb.num_real_edges, tb.var_ptr, tb.var_perm)
    col = torch.zeros(E)
    with pytest.raises(ValueError):
        reduce.segment_sum_cols([col] * 9, *args)
    with pytest.raises(ValueError):
        reduce.segment_sum_cols([col[:-1]], *args)
    with pytest.raises(ValueError):
        reduce.segment_sum(torch.zeros(E, 9), *args)
    with pytest.raises(ValueError):
        reduce.segment_sum(torch.zeros(E, dtype=torch.float64), *args)
    with pytest.raises(ValueError):
        reduce.sorted_segment_sum(col, tb.edge_var[:-1], V)
