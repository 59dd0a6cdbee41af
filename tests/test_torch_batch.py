"""Packing and the shared benchmark set: the port against the JAX package.

Exact equality throughout: ids, signs, masks, bucket shapes and the
pack-time metadata are integers or flags.
"""

import numpy as np
import pytest
import torch

from tests.helpers import cnf_instance, random_ksat

from pdp_solver_tpu.fg.batch import bucket_dims as jax_bucket_dims
from pdp_solver_tpu.fg.batch import pack_instances as jax_pack
from pdp_solver_tpu.utils import benchdata as jax_benchdata

from pdp_solver_tpu_torch.fg.batch import bucket_dims, pack_instances
from pdp_solver_tpu_torch.utils.benchdata import (
    SHARED_SET_FINGERPRINT, dataset_fingerprint, make_ksat_set)

FIELDS = ("edge_var", "edge_clause", "edge_sign", "var_batch",
          "clause_batch", "edge_mask", "var_mask", "clause_mask",
          "instance_mask", "label")


def _mixed_instances(seed):
    rng = np.random.default_rng(seed)
    insts = [cnf_instance(12, random_ksat(rng, 12, 40, k=3), label=1.0),
             cnf_instance(3, [[1], [-1], [2, 3]], label=0.0),     # UNSAT
             cnf_instance(9, [[1, -2], [2, 3, -4], [5], [-6, 7, 8, 9]]),
             cnf_instance(20, random_ksat(rng, 20, 70, k=4))]
    return insts


def _assert_same_pack(jb, tb):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    for f in ("clause_width", "fast_var", "fast_clause", "var_window",
              "num_edges", "num_vars", "num_clauses", "batch_size"):
        assert getattr(tb, f) == getattr(jb, f), f


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_matches_jax_ragged(seed):
    insts = _mixed_instances(seed)
    _assert_same_pack(jax_pack(insts), pack_instances(insts, device="cpu"))


@pytest.mark.parametrize("k", [3, 4])
def test_pack_matches_jax_uniform(k):
    rng = np.random.default_rng(k)
    insts = [cnf_instance(15, random_ksat(rng, 15, 50, k=k))
             for _ in range(6)]
    jb, tb = jax_pack(insts), pack_instances(insts, device="cpu")
    _assert_same_pack(jb, tb)
    assert tb.clause_width == k


def test_pack_explicit_padding_matches_jax():
    insts = _mixed_instances(2)
    kw = dict(pad_v=64, pad_f=160, pad_e=512, pad_b=8)
    _assert_same_pack(jax_pack(insts, **kw),
                      pack_instances(insts, device="cpu", **kw))
    with pytest.raises(ValueError):
        pack_instances(insts, device="cpu", pad_v=4, pad_f=4, pad_e=4,
                       pad_b=4)


def test_bucket_dims_match_jax():
    for dims in [(1, 1, 1, 1), (129, 300, 5000, 7), (12800, 115200,
                                                      460800, 128)]:
        assert bucket_dims(*dims) == jax_bucket_dims(*dims)


def test_csr_layout_describes_the_real_edges():
    insts = _mixed_instances(3)
    tb = pack_instances(insts, device="cpu")
    e = tb.num_real_edges
    ev, ec = tb.edge_var[:e].numpy(), tb.edge_clause[:e].numpy()
    perm, vptr = tb.var_perm.numpy(), tb.var_ptr.numpy()
    assert sorted(perm.tolist()) == list(range(e))
    for v in range(tb.num_vars):
        edges = perm[vptr[v]:vptr[v + 1]]
        assert (ev[edges] == v).all() and (np.diff(edges) > 0).all()
    cptr = tb.clause_ptr.numpy()
    for c in range(tb.num_clauses):
        assert (ec[cptr[c]:cptr[c + 1]] == c).all()
    assert cptr[-1] == e
    ivp, icp = tb.inst_var_ptr.numpy(), tb.inst_clause_ptr.numpy()
    for b, inst in enumerate(insts):
        assert ivp[b + 1] - ivp[b] == inst[0]
        assert icp[b + 1] - icp[b] == inst[1]
    assert tb.num_real_clauses == sum(i[1] for i in insts)
    assert tb.max_instance_vars == max(i[0] for i in insts)
    assert tb.edge_var32.dtype == torch.int32


def test_shared_set_fingerprint_and_full_size_shapes():
    insts = make_ksat_set()
    assert dataset_fingerprint(insts) == SHARED_SET_FINGERPRINT
    ref = jax_benchdata.make_ksat_set(count=3)
    for a, b in zip(make_ksat_set(count=3), ref):
        np.testing.assert_array_equal(a[2], b[2])
        np.testing.assert_array_equal(a[3], b[3])
    tb = pack_instances(insts, device="cpu")
    assert (tb.num_edges, tb.num_vars, tb.num_clauses, tb.batch_size) == (
        524288, 16384, 131072, 128)
    assert tb.num_real_edges == 460800 and tb.clause_width == 4
    assert tb.fast_var and tb.fast_clause
