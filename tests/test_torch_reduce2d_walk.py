"""Kernel 6's order (`csrc/reduce2d.cu`) in PyTorch, and its launch's host
side, on the CPU.

`ops/reduce2d.py walk_order_sum_2d` repeats the card's sums in the card's
order: a light node's rows one after another in slot order; a node of
R2D_HEAVY slots or more cut into the pieces of the blocks anchored inside
it, each piece's chunks of 32 slots dealt round the block's warps, the
warps' rows added in warp order and the pieces' rows in anchor order, in
eight runs. These tests hold it, and `segment_sum_2d`'s plain route, to
JAX's `windowed_segment_sum_2d` in interpret mode (over the real rows in
CSR order with sorted ids, the window invariant checked): exactly on
integer-valued rows, and to rtol 1e-5 / atol 1e-6 on rows in [0, 1) (no
cancellation, so the two orders stay within that), for f32 rows and bf16
rows (JAX's aggregators' form: the rows widened to f32); on a bucket-padded
4-SAT batch (padding edges, variables and clauses), a batch of mixed clause
widths, and a hub whose variable sits in 1,000 clauses (four pieces). A
plain loop in numpy states the kernel's order a second time and must give
the same bits. Padding rows are never read (NaN there changes nothing),
the modules hand the pack-time largest degree to the sum and to Gather2d's
backward, and the launch's host side (the heavy flag and scratch, the
argument block against its C structure, the shared constants) is as the
kernel expects.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import cnf_instance, random_ksat

from pdp_solver_tpu.fg.batch import _windowed_ok
from pdp_solver_tpu.ops.pallas_reduce2d import windowed_segment_sum_2d

from pdp_solver_tpu_torch.fg.batch import pack_instances
from pdp_solver_tpu_torch.modules import common
from pdp_solver_tpu_torch.ops import _build, reduce2d

JTOL = dict(rtol=1e-5, atol=1e-6)
S = _build.R2D_HEAVY
D = 6
CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pdp_solver_tpu_torch", "csrc",
    "reduce2d.cu")


def _mixed(rng, ns=(20, 30, 25)):
    insts = []
    for n in ns:
        clauses = []
        for k in rng.integers(2, 6, size=3 * n):
            vs = rng.choice(n, size=int(k), replace=False)
            clauses.append([int((v + 1) * s) for v, s in zip(
                vs, rng.integers(0, 2, size=int(k)) * 2 - 1)])
        insts.append(cnf_instance(n, clauses))
    return pack_instances(insts, device="cpu")


def _hub(rng, n=100, m=1100, k=3, degree=1000):
    """One instance whose variable 0 sits in `degree` of its clauses."""
    v = np.stack([rng.choice(np.arange(1, n), k, replace=False)
                  for _ in range(m)])
    v[:degree, 0] = 0
    ec = np.repeat(np.arange(m, dtype=np.int32), k)
    signs = rng.choice([-1.0, 1.0], m * k).astype(np.float32)
    return pack_instances([(n, m, np.stack([v.reshape(-1).astype(np.int32),
                                            ec]), signs, -1.0)],
                          device="cpu")


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(11)
    packed = pack_instances([cnf_instance(n, random_ksat(rng, n, 5 * n, 4))
                             for n in (30, 41, 25)], device="cpu")
    return {"packed": packed, "mixed": _mixed(rng), "hub": _hub(rng)}


def _csr(b, side):
    if side == "var":
        return b.edge_var, b.num_vars, b.var_ptr, b.var_perm, \
            b.var_max_degree
    return b.edge_clause, b.num_clauses, b.clause_ptr, None, \
        b.clause_max_degree


def _rows(b, dtype, kind, seed):
    """Seeded [E, D] rows: integers in [-3, 3] or floats in [0, 1),
    representable in dtype."""
    rng = np.random.default_rng(seed)
    if kind == "int":
        x = rng.integers(-3, 4, size=(b.num_edges, D)).astype(np.float32)
    else:
        x = rng.random((b.num_edges, D), dtype=np.float32)
    return torch.from_numpy(x).to(dtype)


def _jax_sum(x, ptr, perm, n):
    """JAX's windowed kernel (interpret mode) over the real rows in CSR
    order, with the sorted node ids of the slots."""
    ptr = ptr.numpy().astype(np.int64)
    e = int(ptr[-1])
    order = np.arange(e) if perm is None else perm.numpy().astype(np.int64)
    ids = np.repeat(np.arange(n, dtype=np.int32), np.diff(ptr))
    assert _windowed_ok(ids)
    xs = x[:e].float().numpy()[order]
    return np.asarray(windowed_segment_sum_2d(jnp.asarray(xs),
                                              jnp.asarray(ids), n, True))


def _kernel_order_numpy(x, ptr, perm):
    """The kernel's sums, stated as plain loops over f32 numpy rows."""
    W, C = _build.R2D_WARPS, 32
    x = x.float().numpy()
    ptr = ptr.numpy().astype(np.int64)
    slot = (np.arange(ptr[-1]) if perm is None
            else perm.numpy().astype(np.int64))
    zero = np.zeros(x.shape[1], np.float32)
    out = np.zeros((len(ptr) - 1, x.shape[1]), np.float32)
    for v in range(len(ptr) - 1):
        lo, hi = int(ptr[v]), int(ptr[v + 1])
        if hi - lo < S:
            acc = zero
            for j in range(lo, hi):
                acc = acc + x[slot[j]]
            out[v] = acc
            continue
        parts = []
        for a in range(-(-lo // S), (hi - 1) // S + 1):
            j0, j1 = max(lo, a * S), min(a * S + S, hi)
            part = None
            for w in range(W):
                acc = zero
                for cb in range(j0 + C * w, j1, C * W):
                    for j in range(cb, min(cb + C, j1)):
                        acc = acc + x[slot[j]]
                part = acc if part is None else part + acc
            parts.append(part)
        m = -(-len(parts) // W)
        tot = None
        for w in range(W):
            acc = zero
            for p in parts[w * m:w * m + m]:
                acc = acc + p
            tot = acc if tot is None else tot + acc
        out[v] = tot
    return out


CASES = [(b, side, dt) for b in ("packed", "mixed", "hub")
         for side in ("var", "clause")
         for dt in (torch.float32, torch.bfloat16)]
IDS = [f"{b}-{side}-{str(dt)[6:]}" for b, side, dt in CASES]


@pytest.mark.parametrize("name,side,dtype", CASES, ids=IDS)
def test_walk_order_sum_2d_matches_windowed_kernel(batches, name, side,
                                                   dtype):
    b = batches[name]
    _, n, ptr, perm, _ = _csr(b, side)
    xi = _rows(b, dtype, "int", 1)
    got = reduce2d.walk_order_sum_2d(xi, ptr, perm)
    assert got.dtype == torch.float32 and got.shape == (n, D)
    np.testing.assert_array_equal(got.numpy(), _jax_sum(xi, ptr, perm, n))
    xf = _rows(b, dtype, "unit", 2)
    np.testing.assert_allclose(reduce2d.walk_order_sum_2d(xf, ptr, perm),
                               _jax_sum(xf, ptr, perm, n), **JTOL)


@pytest.mark.parametrize("name,side,dtype", CASES, ids=IDS)
def test_segment_sum_2d_plain_route_matches_windowed_kernel(batches, name,
                                                            side, dtype):
    b = batches[name]
    ids, n, ptr, perm, md = _csr(b, side)
    e = b.num_real_edges
    for kind, seed in (("int", 3), ("unit", 4)):
        x = _rows(b, dtype, kind, seed)
        got = reduce2d.segment_sum_2d(x, ids, n, e, ptr, perm,
                                      max_degree=md)
        assert got.dtype == torch.float32
        ref = _jax_sum(x, ptr, perm, n)
        if kind == "int":
            np.testing.assert_array_equal(got.numpy(), ref)
        else:
            np.testing.assert_allclose(got.numpy(), ref, **JTOL)


@pytest.mark.parametrize("name", ["packed", "mixed", "hub"])
@pytest.mark.parametrize("side", ["var", "clause"])
def test_walk_order_is_the_kernels_order(batches, name, side):
    """Two statements of the order, bit for bit, on signed rows (where
    another order would give other bits)."""
    b = batches[name]
    _, _, ptr, perm, _ = _csr(b, side)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (b.num_edges, D)).astype(np.float32))
    got = reduce2d.walk_order_sum_2d(x, ptr, perm)
    np.testing.assert_array_equal(got.numpy(),
                                  _kernel_order_numpy(x, ptr, perm))


def test_the_hub_is_cut_into_pieces(batches):
    """The hub's variable holds over three heavy strides (its sum has
    four or more pieces); no node of the other batches is heavy."""
    hub = batches["hub"]
    lo, hi = int(hub.var_ptr[0]), int(hub.var_ptr[1])
    assert hi - lo == hub.var_max_degree == 1000
    assert (hi - 1) // S - (-(-lo // S)) + 1 >= 4
    for name in ("packed", "mixed"):
        b = batches[name]
        assert max(b.var_max_degree, b.clause_max_degree) < S


@pytest.mark.parametrize("name", ["packed", "hub"])
def test_padding_rows_are_never_read_and_empty_nodes_are_zero(batches,
                                                              name):
    b = batches[name]
    e = b.num_real_edges
    assert e < b.num_edges
    x = _rows(b, torch.float32, "unit", 6)
    for side in ("var", "clause"):
        ids, n, ptr, perm, md = _csr(b, side)
        clean = reduce2d.walk_order_sum_2d(x, ptr, perm)
        dirty = x.clone()
        dirty[e:] = float("nan")
        assert torch.equal(reduce2d.walk_order_sum_2d(dirty, ptr, perm),
                           clean)
        assert torch.equal(reduce2d.segment_sum_2d(dirty, ids, n, e, ptr,
                                                   perm, max_degree=md),
                           reduce2d.segment_sum_2d(x, ids, n, e, ptr, perm))
        empty = (ptr[1:] - ptr[:-1]) == 0
        assert bool(empty.any())
        assert bool((clean[empty] == 0).all())


def test_modules_hand_max_degree_through(batches, monkeypatch):
    """scatter_to_vars, scatter_to_clauses (the mixed-width CSR, and bf16
    rows of a uniform batch) and Gather2d's backward over both CSRs give
    the sum the batch's pack-time largest degree."""
    seen = []
    real = reduce2d._segment_sum_2d

    def spy(x, ids, n, num_real, ptr, perm=None, max_degree=None):
        seen.append(max_degree)
        return real(x, ids, n, num_real, ptr, perm, max_degree)

    monkeypatch.setattr(reduce2d, "_segment_sum_2d", spy)
    mixed, packed = batches["mixed"], batches["packed"]
    assert mixed.clause_width == 0 and packed.clause_width == 4
    # [E, d >= MIN_2D_WIDTH] f32 rows take kernel 6 on the var side
    x = torch.rand(mixed.num_edges, common.MIN_2D_WIDTH)
    common.scatter_to_vars(mixed, x)
    common.scatter_to_clauses(mixed, x)
    common.scatter_to_clauses(packed,
                              _rows(packed, torch.bfloat16, "unit", 8))
    assert seen == [mixed.var_max_degree, mixed.clause_max_degree,
                    packed.clause_max_degree]
    seen.clear()
    e = mixed.num_real_edges
    g = _rows(mixed, torch.float32, "unit", 9)
    g[e:] = 0.0
    for ids, n, csr in ((mixed.edge_var32, mixed.num_vars,
                         common.var_csr(mixed)),
                        (mixed.edge_clause32, mixed.num_clauses,
                         common.clause_csr(mixed))):
        nodes = torch.rand(n, D, requires_grad=True)
        reduce2d.gather_2d(nodes, ids, csr=csr).backward(g)
        assert nodes.grad is not None
    assert seen == [mixed.var_max_degree, mixed.clause_max_degree]


def test_csr_is_a_triple_that_carries_max_degree(batches):
    b = batches["mixed"]
    num_real, ptr, perm = common.var_csr(b)
    assert (num_real, ptr, perm) == (b.num_real_edges, b.var_ptr,
                                     b.var_perm)
    assert common.var_csr(b).max_degree == b.var_max_degree
    num_real, ptr, perm = common.clause_csr(b)
    assert perm is None and ptr is b.clause_ptr
    assert common.clause_csr(b).max_degree == b.clause_max_degree
    assert reduce2d.Csr(1, ptr, None).max_degree is None


@pytest.mark.parametrize("max_degree,heavy", [
    (S - 1, 0), (S, 1), (None, 1), (63488, 1)])
def test_sum2d_scratch(max_degree, heavy):
    a = _build.SegSum2dArgs()
    kept = _build.sum2d_scratch(a, 1000, 50, max_degree,
                                torch.device("cpu"))
    assert a.heavy == heavy
    if not heavy:
        assert kept == () and not a.partials and not a.counters
        return
    partials, counters = kept
    anchors = -(-1000 // S)
    assert partials.shape == (anchors * 50,)
    assert partials.dtype == torch.float32
    assert torch.equal(counters, torch.zeros(anchors, dtype=torch.int32))
    assert a.partials == partials.data_ptr()
    assert a.counters == counters.data_ptr()


def _c_fields(struct):
    src = open(CSRC).read()
    m = re.search(r"struct %s \{(.*?)\};" % struct, src, re.S)
    assert m, f"no struct {struct} in {CSRC}"
    fields = []
    for line in m.group(1).split(";"):
        line = re.sub(r"//.*", "", line).strip()
        if line:
            fields.append((line.split()[-1].lstrip("*"), "*" in line))
    return fields


def test_argument_block_matches_the_c_structure():
    ct = [(f, t) for f, t in _build.SegSum2dArgs._fields_]
    c = _c_fields("SegSum2dArgs")
    assert [f for f, _ in ct] == [f for f, _ in c]
    for (f, t), (_, ptr) in zip(ct, c):
        assert (t is _build.P) == ptr, f


def test_constants_match_the_source():
    src = open(CSRC).read()

    def const(name):
        return int(re.search(r"#define %s (\d+)" % name, src).group(1))

    assert const("PDP_R2D_HEAVY") == _build.R2D_HEAVY
    assert "#define PDP_R2D_WARPS (PDP_THREADS / 32)" in src
    assert _build.R2D_WARPS == _build.THREADS // 32


def test_the_sum_refuses_what_it_does_not_take(batches):
    b = batches["packed"]
    e, x = b.num_real_edges, _rows(b, torch.float32, "unit", 10)
    args = (b.edge_var, b.num_vars, e, b.var_ptr, b.var_perm)
    with pytest.raises(ValueError, match="x is"):
        reduce2d.segment_sum_2d(x[:-1], *args)
    with pytest.raises(ValueError, match="x must be"):
        reduce2d.segment_sum_2d(x.double(), *args)
    with pytest.raises(ValueError, match="ids must be"):
        reduce2d.segment_sum_2d(x, b.edge_var.float(), b.num_vars, e,
                                b.var_ptr, b.var_perm)
    with pytest.raises(ValueError, match="real rows"):
        reduce2d.segment_sum_2d(x, b.edge_var, b.num_vars, b.num_edges + 1,
                                b.var_ptr, b.var_perm)
