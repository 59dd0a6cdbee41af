"""The autograd rules of kernels 4 (5, 8), 6 and 7, on the CPU.

The Functions of `ops/reduce2d.py` (SegmentSum2d, Gather2d) and
`ops/reduce.py` run on the plain route here, the same logic the card
runs with the kernels. Their plain versions take f32 only, so they are
held against torch's autograd of the plain formula in f32
(index_add / index_select; to rtol 1e-6 / atol 1e-7: the same sums in
another order) rather than gradcheck in float64, and against jax.vjp of
the JAX kernels (`windowed_segment_sum_2d`, `windowed_gather_2d`,
`windowed_segment_sum_cols`, interpret mode) on a bucket-padded batch
(to rtol 1e-5 / atol 1e-6). Cotangents are zero on the padding rows of a
gather, as on every path of the port; a nonzero one raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import cnf_instance

from pdp_solver_tpu.fg.batch import pack_instances as jax_pack
from pdp_solver_tpu.ops.pallas_reduce import windowed_segment_sum_cols
from pdp_solver_tpu.ops.pallas_reduce2d import (
    windowed_gather_2d, windowed_segment_sum_2d)

from pdp_solver_tpu_torch.fg.batch import pack_instances
from pdp_solver_tpu_torch.modules import common
from pdp_solver_tpu_torch.ops import _build, reduce, reduce2d

TOL = dict(rtol=1e-6, atol=1e-7)
JTOL = dict(rtol=1e-5, atol=1e-6)


def _mixed(seed=1, ns=(20, 30, 25)):
    rng = np.random.default_rng(seed)
    insts = []
    for n in ns:
        clauses = []
        for k in rng.integers(2, 6, size=3 * n):
            vs = rng.choice(n, size=int(k), replace=False)
            clauses.append([int((v + 1) * s) for v, s in zip(
                vs, rng.integers(0, 2, size=int(k)) * 2 - 1)])
        insts.append(cnf_instance(n, clauses))
    return insts


@pytest.fixture(scope="module")
def packed():
    insts = _mixed()
    jb = jax_pack(insts)
    tb = pack_instances(insts, device="cpu")
    assert tb.num_real_edges < tb.num_edges   # padding rows present
    assert jb.fast_var and jb.fast_clause and tb.clause_width == 0
    return jb, tb


def _sides(tb):
    return {"var": (tb.edge_var, tb.edge_var32, tb.num_vars,
                    common.var_csr(tb)),
            "clause": (tb.edge_clause, tb.edge_clause32, tb.num_clauses,
                       common.clause_csr(tb))}


def _rand(shape, seed, lo=-1.0, hi=1.0):
    g = np.random.default_rng(seed)
    return torch.tensor(g.uniform(lo, hi, shape).astype(np.float32))


def _pad_zero(x, tb):
    x = x.clone()
    x[tb.num_real_edges:] = 0.0
    return x


@pytest.mark.parametrize("side", ["var", "clause"])
@pytest.mark.parametrize("d", [3, 16])
def test_segment_sum_2d_function_against_plain_autograd(packed, side, d):
    _, tb = packed
    ids, _, n, (nr, ptr, perm) = _sides(tb)[side]
    x = _rand((tb.num_edges, d), 1).requires_grad_()
    w = _rand((n, d), 2)
    out = reduce2d.segment_sum_2d(x, ids, n, nr, ptr, perm)
    assert type(out.grad_fn).__name__ == "SegmentSum2dBackward"
    (out * w).sum().backward()
    x2 = x.detach().clone().requires_grad_()
    ref = torch.zeros(n, d).index_add(0, ids[:nr], x2[:nr])
    (ref * w).sum().backward()
    torch.testing.assert_close(out, ref, **TOL)
    torch.testing.assert_close(x.grad, x2.grad, **TOL)
    assert not x.grad[nr:].any()


@pytest.mark.parametrize("side", ["var", "clause"])
@pytest.mark.parametrize("minus", [False, True])
@pytest.mark.parametrize("i32", [False, True])
def test_gather_2d_function_against_plain_autograd(packed, side, minus, i32):
    _, tb = packed
    ids64, ids32, n, csr = _sides(tb)[side]
    ids = ids32 if i32 else ids64
    d = 12
    nodes = _rand((n, d), 3).requires_grad_()
    sub = _rand((tb.num_edges, d), 4).requires_grad_() if minus else None
    w = _pad_zero(_rand((tb.num_edges, d), 5), tb)
    out = reduce2d.gather_2d(nodes, ids, sub, csr=csr)
    assert type(out.grad_fn).__name__ == "Gather2dBackward"
    (out * w).sum().backward()
    n2 = nodes.detach().clone().requires_grad_()
    s2 = sub.detach().clone().requires_grad_() if minus else None
    ref = n2.index_select(0, ids64)
    if minus:
        ref = ref - s2
    (ref * w).sum().backward()
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    torch.testing.assert_close(nodes.grad, n2.grad, **TOL)
    if minus:
        torch.testing.assert_close(sub.grad, s2.grad, rtol=0, atol=0)


def test_gather_2d_refuses_a_padding_cotangent(packed):
    _, tb = packed
    ids, ids32, n, csr = _sides(tb)["var"]
    nodes = _rand((n, 4), 3).requires_grad_()
    out = reduce2d.gather_2d(nodes, ids32, csr=csr)
    with pytest.raises(RuntimeError, match="padding row"):
        out.sum().backward()


def test_differentiable_gather_needs_its_csr(packed):
    _, tb = packed
    nodes = _rand((tb.num_vars, 4), 3).requires_grad_()
    with pytest.raises(ValueError, match="csr"):
        reduce2d.gather_2d(nodes, tb.edge_var32)
    with torch.no_grad():   # no grad: the plain call, no Function
        assert reduce2d.gather_2d(nodes, tb.edge_var32).grad_fn is None


def test_bf16_rows_that_require_grad_raise(packed):
    _, tb = packed
    ids, ids32, n, (nr, ptr, perm) = _sides(tb)["var"]
    x = _rand((tb.num_edges, 8), 1).bfloat16().requires_grad_()
    with pytest.raises(NotImplementedError, match="bf16"):
        reduce2d.segment_sum_2d(x, ids, n, nr, ptr, perm)
    nodes = _rand((n, 8), 3).requires_grad_()
    with pytest.raises(NotImplementedError, match="bf16"):
        reduce2d.gather_2d(nodes, ids32, x, csr=(nr, ptr, perm))


def test_backward_launch_counts_stay_zero_on_the_cpu(packed):
    _, tb = packed
    ids, ids32, n, (nr, ptr, perm) = _sides(tb)["var"]
    before = (dict(reduce2d.segment_sum_2d.launches_bwd),
              dict(reduce2d.gather_2d.launches_bwd))
    x = _rand((tb.num_edges, 8), 1).requires_grad_()
    agg = reduce2d.segment_sum_2d(x, ids, n, nr, ptr, perm)
    out = reduce2d.gather_2d(agg, ids32, x, csr=(nr, ptr, perm))
    (out * _pad_zero(_rand(out.shape, 2), tb)).sum().backward()
    assert (reduce2d.segment_sum_2d.launches_bwd,
            reduce2d.gather_2d.launches_bwd) == before


# ------------------------------------------------- against the JAX rules

@pytest.mark.parametrize("side", ["var", "clause"])
def test_sum_and_gather_vjps_match_jax(packed, side):
    jb, tb = packed
    ids, ids32, n, csr = _sides(tb)[side]
    jids = jb.edge_var if side == "var" else jb.edge_clause
    d = 10
    mask = tb.edge_mask[:, None]
    x = _rand((tb.num_edges, d), 6)
    g_nodes = _rand((n, d), 7)
    g_edges = _pad_zero(_rand((tb.num_edges, d), 8), tb)
    nodes = _rand((n, d), 9)

    # the aggregator's form: rows masked, summed, gathered back minus self
    def jf(x, nodes):
        xm = x * jnp.asarray(mask.numpy())
        s = windowed_segment_sum_2d(xm, jids, n, True)
        gat = windowed_gather_2d(nodes, jids, tb.num_edges, True) - xm
        return s, gat
    (js, jg), vjp = jax.vjp(jf, jnp.asarray(x.numpy()),
                            jnp.asarray(nodes.numpy()))
    jdx, jdn = vjp((jnp.asarray(g_nodes.numpy()),
                    jnp.asarray(g_edges.numpy())))

    xt = x.clone().requires_grad_()
    nt = nodes.clone().requires_grad_()
    xm = xt * mask
    s = reduce2d.segment_sum_2d(xm, ids, n, *csr)
    gat = reduce2d.gather_2d(nt, ids32, xm, csr=csr)
    ((s * g_nodes).sum() + (gat * g_edges).sum()).backward()
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(js), **JTOL)
    np.testing.assert_allclose(gat.detach().numpy(), np.asarray(jg), **JTOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), **JTOL)
    np.testing.assert_allclose(nt.grad.numpy(), np.asarray(jdn), **JTOL)


@pytest.mark.parametrize("side", ["var", "clause"])
def test_segment_sum_cols_vjp_matches_jax(packed, side):
    jb, tb = packed
    ids, _, n, (nr, ptr, perm) = _sides(tb)[side]
    jids = jb.edge_var if side == "var" else jb.edge_clause
    em = tb.edge_mask
    cols = [_rand((tb.num_edges,), s) for s in (10, 11)]
    g = _rand((2, n), 12)
    jem = jnp.asarray(em.numpy())

    def jf(a, b):
        return windowed_segment_sum_cols((a * jem, b * jem), jids, n, True)
    jout, vjp = jax.vjp(jf, *(jnp.asarray(c.numpy()) for c in cols))
    jda, jdb = vjp(jnp.asarray(g.numpy()))

    ct = [c.clone().requires_grad_() for c in cols]
    out = reduce.segment_sum_cols([c * em for c in ct], ids, n, nr, ptr,
                                  perm)
    (out * g).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **JTOL)
    np.testing.assert_allclose(ct[0].grad.numpy(), np.asarray(jda), **JTOL)
    np.testing.assert_allclose(ct[1].grad.numpy(), np.asarray(jdb), **JTOL)


# ------------------------------------------------- kernel 4's other forms

@pytest.mark.parametrize("shape", ["1d", "2d"])
def test_segment_sum_function_against_plain_autograd(packed, shape):
    _, tb = packed
    ids, _, n, (nr, ptr, perm) = _sides(tb)["var"]
    size = (tb.num_edges,) if shape == "1d" else (tb.num_edges, 3)
    x = _rand(size, 13).requires_grad_()
    w = _rand((n,) + size[1:], 14)
    out = reduce.segment_sum(x, ids, n, nr, ptr, perm)
    (out * w).sum().backward()
    x2 = x.detach().clone().requires_grad_()
    ref = torch.zeros((n,) + size[1:]).index_add(0, ids[:nr], x2[:nr])
    (ref * w).sum().backward()
    torch.testing.assert_close(out, ref, **TOL)
    torch.testing.assert_close(x.grad, x2.grad, **TOL)


def test_sorted_segment_sum_function_against_plain_autograd(packed):
    _, tb = packed
    ids = torch.sort(tb.edge_clause).values.clone()
    ids[-5:] = tb.num_clauses + 3        # out of range: dropped
    x = _rand((tb.num_edges,), 15).requires_grad_()
    w = _rand((tb.num_clauses,), 16)
    out = reduce.sorted_segment_sum(x, ids, tb.num_clauses)
    (out * w).sum().backward()
    keep = ids < tb.num_clauses
    expect = torch.where(keep, w[ids.clamp(max=tb.num_clauses - 1)],
                         torch.zeros(()))
    torch.testing.assert_close(x.grad, expect, rtol=0, atol=0)


# ------------------------------------------------- the launch guard

def test_refuse_grad_checks_grad_mode_and_inputs():
    a = torch.ones(3, requires_grad=True)
    b = torch.ones(3)
    with pytest.raises(RuntimeError, match="kernel_x: an input requires"):
        _build.refuse_grad("kernel_x", (b, a))
    _build.refuse_grad("kernel_x", (b, a.detach(), None))
    with torch.no_grad():
        _build.refuse_grad("kernel_x", (a,))
