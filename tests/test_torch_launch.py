"""The host side of the group walk (`csrc/common.cuh`) and of the launch
plans of `ops/reduce.py` and `ops/fused.py`, on the CPU.

The walk gives each node a group of G lanes (G from the mean degree), and
splits each node of S = HEAVY_ITERS * G edges or more among the blocks
anchored on the multiples of S inside it. These tests hold the PyTorch
statement of that split (`anchor_segments`, `heavy_pieces`,
`walk_order_sum`) to: every real edge summed exactly once, no padding
edge, each worker's edges in CSR order; sums equal to index_add_ exactly
on integer-valued columns and to rtol 1e-5 / atol 1e-6 on floats (another
order); and, for sorted ids, equal to the JAX package's
`sorted_segment_sum` (interpret mode). Cases: the shared set's full
shapes (var and clause CSR, and the sorted clause ids with the padding's
63,488-edge last run), a ragged batch of mixed clause widths, and a batch
with one 4,000-edge variable. The plans: cached per batch or index
tensors, and raising on a wrong shape, dtype or device as the wrappers did;
the pack-time largest degrees that let a launch skip the anchored blocks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdp_solver_tpu.ops import pallas_segment

from pdp_solver_tpu_torch.fg.batch import pack_instances
from pdp_solver_tpu_torch.ops import _build, fused, reduce
from pdp_solver_tpu_torch.utils.benchdata import make_ksat_set

FLOAT = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def shared():
    return pack_instances(make_ksat_set(), device="cpu")


def _ragged(rng, count=6, n=300, m=500):
    insts = []
    for _ in range(count):
        widths = rng.integers(1, 7, size=m)
        ev = rng.integers(0, n, size=int(widths.sum())).astype(np.int32)
        ec = np.repeat(np.arange(m, dtype=np.int32), widths)
        signs = rng.choice([-1.0, 1.0], ev.shape[0]).astype(np.float32)
        insts.append((n, m, np.stack([ev, ec]), signs, -1.0))
    return pack_instances(insts, device="cpu")


def _hub(rng, n=200, m=4400, k=3, degree=4000):
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
def batches(shared):
    rng = np.random.default_rng(3)
    return {"shared": shared, "ragged": _ragged(rng), "hub": _hub(rng)}


def _form(batch, side):
    """(lo, hi, slot_edge, node_at, n_slots, ids) of one CSR of a batch."""
    e = batch.num_real_edges
    if side == "var":
        lo, hi = reduce.csr_bounds(batch.var_ptr)
        slot_edge = batch.var_perm.long()
        ids = batch.edge_var
        return lo, hi, slot_edge, ids[slot_edge], e, ids
    lo, hi = reduce.csr_bounds(batch.clause_ptr)
    ids = batch.edge_clause
    return lo, hi, None, ids[:e], e, ids


def _sorted_form(batch):
    """The shared set's clause ids over all E edges, padding included: its
    last run holds the last clause's edges and every padding edge."""
    ids = batch.edge_clause
    lo, hi = reduce.sorted_bounds(ids, batch.num_clauses)
    return lo, hi, None, ids, ids.shape[0], ids


def _case(batches, name):
    which, side = name.split("-")
    batch = batches[which]
    if side == "sorted":
        return batch, _sorted_form(batch)
    return batch, _form(batch, side)


CASES = ["shared-var", "shared-clause", "shared-sorted", "ragged-var",
         "ragged-clause", "hub-var"]


def test_group_width():
    """G is a power of two from 4 to 32, about a quarter of the mean
    degree: 8 for the shared set's var CSR, 4 for its clause CSR."""
    b = pack_instances(make_ksat_set(count=128), device="cpu")
    assert _build.group_width(b.num_real_edges, b.num_vars) == 8
    assert _build.group_width(b.num_real_edges, b.num_clauses) == 4
    assert _build.group_width(0, 10) == 4
    assert _build.group_width(0, 0) == 4
    assert _build.group_width(10 ** 6, 10) == 32
    for mean in (1, 5, 16, 17, 40, 64, 65, 127, 129, 1000):
        g = _build.group_width(mean * 100, 100)
        assert g in (4, 8, 16, 32)
        assert g == 4 or 4 * (g // 2) < mean


@pytest.mark.parametrize("name", CASES)
def test_walk_split_covers_each_real_edge_once(batches, name):
    """Light nodes' groups and the heavy nodes' pieces, one per anchored
    block inside the node, together take every slot of the CSR once, each
    worker in CSR order, and only real edges (the sorted form takes every
    id, padding runs included); each heavy node's anchored blocks are its
    pieces, in order."""
    batch, (lo, hi, slot_edge, node_at, n_slots, _) = _case(batches, name)
    g = _build.group_width(n_slots, lo.shape[0])
    S = _build.HEAVY_ITERS * g
    anchors = reduce.anchor_segments(lo, hi, n_slots, g, node_at)
    heavy = torch.nonzero(hi - lo >= S)[:, 0]
    workers = [torch.arange(int(lo[n]), int(hi[n]))
               for n in torch.nonzero(hi - lo < S)[:, 0].tolist()]
    for n in heavy.tolist():
        pieces = reduce.heavy_pieces(int(lo[n]), int(hi[n]), S)
        mine = torch.nonzero(anchors == n)[:, 0].tolist()
        assert mine == list(range(-(-int(lo[n]) // S),
                                  (int(hi[n]) - 1) // S + 1))
        assert len(mine) == len(pieces) >= 2
        assert pieces[0][0] == int(lo[n]) and pieces[-1][1] == int(hi[n])
        workers += [torch.arange(j0, j1) for j0, j1 in pieces]
    assert set(anchors[anchors >= 0].tolist()) == set(heavy.tolist())
    slots = torch.cat(workers)
    assert torch.equal(torch.sort(slots).values, torch.arange(n_slots))
    if name.endswith("sorted"):
        # every id lies in [0, N), so the runs cover every slot
        last = batch.num_real_clauses - 1
        assert int(hi[last] - lo[last]) == 4 + batch.num_edges - \
            batch.num_real_edges
        assert heavy.tolist() == [last]
        return
    assert n_slots == batch.num_real_edges
    edges = slots if slot_edge is None else slot_edge[slots]
    assert int(edges.max()) < batch.num_real_edges
    for w in workers:
        e = w if slot_edge is None else slot_edge[w]
        assert bool((e[1:] > e[:-1]).all()), "CSR order"
    if name == "hub-var":
        assert int((hi - lo).max()) == 4000 and heavy.numel() == 1
        assert batch.var_max_degree == 4000


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("name", CASES)
def test_walk_order_sum_matches_index_add(batches, name, integer):
    """The kernel's order, emulated: exact against index_add_ on
    integer-valued columns, to rtol 1e-5 / atol 1e-6 on floats."""
    batch, (lo, hi, slot_edge, node_at, n_slots, ids) = _case(batches, name)
    g = _build.group_width(n_slots, lo.shape[0])
    gen = torch.Generator().manual_seed(len(name) + integer)
    E = batch.num_edges
    x = (torch.randint(-3, 4, (2, E), generator=gen).float() if integer
         else torch.rand(2, E, generator=gen))
    got = reduce.walk_order_sum(x, lo, hi, slot_edge, g)
    if name.endswith("sorted"):
        ref = torch.stack([reduce.sorted_segment_sum_plain(c, ids,
                                                           lo.shape[0])
                           for c in x])
    else:
        ref = reduce.segment_sum_cols_plain(list(x), ids, lo.shape[0],
                                            batch.num_real_edges)
    assert bool(torch.isfinite(got).all())
    if integer:
        assert torch.equal(got, ref)
    else:
        torch.testing.assert_close(got, ref, **FLOAT)


def test_walk_order_sum_matches_jax_sorted_segment_sum():
    """Sorted ids with one long run and an id past the last segment: the
    emulated walk and the wrapper against the JAX kernel (interpret mode),
    exactly on integer values. (A negative id is left out: the JAX kernel
    takes its window base from the smallest id, and with -1 it does not
    give a segment sum; the port drops such ids.)"""
    rng = np.random.default_rng(4)
    n = 300
    ids = np.sort(np.concatenate([rng.integers(0, n, 2000),
                                  np.full(1500, 7), [n + 2]]))
    x = rng.integers(-4, 5, ids.shape[0]).astype(np.float32)
    ref = pallas_segment.sorted_segment_sum(
        jnp.asarray(x), jnp.asarray(ids.astype(np.int32)), n,
        interpret=True)
    tids = torch.from_numpy(ids)
    lo, hi = reduce.sorted_bounds(tids, n)
    g = _build.group_width(ids.shape[0], n)
    anchors = reduce.anchor_segments(lo, hi, ids.shape[0], g, tids)
    assert anchors.tolist().count(7) >= 2, "the long run is cut in pieces"
    got = reduce.walk_order_sum(torch.from_numpy(x)[None], lo, hi, None,
                                g)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        reduce.sorted_segment_sum(torch.from_numpy(x), tids, n).numpy(),
        np.asarray(ref))


def test_sorted_quick_reject_keeps_every_piece(batches):
    """The sorted form's two-load early exit never drops an anchor inside
    a heavy run: on the padded clause ids, and on ids with runs of every
    length around the stride."""
    b = batches["shared"]
    cases = [(b.edge_clause, b.num_clauses)]
    rng = np.random.default_rng(5)
    # mostly short runs (G = 4, S = 512) and some of 256 to 1,600 slots
    runs = rng.permutation(np.concatenate([rng.integers(1, 9, 2000),
                                           rng.integers(256, 1600, 20)]))
    cases.append((torch.from_numpy(np.repeat(np.arange(2020), runs)), 2020))
    for ids, n in cases:
        lo, hi = reduce.sorted_bounds(ids, n)
        g = _build.group_width(ids.shape[0], n)
        anchors = reduce.anchor_segments(lo, hi, ids.shape[0], g, ids)
        assert _build.HEAVY_ITERS * g == 512
        reject = reduce.sorted_quick_reject(ids, n, g)
        assert not bool((reject & (anchors >= 0)).any())
        assert int((anchors >= 0).sum()) > int(
            (hi - lo >= _build.HEAVY_ITERS * g).sum())


def test_reduce_plan_is_cached_and_checks(batches):
    b = batches["ragged"]
    args = (b.edge_var, b.num_vars, b.num_real_edges, b.var_ptr, b.var_perm)
    p1 = reduce._plan("t", *args)
    assert reduce._plan("t", *args) is p1
    assert reduce._plan("t", b.edge_clause, b.num_clauses, b.num_real_edges,
                        b.clause_ptr, None) is not p1
    assert p1.group == _build.group_width(b.num_real_edges, b.num_vars)
    assert p1.args is None, "no argument block for CPU tensors"
    col = torch.ones(b.num_edges)
    with pytest.raises(ValueError):
        reduce.segment_sum_cols([col], b.edge_var, b.num_vars,
                                b.num_real_edges, b.var_ptr.long(),
                                b.var_perm)
    with pytest.raises(ValueError):
        reduce.segment_sum_cols([col], b.edge_var, b.num_vars,
                                b.num_real_edges, b.var_ptr, b.var_perm[1:])
    with pytest.raises(ValueError):
        reduce.segment_sum_cols([col.double()], *args)
    with pytest.raises(ValueError):
        reduce.segment_sum_cols([col.to("meta")], *args)
    with pytest.raises(ValueError):
        reduce.segment_sum(col.to("meta"), *args)
    with pytest.raises(ValueError):
        reduce.sorted_segment_sum(col, b.edge_var.float(), b.num_vars)
    # the plan survives good calls in between and still checks
    out = reduce.segment_sum_cols([col], *args)
    assert torch.equal(out[0], reduce.segment_sum_cols_plain(
        [col], b.edge_var, b.num_vars, b.num_real_edges)[0])
    with pytest.raises(ValueError):
        reduce.segment_sum_cols([col[:-1]], *args)


@pytest.mark.parametrize("fn", fused.FUSED_FNS + fused.CHAINED_FNS,
                         ids=lambda f: f.name)
def test_fused_plan_is_cached_per_batch_and_checks(batches, fn):
    b, other = batches["shared"], batches["ragged"]
    call = (fused.fused_edge_pass if fn in fused.FUSED_FNS
            else fused.chained_edge_pass)
    sizes = {"V": b.num_vars, "F": b.num_clauses, "E": b.num_edges}
    ins = [torch.rand(sizes[k]) for k in fn.layout]
    call(fn, b, ins)
    plan = fused._plan(fn, b, fn in fused.FUSED_FNS)
    assert fused._plan(fn, b, fn in fused.FUSED_FNS) is plan
    assert fused._plan(fn, other, fn in fused.FUSED_FNS) is not plan
    bad = [ins[:-1], [ins[0][:-1]] + ins[1:], [ins[0].double()] + ins[1:],
           [ins[0].to("meta")] + ins[1:]]
    for case in bad:
        with pytest.raises(ValueError):
            call(fn, b, case)
    # a strided input is taken (made contiguous) and gives the same result
    wide = torch.stack([ins[0], ins[0]], 1)[:, 0]
    assert not wide.is_contiguous()
    got, ref = call(fn, b, [wide] + ins[1:]), call(fn, b, ins)
    for g, r in zip(got, ref):
        if isinstance(g, tuple):
            assert all(torch.equal(u, v) for u, v in zip(g, r))
        elif g is not None:
            assert torch.equal(g, r)


def test_walk_scratch_only_where_a_node_can_be_heavy(batches):
    """The pack-time largest degrees: a launch gets anchored blocks and
    their scratch only when some node can reach the heavy stride, or when
    the largest degree is not known."""
    for which, side in (("shared", "var"), ("shared", "clause"),
                        ("ragged", "var"), ("hub", "var")):
        b = batches[which]
        ptr = b.var_ptr if side == "var" else b.clause_ptr
        top = int((ptr[1:] - ptr[:-1]).max())
        assert top == getattr(b, f"{side}_max_degree")
        g = _build.group_width(b.num_real_edges, ptr.shape[0] - 1)
        a = _build.SegSumArgs()
        scratch = _build.walk_scratch(a, b.num_real_edges, g, top, "cpu")
        assert a.heavy == (top >= _build.HEAVY_ITERS * g) == (which == "hub")
        if a.heavy:
            partials, counters = scratch
            n = -(-b.num_real_edges // (_build.HEAVY_ITERS * g))
            assert partials.shape == (n * _build.WALK_MAXR,)
            assert counters.shape == (n,) and not bool(counters.any())
            assert (a.partials, a.counters) == (partials.data_ptr(),
                                                counters.data_ptr())
        else:
            assert scratch == () and a.partials is None
    a = _build.FusedArgs()
    assert len(_build.walk_scratch(a, 1000, 4, None, "cpu")) == 2
    assert a.heavy == 1
