"""The one-cluster-an-instance kernels (kernel 9, `csrc/sp_sweep.cu`, and
kernel 10, `csrc/verify.cu`) on the CPU: how they split an instance among
the CTAs of its cluster, the cluster size they take, and their launch
plans.

Kernel 9 deals an instance's variables to its cluster's CTAs in shares,
each CTA taking its variables in the group walk's order (G lanes a
variable, 128 / G variables a round on half the CTA's warps, or 256 / G on
all of them when a variable may be heavy, the xor butterfly), and deals
the instance's heavy pieces (the multiples of S = PDP_HEAVY_ITERS * G
inside a heavy variable) round the cluster; the CTA that owns a heavy
variable adds its pieces' totals in anchor order. That split is emulated
here in numpy float32, step for step, and must give `walk_order_sum`'s
bits, whichever the cluster size, on the shared set, a compacted batch
(its first 8 instances) and a batch with one 4,000-edge variable cut in
pieces. Both kernels write the edges of their CTA's clauses and padding
clusters write the padding edges in chunks: every clause is counted once
and every edge written once, padding included, for every cluster size.
"""

import os
import re

import numpy as np
import pytest
import torch

from tests.test_torch_chained import (
    _butterfly, _group, _hub, _sp_terms)

from pdp_solver_tpu_torch.fg.batch import pack_instances
from pdp_solver_tpu_torch.ops import _build, fused, reduce, sp_sweep, verify
from pdp_solver_tpu_torch.problem.state import init_problem_state
from pdp_solver_tpu_torch.utils.benchdata import make_ksat_set

THREADS = _build.THREADS
CSRC = os.path.join(os.path.dirname(__file__), os.pardir,
                    "pdp_solver_tpu_torch", "csrc")
CLUSTERS = [1, 2, 4, 8, 16]
H100_SMS = 132


def _define(source, name):
    """The value of `#define name <int>` in csrc/source."""
    text = open(os.path.join(CSRC, source)).read()
    return int(re.search(r"#define %s (\d+)" % name, text).group(1))


@pytest.fixture(scope="module")
def batches():
    insts = make_ksat_set()
    return {"shared": pack_instances(insts, device="cpu"),
            "compacted": pack_instances(insts[:8], device="cpu"),
            "hub": _hub(np.random.default_rng(3))}


def _share(n, r, cs):
    """common.cuh cluster_share."""
    return n * r // cs


def _piece(terms, perm, j0, j1):
    """One heavy piece's totals as one CTA takes it: thread t its slots
    j0 + t, j0 + t + THREADS, ..., a butterfly in each warp, the warp
    totals in warp order."""
    acc = np.zeros((terms.shape[0], THREADS), np.float32)
    for j in range(j0, j1, THREADS):
        t = np.arange(min(THREADS, j1 - j))
        acc[:, t] = acc[:, t] + terms[:, perm[j + t]]
    warps = _butterfly(acc.reshape(-1, THREADS // 32, 32), 32)
    tot = warps[:, 0, 0]
    for w in range(1, THREADS // 32):
        tot = tot + warps[:, w, 0]
    return tot


def _sweep_cluster(terms, batch, cs):
    """csrc/sp_sweep.cu's variable sums for clusters of cs CTAs:
    f32[2, V], with the CTA that took each variable and each piece."""
    G = _group(batch)
    S = _build.HEAVY_ITERS * G
    heavy = batch.var_max_degree >= S
    ptr = batch.var_ptr.numpy().astype(np.int64)
    perm = batch.var_perm.numpy().astype(np.int64)
    ev = batch.edge_var.numpy()
    ivp = batch.inst_var_ptr.numpy()
    out = np.full((2, batch.num_vars), np.nan, np.float32)
    owner = np.full(batch.num_vars, -1)
    piece_by = {}
    # the walk runs on warps 4-7 beside the clauses, or on the whole CTA
    # when a variable may be heavy
    per_round = (THREADS if heavy else THREADS // 2) // G
    for b in range(batch.batch_size):
        vb, nv = int(ivp[b]), int(ivp[b + 1] - ivp[b])
        for r in range(cs):
            va, vz = vb + _share(nv, r, cs), vb + _share(nv, r + 1, cs)
            assert (owner[va:vz] == -1).all()
            owner[va:vz] = r
            for base in range(va, vz, per_round):
                v = np.arange(base, min(base + per_round, vz))
                lo, hi = ptr[v], ptr[v + 1]
                mine = (hi - lo < S) | (not heavy)
                acc = np.zeros((2, v.shape[0], G), np.float32)
                for k in range(-(-int(((hi - lo) * mine).max(initial=0))
                                 // G)):
                    j = lo[:, None] + np.arange(G) + k * G
                    take = (j < hi[:, None]) & mine[:, None]
                    e = perm[np.where(take, j, 0)]
                    acc = acc + np.where(take, terms[:, e], np.float32(0))
                acc = _butterfly(acc, G)
                out[:, v[mine]] = acc[:, mine, 0]
        if not heavy:
            continue
        # the pieces dealt round the cluster, totals by anchor
        s0, s1 = int(ptr[vb]), int(ptr[vb + nv])
        pieces = {}
        for r in range(cs):
            for s in range((-(-s0 // S) + r) * S, s1, cs * S):
                v = int(ev[perm[s]])
                lo, hi = int(ptr[v]), int(ptr[v + 1])
                if hi - lo < S:
                    continue
                a0 = -(-lo // S)
                assert s // S not in piece_by
                piece_by[s // S] = r
                pieces[s // S] = _piece(terms, perm,
                                        lo if s // S == a0 else s,
                                        min(s + S, hi))
        # each owner adds its heavy variables' pieces in anchor order
        for v in range(vb, vb + nv):
            lo, hi = int(ptr[v]), int(ptr[v + 1])
            if hi - lo < S:
                continue
            a0, a1 = -(-lo // S), (hi - 1) // S
            run = pieces[a0]
            for k in range(a0 + 1, a1 + 1):
                run = run + pieces[k]
            out[:, v] = run
    return out, owner, piece_by


@pytest.mark.parametrize("cs", CLUSTERS)
@pytest.mark.parametrize("which", ["shared", "compacted", "hub"])
def test_cluster_sums_are_the_walks(batches, which, cs):
    """Kernel 9's variable sums, split over a cluster of cs CTAs, equal
    the walk's order bit for bit; every real variable goes to one CTA,
    and on the hub every piece of its heavy variable to one CTA, dealt
    round the cluster."""
    b = batches[which]
    terms = _sp_terms(b, 17)
    lo, hi = reduce.csr_bounds(b.var_ptr)
    walk = reduce.walk_order_sum(terms, lo, hi, b.var_perm.long(),
                                 _group(b)).numpy()
    got, owner, piece_by = _sweep_cluster(terms.numpy(), b, cs)
    real = b.var_mask.numpy() > 0
    assert (owner[real] >= 0).all() and (owner[real] < cs).all()
    assert np.array_equal(got[:, real].view(np.int32),
                          walk[:, real].view(np.int32))
    if which == "hub":
        S = _build.HEAVY_ITERS * _group(b)
        v = int(np.argmax(np.diff(b.var_ptr.numpy())))
        lo_v, hi_v = int(b.var_ptr[v]), int(b.var_ptr[v + 1])
        anchors = range(-(-lo_v // S), (hi_v - 1) // S + 1)
        assert sorted(piece_by) == list(anchors) and len(anchors) > 1
        assert set(piece_by.values()) == set(range(min(cs, len(anchors))))
    else:
        assert piece_by == {}


def _edge_split(batch, cs, chunk):
    """The edges each CTA of each cluster writes in kernels 9 and 10: an
    instance cluster's CTA r the edges of its clause share, a padding
    cluster's CTA r its chunk of the padding edges. Also how many times
    each real clause is counted. Clusters serve the real instances only,
    which come first: the padding rows after them hold no clause."""
    cp = batch.clause_ptr.numpy().astype(np.int64)
    icp = batch.inst_clause_ptr.numpy().astype(np.int64)
    E, e_real = batch.num_edges, batch.num_real_edges
    B = batch.num_instances  # the kernels launch the real instances
    written = np.zeros(E, np.int64)
    counted = np.zeros(batch.num_clauses, np.int64)
    n_pad = -(-(E - e_real) // chunk)
    for q in range(B + -(-n_pad // cs)):
        for r in range(cs):
            if q < B:
                c0, nc = int(icp[q]), int(icp[q + 1] - icp[q])
                ca, cb = c0 + _share(nc, r, cs), c0 + _share(nc, r + 1, cs)
                counted[ca:cb] += 1
                written[cp[ca]:cp[cb]] += 1
            else:
                e0 = e_real + ((q - B) * cs + r) * chunk
                written[e0:min(E, e0 + chunk)] += 1
    return written, counted


@pytest.mark.parametrize("cs", CLUSTERS)
@pytest.mark.parametrize("which", ["shared", "compacted", "hub"])
@pytest.mark.parametrize("source,chunk", [
    ("sp_sweep.cu", "PDP_SWEEP_PAD_CHUNK"),
    ("verify.cu", "PDP_VERIFY_PAD_CHUNK")])
def test_every_clause_counted_and_every_edge_written_once(batches, which,
                                                          cs, source, chunk):
    b = batches[which]
    icp = b.inst_clause_ptr.numpy()
    assert (icp[b.num_instances:] == b.num_real_clauses).all()
    written, counted = _edge_split(b, cs, _define(source, chunk))
    assert b.num_edges > b.num_real_edges
    assert (written == 1).all()
    f = b.num_real_clauses
    assert (counted[:f] == 1).all() and (counted[f:] == 0).all()


def test_cluster_size_rule(batches):
    """Powers of two from 1 to 16: the shared set (128 instances) takes 4,
    a compacted batch of 8 instances 8 for kernel 9 and 4 for kernel 10
    (two edges a thread), one instance of 190,464 edges 16, one instance
    of 720 edges 2 and 1; fewer SMs, smaller clusters."""
    hub = pack_instances([(300, 63488, np.stack([
        np.random.default_rng(5).integers(1, 300, 63488 * 3),
        np.repeat(np.arange(63488), 3)]).astype(np.int32),
        np.ones(63488 * 3, np.float32), -1.0)], device="cpu")
    small = pack_instances(make_ksat_set(count=1, n=20), device="cpu")
    cases = {"shared": (batches["shared"], 4, 4),
             "compacted": (batches["compacted"], 8, 4),
             "hub": (hub, 16, 16), "small": (small, 2, 1)}
    for name, (b, k9, k10) in cases.items():
        got9 = _build.cluster_size(b, H100_SMS)
        got10 = _build.cluster_size(b, H100_SMS, min_share=2 * THREADS)
        assert (got9, got10) == (k9, k10), name
    assert batches["shared"].num_instances == 128
    assert batches["compacted"].num_instances == 8
    assert batches["compacted"].batch_size > 8
    assert _build.cluster_size(batches["shared"], 16) == 1
    for n in (1, 3, 64, 300):
        b = pack_instances(make_ksat_set(count=n, n=30), device="cpu")
        cs = _build.cluster_size(b, H100_SMS)
        assert cs in CLUSTERS and cs <= _define("common.cuh",
                                                "PDP_CLUSTER_MAX")


def _sweep_cols(b):
    g = torch.Generator().manual_seed(2)
    cols = {n: torch.rand(b.num_edges, generator=g) for n in sp_sweep._COLS}
    cols["sign"] = b.edge_sign
    return cols


def test_sweep_plan_is_cached_and_checks(batches):
    """One plan per batch, no argument block on the CPU; a wrong shape,
    dtype or device raises, before and after good calls."""
    b, other = batches["compacted"], batches["hub"]
    cols = _sweep_cols(b)
    ref = sp_sweep.sp_full_sweep(b, **cols)
    plan = sp_sweep._plan(b)
    assert sp_sweep._plan(b) is plan and sp_sweep._plan(other) is not plan
    assert plan.args is None and plan.shape == (b.num_edges,)
    for name in sp_sweep._COLS:
        x = cols[name]
        for bad in (x[:-1], x.double(), x.to("meta")):
            with pytest.raises(ValueError):
                sp_sweep.sp_full_sweep(b, **dict(cols, **{name: bad}))
    got = sp_sweep.sp_full_sweep(b, **cols)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.parametrize("k", [8, 9])
def test_sweep_refuses_clauses_wider_than_its_tile(k):
    """Kernel 9's clause tile holds a CTA's clauses of at most
    PDP_SWEEP_MAX_K literals: the plan refuses a batch with wider ones on
    either device, and the route never sends it one."""
    assert sp_sweep.MAX_WIDTH == _define("sp_sweep.cu", "PDP_SWEEP_MAX_K")
    assert max(fused.CHAINED_WIDTHS) <= sp_sweep.MAX_WIDTH
    b = pack_instances(make_ksat_set(count=2, n=20, alpha=2.0, k=k),
                       device="cpu")
    assert b.clause_max_degree == k
    cols = _sweep_cols(b)
    if k <= sp_sweep.MAX_WIDTH:
        assert len(sp_sweep.sp_full_sweep(b, **cols)) == 4
    else:
        with pytest.raises(ValueError, match="at most 8 literals"):
            sp_sweep.sp_full_sweep(b, **cols)


def test_verify_plan_is_cached_and_checks(batches):
    b, other = batches["compacted"], batches["hub"]
    problem = init_problem_state(b)
    act = b.instance_mask.clone()
    pred = torch.rand(b.num_vars, 1, generator=torch.Generator()
                      .manual_seed(4))
    ref = verify.verify_and_masks(b, problem, act, pred)
    plan = verify._plan(b)
    assert verify._plan(b) is plan and verify._plan(other) is not plan
    assert plan.args is None
    assert plan.sizes == (b.num_vars, b.num_clauses, b.batch_size,
                          b.num_edges)
    bad = [(problem, act, pred[:, 0]), (problem, act[:-1], pred),
           (problem, act.double(), pred), (problem, act.to("meta"), pred),
           (problem.replace(active_vars=problem.active_vars[:-1]), act,
            pred),
           (problem.replace(active_clauses=problem.active_clauses.long()),
            act, pred)]
    for case in bad:
        with pytest.raises(ValueError):
            verify.verify_and_masks(b, *case)
    got = verify.verify_and_masks(b, problem, act, pred)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
