"""The chained edge pass's var phase on the group walk (kernel 2), the
one-launch SP sweep's order (kernel 9), and the launch plans of the
chained pass and the [E, d] gather (kernel 7), on the CPU.

The card's chained pass takes each variable sum in the group walk's order
(`csrc/common.cuh`); `fused.chained_vred_walk_order` repeats it over the
plain version's f3 terms. These tests hold that emulation to the plain
version's `vred`: exactly for `sround` and `ws_chain` (integer-valued
terms), to rtol 1e-5 / atol 1e-6 for `sp_chain` and `sp_chain_login`
(another order), on the shared set, a compacted batch (its first 8
instances) and a batch with one 4,000-edge variable (cut in pieces).
Kernel 9 takes the same order inside its one CTA an instance (G lanes a
variable, the heavy variables piece by piece at the multiples of S in
the instance's slots) and, for a padding edge of another variable than
the last real one, one thread repeating it lane by lane: both are
emulated here in numpy float32, step for step as `csrc/sp_sweep.cu` takes
them, and must equal `walk_order_sum` bit for bit. The argument blocks
of the C entry points must list the fields of their C structures in
order. The gather takes i32 ids (as the JAX kernel does) as well as i64,
with the same result, and equal to the JAX package's `windowed_gather_2d`
in interpret mode.
"""

import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdp_solver_tpu.ops.pallas_reduce2d import windowed_gather_2d

from pdp_solver_tpu_torch.fg.batch import pack_instances
from pdp_solver_tpu_torch.ops import _build, fused, reduce, reduce2d
from pdp_solver_tpu_torch.utils.benchdata import make_ksat_set

FLOAT = dict(rtol=1e-5, atol=1e-6)
THREADS = reduce.THREADS
CSRC = os.path.join(os.path.dirname(__file__), os.pardir,
                    "pdp_solver_tpu_torch", "csrc")


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
def batches():
    insts = make_ksat_set()
    return {"shared": pack_instances(insts, device="cpu"),
            "compacted": pack_instances(insts[:8], device="cpu"),
            "hub": _hub(np.random.default_rng(3))}


def _inputs(fn, batch, seed):
    """Columns drawn like the ones they stand for (as chip_smoke.py draws
    them): the batch's signs and masks, 0/1 flags, +-1 assignments,
    solutions in {0, 0.5, 1}, log u, floats in (0.02, 0.98)."""
    g = torch.Generator().manual_seed(seed)
    sizes = {"V": batch.num_vars, "F": batch.num_clauses,
             "E": batch.num_edges}
    real = {"V": batch.var_mask, "F": batch.clause_mask,
            "E": batch.edge_mask}
    out = []
    for kind, name in zip(fn.layout, fn.inputs):
        u = torch.rand(sizes[kind], generator=g)
        if name == "sign":
            x = batch.edge_sign
        elif name == "mask":
            x = batch.edge_mask
        elif name == "sa":
            x = torch.where(u > 0.5, 1.0, -1.0) * real[kind]
        elif name in ("em", "av", "ac", "cm"):
            x = (u > 0.2).float() * real[kind]
        elif name == "sol":
            x = torch.floor(u * 3.0) / 2.0
        elif name == "log_u_in":
            x = torch.log(u * 0.96 + 0.02)
        else:
            x = u * 0.96 + 0.02
        out.append(x)
    return out


def _group(batch):
    return _build.group_width(batch.num_real_edges, batch.num_vars)


VAR_CHAINS = [f for f in fused.CHAINED_FNS if f.n_vred]


def test_the_hub_has_a_heavy_variable(batches):
    b = batches["hub"]
    assert b.var_max_degree == 4000
    assert b.var_max_degree >= _build.HEAVY_ITERS * _group(b)
    for name in ("shared", "compacted"):
        b = batches[name]
        assert b.var_max_degree < _build.HEAVY_ITERS * _group(b)


@pytest.mark.parametrize("which", ["shared", "compacted", "hub"])
@pytest.mark.parametrize("fn", VAR_CHAINS, ids=lambda f: f.name)
def test_chained_var_walk_matches_plain(batches, which, fn):
    """The var walk's order over each functor's f3 terms: exact for the
    integer functors, to rtol 1e-5 / atol 1e-6 for SP; nodes with no edge
    0."""
    b = batches[which]
    ins = _inputs(fn, b, len(fn.name))
    got = fused.chained_vred_walk_order(fn, b, ins)
    _, ref, _, _ = fused.chained_edge_pass_plain(fn, b, ins)
    assert got.shape == (fn.n_vred, b.num_vars)
    assert bool(torch.isfinite(got).all())
    if fn.name in ("sround", "ws_chain"):
        assert torch.equal(got, ref)
        assert bool(got.any())
    else:
        torch.testing.assert_close(got, ref, **FLOAT)
    empty = b.var_ptr[1:] == b.var_ptr[:-1]
    assert bool((got[:, empty] == 0).all())


# --- kernel 9's order, emulated step for step -----------------------------

def _butterfly(x, width):
    """A xor butterfly over the last axis's lanes [0, width) (the
    shuffles: lane l gets x[l] + x[l ^ off])."""
    lane = np.arange(x.shape[-1])
    off = width // 2
    while off:
        x = x + x[..., lane ^ off]
        off //= 2
    return x


def _sweep_cta(terms, batch):
    """csrc/sp_sweep.cu cta_var_sums for every instance: f32[2, V]."""
    G = _group(batch)
    S = _build.HEAVY_ITERS * G
    heavy = batch.var_max_degree >= S
    ptr = batch.var_ptr.numpy().astype(np.int64)
    perm = batch.var_perm.numpy().astype(np.int64)
    ev = batch.edge_var.numpy()
    ivp = batch.inst_var_ptr.numpy()
    out = np.full((2, batch.num_vars), np.nan, np.float32)
    per_round = THREADS // G
    for b in range(batch.batch_size):
        vb, nv = int(ivp[b]), int(ivp[b + 1] - ivp[b])
        for base in range(0, nv, per_round):
            v = vb + np.arange(base, min(base + per_round, nv))
            lo, hi = ptr[v], ptr[v + 1]
            mine = (hi - lo < S) | (not heavy)
            acc = np.zeros((2, v.shape[0], G), np.float32)
            for k in range(-(-int(((hi - lo) * mine).max(initial=0)) // G)):
                j = lo[:, None] + np.arange(G) + k * G
                take = (j < hi[:, None]) & mine[:, None]
                e = perm[np.where(take, j, 0)]
                acc = acc + np.where(take, terms[:, e], np.float32(0))
            acc = _butterfly(acc, G)
            out[:, v[mine]] = acc[:, mine, 0]
        if not heavy:
            continue
        run = None
        s1 = int(ptr[vb + nv])
        for s in range(-(-int(ptr[vb]) // S) * S, s1, S):
            v = int(ev[perm[s]])
            lo, hi = int(ptr[v]), int(ptr[v + 1])
            if hi - lo < S:
                continue
            a0, a1, k = -(-lo // S), (hi - 1) // S, s // S
            j0, j1 = (lo if k == a0 else s), min(s + S, hi)
            acc = np.zeros((2, THREADS), np.float32)
            for j in range(j0, j1, THREADS):
                t = np.arange(min(THREADS, j1 - j))
                acc[:, t] = acc[:, t] + terms[:, perm[j + t]]
            warps = _butterfly(acc.reshape(2, THREADS // 32, 32), 32)
            tot = warps[:, 0, 0]
            for w in range(1, THREADS // 32):
                tot = tot + warps[:, w, 0]
            run = tot if k == a0 else run + tot
            if k == a1:
                out[:, v] = run
    return out


def _serial_butterfly(x, width):
    """csrc/sp_sweep.cu serial_butterfly: one thread, pair by pair."""
    off = width // 2
    while off:
        for lane in range(width):
            if not lane & off:
                x[lane] = x[lane | off] = np.float32(x[lane] + x[lane | off])
        off //= 2


def _sweep_serial(terms, batch, v):
    """csrc/sp_sweep.cu var_lm_sums (one thread)."""
    G = _group(batch)
    S = _build.HEAVY_ITERS * G
    ptr = batch.var_ptr.numpy().astype(np.int64)
    perm = batch.var_perm.numpy().astype(np.int64)
    lo, hi = int(ptr[v]), int(ptr[v + 1])
    heavy = batch.var_max_degree >= S
    sums = []
    for col in terms:
        if not heavy or hi - lo < S:
            x = [np.float32(0)] * G
            for lane in range(G):
                for j in range(lo + lane, hi, G):
                    x[lane] = np.float32(x[lane] + col[perm[j]])
            _serial_butterfly(x, G)
            sums.append(x[0])
            continue
        a0, a1 = -(-lo // S), (hi - 1) // S
        run = None
        for k in range(a0, a1 + 1):
            j0, j1 = (lo if k == a0 else k * S), min(k * S + S, hi)
            piece = None
            for w in range(THREADS // 32):
                x = [np.float32(0)] * 32
                for lane in range(32):
                    for j in range(j0 + w * 32 + lane, j1, THREADS):
                        x[lane] = np.float32(x[lane] + col[perm[j]])
                _serial_butterfly(x, 32)
                piece = x[0] if w == 0 else np.float32(piece + x[0])
            run = piece if k == a0 else np.float32(run + piece)
        sums.append(run)
    return np.array(sums, np.float32)


def _sp_terms(batch, seed):
    """The SP sweep's polarity-split var terms, log(1 - eta_in) * em."""
    fn = fused.SP_CHAIN
    ins = _inputs(fn, batch, seed)
    bc = (torch.zeros(batch.num_edges),)
    terms, _ = fn.f3(bc, ins, batch.edge_var, batch.edge_clause)
    return torch.stack(terms)


@pytest.mark.parametrize("which", ["shared", "compacted", "hub"])
def test_sweep_order_is_the_walks(batches, which):
    """Kernel 9's CTA order and its one-thread order give the walk's
    bits: the shared set, a compacted batch, and the hub's 4,000-edge
    variable cut in pieces. The one-thread form is checked on the padding
    edges' variable, the hub and a few others."""
    b = batches[which]
    terms = _sp_terms(b, 17)
    lo, hi = reduce.csr_bounds(b.var_ptr)
    walk = reduce.walk_order_sum(terms, lo, hi, b.var_perm.long(),
                                 _group(b)).numpy()
    cta = _sweep_cta(terms.numpy(), b)
    real = b.var_mask.numpy() > 0
    assert np.array_equal(cta[:, real].view(np.int32),
                          walk[:, real].view(np.int32))
    last = int(b.edge_var[b.num_real_edges])   # the padding edges'
    for v in {0, 1, last, b.num_vars // 2}:
        got = _sweep_serial(terms.numpy(), b, v)
        assert np.array_equal(got.view(np.int32), walk[:, v].view(np.int32))


# --- the argument blocks and the plans ------------------------------------

_CTYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
           "long": ctypes.c_long, "long long": ctypes.c_longlong}


def _c_struct(name):
    """(field, ctypes type) of `struct name { ... };` in csrc/."""
    for path in sorted(os.listdir(CSRC)):
        src = open(os.path.join(CSRC, path)).read()
        m = re.search(r"struct %s \{(.*?)\};" % name, src, re.S)
        if m:
            break
    else:
        raise AssertionError(f"no struct {name} in csrc/")
    fields = []
    for decl in re.sub(r"//[^\n]*", "", m.group(1)).split(";"):
        decl = decl.strip()
        if not decl:
            continue
        m2 = re.match(r"(?:const )?(long long|\w+)\s*(\*?)\s*(\w+)"
                      r"(?:\[(\w+)\])?$", decl)
        assert m2, decl
        base, star, field, count = m2.groups()
        t = _build.P if star else _CTYPES[base]
        if count:
            t = t * {"PDP_MAX_IN": _build.MAX_IN,
                     "PDP_MAX_EOUT": _build.MAX_EOUT,
                     "PDP_RED_MAXC": _build.MAX_COLS}[count]
        fields.append((field, t))
    return fields


@pytest.mark.parametrize("name", ["FusedArgs", "ChainedArgs", "GatherArgs",
                                  "SegSumArgs", "SweepArgs", "VerifyArgs",
                                  "WalkArgs"])
def test_argument_blocks_match_the_c_structures(name):
    """Each ctypes Structure lists its C structure's fields in order, of
    the same size and type, so the kernel reads what the plan wrote."""
    py = [(f, getattr(t, "_type_", t), getattr(t, "_length_", None))
          for f, t in getattr(_build, name)._fields_]
    c = [(f, getattr(t, "_type_", t), getattr(t, "_length_", None))
         for f, t in _c_struct(name)]
    assert py == c


@pytest.mark.parametrize("fn", fused.CHAINED_FNS, ids=lambda f: f.name)
def test_chained_plan_is_cached_and_checks(batches, fn):
    """One plan per (functor, batch); no argument block for a batch on the
    CPU; a wrong input count, shape, dtype or device raises, before and
    after good calls."""
    b, other = batches["compacted"], batches["hub"]
    ins = _inputs(fn, b, 1)
    ref = fused.chained_edge_pass(fn, b, ins)
    plan = fused._plan(fn, b, fused=False)
    assert fused._plan(fn, b, fused=False) is plan
    assert fused._plan(fn, other, fused=False) is not plan
    assert plan.args is None
    assert [s[0] for s in plan.shapes] == [
        {"V": b.num_vars, "F": b.num_clauses, "E": b.num_edges}[k]
        for k in fn.layout]
    bad = [ins[:-1], ins + [ins[-1]], [ins[0][:-1]] + ins[1:],
           [ins[0].double()] + ins[1:], [ins[0].to("meta")] + ins[1:],
           ins[:-1] + [ins[-1].long()]]
    for case in bad:
        with pytest.raises(ValueError):
            fused.chained_edge_pass(fn, b, case)
    got = fused.chained_edge_pass(fn, b, ins)
    for g, r in zip(got, ref):
        if isinstance(g, tuple):
            assert all(torch.equal(u, v) for u, v in zip(g, r))
        else:
            assert (g is None and r is None) or torch.equal(g, r)


@pytest.mark.parametrize("d", [1, 3, 8, 50, 64, 150])
def test_gather_2d_i32_ids(d):
    """i32 ids give the i64 ids' rows, with and without the subtract, for
    an odd row count; with sorted ids (the windowed invariant) both equal
    the JAX kernel in interpret mode."""
    rng = np.random.default_rng(d)
    N, E = 90, 701
    ids = np.sort(rng.integers(0, N, E)).astype(np.int32)
    nodes = rng.standard_normal((N, d)).astype(np.float32)
    x = rng.standard_normal((E, d)).astype(np.float32)
    tn, tx = torch.from_numpy(nodes), torch.from_numpy(x)
    i32, i64 = torch.from_numpy(ids), torch.from_numpy(ids.astype(np.int64))
    ref = np.asarray(windowed_gather_2d(jnp.asarray(nodes), jnp.asarray(ids),
                                        E, True))
    for minus in (None, tx):
        a = reduce2d.gather_2d(tn, i32, minus)
        b = reduce2d.gather_2d(tn, i64, minus)
        assert a.shape == (E, d) and torch.equal(a, b)
        np.testing.assert_array_equal(
            a.numpy(), ref if minus is None else ref - x)


def test_gather_plan_is_cached_and_checks():
    """One plan per ids tensor; ids must be i32 or i64 and 1-D, nodes and
    minus f32 rows on the ids' device, minus of the output's shape."""
    nodes = torch.rand(20, 6)
    ids = torch.randint(0, 20, (33,), dtype=torch.int32)
    out = reduce2d.gather_2d(nodes, ids)
    plan = reduce2d._PLANS.get((ids,), None, reduce2d._GatherPlan, ids)
    assert plan.args is None and plan.rows == 33
    assert reduce2d._PLANS.get((ids,), None, reduce2d._GatherPlan,
                               ids) is plan
    for bad in ((nodes, ids.float()), (nodes, ids[:, None]),
                (nodes.double(), ids), (nodes[0], ids),
                (nodes.to("meta"), ids), (nodes, ids, torch.rand(33, 5)),
                (nodes, ids, torch.rand(33, 6).double()),
                (nodes, ids, torch.rand(33, 6).to("meta"))):
        with pytest.raises(ValueError):
            reduce2d.gather_2d(*bad)
    assert torch.equal(reduce2d.gather_2d(nodes, ids), out)
    assert torch.equal(out, nodes[ids.long()])
