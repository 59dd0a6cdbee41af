"""The port's kernels (plain versions on the CPU) against the JAX package.

Each functor of pdp_solver_tpu_torch.ops.fused is held against the JAX
fused/chained edge pass with the caller's own closure, run through the
Pallas kernel in interpret mode; walksat_block against the JAX WalkSAT
kernel. Inputs come from a numpy seed and go to both packages.

Tolerances: outputs that are integers or flags (masks, clause and
instance counts, simplify rounds, WalkSAT energies and flips) must match
exactly; float sums of logs and exponentials (SP sweep, decimator and
scorer columns) to rtol 1e-5 / atol 1e-6, because the two sum in another
order (the Pallas kernel contracts one-hot matrices, the port adds edge by
edge). Edge outputs are compared on real edges: padding-edge values are
meaningless by contract in both packages.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import cnf_instance, random_ksat

from pdp_solver_tpu.fg.batch import pack_instances as jax_pack
from pdp_solver_tpu.modules import decimate as jd
from pdp_solver_tpu.modules import propagate as jp
from pdp_solver_tpu.modules import predict as jpr
from pdp_solver_tpu.ops import pallas_fused as jf
from pdp_solver_tpu.ops import pallas_walksat as jw
from pdp_solver_tpu.ops import segment as jseg
from pdp_solver_tpu.problem import state as jstate
from pdp_solver_tpu.solvers import base as jbase
from pdp_solver_tpu.train import loss as jloss

from pdp_solver_tpu_torch.fg.batch import pack_instances

# the JAX problem package re-exports a function named `simplify`
jsimp = importlib.import_module("pdp_solver_tpu.problem.simplify")
from pdp_solver_tpu_torch.ops import fused, segment, walksat

EXACT = dict(rtol=0, atol=0)
FLOAT = dict(rtol=1e-5, atol=1e-6)


def _instances(seed=0, n_inst=5, n=20, alpha=4.2, k=4, unsat=False):
    rng = np.random.default_rng(seed)
    insts = [cnf_instance(n, random_ksat(rng, n, int(n * alpha), k))
             for _ in range(n_inst)]
    if unsat:
        insts.append(cnf_instance(3, [[1], [-1], [2, 3]]))
    return insts


@pytest.fixture(scope="module")
def packed():
    insts = _instances()
    jb = jax_pack(insts)
    tb = pack_instances(insts, device="cpu")
    assert jb.fast_var and jb.fast_clause and jb.clause_width == 4
    return jb, tb


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _j(x):
    return jnp.asarray(np.asarray(x, dtype=np.float32))


def _cols(rng, jb, spec):
    """Random columns for a layout string: u = (0,1) floats, m = 0/1 masks
    (0 on padding, as every caller's masks are), s = +-1 signs."""
    sizes = {"V": jb.num_vars, "F": jb.num_clauses, "E": jb.num_edges}
    real = {"V": jb.var_mask, "F": jb.clause_mask, "E": jb.edge_mask}
    out = []
    for kind, dist in spec:
        n = sizes[kind]
        if dist == "u":
            x = rng.uniform(0.02, 0.98, n)
        elif dist == "m":
            x = (rng.uniform(size=n) > 0.3) * np.asarray(real[kind])
        elif dist == "s":
            x = rng.choice([-1.0, 1.0], n)
        elif dist == "a":         # assignment in {-1, 0, 1}
            x = rng.choice([-1.0, 0.0, 1.0], n)
        elif dist == "l":         # log-domain sums
            x = -rng.uniform(0.0, 5.0, n)
        else:
            raise ValueError(dist)
        out.append(x.astype(np.float32))
    return out


def _close_edges(jb, ref, got, tol):
    m = np.asarray(jb.edge_mask) > 0
    np.testing.assert_allclose(np.asarray(got)[m], np.asarray(ref)[m], **tol)


def _close(ref, got, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **tol)


# --- fused functors ---------------------------------------------------------

def test_sp_pass_c(packed):
    jb, tb = packed
    rng = np.random.default_rng(1)
    pos, neg = _cols(rng, jb, [("V", "l"), ("V", "l")])
    eta, em, mask, force, v0, v1, v2 = _cols(
        rng, jb, [("E", "u"), ("E", "m"), ("E", "m"), ("E", "s"),
                  ("E", "u"), ("E", "u"), ("E", "u")])
    sign = np.asarray(jb.edge_sign)
    for pi in (0.0, 0.3):
        _, ref = jf.fused_edge_pass(
            jp._sp_pass_c(pi), node_cols=(_j(pos), _j(neg)),
            gather_ids=jb.edge_var,
            edge_cols=tuple(map(_j, (eta, em, mask, sign, force, v0, v1,
                                     v2))),
            n_eout=3, interpret=True)
        red, got = fused.fused_edge_pass(
            fused.SP_PASS_C, tb,
            tuple(map(_t, (pos, neg, eta, em, mask, sign, force, v0, v1,
                           v2))), scalar=pi)
        assert red is None
        for r, g in zip(ref, got):
            _close_edges(jb, r, g, FLOAT)


def test_smax_scorer(packed):
    jb, tb = packed
    rng = np.random.default_rng(2)
    (ac,) = _cols(rng, jb, [("F", "m")])
    prev, eta, em, force = _cols(rng, jb, [("E", "u"), ("E", "u"),
                                           ("E", "m"), ("E", "s")])
    bmask, sign = np.asarray(jb.edge_mask), np.asarray(jb.edge_sign)
    ref, _ = jf.fused_edge_pass(
        jd._smax_scorer_pass, node_cols=(_j(ac),),
        gather_ids=jb.edge_clause, gather_uniform=jb.clause_width,
        edge_cols=tuple(map(_j, (prev, eta, em, bmask, force, sign))),
        reduce_ids=jb.edge_var, num_segments=jb.num_vars, n_red=8,
        interpret=True)
    got, eouts = fused.fused_edge_pass(
        fused.SMAX_SCORER, tb,
        tuple(map(_t, (ac, prev, eta, em, bmask, force, sign))))
    assert eouts == ()
    _close(ref, got, FLOAT)


def test_scorer(packed):
    jb, tb = packed
    rng = np.random.default_rng(3)
    (ac,) = _cols(rng, jb, [("F", "m")])
    eta, force = _cols(rng, jb, [("E", "u"), ("E", "s")])
    sign, mask = np.asarray(jb.edge_sign), np.asarray(jb.edge_mask)
    ref, _ = jf.fused_edge_pass(
        jpr._scorer_pass, node_cols=(_j(ac),), gather_ids=jb.edge_clause,
        gather_uniform=jb.clause_width,
        edge_cols=tuple(map(_j, (eta, force, sign, mask))),
        reduce_ids=jb.edge_var, num_segments=jb.num_vars, n_red=4,
        interpret=True)
    got, _ = fused.fused_edge_pass(
        fused.SCORER, tb, tuple(map(_t, (ac, eta, force, sign, mask))))
    _close(ref, got, FLOAT)


def test_edge_masks(packed):
    jb, tb = packed
    rng = np.random.default_rng(4)
    av, abv = _cols(rng, jb, [("V", "m"), ("V", "m")])
    (ac,) = _cols(rng, jb, [("F", "m")])
    mask = np.asarray(jb.edge_mask)
    _, (em_r, ae_r) = jf.fused_edge_pass(
        jstate._em_ae_pass, node_cols=(_j(av), _j(abv)),
        gather_ids=jb.edge_var, node_cols2=(_j(ac),),
        gather_ids2=jb.edge_clause, gather2_uniform=jb.clause_width,
        edge_cols=(_j(mask),), n_eout=2, interpret=True)
    _, (em_g, ae_g) = fused.fused_edge_pass(
        fused.EM_AE, tb, tuple(map(_t, (av, abv, ac, mask))))
    _close_edges(jb, em_r, em_g, EXACT)
    _close_edges(jb, ae_r, ae_g, EXACT)
    _, (em_r,) = jf.fused_edge_pass(
        jstate._em_pass, node_cols=(_j(av),), gather_ids=jb.edge_var,
        node_cols2=(_j(ac),), gather_ids2=jb.edge_clause,
        gather2_uniform=jb.clause_width, edge_cols=(_j(mask),), n_eout=1,
        interpret=True)
    _, (em_g,) = fused.fused_edge_pass(fused.EM, tb,
                                       tuple(map(_t, (av, ac, mask))))
    _close_edges(jb, em_r, em_g, EXACT)
    _, (ae_r,) = jf.fused_edge_pass(
        jstate._ae_pass, node_cols=(_j(abv),), gather_ids=jb.edge_var,
        n_eout=1, interpret=True)
    _, (ae_g,) = fused.fused_edge_pass(fused.AE, tb, (_t(abv),))
    _close_edges(jb, ae_r, ae_g, EXACT)


# --- chained functors -------------------------------------------------------

def _jax_chain(jb, f1, f2, f3, **kw):
    return jf.chained_edge_pass(
        f1, f2, f3, gather_ids=jb.edge_var, clause_width=jb.clause_width,
        num_clauses=jb.num_clauses, num_segments=jb.num_vars,
        interpret=True, **kw)


def test_sp_chain(packed):
    jb, tb = packed
    rng = np.random.default_rng(6)
    u, eta_in, em, mask, eta_state = _cols(
        rng, jb, [("E", "u"), ("E", "u"), ("E", "m"), ("E", "m"),
                  ("E", "u")])
    sign = np.asarray(jb.edge_sign)
    ins = (u, eta_in, em, mask, eta_state, sign)
    _, vref, (eref,) = _jax_chain(
        jb, jp._sp_chain_f1, jp._sp_chain_f2, jp._sp_chain_f3(False),
        node_cols=(), edge_cols=tuple(map(_j, ins)), n_cred=1, n_cout=0,
        n_bcast=1, n_vred=2, n_eout=1)
    cout, vgot, (egot,), ired = fused.chained_edge_pass(
        fused.SP_CHAIN, tb, tuple(map(_t, ins)))
    assert cout is None and ired is None
    _close(vref, vgot, FLOAT)
    _close_edges(jb, eref, egot, FLOAT)


def test_sround_chain(packed):
    jb, tb = packed
    rng = np.random.default_rng(7)
    av, = _cols(rng, jb, [("V", "m")])
    sol = rng.choice([0.0, 0.5, 1.0], jb.num_vars).astype(np.float32)
    (ac,) = _cols(rng, jb, [("F", "m")])
    sign, mask = np.asarray(jb.edge_sign), np.asarray(jb.edge_mask)
    cref, vref, _ = _jax_chain(
        jb, jsimp._sround_f1, jsimp._sround_f2, jsimp._sround_f3,
        node_cols=(_j(av), _j(sol)), clause_cols=(_j(ac),),
        edge_cols=(_j(sign), _j(mask)), n_cred=2, n_cout=1, n_bcast=2,
        n_vred=4)
    cgot, vgot, _, _ = fused.chained_edge_pass(
        fused.SROUND, tb, tuple(map(_t, (av, sol, sign, mask, ac))))
    _close(cref, cgot, EXACT)
    _close(vref, vgot, EXACT)


def test_cnf_chain(packed):
    jb, tb = packed
    rng = np.random.default_rng(8)
    (p,) = _cols(rng, jb, [("V", "u")])
    sign, mask = np.asarray(jb.edge_sign), np.asarray(jb.edge_mask)
    cm = np.asarray(jb.clause_mask)
    _, _, _, iref = _jax_chain(
        jb, jloss._cnf_chain_f1, jloss._cnf_chain_f2, None,
        node_cols=(_j(p),), clause_cols=(_j(cm),),
        edge_cols=(_j(sign), _j(mask)), n_cred=1, n_cout=0, n_bcast=0,
        n_vred=0, n_eout=0, n_ired=2, clause_batch=jb.clause_batch,
        num_instances=jb.batch_size)
    _, _, _, igot = fused.chained_edge_pass(
        fused.CNF_CHAIN, tb, tuple(map(_t, (p, sign, mask, cm))))
    _close(iref, igot, EXACT)


def test_ws_chain(packed):
    jb, tb = packed
    rng = np.random.default_rng(9)
    av, = _cols(rng, jb, [("V", "m")])
    assign = rng.choice([-1.0, 1.0], jb.num_vars).astype(np.float32)
    sa = (assign * av).astype(np.float32)
    (ac,) = _cols(rng, jb, [("F", "m")])
    (em,) = _cols(rng, jb, [("E", "m")])
    sign, mask = np.asarray(jb.edge_sign), np.asarray(jb.edge_mask)
    _, vref, _, iref = _jax_chain(
        jb, jbase._ws_cf1, jbase._ws_cf2_ired, jbase._ws_cf3,
        node_cols=(_j(sa), _j(av)), clause_cols=(_j(ac),),
        edge_cols=(_j(sign), _j(mask), _j(em)), n_cred=2, n_cout=0,
        n_bcast=3, n_vred=2, n_ired=1, clause_batch=jb.clause_batch,
        num_instances=jb.batch_size)
    _, vgot, _, igot = fused.chained_edge_pass(
        fused.WS_CHAIN, tb, tuple(map(_t, (sa, av, sign, mask, em, ac))))
    _close(vref, vgot, EXACT)
    _close(iref, igot, EXACT)


def test_wrapper_rejects_bad_inputs(packed):
    _, tb = packed
    with pytest.raises(ValueError):
        fused.fused_edge_pass(fused.AE, tb, (torch.zeros(3),))
    with pytest.raises(ValueError):
        fused.fused_edge_pass(
            fused.AE, tb, (torch.zeros(tb.num_vars, dtype=torch.float64),))


# --- segment algebra --------------------------------------------------------

def test_segment_ops_match():
    rng = np.random.default_rng(10)
    ids = np.sort(rng.integers(0, 9, 200)).astype(np.int32)
    x = rng.normal(size=200).astype(np.float32)
    x[::7] = x[3]                       # ties for the first-index rule
    valid = (rng.uniform(size=200) > 0.2).astype(np.float32)
    ti, tx, tv = torch.from_numpy(ids).long(), _t(x), _t(valid)
    _close(jseg.segment_sum(_j(x), ids, 10), segment.segment_sum(tx, ti, 10),
           dict(rtol=1e-6, atol=1e-6))
    _close(jseg.segment_max(_j(x), ids, 10),
           segment.segment_max(tx, ti, 10), EXACT)
    np.testing.assert_array_equal(
        np.asarray(jseg.segment_argmax_first(_j(x), ids, 10, valid=_j(valid))),
        segment.segment_argmax_first(tx, ti, 10, valid=tv).numpy())
    _close(jseg.segment_smooth_max(_j(x), ids, 10, valid=_j(valid)),
           segment.segment_smooth_max(tx, ti, 10, valid=tv), FLOAT)
    _close(jseg.segment_max_shifted(_j(x), ids, 10, valid=_j(valid)),
           segment.segment_max_shifted(tx, ti, 10, valid=tv), EXACT)
    y = np.array([0.0, 1e-45, 0.5, 50.0], np.float32)
    _close(jseg.safe_log(_j(y)), segment.safe_log(_t(y)), EXACT)
    _close(jseg.safe_exp(_j(y)), segment.safe_exp(_t(y)), FLOAT)


# --- WalkSAT block ----------------------------------------------------------

@pytest.mark.parametrize("eps,seed", [(-1.0, 5), (0.5, 123456789),
                                      (0.5, -2023)])
def test_walksat_block_bit_exact(monkeypatch, eps, seed):
    monkeypatch.setenv("PDP_FUSED_PASS", "on")
    insts = _instances(seed=11, n_inst=4, n=16, alpha=3.0, k=3)
    jb = jax_pack(insts)
    tb = pack_instances(insts, device="cpu")
    assert jw.use_walksat_mega(jb) and walksat.use_walksat_block(tb)
    rng = np.random.default_rng(12)
    av = np.asarray(jb.var_mask) * (rng.uniform(size=jb.num_vars) > 0.1)
    ac = np.asarray(jb.clause_mask) * (rng.uniform(size=jb.num_clauses)
                                       > 0.1)
    av, ac = av.astype(np.float32), ac.astype(np.float32)
    assign = (av * rng.choice([-1.0, 1.0], jb.num_vars)).astype(np.float32)
    em = np.asarray(jstate.compute_edge_mask(
        jb, jstate.ProblemState(_j(av), _j(ac), _j(av * 0 + 0.5),
                                _j(np.full(jb.batch_size, 0.5)))))
    a_ref, e_ref = jw.walksat_block(
        _j(assign), batch=jb, active_vars=_j(av), active_clauses=_j(ac),
        em=_j(em), K=6, seed=jnp.int32(seed), eps=eps, interpret=True)
    a_got, e_got = walksat.walksat_block(
        _t(assign), batch=tb, active_vars=_t(av), active_clauses=_t(ac),
        em=_t(em), K=6, seed=seed, eps=eps)
    np.testing.assert_array_equal(a_got.numpy().view(np.int32),
                                  np.asarray(a_ref).view(np.int32))
    np.testing.assert_array_equal(e_got.numpy(), np.asarray(e_ref))


def test_hash01_matches_jax():
    x = np.arange(-50, 5000, 7, dtype=np.int32)
    for salt in (0, 1000003, -123456789, 2**31 - 1):
        ref = np.asarray(jw._hash01(jnp.asarray(x), jnp.int32(salt)))
        got = walksat.hash01(torch.from_numpy(x).long(), salt).numpy()
        np.testing.assert_array_equal(got, ref)
