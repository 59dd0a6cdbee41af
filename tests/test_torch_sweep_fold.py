"""The sweep folds of the p-d-p loop: the port against the JAX package on
the CPU, and against its own unfolded path.

With its kernels on (PDP_FUSED_PASS=on here; by default on its chip) the
JAX package folds work into the p-d-p loop's SP sweep (propagate.py
:274-523, solvers/base.py :478-494): the decimator's eight columns
(`sp_chain_dec`), then the edge masks (`sp_chain_mask`), then the
verification of the current solution (`sp_chain_maskv`), with a pass C
that computes q_u alone (`sp_pass_c_lean`). The JAX side runs its Pallas
kernels in interpret mode; the port runs the plain versions of its
functors. States are handed over with convert.state_from_jax.

Tolerances: one sweep's live messages (q_u, eta, force) agree to rtol /
atol 1e-6 with JAX, and the stale q_s / q_dc pass through unchanged; the
decimator's sums to rtol 1e-5 / atol 1e-6, JAX's own tolerance for them
(tests/test_sweep_dec_fold.py:80): their smooth-max columns sum terms
e^(30 x) of up to ~1e12 in another order, a few ulps apart (2e-6
relative seen); masks and verification counts are equal.
Against the port's own split path (`sp_chain`, `sp_pass_c`,
`smax_scorer`, `edge_masks_pair`, `cnf_evaluate`) every output is equal:
each folded term is computed as the split functor computes it. Whole
forwards compare as tests/test_torch_solver.py's do, at its alpha-9
density: the decimated problem, the active flags, the counters and the
solved flags equal, the messages to atol 1e-3 on real edges (sums of
logs taken in another order, fed back through 30 sweeps).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import cnf_instance, random_ksat

from pdp_solver_tpu.fg.batch import pack_instances as jax_pack
from pdp_solver_tpu.modules import propagate as jp
from pdp_solver_tpu.problem.state import init_problem_state as jax_init
from pdp_solver_tpu.solvers import PDPSolver as JaxSolver
from pdp_solver_tpu.solvers import SolverConfig as JaxConfig
from pdp_solver_tpu.train.loss import cnf_evaluate as jax_cnf_evaluate

from pdp_solver_tpu_torch import convert
from pdp_solver_tpu_torch.fg.batch import pack_instances
from pdp_solver_tpu_torch.modules import propagate as tp
from pdp_solver_tpu_torch.ops import fused
from pdp_solver_tpu_torch.problem.simplify import fused_simplify
from pdp_solver_tpu_torch.problem.state import (
    edge_masks_pair, init_problem_state)
from pdp_solver_tpu_torch.solvers.base import PDPSolver, SolverConfig
from pdp_solver_tpu_torch.train.loss import cnf_evaluate

SETTINGS = dict(model_type="p-d-p", tolerance=0.08, t_max=8,
                local_search_iterations=0, epsilon=0.5, simplify_rounds=1)
SWEEP = dict(rtol=1e-6, atol=1e-6)
SUMS = dict(rtol=1e-5, atol=1e-6)
FOLDS = ("dec", "mask", "maskv")
# the fold settings of a whole forward: (PDP_SWEEP_MASK_FOLD,
# PDP_SWEEP_VERIFY_FOLD) with the decimator fold on
FORWARDS = {"dec": ("off", "auto"), "mask": ("auto", "off"),
            "maskv": ("auto", "auto")}


@pytest.fixture
def fold_env(monkeypatch):
    monkeypatch.setenv("PDP_FUSED_PASS", "on")
    monkeypatch.setenv("PDP_COMPILE_CACHE", "off")
    for name in tp.FOLD_SWITCHES[1:]:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _instances(seed, n_inst=6, n=20, alpha=9.0, k=4):
    rng = np.random.default_rng(seed)
    return [cnf_instance(n, random_ksat(rng, n, int(n * alpha), k))
            for _ in range(n_inst)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _sweep_state(seed):
    """Both packages' batches, messages (JAX's random init), a problem
    with some variables and clauses inactive and a random solution, and
    instance flags with one instance stopped."""
    insts = _instances(seed, n_inst=5, n=24, alpha=3.0)
    jb, tb = jax_pack(insts), pack_instances(insts, device="cpu")
    rng = np.random.default_rng(seed + 1)
    av = np.asarray(jb.var_mask) * (rng.uniform(size=jb.num_vars) > 0.15)
    ac = np.asarray(jb.clause_mask) * (rng.uniform(size=jb.num_clauses)
                                       > 0.2)
    sol = (rng.uniform(size=jb.num_vars) > 0.5).astype(np.float32)
    jprob = jax_init(jb)._replace(
        active_vars=jnp.asarray(av, jnp.float32),
        active_clauses=jnp.asarray(ac, jnp.float32),
        solution=jnp.asarray(sol))
    active = np.asarray(jb.instance_mask).copy()
    active[1] = 0.0
    msgs = jp.survey_propagator_init_state(jax.random.PRNGKey(seed),
                                           jb.num_edges, randomized=True)
    return (jb, jprob, jnp.asarray(active), msgs), (
        tb, convert.state_from_jax(_np(jprob), "cpu"),
        torch.from_numpy(active), convert.state_from_jax(_np(msgs), "cpu"))


def _jax_sweep(fold, jb, prob, active, msgs):
    """JAX's folded propagator: (messages, (nd, scorer_agg), em, ae,
    counts or None)."""
    from pdp_solver_tpu.problem.state import edge_masks_pair as jax_masks
    cfg = jp.SurveyPropagatorConfig()
    if fold == "dec":
        em, ae = jax_masks(jb, prob, active)
        out, agg = jp.survey_propagate_with_decimator_agg(
            cfg, jb, msgs, msgs, em, ae, prob.active_clauses)
        return out, agg, em, ae, None
    out = jp.survey_propagate_folded_masks(cfg, jb, msgs, msgs, prob,
                                           active, verify=fold == "maskv")
    return out if fold == "maskv" else out + (None,)


def _port_sweep(fold, tb, prob, active, msgs):
    cfg = tp.SurveyPropagatorConfig()
    if fold == "dec":
        em, ae = edge_masks_pair(tb, prob, active)
        out, agg = tp.survey_propagate_with_decimator_agg(
            cfg, tb, msgs, msgs, em, ae, prob.active_clauses)
        return out, agg, em, ae, None
    out = tp.survey_propagate_folded_masks(cfg, tb, msgs, msgs, prob,
                                           active, verify=fold == "maskv")
    return out if fold == "maskv" else out + (None,)


@pytest.mark.parametrize("fold", FOLDS)
def test_folded_sweep_matches_jax(fold_env, fold):
    """(a) One folded sweep from one state in both packages."""
    (jb, jprob, jact, jmsgs), (tb, tprob, tact, tmsgs) = _sweep_state(7)
    assert tp.sweep_folds(tb) == (True, True, True)
    ref = _jax_sweep(fold, jb, jprob, jact, jmsgs)
    got = _port_sweep(fold, tb, tprob, tact, tmsgs)
    real = np.asarray(jb.edge_mask) > 0
    for r, g in zip((ref[0].var[0],) + ref[0].fn,
                    (got[0].var[0],) + got[0].fn):
        np.testing.assert_allclose(g.numpy()[real], np.asarray(r)[real],
                                   **SWEEP)
    # q_s and q_dc pass through stale, as in the JAX package
    for i in (1, 2):
        assert torch.equal(got[0].var[i], tmsgs.var[i])
        np.testing.assert_array_equal(np.asarray(ref[0].var[i]),
                                      np.asarray(jmsgs.var[i]))
    for r, g in zip(ref[1], got[1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **SUMS)
    for r, g in zip(ref[2:4], got[2:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if fold == "maskv":
        for r, g in zip(ref[4], got[4]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        solved, unsat = jax_cnf_evaluate(jb, jprob.solution[:, None])
        np.testing.assert_array_equal(
            (got[4][0] == got[4][1]).float().numpy(), np.asarray(solved))
        np.testing.assert_array_equal((got[4][0] - got[4][1]).numpy(),
                                      np.asarray(unsat))


@pytest.mark.parametrize("fold", FOLDS)
def test_folded_sweep_equals_split_path(fold_env, fold):
    """(b) The port's folded sweep against its own split path: sp_chain
    and sp_pass_c, then smax_scorer on the new surveys with the sweep's
    eta_state as prev_eta, edge_masks_pair and cnf_evaluate."""
    _, (tb, prob, active, msgs) = _sweep_state(11)
    em, ae = edge_masks_pair(tb, prob, active)
    split = tp.survey_propagator_apply(tp.SurveyPropagatorConfig(), tb,
                                       msgs, msgs, em, ae)
    nd8, _ = fused.fused_edge_pass(
        fused.SMAX_SCORER, tb,
        (prob.active_clauses, msgs.fn[0], split.fn[0], em, tb.edge_mask,
         split.fn[1], tb.edge_sign))
    got = _port_sweep(fold, tb, prob, active, msgs)
    assert torch.equal(got[0].var[0], split.var[0])
    assert all(torch.equal(g, s) for g, s in zip(got[0].fn, split.fn))
    assert torch.equal(torch.cat(got[1]), nd8)
    assert torch.equal(got[2], em) and torch.equal(got[3], ae)
    if fold == "maskv":
        solved, unsat = cnf_evaluate(tb, prob.solution[:, None])
        max_sat, got_sat = got[4]
        assert torch.equal((max_sat == got_sat).float(), solved)
        assert torch.equal(max_sat - got_sat, unsat)


def _forward_pair(insts, seed=3):
    jb, tb = jax_pack(insts), pack_instances(insts, device="cpu")
    jsolver = JaxSolver(JaxConfig(**SETTINGS))
    tsolver = PDPSolver(SolverConfig(**SETTINGS))
    jstate0 = jsolver.get_init_state(jax.random.PRNGKey(seed), jb,
                                     randomized=True)
    return (jb, jsolver, jstate0), (
        tb, tsolver, convert.state_from_jax(_np(jstate0), "cpu"))


def _assert_forwards_equal(jb, tb, jout, tout):
    _, jstate, (jprob, jactive, _) = jout
    _, tstate, (tprob, tactive, _) = tout
    for f in ("active_vars", "active_clauses", "solution", "is_sat"):
        np.testing.assert_array_equal(getattr(tprob, f).numpy(),
                                      np.asarray(getattr(jprob, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(tactive.numpy(), np.asarray(jactive))
    np.testing.assert_array_equal(tstate.aux.counters.numpy(),
                                  np.asarray(jstate.aux.counters))
    jsolved, _ = jax_cnf_evaluate(jb, jprob.solution[:, None])
    tsolved, _ = cnf_evaluate(tb, tprob.solution[:, None])
    np.testing.assert_array_equal(tsolved.numpy(), np.asarray(jsolved))
    real = np.asarray(jb.edge_mask) > 0
    for r, g in zip(jstate.prop.var + jstate.prop.fn,
                    tstate.prop.var + tstate.prop.fn):
        np.testing.assert_allclose(g.numpy()[real], np.asarray(r)[real],
                                   rtol=0, atol=1e-3)


@pytest.mark.parametrize("fold", FOLDS)
def test_folded_forward_matches_jax(fold_env, fold):
    """(c) A 30-iteration p-d-p forward with check_termination from one
    injected state, folded in both packages at each fold setting."""
    mask, verify = FORWARDS[fold]
    fold_env.setenv("PDP_SWEEP_MASK_FOLD", mask)
    fold_env.setenv("PDP_SWEEP_VERIFY_FOLD", verify)
    (jb, jsolver, jstate0), (tb, tsolver, tstate0) = _forward_pair(
        _instances(0))
    assert tp.sweep_folds(tb) == (True, mask == "auto",
                                  mask == verify == "auto")
    jout = jsolver.forward({}, jax.random.PRNGKey(4), jb, jstate0, 30,
                           is_training=False, check_termination=True,
                           finalize=False)
    tout = tsolver.forward({}, torch.Generator().manual_seed(0), tb,
                           tstate0, 30, check_termination=True,
                           finalize=False)
    _assert_forwards_equal(jb, tb, jout, tout)
    # the run decimated
    assert float(tout[2][0].active_vars.sum()) < float(
        fused_simplify(tb, init_problem_state(tb)).active_vars.sum())


def _trajectory(step, state, carry, n):
    """The active flags and counters after each of n one-iteration
    chunks."""
    flags, counters = [], []
    for _ in range(n):
        state, carry = step(state, carry)
        flags.append(np.asarray(carry[1]).copy())
        counters.append(np.asarray(state.aux.counters).copy())
    return np.stack(flags), np.stack(counters)


def test_verify_fold_lags_the_exit_by_one_iteration(fold_env):
    """(d) Easy instances that a decimation every iteration solves within
    a few: the port's active-flag and counter trajectories, one iteration
    at a time, equal JAX's with every fold on; the last instance stops,
    and the loop exits, one iteration after the unfolded path's."""
    cfg = dict(SETTINGS, tolerance=1.0, t_max=1)
    insts = _instances(6, n_inst=4, n=20, alpha=3.0)
    jb, tb = jax_pack(insts), pack_instances(insts, device="cpu")
    jsolver, tsolver = JaxSolver(JaxConfig(**cfg)), PDPSolver(
        SolverConfig(**cfg))
    jstate0 = jsolver.get_init_state(jax.random.PRNGKey(2), jb,
                                     randomized=True)
    n = 12

    def jstep(state, carry):
        _, state, carry = jsolver.forward(
            {}, jax.random.PRNGKey(0), jb, state, 1, is_training=False,
            check_termination=True, carry=carry, finalize=False)
        return state, carry

    jprob0 = fused_simplify_jax(jb)
    jcarry0 = (jprob0, jb.instance_mask, jb.edge_mask)
    jflags, jcount = _trajectory(jax.jit(jstep), jstate0, jcarry0, n)

    def tstep(state, carry):
        _, state, carry = tsolver.forward(
            {}, torch.Generator().manual_seed(0), tb, state, 1,
            check_termination=True, carry=carry, finalize=False)
        return state, carry

    tcarry0 = (fused_simplify(tb, init_problem_state(tb)),
               tb.instance_mask.clone(), tb.edge_mask.clone())
    tstate0 = convert.state_from_jax(_np(jstate0), "cpu")
    tflags, tcount = _trajectory(tstep, tstate0, tcarry0, n)
    np.testing.assert_array_equal(tflags, jflags)
    np.testing.assert_array_equal(tcount, jcount)

    fold_env.setenv("PDP_SWEEP_DEC_FOLD", "off")
    uflags, _ = _trajectory(tstep, tstate0, tcarry0, n)
    real = len(insts)
    exit_fold = int(np.argmax(tflags[:, :real].sum(1) == 0))
    exit_split = int(np.argmax(uflags[:, :real].sum(1) == 0))
    assert tflags[exit_fold, :real].sum() == 0 < tflags[0, :real].sum()
    assert exit_fold == exit_split + 1
    # an instance that stops on its own verification stops one iteration
    # later folded
    first = np.argmax(uflags[:, :real] == 0, axis=0)
    assert (np.argmax(tflags[:, :real] == 0, axis=0) >= first).all()
    # after the exit nothing moves but held counters
    assert (tcount[exit_fold:] == tcount[exit_fold]).all()


def fused_simplify_jax(jb):
    from pdp_solver_tpu.problem.simplify import fused_simplify as jax_simp
    return jax_simp(jb, jax_init(jb))


def _stand_in(device, batch_size, clause_width=4):
    """The fields the fold gates read, in both packages."""
    return types.SimpleNamespace(
        fast_var=True, fast_clause=True, clause_width=clause_width,
        batch_size=batch_size, device=torch.device(device))


@pytest.mark.parametrize("fused_pass", [None, "on", "off"])
@pytest.mark.parametrize("platform", ["cpu", "card"])
def test_gates_decide_as_jax(fold_env, fused_pass, platform):
    """(e) The three gates against JAX's, for every auto/off setting of
    the three fold switches, a batch at and above IWIN instances and a
    clause width with no chained tiles; "card" is a batch on the card
    against JAX on its TPU (jax.default_backend patched)."""
    if fused_pass is None:
        fold_env.delenv("PDP_FUSED_PASS")
    else:
        fold_env.setenv("PDP_FUSED_PASS", fused_pass)
    if platform == "card":
        fold_env.setattr(jax, "default_backend", lambda: "tpu")
    device = "cuda" if platform == "card" else "cpu"
    gates = ("use_sweep_decimator_fold", "use_sweep_mask_fold",
             "use_sweep_verify_fold")
    seen = set()
    for dec in ("auto", "off"):
        for mask in ("auto", "off"):
            for verify in ("auto", "off"):
                fold_env.setenv("PDP_SWEEP_DEC_FOLD", dec)
                fold_env.setenv("PDP_SWEEP_MASK_FOLD", mask)
                fold_env.setenv("PDP_SWEEP_VERIFY_FOLD", verify)
                for b, k in ((tp.IWIN, 4), (tp.IWIN + 1, 4), (8, 9)):
                    batch = _stand_in(device, b, k)
                    want = tuple(getattr(jp, g)(batch) for g in gates)
                    got = tuple(getattr(tp, g)(batch) for g in gates)
                    assert got == want == tp.sweep_folds(batch), (
                        dec, mask, verify, b, k)
                    seen.add(want)
    folds = fused_pass == "on" or (fused_pass is None and platform == "card")
    assert seen == ({(False,) * 3, (True, False, False),
                     (True, True, False), (True, True, True)}
                    if folds else {(False,) * 3})


@pytest.mark.parametrize("chunks", [(10, 10, 10), (7, 16, 7)])
def test_chunked_folded_forward_equals_one(fold_env, chunks):
    """(f) A folded forward in chunks (the carry's em dead under the mask
    fold) equals one long folded forward, bit for bit."""
    _, (tb, tsolver, tstate0) = _forward_pair(_instances(2))
    gen = torch.Generator().manual_seed(0)
    _, one, (prob1, act1, _) = tsolver.forward(
        {}, gen, tb, tstate0, sum(chunks), check_termination=True,
        finalize=False)
    state, carry = tstate0, None
    for n in chunks:
        _, state, carry = tsolver.forward(
            {}, gen, tb, state, n, check_termination=True, carry=carry,
            finalize=False)
    for f in ("active_vars", "active_clauses", "solution", "is_sat"):
        assert torch.equal(getattr(carry[0], f), getattr(prob1, f)), f
    assert torch.equal(carry[1], act1)
    assert torch.equal(state.aux.counters, one.aux.counters)
    for a, b in zip(state.prop.var + state.prop.fn,
                    one.prop.var + one.prop.fn):
        assert torch.equal(a, b)
