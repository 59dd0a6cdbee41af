"""The np-d-np assembly: the port against the JAX package on the CPU.

np-d-np is the neural propagator (two aggregators over [E, 150] states)
with the sequential decimator over its fn state's column 0, scored by a
neural predictor with a tanh head, and the identity predictor. Every test
here runs the trained r4 checkpoint at full width (hidden 150,
mem_agg 50), read by each package's own loader, on small batches of
uniform 3-SAT (n around 20). The JAX side runs its XLA path, and its
Pallas kernel of the decimator's pass in interpret mode
(`PDP_FUSED_PASS=on`) where the functor is compared.

Tolerances:
- the `smax` functor (kernel 1's np-d-np pass): rtol 1e-5 / atol 1e-6
  against `_smax_pass2` and columns 0-1 of `_smax_pass4` (sums in another
  order);
- one propagator step and the scorer: rtol 1e-5 / atol 1e-5;
- one decimation step: the picks exactly, at every instance whose two
  largest |score| differ by more than 100 times that tolerance (the test
  counts them; closer scores are a tie that the order of a sum decides);
- a 20-iteration forward from one injected state: the active flags, the
  decimated solution and the counters exactly, the states to atol 1e-4,
  as tests/test_torch_p_nd_np.py holds p-nd-np.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import cnf_instance, random_ksat

from pdp_solver_tpu.fg.batch import pack_instances as jax_pack
from pdp_solver_tpu.modules import decimate as JD
from pdp_solver_tpu.modules import propagate as JPR
from pdp_solver_tpu.ops.pallas_fused import batch_var_window
from pdp_solver_tpu.ops.pallas_fused import fused_edge_pass as jax_fused
from pdp_solver_tpu.problem.state import compute_edge_mask as jax_em
from pdp_solver_tpu.problem.state import init_problem_state as jax_init
from pdp_solver_tpu.problem.simplify import fused_simplify as simplify_problem
from pdp_solver_tpu.solvers import PDPSolver as JaxSolver
from pdp_solver_tpu.solvers import SolverConfig as JaxConfig
from pdp_solver_tpu.train import checkpoint as jckpt

from pdp_solver_tpu_torch import convert
from pdp_solver_tpu_torch.fg.batch import pack_instances
from pdp_solver_tpu_torch.modules import decimate as D
from pdp_solver_tpu_torch.modules import mlp
from pdp_solver_tpu_torch.modules import propagate as PR
from pdp_solver_tpu_torch.ops import fused
from pdp_solver_tpu_torch.problem.simplify import fused_simplify
from pdp_solver_tpu_torch.problem.state import (
    compute_edge_mask, init_problem_state)
from pdp_solver_tpu_torch.solvers.base import PDPSolver, SolverConfig
from pdp_solver_tpu_torch.utils import neural

TOL = dict(rtol=1e-5, atol=1e-5)
R4 = dict(model_type="np-d-np", hidden_dim=150, mem_hidden_dim=100,
          agg_hidden_dim=100, mem_agg_hidden_dim=50, classifier_dim=50,
          tolerance=0.02, t_max=10)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def r4():
    """(JAX solver, JAX params, port solver, port params) with the r4
    weights."""
    cfg = JaxConfig(name="np-d-np-r4", **R4)
    jsolver = JaxSolver(cfg)
    template = {"params": jsolver.init_params(jax.random.PRNGKey(0)),
                "global_step": jnp.zeros((), jnp.float32)}
    jparams = jckpt.load_params(
        os.path.dirname(neural.NP_D_NP_CHECKPOINT), template,
        cfg.name)["params"]
    return (jsolver, jparams, PDPSolver(SolverConfig(**R4)),
            neural.np_d_np_params("cpu"))


def _instances(seed, ns=(20, 24, 18, 22), alpha=4.0, k=3):
    rng = np.random.default_rng(seed)
    return [cnf_instance(n, random_ksat(rng, n, int(n * alpha), k))
            for n in ns]


def _pair(n_edges, seed, h=150):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-1, 1, (n_edges, h)).astype(np.float32)
                 for _ in range(2))


def _t(pair):
    return tuple(map(torch.from_numpy, pair))


def _j(pair):
    return tuple(map(jnp.asarray, pair))


def _edge_masks(jb, problem, seed):
    """The live-edge mask of `problem` and a per-edge instance flag with
    one instance stopped, as numpy f32[E]."""
    em = np.array(jax_em(jb, problem))
    active_b = np.ones(jb.batch_size, np.float32)
    active_b[1] = 0.0
    return em, active_b[np.asarray(jb.var_batch)[np.asarray(jb.edge_var)]]


@pytest.mark.parametrize("n_red", [2, 4])
def test_smax_plain_matches_jax(monkeypatch, n_red):
    """The `smax` functor's two columns against JAX's `_smax_pass2` and the
    first two of `_smax_pass4` (its Pallas kernel in interpret mode), with
    some edges dead and a survey near the smooth-max's clamp."""
    monkeypatch.setenv("PDP_FUSED_PASS", "on")
    insts = _instances(1)
    jb, tb = jax_pack(insts), pack_instances(insts, device="cpu")
    rng = np.random.default_rng(2)
    E = jb.num_edges
    prev = rng.uniform(size=E).astype(np.float32)
    eta = np.where(rng.uniform(size=E) > 0.9, prev + 0.9,
                   rng.uniform(size=E)).astype(np.float32)
    em = (np.asarray(jb.edge_mask) * (rng.uniform(size=E) > 0.2)).astype(
        np.float32)
    f = JD._smax_pass2 if n_red == 2 else JD._smax_pass4
    ref, _ = jax_fused(
        f, edge_cols=tuple(map(jnp.asarray, (prev, eta, em, np.asarray(
            jb.edge_mask)))), reduce_ids=jb.edge_var,
        num_segments=jb.num_vars, n_red=n_red,
        window=batch_var_window(jb), interpret=True)
    got, _ = fused.fused_edge_pass(
        fused.SMAX, tb, tuple(map(torch.from_numpy, (prev, eta, em))) + (
            tb.edge_mask,))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:2], rtol=1e-5,
                               atol=1e-6)
    assert float(got[1].max()) > 1e6    # exp(30 * diff) reached ~e^27


def test_propagator_and_scorer_match_jax(r4):
    """One neural propagator step (some edges dead, one instance frozen)
    and the tanh scorer on its output, from the same [E, 150] states."""
    jsolver, jparams, tsolver, tparams = r4
    insts = _instances(3)
    jb, tb = jax_pack(insts), pack_instances(insts, device="cpu")
    problem = simplify_problem(jb, jax_init(jb))
    em, ae = _edge_masks(jb, problem, 4)
    prop, dec = _pair(jb.num_edges, 5), _pair(jb.num_edges, 6)
    ref = JPR.neural_propagator_apply(
        jparams["prop"], jsolver.prop_cfg, jax.random.PRNGKey(0), jb,
        _j(prop), _j(dec),
        jnp.asarray(em), jnp.asarray(ae), False)
    with torch.no_grad():
        got = tparams["prop"](tb, _t(prop), _t(dec), torch.from_numpy(em),
                              torch.from_numpy(ae))
    real = np.asarray(jb.edge_mask) > 0
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy()[real], np.asarray(r)[real],
                                   **TOL)
    frozen = ae == 0
    np.testing.assert_array_equal(got[1].numpy()[frozen], prop[1][frozen])
    sref = jsolver._scorer_fn(jparams, jb)(ref, problem)
    tprob = convert.problem_from_jax(_np(problem), "cpu")
    with torch.no_grad():
        sgot = tsolver._scorer_fn(tparams, tb)(
            tuple(torch.from_numpy(np.array(r)) for r in ref), tprob)
    assert isinstance(tparams["scorer"].classifier, mlp.PerceptronTanh)
    vm = np.asarray(jb.var_mask) > 0
    np.testing.assert_allclose(sgot.numpy()[vm], np.asarray(sref)[vm],
                               **TOL)
    assert np.abs(np.asarray(sref)[vm]).max() > 0.5


def test_decimation_step_picks_match_jax(r4):
    """One step of the sequential decimator from converged bookkeeping
    (prev_eta = the survey, so every instance decimates): the same
    variable fixed to the same value wherever the two largest |score| of
    an instance are more than 100 times the tolerance apart."""
    jsolver, jparams, tsolver, tparams = r4
    insts = _instances(7, ns=(20, 24, 18, 22, 26, 16, 20, 22))
    jb, tb = jax_pack(insts), pack_instances(insts, device="cpu")
    problem = simplify_problem(jb, jax_init(jb))
    msgs = _pair(jb.num_edges, 8)
    eta = msgs[1][:, 0].copy()
    jseq = JD.SeqDecimatorState(prev_eta=jnp.asarray(eta),
                                counters=jnp.zeros(jb.batch_size),
                                has_prev=jnp.ones(()))
    em = jax_em(jb, problem)
    active = jnp.asarray(np.asarray(jb.instance_mask))
    jaux, jprob, jact = JD.sequential_decimator_apply(
        jsolver.dec_cfg, jsolver._scorer_fn(jparams, jb), jb, jseq,
        _j(msgs), problem, em, active)
    tprob = convert.problem_from_jax(_np(problem), "cpu")
    tseq = D.SeqDecimatorState(prev_eta=torch.from_numpy(eta),
                               counters=torch.zeros(tb.batch_size),
                               has_prev=torch.ones(()))
    with torch.no_grad():
        taux, tprob2, tact = D.sequential_decimator_apply(
            tsolver.dec_cfg, None, tb, tseq, _t(msgs), tprob,
            compute_edge_mask(tb, tprob), torch.from_numpy(np.array(
                active)), scorer_fn=tsolver._scorer_fn(tparams, tb))
    # the neural state is never paramagnetic: no instance stops
    np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))
    np.testing.assert_array_equal(taux.counters.numpy(),
                                  np.asarray(jaux.counters))
    np.testing.assert_array_equal(taux.prev_eta.numpy(), eta)
    score = np.asarray(jsolver._scorer_fn(jparams, jb)(_j(msgs), problem))
    coeff = np.abs(score[:, 0]) * np.asarray(problem.active_vars)
    vb = np.asarray(jb.var_batch)
    fixed_j = np.asarray(problem.active_vars) - np.asarray(jprob.active_vars)
    fixed_t = np.asarray(problem.active_vars) - tprob2.active_vars.numpy()
    clear = 0
    for b in range(len(insts)):
        top = np.sort(coeff[vb == b])[-2:]
        if top[1] - top[0] <= 100 * TOL["atol"]:
            continue
        clear += 1
        sel = vb == b
        np.testing.assert_array_equal(fixed_t[sel], fixed_j[sel])
        np.testing.assert_array_equal(tprob2.solution.numpy()[sel],
                                      np.asarray(jprob.solution)[sel])
        assert fixed_j[sel].sum() >= 1
    print(f"{clear} of {len(insts)} instances clear of a tie")
    assert clear >= len(insts) // 2


def test_forward_matches_jax_from_same_state(r4):
    """A 20-iteration forward with check_termination from one injected
    state (JAX's init state) with the r4 weights at full width."""
    jsolver, jparams, tsolver, tparams = r4
    insts = _instances(12, ns=(20, 24, 18, 22), alpha=3.5)
    jb, tb = jax_pack(insts), pack_instances(insts, device="cpu")
    jstate0 = jsolver.get_init_state(jax.random.PRNGKey(4), jb,
                                     randomized=True)
    tstate0 = convert.state_from_jax(_np(jstate0), "cpu")
    assert isinstance(tstate0.aux, D.SeqDecimatorState)
    _, jstate, jcarry = jsolver.forward(
        jparams, jax.random.PRNGKey(5), jb, jstate0, 20, is_training=False,
        check_termination=True, finalize=False)
    _, tstate, tcarry = tsolver.forward(
        tparams, torch.Generator().manual_seed(0), tb, tstate0, 20,
        check_termination=True, finalize=False)
    for name in ("active_vars", "active_clauses", "solution", "is_sat"):
        np.testing.assert_array_equal(getattr(tcarry[0], name).numpy(),
                                      np.asarray(getattr(jcarry[0], name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tcarry[1].numpy(), np.asarray(jcarry[1]))
    np.testing.assert_array_equal(tstate.aux.counters.numpy(),
                                  np.asarray(jstate.aux.counters))
    real = np.asarray(jb.edge_mask) > 0
    for r, g in zip(tuple(jstate.prop) + tuple(jstate.dec),
                    tuple(tstate.prop) + tuple(tstate.dec)):
        np.testing.assert_allclose(g.numpy()[real], np.asarray(r)[real],
                                   rtol=0, atol=1e-4)
    # the run decimated, and every instance is still active or solved
    n_dec = fused_simplify(tb, init_problem_state(tb)).active_vars.sum()
    assert float(tcarry[0].active_vars.sum()) < float(n_dec) - 8


def test_params_from_jax_r4(r4):
    """The r4 tree loads into the np-d-np modules, every leaf, its widths
    read off the shapes; a missing, unknown or misshapen leaf raises."""
    jparams, tparams = r4[1], r4[3]
    tree = _np(jparams)
    assert set(tparams) == {"prop", "scorer"}
    assert isinstance(tparams["prop"], PR.NeuralPropagator)
    assert tparams["scorer"].var_agg.w1_a.weight.shape == (100, 50)
    assert tparams["prop"].var_agg.w1_a.weight.shape == (100, 51)
    n = sum(p.numel() for p in tparams.parameters())
    assert n == sum(np.size(x) for x in
                    jax.tree_util.tree_leaves(tree)) == 128700
    ckpt = convert.load_jax_checkpoint(neural.NP_D_NP_CHECKPOINT)
    for name, p in tparams.named_parameters():
        module, _, leaf = name.rpartition(".")
        node = ckpt["params"]
        for part in module.split("."):
            node = node[part]
        arr = node[{"weight": "w", "bias": "b"}[leaf]]
        np.testing.assert_array_equal(
            p.detach().numpy(), arr.T if arr.ndim == 2 else arr)

    def edited(fn):
        t = jax.tree_util.tree_map(lambda x: x, tree)
        fn(t)
        return t

    def no_classifier(t):
        del t["scorer"]["classifier"]["l2"]

    def extra_bias(t):
        t["scorer"]["classifier"]["l2"]["b"] = np.zeros(1, np.float32)

    def extra_module(t):
        t["dec"] = {}

    def misshapen(t):
        t["scorer"]["var_agg"]["w1_a"]["w"] = np.zeros((51, 100),
                                                       np.float32)

    for fn, err in ((no_classifier, KeyError), (extra_bias, KeyError),
                    (extra_module, KeyError), (misshapen, ValueError)):
        with pytest.raises(err):
            convert.params_from_jax(edited(fn), "cpu")


def test_assembly_builds_and_serves_replicated(r4):
    """The assembly's parts, its init state (two [E, 150] pairs and the
    decimator's bookkeeping, R times over with replication), and a short
    replicated solve whose prediction comes back in the batch's layout."""
    tsolver, tparams = r4[2], r4[3]
    assert tsolver.neural_prop and not tsolver.neural_dec
    assert tsolver.scorer_cfg.classifier_kind == "tanh"
    assert (tsolver.dec_cfg.tolerance, tsolver.dec_cfg.t_max) == (0.02, 10)
    assert set(tsolver.init_params("cpu")) == {"prop", "scorer"}
    tb = pack_instances(_instances(9, ns=(16, 18)), device="cpu")
    gen = torch.Generator().manual_seed(0)
    state = tsolver.get_init_state(gen, tb, randomized=True, replication=2)
    assert state.prop[0].shape == state.dec[1].shape == (2 * tb.num_edges,
                                                         150)
    assert state.aux.counters.shape == (2 * tb.batch_size,)
    with pytest.raises(ValueError):
        tsolver.forward({"prop": tparams["prop"]}, gen, tb, state, 1)
    (pred, _), out = tsolver.forward(tparams, gen, tb, state, 4,
                                     check_termination=True, replication=2)
    assert pred.shape == (tb.num_vars, 1)
    assert out.aux.has_prev.item() == 1.0


def test_fresh_init_leaves_the_callers_generator():
    """np_d_np_params(trained=False): the same parameters for one seed,
    others for another, and torch's default generator left as it was."""
    torch.manual_seed(123)
    before = torch.random.get_rng_state()
    a = neural.np_d_np_params("cpu", trained=False, seed=0)
    assert torch.equal(torch.random.get_rng_state(), before)
    b = neural.np_d_np_params("cpu", trained=False, seed=0)
    c = neural.np_d_np_params("cpu", trained=False, seed=1)
    pa, pb, pc = (list(p.parameters()) for p in (a, b, c))
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))
    assert not all(torch.equal(x, y) for x, y in zip(pa, pc))
