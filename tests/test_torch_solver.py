"""The p-d-p solver: the port against the JAX package on the CPU.

A whole p-d-p forward (the hot loop: SP sweep, decimation, simplification,
verification, mask refresh) starts in both packages from the same messages,
handed over with convert.state_from_jax. The JAX side runs its Pallas
kernels in interpret mode; both packages take the unfolded path
(PDP_SWEEP_DEC_FOLD=off; the sweep folds, the card's default, are held
against JAX in tests/test_torch_sweep_fold.py).
Tolerance: the decimated problem, the active flags, the decimator counters
and the solved flags must be EQUAL; the messages, sums of logs taken in
another order and fed back through up to 60 sweeps, agree to atol 1e-3 on
real edges after the run (one sweep agrees to 1e-6, see
test_torch_modules.py). The instances sit at the shared set's density
(4-SAT, alpha 9): below the SP threshold the surveys go paramagnetic, every
|score| is rounding noise, and which variable is fixed first is decided by
the order of a sum, in any two implementations.

WalkSAT: given the same block seeds the local search is bit-exact (the
hash RNG is reproduced); the per-iteration remainder draws from torch's
generator, so it is compared greedy (eps < 0), where it uses no random
numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import cnf_instance, random_ksat

from pdp_solver_tpu.fg.batch import pack_instances as jax_pack
from pdp_solver_tpu.problem.state import init_problem_state as jax_init
from pdp_solver_tpu.solvers import PDPSolver as JaxSolver
from pdp_solver_tpu.solvers import SolverConfig as JaxConfig
from pdp_solver_tpu.train.loss import cnf_evaluate as jax_cnf_evaluate

from pdp_solver_tpu_torch import convert
from pdp_solver_tpu_torch.fg.batch import pack_instances
from pdp_solver_tpu_torch.problem.simplify import fused_simplify
from pdp_solver_tpu_torch.problem.state import init_problem_state
from pdp_solver_tpu_torch.solvers.base import (
    WALKSAT_K, PDPSolver, SolverConfig, build_solver)
from pdp_solver_tpu_torch.solvers.compact import compacting_solve
from pdp_solver_tpu_torch.train.loss import cnf_evaluate
from pdp_solver_tpu_torch.utils.benchdata import make_ksat_set

SETTINGS = dict(model_type="p-d-p", tolerance=0.08, t_max=8,
                local_search_iterations=0, epsilon=0.5, simplify_rounds=1)


@pytest.fixture
def kernel_env(monkeypatch):
    monkeypatch.setenv("PDP_FUSED_PASS", "on")
    monkeypatch.setenv("PDP_WALKSAT_MEGA", "on")
    monkeypatch.setenv("PDP_SWEEP_DEC_FOLD", "off")


def _instances(seed, n_inst=6, n=20, alpha=4.0, k=4):
    rng = np.random.default_rng(seed)
    return [cnf_instance(n, random_ksat(rng, n, int(n * alpha), k))
            for _ in range(n_inst)]


def _verify(inst, sol01):
    n, m, gmap, signs, _ = inst
    lit = np.where(signs > 0, sol01[gmap[0]], 1.0 - sol01[gmap[0]])
    sat = np.zeros(m)
    np.add.at(sat, gmap[1], lit > 0.5)
    return bool((sat > 0).all())


@pytest.mark.parametrize("iters,check", [(30, True), (60, True),
                                         (30, False)])
def test_forward_matches_jax_from_same_state(kernel_env, iters, check):
    insts = _instances(0, alpha=9.0)
    jb = jax_pack(insts)
    tb = pack_instances(insts, device="cpu")
    jsolver = JaxSolver(JaxConfig(**SETTINGS))
    tsolver = PDPSolver(SolverConfig(**SETTINGS))
    jstate0 = jsolver.get_init_state(jax.random.PRNGKey(3), jb,
                                     randomized=True)
    tstate0 = convert.state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate0), "cpu")

    _, jstate, (jprob, jactive, jem) = jsolver.forward(
        {}, jax.random.PRNGKey(4), jb, jstate0, iters, is_training=False,
        check_termination=check, finalize=False)
    _, tstate, (tprob, tactive, tem) = tsolver.forward(
        {}, torch.Generator().manual_seed(0), tb, tstate0, iters,
        check_termination=check, finalize=False)

    for f in ("active_vars", "active_clauses", "solution", "is_sat"):
        np.testing.assert_array_equal(getattr(tprob, f).numpy(),
                                      np.asarray(getattr(jprob, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(tactive.numpy(), np.asarray(jactive))
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    jsolved, _ = jax_cnf_evaluate(jb, jprob.solution[:, None])
    tsolved, _ = cnf_evaluate(tb, tprob.solution[:, None])
    np.testing.assert_array_equal(tsolved.numpy(), np.asarray(jsolved))
    m = np.asarray(jb.edge_mask) > 0
    for r, g in zip(jstate.prop.var + jstate.prop.fn,
                    tstate.prop.var + tstate.prop.fn):
        np.testing.assert_allclose(g.numpy()[m], np.asarray(r)[m],
                                   rtol=0, atol=1e-3)
    np.testing.assert_array_equal(tstate.aux.counters.numpy(),
                                  np.asarray(jstate.aux.counters))
    # the run decimated
    assert float(tprob.active_vars.sum()) < float(
        fused_simplify(tb, init_problem_state(tb)).active_vars.sum())


def _jax_block_seeds(rng, n_blocks):
    seeds = []
    for _ in range(n_blocks):
        rng, r = jax.random.split(rng)
        seeds.append(int(jax.lax.bitcast_convert_type(
            jax.random.bits(r, (1,), jnp.uint32), jnp.int32)[0]))
    return seeds


@pytest.mark.parametrize("iters,eps", [(16, 0.5), (19, -1.0)])
def test_local_search_matches_jax(kernel_env, iters, eps):
    insts = _instances(1, n_inst=5, n=16, alpha=4.0, k=3)
    jb = jax_pack(insts)
    tb = pack_instances(insts, device="cpu")
    cfg = dict(SETTINGS, local_search_iterations=iters, epsilon=eps)
    jsolver, tsolver = JaxSolver(JaxConfig(**cfg)), PDPSolver(
        SolverConfig(**cfg))
    pred = (np.random.default_rng(2).uniform(size=(jb.num_vars, 1))
            > 0.5).astype(np.float32)
    jprob = jax_init(jb)
    tprob = init_problem_state(tb)
    rng = jax.random.PRNGKey(9)
    ref = jsolver.local_search(rng, jb, jprob, jnp.asarray(pred), iters)
    got = tsolver.local_search(
        torch.Generator().manual_seed(0), tb, tprob, torch.from_numpy(pred),
        iters, seeds=_jax_block_seeds(rng, iters // WALKSAT_K))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_chunked_forward_equals_single_shot():
    insts = _instances(2)
    tb = pack_instances(insts, device="cpu")
    solver = PDPSolver(SolverConfig(**SETTINGS))
    state0 = solver.get_init_state(torch.Generator().manual_seed(1), tb,
                                   randomized=True)
    _, s1, c1 = solver.forward({}, None, tb, state0, 40,
                               check_termination=True, finalize=False)
    state, carry = state0, None
    for _ in range(4):
        _, state, carry = solver.forward({}, None, tb, state, 10,
                                         check_termination=True,
                                         carry=carry, finalize=False)
    for a, b in zip((c1[0].solution, c1[0].active_vars, c1[1], c1[2],
                     s1.prop.fn[0], s1.aux.counters),
                    (carry[0].solution, carry[0].active_vars, carry[1],
                     carry[2], state.prop.fn[0], state.aux.counters)):
        assert torch.equal(a, b)


def test_finalize_with_local_search_solves_and_verifies():
    insts = _instances(3, n_inst=4, n=16, alpha=3.0, k=3)
    tb = pack_instances(insts, device="cpu")
    solver = PDPSolver(SolverConfig(**dict(SETTINGS,
                                           local_search_iterations=100)))
    gen = torch.Generator().manual_seed(0)
    (pred, _), _ = solver.forward(
        {}, gen, tb, solver.get_init_state(gen, tb, randomized=True), 50,
        check_termination=True)
    solved, _ = cnf_evaluate(tb, pred)
    off = 0
    for inst, ok in zip(insts, solved.numpy()):
        assert _verify(inst, pred[off:off + inst[0], 0].numpy()) == bool(ok)
        off += inst[0]
    assert solved[:4].sum() >= 3


def test_compacting_solve_verified_on_small_shared_set():
    insts = make_ksat_set(count=16, n=50)
    solver = PDPSolver(SolverConfig(**dict(SETTINGS, t_max=50,
                                           local_search_iterations=100)))
    sols, solved, stats = compacting_solve(
        solver, {}, torch.Generator().manual_seed(0), insts, 300,
        ls_iterations=100, chunk=50, schedule=[(150, 50), (150, 50)],
        min_edges=1000, device="cpu")
    for inst, sol, ok in zip(insts, sols, solved):
        assert _verify(inst, sol) == ok
    assert stats["compactions"], "the batch never compacted"
    assert sum(solved) >= 6
    assert stats["solved"] == sum(solved)


def test_convert_and_build():
    assert convert.params_from_jax({}) == {}
    with pytest.raises(KeyError):
        convert.params_from_jax({"prop": {}})
    solver = build_solver({"model_type": "p-d-p", "tolerance": 0.1,
                           "local_search_iteration": 7})
    assert solver.cfg.tolerance == 0.1
    assert solver.cfg.local_search_iterations == 7
    # p-nd-np is ported: the assembly builds, with its SP adaptors
    assert PDPSolver(SolverConfig(model_type="p-nd-np")
                     ).prop_cfg.include_adaptors
    # np-d-np is ported: the assembly builds, with the sequential decimator
    npdnp = PDPSolver(SolverConfig(model_type="np-d-np", t_max=10))
    assert npdnp.neural_prop and not npdnp.neural_dec
    assert npdnp.dec_cfg.t_max == 10
    with pytest.raises(ValueError):
        PDPSolver(SolverConfig(model_type="nope"))
    jb = jax_pack(_instances(4, n_inst=2))
    jp = jax.tree_util.tree_map(np.asarray, jax_init(jb))
    tp = convert.state_from_jax(jp, "cpu")
    np.testing.assert_array_equal(tp.solution.numpy(), jp.solution)
    tb = pack_instances(_instances(4, n_inst=2), device="cpu")
    assert torch.equal(fused_simplify(tb, tp).active_vars,
                       fused_simplify(tb, init_problem_state(tb))
                       .active_vars)


def test_energy_helpers_match_jax():
    from pdp_solver_tpu.solvers import base as jbase
    from pdp_solver_tpu_torch.solvers import base as tbase
    insts = _instances(5, n_inst=3, n=16, alpha=4.0, k=3)
    jb = jax_pack(insts)
    tb = pack_instances(insts, device="cpu")
    rng = np.random.default_rng(6)
    assign = rng.choice([-1.0, 0.0, 1.0], jb.num_vars).astype(np.float32)
    em = (np.asarray(jb.edge_mask)
          * (rng.uniform(size=jb.num_edges) > 0.2)).astype(np.float32)
    jp, tp = jax_init(jb), init_problem_state(tb)
    for r, g in zip(jbase._compute_energy(jb, jp, jnp.asarray(assign)),
                    tbase._compute_energy(tb, tp, torch.from_numpy(assign))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(
        tbase._compute_energy_diff(tb, tp, torch.from_numpy(assign),
                                   torch.from_numpy(em)).numpy(),
        np.asarray(jbase._compute_energy_diff(jb, jp, jnp.asarray(assign),
                                              jnp.asarray(em))))
    solved = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0])
    np.testing.assert_array_equal(
        tbase._group_any(solved, 2).numpy(),
        np.asarray(jbase._group_any(jnp.asarray(solved.numpy()), 2)))
