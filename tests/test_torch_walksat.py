"""WalkSAT's one-launch walk (`ops/walksat.py walksat_walk`, kernel 3 of
PERF.md) on the CPU, against the JAX package.

The plain multi-block form (and the wrapper, which runs it for a batch on
the CPU) against JAX's `walksat_block` in interpret mode
(`PDP_FUSED_PASS=on`) chained over the same seeds: assignments bit for bit
(int32 views) and energies exactly, greedy and eps-greedy, with some
variables and clauses inactive, instances that reach 0 energy part-way
through and others that do not, and a seed whose salts wrap around int32.
`PDPSolver.local_search` against a loop of `walksat_block_plain` with one
`random_seed32` draw a block, so the solver's seed stream is unchanged,
with and without a remainder of chained-pass iterations. The launch plan:
cached per batch and raising on a wrong shape, dtype, device, K or seed
count; the kernel's launch shape on the shared set, a compacted batch, the
hub (one variable in 63,488 clauses: its edges stay in global memory) and
a large banded instance (30,000 variables: its variables too), and a batch
of mixed clause widths, which the kernel refuses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import cnf_instance, random_ksat

from pdp_solver_tpu.fg.batch import pack_instances as jax_pack
from pdp_solver_tpu.ops import pallas_walksat as jw
from pdp_solver_tpu.problem import state as jstate

from pdp_solver_tpu_torch.fg.batch import pack_instances
from pdp_solver_tpu_torch.ops import walksat
from pdp_solver_tpu_torch.problem.state import (
    compute_edge_mask, init_problem_state)
from pdp_solver_tpu_torch.solvers.base import (
    WALKSAT_K, PDPSolver, SolverConfig, random_seed32)
from pdp_solver_tpu_torch.utils.bench_kernels import (
    hub_instance, large_instance)
from pdp_solver_tpu_torch.utils.benchdata import make_ksat_set

# 2**31 - 7 + kk * 1000003 wraps around int32 from kk = 1
SEEDS = [5, 123456789, -2023, 2**31 - 7]


def _instances(seed=13, n_inst=4, n=16, alpha=3.0, k=3):
    rng = np.random.default_rng(seed)
    return [cnf_instance(n, random_ksat(rng, n, int(n * alpha), k))
            for _ in range(n_inst)]


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _j(x):
    return jnp.asarray(np.asarray(x, dtype=np.float32))


def _inputs(n_vars, n_clauses, var_mask, clause_mask):
    """Some variables and clauses inactive, a random +-1 fill."""
    rng = np.random.default_rng(12)
    av = np.asarray(var_mask) * (rng.uniform(size=n_vars) > 0.1)
    ac = np.asarray(clause_mask) * (rng.uniform(size=n_clauses) > 0.1)
    av, ac = av.astype(np.float32), ac.astype(np.float32)
    assign = (av * rng.choice([-1.0, 1.0], n_vars)).astype(np.float32)
    return assign, av, ac


@pytest.mark.parametrize("eps", [-1.0, 0.5])
def test_walk_matches_jax_chained(monkeypatch, eps):
    """The plain walk and the wrapper on the CPU equal JAX's kernel called
    once per seed, K = 6, bit for bit."""
    monkeypatch.setenv("PDP_FUSED_PASS", "on")
    insts = _instances()
    jb = jax_pack(insts)
    tb = pack_instances(insts, device="cpu")
    assert jw.use_walksat_mega(jb) and walksat.use_walksat_block(tb)
    assign, av, ac = _inputs(jb.num_vars, jb.num_clauses, jb.var_mask,
                             jb.clause_mask)
    em = np.asarray(jstate.compute_edge_mask(
        jb, jstate.ProblemState(_j(av), _j(ac), _j(av * 0 + 0.5),
                                _j(np.full(jb.batch_size, 0.5)))))
    a_ref, energies = _j(assign), []
    for seed in SEEDS:
        a_ref, e_ref = jw.walksat_block(
            a_ref, batch=jb, active_vars=_j(av), active_clauses=_j(ac),
            em=_j(em), K=6, seed=jnp.int32(seed), eps=eps, interpret=True)
        energies.append(np.asarray(e_ref))
    kw = dict(batch=tb, active_vars=_t(av), active_clauses=_t(ac),
              em=_t(em), K=6, seeds=SEEDS, eps=eps)
    for fn in (walksat.walksat_walk_plain, walksat.walksat_walk):
        a_got, e_got = fn(_t(assign), **kw)
        np.testing.assert_array_equal(a_got.numpy().view(np.int32),
                                      np.asarray(a_ref).view(np.int32))
        np.testing.assert_array_equal(e_got.numpy(), energies[-1])
    # every instance starts unsat; some are solved part-way, some are not
    n = len(insts)
    _, e0 = walksat.walksat_block_plain(
        _t(assign), batch=tb, active_vars=_t(av), active_clauses=_t(ac),
        em=_t(em), K=1, seed=0, eps=eps)
    assert (e0[:n] > 0).all()
    final = energies[-1][:n]
    assert (final == 0).any() and (final > 0).any()
    assert (energies[0][:n] > 0).sum() > (final > 0).sum()


@pytest.mark.parametrize("extra", [0, 3])
def test_local_search_keeps_the_seed_stream(extra):
    """local_search draws one random_seed32 a block before its launch, so
    it gives the bits of a loop of walksat_block_plain with one draw a
    block, and leaves the generator where that loop does; a remainder of
    `extra` iterations then runs the chained pass from there."""
    insts = _instances(seed=14)
    tb = pack_instances(insts, device="cpu")
    assert walksat.use_walksat_block(tb)
    solver = PDPSolver(SolverConfig(model_type="walk-sat", epsilon=0.5))
    problem = init_problem_state(tb)
    _, av, ac = _inputs(tb.num_vars, tb.num_clauses, tb.var_mask,
                        tb.clause_mask)
    problem = problem.replace(active_vars=_t(av), active_clauses=_t(ac))
    pred = torch.from_numpy(np.random.default_rng(4).uniform(
        size=(tb.num_vars, 1)).astype(np.float32))
    iters = 3 * WALKSAT_K + extra
    got = solver.local_search(torch.Generator().manual_seed(21), tb,
                              problem, pred, iters)

    gen = torch.Generator().manual_seed(21)
    a = problem.active_vars * (2.0 * (pred[:, 0] > 0.5).float() - 1.0)
    em = compute_edge_mask(tb, problem)
    for _ in range(3):
        a, _ = walksat.walksat_block_plain(
            a, batch=tb, active_vars=problem.active_vars,
            active_clauses=problem.active_clauses, em=em, K=WALKSAT_K,
            seed=random_seed32(gen), eps=0.5)
    ref = ((a + 1.0) / 2.0)[:, None]
    if extra:
        ref = solver.local_search(gen, tb, problem, ref, extra)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  ref.numpy().view(np.int32))


def test_local_search_takes_a_seed_a_block():
    """Given seeds, local_search runs one block on each of the first
    iterations // K of them, as walksat_walk_plain does, and raises when
    there are fewer seeds than blocks rather than dropping flips."""
    insts = _instances(seed=15)
    tb = pack_instances(insts, device="cpu")
    solver = PDPSolver(SolverConfig(model_type="walk-sat", epsilon=0.5))
    problem = init_problem_state(tb)
    pred = torch.from_numpy(np.random.default_rng(5).uniform(
        size=(tb.num_vars, 1)).astype(np.float32))
    iters = 3 * WALKSAT_K
    got = solver.local_search(torch.Generator().manual_seed(0), tb,
                              problem, pred, iters, seeds=SEEDS)
    a = problem.active_vars * (2.0 * (pred[:, 0] > 0.5).float() - 1.0)
    a, _ = walksat.walksat_walk_plain(
        a, batch=tb, active_vars=problem.active_vars,
        active_clauses=problem.active_clauses,
        em=compute_edge_mask(tb, problem), K=WALKSAT_K, seeds=SEEDS[:3],
        eps=0.5)
    np.testing.assert_array_equal(
        got.numpy().view(np.int32),
        ((a + 1.0) / 2.0)[:, None].numpy().view(np.int32))
    with pytest.raises(ValueError, match="3 block seeds, got 2"):
        solver.local_search(torch.Generator().manual_seed(0), tb, problem,
                            pred, iters, seeds=SEEDS[:2])


def test_walk_plan_is_cached_and_checks():
    """One plan per batch, no argument block for a batch on the CPU; a
    wrong shape, dtype or device, K < 1 or no seed raises, before and
    after good calls."""
    b = pack_instances(_instances(), device="cpu")
    other = pack_instances(_instances(seed=14), device="cpu")
    assign, av, ac = (_t(x) for x in _inputs(
        b.num_vars, b.num_clauses, b.var_mask, b.clause_mask))
    em = b.edge_mask.clone()
    kw = dict(batch=b, active_vars=av, active_clauses=ac, em=em, K=4,
              seeds=SEEDS[:2], eps=0.5)
    ref = walksat.walksat_walk(assign, **kw)
    plan = walksat._plan(b)
    assert walksat._plan(b) is plan
    assert walksat._plan(other) is not plan
    assert plan.args is None
    bad = [dict(kw, active_vars=av[:-1]), dict(kw, em=em.double()),
           dict(kw, active_clauses=av), dict(kw, em=em.to("meta")),
           dict(kw, active_vars=av.to("meta")), dict(kw, K=0),
           dict(kw, seeds=[]),
           dict(kw, edge_constants=(em, em[:-1]))]
    for case in bad:
        with pytest.raises(ValueError):
            walksat.walksat_walk(assign, **case)
    for x in (assign[:-1], assign.long()):
        with pytest.raises(ValueError):
            walksat.walksat_walk(x, **kw)
    got = walksat.walksat_walk(assign, **kw)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.fixture(scope="module")
def shapes():
    insts = make_ksat_set()
    return {"shared": insts, "compacted": insts[:8],
            "hub": [hub_instance()], "large": [large_instance()]}


@pytest.mark.parametrize("which,threads,stage_vars,stage_edges", [
    ("shared", 256, True, True), ("compacted", 256, True, True),
    ("hub", 1024, True, False), ("large", 1024, False, False)])
def test_launch_shape(shapes, which, threads, stage_vars, stage_edges):
    """A thread for each variable and every 4 clauses of the largest
    instance, 64 to 1024; the variables, then the clauses, in shared
    memory where they fit.
    The large instance is one that the block rule takes with more
    variables (30,000) than one CTA's shared memory holds."""
    b = pack_instances(shapes[which], device="cpu")
    assert walksat.use_walksat_block(b)
    assert walksat.launch_shape(b) == (threads, stage_vars, stage_edges)
    if which == "large":
        assert b.max_instance_vars == 30000 and b.num_vars == 32768


def test_launch_shape_refuses_mixed_widths():
    rng = np.random.default_rng(2)
    insts = [cnf_instance(12, random_ksat(rng, 12, 30, k))
             for k in (3, 4)]
    b = pack_instances(insts, device="cpu")
    assert b.clause_width == 0 and not walksat.use_walksat_block(b)
    with pytest.raises(ValueError):
        walksat.launch_shape(b)


def test_clause_tables():
    """vref lists each variable's clauses (local to its instance) in the
    var-major CSR's order, -1 on a clause's later slots of one variable;
    lv holds each clause's local variables, 4 slots a clause."""
    insts = _instances(seed=15, n_inst=3, n=10, alpha=2.0, k=3)
    n, m, gmap, signs, label = insts[1]
    gmap = gmap.copy()
    gmap[0, 3 * 2 + 2] = gmap[0, 3 * 2]           # clause 2 holds a var twice
    insts[1] = (n, m, gmap, signs, label)
    b = pack_instances(insts, device="cpu")
    vref, lv = walksat.clause_tables(b)
    ev = b.edge_var[:b.num_real_edges].numpy()
    ec = b.edge_clause[:b.num_real_edges].numpy()
    icp, ivp = b.inst_clause_ptr.numpy(), b.inst_var_ptr.numpy()
    cb = b.clause_batch.numpy()
    want = []
    for q, e in enumerate(b.var_perm.numpy()):
        c = ec[e]
        first = e == 3 * c + list(ev[3 * c:3 * c + 3]).index(ev[e])
        want.append(c - icp[cb[c]] if first else -1)
    np.testing.assert_array_equal(vref.numpy(), want)
    assert (vref.numpy() == -1).sum() == 1
    lv = lv.numpy().reshape(-1, 4)
    np.testing.assert_array_equal(lv[:, 3], 0)
    np.testing.assert_array_equal(
        lv[:, :3], ev.reshape(-1, 3) - ivp[cb[:b.num_real_clauses]][:, None])
