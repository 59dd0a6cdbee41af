"""In-batch replication: the port against the JAX package on the CPU.

`replicate_batch` (R copies of every instance, replica r of instance b at
row r*B + b) gives the JAX package's ids, signs, masks and pack-time
metadata, on a padded and an unpadded batch, with a CSR that describes
its real prefix (every row of replicas 0 to R-2, padding included, then
the last replica's real rows). `_deduplicate` picks what JAX's picks.
The replicated WalkSAT stops once every instance has a solved replica:
`local_search(replication=2)` against JAX's `walksat_block` chained with
its `block_done` (interpret mode, `PDP_FUSED_PASS=on`,
`PDP_WALKSAT_MEGA=on`) bit for bit, on batches where some instances are
solved by one replica only, so that the stop freezes the other. A
replicated p-d-p forward from JAX's replicated init state: the decimated
problem, the active flags, the edge mask and the counters EQUAL, as
tests/test_torch_solver.py holds R = 1. `compacting_solve(replicas=1)`
gives the bits it gave before replicas existed; `replicas=2` returns one
entry an instance, each reported solution verified with numpy.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import cnf_instance, random_ksat

from pdp_solver_tpu.fg.batch import pack_instances as jax_pack
from pdp_solver_tpu.fg.batch import replicate_batch as jax_replicate
from pdp_solver_tpu.problem.state import init_problem_state as jax_init
from pdp_solver_tpu.solvers import PDPSolver as JaxSolver
from pdp_solver_tpu.solvers import SolverConfig as JaxConfig
from pdp_solver_tpu.solvers import base as jbase

from pdp_solver_tpu_torch import convert
from pdp_solver_tpu_torch.fg.batch import pack_instances, replicate_batch
from pdp_solver_tpu_torch.ops import walksat
from pdp_solver_tpu_torch.problem.state import init_problem_state
from pdp_solver_tpu_torch.solvers import base as tbase
from pdp_solver_tpu_torch.solvers.base import (
    WALKSAT_K, PDPSolver, SolverConfig)
from pdp_solver_tpu_torch.solvers.compact import compacting_solve
from pdp_solver_tpu_torch.train.loss import cnf_evaluate
from pdp_solver_tpu_torch.utils.benchdata import make_ksat_set
from pdp_solver_tpu_torch.utils.headline import verify_solution

P_D_P = dict(model_type="p-d-p", tolerance=0.08, t_max=8,
             local_search_iterations=0, epsilon=0.5, simplify_rounds=1)
ID_FIELDS = ("edge_var", "edge_clause", "edge_sign", "var_batch",
             "clause_batch", "edge_mask", "var_mask", "clause_mask",
             "instance_mask", "label")
META_FIELDS = ("clause_width", "fast_var", "fast_clause", "var_window")


@pytest.fixture
def kernel_env(monkeypatch):
    monkeypatch.setenv("PDP_FUSED_PASS", "on")
    monkeypatch.setenv("PDP_WALKSAT_MEGA", "on")
    monkeypatch.setenv("PDP_SWEEP_DEC_FOLD", "off")
    monkeypatch.setenv("PDP_COMPILE_CACHE", "off")


def _instances(seed, n_inst=6, n=16, alpha=4.0, k=4):
    rng = np.random.default_rng(seed)
    return [cnf_instance(n, random_ksat(rng, n, int(n * alpha), k))
            for _ in range(n_inst)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_block_seeds(rng, n_blocks):
    seeds = []
    for _ in range(n_blocks):
        rng, r = jax.random.split(rng)
        seeds.append(int(jax.lax.bitcast_convert_type(
            jax.random.bits(r, (1,), jnp.uint32), jnp.int32)[0]))
    return seeds


def _check_csr(b):
    """The CSR of a replicated batch describes its real prefix: each edge
    of [0, num_real_edges) once in the var CSR under its own variable (in
    increasing order) and once in a clause's range (a real clause's range
    holds exactly its real edges); each variable and clause of the prefix
    in the range of the instance that var_batch / clause_batch names; the
    rows after num_instances own nothing."""
    e, f = b.num_real_edges, b.num_real_clauses
    ev, ec = b.edge_var.numpy(), b.edge_clause.numpy()
    vptr, perm = b.var_ptr.numpy(), b.var_perm.numpy()
    assert vptr[-1] == e and sorted(perm.tolist()) == list(range(e))
    for v in range(b.num_vars):
        run = perm[vptr[v]:vptr[v + 1]]
        assert (ev[run] == v).all() and (np.diff(run) > 0).all()
    cptr = b.clause_ptr.numpy()
    assert cptr[0] == 0 and cptr[f] == e and cptr[-1] == e
    assert (np.diff(cptr) >= 0).all()
    assert int(np.diff(cptr).max()) == b.clause_max_degree
    cm, em = b.clause_mask.numpy(), b.edge_mask.numpy()
    for c in range(f):
        lo, hi = cptr[c], cptr[c + 1]
        if cm[c] > 0:
            own = np.flatnonzero((ec == c) & (em > 0))
            assert list(range(lo, hi)) == own.tolist()
        else:
            assert (em[lo:hi] == 0).all()
    for ptr, ids in ((b.inst_var_ptr, b.var_batch),
                     (b.inst_clause_ptr, b.clause_batch)):
        ptr, ids = ptr.numpy(), ids.numpy()
        n_pre = ptr[b.num_instances]
        assert (ptr[b.num_instances:] == n_pre).all()
        row = np.searchsorted(ptr, np.arange(n_pre), side="right") - 1
        assert (row == ids[:n_pre]).all()
    assert b.max_instance_vars == int(np.diff(b.inst_var_ptr.numpy()).max())


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("bucket", [True, False])
def test_replicate_batch_matches_jax(k, bucket):
    insts = _instances(1, n_inst=3, alpha=4.0, k=k)
    jb = jax_pack(insts, bucket=bucket)
    tb = pack_instances(insts, device="cpu", bucket=bucket)
    assert tb.num_edges == jb.num_edges and tb.batch_size == jb.batch_size
    assert bucket == (tb.num_real_edges < tb.num_edges)
    for R in (2, 3):
        jr, tr = jax_replicate(jb, R), replicate_batch(tb, R)
        for name in ID_FIELDS:
            np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                          np.asarray(getattr(jr, name)),
                                          err_msg=name)
        for name in META_FIELDS:
            assert getattr(tr, name) == getattr(jr, name), name
        np.testing.assert_array_equal(tr.edge_var32.numpy(),
                                      tr.edge_var.numpy())
        n, E, B = tb.num_instances, tb.num_edges, tb.batch_size
        assert tr.num_instances == (R - 1) * B + n
        assert tr.num_real_edges == (R - 1) * E + tb.num_real_edges
        _check_csr(tr)
    assert replicate_batch(tb, 1) is tb


def test_deduplicate_matches_jax():
    """The first replica of least energy, energies with ties."""
    insts = _instances(2, n_inst=5, alpha=4.0, k=3)
    jr, tr = jax_replicate(jax_pack(insts), 3), replicate_batch(
        pack_instances(insts, device="cpu"), 3)
    rng = np.random.default_rng(3)
    pred = (rng.uniform(size=(jr.num_vars, 1)) > 0.5).astype(np.float32)
    jp, tp = jax_init(jr), init_problem_state(tr)
    ref = jbase._deduplicate(jr, jp, jnp.asarray(pred), 3)
    got = tbase._deduplicate(tr, tp, torch.from_numpy(pred), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    energy, _ = tbase._compute_energy(tr, tp, torch.from_numpy(2 * pred[:, 0]
                                                               - 1))
    e = energy.numpy().reshape(3, -1)[:, :len(insts)]
    # the pick is not always replica 0, and some instance has a tie
    assert (e.argmin(0) > 0).any()
    assert any(len(set(col)) < 3 for col in e.T.tolist())


@pytest.mark.parametrize("alpha,seed,iters,eps", [
    (7.0, 3, 64, 0.5),       # eight blocks, the stop inside them
    (4.0, 4, 13, -1.0),      # one block and a remainder of five
    (4.0, 6, 5, -1.0),       # the remainder alone
])
def test_local_search_replicated_matches_jax(kernel_env, alpha, seed, iters,
                                             eps):
    """local_search(replication=2) against JAX's blocks chained with its
    block_done, then its per-iteration loop with the same test (greedy
    where the remainder runs: JAX draws its noise there), bit for bit;
    some instance ends with one replica solved and the other not, and
    the result differs from a walk without the stop."""
    insts = _instances(seed, alpha=alpha)
    jr = jax_replicate(jax_pack(insts), 2)
    tr = replicate_batch(pack_instances(insts, device="cpu"), 2)
    assert walksat.use_walksat_block(tr)
    cfg = dict(model_type="walk-sat", epsilon=eps,
               local_search_iterations=iters)
    jsolver, tsolver = JaxSolver(JaxConfig(**cfg)), PDPSolver(
        SolverConfig(**cfg))
    pred = (np.random.default_rng(seed).uniform(size=(jr.num_vars, 1))
            > 0.5).astype(np.float32)
    key = jax.random.PRNGKey(9)
    ref = jsolver.local_search(key, jr, jax_init(jr), jnp.asarray(pred),
                               iters, replication=2)
    seeds = _jax_block_seeds(key, iters // WALKSAT_K)

    def run(replication):
        return tsolver.local_search(
            torch.Generator().manual_seed(0), tr, init_problem_state(tr),
            torch.from_numpy(pred), iters, seeds=seeds,
            replication=replication)

    got = run(2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    energy, _ = tbase._compute_energy(tr, init_problem_state(tr),
                                      2.0 * got[:, 0] - 1.0)
    e = energy.numpy().reshape(2, -1)[:, :len(insts)]
    assert ((e == 0).any(0)).all() and (e > 0).any()
    assert not torch.equal(got, run(1))


def test_walk_view_leaves_out_the_padding():
    """The real rows of a replicated padded batch (`FGBatch.real`, what
    the WalkSAT kernel walks): each row's real variables and clauses (the
    padding the replicas keep inside their last instance's ranges left
    out), the var-major CSR of the real edges, and so the packed batch's
    instance sizes and launch shape; its clause references stay inside
    each instance's real clauses. A packed batch's real rows are its
    ranges and CSR."""
    insts = _instances(5, n_inst=5, alpha=7.0)
    tb = pack_instances(insts, device="cpu")
    tr = replicate_batch(tb, 2)
    assert tr.max_instance_vars > tb.max_instance_vars
    assert tr.inner_padding and not tb.inner_padding
    view = tr.real
    B = tb.batch_size
    for r in range(2):
        np.testing.assert_array_equal(
            view.var_end[r * B:(r + 1) * B].numpy()
            - tr.inst_var_ptr[r * B:(r + 1) * B].numpy(),
            np.diff(tb.inst_var_ptr.numpy()))
        np.testing.assert_array_equal(
            view.clause_end[r * B:(r + 1) * B].numpy()
            - tr.inst_clause_ptr[r * B:(r + 1) * B].numpy(),
            np.diff(tb.inst_clause_ptr.numpy()))
    assert (view.max_vars, view.max_clauses) == (tb.max_instance_vars,
                                                 tb.max_instance_clauses)
    assert (view.num_vars, view.num_clauses, view.num_edges) == (
        int(tr.var_mask.sum()), int(tr.clause_mask.sum()),
        int(tr.edge_mask.sum()))
    assert walksat.launch_shape(tr) == walksat.launch_shape(tb)
    real = np.flatnonzero(tr.edge_mask.numpy() > 0)
    perm = view.var_perm.numpy()
    assert sorted(perm.tolist()) == real.tolist()
    ev = tr.edge_var.numpy()
    assert (np.diff(ev[perm]) >= 0).all()
    np.testing.assert_array_equal(
        np.diff(view.var_ptr.numpy()), np.bincount(ev[real],
                                                   minlength=tr.num_vars))
    vref, _ = walksat.clause_tables(tr)
    row = tr.clause_batch.numpy()[tr.edge_clause.numpy()[perm]]
    n_real = (view.clause_end - tr.inst_clause_ptr[:-1]).numpy()[row]
    assert ((vref.numpy() < n_real) & (vref.numpy() >= -1)).all()
    same = tb.real
    assert same.var_perm is tb.var_perm and same.var_ptr is tb.var_ptr
    np.testing.assert_array_equal(same.var_end.numpy(),
                                  tb.inst_var_ptr[1:].numpy())
    np.testing.assert_array_equal(same.clause_end.numpy(),
                                  tb.inst_clause_ptr[1:].numpy())
    assert (same.num_edges, same.max_vars) == (tb.num_real_edges,
                                               tb.max_instance_vars)


def test_walk_plain_stops_after_the_solving_block():
    """walksat_walk_plain with replicas: the blocks up to the first whose
    energies leave every instance a solved replica, no more."""
    insts = _instances(3, alpha=7.0)
    tr = replicate_batch(pack_instances(insts, device="cpu"), 2)
    problem = init_problem_state(tr)
    rng = np.random.default_rng(3)
    assign = torch.from_numpy(np.where(rng.uniform(size=tr.num_vars) > 0.5,
                                       1.0, -1.0).astype(np.float32))
    assign = assign * problem.active_vars
    kw = dict(batch=tr, active_vars=problem.active_vars,
              active_clauses=problem.active_clauses,
              em=tbase.compute_edge_mask(tr, problem), K=WALKSAT_K, eps=0.5)
    seeds = list(range(40, 52))
    a, stop = assign, None
    for j, s in enumerate(seeds):
        a, energy = walksat.walksat_block_plain(a, seed=s, **kw)
        if walksat.replicas_done(tr, energy, 2) > 0:
            stop = j
            break
    assert stop is not None and 0 < stop < len(seeds) - 1
    for fn in (walksat.walksat_walk_plain, walksat.walksat_walk):
        got, e_got = fn(assign, seeds=seeds, replicas=2, **kw)
        assert torch.equal(got, a) and torch.equal(e_got, energy)
    with pytest.raises(ValueError):
        walksat.walksat_walk(assign, seeds=seeds, replicas=3, **kw)


def test_forward_replicated_matches_jax(kernel_env):
    """A 60-iteration replicated p-d-p forward with check_termination from
    JAX's replicated init state, at the shared set's density (4-SAT,
    alpha 9): the problem, the flags, the edge mask, the counters and the
    solved flags equal; an instance that one replica solved has stopped
    in both."""
    insts = _instances(0, n_inst=6, n=20, alpha=9.0)
    jb = jax_pack(insts)
    tb = pack_instances(insts, device="cpu")
    jsolver = JaxSolver(JaxConfig(**P_D_P))
    tsolver = PDPSolver(SolverConfig(**P_D_P))
    jstate0 = jsolver.get_init_state(jax.random.PRNGKey(3), jb,
                                     randomized=True, replication=2)
    tstate0 = convert.state_from_jax(_np(jstate0), "cpu")
    _, jstate, (jprob, jactive, jem) = jsolver.forward(
        {}, jax.random.PRNGKey(4), jb, jstate0, 60, is_training=False,
        check_termination=True, replication=2, finalize=False)
    _, tstate, (tprob, tactive, tem) = tsolver.forward(
        {}, torch.Generator().manual_seed(0), tb, tstate0, 60,
        check_termination=True, replication=2, finalize=False)
    for name in ("active_vars", "active_clauses", "solution", "is_sat"):
        np.testing.assert_array_equal(getattr(tprob, name).numpy(),
                                      np.asarray(getattr(jprob, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tactive.numpy(), np.asarray(jactive))
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    np.testing.assert_array_equal(tstate.aux.counters.numpy(),
                                  np.asarray(jstate.aux.counters))
    tr = replicate_batch(tb, 2)
    solved = cnf_evaluate(tr, tprob.solution[:, None])[0].numpy()
    solved = solved.reshape(2, -1)[:, :len(insts)]
    active = tactive.numpy().reshape(2, -1)[:, :len(insts)]
    split = solved[0] != solved[1]
    assert split.any() and (active[:, split] == 0).all()
    # the finalized prediction comes back in the batch's own layout
    (pred, _), _ = tsolver.forward(
        {}, torch.Generator().manual_seed(0), tb,
        tsolver.get_init_state(torch.Generator().manual_seed(1), tb,
                               randomized=True, replication=2), 5,
        check_termination=True, replication=2)
    assert pred.shape == (tb.num_vars, 1)


def _digest(sols):
    h = hashlib.sha256()
    for s in sols:
        h.update(np.ascontiguousarray(s, np.float32).tobytes())
    return h.hexdigest()[:16]


def test_compacting_solve_replicas():
    """replicas=1 gives the bits the solve gave before replicas existed
    (the solved flags and a digest of the solutions, recorded from that
    code on this input and generator; the run compacts once and runs
    local search); replicas=2 returns one verified entry an instance."""
    insts = make_ksat_set(count=12, n=40)
    solver = PDPSolver(SolverConfig(**dict(
        P_D_P, t_max=30, local_search_iterations=40)))

    def solve(**kw):
        return compacting_solve(
            solver, {}, torch.Generator().manual_seed(5), insts, 160,
            ls_iterations=40, chunk=20, schedule=[(80, 20), (80, 20)],
            min_edges=1000, device="cpu", **kw)

    sols, solved, stats = solve(replicas=1)
    assert solved == [False, True, False, True, False, False, True, True,
                      True, True, True, True]
    assert _digest(sols) == "11d4349b41206fb0"
    assert stats["compactions"] == [
        {"iter": 80, "instances": 8, "edges": 16384}]
    sols2, solved2, stats2 = solve(replicas=2)
    assert len(sols2) == len(solved2) == len(insts)
    for inst, sol, ok in zip(insts, sols2, solved2):
        assert sol.shape == (inst[0],)
        assert verify_solution(inst, sol) == ok
    assert stats2["solved"] == sum(solved2) >= sum(solved)
    assert stats2["attempts"][0]["instances"] == len(insts)
