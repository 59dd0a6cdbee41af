"""The CUDA kernels against their plain versions, on the card.

Marked `gpu`: each test skips when torch sees no CUDA card (decided inside
the fixture, never at import). On the card's machine run them with
`python -m pytest tests/test_torch_gpu.py -m gpu`. Tolerances as in
chip_smoke.py: flags and counts exact, float sums rtol 1e-5 / atol 1e-6
(the [E, d] segment sum rtol 1e-5 / atol 1e-5), walksat_block and the
[E, d] gather bit-exact. The multi-column segment sum (kernels 4, 5 and
8) is exact on signed integer-valued columns, its sums of non-negative
floats (as the path's are) and the one-launch SP sweep (kernel 9) to rtol
1e-5 / atol 1e-6 (the plain versions sum with atomics on the card). The
log-input sweep (kernel 9, login=True) also bit for bit against the two
launches it replaces (`sp_chain_login`, `sp_pass_c`), and the verification
with masks (kernel 10) exactly against its plain version and the split
path, on every edge. The group walk of kernels 4, 5, 8 and of kernel 1's
var side (`csrc/common.cuh`) also bit for bit against its order emulated
in PyTorch (`ops/reduce.py walk_order_sum`), with the same bits on two
calls, on a compacted batch (8 instances), one instance and a variable of
63,488 edges.
"""

import numpy as np
import pytest
import torch

from pdp_solver_tpu_torch.fg.batch import pack_instances
from pdp_solver_tpu_torch.ops import (
    _build, fused, reduce, sp_sweep, verify, walksat)
from pdp_solver_tpu_torch.problem.state import (
    edge_masks_pair, init_problem_state)
from pdp_solver_tpu_torch.train.loss import cnf_evaluate
from pdp_solver_tpu_torch.utils.benchdata import make_ksat_set

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def batches():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    insts = make_ksat_set(count=6, n=60)
    return (pack_instances(insts, device="cpu"),
            pack_instances(insts, device="cuda"))


def _inputs(fn, batch, seed):
    g = torch.Generator().manual_seed(seed)
    sizes = {"V": batch.num_vars, "F": batch.num_clauses,
             "E": batch.num_edges}
    real = {"V": batch.var_mask, "F": batch.clause_mask,
            "E": batch.edge_mask}
    out = []
    for i, kind in enumerate(fn.layout):
        x = torch.rand(sizes[kind], generator=g) * 0.96 + 0.02
        if i % 2:
            x = (x > 0.3).float() * real[kind].cpu()
        out.append(x)
    return out


@pytest.mark.parametrize("fn", fused.FUSED_FNS + fused.CHAINED_FNS,
                         ids=lambda f: f.name)
def test_kernel_matches_plain(batches, fn):
    cpu, gpu = batches
    ins = _inputs(fn, cpu, 0)
    call = (fused.fused_edge_pass if fn in fused.FUSED_FNS
            else fused.chained_edge_pass)
    plain = (fused.fused_edge_pass_plain if fn in fused.FUSED_FNS
             else fused.chained_edge_pass_plain)
    ref = plain(fn, gpu, [x.cuda() for x in ins])
    got = call(fn, gpu, [x.cuda() for x in ins])
    torch.cuda.synchronize()
    m = gpu.edge_mask > 0
    for r, o in zip(ref, got):
        if r is None:
            assert o is None
            continue
        if isinstance(r, tuple):
            for a, b in zip(r, o):
                torch.testing.assert_close(b[m], a[m], rtol=1e-5, atol=1e-6)
        else:
            torch.testing.assert_close(o, r, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("eps", [-1.0, 0.5])
def test_walksat_block_matches_plain(batches, eps):
    _, gpu = batches
    g = torch.Generator().manual_seed(1)
    av = gpu.var_mask
    assign = (torch.randint(0, 2, (gpu.num_vars,), generator=g).float()
              * 2 - 1).cuda() * av
    em = gpu.edge_mask
    kw = dict(batch=gpu, active_vars=av, active_clauses=gpu.clause_mask,
              em=em, K=8, seed=77, eps=eps)
    a_ref, e_ref = walksat.walksat_block_plain(assign, **kw)
    a_got, e_got = walksat.walksat_block(assign, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a_got, a_ref) and torch.equal(e_got, e_ref)
    np.testing.assert_array_equal(a_got.cpu().numpy().view(np.int32),
                                  a_ref.cpu().numpy().view(np.int32))


@pytest.mark.parametrize("d", [50, 150, 37])
def test_reduce2d_kernels_match_plain(batches, d):
    """Kernel 6 to rtol 1e-5 / atol 1e-5 (the plain index_add_ on the card
    sums in atomic order), kernel 7 with and without the subtract bit for
    bit, padding rows included; the clause-major CSR (no permutation) too."""
    from pdp_solver_tpu_torch.ops import reduce2d
    _, gpu = batches
    g = torch.Generator().manual_seed(d)
    x = torch.randn(gpu.num_edges, d, generator=g).cuda()
    nodes = torch.randn(gpu.num_vars, d, generator=g).cuda()
    ev, V, e = gpu.edge_var, gpu.num_vars, gpu.num_real_edges
    got = reduce2d.segment_sum_2d(x, ev, V, e, gpu.var_ptr, gpu.var_perm)
    ref = reduce2d.segment_sum_2d_plain(x, ev, V, e)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    ec, F = gpu.edge_clause, gpu.num_clauses
    got = reduce2d.segment_sum_2d(x, ec, F, e, gpu.clause_ptr)
    ref = reduce2d.segment_sum_2d_plain(x, ec, F, e)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    for minus in (None, x):
        got = reduce2d.gather_2d(nodes, ev, minus)
        ref = reduce2d.gather_2d_plain(nodes, ev, minus)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)


def _ragged(rng, n_inst=5, n=300, m=500):
    """Instances of mixed clause widths (1-6) over random variables."""
    insts = []
    for _ in range(n_inst):
        widths = rng.integers(1, 7, size=m)
        ev = rng.integers(0, n, size=int(widths.sum())).astype(np.int32)
        ec = np.repeat(np.arange(m, dtype=np.int32), widths)
        signs = rng.choice([-1.0, 1.0], ev.shape[0]).astype(np.float32)
        insts.append((n, m, np.stack([ev, ec]), signs, -1.0))
    return pack_instances(insts, device="cuda")


@pytest.mark.parametrize("which", ["shared", "ragged"])
@pytest.mark.parametrize("C", [1, 2, 8])
def test_segment_sum_cols_matches_plain(batches, which, C):
    gpu = (batches[1] if which == "shared"
           else _ragged(np.random.default_rng(C)))
    assert (gpu.clause_width == 0) == (which == "ragged")
    g = torch.Generator().manual_seed(C)
    E, e = gpu.num_edges, gpu.num_real_edges
    for integer in (True, False):
        cols = [(torch.randint(-3, 4, (E,), generator=g).float() if integer
                 else torch.rand(E, generator=g)).cuda() for _ in range(C)]
        for ids, n, ptr, perm in (
                (gpu.edge_var, gpu.num_vars, gpu.var_ptr, gpu.var_perm),
                (gpu.edge_clause, gpu.num_clauses, gpu.clause_ptr, None)):
            ref = reduce.segment_sum_cols_plain(cols, ids, n, e)
            got = reduce.segment_sum_cols(cols, ids, n, e, ptr, perm)
            rows = reduce.segment_sum(torch.stack(cols, 1), ids, n, e, ptr,
                                      perm)
            torch.cuda.synchronize()
            if integer:
                assert torch.equal(got, ref) and torch.equal(rows.T, ref)
            else:
                torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
                assert torch.equal(rows.T, got)


def test_sorted_segment_sum_matches_plain(batches):
    _, gpu = batches
    g = torch.Generator().manual_seed(3)
    ids = gpu.var_batch
    x = torch.randint(-3, 4, (ids.shape[0],), generator=g).float().cuda()
    got = reduce.sorted_segment_sum(x, ids, gpu.batch_size)
    ref = reduce.sorted_segment_sum_plain(x, ids, gpu.batch_size)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def _sweep_inputs(batch, seed, pi):
    g = torch.Generator().manual_seed(seed)
    E = batch.num_edges

    def u(lo=0.0, hi=1.0):
        return (torch.rand(E, generator=g) * (hi - lo) + lo).cuda()

    v = torch.rand(E, 3, generator=g)
    v = (v / v.sum(1, keepdim=True)).cuda()
    return dict(u_like=u(0.01, 1.0), eta_in=u(0.0, 0.99),
                em=batch.edge_mask * (u() > 0.1).float(),
                mask=(u() > 0.2).float(), eta_state=u(), sign=batch.edge_sign,
                force=torch.where(u() > 0.5, 1.0, -1.0) if pi else u() * 0,
                v0=v[:, 0].contiguous(), v1=v[:, 1].contiguous(),
                v2=v[:, 2].contiguous())


@pytest.mark.parametrize("case", ["shared", "big_instance"])
@pytest.mark.parametrize("pi", [0.0, 0.01])
def test_sp_sweep_matches_plain_and_two_launch_path(batches, case, pi):
    """Against its plain version and against the two launches it
    replaces, on the shared-set batch and on an instance too large for
    the shared-memory sums (global scratch)."""
    if case == "shared":
        gpu = batches[1]
    else:
        gpu = pack_instances(make_ksat_set(count=2, n=7000, alpha=4.0, k=3),
                             device="cuda")
        assert gpu.max_instance_vars > sp_sweep.SMEM_VARS
    kw = _sweep_inputs(gpu, 11, pi)
    got = sp_sweep.sp_full_sweep(gpu, pi=pi, **kw)
    ref = sp_sweep.sp_full_sweep_plain(gpu, tuple(kw.values()), pi)
    _, pn, (eta2,), _ = fused.chained_edge_pass(
        fused.SP_CHAIN, gpu, (kw["u_like"], kw["eta_in"], kw["em"],
                              kw["mask"], kw["eta_state"], kw["sign"]))
    _, two = fused.fused_edge_pass(
        fused.SP_PASS_C, gpu,
        (pn[0], pn[1], kw["eta_in"], kw["em"], kw["mask"], kw["sign"],
         kw["force"], kw["v0"], kw["v1"], kw["v2"]), scalar=pi)
    torch.cuda.synchronize()
    for a, b, c in zip(got, ref, (eta2,) + tuple(two)):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-6)


def test_sp_sweep_login_bit_equal_to_two_launch_path(batches):
    """login=True (u given as log u): against its plain version, and bit
    for bit against `sp_chain_login` + `sp_pass_c`."""
    gpu = batches[1]
    kw = _sweep_inputs(gpu, 12, 0.0)
    kw["u_like"] = torch.log(kw["u_like"])
    got = sp_sweep.sp_full_sweep(gpu, login=True, **kw)
    ref = sp_sweep.sp_full_sweep_plain(gpu, tuple(kw.values()), 0.0,
                                       login=True)
    _, pn, (eta2,), _ = fused.chained_edge_pass(
        fused.SP_CHAIN_LOGIN, gpu, (kw["u_like"], kw["eta_in"], kw["em"],
                                    kw["mask"], kw["eta_state"], kw["sign"]))
    _, two = fused.fused_edge_pass(
        fused.SP_PASS_C, gpu,
        (pn[0], pn[1], kw["eta_in"], kw["em"], kw["mask"], kw["sign"],
         kw["force"], kw["v0"], kw["v1"], kw["v2"]), scalar=0.0)
    torch.cuda.synchronize()
    for a, b, c in zip(got, ref, (eta2,) + tuple(two)):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        assert torch.equal(a, c)


def _planted(rng, count, n, m, k):
    """Instances satisfied by a random assignment each (a clause that the
    assignment leaves unsatisfied gets its first literal flipped), and
    the assignments (0/1)."""
    insts, xs = [], []
    for _ in range(count):
        x = rng.integers(0, 2, size=n)
        v = rng.random((m, n)).argsort(1)[:, :k]
        s = rng.integers(0, 2, size=(m, k)) * 2 - 1
        sat = ((s > 0) == (x[v] > 0)).any(1)
        s[~sat, 0] *= -1
        insts.append((n, m, np.stack([v.reshape(-1), np.repeat(
            np.arange(m), k)]).astype(np.int32),
            s.reshape(-1).astype(np.float32), -1.0))
        xs.append(x.astype(np.float32))
    return insts, xs


def test_verify_and_masks_matches_plain_and_split_path():
    """Exactly, on solved, unsat, em and ae, on every edge: some variables
    and clauses inactive, instance 2 already stopped, a prediction that
    solves the even instances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(9)
    insts, xs = _planted(rng, 6, 60, 540, 4)
    gpu = pack_instances(insts, device="cuda")
    assert verify.use_verify_masks(gpu)
    pred = rng.uniform(size=gpu.num_vars).astype(np.float32)
    for b in range(0, 6, 2):
        pred[b * 60:(b + 1) * 60] = xs[b]
    p = torch.from_numpy(pred)[:, None].cuda()
    problem = init_problem_state(gpu)
    av, ac = problem.active_vars.clone(), problem.active_clauses.clone()
    av[::7] = 0.0
    ac[::5] = 0.0
    problem = problem.replace(active_vars=av, active_clauses=ac)
    act = gpu.instance_mask.clone()
    act[2] = 0.0
    got = verify.verify_and_masks(gpu, problem, act, p)
    ref = verify.verify_and_masks_plain(gpu, av, ac, act, p[:, 0])
    solved, unsat = cnf_evaluate(gpu, p)
    split = (solved, unsat) + edge_masks_pair(
        gpu, problem, act * (solved <= 0.5).float())
    torch.cuda.synchronize()
    for name, a, b, c in zip(("solved", "unsat", "em", "ae"), got, ref,
                             split):
        assert torch.equal(a, b), name
        assert torch.equal(a, c), name
    assert got[0][:6].tolist() == [1, 0, 1, 0, 1, 0]
    assert gpu.num_edges > gpu.num_real_edges


# --- the group walk (kernels 4, 5, 8 and kernel 1's var side) -------------

def _hub_batch(degree=63488, n=300, k=3, seed=5):
    """One instance whose variable 0 sits in every one of its `degree`
    clauses: a var CSR with one node of `degree` edges."""
    rng = np.random.default_rng(seed)
    v = rng.integers(1, n, size=(degree, k))
    v[:, 0] = 0
    ec = np.repeat(np.arange(degree), k)
    signs = rng.choice([-1.0, 1.0], degree * k).astype(np.float32)
    return pack_instances([(n, degree, np.stack(
        [v.reshape(-1), ec]).astype(np.int32), signs, -1.0)], device="cuda")


@pytest.fixture(scope="module")
def walk_batches(batches):
    """The small shared-set batch, one instance, the 8 instances of a
    32,768-edge bucket (a compacted batch) and one 63,488-edge variable."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = {"shared": batches[1],
           "single": pack_instances(make_ksat_set(count=1), device="cuda"),
           "compacted": pack_instances(make_ksat_set(count=8),
                                       device="cuda"),
           "hub": _hub_batch()}
    assert out["compacted"].num_edges == 32768
    return out


def _walk_ref(x, batch, side):
    """The kernel's order (ops/reduce.py walk_order_sum) for x f32[C, E]."""
    if side == "var":
        lo, hi = reduce.csr_bounds(batch.var_ptr)
        slot_edge = batch.var_perm.long()
        node_at = batch.edge_var[slot_edge]
    else:
        lo, hi = reduce.csr_bounds(batch.clause_ptr)
        slot_edge, node_at = None, batch.edge_clause
    g = _build.group_width(batch.num_real_edges, lo.shape[0])
    return reduce.walk_order_sum(x, lo, hi, slot_edge, g)


@pytest.mark.parametrize("which", ["shared", "single", "compacted", "hub"])
@pytest.mark.parametrize("C", [1, 2, 3, 4, 5, 6, 7, 8])
def test_segment_sum_cols_walk(walk_batches, which, C):
    """Kernel 4 for C = 1..8 over the var and clause CSRs: exact on
    integer columns, floats to rtol 1e-5 / atol 1e-6 of index_add_ and
    bit for bit the walk's emulated order; the [E, C] stride form equal
    to the column form; nodes with no edges 0; two calls the same bits,
    with the pack-time largest degree and without it."""
    gpu = walk_batches[which]
    g = torch.Generator().manual_seed(C)
    E, e = gpu.num_edges, gpu.num_real_edges
    for integer in (True, False):
        cols = [(torch.randint(-3, 4, (E,), generator=g).float() if integer
                 else torch.rand(E, generator=g)).cuda() for _ in range(C)]
        for side, ids, n, ptr, perm in (
                ("var", gpu.edge_var, gpu.num_vars, gpu.var_ptr,
                 gpu.var_perm),
                ("clause", gpu.edge_clause, gpu.num_clauses, gpu.clause_ptr,
                 None)):
            md = getattr(gpu, f"{side}_max_degree")
            ref = reduce.segment_sum_cols_plain(cols, ids, n, e)
            got = reduce.segment_sum_cols(cols, ids, n, e, ptr, perm,
                                          max_degree=md)
            again = reduce.segment_sum_cols(cols, ids, n, e, ptr, perm)
            rows = reduce.segment_sum(torch.stack(cols, 1), ids, n, e, ptr,
                                      perm)
            emu = _walk_ref(torch.stack(cols), gpu, side)
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            assert torch.equal(rows.T, got)
            assert torch.equal(got, emu)
            empty = (ptr[1:] == ptr[:-1])
            assert bool(empty.any()) and bool((got[:, empty] == 0).all())
            if integer:
                assert torch.equal(got, ref)
            else:
                torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["out_of_range", "padded_clause_ids"])
def test_sorted_segment_sum_walk(walk_batches, case):
    """Kernel 8: ids outside [0, N) dropped; the shared set's clause ids
    over all E edges, whose last run holds 63,488 padding edges (one
    block); exact, the emulated order's bits, twice the same bits."""
    if case == "out_of_range":
        rng = np.random.default_rng(8)
        n = 500
        ids = np.sort(np.concatenate([rng.integers(-3, n + 3, 20000),
                                      np.full(5000, 11)]))
        ids = torch.from_numpy(ids).cuda()
    else:
        full = pack_instances(make_ksat_set(), device="cuda")
        ids, n = full.edge_clause, full.num_clauses
        assert int((ids == full.num_real_clauses - 1).sum()) == 4 + 63488
    g = torch.Generator().manual_seed(9)
    for x in (torch.randint(-3, 4, ids.shape, generator=g).float().cuda(),
              torch.rand(ids.shape, generator=g).cuda()):
        got = reduce.sorted_segment_sum(x, ids, n)
        again = reduce.sorted_segment_sum(x, ids, n)
        ref = reduce.sorted_segment_sum_plain(x, ids, n)
        lo, hi = reduce.sorted_bounds(ids, n)
        gw = _build.group_width(ids.shape[0], n)
        emu = reduce.walk_order_sum(x[None], lo, hi, None, gw)[0]
        torch.cuda.synchronize()
        assert torch.equal(got, again) and torch.equal(got, emu)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    assert torch.equal(reduce.sorted_segment_sum(x, ids.int(), n), got)


@pytest.mark.parametrize("which", ["compacted", "hub", "shared"])
@pytest.mark.parametrize("fn", [fused.SMAX_SCORER, fused.SCORER],
                         ids=lambda f: f.name)
def test_var_side_fused_pass_walk(walk_batches, which, fn):
    """Kernel 1's var side (SmaxScorer, Scorer) through the group walk:
    against its plain version to rtol 1e-5 / atol 1e-6, and the same bits
    on two calls. For the 63,488-edge variable the plain version sums in
    float64: a float32 index_add_ of that many terms in atomic order is
    itself ~4e-5 off (measured on the H100), the walk's tree ~1e-6."""
    gpu = walk_batches[which]
    ins = [x.cuda() for x in _inputs(fn, gpu, 4)]
    if which == "hub":
        terms, _ = fn.plain([x.double() for x in ins], gpu.edge_var,
                            gpu.edge_clause, 0.0)
        e = gpu.num_real_edges
        ref = torch.zeros((fn.n_red, gpu.num_vars), dtype=torch.float64,
                          device="cuda").index_add_(
            1, gpu.edge_var[:e], torch.stack([t[:e] for t in terms])).float()
    else:
        ref, _ = fused.fused_edge_pass_plain(fn, gpu, ins)
    got, _ = fused.fused_edge_pass(fn, gpu, ins)
    again, _ = fused.fused_edge_pass(fn, gpu, ins)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
