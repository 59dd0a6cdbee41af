"""The CUDA kernels against their plain versions, on the card.

The p-d-p loop's sweep folds (kernels 1 and 2's `sp_chain_dec`,
`sp_chain_mask`, `sp_chain_maskv`, `sp_pass_c_lean`) take their inputs
as that loop has them (`_fold_inputs`: 0/1 flags, +-1 forces) and give,
from one loop state, the bits of the split passes they replace on the
small shared set, a compacted batch and the hub.

Marked `gpu`: each test skips when torch sees no CUDA card (decided inside
the fixture, never at import). On the card's machine run them with
`python -m pytest tests/test_torch_gpu.py -m gpu`. Tolerances as in
chip_smoke.py: flags and counts exact, float sums rtol 1e-5 / atol 1e-6
(the [E, d] segment sum rtol 1e-5 / atol 1e-5), walksat_block and the
[E, d] gather bit-exact. The one-launch WalkSAT walk (kernel 3) bit for
bit against its plain version for 1, 8 and 25 blocks, greedy and
eps-greedy, on the shared set, a compacted batch, the hub (its edges in
global memory) and a large banded instance of 30,000 variables (its
variables too); its replicated form (R = 2, a launch a block and a done
flag on the card) bit for bit against the plain walk with its replica
stop, on the shared set and a compacted batch. Kernels 1, 2 and 9 on
those two batches replicated twice (replica 0's padding inside the
prefix the kernels treat as real): every output row against the plain
version, kernel 9 also bit for bit against its two launches. The
multi-column segment sum (kernels 4, 5 and
8) is exact on signed integer-valued columns, its sums of non-negative
floats (as the path's are) and the one-launch SP sweep (kernel 9) to rtol
1e-5 / atol 1e-6 (the plain versions sum with atomics on the card). The
log-input sweep (kernel 9, login=True) also bit for bit against the two
launches it replaces (`sp_chain_login`, `sp_pass_c`), and the verification
with masks (kernel 10) exactly against its plain version and the split
path, on every edge, on the planted shared-set shape, a compacted batch
and the hub (one 63,488-edge variable); both run a thread-block cluster an
instance. The group walk of kernels 4, 5, 8 and of kernel 1's
var side (`csrc/common.cuh`; the smax_scorer, smax and scorer functors
against their plain versions, in float64 at the hub) also bit for bit against its order emulated
in PyTorch (`ops/reduce.py walk_order_sum`), with the same bits on two
calls, on a compacted batch (8 instances), one instance and a variable of
63,488 edges. The chained pass (kernel 2), whose var phase runs the same
walk: every functor against its plain version (exact for sround,
cnf_chain and ws_chain), the same bits on two calls and its variable sums
the bits of the walk's order over the plain f3 terms; kernel 9 bit for bit
against its two launches for pi 0, pi 0.01 and login. The [E, d] gather
(kernel 7) bit for bit for d in {1, 3, 8, 50, 64, 150}, with i32 and i64
ids, an odd row count and a misaligned table. Kernels 6 and 7 on bf16
rows (compute_dtype="bfloat16"), on the shared set, a compacted batch and
the hub: f32 sums of bf16 rows to rtol 1e-5 / atol 1e-5 of a float64 sum
over the var CSR (atol 5e-4 at the hub's 63,488-row node, summed in f32)
and of the plain version over the clause CSR, f32
nodes minus bf16 rows bit for bit, each counted as a bf16 launch and none
as an f32 one. Kernel 6 on both CSRs of those three batches, f32 and bf16
rows of 37, 50, 64 and 150 columns, bit for bit against its order
emulated in PyTorch (`ops/reduce2d.py walk_order_sum_2d`), with and
without the largest degree.
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


# the p-d-p loop's sweep folds: their inputs are drawn as that loop has
# them (`_fold_inputs`)
FOLD_FNS = (fused.SP_CHAIN_DEC, fused.SP_CHAIN_MASK, fused.SP_CHAIN_MASKV,
            fused.SP_PASS_C_LEAN)


def _fold_inputs(fn, batch, seed):
    """A fold's inputs as the p-d-p loop has them: 0/1 flags where it has
    flags (edge masks, activity and instance flags; the folds' algebra
    needs them: em = av * ac * bmask, the clause factor applied at the
    clause, is the split path's em only on 0/1), the batch's signs and
    edge mask, forces +-1 on real edges, solutions 0/1, messages in
    (0.02, 0.98)."""
    g = torch.Generator().manual_seed(seed)
    sizes = {"V": batch.num_vars, "F": batch.num_clauses,
             "E": batch.num_edges}
    real = {"V": batch.var_mask, "F": batch.clause_mask,
            "E": batch.edge_mask}
    out = []
    for kind, name in zip(fn.layout, fn.inputs):
        u = torch.rand(sizes[kind], generator=g).to(batch.device)
        if name == "sign":
            x = batch.edge_sign
        elif name in ("mask", "bmask", "cm"):
            x = real[kind]
        elif name == "force":
            x = torch.where(u > 0.5, 1.0, -1.0) * real[kind]
        elif name in ("em", "av", "abv", "ac", "sol"):
            x = (u > 0.2).float() * real[kind]
        else:
            x = u * 0.96 + 0.02
        out.append(x.contiguous())
    return out


@pytest.mark.parametrize("fn", fused.FUSED_FNS + fused.CHAINED_FNS,
                         ids=lambda f: f.name)
def test_kernel_matches_plain(batches, fn):
    cpu, gpu = batches
    ins = (_fold_inputs(fn, cpu, 0) if fn in FOLD_FNS
           else _inputs(fn, cpu, 0))
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


@pytest.fixture(scope="module")
def walk_shapes():
    """The shared set, a compacted batch (its first 8 instances), the hub
    (one variable in 63,488 clauses: edges in global memory) and one
    large banded instance (30,000 variables: variables in global memory
    too)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pdp_solver_tpu_torch.utils.bench_kernels import (
        hub_batch, large_instance)
    insts = make_ksat_set()
    return {"shared": pack_instances(insts, device="cuda"),
            "compacted": pack_instances(insts[:8], device="cuda"),
            "hub": hub_batch(),
            "large": pack_instances([large_instance()], device="cuda")}


@pytest.mark.parametrize("eps", [-1.0, 0.5])
@pytest.mark.parametrize("which", ["shared", "compacted", "hub", "large"])
def test_walksat_walk_matches_plain(walk_shapes, which, eps):
    """One walksat_walk launch of 1, 8 and 25 blocks bit for bit against
    the plain walk (assignments as int32 views, energies exactly), from a
    random fill with some variables and clauses inactive, and launching
    the staging mode the batch's shape calls for."""
    gpu = walk_shapes[which]
    assert walksat.use_walksat_block(gpu)
    _, stage_vars, stage_edges = walksat.launch_shape(gpu)
    assert (stage_vars, stage_edges) == {
        "shared": (True, True), "compacted": (True, True),
        "hub": (True, False), "large": (False, False)}[which]
    g = torch.Generator().manual_seed(3)
    av = gpu.var_mask * (torch.rand(gpu.num_vars, generator=g)
                         > 0.1).float().cuda()
    ac = gpu.clause_mask * (torch.rand(gpu.num_clauses, generator=g)
                            > 0.1).float().cuda()
    assign = av * (torch.randint(0, 2, (gpu.num_vars,), generator=g)
                   .float().cuda() * 2 - 1)
    em = gpu.edge_mask * av[gpu.edge_var] * ac[gpu.edge_clause]
    kw = dict(batch=gpu, active_vars=av, active_clauses=ac, em=em, K=8,
              eps=eps)
    seeds = [int(s) for s in torch.randint(-(1 << 31), 1 << 31, (25,),
                                           generator=g)]
    a, ref = assign, {}
    for j, seed in enumerate(seeds):
        a, e = walksat.walksat_block_plain(a, seed=seed, **kw)
        ref[j + 1] = (a, e)
    launches = walksat.walksat_walk.launches
    for n in (1, 8, 25):
        got_a, got_e = walksat.walksat_walk(assign, seeds=seeds[:n], **kw)
        torch.cuda.synchronize()
        ref_a, ref_e = ref[n]
        assert np.array_equal(got_a.cpu().numpy().view(np.int32),
                              ref_a.cpu().numpy().view(np.int32)), n
        assert torch.equal(got_e, ref_e), n
    assert walksat.walksat_walk.launches == launches + 3
    assert float(ref[1][1].sum()) > 0


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

@pytest.mark.parametrize("which", ["shared", "compacted"])
def test_walksat_walk_replicated_matches_plain(walk_shapes, which):
    """The replicated walk (R = 2, one launch a block, the done flag on
    the card) bit for bit against the plain walk with its replica stop,
    on the shared set and on a compacted batch, whose padding rows and
    variables sit between the replicas; from a problem with most clauses
    inactive, so that every instance has a solved replica before the last
    block and the launches after that return at once."""
    from pdp_solver_tpu_torch.fg.batch import replicate_batch
    gpu = replicate_batch(walk_shapes[which], 2)
    assert walksat.use_walksat_block(gpu)
    g = torch.Generator().manual_seed(4)
    av = gpu.var_mask
    ac = gpu.clause_mask * (torch.rand(gpu.num_clauses, generator=g)
                            > 0.7).float().cuda()
    assign = av * (torch.randint(0, 2, (gpu.num_vars,), generator=g)
                   .float().cuda() * 2 - 1)
    em = gpu.edge_mask * av[gpu.edge_var] * ac[gpu.edge_clause]
    kw = dict(batch=gpu, active_vars=av, active_clauses=ac, em=em, K=8,
              eps=0.5)
    seeds = list(range(1000, 1025))
    a, stop = assign, None
    for j, seed in enumerate(seeds):
        a, e = walksat.walksat_block_plain(a, seed=seed, **kw)
        if walksat.replicas_done(gpu, e, 2) > 0:
            stop = j
            break
    assert stop is not None and stop < len(seeds) - 1
    ref_a, ref_e = walksat.walksat_walk_plain(assign, seeds=seeds,
                                              replicas=2, **kw)
    assert torch.equal(ref_a, a)
    launches = walksat.walksat_walk.launches
    got_a, got_e = walksat.walksat_walk(assign, seeds=seeds, replicas=2,
                                        **kw)
    again_a, _ = walksat.walksat_walk(assign, seeds=seeds, replicas=2, **kw)
    torch.cuda.synchronize()
    assert walksat.walksat_walk.launches == launches + 2 * len(seeds)
    np.testing.assert_array_equal(got_a.cpu().numpy().view(np.int32),
                                  ref_a.cpu().numpy().view(np.int32))
    assert torch.equal(got_e, ref_e) and torch.equal(again_a, got_a)


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
    integer columns, floats to rtol 1e-5 / atol 1e-6 of index_add_ (taken
    in float64 on the hub's 63,488-edge node) and bit for bit the walk's
    emulated order; the [E, C] stride form equal to the column form;
    nodes with no edges 0; two calls the same bits, with the pack-time
    largest degree and without it."""
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
            if which == "hub" and not integer:
                # a float32 index_add_ of 63,488 terms in atomic order is
                # itself ~1e-5 off, and differs from run to run
                ref = reduce.segment_sum_cols_plain(
                    [c.double() for c in cols], ids, n, e).float()
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
@pytest.mark.parametrize("fn", [fused.SMAX_SCORER, fused.SMAX, fused.SCORER],
                         ids=lambda f: f.name)
def test_var_side_fused_pass_walk(walk_batches, which, fn):
    """Kernel 1's var side (SmaxScorer, Smax, Scorer) through the group
    walk:
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


# --- the chained pass's var walk (kernel 2), kernel 9's order, kernel 7 ---

INTEGER_CHAINS = ("sround", "cnf_chain", "ws_chain")


def _typed_inputs(fn, batch, seed):
    """Inputs drawn like the columns they stand for: 0/1 masks and
    activity flags, +-1 signs and forces, solutions in {0, 0.5, 1}, log u
    for the log-input sweep, floats in (0.02, 0.98) otherwise; a sweep
    fold's as the p-d-p loop has them (`_fold_inputs`)."""
    if fn in FOLD_FNS:
        return _fold_inputs(fn, batch, seed)
    g = torch.Generator().manual_seed(seed)
    sizes = {"V": batch.num_vars, "F": batch.num_clauses,
             "E": batch.num_edges}
    real = {"V": batch.var_mask, "F": batch.clause_mask,
            "E": batch.edge_mask}
    out = []
    for kind, name in zip(fn.layout, fn.inputs):
        u = torch.rand(sizes[kind], generator=g).cuda()
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
        out.append(x.contiguous())
    return out


def _flat(outs):
    flat = []
    for o in outs:
        if isinstance(o, tuple):
            flat += list(o)
        elif o is not None:
            flat.append(o)
    return flat


@pytest.mark.parametrize("which", ["shared", "compacted", "hub"])
@pytest.mark.parametrize("fn", fused.CHAINED_FNS, ids=lambda f: f.name)
def test_chained_pass_walk(walk_batches, which, fn):
    """Kernel 2 with its var phase on the group walk: against the plain
    version (exact for the integer functors, rtol 1e-5 / atol 1e-6 for
    SP; for the 63,488-edge variable the SP sums against float64, as a
    float32 index_add_ of that many terms is itself ~4e-5 off), the same
    bits on two calls, and its variable sums bit for bit the walk's order
    over the plain version's f3 terms."""
    gpu = walk_batches[which]
    ins = _typed_inputs(fn, gpu, 6)
    got = fused.chained_edge_pass(fn, gpu, ins)
    again = fused.chained_edge_pass(fn, gpu, ins)
    ref = fused.chained_edge_pass_plain(fn, gpu, ins)
    if which == "hub" and fn.n_vred and fn.name not in INTEGER_CHAINS:
        ref = (ref[0], fused.chained_edge_pass_plain(
            fn, gpu, [x.double() for x in ins])[1].float()) + ref[2:]
    torch.cuda.synchronize()
    assert [o is None for o in got] == [r is None for r in ref]
    for g, a, r in zip(_flat(got), _flat(again), _flat(ref)):
        assert g.shape == r.shape and bool(torch.isfinite(g).all())
        assert torch.equal(g, a)
        if fn.name in INTEGER_CHAINS:
            assert torch.equal(g, r)
        else:
            torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)
    if fn.n_vred:
        emu = fused.chained_vred_walk_order(fn, gpu, ins)
        torch.cuda.synchronize()
        assert torch.equal(got[1], emu)


@pytest.mark.parametrize("which", ["shared", "compacted", "hub"])
@pytest.mark.parametrize("fold", ["dec", "mask", "maskv"])
def test_folds_bit_equal_to_split_passes(walk_batches, which, fold):
    """A sweep fold then sp_pass_c_lean against em_ae, sp_chain,
    sp_pass_c, smax_scorer and cnf_chain from one loop state
    (utils/bench_kernels.py fold_inputs): the variable sums, eta, em, ae,
    q_u and the verification's counts bit for bit."""
    from pdp_solver_tpu_torch.utils.bench_kernels import (
        fold_inputs, folded_sweep, split_sweep)
    gpu = walk_batches[which]
    x = fold_inputs(gpu)
    ref = split_sweep(gpu, x)
    got = folded_sweep(gpu, x, fold)
    torch.cuda.synchronize()
    assert set(got) <= set(ref)
    for key, out in got.items():
        assert bool(torch.isfinite(out).all())
        assert torch.equal(out, ref[key]), key


@pytest.mark.parametrize("which", ["shared", "compacted", "hub"])
@pytest.mark.parametrize("case", ["pi0", "pi0.01", "login"])
def test_sp_sweep_bit_equal_to_two_launches(walk_batches, which, case):
    """Kernel 9 takes its variable sums in the walk's order, so it gives
    the bits of sp_chain (sp_chain_login) + sp_pass_c in every case; the
    hub's 63,488-edge variable goes piece by piece."""
    gpu = walk_batches[which]
    pi, login = {"pi0": (0.0, False), "pi0.01": (0.01, False),
                 "login": (0.0, True)}[case]
    kw = _sweep_inputs(gpu, 13, pi)
    if login:
        kw["u_like"] = torch.log(kw["u_like"])
    cols = tuple(kw.values())
    got = sp_sweep.sp_full_sweep(gpu, pi=pi, login=login, **kw)
    chain = fused.SP_CHAIN_LOGIN if login else fused.SP_CHAIN
    _, pn, (eta2,), _ = fused.chained_edge_pass(chain, gpu, cols[:6])
    _, two = fused.fused_edge_pass(
        fused.SP_PASS_C, gpu, (pn[0], pn[1]) + cols[1:4] + cols[5:],
        scalar=pi)
    torch.cuda.synchronize()
    for a, c in zip(got, (eta2,) + tuple(two)):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, c)


@pytest.fixture(scope="module")
def replicated_batches(walk_batches):
    """The small shared-set batch and the compacted batch, replicated
    twice: replica 0's padding edges, clauses, variables and rows lie
    inside the prefix the kernels treat as real."""
    from pdp_solver_tpu_torch.fg.batch import replicate_batch
    out = {k: replicate_batch(walk_batches[k], 2)
           for k in ("shared", "compacted")}
    assert all(b.inner_padding for b in out.values())
    return out


def _active_mask_inputs(fn, batch, seed):
    """_typed_inputs with the SP passes' mask drawn as the solver's
    active-edge flag, which is 1 on padding edges too."""
    ins = _typed_inputs(fn, batch, seed)
    # (the mask and verify folds read the instance flag per variable,
    # abv, in its place)
    if fn.name.startswith("sp_") and "mask" in fn.inputs:
        g = torch.Generator().manual_seed(seed + 1000)
        ins[fn.inputs.index("mask")] = (torch.rand(
            batch.num_edges, generator=g) > 0.2).float().cuda()
    return ins


@pytest.mark.parametrize("which", ["shared", "compacted"])
@pytest.mark.parametrize("fn", fused.FUSED_FNS + fused.CHAINED_FNS,
                         ids=lambda f: f.name)
def test_edge_passes_replicated_match_plain(replicated_batches, which, fn):
    """Kernels 1 and 2 on a replicated batch against their plain versions
    on every output row, padding included (exact for the flag and count
    functors, rtol 1e-5 / atol 1e-6 else), the same bits on two calls,
    and a chained pass's variable sums the bits of the walk's order."""
    gpu = replicated_batches[which]
    chained = fn in fused.CHAINED_FNS
    call = fused.chained_edge_pass if chained else fused.fused_edge_pass
    plain = (fused.chained_edge_pass_plain if chained
             else fused.fused_edge_pass_plain)
    ins = _active_mask_inputs(fn, gpu, 21)
    got = call(fn, gpu, ins)
    again = call(fn, gpu, ins)
    ref = plain(fn, gpu, ins)
    torch.cuda.synchronize()
    assert [o is None for o in got] == [r is None for r in ref]
    exact = fn.name in INTEGER_CHAINS + ("em_ae", "em", "ae")
    for g, a, r in zip(_flat(got), _flat(again), _flat(ref)):
        assert g.shape == r.shape and bool(torch.isfinite(g).all())
        assert torch.equal(g, a)
        if exact:
            assert torch.equal(g, r)
        else:
            torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)
    if chained and fn.n_vred:
        emu = fused.chained_vred_walk_order(fn, gpu, ins)
        torch.cuda.synchronize()
        assert torch.equal(got[1], emu)


@pytest.mark.parametrize("which", ["shared", "compacted"])
@pytest.mark.parametrize("case", ["pi0", "pi0.01", "login"])
def test_sp_sweep_replicated(replicated_batches, which, case):
    """Kernel 9 on a replicated batch: against its plain version on every
    edge (rtol 1e-5 / atol 1e-6) and bit for bit against its two
    launches, the mask 1 on padding edges as the solver's is."""
    gpu = replicated_batches[which]
    pi, login = {"pi0": (0.0, False), "pi0.01": (0.01, False),
                 "login": (0.0, True)}[case]
    kw = _sweep_inputs(gpu, 14, pi)
    if login:
        kw["u_like"] = torch.log(kw["u_like"])
    cols = tuple(kw.values())
    got = sp_sweep.sp_full_sweep(gpu, pi=pi, login=login, **kw)
    ref = sp_sweep.sp_full_sweep_plain(gpu, cols, pi, login)
    chain = fused.SP_CHAIN_LOGIN if login else fused.SP_CHAIN
    _, pn, (eta2,), _ = fused.chained_edge_pass(chain, gpu, cols[:6])
    _, two = fused.fused_edge_pass(
        fused.SP_PASS_C, gpu, (pn[0], pn[1]) + cols[1:4] + cols[5:],
        scalar=pi)
    torch.cuda.synchronize()
    for a, r, c in zip(got, ref, (eta2,) + tuple(two)):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-6)
        assert torch.equal(a, c)


def _planted_hub(degree=63488, n=300, k=3, seed=5):
    """_hub_batch's graph with signs that an assignment satisfies (an
    unsatisfied clause gets the sign of its literal of variable 0
    flipped), and that assignment (0/1)."""
    rng = np.random.default_rng(seed)
    v = rng.integers(1, n, size=(degree, k))
    v[:, 0] = 0
    x = rng.integers(0, 2, size=n)
    s = rng.choice([-1, 1], size=(degree, k))
    sat = ((s > 0) == (x[v] > 0)).any(1)
    s[~sat, 0] *= -1
    inst = (n, degree, np.stack([v.reshape(-1), np.repeat(
        np.arange(degree), k)]).astype(np.int32),
        s.reshape(-1).astype(np.float32), -1.0)
    return pack_instances([inst], device="cuda"), [x.astype(np.float32)]


@pytest.mark.parametrize("which", ["compacted", "hub"])
def test_verify_and_masks_compacted_and_hub(which):
    """Kernel 10 exactly against its plain version and the split path on a
    compacted batch (8 planted instances of the shared set's shape, a
    32,768-edge bucket, 4 of them solved) and on the hub (one planted
    instance whose variable 0 has 63,488 edges, solved), with some
    variables and clauses inactive and instance 0 already stopped."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(10)
    if which == "compacted":
        insts, xs = _planted(rng, 8, 100, 900, 4)
        gpu = pack_instances(insts, device="cuda")
        assert gpu.num_edges == 32768
    else:
        gpu, xs = _planted_hub()
    assert verify.use_verify_masks(gpu)
    pred = rng.uniform(size=gpu.num_vars).astype(np.float32)
    off = 0
    for b, x in enumerate(xs):
        if b % 2 == 0:
            pred[off:off + len(x)] = x
        off += len(x)
    p = torch.from_numpy(pred)[:, None].cuda()
    problem = init_problem_state(gpu)
    av, ac = problem.active_vars.clone(), problem.active_clauses.clone()
    av[::7] = 0.0
    ac[::5] = 0.0
    problem = problem.replace(active_vars=av, active_clauses=ac)
    act = gpu.instance_mask.clone()
    act[0] = 0.0
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
    n = len(xs)
    assert got[0][:n].tolist() == [float(b % 2 == 0) for b in range(n)]
    assert gpu.num_edges > gpu.num_real_edges


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64],
                         ids=["i32", "i64"])
@pytest.mark.parametrize("d", [1, 3, 8, 50, 64, 150])
def test_gather_2d_bit_exact(d, ids_dtype):
    """Kernel 7 bit for bit against index_select (minus the subtrahend),
    with and without the subtract, for an odd row count and for a node
    table whose rows are not 8-byte aligned (the scalar path)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pdp_solver_tpu_torch.ops import reduce2d
    g = torch.Generator().manual_seed(d)
    N, E = 997, 20001
    ids = torch.randint(0, N, (E,), generator=g).to(ids_dtype).cuda()
    nodes = torch.randn(N, d, generator=g).cuda()
    shifted = torch.randn(N * d + 1, generator=g).cuda()[1:].view(N, d)
    minus = torch.randn(E, d, generator=g).cuda()
    for table in (nodes, shifted):
        for m in (None, minus):
            got = reduce2d.gather_2d(table, ids, m)
            ref = reduce2d.gather_2d_plain(table, ids.long(), m)
            torch.cuda.synchronize()
            assert torch.equal(got, ref)


@pytest.mark.parametrize("d", [50, 37, 64])
@pytest.mark.parametrize("which", ["shared", "compacted", "hub"])
def test_reduce2d_bf16_kernels_match_plain(walk_shapes, which, d):
    """d = 50 (the path's width: bf16 pairs a lane in the sum, pieces of
    2 in the gather), 37 (an element at a time) and 64 (pieces of 4)."""
    from pdp_solver_tpu_torch.ops import reduce2d
    gpu = walk_shapes[which]
    g = torch.Generator().manual_seed(d)
    x = torch.randn(gpu.num_edges, d, generator=g).cuda().bfloat16()
    nodes = torch.randn(gpu.num_vars, d, generator=g).cuda()
    ev, V, e = gpu.edge_var, gpu.num_vars, gpu.num_real_edges
    f32_before = (reduce2d.segment_sum_2d.launches,
                  reduce2d.gather_2d.launches)
    sums = reduce2d.segment_sum_2d.launches_bf16
    gathers = reduce2d.gather_2d.launches_bf16
    ref64 = torch.zeros(V, d, dtype=torch.float64, device="cuda")
    ref64.index_add_(0, ev[:e], x[:e].double())
    got = reduce2d.segment_sum_2d(x, ev, V, e, gpu.var_ptr, gpu.var_perm)
    assert got.dtype == torch.float32
    # the hub's node adds 63,488 rows in f32 (7.8e-5 off the float64 sum
    # on an H100 at d = 50 when they were added one after another)
    atol = 5e-4 if which == "hub" else 1e-5
    torch.testing.assert_close(got.double(), ref64, rtol=1e-5, atol=atol)
    got = reduce2d.segment_sum_2d(x, gpu.edge_clause, gpu.num_clauses, e,
                                  gpu.clause_ptr)
    ref = reduce2d.segment_sum_2d_plain(x, gpu.edge_clause,
                                        gpu.num_clauses, e)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    for ids in (gpu.edge_var32, ev):
        got = reduce2d.gather_2d(nodes, ids, x)
        ref = reduce2d.gather_2d_plain(nodes, ev, x)
        torch.cuda.synchronize()
        assert got.dtype == ref.dtype == torch.float32
        assert torch.equal(got, ref)
    assert reduce2d.segment_sum_2d.launches_bf16 == sums + 2
    assert reduce2d.gather_2d.launches_bf16 == gathers + 2
    assert (reduce2d.segment_sum_2d.launches,
            reduce2d.gather_2d.launches) == f32_before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [50, 37, 64, 150])
@pytest.mark.parametrize("which", ["shared", "compacted", "hub"])
def test_segment_sum_2d_walk_order(walk_shapes, which, d, dtype):
    """Kernel 6 bit for bit against its order emulated in PyTorch
    (ops/reduce2d.py walk_order_sum_2d) over the var and the clause CSR:
    d = 50 (8-byte f32 and 4-byte bf16 pieces), 37 (an element at a time),
    64 (16 and 8 bytes) and 150 (three passes of 32 pieces); the same bits
    on two calls and with max_degree unknown (the anchored blocks then
    look for heavy nodes at every anchor)."""
    from pdp_solver_tpu_torch.ops import reduce2d
    gpu = walk_shapes[which]
    g = torch.Generator().manual_seed(d)
    x = torch.randn(gpu.num_edges, d, generator=g).cuda().to(dtype)
    e = gpu.num_real_edges
    for ids, n, ptr, perm, md in (
            (gpu.edge_var, gpu.num_vars, gpu.var_ptr, gpu.var_perm,
             gpu.var_max_degree),
            (gpu.edge_clause32, gpu.num_clauses, gpu.clause_ptr, None,
             gpu.clause_max_degree)):
        got = reduce2d.segment_sum_2d(x, ids, n, e, ptr, perm,
                                      max_degree=md)
        again = reduce2d.segment_sum_2d(x, ids, n, e, ptr, perm,
                                        max_degree=md)
        unknown = reduce2d.segment_sum_2d(x, ids, n, e, ptr, perm)
        ref = reduce2d.walk_order_sum_2d(x, ptr, perm)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32
        assert torch.equal(got, again)
        assert torch.equal(got, unknown)
        assert torch.equal(got, ref), float((got - ref).abs().max())


# ---------------------------------------------------------------------------
# training: the guard of the wrappers without a backward rule, and the
# autograd pair of kernels 6 and 7 (each the other's backward) on the card
# ---------------------------------------------------------------------------

def _grad_input_calls(gpu):
    """One call of each launching wrapper without a backward rule, with
    its first input requiring grad."""
    fn_f, fn_c = fused.EM_AE, fused.CNF_CHAIN

    def ins(fn):
        xs = [x.cuda() for x in _inputs(fn, gpu, 3)]
        xs[0] = xs[0].clone().requires_grad_()
        return xs
    av = gpu.var_mask
    assign = (av * 2 - 1).clone().requires_grad_()
    sweep = _sweep_inputs(gpu, 5, 0.0)
    sweep["u_like"] = sweep["u_like"].clone().requires_grad_()
    problem = init_problem_state(gpu)
    pred = torch.full((gpu.num_vars, 1), 0.7, device="cuda",
                      requires_grad=True)
    return {
        "fused_edge_pass[em_ae]": lambda: fused.fused_edge_pass(
            fn_f, gpu, ins(fn_f)),
        "chained_edge_pass[cnf_chain]": lambda: fused.chained_edge_pass(
            fn_c, gpu, ins(fn_c)),
        "walksat_walk": lambda: walksat.walksat_walk(
            assign, batch=gpu, active_vars=av,
            active_clauses=gpu.clause_mask, em=gpu.edge_mask, K=8,
            seeds=[1], eps=0.5),
        "sp_full_sweep": lambda: sp_sweep.sp_full_sweep(gpu, **sweep),
        "verify_and_masks": lambda: verify.verify_and_masks(
            gpu, problem, gpu.instance_mask, pred),
    }


@pytest.mark.parametrize("name", ["fused_edge_pass[em_ae]",
                                  "chained_edge_pass[cnf_chain]",
                                  "walksat_walk", "sp_full_sweep",
                                  "verify_and_masks"])
def test_wrappers_without_a_backward_rule_refuse_grad(batches, name):
    call = _grad_input_calls(batches[1])[name]
    with pytest.raises(RuntimeError, match="an input requires grad"):
        call()
    with torch.no_grad():
        call()
    torch.cuda.synchronize()


@pytest.mark.parametrize("side", ["var", "clause"])
def test_autograd_pair_on_card_matches_cpu(side):
    """SegmentSum2d and Gather2d (minus) on the card against the same
    Functions on the CPU (the plain transposes): values and gradients to
    rtol 1e-5 / atol 1e-5, the gather's gradient to the subtrahend
    exactly, and each kernel counted as the other's backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pdp_solver_tpu_torch.modules import common
    from pdp_solver_tpu_torch.ops import reduce2d
    rng = np.random.default_rng(3)
    insts = []
    for _ in range(4):
        widths = rng.integers(2, 7, size=400)
        ev = np.concatenate([rng.choice(200, int(k), replace=False)
                             for k in widths]).astype(np.int32)
        ec = np.repeat(np.arange(400, dtype=np.int32), widths)
        signs = rng.choice([-1.0, 1.0], ev.shape[0]).astype(np.float32)
        insts.append((200, 400, np.stack([ev, ec]), signs, -1.0))
    out = {}
    s, g = reduce2d.segment_sum_2d, reduce2d.gather_2d
    for dev in ("cpu", "cuda"):
        b = pack_instances(insts, device=dev)
        assert b.clause_width == 0
        ids, ids32, n, csr = (
            (b.edge_var, b.edge_var32, b.num_vars, common.var_csr(b))
            if side == "var" else
            (b.edge_clause, b.edge_clause32, b.num_clauses,
             common.clause_csr(b)))
        gen = torch.Generator().manual_seed(4)
        x = torch.randn(b.num_edges, 50, generator=gen).to(dev)
        x = (x * b.edge_mask[:, None]).requires_grad_()
        w = torch.randn(b.num_edges, 50, generator=gen).to(dev)
        w = w * b.edge_mask[:, None]
        before = (s.launches_bwd[side], g.launches_bwd[side])
        agg = s(x, ids, n, *csr)
        y = g(agg, ids32, x, csr=csr)
        (y * w).sum().backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert (s.launches_bwd[side], g.launches_bwd[side]) == (
                before[0] + 1, before[1] + 1)
        out[dev] = (y.detach().cpu(), x.grad.cpu())
    for a, b in zip(out["cpu"], out["cuda"]):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)
