"""The CUDA kernels against their plain versions, on the card.

Marked `gpu`: each test skips when torch sees no CUDA card (decided inside
the fixture, never at import). On the card's machine run them with
`python -m pytest tests/test_torch_gpu.py -m gpu`. Tolerances as in
chip_smoke.py: flags and counts exact, float sums rtol 1e-5 / atol 1e-6
(the [E, d] segment sum rtol 1e-5 / atol 1e-5), walksat_block and the
[E, d] gather bit-exact. The multi-column segment sum (kernels 4, 5 and
8) is exact on signed integer-valued columns, its sums of non-negative
floats (as the path's are) and the one-launch SP sweep (kernel 9) to rtol
1e-5 / atol 1e-6 (the plain versions sum with atomics on the card).
"""

import numpy as np
import pytest
import torch

from pdp_solver_tpu_torch.fg.batch import pack_instances
from pdp_solver_tpu_torch.ops import fused, reduce, sp_sweep, walksat
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
