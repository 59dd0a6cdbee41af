"""The CUDA kernels against their plain versions, on the card.

Marked `gpu`: each test skips when torch sees no CUDA card (decided inside
the fixture, never at import). On the card's machine run them with
`python -m pytest tests/test_torch_gpu.py -m gpu`. Tolerances as in
chip_smoke.py: flags and counts exact, float sums rtol 1e-5 / atol 1e-6
(the [E, d] segment sum rtol 1e-5 / atol 1e-5), walksat_block and the
[E, d] gather bit-exact.
"""

import numpy as np
import pytest
import torch

from pdp_solver_tpu_torch.fg.batch import pack_instances
from pdp_solver_tpu_torch.ops import fused, walksat
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
