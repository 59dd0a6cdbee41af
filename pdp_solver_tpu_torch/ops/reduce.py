"""Multi-column segment sums from edges to nodes.

Counterpart of `pdp_solver_tpu/ops/pallas_reduce.py`
(`windowed_segment_sum_cols` :224, `windowed_segment_sum` :240 and
`windowed_segment_sum_cols_based` :209) and of
`pdp_solver_tpu/ops/pallas_segment.py` (`sorted_segment_sum` :120). The
TPU kernels need the pack-time window invariant, or host-chosen window
bases plus a residual scatter, or sorted ids; here one CUDA kernel
(`csrc/reduce.cu`) walks a CSR of each node's edges, which any batch has,
and computes all of them (kernels 4, 5 and 8 of PERF.md).

segment_sum_cols(cols, ids, num_segments, num_real, ptr, perm=None)
    C <= 8 separate f32[E] columns -> f32[C, num_segments]: row c holds the
    sums of cols[c] over the first num_real edges (the real ones), edge e
    going to node ids[e].
segment_sum(x, ids, num_segments, num_real, ptr, perm=None)
    the same for x f32[E] -> f32[N], or x f32[E, C] (C <= 8) -> f32[N, C].
sorted_segment_sum(x, ids, num_segments)
    f32[E] with sorted ids -> f32[N]; ids outside [0, N) are dropped, as
    by a segment sum.

Each wrapper runs its plain PyTorch version (`*_plain`, index_add_) when
the tensors lie on the CPU and launches the kernel when they lie on the
card, or raises; there is no fallback between the two. On the card the
sum walks the CSR (ptr, perm) that lists each node's edges in increasing
order (`FGBatch.var_ptr`/`var_perm`; perm None means edges ptr[n] ..
ptr[n+1], as for clause-major clauses), so its sums have one fixed order
and no atomics. Every launch of the kernel is counted in
`segment_sum_cols.launches` and, per wrapper, in
`segment_sum_cols.launches_by_form`.
"""

import ctypes

import torch

from pdp_solver_tpu_torch.ops import _build
from pdp_solver_tpu_torch.ops.reduce2d import _device

MAX_COLS = 8


def _check_csr(name, ptr, perm, num_segments, num_real):
    if ptr.dtype != torch.int32 or ptr.shape != (num_segments + 1,):
        raise ValueError(f"{name}: ptr must be i32[{num_segments + 1}], "
                         f"got {ptr.dtype} {tuple(ptr.shape)}")
    if perm is not None and (perm.dtype != torch.int32
                             or perm.shape != (num_real,)):
        raise ValueError(f"{name}: perm must be i32[{num_real}], got "
                         f"{perm.dtype} {tuple(perm.shape)}")


def _launch(form, col_ptrs, stride, ptr, perm, num_segments, out):
    """One launch over column base pointers (the caller keeps their
    tensors alive)."""
    arr = (ctypes.c_void_p * MAX_COLS)(*col_ptrs)
    rc = _build.library().pdp_segment_sum_cols(
        ctypes.cast(arr, ctypes.c_void_p), len(col_ptrs), stride,
        ptr.data_ptr(),
        perm.data_ptr() if perm is not None and perm.numel() else None,
        num_segments, out.data_ptr(),
        torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(rc, f"segment_sum_cols[{form}]")
    segment_sum_cols.launches += 1
    by = segment_sum_cols.launches_by_form
    by[form] = by.get(form, 0) + 1


def segment_sum_cols_plain(cols, ids, num_segments, num_real):
    """The plain version: index_add_ of the stacked real edges."""
    x = torch.stack([c[:num_real] for c in cols])
    out = torch.zeros((len(cols), num_segments), dtype=torch.float32,
                      device=x.device)
    return out.index_add_(1, ids[:num_real], x)


def segment_sum_cols(cols, ids, num_segments, num_real, ptr, perm=None):
    """C f32[E] columns -> f32[C, num_segments]; see the module docstring."""
    cols = tuple(cols)
    name = "segment_sum_cols"
    if not 1 <= len(cols) <= MAX_COLS:
        raise ValueError(f"{name}: {len(cols)} columns, expected 1.."
                         f"{MAX_COLS}")
    E = ids.shape[0]
    for c in cols:
        if c.shape != (E,) or c.dtype != torch.float32:
            raise ValueError(f"{name}: columns must be f32[{E}], got "
                             f"{c.dtype} {tuple(c.shape)}")
    if num_real > E:
        raise ValueError(f"{name}: {num_real} real edges of {E}")
    dev = _device(name, *cols, ids, ptr, perm)
    if dev.type == "cpu":
        return segment_sum_cols_plain(cols, ids, num_segments, num_real)
    _check_csr(name, ptr, perm, num_segments, num_real)
    cols = tuple(c.contiguous() for c in cols)
    out = torch.empty((len(cols), num_segments), dtype=torch.float32,
                      device=dev)
    _launch("cols", [c.data_ptr() for c in cols], 1, ptr, perm,
            num_segments, out)
    return out


segment_sum_cols.launches = 0
segment_sum_cols.launches_by_form = {}


def segment_sum_plain(x, ids, num_segments, num_real):
    """The plain version: index_add_ over the real rows."""
    out = torch.zeros((num_segments,) + tuple(x.shape[1:]),
                      dtype=torch.float32, device=x.device)
    return out.index_add_(0, ids[:num_real], x[:num_real])


def segment_sum(x, ids, num_segments, num_real, ptr, perm=None):
    """f32[E] -> f32[N] or f32[E, C] (C <= 8) -> f32[N, C]; the [E, C]
    array is read in place, column c at stride C."""
    name = "segment_sum"
    E = ids.shape[0]
    if (x.dtype != torch.float32 or x.dim() not in (1, 2)
            or x.shape[0] != E
            or (x.dim() == 2 and not 1 <= x.shape[1] <= MAX_COLS)):
        raise ValueError(f"{name}: x must be f32[{E}] or f32[{E}, C <= "
                         f"{MAX_COLS}], got {x.dtype} {tuple(x.shape)}")
    if num_real > E:
        raise ValueError(f"{name}: {num_real} real edges of {E}")
    dev = _device(name, x, ids, ptr, perm)
    if dev.type == "cpu":
        return segment_sum_plain(x, ids, num_segments, num_real)
    _check_csr(name, ptr, perm, num_segments, num_real)
    x = x.contiguous()
    C = 1 if x.dim() == 1 else x.shape[1]
    out = torch.empty((C, num_segments), dtype=torch.float32, device=dev)
    base = x.data_ptr()
    _launch("rows", [base + 4 * c for c in range(C)], C, ptr, perm,
            num_segments, out)
    return out[0] if x.dim() == 1 else out.T


def sorted_segment_sum_plain(x, ids, num_segments):
    """The plain version: index_add_ of the rows whose id is in range."""
    keep = (ids >= 0) & (ids < num_segments)
    out = torch.zeros(num_segments, dtype=torch.float32, device=x.device)
    return out.index_add_(0, ids[keep], x[keep])


def sorted_segment_sum(x, ids, num_segments):
    """f32[E] with ids sorted ascending -> f32[num_segments]. On the card
    the CSR offsets come from the sorted ids (torch.searchsorted) and the
    kernel sums with C = 1 and no permutation."""
    name = "sorted_segment_sum"
    if x.dtype != torch.float32 or x.dim() != 1 or ids.shape != x.shape:
        raise ValueError(f"{name}: x must be f32[E] with ids [E], got "
                         f"{x.dtype} {tuple(x.shape)}, ids "
                         f"{tuple(ids.shape)}")
    dev = _device(name, x, ids)
    if dev.type == "cpu":
        return sorted_segment_sum_plain(x, ids, num_segments)
    bounds = torch.arange(num_segments + 1, device=dev, dtype=ids.dtype)
    ptr = torch.searchsorted(ids.contiguous(), bounds).to(torch.int32)
    x = x.contiguous()
    out = torch.empty((1, num_segments), dtype=torch.float32, device=dev)
    _launch("sorted", [x.data_ptr()], 1, ptr, None, num_segments, out)
    return out[0]
