"""[E, d] feature blocks between edges and nodes: segment sum and gather.

Counterpart of `pdp_solver_tpu/ops/pallas_reduce2d.py`
(`windowed_segment_sum_2d` :109 and `windowed_gather_2d` :120). The
neural modules move [E, d] hidden states (d = 50..150) between edges and
variables every iteration through these two.

segment_sum_2d(x, ids, num_segments, num_real, ptr, perm) -> [N, d]
    row e of x goes to node ids[e], for the first num_real rows (the real
    edges); f32 sums.
gather_2d(nodes, ids, minus=None) -> [E, d]
    nodes[ids[e]] for every e (padding rows included), minus the matching
    row of `minus` when it is given (the aggregate-minus-self of the
    neural aggregators, fused).

Each wrapper runs its plain PyTorch version when the tensors lie on the
CPU and launches its CUDA kernel (`csrc/reduce2d.cu`) when they lie on the
card, or raises; there is no fallback between the two. On the card the
segment sum walks the CSR (ptr, perm) that lists each node's rows in
increasing order (`FGBatch.var_ptr`/`var_perm`; perm None means rows
ptr[n]..ptr[n+1], as for clause-major clauses), so its sums have one fixed
order and no atomics. Calls that launched a kernel are counted in
`.launches`. Forward only: each is the other's transpose, and the
autograd pair comes with training.
"""

import torch

from pdp_solver_tpu_torch.ops import _build


def _check_rows(name, x, what):
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"{name}: {what} must be f32[rows, d], got "
                         f"{x.dtype} {tuple(x.shape)}")


def _device(name, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def segment_sum_2d_plain(x, ids, num_segments, num_real):
    """The plain version: index_add_ over the real rows."""
    out = torch.zeros((num_segments, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    return out.index_add_(0, ids[:num_real], x[:num_real])


def segment_sum_2d(x, ids, num_segments, num_real, ptr, perm=None):
    """[E, d] -> [num_segments, d]; see the module docstring."""
    _check_rows("segment_sum_2d", x, "x")
    dev = _device("segment_sum_2d", x, ids, ptr, perm)
    if ids.shape[0] != x.shape[0] or num_real > x.shape[0]:
        raise ValueError(f"segment_sum_2d: {x.shape[0]} rows, "
                         f"{ids.shape[0]} ids, {num_real} real")
    if dev.type == "cpu":
        return segment_sum_2d_plain(x, ids, num_segments, num_real)
    if ptr.dtype != torch.int32 or ptr.shape != (num_segments + 1,):
        raise ValueError(f"segment_sum_2d: ptr must be i32[{num_segments + 1}]"
                         f", got {ptr.dtype} {tuple(ptr.shape)}")
    if perm is not None and (perm.dtype != torch.int32
                             or perm.shape != (num_real,)):
        raise ValueError(f"segment_sum_2d: perm must be i32[{num_real}], "
                         f"got {perm.dtype} {tuple(perm.shape)}")
    x = x.contiguous()
    d = x.shape[1]
    out = torch.empty((num_segments, d), dtype=torch.float32, device=dev)
    rc = _build.library().pdp_segment_sum_2d(
        x.data_ptr(), d, ptr.data_ptr(),
        perm.data_ptr() if perm is not None and perm.numel() else None,
        num_segments, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "segment_sum_2d")
    segment_sum_2d.launches += 1
    return out


segment_sum_2d.launches = 0


def gather_2d_plain(nodes, ids, minus=None):
    """The plain version: index_select (minus the subtrahend)."""
    out = nodes.index_select(0, ids)
    return out if minus is None else out - minus


def gather_2d(nodes, ids, minus=None):
    """[N, d] -> [len(ids), d]; see the module docstring."""
    _check_rows("gather_2d", nodes, "nodes")
    dev = _device("gather_2d", nodes, ids, minus)
    E, d = ids.shape[0], nodes.shape[1]
    if minus is not None:
        _check_rows("gather_2d", minus, "minus")
        if minus.shape != (E, d):
            raise ValueError(f"gather_2d: minus is {tuple(minus.shape)}, "
                             f"expected ({E}, {d})")
    if dev.type == "cpu":
        return gather_2d_plain(nodes, ids, minus)
    if ids.dtype != torch.int64:
        raise ValueError(f"gather_2d: ids must be int64, got {ids.dtype}")
    nodes = nodes.contiguous()
    minus = None if minus is None else minus.contiguous()
    ids = ids.contiguous()
    out = torch.empty((E, d), dtype=torch.float32, device=dev)
    rc = _build.library().pdp_gather_2d(
        nodes.data_ptr(), d, ids.data_ptr(),
        None if minus is None else minus.data_ptr(), E, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "gather_2d")
    gather_2d.launches += 1
    return out


gather_2d.launches = 0
