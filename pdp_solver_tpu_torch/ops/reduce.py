"""Multi-column segment sums from edges to nodes.

Counterpart of `pdp_solver_tpu/ops/pallas_reduce.py`
(`windowed_segment_sum_cols` :224, `windowed_segment_sum` :240 and
`windowed_segment_sum_cols_based` :209) and of
`pdp_solver_tpu/ops/pallas_segment.py` (`sorted_segment_sum` :120). The
TPU kernels need the pack-time window invariant, or host-chosen window
bases plus a residual scatter, or sorted ids; here one CUDA kernel
(`csrc/reduce.cu`) walks a CSR of each node's edges, which any batch has,
or the runs of sorted ids, and computes all of them (kernels 4, 5 and 8 of
PERF.md).

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
ptr[n+1], as for clause-major clauses), or finds each node's run of sorted
ids in the same launch, with the group walk of `csrc/common.cuh`: G lanes
a node, and a node of very high degree cut among blocks. Its sums have
one fixed order (`walk_order_sum` repeats it) and no float atomics.

What a launch needs of the index tensors (checks, group width, pointers)
is worked out once per (ids, ptr, perm) and kept in a plan; a call then
checks its columns against the plan, fills the plan's argument block and
makes one ctypes call. Every launch of the kernel is counted in
`segment_sum_cols.launches` and, per wrapper, in
`segment_sum_cols.launches_by_form`.
"""

import ctypes
import math

import torch

from pdp_solver_tpu_torch.ops import _build
from pdp_solver_tpu_torch.ops.reduce2d import _device

F32 = torch.float32
MAX_COLS = _build.MAX_COLS
THREADS = _build.THREADS  # PDP_THREADS, the threads of a block


def _check_csr(name, ptr, perm, num_segments, num_real):
    if ptr.dtype != torch.int32 or ptr.shape != (num_segments + 1,):
        raise ValueError(f"{name}: ptr must be i32[{num_segments + 1}], "
                         f"got {ptr.dtype} {tuple(ptr.shape)}")
    if perm is not None and (perm.dtype != torch.int32
                             or perm.shape != (num_real,)):
        raise ValueError(f"{name}: perm must be i32[{num_real}], got "
                         f"{perm.dtype} {tuple(perm.shape)}")


class _Plan:
    """The checked index tensors of one CSR (or one sorted id array) and,
    on the card, the kernel's argument block for them."""

    def __init__(self, name, ids, num_segments, num_real, ptr, perm,
                 sorted_ids, max_degree):
        self.device = _device(name, ids, ptr, perm)
        if ids.dim() != 1 or ids.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"{name}: ids must be i32[E] or i64[E], got "
                             f"{ids.dtype} {tuple(ids.shape)}")
        E = ids.shape[0]
        if num_real > E:
            raise ValueError(f"{name}: {num_real} real edges of {E}")
        if not sorted_ids:
            _check_csr(name, ptr, perm, num_segments, num_real)
        self.shape = torch.Size([E])
        n_slots = E if sorted_ids else num_real
        self.group = _build.group_width(n_slots, num_segments)
        self.args = None
        if self.device.type == "cuda":
            a = _build.SegSumArgs()
            a.sorted = int(sorted_ids)
            a.ptr = None if sorted_ids else ptr.data_ptr()
            a.perm = (perm.data_ptr() if perm is not None and perm.numel()
                      else None)
            a.ids = ids.data_ptr()
            a.ids64 = int(ids.dtype == torch.int64)
            a.n_seg = num_segments
            a.n_slots = n_slots
            a.group = self.group
            self.scratch = _build.walk_scratch(a, n_slots, self.group,
                                               max_degree, self.device)
            self.args = a
            self.cols = a.cols
            self.ref = ctypes.byref(a)
            self.call = _build.library().pdp_segment_sum_cols
            self.stream = _build.stream_fn(self.device)

    def launch(self, form, cols, stride, out):
        """One launch over column base pointers (the caller keeps their
        tensors alive)."""
        a = self.args
        n = len(cols)
        self.cols[:n] = cols
        a.n_cols = n
        a.stride = stride
        a.out = out.data_ptr()
        a.stream = self.stream()
        rc = self.call(self.ref)
        if rc:
            _build.check(rc, f"segment_sum_cols[{form}]")
        segment_sum_cols.launches += 1
        by = segment_sum_cols.launches_by_form
        by[form] = by.get(form, 0) + 1


_PLANS = _build.PlanCache()


def _plan(name, ids, num_segments, num_real, ptr, perm, sorted_ids=False,
          max_degree=None):
    return _PLANS.get((ids, ptr, perm),
                      (num_segments, num_real, sorted_ids, max_degree),
                      _Plan, name, ids, num_segments, num_real, ptr, perm,
                      sorted_ids, max_degree)


def _bad_col(name, x, plan):
    raise ValueError(f"{name}: columns must be f32{list(plan.shape)} on "
                     f"{plan.device}, got {x.dtype} {tuple(x.shape)} on "
                     f"{x.device}")


def segment_sum_cols_plain(cols, ids, num_segments, num_real):
    """The plain version: index_add_ of the stacked real edges (in the
    columns' dtype)."""
    x = torch.stack([c[:num_real] for c in cols])
    out = x.new_zeros((len(cols), num_segments))
    return out.index_add_(1, ids[:num_real], x)


def segment_sum_cols(cols, ids, num_segments, num_real, ptr, perm=None,
                     max_degree=None):
    """C f32[E] columns -> f32[C, num_segments]; see the module docstring.
    max_degree, when given, is the CSR's largest segment (FGBatch's
    var_max_degree / clause_max_degree)."""
    name = "segment_sum_cols"
    if not 1 <= len(cols) <= MAX_COLS:
        raise ValueError(f"{name}: {len(cols)} columns, expected 1.."
                         f"{MAX_COLS}")
    plan = _plan(name, ids, num_segments, num_real, ptr, perm,
                 max_degree=max_degree)
    shape, dev, kept = plan.shape, plan.device, []
    for c in cols:
        if c.shape != shape or c.dtype != F32 or c.device != dev:
            _bad_col(name, c, plan)
        kept.append(c if c.is_contiguous() else c.contiguous())
    if plan.args is None:
        return segment_sum_cols_plain(cols, ids, num_segments, num_real)
    out = cols[0].new_empty((len(cols), num_segments))
    plan.launch("cols", [c.data_ptr() for c in kept], 1, out)
    return out


segment_sum_cols.launches = 0
segment_sum_cols.launches_by_form = {}


def segment_sum_plain(x, ids, num_segments, num_real):
    """The plain version: index_add_ over the real rows."""
    out = torch.zeros((num_segments,) + tuple(x.shape[1:]),
                      dtype=torch.float32, device=x.device)
    return out.index_add_(0, ids[:num_real], x[:num_real])


def segment_sum(x, ids, num_segments, num_real, ptr, perm=None,
                max_degree=None):
    """f32[E] -> f32[N] or f32[E, C] (C <= 8) -> f32[N, C]; the [E, C]
    array is read in place, column c at stride C. max_degree as for
    segment_sum_cols."""
    name = "segment_sum"
    E = ids.shape[0]
    if (x.dtype != F32 or x.dim() not in (1, 2)
            or x.shape[0] != E
            or (x.dim() == 2 and not 1 <= x.shape[1] <= MAX_COLS)):
        raise ValueError(f"{name}: x must be f32[{E}] or f32[{E}, C <= "
                         f"{MAX_COLS}], got {x.dtype} {tuple(x.shape)}")
    plan = _plan(name, ids, num_segments, num_real, ptr, perm,
                 max_degree=max_degree)
    if x.device != plan.device:
        raise ValueError(f"{name}: x on {x.device}, ids on {plan.device}")
    if plan.args is None:
        return segment_sum_plain(x, ids, num_segments, num_real)
    if not x.is_contiguous():
        x = x.contiguous()
    C = 1 if x.dim() == 1 else x.shape[1]
    out = x.new_empty((C, num_segments))
    base = x.data_ptr()
    plan.launch("rows", [base + 4 * c for c in range(C)], C, out)
    return out[0] if x.dim() == 1 else out.T


def sorted_segment_sum_plain(x, ids, num_segments):
    """The plain version: index_add_ of the rows whose id is in range."""
    keep = (ids >= 0) & (ids < num_segments)
    out = torch.zeros(num_segments, dtype=torch.float32, device=x.device)
    return out.index_add_(0, ids[keep], x[keep])


def sorted_segment_sum(x, ids, num_segments):
    """f32[E] with ids sorted ascending -> f32[num_segments]. On the card
    each group of lanes finds its node's run of ids by binary search in
    the same launch (C = 1, no permutation)."""
    name = "sorted_segment_sum"
    if x.dtype != torch.float32 or x.dim() != 1 or ids.shape != x.shape:
        raise ValueError(f"{name}: x must be f32[E] with ids [E], got "
                         f"{x.dtype} {tuple(x.shape)}, ids "
                         f"{tuple(ids.shape)}")
    plan = _plan(name, ids, num_segments, 0, None, None, sorted_ids=True)
    if x.device != plan.device:
        raise ValueError(f"{name}: x on {x.device}, ids on {plan.device}")
    if plan.args is None:
        return sorted_segment_sum_plain(x, ids, num_segments)
    if not x.is_contiguous():
        x = x.contiguous()
    out = x.new_empty((1, num_segments))
    plan.launch("sorted", [x.data_ptr()], 1, out)
    return out[0]


# ---------------------------------------------------------------------------
# the group walk's order, in PyTorch (for tests and the card's checks)
# ---------------------------------------------------------------------------

def csr_bounds(ptr):
    """(lo, hi) i64[N] of a CSR's segments."""
    ptr = ptr.long()
    return ptr[:-1], ptr[1:]


def sorted_bounds(ids, num_segments):
    """(lo, hi) i64[N] of the runs of sorted ids equal to 0 .. N-1."""
    keys = torch.arange(num_segments + 1, device=ids.device,
                        dtype=ids.dtype)
    at = torch.searchsorted(ids.contiguous(), keys)
    return at[:-1], at[1:]


def anchor_segments(lo, hi, n_slots, group, node_at):
    """The heavy segment each anchored block of the walk works on, or -1:
    block a sits on slot s = a * S (S = HEAVY_ITERS * group) and takes a
    piece of the segment n = node_at[s] when n has S slots or more
    (csrc/common.cuh heavy_at)."""
    S = _build.HEAVY_ITERS * group
    s = torch.arange(0, n_slots, S, device=lo.device)
    n = node_at[s].long()
    ok = (n >= 0) & (n < lo.shape[0])
    n = n.clamp(0, max(lo.shape[0] - 1, 0))
    ok &= (hi[n] - lo[n]) >= S
    return torch.where(ok, n, torch.full_like(n, -1))


def heavy_pieces(lo, hi, S):
    """The pieces [j0, j1) of a heavy segment [lo, hi), one per anchored
    block inside it, in anchor order."""
    a0, a1 = -(-lo // S), (hi - 1) // S
    return [(lo if a == a0 else a * S, min(a * S + S, hi))
            for a in range(a0, a1 + 1)]


def sorted_quick_reject(ids, num_segments, group):
    """The sorted form's early exit (csrc/common.cuh SortedSeg heavy_at):
    per anchor, True where two loads show that no run of S slots holds
    it, before any search."""
    S = _build.HEAVY_ITERS * group
    n_ids = ids.shape[0]
    s = torch.arange(0, n_ids, S, device=ids.device)
    n = ids[s]
    out = (n < 0) | (n >= num_segments)
    a, b = s - S // 2, s + S // 2 - 1
    near = (((a >= 0) & (ids[a.clamp(min=0)] == n))
            | ((b < n_ids) & (ids[b.clamp(max=n_ids - 1)] == n)))
    return out | ~near


def _lane_sums(x, lo, hi, width, slot_edge):
    """[C, n, width]: lane l of segment i sums the slots lo[i] + l,
    lo[i] + l + width, ... < hi[i] in order."""
    C, n = x.shape[0], lo.shape[0]
    acc = x.new_zeros((C, n, width))
    if n == 0:
        return acc
    lane = torch.arange(width, device=x.device)
    zero = x.new_zeros(())
    for k in range(math.ceil(int((hi - lo).max()) / width)):
        j = lo[:, None] + lane + k * width
        valid = j < hi[:, None]
        j = torch.where(valid, j, torch.zeros_like(j))
        e = j if slot_edge is None else slot_edge[j]
        acc = acc + torch.where(valid, x[:, e], zero)
    return acc


def _butterfly(acc, width):
    """Every lane's total after xor shuffles width/2, ..., 1 (last dim)."""
    lane = torch.arange(acc.shape[-1], device=acc.device)
    off = width // 2
    while off:
        acc = acc + acc[..., lane ^ off]
        off //= 2
    return acc


def walk_order_sum(x, lo, hi, slot_edge, group):
    """The kernel's sums in the kernel's order: x f32[C, E] edge terms,
    segment n's slots [lo[n], hi[n]), slot j holding edge slot_edge[j]
    (j when None). A segment under S = HEAVY_ITERS * group slots is summed
    by a group of `group` lanes; a longer one in pieces (heavy_pieces),
    each by the THREADS threads of a block, and the pieces' totals added
    in order."""
    C, n_seg = x.shape[0], lo.shape[0]
    S = _build.HEAVY_ITERS * group
    out = x.new_empty((C, n_seg))
    light = torch.nonzero((hi - lo) < S)[:, 0]
    acc = _butterfly(_lane_sums(x, lo[light], hi[light], group, slot_edge),
                     group)
    out[:, light] = acc[..., 0]
    for n in torch.nonzero((hi - lo) >= S)[:, 0].tolist():
        pieces = torch.tensor(heavy_pieces(int(lo[n]), int(hi[n]), S),
                              device=x.device)
        acc = _lane_sums(x, pieces[:, 0], pieces[:, 1], THREADS, slot_edge)
        acc = _butterfly(acc.reshape(C, -1, THREADS // 32, 32), 32)
        part = acc[..., 0, 0]
        for w in range(1, THREADS // 32):
            part = part + acc[..., w, 0]
        tot = part[:, 0]
        for k in range(1, part.shape[1]):
            tot = tot + part[:, k]
        out[:, n] = tot
    return out
