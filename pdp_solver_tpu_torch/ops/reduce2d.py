"""[E, d] feature blocks between edges and nodes: segment sum and gather.

Counterpart of `pdp_solver_tpu/ops/pallas_reduce2d.py`
(`windowed_segment_sum_2d` :109 and `windowed_gather_2d` :120). The
neural modules move [E, d] hidden states (d = 50..150) between edges and
variables every iteration through these two.

segment_sum_2d(x, ids, num_segments, num_real, ptr, perm, max_degree)
        -> f32[N, d]:
    row e of x goes to node ids[e], for the first num_real rows (the real
    edges); x is f32 or bf16 rows, the sums are taken in f32 and stay f32.
    max_degree (None: not known) is the CSR's largest segment.
gather_2d(nodes, ids, minus=None) -> f32[E, d]
    nodes[ids[e]] for every e (padding rows included), minus the matching
    row of `minus` when it is given (the aggregate-minus-self of the
    neural aggregators, fused); nodes f32, minus f32 or bf16, the subtract
    in f32; ids i32 (as the JAX kernel takes them, `FGBatch.edge_var32`)
    or i64.

bf16 rows are those of the neural aggregators' compute_dtype="bfloat16":
the JAX package multiplies them by its f32 edge mask before it sums, so
its sums, its gathers and the subtract are f32 (`pdp_solver_tpu/modules/
common.py` :148-152), and these are the only bf16 forms either package
takes. A bf16 row goes to a bf16 instantiation of the kernel, which widens
it on load: it is never widened into the f32 kernel's input. Each wrapper
runs its plain PyTorch version when the tensors lie on the CPU and
launches its CUDA kernel (`csrc/reduce2d.cu`) when they lie on the card,
or raises; there is no fallback between the two. On the card the segment
sum walks the CSR (ptr, perm) that lists each node's rows in increasing
order (`FGBatch.var_ptr`/`var_perm`; perm None means rows
ptr[n]..ptr[n+1], as for clause-major clauses): a warp takes a node, and
a node of R2D_HEAVY rows or more is cut among blocks of a first launch,
whose pieces are added in a fixed order; so its sums have one fixed
order (`walk_order_sum_2d` repeats it) and no float atomics. With
max_degree under R2D_HEAVY there is no launch for heavy nodes; the edge
ids find the heavy node at each anchor. The checks of each wrapper's
index tensors and their pointers (and the sum's scratch) are worked out
once per index tensors and kept in a plan, so a call checks the rows,
fills the plan's argument block and makes one ctypes call. Calls that
launched a kernel are counted in `.launches` (f32 rows) and
`.launches_bf16` (bf16 rows: x, or the gather's subtrahend).

Gradients (the JAX kernels' custom VJPs, `_sum2d_bwd` :142 and
`_gather2d_bwd` :152): each is the other's transpose. When grad mode is
on and an input requires grad, the call goes through `SegmentSum2d` or
`Gather2d`, torch.autograd.Functions whose backward is the other
wrapper, so on the card kernel 7 is kernel 6's backward and kernel 6 is
kernel 7's, and on the CPU the backward runs the plain transposes (the
same logic, not torch's autograd of index_add_). The sum's transpose
gathers the cotangent to the real rows and gives the padding rows zero
(the forward never read them). The gather writes every row, padding
included, but its transpose sums the real rows of the CSR only: that is
exact where the padding rows' cotangent is zero, which holds on every
path of the port (a padding edge's rows reach the loss only through the
edge masks, which are 0 there), and the CPU route checks it on every
backward. A differentiable gather therefore needs the CSR of its ids,
`csr=(num_real, ptr, perm)`. The launches made as a backward rule are
also counted in `.launches_bwd`, by side ("var": a CSR with perm;
"clause": the clause-major one). A gather's csr given as a `Csr` carries
the CSR's largest segment too, which its transpose hands to the sum.
bf16 rows that require grad raise: no training configuration uses bf16,
and the bf16 rules are not tested.
"""

import ctypes

import torch

from pdp_solver_tpu_torch.ops import _build


_DTYPES = (torch.float32, torch.bfloat16)


def _check_rows(name, x, what, dtypes=_DTYPES):
    if x.dim() != 2 or x.dtype not in dtypes:
        kinds = " or ".join(str(t).split(".")[1] for t in dtypes)
        raise ValueError(f"{name}: {what} must be {kinds}[rows, d], got "
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
    """The plain version: index_add_ over the real rows in f32. (A bf16
    index_add_ would round at every add: not the JAX kernel's function.)"""
    out = torch.zeros((num_segments, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    out.index_add_(0, ids[:num_real], x[:num_real].float())
    return out


class _SumPlan:
    """The checked CSR of a segment sum and, on the card, the kernel's
    argument block and scratch for it and rows of d columns."""

    def __init__(self, ids, num_segments, num_real, ptr, perm, max_degree,
                 d):
        name = "segment_sum_2d"
        self.device = _device(name, ids, ptr, perm)
        if ids.dim() != 1 or ids.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"{name}: ids must be i32[E] or i64[E], got "
                             f"{ids.dtype} {tuple(ids.shape)}")
        self.rows = ids.shape[0]
        if num_real > self.rows:
            raise ValueError(f"{name}: {num_real} real rows of {self.rows}")
        self.args = None
        if self.device.type != "cuda":
            return
        if ptr.dtype != torch.int32 or ptr.shape != (num_segments + 1,):
            raise ValueError(f"{name}: ptr must be i32[{num_segments + 1}]"
                             f", got {ptr.dtype} {tuple(ptr.shape)}")
        if perm is not None and (perm.dtype != torch.int32
                                 or perm.shape != (num_real,)):
            raise ValueError(f"{name}: perm must be i32[{num_real}], "
                             f"got {perm.dtype} {tuple(perm.shape)}")
        a = _build.SegSum2dArgs()
        self.index = (ids.contiguous(), ptr.contiguous(),
                      None if perm is None else perm.contiguous())
        a.ids = self.index[0].data_ptr()
        a.ids64 = int(ids.dtype == torch.int64)
        a.ptr = self.index[1].data_ptr()
        a.perm = (self.index[2].data_ptr() if perm is not None and num_real
                  else None)
        a.d = d
        a.n_seg = num_segments
        a.n_slots = num_real
        self.scratch = _build.sum2d_scratch(a, num_real, d, max_degree,
                                            self.device)
        self.args = a
        self.ref = ctypes.byref(a)
        self.call = _build.library().pdp_segment_sum_2d
        self.stream = _build.stream_fn(self.device)


_SUM_PLANS = _build.PlanCache()


def _segment_sum_2d(x, ids, num_segments, num_real, ptr, perm=None,
                    max_degree=None):
    """The sum without autograd: the plain version on the CPU, the
    kernel on the card."""
    _check_rows("segment_sum_2d", x, "x")
    d = x.shape[1]
    plan = _SUM_PLANS.get((ids, ptr, perm),
                          (num_segments, num_real, max_degree, d), _SumPlan,
                          ids, num_segments, num_real, ptr, perm, max_degree,
                          d)
    if x.shape[0] != plan.rows or x.device != plan.device:
        raise ValueError(f"segment_sum_2d: x is {tuple(x.shape)} on "
                         f"{x.device}, ids [{plan.rows}] on {plan.device}")
    a = plan.args
    if a is None:
        return segment_sum_2d_plain(x, ids, num_segments, num_real)
    if not x.is_contiguous():
        x = x.contiguous()
    out = torch.empty((num_segments, d), dtype=torch.float32,
                      device=plan.device)
    bf16 = x.dtype == torch.bfloat16
    a.x = x.data_ptr()
    a.x_bf16 = int(bf16)
    a.out = out.data_ptr()
    a.stream = plan.stream()
    rc = plan.call(plan.ref)
    if rc:
        _build.check(rc, "segment_sum_2d")
    if bf16:
        segment_sum_2d.launches_bf16 += 1
    else:
        segment_sum_2d.launches += 1
    return out


def walk_order_sum_2d(x, ptr, perm=None):
    """The kernel's sums in the kernel's order (csrc/reduce2d.cu): x
    [E, d] rows (f32 or bf16, added in f32), node n's rows at the slots
    [ptr[n], ptr[n+1]), slot j holding row perm[j] (j when perm is None).
    A node under R2D_HEAVY slots adds its rows one after another in slot
    order; a longer one is cut into the pieces of the blocks anchored in
    it, where warp w of a block adds the piece's chunks of 32 slots w,
    w + 8, ... in turn, the block adds its warps' rows in warp order, and
    the last block in adds the pieces' rows: warp w those of the w-th of
    W runs of ceil(pieces / W) in anchor order, then the runs' rows in
    order. For the tests and the
    card's checks: on the card the kernel's sums equal these bit for
    bit."""
    S, W, C = _build.R2D_HEAVY, _build.R2D_WARPS, 32
    dev = x.device
    x = x.float()
    ptr = ptr.long()
    lo, hi = ptr[:-1], ptr[1:]
    deg = hi - lo
    slot = (torch.arange(int(ptr[-1]), device=dev) if perm is None
            else perm.long())
    out = x.new_zeros((lo.shape[0], x.shape[1]))
    light = torch.nonzero((deg > 0) & (deg < S))[:, 0]
    if light.numel():
        acc = x.new_zeros((light.shape[0], x.shape[1]))
        for k in range(int(deg[light].max())):
            on = torch.nonzero(deg[light] > k)[:, 0]
            acc[on] = acc[on] + x[slot[lo[light[on]] + k]]
        out[light] = acc
    heavy = torch.nonzero(deg >= S)[:, 0]
    if not heavy.numel():
        return out
    # the pieces [j0, j1) of each heavy node, one per anchor inside it, in
    # anchor order
    a0, a1 = -(-lo[heavy] // S), (hi[heavy] - 1) // S
    count = a1 - a0 + 1
    node = torch.repeat_interleave(torch.arange(heavy.shape[0], device=dev),
                                   count)
    first = torch.cumsum(count, 0) - count
    k = torch.arange(node.shape[0], device=dev) - first[node]
    anchor = (a0[node] + k) * S
    j0 = torch.where(k == 0, lo[heavy][node], anchor)
    j1 = torch.minimum(anchor + S, hi[heavy][node])
    # warp w of a piece's block takes its chunks w, w + W, ... of C slots:
    # slot j0 + t is step (c // W) * C + t % C of warp c % W, c = t // C
    lens = j1 - j0
    pid = torch.repeat_interleave(torch.arange(lens.shape[0], device=dev),
                                  lens)
    t = torch.arange(pid.shape[0], device=dev) - (torch.cumsum(lens, 0)
                                                  - lens)[pid]
    c = t // C
    step = (c // W) * C + t % C
    idx = torch.full((lens.shape[0], W, int(step.max()) + 1), -1,
                     dtype=torch.long, device=dev)
    idx[pid, c % W, step] = slot[j0[pid] + t]
    acc = x.new_zeros((lens.shape[0], W, x.shape[1]))
    for i in range(idx.shape[2]):
        on = idx[:, :, i] >= 0
        acc[on] = acc[on] + x[idx[:, :, i][on]]
    part = acc[:, 0]
    for w in range(1, W):
        part = part + acc[:, w]
    # the last block in: warp w adds the pieces [w m, w m + m) of the node
    # in anchor order, m = ceil(pieces / W); then the warps' rows in order
    m = (count + W - 1) // W
    tot = None
    for w in range(W):
        r = x.new_zeros((heavy.shape[0], x.shape[1]))
        for i in range(int(m.max())):
            on = torch.nonzero((i < m) & (w * m + i < count))[:, 0]
            r[on] = r[on] + part[first[on] + w * m[on] + i]
        tot = r if tot is None else tot + r
    out[heavy] = tot
    return out


def gather_2d_plain(nodes, ids, minus=None):
    """The plain version: index_select (minus the subtrahend, in f32)."""
    out = nodes.index_select(0, ids)
    return out if minus is None else out - minus.float()


class _GatherPlan:
    """The checked ids of a gather and, on the card, the kernel's argument
    block for them."""

    def __init__(self, ids):
        if ids.dim() != 1 or ids.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"gather_2d: ids must be i32[E] or i64[E], got "
                             f"{ids.dtype} {tuple(ids.shape)}")
        self.device = _device("gather_2d", ids)
        self.rows = ids.shape[0]
        self.args = None
        if self.device.type == "cuda":
            a = _build.GatherArgs()
            self.ids = ids.contiguous()
            a.ids = self.ids.data_ptr()
            a.ids64 = int(ids.dtype == torch.int64)
            a.n_rows = self.rows
            self.args = a
            self.ref = ctypes.byref(a)
            self.call = _build.library().pdp_gather_2d
            self.stream = _build.stream_fn(self.device)


_PLANS = _build.PlanCache()


def _gather_2d(nodes, ids, minus=None):
    """The gather without autograd: the plain version on the CPU, the
    kernel on the card."""
    plan = _PLANS.get((ids,), None, _GatherPlan, ids)
    _check_rows("gather_2d", nodes, "nodes", (torch.float32,))
    E, d = plan.rows, nodes.shape[1]
    if nodes.device != plan.device:
        raise ValueError(f"gather_2d: nodes on {nodes.device}, ids on "
                         f"{plan.device}")
    if minus is not None:
        _check_rows("gather_2d", minus, "minus")
        if minus.shape != (E, d) or minus.device != plan.device:
            raise ValueError(f"gather_2d: minus is {tuple(minus.shape)} on "
                             f"{minus.device}, expected ({E}, {d}) on "
                             f"{plan.device}")
    a = plan.args
    if a is None:
        return gather_2d_plain(nodes, ids, minus)
    if not nodes.is_contiguous():
        nodes = nodes.contiguous()
    if minus is not None and not minus.is_contiguous():
        minus = minus.contiguous()
    out = nodes.new_empty((E, d))
    a.nodes = nodes.data_ptr()
    a.d = d
    a.minus = None if minus is None else minus.data_ptr()
    a.out = out.data_ptr()
    a.minus_bf16 = int(minus is not None and minus.dtype == torch.bfloat16)
    a.stream = plan.stream()
    rc = plan.call(plan.ref)
    if rc:
        _build.check(rc, "gather_2d")
    if a.minus_bf16:
        gather_2d.launches_bf16 += 1
    else:
        gather_2d.launches += 1
    return out



class Csr(tuple):
    """(num_real, ptr, perm) of a CSR, with its largest segment as
    .max_degree (None: not known)."""

    def __new__(cls, num_real, ptr, perm, max_degree=None):
        csr = super().__new__(cls, (num_real, ptr, perm))
        csr.max_degree = max_degree
        return csr


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _refuse_bf16_grad(name, *tensors):
    for t in tensors:
        if t is not None and t.requires_grad and t.dtype == torch.bfloat16:
            raise NotImplementedError(
                f"{name}: bf16 rows that require grad; no training "
                "configuration uses bf16, and the bf16 backward rules are "
                "not tested")


def _side(perm):
    return "clause" if perm is None else "var"


class SegmentSum2d(torch.autograd.Function):
    """segment_sum_2d with its transpose, gather_2d of the cotangent to
    the real rows (JAX `_sum2d_bwd` :142)."""

    @staticmethod
    def forward(ctx, x, ids, num_segments, num_real, ptr, perm, max_degree):
        ctx.save_for_backward(ids)
        ctx.num_real, ctx.side = num_real, _side(perm)
        return _segment_sum_2d(x, ids, num_segments, num_real, ptr, perm,
                               max_degree)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        gx = _gather_2d(g.contiguous(), ids)
        gx[ctx.num_real:] = 0.0
        if gx.is_cuda:
            gather_2d.launches_bwd[ctx.side] += 1
        return gx, None, None, None, None, None, None


class Gather2d(torch.autograd.Function):
    """gather_2d (minus) with its transpose, segment_sum_2d of the
    cotangent over the CSR of the ids (JAX `_gather2d_bwd` :152), and -g
    to the subtrahend."""

    @staticmethod
    def forward(ctx, nodes, minus, ids, num_real, ptr, perm, max_degree):
        ctx.save_for_backward(ids, ptr, perm)
        ctx.num_nodes, ctx.num_real = nodes.shape[0], num_real
        ctx.max_degree = max_degree
        ctx.minus_dtype = None if minus is None else minus.dtype
        return _gather_2d(nodes, ids, minus)

    @staticmethod
    def backward(ctx, g):
        ids, ptr, perm = ctx.saved_tensors
        g = g.contiguous()
        if not g.is_cuda and bool((g[ctx.num_real:] != 0).any()):
            raise RuntimeError(
                "gather_2d: the cotangent of a padding row is not zero, "
                "and the transpose sums the real rows only; mask the "
                "padding rows before they reach the loss")
        g_nodes = g_minus = None
        if ctx.needs_input_grad[0]:
            g_nodes = _segment_sum_2d(g, ids, ctx.num_nodes, ctx.num_real,
                                      ptr, perm, ctx.max_degree)
            if g.is_cuda:
                segment_sum_2d.launches_bwd[_side(perm)] += 1
        if ctx.needs_input_grad[1]:
            g_minus = (-g).to(ctx.minus_dtype)
        return g_nodes, g_minus, None, None, None, None, None


def segment_sum_2d(x, ids, num_segments, num_real, ptr, perm=None,
                   max_degree=None):
    """[E, d] -> f32[num_segments, d]; see the module docstring.
    max_degree, when given, is the CSR's largest segment (FGBatch's
    var_max_degree / clause_max_degree). Through SegmentSum2d when grad
    mode is on and x requires grad."""
    if _needs_grad(x):
        _refuse_bf16_grad("segment_sum_2d", x)
        return SegmentSum2d.apply(x, ids, num_segments, num_real, ptr, perm,
                                  max_degree)
    return _segment_sum_2d(x, ids, num_segments, num_real, ptr, perm,
                           max_degree)


segment_sum_2d.launches = 0
segment_sum_2d.launches_bf16 = 0
segment_sum_2d.launches_bwd = {"var": 0, "clause": 0}


def gather_2d(nodes, ids, minus=None, csr=None):
    """f32[N, d] -> f32[len(ids), d]; see the module docstring. Through
    Gather2d when grad mode is on and nodes or minus requires grad, which
    needs csr = (num_real, ptr, perm), the CSR of ids for the transpose
    (a Csr also hands its max_degree to the transpose's sum)."""
    if _needs_grad(nodes, minus):
        if csr is None:
            raise ValueError("gather_2d: a gather that requires grad needs "
                             "csr=(num_real, ptr, perm) of its ids for its "
                             "transpose")
        _refuse_bf16_grad("gather_2d", nodes, minus)
        return Gather2d.apply(nodes, minus, ids, *csr,
                              getattr(csr, "max_degree", None))
    return _gather_2d(nodes, ids, minus)


gather_2d.launches = 0
gather_2d.launches_bf16 = 0
gather_2d.launches_bwd = {"var": 0, "clause": 0}
