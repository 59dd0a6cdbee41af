"""[E, d] feature blocks between edges and nodes: segment sum and gather.

Counterpart of `pdp_solver_tpu/ops/pallas_reduce2d.py`
(`windowed_segment_sum_2d` :109 and `windowed_gather_2d` :120). The
neural modules move [E, d] hidden states (d = 50..150) between edges and
variables every iteration through these two.

segment_sum_2d(x, ids, num_segments, num_real, ptr, perm) -> f32[N, d]:
    row e of x goes to node ids[e], for the first num_real rows (the real
    edges); x is f32 or bf16 rows, the sums are taken in f32 and stay f32.
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
ptr[n]..ptr[n+1], as for clause-major clauses), so its sums have one fixed
order and no atomics. The gather's checks of its ids and their pointers
are worked out once per ids tensor and kept in a plan, so a call checks
the rows, fills the plan's argument block and makes one ctypes call. Calls
that launched a kernel are counted in `.launches` (f32 rows) and
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
"clause": the clause-major one). bf16 rows that require grad raise: no
training configuration uses bf16, and the bf16 rules are not tested.
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


def _segment_sum_2d(x, ids, num_segments, num_real, ptr, perm=None):
    """The sum without autograd: the plain version on the CPU, the
    kernel on the card."""
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
    bf16 = x.dtype == torch.bfloat16
    rc = _build.library().pdp_segment_sum_2d(
        x.data_ptr(), int(bf16), d, ptr.data_ptr(),
        perm.data_ptr() if perm is not None and perm.numel() else None,
        num_segments, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "segment_sum_2d")
    if bf16:
        segment_sum_2d.launches_bf16 += 1
    else:
        segment_sum_2d.launches += 1
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
    def forward(ctx, x, ids, num_segments, num_real, ptr, perm):
        ctx.save_for_backward(ids)
        ctx.num_real, ctx.side = num_real, _side(perm)
        return _segment_sum_2d(x, ids, num_segments, num_real, ptr, perm)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        gx = _gather_2d(g.contiguous(), ids)
        gx[ctx.num_real:] = 0.0
        if gx.is_cuda:
            gather_2d.launches_bwd[ctx.side] += 1
        return gx, None, None, None, None, None


class Gather2d(torch.autograd.Function):
    """gather_2d (minus) with its transpose, segment_sum_2d of the
    cotangent over the CSR of the ids (JAX `_gather2d_bwd` :152), and -g
    to the subtrahend."""

    @staticmethod
    def forward(ctx, nodes, minus, ids, num_real, ptr, perm):
        ctx.save_for_backward(ids, ptr, perm)
        ctx.num_nodes, ctx.num_real = nodes.shape[0], num_real
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
                                      ptr, perm)
            if g.is_cuda:
                segment_sum_2d.launches_bwd[_side(perm)] += 1
        if ctx.needs_input_grad[1]:
            g_minus = (-g).to(ctx.minus_dtype)
        return g_nodes, g_minus, None, None, None, None


def segment_sum_2d(x, ids, num_segments, num_real, ptr, perm=None):
    """[E, d] -> f32[num_segments, d]; see the module docstring. Through
    SegmentSum2d when grad mode is on and x requires grad."""
    if _needs_grad(x):
        _refuse_bf16_grad("segment_sum_2d", x)
        return SegmentSum2d.apply(x, ids, num_segments, num_real, ptr, perm)
    return _segment_sum_2d(x, ids, num_segments, num_real, ptr, perm)


segment_sum_2d.launches = 0
segment_sum_2d.launches_bf16 = 0
segment_sum_2d.launches_bwd = {"var": 0, "clause": 0}


def gather_2d(nodes, ids, minus=None, csr=None):
    """f32[N, d] -> f32[len(ids), d]; see the module docstring. Through
    Gather2d when grad mode is on and nodes or minus requires grad, which
    needs csr = (num_real, ptr, perm), the CSR of ids for the
    transpose."""
    if _needs_grad(nodes, minus):
        if csr is None:
            raise ValueError("gather_2d: a gather that requires grad needs "
                             "csr=(num_real, ptr, perm) of its ids for its "
                             "transpose")
        _refuse_bf16_grad("gather_2d", nodes, minus)
        return Gather2d.apply(nodes, minus, ids, *csr)
    return _gather_2d(nodes, ids, minus)


gather_2d.launches = 0
gather_2d.launches_bf16 = 0
gather_2d.launches_bwd = {"var": 0, "clause": 0}
