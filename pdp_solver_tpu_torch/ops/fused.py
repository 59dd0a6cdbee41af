"""Fused and chained edge passes: gather -> elementwise -> reduce.

Counterpart of `pdp_solver_tpu/ops/pallas_fused.py` (`fused_edge_pass`
:553 and `chained_edge_pass` :442). The JAX functions take caller closures;
here each caller is a named functor, declared once below with its plain
PyTorch version and once in `csrc/edge_pass.cu` as a device struct. The
wrapper runs the plain version when the batch lies on the CPU and launches
the CUDA kernel when it lies on the card (or raises); there is no fallback
between the two.

Inputs are passed as one tuple `ins` whose layout each functor fixes (the
`layout` string: V = a variable column, F = a clause column, E = an edge
column). Node columns are gathered through edge_var / edge_clause.

fused_edge_pass(fn, batch, ins) -> (reduced [n_red, V] or None, eouts)
    one direction: per-edge f, then a sum per variable (side "var") or
    none. (Every clause-direction reduce on the path is the first phase of
    a chained pass.)
chained_edge_pass(fn, batch, ins) -> (cout [n_cout, F] or None,
                                      vred [n_vred, V] or None, eouts,
                                      ired [n_ired, B] or None)
    both directions: f1 per edge summed per clause, f2 per clause
    (clause outputs, columns broadcast back to the edges, clause columns
    summed per instance), f3 per edge summed per variable.

Each wrapper counts the calls that launched its kernel in `.launches`
(and per functor in `.launches_by_fn`).
"""

import ctypes
import dataclasses
from typing import Callable

import torch

from pdp_solver_tpu_torch.ops import _build
from pdp_solver_tpu_torch.ops.reduce import (
    csr_bounds, segment_sum_cols_plain, walk_order_sum)
from pdp_solver_tpu_torch.ops.segment import (
    LOG_EPS_PROP, LOG_EPS_SCORE, safe_exp, safe_log)


F32 = torch.float32


def _flag(b):
    return b.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class EdgeFn:
    """A fused-pass functor: plain(ins, ev, ec, s) -> (red cols, eouts)."""
    name: str
    side: str          # "none" | "var"
    layout: str        # one of V/F/E per input
    inputs: tuple      # the inputs' names, in order
    n_red: int
    n_eout: int
    plain: Callable
    flops: int         # arithmetic per edge (for the bound)

    @property
    def meta(self):
        side = {"none": 0, "var": 1}[self.side]
        return (0, side, len(self.layout), self.n_red, self.n_eout,
                0, 0, 0, 0, 0)


@dataclasses.dataclass(frozen=True)
class ChainFn:
    """A chained-pass functor.

    f1(ins, ev, ec) -> n_cred edge columns (summed per clause)
    f2(cred, ins) -> (n_cout clause outputs, n_bcast clause columns,
                      n_ired clause columns summed per instance)
    f3(bcast_e, ins, ev, ec) -> (n_vred edge columns summed per variable,
                                 n_eout edge outputs)
    """
    name: str
    layout: str
    inputs: tuple
    n_cred: int
    n_cout: int
    n_bcast: int
    n_vred: int
    n_eout: int
    n_ired: int
    f1: Callable
    f2: Callable
    f3: Callable
    flops: int

    @property
    def meta(self):
        return (1, 0, len(self.layout), 0, self.n_eout, self.n_cred,
                self.n_cout, self.n_bcast, self.n_vred, self.n_ired)


# ---------------------------------------------------------------------------
# functors (input layouts must match csrc/edge_pass.cu)
# ---------------------------------------------------------------------------

def q_triplet_stable(same, opp):
    """(q_u, q_s, q_dc, total) from the log-domain same/opp aggregations,
    shifted by max(same, opp) so the normalisation never divides 0/0
    (propagate.py q_triplet_stable :168)."""
    b = torch.maximum(same, opp)
    s = safe_exp(same - b)
    o = safe_exp(opp - b)
    d = safe_exp(same + opp - b)
    q_u = torch.clamp(s - d, min=0.0)
    q_s = torch.clamp(o - d, min=0.0)
    total = torch.clamp(q_u + q_s + d, min=1e-20)
    return q_u, q_s, d, total


def _sp_pass_c(ins, ev, ec, pi):
    pos, neg, eta_in, em, mask, sign, force, v0, v1, v2 = ins
    pos, neg = pos[ev], neg[ev]
    lm = safe_log(1.0 - eta_in, LOG_EPS_PROP) * em
    same = 0.5 * (1 + sign) * pos + 0.5 * (1 - sign) * neg - lm
    same = same + safe_log(1.0 - pi * _flag(force == sign), LOG_EPS_PROP)
    opp = 0.5 * (1 - sign) * pos + 0.5 * (1 + sign) * neg
    opp = opp + safe_log(1.0 - pi * _flag(force == -sign), LOG_EPS_PROP)
    q_u, q_s, d, total = q_triplet_stable(same, opp)
    return (), tuple(mask * (q / total) + (1.0 - mask) * v
                     for q, v in ((q_u, v0), (q_s, v1), (d, v2)))


def _smax_scorer(ins, ev, ec, s):
    ac, prev_eta, eta, em, bmask, force, sign = ins
    diff = torch.abs(prev_eta - eta) * em
    cd = safe_exp(30.0 * diff) * bmask
    ce = safe_exp(30.0 * eta) * bmask
    em_s = ac[ec] * bmask
    fm1 = safe_log(1.0 - eta, LOG_EPS_SCORE) * em_s
    pos_w, neg_w = _flag(sign == 1), _flag(sign == -1)
    return (diff * cd, cd, eta * ce, ce, force * bmask, fm1 * pos_w,
            fm1 * neg_w, fm1), ()


def _smax(ins, ev, ec, s):
    prev_eta, eta, em, bmask = ins
    diff = torch.abs(prev_eta - eta) * em
    c = safe_exp(30.0 * diff) * bmask
    return (diff * c, c), ()


def _scorer(ins, ev, ec, s):
    ac, eta, force, sign, mask = ins
    em = ac[ec] * mask
    fm1 = safe_log(1.0 - eta, LOG_EPS_SCORE) * em
    return (force * mask, fm1 * _flag(sign == 1), fm1 * _flag(sign == -1),
            fm1), ()


def _em_ae(ins, ev, ec, s):
    av, abv, ac, mask = ins
    return (), (av[ev] * ac[ec] * mask, abv[ev])


def _em(ins, ev, ec, s):
    av, ac, mask = ins
    return (), (av[ev] * ac[ec] * mask,)


def _ae(ins, ev, ec, s):
    (abv,) = ins
    return (), (abv[ev],)


SP_PASS_C = EdgeFn(
    "sp_pass_c", "none", "VVEEEEEEEE",
    ("pos", "neg", "eta_in", "em", "mask", "sign", "force", "v0", "v1",
     "v2"), 0, 3, _sp_pass_c, 40)
SMAX_SCORER = EdgeFn(
    "smax_scorer", "var", "FEEEEEE",
    ("ac", "prev_eta", "eta", "em", "bmask", "force", "sign"), 8, 0,
    _smax_scorer, 30)
# the convergence smooth-max columns alone (decimate.py _smax_pass2 :114;
# columns 0-1 of _smax_pass4 :122): np-d-np's sequential decimator over
# the neural propagator's fn[:, 0]
SMAX = EdgeFn("smax", "var", "EEEE", ("prev_eta", "eta", "em", "bmask"), 2,
              0, _smax, 8)
SCORER = EdgeFn("scorer", "var", "FEEEE",
                ("ac", "eta", "force", "sign", "mask"), 4, 0, _scorer, 12)
EM_AE = EdgeFn("em_ae", "none", "VVFE", ("av", "abv", "ac", "mask"), 0, 2,
               _em_ae, 2)
EM = EdgeFn("em", "none", "VFE", ("av", "ac", "mask"), 0, 1, _em, 2)
AE = EdgeFn("ae", "none", "V", ("abv",), 0, 1, _ae, 0)


def _sp_f1(ins, ev, ec):
    u_in, eta_in, em, mask, eta_state, sign = ins
    return (safe_log(u_in, LOG_EPS_PROP) * em,)


def _sp_f1_login(ins, ev, ec):
    log_u_in, eta_in, em, mask, eta_state, sign = ins
    return (log_u_in * em,)


def _sp_f2(cred, ins):
    return (), cred, ()


def _sp_f3_of(login):
    def f3(bc, ins, ev, ec):
        u_in, eta_in, em, mask, eta_state, sign = ins
        log_u = (u_in if login else safe_log(u_in, LOG_EPS_PROP)) * em
        eta = safe_exp(bc[0] - log_u)
        new_eta = mask * eta + (1.0 - mask) * eta_state
        lm = safe_log(1.0 - eta_in, LOG_EPS_PROP) * em
        return (lm * _flag(sign == 1), lm * _flag(sign == -1)), (new_eta,)
    return f3


def _sround_f1(ins, ev, ec):
    av, sol, sign, mask, ac = ins
    av_e, sol_e = av[ev], sol[ev]
    lit_true = torch.where(sign > 0, _flag(sol_e >= 1.0), _flag(sol_e <= 0.0))
    assigned = _flag(av_e <= 0)
    return (av_e * mask, lit_true * assigned * mask)


def _sround_f2(cred, ins):
    degree_f, sat_f = cred
    ac = ins[4]
    ac2 = torch.where(sat_f > 0, torch.zeros_like(ac), ac)
    single_f = _flag(degree_f == 1.0) * ac2
    return (ac2,), (ac2, single_f), ()


def _sround_f3(bc, ins, ev, ec):
    ac_e, single_e = bc
    sign, mask = ins[2], ins[3]
    s_e = single_e * mask
    c_e = ac_e * mask
    return (s_e, sign * s_e, c_e, sign * c_e), ()


def _cnf_f1(ins, ev, ec):
    p, sign, mask, cm = ins
    lit = sign * p[ev] + (1.0 - sign) / 2.0
    return (_flag(lit > 0.5) * mask,)


def _cnf_f2(cred, ins):
    cm = ins[3]
    return (), (), (cm, _flag(cred[0] > 0) * cm)


def _ws_f1(ins, ev, ec):
    sa, av, sign, mask, em, ac = ins
    return (sign * sa[ev] * mask, av[ev] * mask)


def _ws_f2(cred, ins):
    agg_f, degree_f = cred
    unsat_f = _flag(agg_f == -degree_f) * ins[5]
    return (), (agg_f, degree_f, unsat_f), (unsat_f,)


def _ws_f3(bc, ins, ev, ec):
    agg_c, degree_c, unsat_c = bc
    sa, av, sign, mask, em, ac = ins
    dist = sign * sa[ev] * mask
    agg_e = agg_c - dist
    critical = _flag(agg_e == (1.0 - degree_c)) * em
    return (critical * dist, unsat_c * mask), ()


def _no_f3(bc, ins, ev, ec):
    return (), ()


SP_CHAIN = ChainFn(
    "sp_chain", "EEEEEE",
    ("u_in", "eta_in", "em", "mask", "eta_state", "sign"), 1, 0, 1, 2, 1, 0,
    _sp_f1, _sp_f2, _sp_f3_of(False), 20)
# the same sweep for u already in log space (p-nd-np's adaptors,
# propagate.py _sp_chain_f1_login :250, _sp_chain_f3(login=True) :260)
SP_CHAIN_LOGIN = ChainFn(
    "sp_chain_login", "EEEEEE",
    ("log_u_in", "eta_in", "em", "mask", "eta_state", "sign"), 1, 0, 1, 2,
    1, 0, _sp_f1_login, _sp_f2, _sp_f3_of(True), 16)
SROUND = ChainFn("sround", "VVEEF", ("av", "sol", "sign", "mask", "ac"),
                 2, 1, 2, 4, 0, 0, _sround_f1, _sround_f2, _sround_f3, 12)
CNF_CHAIN = ChainFn("cnf_chain", "VEEF", ("p", "sign", "mask", "cm"),
                    1, 0, 0, 0, 0, 2, _cnf_f1, _cnf_f2, _no_f3, 6)
WS_CHAIN = ChainFn("ws_chain", "VVEEEF",
                   ("sa", "av", "sign", "mask", "em", "ac"),
                   2, 0, 3, 2, 0, 1, _ws_f1, _ws_f2, _ws_f3, 14)

FUSED_FNS = (SP_PASS_C, SMAX_SCORER, SMAX, SCORER, EM_AE, EM, AE)
CHAINED_FNS = (SP_CHAIN, SP_CHAIN_LOGIN, SROUND, CNF_CHAIN, WS_CHAIN)

# the JAX package's uniform clause widths for its chained passes
# (pallas_fused.py _TILES, k > 0)
CHAINED_WIDTHS = (2, 3, 4, 5, 6, 7, 8)


def use_chained_pass(batch) -> bool:
    """The JAX package's eligibility for its chained passes and the
    one-launch kernels built on them (`pallas_fused.py use_chained_pass`
    :434): a uniform clause width it has tiles for, on a batch that meets
    the window invariants. The CUDA kernels need neither; the rule keeps
    the two packages on one route."""
    return bool(batch.fast_var and batch.fast_clause
                and batch.clause_width in CHAINED_WIDTHS)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

class _Plan:
    """One functor on one batch: the shapes its inputs must have and, on
    the card, the kernel's argument block with everything that does not
    change from call to call (functor id, index and CSR pointers, counts,
    the var walk's group width and scratch, and for a chained pass its
    clause-level scratch). A plan's scratch serves one launch at a time:
    launches on one stream."""

    def __init__(self, fn, batch, fused):
        self.device = batch.device
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{fn.name}: unsupported device {self.device}")
        sizes = {"V": batch.num_vars, "F": batch.num_clauses,
                 "E": batch.num_edges}
        self.name = fn.name
        self.shapes = tuple(torch.Size([sizes[k]]) for k in fn.layout)
        self.args = None
        if self.device.type != "cuda":
            return
        a = _build.FusedArgs() if fused else _build.ChainedArgs()
        a.fn = _build.fn_id(fn.name, fn.meta)
        a.n_in, a.n_eout = len(fn.layout), fn.n_eout
        a.ev = batch.edge_var32.data_ptr()
        a.ec = batch.edge_clause32.data_ptr()
        a.e_real, a.e_total = batch.num_real_edges, batch.num_edges
        a.group = _build.GROUP_MIN
        self.scratch = ()
        if fused:
            self._fused_args(fn, batch, a)
        else:
            self._chained_args(fn, batch, a)
        self.args = a
        self.ins, self.eouts = a.ins, a.eouts
        self.eout_shape = (batch.num_edges,)
        self.n_eout = fn.n_eout
        self.ref = ctypes.byref(a)
        self.stream = _build.stream_fn(self.device)

    def _var_walk(self, batch, a):
        """The var walk's group width and scratch in a."""
        a.group = _build.group_width(batch.num_real_edges, batch.num_vars)
        self.scratch = _build.walk_scratch(
            a, batch.num_real_edges, a.group, batch.var_max_degree,
            self.device)

    def _fused_args(self, fn, batch, a):
        self.red_shape = None
        if fn.side == "var":
            a.n_seg = batch.num_vars
            a.ptr = batch.var_ptr.data_ptr()
            a.perm = (batch.var_perm.data_ptr() if batch.var_perm.numel()
                      else None)
            self._var_walk(batch, a)
            self.red_shape = (fn.n_red, batch.num_vars)
        self.call = _build.library().pdp_fused_edge_pass

    def _chained_args(self, fn, batch, a):
        F = batch.num_clauses
        a.n_vars, a.n_clauses = batch.num_vars, F
        a.n_inst = batch.batch_size
        a.inner_pad = int(batch.inner_padding)
        a.var_ptr = batch.var_ptr.data_ptr()
        a.var_perm = (batch.var_perm.data_ptr() if batch.var_perm.numel()
                      else None)
        a.clause_ptr = batch.clause_ptr.data_ptr()
        a.inst_clause_ptr = batch.inst_clause_ptr.data_ptr()
        if fn.n_vred:
            self._var_walk(batch, a)
        # clause-level scratch: the columns broadcast back to the edges and
        # the clause columns of the per-instance sums
        self.clause_scratch = [torch.empty((n, F), dtype=F32,
                                           device=self.device)
                               for n in (fn.n_bcast, fn.n_ired) if n]
        if fn.n_bcast:
            a.bc = self.clause_scratch[0].data_ptr()
        if fn.n_ired:
            a.irc = self.clause_scratch[-1].data_ptr()
        self.cout_shape = (fn.n_cout, F) if fn.n_cout else None
        self.vred_shape = (fn.n_vred, batch.num_vars) if fn.n_vred else None
        self.ired_shape = ((fn.n_ired, batch.batch_size) if fn.n_ired
                           else None)
        self.call = _build.library().pdp_chained_edge_pass

    def check(self, ins):
        """The inputs, each of its shape, f32 and on the batch's device
        (raises otherwise), made contiguous."""
        if len(ins) != len(self.shapes):
            raise ValueError(f"{self.name}: {len(ins)} inputs, expected "
                             f"{len(self.shapes)}")
        dev, kept = self.device, []
        for x, shape in zip(ins, self.shapes):
            if x.shape != shape or x.dtype != F32 or x.device != dev:
                self._bad_input(ins)
            kept.append(x if x.is_contiguous() else x.contiguous())
        return kept

    def _bad_input(self, ins):
        for i, (x, shape) in enumerate(zip(ins, self.shapes)):
            if x.shape != shape:
                raise ValueError(f"{self.name}: input {i} has shape "
                                 f"{tuple(x.shape)}, expected {tuple(shape)}")
            if x.dtype != F32:
                raise ValueError(f"{self.name}: input {i} is {x.dtype}, "
                                 "expected float32")
            if x.device != self.device:
                raise ValueError(f"{self.name}: input {i} is on {x.device}, "
                                 f"the batch on {self.device}")


_PLANS = _build.PlanCache()


def _plan(fn, batch, fused=True):
    return _PLANS.get((batch,), fn.name, _Plan, fn, batch, fused)


def _edge_outputs(plan, x0):
    """new_empty f32[E] edge outputs, their pointers in the argument
    block."""
    if not plan.n_eout:
        return ()
    eouts = tuple(x0.new_empty(plan.eout_shape) for _ in range(plan.n_eout))
    plan.eouts[:plan.n_eout] = [t.data_ptr() for t in eouts]
    return eouts


def _sum_real_edges(batch, cols, ids, n):
    """Sum edge columns into n nodes over the real edges only."""
    return segment_sum_cols_plain(cols, ids, n, batch.num_real_edges)


def fused_edge_pass_plain(fn: EdgeFn, batch, ins, scalar=0.0):
    """The plain PyTorch version (gather, elementwise, index_add_)."""
    red_cols, eouts = fn.plain(ins, batch.edge_var, batch.edge_clause,
                               scalar)
    red = None
    if fn.n_red:
        red = _sum_real_edges(batch, red_cols, batch.edge_var, batch.num_vars)
    return red, tuple(eouts)


def fused_edge_pass(fn: EdgeFn, batch, ins, scalar=0.0):
    """One fused gather -> f -> reduce pass; see the module docstring. On
    the card: one launch, through the (functor, batch) plan."""
    plan = _plan(fn, batch)
    ins = plan.check(ins)
    a = plan.args
    if a is None:
        return fused_edge_pass_plain(fn, batch, ins, scalar)
    plan.ins[:len(ins)] = [x.data_ptr() for x in ins]
    x0 = ins[0]
    eouts = _edge_outputs(plan, x0)
    red = None
    if plan.red_shape is not None:
        red = x0.new_empty(plan.red_shape)
        a.red = red.data_ptr()
    a.scalar = scalar
    a.stream = plan.stream()
    rc = plan.call(plan.ref)
    if rc:
        _build.check(rc, f"fused_edge_pass[{fn.name}]")
    fused_edge_pass.launches += 1
    by = fused_edge_pass.launches_by_fn
    by[fn.name] = by.get(fn.name, 0) + 1
    return red, eouts


fused_edge_pass.launches = 0
fused_edge_pass.launches_by_fn = {}


def chained_edge_pass_plain(fn: ChainFn, batch, ins):
    """The plain PyTorch version of a chained pass (in the inputs' dtype:
    float64 inputs give a float64 reference)."""
    F, V, B = batch.num_clauses, batch.num_vars, batch.batch_size
    ev, ec = batch.edge_var, batch.edge_clause
    cred = _sum_real_edges(batch, fn.f1(ins, ev, ec), ec, F)
    cout, bcast, ired_c = fn.f2(tuple(cred), ins)
    vred, eouts = None, ()
    if fn.n_vred or fn.n_eout:
        bc_e = tuple(b[ec] for b in bcast)
        vred_cols, eouts = fn.f3(bc_e, ins, ev, ec)
        if fn.n_vred:
            vred = _sum_real_edges(batch, vred_cols, ev, V)
    ired = None
    if fn.n_ired:
        f = batch.num_real_clauses
        x = torch.stack(ired_c)[:, :f]
        ired = x.new_zeros((fn.n_ired, B)).index_add_(
            1, batch.clause_batch[:f], x)
    return (torch.stack(cout) if fn.n_cout else None, vred, tuple(eouts),
            ired)


def chained_vred_walk_order(fn: ChainFn, batch, ins):
    """The chained pass's variable sums f32[n_vred, V] in the var walk's
    order (`csrc/common.cuh`, emulated by `walk_order_sum`), over the f3
    terms of the plain version: on the card, the kernel's bits wherever
    its terms are the plain version's."""
    ev, ec = batch.edge_var, batch.edge_clause
    cred = _sum_real_edges(batch, fn.f1(ins, ev, ec), ec, batch.num_clauses)
    _, bcast, _ = fn.f2(tuple(cred), ins)
    terms, _ = fn.f3(tuple(b[ec] for b in bcast), ins, ev, ec)
    lo, hi = csr_bounds(batch.var_ptr)
    group = _build.group_width(batch.num_real_edges, batch.num_vars)
    return walk_order_sum(torch.stack(terms), lo, hi, batch.var_perm.long(),
                          group)


def chained_edge_pass(fn: ChainFn, batch, ins):
    """Both graph directions of a clause -> variable chain; see the module
    docstring. On the card, through the (functor, batch) plan: a
    clause-major launch (f1, clause sum, f2), with n_vred a launch of the
    var walk (f3, variable sum) and, with n_ired, a per-instance sum
    launch."""
    plan = _plan(fn, batch, fused=False)
    ins = plan.check(ins)
    a = plan.args
    if a is None:
        return chained_edge_pass_plain(fn, batch, ins)
    plan.ins[:len(ins)] = [x.data_ptr() for x in ins]
    x0 = ins[0]
    eouts = _edge_outputs(plan, x0)
    cout = vred = ired = None
    if plan.cout_shape is not None:
        cout = x0.new_empty(plan.cout_shape)
        a.cout = cout.data_ptr()
    if plan.vred_shape is not None:
        vred = x0.new_empty(plan.vred_shape)
        a.vred = vred.data_ptr()
    if plan.ired_shape is not None:
        ired = x0.new_empty(plan.ired_shape)
        a.ired = ired.data_ptr()
    a.stream = plan.stream()
    rc = plan.call(plan.ref)
    if rc:
        _build.check(rc, f"chained_edge_pass[{fn.name}]")
    chained_edge_pass.launches += 1
    by = chained_edge_pass.launches_by_fn
    by[fn.name] = by.get(fn.name, 0) + 1
    return cout, vred, eouts, ired


chained_edge_pass.launches = 0
chained_edge_pass.launches_by_fn = {}
