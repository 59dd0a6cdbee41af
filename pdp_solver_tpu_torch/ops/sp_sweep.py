"""The whole Survey Propagation sweep in one launch.

Counterpart of `pdp_solver_tpu/ops/pallas_sp.py` (`sp_full_sweep` :166,
`use_sp_sweep` :159; kernel 9 of PERF.md). The propagator takes it in place
of its two launches (the chained pass `sp_chain`, then `sp_pass_c`) when
`PDP_SP_SWEEP=on` and `use_sp_sweep(batch)`, as the JAX package does
(`modules/propagate.py:566-583`).

sp_full_sweep(batch, *, u_like, eta_in, em, mask, eta_state, sign, force,
              v0, v1, v2, pi=0.0, login=False) -> (new_eta, nv0, nv1, nv2)
    the JAX function's column arguments (its gather ids, clause width and
    variable count come from the batch); every input and output is f32[E].
    With login=True u_like already is log u (p-nd-np's adaptors).

The wrapper runs its plain version (`sp_full_sweep_plain`: the two-step
plain path, `chained_edge_pass_plain[sp_chain]` (`[sp_chain_login]` with
login) then `fused_edge_pass_plain[sp_pass_c]`) when the batch lies on the
CPU and launches the CUDA kernel (`csrc/sp_sweep.cu`, a thread-block
cluster of `_build.cluster_size(batch)` CTAs per instance, login a
compile-time flag) when it lies on the card, or raises. The kernel takes
its variable sums in the order of the chained pass's var walk
(`csrc/common.cuh`, G = `_build.group_width` of the batch's var CSR),
whichever CTA of the cluster takes them, so it gives the bits of its two
launches. A plan per batch holds the kernel's argument block, its cluster
size and its scratch. A batch with a clause of more than MAX_WIDTH
literals raises on either device: the kernel's clause tile holds no wider
ones, and the route (`use_sp_sweep`) takes widths up to 8 only. Launches
are counted in `sp_full_sweep.launches`, and per form ("plain", "login")
in `sp_full_sweep.launches_by_form`.
"""

import ctypes

import torch

from pdp_solver_tpu_torch.ops import _build, fused

# instances with more variables keep their sums in a global scratch
# instead of each CTA's shared memory (two f32 sums a variable: 48 KB)
SMEM_VARS = 6144
# the widest clause the kernel's clause tile holds (PDP_SWEEP_MAX_K,
# csrc/sp_sweep.cu); the route takes widths up to 8 (fused.CHAINED_WIDTHS)
MAX_WIDTH = 8
_COLS = ("u_like", "eta_in", "em", "mask", "eta_state", "sign", "force",
         "v0", "v1", "v2")


def use_sp_sweep(batch) -> bool:
    """The JAX package's eligibility (`pallas_sp.py use_sp_sweep` :159,
    which is its chained passes' rule)."""
    return fused.use_chained_pass(batch)


def sp_full_sweep_plain(batch, cols, pi=0.0, login=False):
    """The plain version: the propagator's two plain steps."""
    u_like, eta_in, em, mask, eta_state, sign, force, v0, v1, v2 = cols
    chain = fused.SP_CHAIN_LOGIN if login else fused.SP_CHAIN
    _, pn, (new_eta,), _ = fused.chained_edge_pass_plain(
        chain, batch, (u_like, eta_in, em, mask, eta_state, sign))
    _, (nv0, nv1, nv2) = fused.fused_edge_pass_plain(
        fused.SP_PASS_C, batch,
        (pn[0], pn[1], eta_in, em, mask, sign, force, v0, v1, v2),
        scalar=float(pi))
    return new_eta, nv0, nv1, nv2


class _Plan:
    """The sweep on one batch: the inputs' shape and, on the card, the
    kernel's argument block with everything that does not change from
    call to call (CSR pointers, counts, the walk's group width, the
    cluster size, the scratch). A plan's scratch serves one launch at a
    time: launches on one stream."""

    def __init__(self, batch):
        if batch.clause_max_degree > MAX_WIDTH:
            raise ValueError(f"sp_full_sweep: clauses of at most {MAX_WIDTH} "
                             f"literals, got {batch.clause_max_degree}")
        self.device = batch.device
        self.shape = torch.Size([batch.num_edges])
        self.args = None
        if self.device.type != "cuda":
            return
        a = _build.SweepArgs()
        V, e = batch.num_vars, batch.num_real_edges
        a.ev = batch.edge_var32.data_ptr()
        a.ec = batch.edge_clause32.data_ptr()
        a.clause_ptr = batch.clause_ptr.data_ptr()
        a.var_ptr = batch.var_ptr.data_ptr()
        a.var_perm = (batch.var_perm.data_ptr() if batch.var_perm.numel()
                      else None)
        a.inst_clause_ptr = batch.inst_clause_ptr.data_ptr()
        a.inst_var_ptr = batch.inst_var_ptr.data_ptr()
        # clusters for the real instances only (a prefix of the rows; the
        # rows after them have no clause or variable)
        a.n_inst, a.n_vars = batch.num_instances, V
        a.max_inst_vars = batch.max_instance_vars
        a.e_real, a.e_total = e, batch.num_edges
        a.inner_pad = int(batch.inner_padding)
        a.group = _build.group_width(e, V)
        md = batch.var_max_degree
        stride = _build.HEAVY_ITERS * a.group
        a.heavy = int(md is None or md >= stride)
        a.cluster = _build.cluster_size(batch,
                                        _build.device_sms(self.device))
        f32 = dict(dtype=torch.float32, device=self.device)
        self.scratch = []
        if batch.max_instance_vars > SMEM_VARS:
            self.scratch.append(torch.empty(2 * V, **f32))
            a.sums = self.scratch[-1].data_ptr()
        if a.heavy:
            self.scratch.append(torch.empty(2 * max(-(-e // stride), 1),
                                            **f32))
            a.pieces = self.scratch[-1].data_ptr()
        self.args = a
        self.ref = ctypes.byref(a)
        self.call = _build.library().pdp_sp_sweep
        self.stream = _build.stream_fn(self.device)

    def check(self, cols):
        """The columns, each f32[E] on the batch's device (raises
        otherwise), made contiguous."""
        dev, shape, kept = self.device, self.shape, []
        for name, x in zip(_COLS, cols):
            if x.shape != shape or x.dtype != torch.float32:
                raise ValueError(f"sp_full_sweep: {name} must be "
                                 f"f32[{shape[0]}], got {x.dtype} "
                                 f"{tuple(x.shape)}")
            if x.device != dev:
                raise ValueError(f"sp_full_sweep: {name} is on {x.device}, "
                                 f"the batch on {dev}")
            kept.append(x if x.is_contiguous() else x.contiguous())
        return kept


_PLANS = _build.PlanCache()


def _plan(batch):
    if batch.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sp_full_sweep: unsupported device {batch.device}")
    return _PLANS.get((batch,), None, _Plan, batch)


def sp_full_sweep(batch, *, u_like, eta_in, em, mask, eta_state, sign,
                  force, v0, v1, v2, pi=0.0, login=False):
    """One complete SP sweep; see the module docstring."""
    plan = _plan(batch)
    cols = plan.check((u_like, eta_in, em, mask, eta_state, sign, force,
                       v0, v1, v2))
    a = plan.args
    if a is None:
        return sp_full_sweep_plain(batch, cols, pi, login)
    _build.refuse_grad("sp_full_sweep", cols)
    a.ins[:len(cols)] = [x.data_ptr() for x in cols]
    # the four outputs are the rows of one allocation
    out = cols[0].new_empty((4, plan.shape[0]))
    p, row = out.data_ptr(), 4 * plan.shape[0]
    a.outs[:4] = [p, p + row, p + 2 * row, p + 3 * row]
    a.pi = pi
    a.login = 1 if login else 0
    a.stream = plan.stream()
    rc = plan.call(plan.ref)
    if rc:
        _build.check(rc, "sp_full_sweep")
    sp_full_sweep.launches += 1
    key = "login" if login else "plain"
    by = sp_full_sweep.launches_by_form
    by[key] = by.get(key, 0) + 1
    return out.unbind()


sp_full_sweep.launches = 0
sp_full_sweep.launches_by_form = {}
