"""CNF verification, the freeze of solved instances and the next edge masks
in one launch.

Counterpart of `pdp_solver_tpu/ops/pallas_verify.py` (`verify_and_masks`
:170, `use_verify_masks` :165; kernel 10 of PERF.md). The hot loop takes
it in place of `cnf_evaluate`, the freeze and `edge_masks_pair` when
`PDP_VERIFY_MASKS=on` and `use_verify_masks(batch)`, as the JAX package
does (`solvers/base.py:463-471`, `:555-566`).

verify_and_masks(batch, problem, active_b, var_pred)
        -> (solved f32[B], unsat f32[B], em f32[E], ae f32[E])
    solved/unsat: `cnf_evaluate(batch, var_pred)`; em/ae:
    `edge_masks_pair(batch, problem, active_b * (solved <= 0.5))`, on
    every edge, padding edges included.

The wrapper runs its plain version (`verify_and_masks_plain`) when the
batch lies on the CPU and launches the CUDA kernel (`csrc/verify.cu`, a
thread-block cluster of `_build.cluster_size` CTAs per instance)
when it lies on the card, or raises. A plan per batch holds the kernel's
argument block and its cluster size. Launches are counted in
`verify_and_masks.launches`.
"""

import ctypes

import torch

from pdp_solver_tpu_torch.ops import _build
from pdp_solver_tpu_torch.ops.fused import use_chained_pass

# the JAX kernel's instance window (pallas_fused.py IWIN): its rule keeps
# larger batches on the split path, and the port follows it
IWIN = 2048


def use_verify_masks(batch) -> bool:
    """The JAX package's eligibility: its chained passes' rule and at most
    IWIN instances."""
    return bool(use_chained_pass(batch) and batch.batch_size <= IWIN)


def verify_and_masks_plain(batch, active_vars, active_clauses, active_b,
                           pred):
    """The plain version: per-clause literal sums over the real edges,
    per-instance counts over the real clauses, then the masks by gathers.
    pred: f32[V], the prediction's column."""
    e, f = batch.num_real_edges, batch.num_real_clauses
    ev, ec, sign = batch.edge_var, batch.edge_clause, batch.edge_sign
    lit = sign * pred[ev] + (1.0 - sign) / 2.0
    sat_e = (lit > 0.5).to(torch.float32) * batch.edge_mask
    per_clause = torch.zeros_like(batch.clause_mask).index_add_(
        0, ec[:e], sat_e[:e])
    cm = batch.clause_mask
    cols = torch.stack([cm, (per_clause > 0).to(torch.float32) * cm])
    counts = torch.zeros((2, batch.batch_size), device=batch.device)
    counts.index_add_(1, batch.clause_batch[:f], cols[:, :f])
    solved = (counts[0] == counts[1]).to(torch.float32)
    active = active_b * (solved <= 0.5).to(torch.float32)
    em = active_vars[ev] * active_clauses[ec] * batch.edge_mask
    ae = active[batch.var_batch][ev]
    return solved, counts[0] - counts[1], em, ae


class _Plan:
    """Kernel 10 on one batch: the inputs' sizes and, on the card, the
    kernel's argument block with everything that does not change from
    call to call (the batch's pointers and counts, the cluster size)."""

    def __init__(self, batch):
        self.device = batch.device
        self.sizes = (batch.num_vars, batch.num_clauses, batch.batch_size,
                      batch.num_edges)
        self.args = None
        if self.device.type != "cuda":
            return
        a = _build.VerifyArgs()
        a.sign = batch.edge_sign.data_ptr()
        a.edge_mask = batch.edge_mask.data_ptr()
        a.cm = batch.clause_mask.data_ptr()
        a.ev = batch.edge_var32.data_ptr()
        a.ec = batch.edge_clause32.data_ptr()
        a.clause_ptr = batch.clause_ptr.data_ptr()
        a.inst_clause_ptr = batch.inst_clause_ptr.data_ptr()
        a.var_batch = batch.var_batch.data_ptr()
        # clusters for the real instances only (a prefix of the rows)
        a.n_inst = batch.num_instances
        a.n_rows = batch.batch_size
        a.e_real, a.e_total = batch.num_real_edges, batch.num_edges
        a.cluster = _build.cluster_size(
            batch, _build.device_sms(self.device), 2 * _build.THREADS)
        self.args = a
        self.ref = ctypes.byref(a)
        self.call = _build.library().pdp_verify_and_masks
        self.stream = _build.stream_fn(self.device)


_PLANS = _build.PlanCache()


def _plan(batch):
    if batch.device.type not in ("cpu", "cuda"):
        raise ValueError(f"verify_and_masks: unsupported device "
                         f"{batch.device}")
    return _PLANS.get((batch,), None, _Plan, batch)


def _check(name, x, n, batch):
    if x.shape != (n,) or x.dtype != torch.float32:
        raise ValueError(f"verify_and_masks: {name} must be f32[{n}], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device != batch.device:
        raise ValueError(f"verify_and_masks: {name} is on {x.device}, the "
                         f"batch on {batch.device}")


def verify_and_masks(batch, problem, active_b, var_pred):
    """One launch: (solved, unsat, em, ae); see the module docstring.
    var_pred: f32[V, 1]."""
    plan = _plan(batch)
    V, F, B, E = plan.sizes
    if var_pred.shape != (V, 1):
        raise ValueError(f"verify_and_masks: var_pred must be [{V}, 1], got "
                         f"{tuple(var_pred.shape)}")
    pred = var_pred[:, 0]
    ins = (("var_pred", pred, V), ("active_vars", problem.active_vars, V),
           ("active_clauses", problem.active_clauses, F),
           ("active_b", active_b, B))
    for name, x, n in ins:
        _check(name, x, n, batch)
    a = plan.args
    if a is None:
        return verify_and_masks_plain(batch, problem.active_vars,
                                      problem.active_clauses, active_b, pred)
    pred, av, ac, act = (x if x.is_contiguous() else x.contiguous()
                         for _, x, _ in ins)
    a.pred, a.av = pred.data_ptr(), av.data_ptr()
    a.ac, a.active = ac.data_ptr(), act.data_ptr()
    # (solved, unsat) and (em, ae) are the rows of two allocations
    out_b, out_e = pred.new_empty((2, B)), pred.new_empty((2, E))
    a.solved = out_b.data_ptr()
    a.unsat = a.solved + 4 * B
    a.em = out_e.data_ptr()
    a.ae = a.em + 4 * E
    a.stream = plan.stream()
    rc = plan.call(plan.ref)
    if rc:
        _build.check(rc, "verify_and_masks")
    verify_and_masks.launches += 1
    return (*out_b.unbind(), *out_e.unbind())


verify_and_masks.launches = 0
