"""Problem state: which variables and clauses are still live.

Counterpart of `pdp_solver_tpu/problem/state.py`. The graph constants live
in the FGBatch; the mutable part is this dataclass of tensors:

  active_vars     f32[V]  0 also marks padding
  active_clauses  f32[F]
  solution        f32[V]  0.5 until decided, then 0 or 1
  is_sat          f32[B]  0.5 unknown, 0 UNSAT
"""

import dataclasses

import torch

from pdp_solver_tpu_torch.ops import fused


@dataclasses.dataclass
class ProblemState:
    active_vars: torch.Tensor
    active_clauses: torch.Tensor
    solution: torch.Tensor
    is_sat: torch.Tensor

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def init_problem_state(batch) -> ProblemState:
    """Padding nodes start deactivated, so every masked op ignores them."""
    return ProblemState(
        active_vars=batch.var_mask.clone(),
        active_clauses=batch.clause_mask.clone(),
        solution=0.5 * torch.ones_like(batch.var_mask),
        is_sat=0.5 * torch.ones_like(batch.label))


def compute_edge_mask(batch, state: ProblemState):
    """Per-edge liveness: both endpoints active (state.py :62)."""
    _, (em,) = fused.fused_edge_pass(
        fused.EM, batch,
        (state.active_vars, state.active_clauses, batch.edge_mask))
    return em


def edge_active_instance_mask(batch, active_instances):
    """Per-edge flag of the instance owning the edge's variable (:86)."""
    _, (ae,) = fused.fused_edge_pass(
        fused.AE, batch, (active_instances[batch.var_batch],))
    return ae


def edge_masks_pair(batch, state: ProblemState, active_instances):
    """(edge liveness mask, per-edge instance flag) in one pass (:107)."""
    _, (em, ae) = fused.fused_edge_pass(
        fused.EM_AE, batch,
        (state.active_vars, active_instances[batch.var_batch],
         state.active_clauses, batch.edge_mask))
    return em, ae
