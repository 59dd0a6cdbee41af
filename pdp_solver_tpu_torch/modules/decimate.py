"""The sequential (greedy) decimator.

Counterpart of `sequential_decimator_apply` in
`pdp_solver_tpu/modules/decimate.py` (:185). Per iteration: the
paramagnetic early stop (classical message states only, :270), the
per-instance convergence test with its t_max timeout, then each converged
instance fixes its max-|score| variable (or every variable within the
decimation_threshold band) and the problem is re-simplified.

Everything stays on the device: the JAX `lax.cond` on "anything to
decimate" becomes a select between the simplified and the unchanged
problem, so the loop needs no host sync.
"""

import dataclasses

import torch

from pdp_solver_tpu_torch.modules.predict import survey_scorer_tail
from pdp_solver_tpu_torch.ops import fused
from pdp_solver_tpu_torch.ops.segment import (
    segment_argmax_first, segment_max, segment_max_shifted, segment_sum)
from pdp_solver_tpu_torch.problem.simplify import fused_set_variables
from pdp_solver_tpu_torch.problem.state import ProblemState


@dataclasses.dataclass
class SeqDecimatorState:
    prev_eta: torch.Tensor   # f32[E] previous clause->var survey
    counters: torch.Tensor   # f32[B] iterations since last decimation
    has_prev: torch.Tensor   # f32[]  0 on the first iteration


def seq_decimator_init_state(batch):
    return SeqDecimatorState(
        prev_eta=torch.zeros_like(batch.edge_mask),
        counters=torch.zeros_like(batch.instance_mask),
        has_prev=torch.zeros((), device=batch.device))


@dataclasses.dataclass(frozen=True)
class SeqDecimatorConfig:
    tolerance: float
    t_max: float
    decimation_threshold: float = 1.0
    decimation_guard: float = 0.0
    simplify_rounds: int = 0


def _select(cond, new: ProblemState, old: ProblemState) -> ProblemState:
    return ProblemState(*(torch.where(cond, getattr(new, f), getattr(old, f))
                          for f in ("active_vars", "active_clauses",
                                    "solution", "is_sat")))


def sequential_decimator_apply(cfg: SeqDecimatorConfig, scorer_cfg, batch,
                               seq_state: SeqDecimatorState, message_state,
                               problem: ProblemState, edge_mask,
                               active_instances):
    """Returns (new_seq_state, new_problem, new_active_instances);
    active_instances may be None (no termination tracking)."""
    V, B = batch.num_vars, batch.batch_size
    eta, force = message_state.fn

    # convergence + paramagnetic smooth-max columns and the survey
    # scorer's aggregation, one edge -> variable pass
    nd8, _ = fused.fused_edge_pass(
        fused.SMAX_SCORER, batch,
        (problem.active_clauses, seq_state.prev_eta, eta, edge_mask,
         batch.edge_mask, force, batch.edge_sign))
    nd, scorer_agg = nd8[:4], nd8[4:]
    sm = nd[0::2] / torch.clamp(nd[1::2], min=1.0)             # [2, V]
    sm = sm * problem.active_vars[None, :]
    neg_inf = torch.full_like(sm, float("-inf"))
    mx = segment_max(torch.where(batch.var_mask[None, :] > 0, sm,
                                 neg_inf).T.contiguous(),
                     batch.var_batch, B)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    diff_b = mx[:, 0]

    if active_instances is not None:
        # paramagnetic early stop (classical message states only)
        active_instances = torch.where(
            mx[:, 1] <= 1e-10, torch.zeros_like(active_instances),
            active_instances)

    gate = seq_state.has_prev * (torch.sum(problem.active_vars) > 0).to(
        torch.float32)
    converged = (diff_b < cfg.tolerance).to(torch.float32)
    counters = torch.where(converged > 0, torch.zeros_like(diff_b),
                           seq_state.counters)
    timeout = (counters >= cfg.t_max).to(torch.float32)
    flag_b = torch.maximum(converged, timeout)
    counters = torch.where(timeout > 0, torch.zeros_like(counters), counters)
    counters = counters + 1.0
    counters = gate * counters + (1.0 - gate) * seq_state.counters
    flag_b = flag_b * gate

    score = survey_scorer_tail(scorer_cfg, scorer_agg)[:, 0]      # [V]
    coeff = torch.abs(score) * problem.active_vars * flag_b[batch.var_batch]
    if cfg.decimation_threshold < 1.0:
        max_b = segment_max_shifted(coeff, batch.var_batch, B,
                                    valid=batch.var_mask)
        theta_b = torch.full((B,), cfg.decimation_threshold,
                             device=coeff.device)
        if cfg.decimation_guard > 0:
            active_n = segment_sum(problem.active_vars * batch.var_mask,
                                   batch.var_batch, B)
            theta_b = torch.where(active_n > cfg.decimation_guard, theta_b,
                                  torch.ones_like(theta_b))
        decimate_b = flag_b * (max_b > 0).to(torch.float32)
        if active_instances is not None:
            decimate_b = decimate_b * active_instances
        sel = ((coeff >= theta_b[batch.var_batch] * max_b[batch.var_batch])
               & (coeff > 0) & (decimate_b[batch.var_batch] > 0))
    else:
        max_ind = segment_argmax_first(coeff, batch.var_batch, B,
                                       valid=batch.var_mask)
        norm_b = segment_sum(coeff, batch.var_batch, B)
        decimate_b = flag_b * (norm_b != 0).to(torch.float32)
        if active_instances is not None:
            decimate_b = decimate_b * active_instances
        sel = ((torch.arange(V, device=coeff.device)
                == max_ind[batch.var_batch])
               & (decimate_b[batch.var_batch] > 0))
    assignment = torch.where(sel, torch.sign(score), torch.zeros_like(score))

    decimated = fused_set_variables(batch, problem, assignment,
                                    max_rounds=cfg.simplify_rounds)
    problem = _select(torch.sum(decimate_b) > 0, decimated, problem)

    new_state = SeqDecimatorState(prev_eta=eta, counters=counters,
                                  has_prev=torch.ones_like(
                                      seq_state.has_prev))
    return new_state, problem, active_instances
