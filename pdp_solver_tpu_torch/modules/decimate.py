"""Decimators: the neural (GRU) decimator, the sequential (greedy) one and
the REINFORCE (concurrent) one.

Counterpart of `neural_decimator_apply` (:59),
`sequential_decimator_apply` (:185) and `reinforce_decimator_apply` (:374)
in `pdp_solver_tpu/modules/decimate.py`.

The neural decimator keeps a (var, fn) pair of [E, h] states and updates
each with a GRU cell over the propagator's messages; its init state is
`propagate.neural_init_state`.

The sequential decimator, per iteration: the
paramagnetic early stop (classical message states only, :270), the
per-instance convergence test with its t_max timeout, then each converged
instance fixes its max-|score| variable (or every variable within the
decimation_threshold band) and the problem is re-simplified. It reads SP
messages (p-d-p: the survey scorer's aggregation rides the convergence
pass) or the neural propagator's (var, fn) [E, h] pair (np-d-np: the
survey is fn[:, 0], the convergence columns come from the `smax` pass and
the score from the caller's scorer, the neural predictor with its tanh
head).

Everything stays on the device: the JAX `lax.cond` on "anything to
decimate" becomes a select between the simplified and the unchanged
problem, so the loop needs no host sync.

The REINFORCE decimator never changes the problem. Per iteration: the
per-instance convergence test (the smooth-max over each variable's edges
of |eta - prev eta|, an instance stops once its max is <= 0.01), then,
with probability decimation_probability, every live edge's external force
becomes the sign of its variable's SP bias. The coin is drawn by the
caller on the host and passed in as a bool, so it needs no device sync.
"""

import dataclasses

import torch
from torch import nn

from pdp_solver_tpu_torch.modules import mlp
from pdp_solver_tpu_torch.modules.common import (
    col, var_smooth_max, with_meta)
from pdp_solver_tpu_torch.modules.predict import (
    survey_scorer_apply, survey_scorer_tail)
from pdp_solver_tpu_torch.modules.propagate import SPMessages
from pdp_solver_tpu_torch.ops import fused
from pdp_solver_tpu_torch.ops.segment import (
    segment_argmax_first, segment_max, segment_max_shifted, segment_sum)
from pdp_solver_tpu_torch.problem.simplify import fused_set_variables
from pdp_solver_tpu_torch.problem.state import ProblemState


@dataclasses.dataclass(frozen=True)
class NeuralDecimatorConfig:
    var_message_dim: int
    fn_message_dim: int
    meta_dim: int
    hidden_dim: int
    edge_dim: int
    dropout: float = 0.0
    compute_dtype: str = "float32"   # "bfloat16": the GRU cells in bf16


class NeuralDecimator(nn.Module):
    """Reference pdp_decimate.py:51-87: two GRU cells over persistent edge
    states, frozen on the edges of instances that have stopped. The
    messages are the neural propagator's (var, fn) [E, h] pair (np-nd-np)
    or SPMessages (p-nd-np), whose 1-D columns are stacked into [E, 3] and
    [E, 2] blocks first (JAX decimate.py:67-71). Per-instance meta
    features (`meta_e` [E, meta_dim]) follow the messages and the sign at
    both cells' inputs (:75-91). forward's compute_dtype (the solver's)
    overrides cfg.compute_dtype."""

    def __init__(self, cfg: NeuralDecimatorConfig):
        super().__init__()
        self.cfg = cfg
        self.var_gru = mlp.GRUCell(
            cfg.var_message_dim + cfg.edge_dim + cfg.meta_dim,
            cfg.hidden_dim)
        self.fn_gru = mlp.GRUCell(
            cfg.fn_message_dim + cfg.edge_dim + cfg.meta_dim,
            cfg.hidden_dim)

    def forward(self, batch, dec_state, message_state, active_edge,
                compute_dtype=None, meta_e=None):
        old_var, old_fn = dec_state
        if isinstance(message_state, SPMessages):
            msg_var = torch.stack(message_state.var, dim=1)
            msg_fn = torch.stack(message_state.fn, dim=1)
        else:
            msg_var, msg_fn = message_state
        feat = col(batch.edge_sign)
        keep = col(active_edge) > 0
        dtype = mlp.cast_for(self.cfg, compute_dtype)
        var_new = self.var_gru(
            with_meta(torch.cat([msg_var, feat], dim=1), meta_e), old_var,
            dtype)
        fn_new = self.fn_gru(
            with_meta(torch.cat([msg_fn, feat], dim=1), meta_e), old_fn,
            dtype)
        var_state = torch.where(keep, var_new, old_var)
        fn_state = torch.where(keep, fn_new, old_fn)
        return var_state, fn_state


@dataclasses.dataclass
class SeqDecimatorState:
    prev_eta: torch.Tensor   # f32[E] previous clause->var survey
    counters: torch.Tensor   # f32[B] iterations since last decimation
    has_prev: torch.Tensor   # f32[]  0 on the first iteration


def seq_decimator_init_state(batch, replication=1):
    """Fresh bookkeeping for the batch, or for its R-fold replica
    (`fg.batch.replicate_batch`)."""
    return SeqDecimatorState(
        prev_eta=batch.edge_mask.new_zeros(batch.num_edges * replication),
        counters=batch.instance_mask.new_zeros(
            batch.batch_size * replication),
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
                               active_instances, scorer_fn=None,
                               precomputed_agg=None):
    """Returns (new_seq_state, new_problem, new_active_instances);
    active_instances may be None (no termination tracking).

    message_state: SPMessages, scored by the survey scorer of scorer_cfg;
    or the neural propagator's (var, fn) pair, scored by
    scorer_fn(message_state, problem) -> [V, 1] (JAX's scorer_fn,
    `pdp_solver_tpu/solvers/base.py` _scorer_fn). precomputed_agg: (nd
    [4, V], scorer_agg [4, V]) that a folded sweep already summed
    (`propagate.survey_propagate_with_decimator_agg`), in place of this
    decimator's own pass (decimate.py :221-224)."""
    V, B = batch.num_vars, batch.batch_size
    classical = isinstance(message_state, SPMessages)
    if precomputed_agg is not None:
        eta = message_state.fn[0]
        nd, scorer_agg = precomputed_agg
    elif classical:
        eta, force = message_state.fn
        # convergence + paramagnetic smooth-max columns and the survey
        # scorer's aggregation, one edge -> variable pass
        nd8, _ = fused.fused_edge_pass(
            fused.SMAX_SCORER, batch,
            (problem.active_clauses, seq_state.prev_eta, eta, edge_mask,
             batch.edge_mask, force, batch.edge_sign))
        nd, scorer_agg = nd8[:4], nd8[4:]
    else:
        # the survey is the fn state's column 0, a strided view: made
        # contiguous once, it is also the next prev_eta
        eta = message_state[1][:, 0].contiguous()
        nd, _ = fused.fused_edge_pass(
            fused.SMAX, batch,
            (seq_state.prev_eta, eta, edge_mask, batch.edge_mask))
    sm = nd[0::2] / torch.clamp(nd[1::2], min=1.0)             # [C, V]
    sm = sm * problem.active_vars[None, :]
    neg_inf = torch.full_like(sm, float("-inf"))
    mx = segment_max(torch.where(batch.var_mask[None, :] > 0, sm,
                                 neg_inf).T.contiguous(),
                     batch.var_batch, B)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    diff_b = mx[:, 0]

    if active_instances is not None and classical:
        # paramagnetic early stop (classical message states only: the
        # JAX package skips it for the neural propagator's hidden column,
        # which sits at or below 0 routinely)
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

    if classical:
        score = survey_scorer_tail(scorer_cfg, scorer_agg)[:, 0]  # [V]
    else:
        score = scorer_fn(message_state, problem)[:, 0]
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


# --------------------------------------------------------------------------
# REINFORCE (concurrent) decimator
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ReinforceDecimatorState:
    prev_eta: torch.Tensor   # f32[E] previous clause->var survey
    has_prev: torch.Tensor   # f32[]  0 on the first iteration


def reinforce_decimator_init_state(batch, replication=1):
    return ReinforceDecimatorState(
        prev_eta=batch.edge_mask.new_zeros(batch.num_edges * replication),
        has_prev=torch.zeros((), device=batch.device))


@dataclasses.dataclass(frozen=True)
class ReinforceDecimatorConfig:
    decimation_probability: float = 0.5


def reinforce_decimator_apply(cfg: ReinforceDecimatorConfig, scorer_cfg,
                              batch, rf_state: ReinforceDecimatorState,
                              message_state, problem: ProblemState,
                              edge_mask, active_instances, active_edge,
                              coin: bool):
    """decimate.py :374 (reference pdp_decimate.py:202-234). `coin` is the
    caller's draw of uniform < decimation_probability. Returns
    (new_state, messages with the new external force, new active
    instances); active_instances may be None (no termination tracking)."""
    B = batch.batch_size
    eta, old_force = message_state.fn

    if active_instances is not None:
        gate = rf_state.has_prev * (torch.sum(problem.active_vars) > 0).to(
            torch.float32)
        diff = torch.abs(rf_state.prev_eta - eta) * edge_mask
        diff_v = var_smooth_max(batch, diff) * problem.active_vars
        diff_b = segment_max_shifted(diff_v, batch.var_batch, B,
                                     valid=batch.var_mask)
        deactivate = (diff_b <= 0.01) & (gate > 0)
        active_instances = torch.where(
            deactivate, torch.zeros_like(active_instances), active_instances)

    force = old_force
    if coin:
        score = survey_scorer_apply(scorer_cfg, batch, message_state,
                                    problem)[0]
        score_e = torch.sign(score[:, 0])[batch.edge_var]
        force = active_edge * score_e + (1.0 - active_edge) * old_force

    new_state = ReinforceDecimatorState(
        prev_eta=eta, has_prev=torch.ones_like(rf_state.has_prev))
    return (new_state, SPMessages(var=message_state.var, fn=(eta, force)),
            active_instances)
