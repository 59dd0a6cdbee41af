"""The survey scorer and the identity predictor.

Counterpart of the classical half of `pdp_solver_tpu/modules/predict.py`.
"""

import dataclasses

import torch

from pdp_solver_tpu_torch.modules.propagate import SPMessages
from pdp_solver_tpu_torch.ops import fused
from pdp_solver_tpu_torch.ops.segment import (
    LOG_EPS_SCORE, safe_exp, safe_log)


def identity_predictor_apply(generator, problem, random_fill, last_call):
    """Reads the decimated solution; on the last call optionally fills the
    still-active variables with uniform noise (predict.py :73)."""
    pred = problem.solution[:, None]
    if random_fill and last_call:
        noise = torch.rand(pred.shape, generator=generator,
                           device=pred.device)
        pred = torch.where(problem.active_vars[:, None] > 0, noise, pred)
    return pred, None


@dataclasses.dataclass(frozen=True)
class SurveyScorerConfig:
    """The classical survey scorer (its adaptors are not ported yet)."""
    pi: float = 0.0


def survey_scorer_apply(cfg: SurveyScorerConfig, batch, message_state,
                        problem):
    """SP marginal bias q1 - q0 per variable (predict.py :107): one fused
    pass aggregates (force, positive, negative, don't-care) per variable,
    messages of deactivated clauses excluded."""
    eta, force = message_state.fn
    agg, _ = fused.fused_edge_pass(
        fused.SCORER, batch,
        (problem.active_clauses, eta, force, batch.edge_sign,
         batch.edge_mask))
    return survey_scorer_tail(cfg, agg), None


def survey_scorer_tail(cfg: SurveyScorerConfig, agg):
    """Variable-level conclusion from the 4 aggregation columns [4, V]
    (predict.py :147), with the bias shift and the 1e-10 log clamp."""
    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=agg.device)

    external_force = torch.sign(agg[0])[:, None]
    pos = agg[1][:, None] + safe_log(
        1.0 - cfg.pi * (external_force == 1).to(torch.float32),
        LOG_EPS_SCORE)
    neg = agg[2][:, None] + safe_log(
        1.0 - cfg.pi * (external_force == -1).to(torch.float32),
        LOG_EPS_SCORE)
    pns = pos + neg
    dont_care = agg[3][:, None] + safe_log(f32(1.0 - cfg.pi), LOG_EPS_SCORE)

    bias = (2.0 * pns + dont_care) / 4.0
    pos = pos - bias
    neg = neg - bias
    pns = pns - bias
    dont_care = safe_exp(dont_care - bias)

    q_0 = safe_exp(pos) - safe_exp(pns)
    q_1 = safe_exp(neg) - safe_exp(pns)
    total = safe_log(q_0 + q_1 + dont_care, LOG_EPS_SCORE)
    return (safe_exp(safe_log(q_1, LOG_EPS_SCORE) - total)
            - safe_exp(safe_log(q_0, LOG_EPS_SCORE) - total))


def scorer_message_init_state(generator, num_edges, randomized, device):
    """The message-shaped state the sequential decimator hands to the SP
    propagator (predict.py scorer_message_init_state): the random variable
    state is NOT normalised here, as in the reference."""
    if randomized:
        v = torch.rand((num_edges, 3), generator=generator, device=device)
        f = torch.rand((num_edges,), generator=generator, device=device)
        var = (v[:, 0].contiguous(), v[:, 1].contiguous(),
               v[:, 2].contiguous())
        fn = (f, torch.zeros((num_edges,), device=device))
    else:
        third = torch.full((num_edges,), 1.0 / 3.0, device=device)
        var = (third, third.clone(), third.clone())
        fn = (torch.full((num_edges,), 0.5, device=device),
              torch.zeros((num_edges,), device=device))
    return SPMessages(var=var, fn=fn)
