"""Predictors and scorers: the neural predictor (with a sigmoid head; with
a tanh head and one output it is np-d-np's scorer), the survey scorer, the
identity predictor and the REINFORCE predictor.

Counterpart of `pdp_solver_tpu/modules/predict.py` (the neural predictor
:51, the identity predictor :73, the survey scorer :107, the REINFORCE
predictor :178).
"""

import dataclasses

import torch
from torch import nn

from pdp_solver_tpu_torch.modules import mlp
from pdp_solver_tpu_torch.modules.common import (
    col, scatter_to_vars_cols, with_meta)
from pdp_solver_tpu_torch.modules.propagate import SPMessages
from pdp_solver_tpu_torch.ops import fused
from pdp_solver_tpu_torch.ops.segment import (
    LOG_EPS_SCORE, safe_exp, safe_log)


@dataclasses.dataclass(frozen=True)
class NeuralPredictorConfig:
    decimator_dim: int
    prediction_dim: int
    edge_dim: int
    meta_dim: int
    mem_hidden_dim: int
    agg_hidden_dim: int
    mem_agg_hidden_dim: int
    classifier_dim: int
    classifier_kind: str = "sigmoid"  # "sigmoid" (Perceptron) | "tanh"
    compute_dtype: str = "float32"    # "bfloat16": the aggregator in bf16

    def aggregator_cfg(self):
        return mlp.AggregatorConfig(
            input_dim=self.decimator_dim + self.edge_dim + self.meta_dim,
            output_dim=self.decimator_dim,
            mem_hidden_dim=self.mem_hidden_dim,
            mem_agg_hidden_dim=self.mem_agg_hidden_dim,
            agg_hidden_dim=self.agg_hidden_dim,
            feature_dim=0,
            include_self=True)


class NeuralPredictor(nn.Module):
    """Aggregate the decimator's variable states per variable (self
    included), then a per-variable classifier (reference
    pdp_predict.py:49-91; only the variable path exists, as in the JAX
    package). forward -> (prediction [V, prediction_dim], None). With
    compute_dtype "bfloat16" (forward's, the solver's, else
    cfg.compute_dtype) the aggregator takes it and the classifier runs in
    f32 on its f32 result, as in JAX (predict.py:62-70). Per-instance meta
    features (`meta_e` [E, meta_dim]) follow the state and the sign at the
    aggregator's input (:53-61)."""

    def __init__(self, cfg: NeuralPredictorConfig):
        super().__init__()
        self.cfg = cfg
        self.var_agg = mlp.Aggregator(cfg.aggregator_cfg())
        head = (mlp.PerceptronTanh if cfg.classifier_kind == "tanh"
                else mlp.Perceptron)
        self.classifier = head(cfg.decimator_dim, cfg.classifier_dim,
                               cfg.prediction_dim)

    def forward(self, batch, dec_state, edge_mask, compute_dtype=None,
                meta_e=None):
        agg_in = with_meta(torch.cat([dec_state[0], col(batch.edge_sign)],
                                     dim=1), meta_e)
        agg_v = self.var_agg(batch, agg_in, None, "var", edge_mask,
                             mlp.cast_for(self.cfg, compute_dtype))
        return self.classifier(agg_v), None


def identity_predictor_apply(generator, problem, random_fill, last_call):
    """Reads the decimated solution; on the last call optionally fills the
    still-active variables with uniform noise (predict.py :73), drawn from
    the CPU generator and copied to the solution's device, as the
    solver's other classical draws are."""
    pred = problem.solution[:, None]
    if random_fill and last_call:
        noise = torch.rand(pred.shape, generator=generator).to(pred.device)
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


def reinforce_predictor_apply(batch, dec_state):
    """1 where the sum of a variable's external forces is positive, else 0
    (predict.py :178, reference pdp_predict.py:214-226): [V, 1]."""
    force = dec_state.fn[1]
    pred = (scatter_to_vars_cols(batch, (force,))[0] > 0).to(torch.float32)
    return pred[:, None], None


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
