"""Propagators: neural message passing and classical Survey Propagation.

Counterpart of `pdp_solver_tpu/modules/propagate.py`. State layouts, as in
the JAX package:
  NeuralPropagator: (var_state [E, h], fn_state [E, h]);
  survey propagator: SPMessages of 1-D edge columns, var = (q_u, q_s, q_dc)
  simplex, fn = (eta survey, external force).

The JAX package also folds the decimator's reduce and the edge masks into
the sweep (`survey_propagate_with_decimator_agg` :474,
`survey_propagate_folded_masks` :396) to save launches on the TPU. The port
leaves the folds out: its sweep, decimator and mask passes compute the same
messages, masks and reductions in separate kernels.
"""

import dataclasses
import os

import torch
from torch import nn
from torch.nn import functional as Fn

from pdp_solver_tpu_torch.modules import mlp
from pdp_solver_tpu_torch.modules.common import col
from pdp_solver_tpu_torch.ops import fused
from pdp_solver_tpu_torch.ops.fused import q_triplet_stable  # noqa: F401
from pdp_solver_tpu_torch.ops.sp_sweep import sp_full_sweep, use_sp_sweep


@dataclasses.dataclass(frozen=True)
class NeuralPropagatorConfig:
    edge_dim: int
    decimator_dim: int
    meta_dim: int
    hidden_dim: int
    mem_hidden_dim: int
    mem_agg_hidden_dim: int
    agg_hidden_dim: int
    dropout: float = 0.0
    compute_dtype: str = "float32"   # "bfloat16": the aggregators in bf16

    def aggregator_cfg(self):
        return mlp.AggregatorConfig(
            input_dim=self.decimator_dim + self.edge_dim + self.meta_dim,
            output_dim=self.hidden_dim,
            mem_hidden_dim=self.mem_hidden_dim,
            mem_agg_hidden_dim=self.mem_agg_hidden_dim,
            agg_hidden_dim=self.agg_hidden_dim,
            feature_dim=self.edge_dim,
            include_self=False)


class NeuralPropagator(nn.Module):
    """Reference pdp_propagate.py:47-95 (JAX propagate.py:65). The names
    cross over as in the reference: `var_agg` sums over each variable's
    edges and produces the new *function* state, `fn_agg` sums over each
    clause's edges and produces the new *variable* state. Edges of
    instances that have stopped (active_edge 0) keep their state. Dropout
    acts only in training, and per-instance meta features only in p-nd-np,
    neither of which is ported. forward's compute_dtype (the solver's)
    overrides cfg.compute_dtype."""

    def __init__(self, cfg: NeuralPropagatorConfig):
        super().__init__()
        self.cfg = cfg
        self.var_agg = mlp.Aggregator(cfg.aggregator_cfg())
        self.fn_agg = mlp.Aggregator(cfg.aggregator_cfg())

    def forward(self, batch, prop_state, dec_state, edge_mask, active_edge,
                compute_dtype=None):
        var_state, fn_state = prop_state
        dec_var, dec_fn = dec_state
        feat = col(batch.edge_sign)
        keep = col(active_edge) > 0
        dtype = mlp.cast_for(self.cfg, compute_dtype)
        fn_new = self.var_agg(batch, torch.cat([dec_var, feat], dim=1), feat,
                              "var", edge_mask, dtype)
        fn_state = torch.where(keep, fn_new, fn_state)
        var_new = self.fn_agg(batch, torch.cat([dec_fn, feat], dim=1), feat,
                              "clause", edge_mask, dtype)
        var_state = torch.where(keep, var_new, var_state)
        return var_state, fn_state


def neural_init_state(generator, num_edges, hidden_dim, randomized,
                      device):
    """A (var, fn) pair of [E, h] states: U(-1, 1) or zeros (reference
    pdp_propagate.py:97-108; the neural decimator's init state is the same
    draw, JAX decimate.py:102)."""
    shape = (num_edges, hidden_dim)
    if not randomized:
        return (torch.zeros(shape, device=device),
                torch.zeros(shape, device=device))
    return tuple(torch.rand(shape, generator=generator, device=device)
                 .mul_(2.0).sub_(1.0) for _ in range(2))


@dataclasses.dataclass
class SPMessages:
    var: tuple   # (q_u, q_s, q_dc) f32[E] each
    fn: tuple    # (eta, force) f32[E] each


@dataclasses.dataclass(frozen=True)
class SurveyPropagatorConfig:
    """Classical SP, or with include_adaptors p-nd-np's SP, which reads its
    inputs off the neural decimator's [E, decimator_dim] states through
    two learned projections (`SurveyAdaptors`)."""
    pi: float = 0.0     # REINFORCE external-force factor; 0 for p-d-p
    include_adaptors: bool = False
    decimator_dim: int = 1


class SurveyAdaptors(nn.Module):
    """The learned projections of the neural decimator's states into SP
    inputs (reference pdp_propagate.py:128-131; JAX propagate.py :129,
    :545-554): `var_proj` [h -> 2] and `fn_proj` [h -> 1], both without
    a bias. forward(dec_state) -> (log u, eta_in, force), f32[E] each:
    log u = log_sigmoid(fn_proj(dec_var)), eta_in =
    sigmoid(var_proj(dec_fn)[:, 0]), force = sign(var_proj(dec_fn)[:, 1]).
    The two small products stay matrix products, as the JAX package leaves
    them to XLA."""

    def __init__(self, cfg: SurveyPropagatorConfig):
        super().__init__()
        self.var_proj = nn.Linear(cfg.decimator_dim, 2, bias=False)
        self.fn_proj = nn.Linear(cfg.decimator_dim, 1, bias=False)

    def forward(self, dec_state):
        dec_var, dec_fn = dec_state
        log_u = Fn.logsigmoid(self.fn_proj(dec_var))[:, 0].contiguous()
        proj = self.var_proj(dec_fn)
        eta_in = torch.sigmoid(proj[:, 0]).contiguous()
        force = torch.sign(proj[:, 1]).contiguous()
        return log_u, eta_in, force


def survey_propagator_apply(cfg: SurveyPropagatorConfig, batch, prop_state,
                            dec_state, edge_mask, active_edge,
                            adaptors=None):
    """One SP sweep in log space (propagate.py :526): a chained pass (clause
    log-u sums, the eta survey, the polarity-split variable sums of
    log(1 - eta)) then pass C (the q-triplet per edge). With
    PDP_SP_SWEEP=on (read at each call, default off, as in the JAX
    package) and a batch `use_sp_sweep` accepts, the whole sweep is one
    launch of `ops/sp_sweep.py` instead.

    dec_state: SPMessages (u = var[0], eta_in and force = fn), or with
    cfg.include_adaptors the neural decimator's (var, fn) [E, h] pair,
    read through `adaptors` (a SurveyAdaptors); u then arrives as log u
    and both routes take their log-input form (`sp_chain_login`,
    `sp_full_sweep(login=True)`)."""
    v0, v1, v2 = prop_state.var
    eta_state = prop_state.fn[0]
    login = cfg.include_adaptors
    if login:
        if adaptors is None:
            raise ValueError("a propagator with adaptors needs their "
                             "parameters")
        u_like, eta_in, force = adaptors(dec_state)
    else:
        u_like = dec_state.var[0]
        eta_in, force = dec_state.fn
    sign = batch.edge_sign
    if (use_sp_sweep(batch)
            and os.environ.get("PDP_SP_SWEEP", "off") == "on"):
        new_eta, nv0, nv1, nv2 = sp_full_sweep(
            batch, u_like=u_like, eta_in=eta_in, em=edge_mask,
            mask=active_edge, eta_state=eta_state, sign=sign, force=force,
            v0=v0, v1=v1, v2=v2, pi=float(cfg.pi), login=login)
        return SPMessages(var=(nv0, nv1, nv2), fn=(new_eta, force))
    _, pn, (new_eta,), _ = fused.chained_edge_pass(
        fused.SP_CHAIN_LOGIN if login else fused.SP_CHAIN, batch,
        (u_like, eta_in, edge_mask, active_edge, eta_state, sign))
    _, (nv0, nv1, nv2) = fused.fused_edge_pass(
        fused.SP_PASS_C, batch,
        (pn[0], pn[1], eta_in, edge_mask, active_edge, sign, force, v0, v1,
         v2), scalar=float(cfg.pi))
    return SPMessages(var=(nv0, nv1, nv2), fn=(new_eta, force))


def survey_propagator_init_state(generator, num_edges, randomized,
                                 device):
    """Reference init (propagate.py :654): a normalised random simplex and
    uniform surveys, or the uniform fixed point."""
    if randomized:
        v = torch.rand((num_edges, 3), generator=generator, device=device)
        v = v / torch.sum(v, dim=1, keepdim=True)
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
