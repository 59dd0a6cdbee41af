"""Propagators: neural message passing and classical Survey Propagation.

Counterpart of `pdp_solver_tpu/modules/propagate.py`. State layouts, as in
the JAX package:
  NeuralPropagator: (var_state [E, h], fn_state [E, h]);
  survey propagator: SPMessages of 1-D edge columns, var = (q_u, q_s, q_dc)
  simplex, fn = (eta survey, external force).

The classical p-d-p loop folds work into its sweep, as the JAX package's
does wherever its kernels run (`survey_propagate_with_decimator_agg` :474,
`survey_propagate_folded_masks` :396): the decimator fold sums the
sequential decimator's eight columns beside the sweep's polarity sums
(`sp_chain_dec`), the mask fold also makes the edge masks in the sweep
(`sp_chain_mask`), and the verify fold also checks the current solution
against its CNF (`sp_chain_maskv`); pass C then computes q_u alone
(`sp_pass_c_lean`), since q_s and q_dc are dead in that loop.
`sweep_folds` decides, as the JAX package's gates do, with the card in
place of its TPU: on a batch on the card by default, on the CPU only
under PDP_FUSED_PASS=on, and each fold off under its own switch
(PDP_SWEEP_DEC_FOLD, PDP_SWEEP_MASK_FOLD, PDP_SWEEP_VERIFY_FOLD: auto or
off). `survey_propagator_apply` is the unfolded sweep.
"""

import dataclasses
import os

import torch
from torch import nn
from torch.nn import functional as Fn

from pdp_solver_tpu_torch.modules import mlp
from pdp_solver_tpu_torch.modules.common import (
    col, dropout, scatter_to_clauses_cols, scatter_to_vars_cols, with_meta)
from pdp_solver_tpu_torch.ops import fused
from pdp_solver_tpu_torch.ops.fused import q_triplet_stable
from pdp_solver_tpu_torch.ops.segment import LOG_EPS_PROP, safe_exp, safe_log
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
    instances that have stopped (active_edge 0) keep their state. In
    training (the module in .train()) each new state goes through dropout
    at cfg.dropout, at JAX's two sites (propagate.py :84, :91: the
    function state's masks drawn first), with masks from the `generator`
    the caller passes. Per-instance meta features, broadcast to the edges
    (`meta_e` [E, meta_dim]), follow the decimator state and the sign at
    both aggregators' inputs (JAX propagate.py :74-87). forward's
    compute_dtype (the solver's) overrides cfg.compute_dtype."""

    def __init__(self, cfg: NeuralPropagatorConfig):
        super().__init__()
        self.cfg = cfg
        self.var_agg = mlp.Aggregator(cfg.aggregator_cfg())
        self.fn_agg = mlp.Aggregator(cfg.aggregator_cfg())

    def forward(self, batch, prop_state, dec_state, edge_mask, active_edge,
                compute_dtype=None, generator=None, meta_e=None):
        drop = self.training and self.cfg.dropout > 0.0
        if drop and generator is None:
            raise ValueError("NeuralPropagator: dropout in training needs a "
                             "generator")
        var_state, fn_state = prop_state
        dec_var, dec_fn = dec_state
        feat = col(batch.edge_sign)
        keep = col(active_edge) > 0
        dtype = mlp.cast_for(self.cfg, compute_dtype)
        fn_new = self.var_agg(batch, with_meta(torch.cat([dec_var, feat],
                                                         dim=1), meta_e),
                              feat, "var", edge_mask, dtype)
        fn_state = torch.where(keep, fn_new, fn_state)
        fn_state = dropout(generator, fn_state, self.cfg.dropout, drop)
        var_new = self.fn_agg(batch, with_meta(torch.cat([dec_fn, feat],
                                                         dim=1), meta_e),
                              feat, "clause", edge_mask, dtype)
        var_state = torch.where(keep, var_new, var_state)
        var_state = dropout(generator, var_state, self.cfg.dropout, drop)
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
    launch of `ops/sp_sweep.py` instead. Under autograd (grad mode on and
    an input that requires grad: p-nd-np's adaptors in training) the
    sweep takes its differentiable route, `sp_sweep_train`, as the JAX
    package's training_mode takes its XLA fallback.

    dec_state: SPMessages (u = var[0], eta_in and force = fn), or with
    cfg.include_adaptors the neural decimator's (var, fn) [E, h] pair,
    read through `adaptors` (a SurveyAdaptors); u then arrives as log u
    and every route takes its log-input form (`sp_chain_login`,
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
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (u_like, eta_in, force, eta_state, v0,
                                      v1, v2)):
        new_eta, nv0, nv1, nv2 = sp_sweep_train(
            batch, u_like, eta_in, edge_mask, active_edge, eta_state, force,
            (v0, v1, v2), float(cfg.pi), login)
        return SPMessages(var=(nv0, nv1, nv2), fn=(new_eta, force))
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


# --- the sweep folds (propagate.py :274-523) ---------------------------

# the verify fold's limit on instances (pallas_fused.py IWIN :288)
IWIN = 2048
FOLD_SWITCHES = ("PDP_FUSED_PASS", "PDP_SWEEP_DEC_FOLD",
                 "PDP_SWEEP_MASK_FOLD", "PDP_SWEEP_VERIFY_FOLD")


def fold_switches():
    """The fold gates' switches, read from the environment at once:
    {name: value}, "auto" where unset."""
    return {k: os.environ.get(k, "auto") for k in FOLD_SWITCHES}


def kernels_run(batch, switches=None) -> bool:
    """The JAX package's use_fused_pass (pallas_fused.py :98), the card in
    place of its TPU: PDP_FUSED_PASS=off never, on wherever the batch
    meets the window invariants, and by default there on a batch on the
    card."""
    mode = (switches or fold_switches())["PDP_FUSED_PASS"]
    if mode == "off":
        return False
    ok = bool(batch.fast_var and batch.fast_clause)
    return ok if mode == "on" else ok and batch.device.type == "cuda"


def use_sweep_decimator_fold(batch, switches=None) -> bool:
    """propagate.py :464: the chained fast path for classical SP, unless
    PDP_SWEEP_DEC_FOLD=off."""
    sw = switches or fold_switches()
    return (sw["PDP_SWEEP_DEC_FOLD"] != "off" and kernels_run(batch, sw)
            and fused.use_chained_pass(batch))


def use_sweep_mask_fold(batch, switches=None) -> bool:
    """propagate.py :358: the decimator fold, unless
    PDP_SWEEP_MASK_FOLD=off."""
    sw = switches or fold_switches()
    return (sw["PDP_SWEEP_MASK_FOLD"] != "off"
            and use_sweep_decimator_fold(batch, sw))


def use_sweep_verify_fold(batch, switches=None) -> bool:
    """propagate.py :388: the mask fold on at most IWIN instances, unless
    PDP_SWEEP_VERIFY_FOLD=off."""
    sw = switches or fold_switches()
    return (sw["PDP_SWEEP_VERIFY_FOLD"] != "off"
            and use_sweep_mask_fold(batch, sw)
            and batch.batch_size <= IWIN)


def sweep_folds(batch):
    """(fold_dec, fold_masks, fold_verify) for a classical p-d-p loop on
    this batch, each fold implying the one before (solvers/base.py
    :478-494), from one read of the switches."""
    sw = fold_switches()
    return (use_sweep_decimator_fold(batch, sw),
            use_sweep_mask_fold(batch, sw),
            use_sweep_verify_fold(batch, sw))


def _lean_pass_c(cfg, batch, pn, eta_in, em, mask, force, v0):
    _, (nv0,) = fused.fused_edge_pass(
        fused.SP_PASS_C_LEAN, batch,
        (pn[0], pn[1], eta_in, em, mask, batch.edge_sign, force, v0),
        scalar=float(cfg.pi))
    return nv0


def survey_propagate_with_decimator_agg(cfg: SurveyPropagatorConfig, batch,
                                        prop_state, dec_state, edge_mask,
                                        active_edge, active_clauses):
    """One classical SP sweep that also returns the sequential decimator's
    convergence and scorer sums (propagate.py :474; use_sweep_decimator_fold
    must hold): the sweep's chained pass with the decimator's eight columns
    (`sp_chain_dec`), then the lean pass C. Returns (SPMessages, (nd
    [4, V], scorer_agg [4, V])), the sums the decimator's own pass would
    give on these messages with prev_eta = the sweep's eta_state (the
    p-d-p loop's): pass them as its precomputed_agg. q_s and q_dc pass
    through stale, as in the JAX package: that loop never reads them."""
    assert not cfg.include_adaptors
    v0, v1, v2 = prop_state.var
    eta_state = prop_state.fn[0]
    u_like = dec_state.var[0]
    eta_in, force = dec_state.fn
    _, vred, (new_eta,), _ = fused.chained_edge_pass(
        fused.SP_CHAIN_DEC, batch,
        (active_clauses, u_like, eta_in, edge_mask, active_edge, eta_state,
         batch.edge_sign, force, batch.edge_mask))
    nv0 = _lean_pass_c(cfg, batch, vred[0:2], eta_in, edge_mask,
                       active_edge, force, v0)
    return (SPMessages(var=(nv0, v1, v2), fn=(new_eta, force)),
            (vred[2:6], vred[6:10]))


def survey_propagate_folded_masks(cfg: SurveyPropagatorConfig, batch,
                                  prop_state, dec_state, problem,
                                  active_instances, verify=False):
    """One classical SP sweep that makes its own edge masks from the
    problem and the instance flags (propagate.py :396; use_sweep_mask_fold
    must hold), with the decimator's sums of
    survey_propagate_with_decimator_agg. Returns (SPMessages, (nd,
    scorer_agg), em, ae), em and ae equal to
    edge_masks_pair(batch, problem, active_instances); with verify=True
    (use_sweep_verify_fold must hold) also (max_sat, got_sat) per
    instance, cnf_evaluate's counts for problem.solution, from the same
    chained pass."""
    assert not cfg.include_adaptors
    v0, v1, v2 = prop_state.var
    eta_state = prop_state.fn[0]
    u_like = dec_state.var[0]
    eta_in, force = dec_state.fn
    edges = (u_like, eta_in, eta_state, batch.edge_sign, force,
             batch.edge_mask)
    abv = active_instances[batch.var_batch]
    if verify:
        fn, ins = fused.SP_CHAIN_MASKV, (
            problem.active_vars, abv, problem.solution,
            problem.active_clauses, batch.clause_mask) + edges
    else:
        fn, ins = fused.SP_CHAIN_MASK, (
            problem.active_vars, abv, problem.active_clauses) + edges
    _, vred, (new_eta, em, ae), counts = fused.chained_edge_pass(
        fn, batch, ins)
    nv0 = _lean_pass_c(cfg, batch, vred[0:2], eta_in, em, ae, force, v0)
    out = (SPMessages(var=(nv0, v1, v2), fn=(new_eta, force)),
           (vred[2:6], vred[6:10]), em, ae)
    return out + ((counts[0], counts[1]),) if verify else out


def sp_sweep_train(batch, u_like, eta_in, em, mask, eta_state, force, v,
                   pi, login):
    """The sweep's differentiable route: the JAX package's XLA fallback
    (propagate.py :623-651), the same math as the chained pass and pass C.
    Its two segment sums are kernel 4 with its backward rule on the card
    (`common.scatter_to_clauses_cols` / `scatter_to_vars_cols`; a uniform
    clause width sums by a reshape, as in JAX); the gathers back to the
    edges are PyTorch indexing. Returns (new eta, q_u, q_s, q_dc)."""
    sign = batch.edge_sign
    log_u = (u_like if login else safe_log(u_like, LOG_EPS_PROP)) * em
    agg = scatter_to_clauses_cols(batch, (log_u,))[0]
    eta = safe_exp(agg[batch.edge_clause] - log_u)
    new_eta = mask * eta + (1.0 - mask) * eta_state
    lm = safe_log(1.0 - eta_in, LOG_EPS_PROP) * em
    pos_w = (sign == 1).to(torch.float32)
    neg_w = (sign == -1).to(torch.float32)
    pn = scatter_to_vars_cols(batch, (lm * pos_w, lm * neg_w))
    pos = pn[0][batch.edge_var]
    neg = pn[1][batch.edge_var]
    same = 0.5 * (1 + sign) * pos + 0.5 * (1 - sign) * neg - lm
    same = same + safe_log(
        1.0 - pi * (force == sign).to(torch.float32), LOG_EPS_PROP)
    # the opposite polarity's sum never holds the edge itself
    opp = 0.5 * (1 - sign) * pos + 0.5 * (1 + sign) * neg
    opp = opp + safe_log(
        1.0 - pi * (force == -sign).to(torch.float32), LOG_EPS_PROP)
    q_u, q_s, d, total = q_triplet_stable(same, opp)
    return (new_eta,) + tuple(mask * (q / total) + (1.0 - mask) * x
                              for q, x in zip((q_u, q_s, d), v))


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
