"""Classical Survey Propagation.

Counterpart of the SP half of `pdp_solver_tpu/modules/propagate.py`.
Message state (1-D edge columns, as in the JAX package):
  var = (q_u, q_s, q_dc) simplex, fn = (eta survey, external force).

The JAX package also folds the decimator's reduce and the edge masks into
the sweep (`survey_propagate_with_decimator_agg` :474,
`survey_propagate_folded_masks` :396) to save launches on the TPU. The port
leaves the folds out: its sweep, decimator and mask passes compute the same
messages, masks and reductions in separate kernels.
"""

import dataclasses

import torch

from pdp_solver_tpu_torch.ops import fused
from pdp_solver_tpu_torch.ops.fused import q_triplet_stable  # noqa: F401


@dataclasses.dataclass
class SPMessages:
    var: tuple   # (q_u, q_s, q_dc) f32[E] each
    fn: tuple    # (eta, force) f32[E] each


@dataclasses.dataclass(frozen=True)
class SurveyPropagatorConfig:
    """Classical SP (the learned adaptors of p-nd-np are not ported yet)."""
    pi: float = 0.0     # REINFORCE external-force factor; 0 for p-d-p


def survey_propagator_apply(cfg: SurveyPropagatorConfig, batch, prop_state,
                            dec_state, edge_mask, active_edge):
    """One SP sweep in log space (propagate.py :526): a chained pass (clause
    log-u sums, the eta survey, the polarity-split variable sums of
    log(1 - eta)) then pass C (the q-triplet per edge)."""
    v0, v1, v2 = prop_state.var
    eta_state = prop_state.fn[0]
    u_like = dec_state.var[0]
    eta_in, force = dec_state.fn
    sign = batch.edge_sign
    _, pn, (new_eta,), _ = fused.chained_edge_pass(
        fused.SP_CHAIN, batch,
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
