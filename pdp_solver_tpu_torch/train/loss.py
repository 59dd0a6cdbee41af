"""The unsupervised energy loss and hard CNF verification.

Counterpart of `literal_values` (:20), `energy_loss` (:27-60) and
`cnf_evaluate` (:82) in `pdp_solver_tpu/train/loss.py`. The loss is
differentiable: its two clause sums run in one call of
`common.scatter_to_clauses_cols` (the reshape on a uniform width, else
kernel 4 over the clause CSR through its autograd Function, as the JAX
loss reaches kernel 4 and its VJP), and its clamps split the gradient at
a tie as JAX's jnp.maximum / jnp.minimum do (`ops/segment.py`).
cnf_evaluate's chained pass has no backward rule: call it on a
prediction that needs no grad.
"""

import torch

from pdp_solver_tpu_torch.modules.common import scatter_to_clauses_cols
from pdp_solver_tpu_torch.ops import fused
from pdp_solver_tpu_torch.ops.segment import clamp_max, clamp_min

LOSS_EPS = 1e-8          # reference trainer.py:42
MAX_COEFF = 10.0         # reference trainer.py:46
# the clause value is clamped here before the sharpness power: a fully
# violated clause reaches den / eps ~ 1e9, whose 5th power overflows f32
# (JAX loss.py :46-51)
MAX_CLAUSE_VALUE = 1e7


def literal_values(batch, variable_prediction):
    """Per-edge satisfaction probability of each literal: p for positive
    literals, 1 - p for negated ones."""
    p_e = variable_prediction[batch.edge_var, 0]
    return batch.edge_sign * p_e + (1.0 - batch.edge_sign) / 2.0


def energy_loss(batch, variable_prediction, global_step, exploration_alpha,
                loss_sharpness, eps=LOSS_EPS, max_coeff=MAX_COEFF):
    """The annealed smooth-max energy (reference util.py:178-197), a
    scalar: coeff = min(global_step^alpha, max_coeff) (0^alpha = 0)
    sharpens each clause's soft-max of its literal values; the clause
    deficit is raised to loss_sharpness; the mean is over the real
    clauses. global_step is an f32 scalar tensor (or a float)."""
    step = torch.as_tensor(global_step, dtype=torch.float32,
                           device=variable_prediction.device)
    coeff = clamp_max(torch.pow(step, exploration_alpha), max_coeff)
    ev = literal_values(batch, variable_prediction) * batch.edge_mask
    weights = torch.exp(coeff * ev) * batch.edge_mask
    nom, den = scatter_to_clauses_cols(batch, (weights * ev, weights))
    clause_value = den / clamp_min(nom, eps)
    clause_value = clamp_max(clause_value, MAX_CLAUSE_VALUE)
    clause_value = 1.0 + torch.pow(clause_value - 1.0, loss_sharpness)
    log_v = torch.log(clamp_min(clause_value, eps)) * batch.clause_mask
    return torch.sum(log_v) / clamp_min(torch.sum(batch.clause_mask), 1.0)


def cnf_evaluate(batch, variable_prediction):
    """Threshold the prediction and count satisfied clauses per instance,
    all in one chained pass. Returns (solved f32[B], unsat_count f32[B]);
    padding instances report solved=1 / unsat=0."""
    _, _, _, counts = fused.chained_edge_pass(
        fused.CNF_CHAIN, batch,
        (variable_prediction[:, 0].contiguous(), batch.edge_sign,
         batch.edge_mask, batch.clause_mask))
    max_sat, got_sat = counts[0], counts[1]
    solved = (max_sat == got_sat).to(torch.float32)
    return solved, max_sat - got_sat
