"""Hard CNF verification.

Counterpart of `literal_values` (:20) and `cnf_evaluate` (:82) in
`pdp_solver_tpu/train/loss.py`. The energy loss belongs to training and is
not ported yet.
"""

import torch

from pdp_solver_tpu_torch.ops import fused


def literal_values(batch, variable_prediction):
    """Per-edge satisfaction probability of each literal: p for positive
    literals, 1 - p for negated ones."""
    p_e = variable_prediction[batch.edge_var, 0]
    return batch.edge_sign * p_e + (1.0 - batch.edge_sign) / 2.0


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
