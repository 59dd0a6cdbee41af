"""Graph-op helpers of the neural modules: edge rows to nodes and back.

Counterpart of `pdp_solver_tpu/modules/common.py`. Feature tensors are
2-D [N, d]; masks are 1-D [N] and broadcast with `col()`.

The JAX package picks among several backends (XLA scatter, ELL tables,
the windowed Pallas kernels when their VMEM budget allows). Here there is
one route per direction:
  - variables: the [E, d] sum and the broadcast back run on
    `ops/reduce2d.py` (kernels 6 and 7 of PERF.md on the card), whatever
    the number of variables;
  - clauses: a uniform-width batch (every k-SAT set) sums each clause's k
    contiguous rows by a reshape, as the JAX package does
    (`ops/pallas_reduce.py uniform_clause_sum` :250); any other batch sums
    over the clause-major CSR with the same segment-sum kernel. The
    broadcast back is a row index.
Padding edges take part in no sum.
"""

import torch

from pdp_solver_tpu_torch.ops.reduce2d import gather_2d, segment_sum_2d


def col(mask_1d):
    return mask_1d[:, None]


def scatter_to_vars(batch, x_e):
    """Sum each variable's edge rows: [E, d] -> [V, d]."""
    return segment_sum_2d(x_e, batch.edge_var, batch.num_vars,
                          batch.num_real_edges, batch.var_ptr,
                          batch.var_perm)


def scatter_to_clauses(batch, x_e):
    """Sum each clause's edge rows: [E, d] -> [F, d]."""
    k, F = batch.clause_width, batch.num_clauses
    if k > 0:
        f, d = batch.num_real_clauses, x_e.shape[1]
        out = x_e.new_zeros((F, d))
        out[:f] = x_e[:f * k].reshape(f, k, d).sum(1)
        return out
    return segment_sum_2d(x_e, batch.edge_clause, F, batch.num_real_edges,
                          batch.clause_ptr)


def gather_from_vars(batch, x_v):
    """Broadcast variable rows to the edges: [V, d] -> [E, d]."""
    return gather_2d(x_v, batch.edge_var)


def gather_from_clauses(batch, x_f):
    return x_f[batch.edge_clause]


def aggregate_minus_self_var(batch, x_e):
    """Each edge's variable sum without its own row (reference
    util.py:60-68, include_self_message=False), the subtract fused into
    the gather. Padding edges get their variable's sum minus their row."""
    return gather_2d(scatter_to_vars(batch, x_e), batch.edge_var, minus=x_e)


def instances_to_edges(batch, x_b):
    """Instance rows -> edges through the edge's variable (reference
    pdp_propagate.py:52-54)."""
    return x_b[batch.var_batch[batch.edge_var]]
