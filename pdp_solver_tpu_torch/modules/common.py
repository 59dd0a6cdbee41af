"""Graph-op helpers of the modules: edge rows to nodes and back.

Counterpart of `pdp_solver_tpu/modules/common.py`. Feature tensors are
2-D [N, d] or 1-D [N] (C-column reduces take and return a tuple / [C, N]);
masks are 1-D [N] and broadcast with `col()`.

The JAX package picks among several backends (XLA scatter, ELL tables,
the windowed Pallas kernels when their VMEM budget and the pack-time
window invariant allow, the based kernel plus a residual scatter when it
does not). Here there is one route per direction:
  - variables: every sum walks the var-major CSR. An [E, d] block with
    d >= 8 (the neural hidden states) and its broadcast back run on
    `ops/reduce2d.py` (kernels 6 and 7 of PERF.md); 1-D columns, tuples of
    up to 8 columns and [E, C < 8] blocks run on `ops/reduce.py` (the one
    kernel of rows 4, 5 and 8), on any batch;
  - clauses: a uniform-width batch (every k-SAT set) sums each clause's k
    contiguous rows by a reshape, as the JAX package does
    (`ops/pallas_reduce.py uniform_clause_sum` :250); any other batch sums
    over the clause-major CSR with the same segment-sum kernels. The
    broadcast back is a row index.
Padding edges take part in no sum.

bf16 [E, d] blocks (the neural aggregators' compute_dtype="bfloat16")
give f32 sums, in each direction through kernel 6 (on the clause-major
CSR for clauses), and the aggregate-minus-self an f32 result: the JAX
package multiplies the rows by the f32 `batch.edge_mask` before it sums,
and that product is f32 (type promotion), so its sums, its gathers and
the subtract of the bf16 rows are f32 (`pdp_solver_tpu/modules/common.py`
:148-150, :213-216, :196).
"""

import torch

from pdp_solver_tpu_torch.ops import reduce
from pdp_solver_tpu_torch.ops.reduce2d import gather_2d, segment_sum_2d
from pdp_solver_tpu_torch.ops.segment import safe_exp

# [E, d] blocks at least this wide go to the 2-D kernel (the JAX package's
# _use_windowed_2d threshold)
MIN_2D_WIDTH = 8


def col(mask_1d):
    return mask_1d[:, None]


def scatter_to_vars(batch, x_e):
    """Sum each variable's edge rows: [E] -> [V], [E, d] -> [V, d] (f32
    sums of bf16 rows)."""
    args = (batch.edge_var, batch.num_vars, batch.num_real_edges,
            batch.var_ptr, batch.var_perm)
    if x_e.dtype == torch.bfloat16 or (x_e.dim() == 2
                                       and x_e.shape[1] >= MIN_2D_WIDTH):
        return segment_sum_2d(x_e, *args)
    return reduce.segment_sum(x_e, *args, max_degree=batch.var_max_degree)


def scatter_to_vars_cols(batch, cols):
    """Sum each of C <= 8 edge columns per variable -> [C, V]."""
    return reduce.segment_sum_cols(cols, batch.edge_var, batch.num_vars,
                                   batch.num_real_edges, batch.var_ptr,
                                   batch.var_perm,
                                   max_degree=batch.var_max_degree)


def scatter_to_clauses_cols(batch, cols):
    """Sum each of C <= 8 edge columns per clause -> [C, F]."""
    k, F = batch.clause_width, batch.num_clauses
    if k > 0:
        f = batch.num_real_clauses
        out = cols[0].new_zeros((len(cols), F))
        out[:, :f] = torch.stack([c[:f * k] for c in cols]).reshape(
            len(cols), f, k).sum(2)
        return out
    return reduce.segment_sum_cols(cols, batch.edge_clause, F,
                                   batch.num_real_edges, batch.clause_ptr,
                                   max_degree=batch.clause_max_degree)


def scatter_to_clauses(batch, x_e):
    """Sum each clause's edge rows: [E, d] -> [F, d] (f32 sums of bf16
    rows, over the clause-major CSR)."""
    k, F = batch.clause_width, batch.num_clauses
    if k > 0 and x_e.dtype == torch.float32:
        f, d = batch.num_real_clauses, x_e.shape[1]
        out = x_e.new_zeros((F, d))
        out[:f] = x_e[:f * k].reshape(f, k, d).sum(1)
        return out
    return segment_sum_2d(x_e, batch.edge_clause, F, batch.num_real_edges,
                          batch.clause_ptr)


def gather_from_vars(batch, x_v):
    """Broadcast variable rows to the edges: [V, d] -> [E, d]."""
    return gather_2d(x_v, batch.edge_var32)


def gather_from_clauses(batch, x_f):
    return x_f[batch.edge_clause]


def aggregate_minus_self_var(batch, x_e):
    """Each edge's variable sum without its own row (reference
    util.py:60-68, include_self_message=False), the subtract fused into
    the gather (f32 for bf16 rows). Padding edges get their variable's sum
    minus their row."""
    return gather_2d(scatter_to_vars(batch, x_e), batch.edge_var32,
                     minus=x_e)


def var_smooth_max(batch, x_e, alpha=30.0):
    """Per-variable smooth-max over incident edges (reference
    sparse_smooth_max, util.py:282-286): sum(x e^{a x}) / max(sum(e^{a x}),
    1). x_e must carry any liveness mask already; numerator and
    denominator ride one stacked [E, 2] reduce."""
    coeff = safe_exp(alpha * x_e) * batch.edge_mask
    nd = scatter_to_vars(batch, torch.stack([x_e * coeff, coeff], dim=1))
    return nd[:, 0] / torch.clamp(nd[:, 1], min=1.0)


def instances_to_edges(batch, x_b):
    """Instance rows -> edges through the edge's variable (reference
    pdp_propagate.py:52-54)."""
    return x_b[batch.var_batch[batch.edge_var]]
