"""Segment-reduce algebra on the packed edge list.

Counterpart of `pdp_solver_tpu/ops/segment.py`, with the same clamps.
All inputs are [N] or [N, d] tensors with int64 segment ids; padding rows
must be pre-masked by the caller (0 for sums, excluded via `valid` for
maxes).

The clamps are `torch.maximum` / `torch.minimum` against a bound held as
a 0-dim tensor (`bound`), not `torch.clamp`: at a tie (x equal to the
bound) the JAX package's jnp.maximum / jnp.minimum, and torch.maximum
between two tensors, send half the gradient to each side, while
torch.clamp sends all of it to x. The values are the same either way.
"""

import torch

# reference clamps: safe_exp logit clamp 30.0; safe_log eps FLT_MIN in the
# propagator (the JAX package raised it from 1e-40, a float32 subnormal)
# and 1e-10 in the scorer
MAX_LOGIT = 30.0
LOG_EPS_PROP = 1.1754944e-38
LOG_EPS_SCORE = 1e-10


_BOUNDS = {}


def bound(value, dtype=torch.float32):
    """`value` as a 0-dim CPU tensor of `dtype`, made once: the other side
    of a tie-splitting clamp (a CPU scalar tensor meets a tensor on any
    device)."""
    t = _BOUNDS.get((value, dtype))
    if t is None:
        t = _BOUNDS[value, dtype] = torch.tensor(value, dtype=dtype)
    return t


def clamp_min(x, lo):
    """max(x, lo), half the gradient to x at a tie (jnp.maximum's rule)."""
    return torch.maximum(x, bound(lo, x.dtype))


def clamp_max(x, hi):
    """min(x, hi), half the gradient to x at a tie (jnp.minimum's rule)."""
    return torch.minimum(x, bound(hi, x.dtype))


def safe_log(x, eps=LOG_EPS_PROP):
    return torch.log(clamp_min(x, eps))


def safe_exp(x, max_logit=MAX_LOGIT):
    return torch.exp(clamp_max(x, max_logit))


def segment_sum(x, segment_ids, num_segments):
    """Sum rows of x into `num_segments` buckets. x: [N] or [N, d]."""
    out = x.new_zeros((num_segments,) + tuple(x.shape[1:]))
    return out.index_add_(0, segment_ids, x)


def segment_max(x, segment_ids, num_segments):
    """Max-reduce rows of x per segment. Empty segments get -inf."""
    out = x.new_full((num_segments,) + tuple(x.shape[1:]), float("-inf"))
    idx = segment_ids
    if x.dim() > 1:
        idx = segment_ids.view(-1, *([1] * (x.dim() - 1))).expand_as(x)
    return out.scatter_reduce_(0, idx, x, reduce="amax", include_self=True)


def segment_min_index(idx_vals, segment_ids, num_segments, fill):
    """Min-reduce integer values per segment; empty segments get `fill`."""
    out = idx_vals.new_full((num_segments,), fill)
    return out.scatter_reduce_(0, segment_ids, idx_vals, reduce="amin",
                               include_self=True)


def segment_argmax_first(x, segment_ids, num_segments, valid=None):
    """Per-segment argmax with first-index tie-breaking (the global row
    index of the first maximal element). Rows with valid == 0 are excluded;
    segments with no valid rows return index 0."""
    n = x.shape[0]
    if valid is not None:
        x = torch.where(valid > 0, x, torch.full_like(x, float("-inf")))
    seg_max = segment_max(x, segment_ids, num_segments)
    is_max = x == seg_max[segment_ids]
    if valid is not None:
        is_max = is_max & (valid > 0)
    row_idx = torch.arange(n, device=x.device, dtype=torch.int64)
    candidate = torch.where(is_max, row_idx, torch.full_like(row_idx, n))
    first = segment_min_index(candidate, segment_ids, num_segments, n)
    return torch.where(first >= n, torch.zeros_like(first), first)


def segment_smooth_max(x, segment_ids, num_segments, alpha=30.0, valid=None):
    """Smooth-max per segment: sum(x e^{a x}) / max(sum(e^{a x}), 1)."""
    coeff = safe_exp(alpha * x)
    if valid is not None:
        coeff = coeff * valid
    num = segment_sum(x * coeff, segment_ids, num_segments)
    den = segment_sum(coeff, segment_ids, num_segments)
    return num / torch.clamp(den, min=1.0)


def segment_max_shifted(x, segment_ids, num_segments, valid=None):
    """Per-segment max over valid rows; segments with no valid rows get 0."""
    if valid is not None:
        x = torch.where(valid > 0, x, torch.full_like(x, float("-inf")))
    m = segment_max(x, segment_ids, num_segments)
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))
