"""The factor-graph compiler: CNF instances -> packed, padded edge-list tensors.

Counterpart of `pdp_solver_tpu/fg/batch.py`. The padded layout is the same
(same bucket shapes, same ids, signs and masks), so a batch packed here and
one packed by the JAX package hold identical arrays.

Encoding:
  edge_var[e]     variable index of edge e (instance-offset)
  edge_clause[e]  clause   index of edge e (instance-offset)
  edge_sign[e]    +1 positive literal, -1 negated, 0 on padding
  var_batch[v]    instance id of variable v
  clause_batch[f] instance id of clause f

Real edges form a prefix [0, num_real_edges) sorted by (instance, clause),
real clauses a prefix [0, num_real_clauses); padding rows point at the
last real slot with a 0 mask. Padding edges take part in no reduce, and
padding clauses in no per-instance sum, in the plain versions as in the
kernels, whatever the caller's masks.

Added for the CUDA kernels (built once at pack time, int32):
  var_ptr/var_perm    var-major CSR over the REAL edges: the edges of
                      variable v are var_perm[var_ptr[v]:var_ptr[v+1]], in
                      increasing edge order. The var-direction reduce walks
                      it, so every var sum has one fixed order (no atomics).
  clause_ptr          the real edges of clause f are
                      [clause_ptr[f], clause_ptr[f+1]) (clause-major).
  inst_var_ptr /      the real variables / clauses of instance b.
  inst_clause_ptr
  var_max_degree /    the largest number of real edges of one variable /
  clause_max_degree   clause: the segment sums' group walk skips its
                      blocks for very high degree when no node needs them.

clause_width, fast_var, fast_clause and var_window are the JAX package's
pack-time metadata, kept so the port takes the same paths (the WalkSAT
block rule reads them); the CUDA kernels themselves need none of them.
"""

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

# must match the JAX package's reduce tiling (used only for the metadata)
REDUCE_TILE = 1024
REDUCE_WINDOW = 2048
REDUCE_ALIGN = 1024
_ODD_K = (3, 5, 6, 7)

@dataclasses.dataclass(frozen=True)
class FGBatch:
    """A packed batch of CNF factor graphs (tensors on one device)."""

    edge_var: torch.Tensor       # i64[E]
    edge_clause: torch.Tensor    # i64[E]
    edge_sign: torch.Tensor      # f32[E]
    var_batch: torch.Tensor      # i64[V]
    clause_batch: torch.Tensor   # i64[F]
    edge_mask: torch.Tensor      # f32[E]
    var_mask: torch.Tensor       # f32[V]
    clause_mask: torch.Tensor    # f32[F]
    instance_mask: torch.Tensor  # f32[B]
    label: torch.Tensor          # f32[B]
    edge_var32: torch.Tensor     # i32[E]
    edge_clause32: torch.Tensor  # i32[E]
    var_ptr: torch.Tensor        # i32[V+1]
    var_perm: torch.Tensor       # i32[num_real_edges]
    clause_ptr: torch.Tensor     # i32[F+1]
    inst_var_ptr: torch.Tensor   # i32[B+1]
    inst_clause_ptr: torch.Tensor  # i32[B+1]
    num_real_edges: int
    num_real_clauses: int
    max_instance_vars: int
    var_max_degree: int = None
    clause_max_degree: int = None
    clause_width: int = 0
    fast_var: bool = False
    fast_clause: bool = False
    var_window: int = 0

    @property
    def num_edges(self):
        return self.edge_var.shape[0]

    @property
    def num_vars(self):
        return self.var_batch.shape[0]

    @property
    def num_clauses(self):
        return self.clause_batch.shape[0]

    @property
    def batch_size(self):
        return self.label.shape[0]

    @property
    def device(self):
        return self.edge_var.device


def bucket_dims(v: int, f: int, e: int, b: int,
                granularity: float = 2.0,
                min_dim: int = 128) -> Tuple[int, int, int, int]:
    """Round dims up to a geometric grid (the JAX package's bucket shapes;
    here they bound the number of distinct shapes compaction visits)."""

    def up(x):
        x = max(x, min_dim)
        g = min_dim
        while g < x:
            g = int(np.ceil(g * granularity))
        return g

    return up(v), up(f), up(e), up(b)


def _windowed_ok(ids: np.ndarray, pairwise: bool = False) -> bool:
    """The JAX package's fast_var/fast_clause test: every TILE-slab of ids
    (or every adjacent pair of slabs) spans <= WINDOW - ALIGN ids."""
    n = ids.shape[0]
    if n == 0:
        return True
    pad = -(-n // REDUCE_TILE) * REDUCE_TILE
    padded = np.concatenate([ids, np.full(pad - n, ids[-1], ids.dtype)])
    tiles = padded.reshape(-1, REDUCE_TILE)
    mins, maxs = tiles.min(axis=1), tiles.max(axis=1)
    if pairwise and len(mins) > 1:
        mins = np.minimum(mins[:-1], mins[1:])
        maxs = np.maximum(maxs[:-1], maxs[1:])
    return bool(((maxs - mins) <= REDUCE_WINDOW - REDUCE_ALIGN).all())


def _min_var_window(ids: np.ndarray) -> int:
    """The JAX package's var_window metadata: smallest verified one-hot
    window in {512, 1024}, 0 if only the default 2048 applies."""
    n = ids.shape[0]
    if n == 0:
        return 512
    slab = 512
    pad = -(-n // slab) * slab
    padded = np.concatenate([ids, np.full(pad - n, ids[-1], ids.dtype)])
    tiles = padded.reshape(-1, slab)
    mins, maxs = tiles.min(axis=1), tiles.max(axis=1)
    t = len(mins)
    if t >= 3:
        mins = np.minimum(np.minimum(mins[:-2], mins[1:-1]), mins[2:])
        maxs = np.maximum(np.maximum(maxs[:-2], maxs[1:-1]), maxs[2:])
    elif t == 2:
        mins = np.minimum(mins[:1], mins[1:])
        maxs = np.maximum(maxs[:1], maxs[1:])
    span = int((maxs - mins).max())
    for w in (512, 1024):
        if span <= w // 2:
            return w
    return 0


def _ptr(ids: np.ndarray, n: int) -> np.ndarray:
    """CSR offsets [n+1] of sorted ids (int32)."""
    counts = np.bincount(ids, minlength=n)[:n]
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def pack_instances(instances: Sequence[tuple], device="cuda",
                   pad_v: int = None, pad_f: int = None,
                   pad_e: int = None, pad_b: int = None,
                   bucket: bool = True,
                   granularity: float = 2.0) -> FGBatch:
    """Pack per-instance tuples (n, m, graph_map[2,Ei], edge_sign[Ei], label)
    into one padded FGBatch on `device`."""
    n_inst = len(instances)
    tot_v = sum(int(inst[0]) for inst in instances)
    tot_f = sum(int(inst[1]) for inst in instances)
    tot_e = sum(int(inst[2].shape[1]) for inst in instances)

    if pad_v is None:
        if bucket:
            pad_v, pad_f, pad_e, pad_b = bucket_dims(
                tot_v, tot_f, tot_e, n_inst, granularity)
        else:
            pad_v, pad_f, pad_e, pad_b = tot_v, tot_f, tot_e, n_inst

    if tot_v > pad_v or tot_f > pad_f or tot_e > pad_e or n_inst > pad_b:
        raise ValueError(
            f"batch ({tot_v},{tot_f},{tot_e},{n_inst}) exceeds padded shape "
            f"({pad_v},{pad_f},{pad_e},{pad_b})")

    edge_var = np.zeros(pad_e, dtype=np.int32)
    edge_clause = np.zeros(pad_e, dtype=np.int32)
    edge_sign = np.zeros(pad_e, dtype=np.float32)
    var_batch = np.zeros(pad_v, dtype=np.int32)
    clause_batch = np.zeros(pad_f, dtype=np.int32)
    label = np.zeros(pad_b, dtype=np.float32)
    max_vars = 0

    v_off = f_off = e_off = 0
    for b, inst in enumerate(instances):
        n, m, gmap, signs = int(inst[0]), int(inst[1]), inst[2], inst[3]
        ei = gmap.shape[1]
        order = np.argsort(gmap[1], kind="stable")
        edge_var[e_off:e_off + ei] = gmap[0][order] + v_off
        edge_clause[e_off:e_off + ei] = gmap[1][order] + f_off
        edge_sign[e_off:e_off + ei] = np.asarray(
            signs, dtype=np.float32).reshape(-1)[order]
        var_batch[v_off:v_off + n] = b
        clause_batch[f_off:f_off + m] = b
        label[b] = float(inst[4])
        max_vars = max(max_vars, n)
        v_off += n
        f_off += m
        e_off += ei

    last_v = max(v_off - 1, 0)
    last_f = max(f_off - 1, 0)
    last_b = max(n_inst - 1, 0)
    edge_var[e_off:] = last_v
    edge_clause[e_off:] = last_f
    var_batch[v_off:] = last_b
    clause_batch[f_off:] = last_b

    edge_mask = (np.arange(pad_e) < e_off).astype(np.float32)
    var_mask = (np.arange(pad_v) < v_off).astype(np.float32)
    clause_mask = (np.arange(pad_f) < f_off).astype(np.float32)
    instance_mask = (np.arange(pad_b) < n_inst).astype(np.float32)

    clause_width = 0
    if e_off > 0 and f_off > 0 and e_off % f_off == 0:
        k = e_off // f_off
        counts = np.bincount(edge_clause[:e_off], minlength=f_off)
        if (counts[:f_off] == k).all():
            clause_width = k
    fast_var = _windowed_ok(edge_var, pairwise=clause_width in _ODD_K)
    fast_clause = _windowed_ok(edge_clause, pairwise=clause_width in _ODD_K)
    var_window = _min_var_window(edge_var) if fast_var else 0

    real_var = edge_var[:e_off]
    var_perm = np.argsort(real_var, kind="stable").astype(np.int32)
    var_ptr = _ptr(real_var, pad_v)
    clause_ptr = _ptr(edge_clause[:e_off], pad_f)

    def t(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            device=device, dtype=dtype)

    return FGBatch(
        edge_var=t(edge_var, torch.int64),
        edge_clause=t(edge_clause, torch.int64),
        edge_sign=t(edge_sign, torch.float32),
        var_batch=t(var_batch, torch.int64),
        clause_batch=t(clause_batch, torch.int64),
        edge_mask=t(edge_mask, torch.float32),
        var_mask=t(var_mask, torch.float32),
        clause_mask=t(clause_mask, torch.float32),
        instance_mask=t(instance_mask, torch.float32),
        label=t(label, torch.float32),
        edge_var32=t(edge_var, torch.int32),
        edge_clause32=t(edge_clause, torch.int32),
        var_ptr=t(var_ptr, torch.int32),
        var_perm=t(var_perm, torch.int32),
        clause_ptr=t(clause_ptr, torch.int32),
        inst_var_ptr=t(_ptr(var_batch[:v_off], pad_b), torch.int32),
        inst_clause_ptr=t(_ptr(clause_batch[:f_off], pad_b), torch.int32),
        num_real_edges=e_off,
        num_real_clauses=f_off,
        max_instance_vars=max_vars,
        var_max_degree=int(np.diff(var_ptr).max(initial=0)),
        clause_max_degree=int(np.diff(clause_ptr).max(initial=0)),
        clause_width=clause_width,
        fast_var=fast_var,
        fast_clause=fast_clause,
        var_window=var_window)
