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
  max_instance_vars / the most real variables / clauses of one instance
  max_instance_clauses (the WalkSAT kernel sizes its shared memory and its
                      CTA by them).
  var_max_degree /    the largest number of real edges of one variable /
  clause_max_degree   clause: the segment sums' group walk skips its
                      blocks for very high degree when no node needs them.
  num_instances       the rows [0, n) of the B that the per-instance
                      kernels launch (3, 9, 10, the chained pass's
                      instance sums): the real instances of a packed
                      batch; the one-cluster-an-instance kernels size
                      their clusters by it (ops/_build.py cluster_size).
  real                `RealRows`: each row's real variables and clauses
                      and the var-major CSR of the edges with edge_mask 1.
                      In a packed batch these are the ranges and the CSR
                      above; in a replicated one they leave out the
                      padding inside the prefix (the WalkSAT kernel walks
                      them).

A replicated batch (`replicate_batch`, R copies in the JAX package's
layout: replica r of instance b is instance r*B + b, variable v + r*V,
clause f + r*F, edge e + r*E) keeps the padding of every replica but the
last between the replicas. Its "real" prefix (num_real_edges,
num_real_clauses, num_instances and the CSR) is every row of replicas 0
to R-2, padding included, then the last replica's real rows; the padding
inside it is inert, masked as the JAX package masks all its padding: a
padding variable or clause belongs to its replica's last real instance
(as var_batch and clause_batch say), a padding edge to that replica's
last real variable (as edge_var says) and, in clause_ptr, to the
replica's padding clauses, k apiece where the width stays uniform (the
positional clause view of the uniform-width paths), else dealt evenly
(or to its last real clause, where there is no padding clause). Every
term a padding edge adds to a sum is a masked zero, and the WalkSAT
kernel leaves padding variables out of its selection, as the plain
version does. The last replica's padding is the suffix, as in a packed
batch. A padding edge inside the prefix lies in a padding clause's
clause_ptr range while edge_clause names its replica's last real clause:
the clause-major kernels give its edge outputs that clause's columns, as
the plain versions do (`FGBatch.inner_padding`).

clause_width, fast_var, fast_clause and var_window are the JAX package's
pack-time metadata, kept so the port takes the same paths (the WalkSAT
block rule reads them); the CUDA kernels themselves need none of them.

graph_feat f32[B, meta_dim] holds per-instance meta features: an
instance tuple's 7th element (the JSON row's 6th, `fg/jsonfmt.py`), zero
on padding instances, and zero-width when any instance has none (JAX
fg/batch.py :337-346). `replicate_batch` tiles it and `unpack_instances`
gives it back.
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
class RealRows:
    """The real part of a batch's rows: row b's real variables are
    [inst_var_ptr[b], var_end[b]) and its real clauses [inst_clause_ptr[b],
    clause_end[b]); the edges with edge_mask 1 of variable v are
    var_perm[var_ptr[v]:var_ptr[v+1]], in increasing edge order."""

    var_end: torch.Tensor        # i32[B]
    clause_end: torch.Tensor     # i32[B]
    var_ptr: torch.Tensor        # i32[V+1]
    var_perm: torch.Tensor       # i32[num_edges]
    num_vars: int
    num_clauses: int
    num_edges: int
    max_vars: int                # the most of one row
    max_clauses: int


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
    max_instance_clauses: int
    num_instances: int           # rows [0, n) of B the kernels launch
    real: RealRows
    graph_feat: torch.Tensor     # f32[B, meta_dim]
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

    @property
    def inner_padding(self):
        """Whether padding edges lie inside [0, num_real_edges) (a
        replicated batch with padding)."""
        return self.real.num_edges < self.num_real_edges


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
    max_vars = max_clauses = 0

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
        max_clauses = max(max_clauses, m)
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

    metas = [np.asarray(inst[6], np.float32).reshape(-1)
             for inst in instances if len(inst) > 6 and inst[6] is not None]
    graph_feat = np.zeros((pad_b, metas[0].shape[0] if metas
                           and len(metas) == n_inst else 0), np.float32)
    if graph_feat.shape[1]:
        graph_feat[:n_inst] = np.stack(metas)

    def t(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            device=device, dtype=dtype)

    var_ptr_t, var_perm_t = t(var_ptr, torch.int32), t(var_perm, torch.int32)
    inst_var_ptr = t(_ptr(var_batch[:v_off], pad_b), torch.int32)
    inst_clause_ptr = t(_ptr(clause_batch[:f_off], pad_b), torch.int32)
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
        var_ptr=var_ptr_t,
        var_perm=var_perm_t,
        clause_ptr=t(clause_ptr, torch.int32),
        inst_var_ptr=inst_var_ptr,
        inst_clause_ptr=inst_clause_ptr,
        num_real_edges=e_off,
        num_real_clauses=f_off,
        max_instance_vars=max_vars,
        max_instance_clauses=max_clauses,
        var_max_degree=int(np.diff(var_ptr).max(initial=0)),
        clause_max_degree=int(np.diff(clause_ptr).max(initial=0)),
        clause_width=clause_width,
        fast_var=fast_var,
        fast_clause=fast_clause,
        var_window=var_window,
        graph_feat=t(graph_feat, torch.float32),
        num_instances=n_inst,
        real=RealRows(
            var_end=inst_var_ptr[1:], clause_end=inst_clause_ptr[1:],
            var_ptr=var_ptr_t, var_perm=var_perm_t, num_vars=v_off,
            num_clauses=f_off, num_edges=e_off, max_vars=max_vars,
            max_clauses=max_clauses))


def replicate_batch(batch: FGBatch, replication: int) -> FGBatch:
    """R copies of every instance in one batch (the reference's
    batch_replication; the JAX package's replicate_batch
    `pdp_solver_tpu/fg/batch.py:423`, with the same ids, signs, masks and
    pack-time metadata): replica r of instance b is instance r*B + b,
    variable v + r*V, clause f + r*F, edge e + r*E, so a [R, V] reshape
    gathers a variable's replicas. The CSR is rebuilt for this layout, its
    real prefix ending in the last replica's real rows (see the module
    docstring). R <= 1 returns the batch."""
    if replication <= 1:
        return batch
    R = replication
    E, V, F, B = (batch.num_edges, batch.num_vars, batch.num_clauses,
                  batch.batch_size)

    def host(x):
        return x.cpu().numpy()

    def tile(x, stride=None):
        x = np.tile(host(x), R)
        if stride is not None:
            x = x + np.repeat(np.arange(R, dtype=x.dtype), len(x) // R) \
                * x.dtype.type(stride)
        return x

    edge_var = tile(batch.edge_var32, V)
    edge_clause = tile(batch.edge_clause32, F)
    var_batch = tile(batch.var_batch, B)
    clause_batch = tile(batch.clause_batch, B)
    e_real, f_real = batch.num_real_edges, batch.num_real_clauses
    n_real = batch.num_instances
    v_real = int(host(batch.inst_var_ptr)[n_real])
    e_pre, f_pre = (R - 1) * E + e_real, (R - 1) * F + f_real
    v_pre, n_pre = (R - 1) * V + v_real, (R - 1) * B + n_real

    k = batch.clause_width
    clause_width = k if k > 0 and E == k * F else 0
    tile_aligned = E % REDUCE_TILE == 0 and k in (0, 2, 4, 8)

    # clause_ptr: each replica's real degrees, then its gap of padding
    # edges dealt over its padding clauses, the first ones taking one more
    # (the last replica's padding is the suffix and has none)
    counts = np.tile(np.diff(host(batch.clause_ptr)).astype(np.int64), R)
    gap, n_pad = E - e_real, F - f_real
    if gap:
        for r in range(R - 1):
            if n_pad:
                counts[r * F + f_real:(r + 1) * F] = (
                    gap // n_pad + (np.arange(n_pad) < gap % n_pad))
            else:
                counts[r * F + f_real - 1] += gap
    clause_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)

    real_var = edge_var[:e_pre]
    var_ptr = _ptr(real_var, R * V)
    inst_var_ptr = _ptr(var_batch[:v_pre], R * B)
    inst_clause_ptr = _ptr(clause_batch[:f_pre], R * B)
    # the real rows: each replica's rows end where the batch's do, and the
    # var-major CSR holds the edges with edge_mask 1
    real_edges = np.flatnonzero(np.tile(host(batch.edge_mask), R) > 0)
    real_perm = real_edges[np.argsort(edge_var[real_edges], kind="stable")]
    var_end = inst_var_ptr[:-1] + np.tile(
        np.diff(host(batch.inst_var_ptr)), R)
    clause_end = inst_clause_ptr[:-1] + np.tile(
        np.diff(host(batch.inst_clause_ptr)), R)
    dev = batch.device

    def t(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            device=dev, dtype=dtype)

    def tiled(x):
        return x.repeat(R)

    return FGBatch(
        edge_var=t(edge_var, torch.int64),
        edge_clause=t(edge_clause, torch.int64),
        edge_sign=tiled(batch.edge_sign),
        var_batch=t(var_batch, torch.int64),
        clause_batch=t(clause_batch, torch.int64),
        edge_mask=tiled(batch.edge_mask),
        var_mask=tiled(batch.var_mask),
        clause_mask=tiled(batch.clause_mask),
        instance_mask=tiled(batch.instance_mask),
        label=tiled(batch.label),
        edge_var32=t(edge_var, torch.int32),
        edge_clause32=t(edge_clause, torch.int32),
        var_ptr=t(var_ptr, torch.int32),
        var_perm=t(np.argsort(real_var, kind="stable"), torch.int32),
        clause_ptr=t(clause_ptr, torch.int32),
        inst_var_ptr=t(inst_var_ptr, torch.int32),
        inst_clause_ptr=t(inst_clause_ptr, torch.int32),
        num_real_edges=e_pre,
        num_real_clauses=f_pre,
        max_instance_vars=int(np.diff(inst_var_ptr).max(initial=0)),
        max_instance_clauses=int(np.diff(inst_clause_ptr).max(initial=0)),
        var_max_degree=int(np.diff(var_ptr).max(initial=0)),
        clause_max_degree=int(counts.max(initial=0)),
        clause_width=clause_width,
        fast_var=batch.fast_var and tile_aligned,
        fast_clause=batch.fast_clause and tile_aligned,
        var_window=batch.var_window if tile_aligned else 0,
        graph_feat=batch.graph_feat.repeat(R, 1),
        num_instances=n_pre,
        real=RealRows(
            var_end=t(var_end, torch.int32),
            clause_end=t(clause_end, torch.int32),
            var_ptr=t(_ptr(edge_var[real_edges], R * V), torch.int32),
            var_perm=t(real_perm, torch.int32), num_vars=R * v_real,
            num_clauses=R * f_real, num_edges=R * e_real,
            max_vars=batch.real.max_vars,
            max_clauses=batch.real.max_clauses))


def unpack_instances(batch: FGBatch):
    """The inverse of pack_instances (JAX fg/batch.py :504-537): the
    per-instance tuples (n, m, graph_map[2, Ei], edge_sign[Ei], label) of
    the real instances, with (None, meta) appended when the batch carries
    meta features, read on the host."""
    def host(x):
        return x.cpu().numpy()
    ev, ec, es = host(batch.edge_var), host(batch.edge_clause), host(
        batch.edge_sign)
    vb, cb = host(batch.var_batch), host(batch.clause_batch)
    vm, cm = host(batch.var_mask) > 0, host(batch.clause_mask) > 0
    em = host(batch.edge_mask) > 0
    labels, metas = host(batch.label), host(batch.graph_feat)
    n_real = int(host(batch.instance_mask).sum())

    def offsets(ids):
        counts = np.bincount(ids, minlength=n_real)[:n_real]
        return counts, np.concatenate([[0], np.cumsum(counts)])
    n_by_b, v_off = offsets(vb[vm])
    m_by_b, f_off = offsets(cb[cm])
    _, e_off = offsets(vb[ev[em]])
    out = []
    for b in range(n_real):
        sl = slice(int(e_off[b]), int(e_off[b + 1]))
        gmap = np.stack([ev[sl] - v_off[b], ec[sl] - f_off[b]]).astype(
            np.int32)
        inst = [int(n_by_b[b]), int(m_by_b[b]), gmap,
                es[sl].astype(np.float32), float(labels[b])]
        if metas.shape[1] > 0:
            inst += [None, metas[b]]
        out.append(tuple(inst))
    return out
