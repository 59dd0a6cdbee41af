"""Input pipeline: JSON datasets and generator streams -> packed FGBatches.

Counterpart of `pdp_solver_tpu/fg/loader.py`, with the same segments,
shapes and macro_done flags; batches are packed by the port's
`pack_instances` on the loader's `device`.

Replaces reference `FactorGraphDataset` / `DynamicBatchDivider` / DataLoader
(src/pdp/factorgraph/dataset.py). As in the JAX package, segments are
padded up to geometric bucket shapes, and generator mode can pad every
segment to one fixed shape (`fixed_dims`), so that a training run keeps
one set of shapes (and of kernel launch plans).

The memory-driven segmentation heuristic itself is kept semantically: a
macro-batch of `batch_size` instances is split so each segment satisfies
limit >= max_edges_in_segment * hidden_dim * segment_size, with instances
sorted by edge count descending (dataset.py:36-74), and the limit divided by
`batch_replication` up front (dataset.py:95).
"""

import collections
import os

import numpy as np

import dataclasses

from pdp_solver_tpu_torch.fg.batch import pack_instances
from pdp_solver_tpu_torch.fg.jsonfmt import parse_line, read_json_dataset

# files above this size are read lazily (line-offset index + LRU parse
# cache, the reference's max_cache_size behaviour, dataset.py:103-118);
# override with PDP_LAZY_FILE_BYTES
LAZY_FILE_BYTES = int(os.environ.get("PDP_LAZY_FILE_BYTES",
                                     64 * 1024 * 1024))


class _LazyJsonDataset:
    """Sequence of parsed instances backed by a line-offset index and a
    bounded LRU cache, so datasets far larger than RAM stream cleanly."""

    def __init__(self, path, max_cache_size=100000):
        self._path = path
        self._cache = collections.OrderedDict()
        self._max_cache = max_cache_size
        self._offsets = []
        with open(path, "rb") as f:
            off = 0
            for line in f:
                if line.strip():
                    self._offsets.append(off)
                off += len(line)
        self._fh = open(path, "rb")

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __del__(self):
        self.close()

    def __len__(self):
        return len(self._offsets)

    def __getitem__(self, i):
        if i in self._cache:
            self._cache.move_to_end(i)
            return self._cache[i]
        if self._fh is None:
            self._fh = open(self._path, "rb")
        self._fh.seek(self._offsets[i])
        inst = parse_line(self._fh.readline().decode())
        if len(self._cache) >= self._max_cache:
            self._cache.popitem(last=False)
        self._cache[i] = inst
        return inst


def divide_batch(instances, limit, hidden_dim):
    """Split one macro-batch into memory-bounded segments
    (reference DynamicBatchDivider.divide, dataset.py:24-74)."""
    edge_num = [inst[2].shape[1] for inst in instances]
    max_e = max(edge_num)
    if limit // max(max_e * hidden_dim, 1) >= len(instances):
        return [instances]

    order = sorted(range(len(instances)), reverse=True,
                   key=lambda i: edge_num[i])
    segments = []
    i = 0
    while i < len(order):
        allowed = max(1, limit // (edge_num[order[i]] * hidden_dim))
        segments.append([instances[j] for j in order[i:i + allowed]])
        i += allowed
    return segments


class BatchLoader:
    """Iterate packed (FGBatch, misc) pairs over a dataset or a generator.

    dataset mode:   instances read once from a JSON-lines file (cached).
    generator mode: `epoch_size` fresh instances per epoch; with
                    `fixed_shape=True` every batch is padded to the same
                    shape.
    """

    def __init__(self, input_file=None, generator=None, epoch_size=0,
                 batch_size=5000, limit=40000000, hidden_dim=3,
                 batch_replication=1, shuffle=False, granularity=2.0,
                 fixed_shape=False, fixed_dims=None, seed=0,
                 max_cache_size=100000, device="cuda"):
        self._device = device
        self._generator = generator
        self._epoch_size = epoch_size
        self._batch_size = batch_size
        self._limit = limit // max(batch_replication, 1)
        self._hidden_dim = max(hidden_dim, 1)
        self._shuffle = shuffle
        self._granularity = granularity
        self._fixed_shape = fixed_shape
        # explicit (V, F, E, B) pad dims for fixed-shape mode. The default
        # (generator.max_dims() scaled by the memory cap) pads every segment
        # to the worst SINGLE instance times the instance cap, which for
        # wide generator ranges is ~5x the expected size — segments then
        # carry 2-3 real instances in an 80%-padding batch. Passing expected
        # aggregate dims instead packs segments densely (the greedy fill in
        # _emit already handles per-instance overflow by starting a new
        # segment).
        self._fixed_dims = fixed_dims
        self._rng = np.random.default_rng(seed)
        self._instances = None
        if input_file is not None:
            if os.path.getsize(input_file) > LAZY_FILE_BYTES:
                self._instances = _LazyJsonDataset(input_file, max_cache_size)
            else:
                self._instances = read_json_dataset(input_file)

    def __len__(self):
        n = self._epoch_size if self._generator is not None \
            else len(self._instances)
        return max(1, -(-n // self._batch_size))

    def _iter_instances(self):
        if self._generator is not None:
            for _ in range(self._epoch_size):
                yield self._generator.generate() + ((),)  # no misc
        else:
            idx = np.arange(len(self._instances))
            if self._shuffle:
                self._rng.shuffle(idx)
            for i in idx:
                yield self._instances[i]

    def _fixed_dims_default(self):
        if self._fixed_dims is not None:
            return tuple(self._fixed_dims)
        v, f, e = self._generator.max_dims()
        b = self._batch_size
        cap = self._limit // max(e * self._hidden_dim, 1)
        b = max(1, min(b, cap)) if cap > 0 else 1
        return v * b, f * b, e * b, b

    def __iter__(self):
        for batch, misc, _ in self.iter_segments():
            yield batch, misc

    def iter_segments(self):
        """Yield (batch, misc, macro_done) where macro_done marks the last
        segment of each macro-batch - the reference's global_step increments
        once per macro-batch (base.py:144-145), not once per segment."""
        macro = []
        fixed = self._fixed_dims_default() if (
            self._fixed_shape and self._generator is not None) else None
        for inst in self._iter_instances():
            macro.append(inst)
            if len(macro) >= self._batch_size:
                yield from self._emit(macro, fixed)
                macro = []
        if macro:
            yield from self._emit(macro, fixed)

    def _emit(self, macro, fixed):
        # group first (raw instance tuples, cheap), pack one segment per
        # yield - materializing every packed segment of a macro-batch at
        # once would hold S full padded array sets in host memory
        groups = []
        if fixed is not None:
            pv, pf, pe, pb = fixed
            # greedy fill below the fixed caps
            seg, sv = [], [0, 0, 0]
            for inst in macro:
                d = (inst[0], inst[1], inst[2].shape[1])
                if d[0] > pv or d[1] > pf or d[2] > pe:
                    raise ValueError(
                        f"instance dims {d} exceed fixed pad dims "
                        f"({pv}, {pf}, {pe}); raise fixed_dims or shrink "
                        "the generator's max instance size")
                if seg and (sv[0] + d[0] > pv or sv[1] + d[1] > pf
                            or sv[2] + d[2] > pe or len(seg) >= pb):
                    groups.append(seg)
                    seg, sv = [], [0, 0, 0]
                seg.append(inst)
                sv = [sv[0] + d[0], sv[1] + d[1], sv[2] + d[2]]
            if seg:
                groups.append(seg)
        else:
            pv = pf = pe = pb = None
            groups = list(divide_batch(macro, self._limit, self._hidden_dim))
        for i, seg in enumerate(groups):
            batch, misc = self._pack(seg, pv, pf, pe, pb)
            yield batch, misc, i == len(groups) - 1

    def _pack(self, seg, pv, pf, pe, pb):
        misc = [inst[5] if len(inst) > 5 else () for inst in seg]
        batch = pack_instances(seg, device=self._device, pad_v=pv,
                               pad_f=pf, pad_e=pe, pad_b=pb, bucket=True,
                               granularity=self._granularity)
        if pv is not None:
            # the JAX loader clears this pack-time metadata on fixed-shape
            # segments (its jit cache keys on it); cleared here too, so
            # that both packages hand out the same batches
            batch = dataclasses.replace(batch, var_window=0)
        return batch, misc
