// [E, d] feature blocks between edges and nodes: a segment sum and a row
// gather (with an optional fused subtract).
//
// Replaces the TPU kernels of pdp_solver_tpu/ops/pallas_reduce2d.py:
//   windowed_segment_sum_2d (:109, body _reduce_kernel :31, pallas_call :88)
//   windowed_gather_2d      (:120, body _gather_kernel :56, pallas_call :99)
// The TPU kernels contract a [512, 2048] one-hot window against the block
// on the matrix unit and keep the whole [N, d] node table in VMEM; none of
// that is carried over. Here the reduce walks a CSR of each node's edges
// and the gather indexes rows directly.
//
// Rows are f32, or bf16 where the neural modules' compute_dtype="bfloat16"
// gives them: each bf16 element is widened to f32 on load, all arithmetic
// and every output is f32. (The JAX package's aggregators multiply their
// bf16 rows by its f32 edge mask before the sum, so its sums, gathers and
// the subtract are f32 too; no bf16 output is taken.)
//
// pdp_segment_sum_2d: out[n, :] = the f32 sum of x[e, :] over the edges the
//   CSR lists for node n: perm[ptr[n] .. ptr[n+1]) (or the edges ptr[n] ..
//   ptr[n+1] themselves when perm is null, as for clause-major clauses).
//   Padding edges are not in the CSR and are never read; a node with no
//   edges gets 0. One launch, or two when heavy nodes may exist.
//
//   What bounds it: each real row is read once, from a random place on the
//   var side (the permutation), and nothing is computed but one add an
//   element, so the kernel is bound by bytes, and on the card by how many
//   row reads are in flight. The kernel this one replaced gave each node
//   one warp with its rows about 4 at a time, behind a chain of dependent
//   loads (offsets, edge ids, rows), and a node of 63,488 edges one warp
//   through 63,488 rows (19 ms on an H100). This design:
//   1. Splits heavy nodes. When some node may hold S = PDP_R2D_HEAVY slots
//      or more (the pack-time largest degree says whether one can), a
//      first launch runs blocks anchored on the slots a * S. A heavy node
//      is cut among the blocks anchored inside it, as the group walk of
//      common.cuh cuts it: the first takes [lo, its anchor + S), each
//      later one [its anchor, its anchor + S), cut at hi. In a block, warp
//      w takes the piece's chunks of 32 slots w, w + 8, ...; the warps'
//      partial rows meet in shared memory and are added in warp order; a
//      piece's row goes to scratch (f32[d] an anchored block), and the
//      block that counts itself last in (an integer atomic) adds the
//      pieces: warp w adds those of the w-th of 8 runs of ceil(pieces / 8)
//      in anchor order, then the runs' rows are added in order. Its
//      registers are capped so that six such blocks fit an SM and a hub's
//      pieces start in one wave. Light warps skip heavy nodes.
//   2. Keeps rows in flight with few registers. A light warp takes one
//      node: its two offsets, then its rows. It loads the edge ids of 32
//      slots at once (a lane each; the next 32 fetched while these are
//      summed) and PDP_R2D_ROWS = 8 rows before it adds any. The kinds of
//      block are instantiations of one kernel, so each holds only its own
//      state (47 registers a thread for f32 rows of 50, 42 for bf16, where
//      one kernel of all kinds took 61 and 54). Short nodes (a mean under
//      PDP_R2D_SHORT slots: clauses) take a variant with 4 rows in flight
//      and registers capped at 32, so that an SM holds 64 warps: for a
//      node of 4 rows a warp's latency, not its loads in flight, is what
//      there is to hide.
//   3. Takes the widest legal load. A lane loads VEC elements at once, VEC
//      the widest of 4, 2, 1 for f32 (16, 8, 4 bytes) and 8, 4, 2, 1 for
//      bf16 that divides d and the rows' and output's alignment: an f32
//      row of 50 moves as 25 loads of 8 bytes, a bf16 row of 50 as 25 of
//      4, and the output rows go out in the same pieces. A row wider than
//      32 pieces takes several passes over the node.
//   4. Makes an empty node (a padding variable or clause) a store of
//      zeros, with no walk.
//   Each sum has one fixed order, which follows from the CSR and these
//   constants alone: a light node's rows one after another in slot order;
//   a heavy node's as above. No float atomics: the decimators take an
//   argmax of |score|, and the sums are the same from run to run.
//   ops/reduce2d.py walk_order_sum_2d repeats the order in PyTorch.
//   Tried and slower on the card: a ring of rows in flight in shared
//   memory (cp.async, 4-8 byte copies) in place of registers, on every
//   shape; a warp streaming a run of 4-16 short nodes as one, their
//   offsets read at once, against the short-node variant; TMA's
//   tiled copies do not gather rows by index.
// pdp_gather_2d: out[e, c] = nodes[ids[e], c] (- minus[e, c]) for every
//   row e < n_rows (padding edges included), ids i32 or i64; nodes and out
//   f32, minus f32 or bf16. It streams the output: a
//   block of 256 threads takes a tile of 256 rows, whose output (and
//   subtrahend) is one contiguous run of 256 * d elements. The tile's
//   threads read one row's id each into shared memory (an id is read
//   once), then the block moves the run in pieces of VEC elements (VEC =
//   4, 2 or 1: the widest that divides d and the pointers' alignment, so
//   a piece is at most 16 bytes and never crosses a row),
//   neighbouring threads on neighbouring pieces: every thread moves d /
//   VEC pieces and no lane idles whatever d is. A small batch takes tiles
//   of fewer rows (down to 32), so that the launch still has four blocks
//   an SM; there the last pass of a tile leaves lanes idle. A piece's node
//   row comes from L2 (the np-nd-np table is 3.3 MB of the 50 MB); the
//   output, written once, goes out with streaming stores that do not push
//   the table out of L2.
//
// Bound on the H100 at the np-nd-np shapes (E = 524,288 edges of which
// 460,800 real, V = 16,384, d = 50, f32): the reduce reads 92 MB of rows
// and writes 3.3 MB, about 29 us at 3.35 TB/s; the gather-minus reads the
// 105 MB subtrahend, 3.3 MB of node rows (reused from L2) and 2-4 MB of
// ids (i32 or i64), and writes 105 MB, about 64 us; without the subtract
// about 33 us. On bf16 rows: the reduce reads 46 MB of rows (about 15
// us); the gather-minus reads a 52 MB subtrahend and writes 105 MB (about
// 49 us). All do one add per element: bound by bytes. A random row of
// the var side also drags in the rest of its 32-byte sectors: 224 bytes
// for an f32 row of 200, 128 for a bf16 row of 100.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

// slots from which a node is heavy, and the anchors' spacing
#define PDP_R2D_HEAVY 256
// rows a warp of the reduce loads before it adds any: for a node of many
// slots, and for short nodes (a mean under PDP_R2D_SHORT slots, as
// clauses), whose warps take fewer registers so that an SM holds eight
// blocks of them
#define PDP_R2D_ROWS 8
#define PDP_R2D_SHORT_ROWS 4
#define PDP_R2D_SHORT 8
// blocks an SM must hold of the anchored kernel (its registers capped to
// fit): a hub's pieces then start in one wave
#define PDP_R2D_HEAVY_MIN_BLOCKS 6
#define PDP_R2D_WARPS (PDP_THREADS / 32)
// the kernels of the reduce: a warp a node (long or short nodes), the
// anchored blocks of the heavy nodes
#define PDP_R2D_LONG 0
#define PDP_R2D_SHORT_NODES 1
#define PDP_R2D_ANCHORED 2
// the gather's tiles shrink until the launch has this many blocks (four a
// streaming multiprocessor of the H100)
#define PDP_G2D_MIN_BLOCKS 528

// The element types: each is moved as its raw bits and widened to f32.
struct F32 {
  using Raw = float;
  __device__ static float get(Raw r) { return r; }
};
struct BF16 {
  using Raw = unsigned short;
  __device__ static float get(Raw r) {
    return __uint_as_float(((unsigned)r) << 16);
  }
};

// an unsigned word of BYTES bytes: one load or store instruction
template <int BYTES>
struct Word;
template <>
struct Word<2> {
  using T = unsigned short;
};
template <>
struct Word<4> {
  using T = unsigned;
};
template <>
struct Word<8> {
  using T = uint2;
};
template <>
struct Word<16> {
  using T = uint4;
};

// VEC elements of type E, moved as one word
template <class E, int VEC>
union Piece {
  using W = typename Word<VEC * sizeof(typename E::Raw)>::T;
  W w;
  typename E::Raw v[VEC];
};

// VEC f32 values to dst, in words of up to 16 bytes
template <int VEC>
__device__ __forceinline__ void store_f32(float* dst, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    *dst = v[0];
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; k += 4)
      *reinterpret_cast<float4*>(dst + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  }
}

// One launch of the reduce (its fields from SegSum2dArgs and the launch's
// shape).
struct Sum2dPlan {
  const void* x;
  const int* ptr;
  const int* perm;
  const void* ids;
  float* partials;  // f32[anchor_blocks, d]
  int* counters;    // i32[anchor_blocks], 0 between launches
  float* out;
  int d;
  int hd;  // pieces of VEC elements a row
  int ids64;
  int n_seg;
  int n_slots;
  int heavy_min;  // PDP_R2D_HEAVY, or above any node without anchors
};

// The lane's piece of a row, pieces q = q0 + lane of VEC elements (a pass
// of 32 pieces), summed in f32.
template <class I, int VEC>
struct LanePiece {
  using P = Piece<I, VEC>;
  using W = typename P::W;
  float acc[VEC];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
  }
  // the lane's piece of row e (a zero word past the row's end)
  __device__ __forceinline__ static W load(const Sum2dPlan& p, int e,
                                           int q) {
    return q < p.hd ? __ldg(static_cast<const W*>(p.x) + (long)e * p.hd + q)
                    : W{};
  }
  __device__ __forceinline__ void add(W w) {
    P r;
    r.w = w;
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] += I::get(r.v[v]);
  }
  // the lane's piece of out row n (or zeros)
  __device__ __forceinline__ void store(const Sum2dPlan& p, int n, int q,
                                        bool zeros) const {
    if (q < p.hd) {
      float o[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) o[v] = zeros ? 0.0f : acc[v];
      store_f32<VEC>(p.out + (long)n * p.d + q * VEC, o);
    }
  }
};

// the edge of slot j: lane (j - cb)'s id of the chunk at cb (j itself
// without perm); every lane of the warp calls it
__device__ __forceinline__ int slot_edge(const Sum2dPlan& p, int mine, int cb,
                                         int j) {
  return p.perm ? __shfl_sync(PDP_FULL_MASK, mine, (j - cb) & 31) : j;
}

// the edge ids of the chunk of 32 slots at cb (a lane each, below end)
__device__ __forceinline__ int chunk_ids(const Sum2dPlan& p, int cb, int end) {
  const int j = cb + (threadIdx.x & 31);
  return p.perm && j < end ? p.perm[j] : 0;
}

// Adds the slots [cb, cb + nch) (nch <= 32) of one node to lp, in slot
// order, U rows (a divisor of 32) loaded before any is added. Every lane
// of the warp calls it.
template <class I, int VEC, int U>
__device__ __forceinline__ void sum_chunk(const Sum2dPlan& p, int mine,
                                          int cb, int nch, int q,
                                          LanePiece<I, VEC>& lp) {
  for (int t0 = 0; t0 < nch; t0 += U) {
    typename LanePiece<I, VEC>::W r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = slot_edge(p, mine, cb, cb + t0 + u);
      if (t0 + u < nch) r[u] = LanePiece<I, VEC>::load(p, e, q);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (t0 + u < nch) lp.add(r[u]);
  }
}

// Adds the slots [lo, hi) of one node to lp: chunk by chunk, the next
// chunk's edge ids fetched while this one is summed.
template <class I, int VEC, int U>
__device__ __forceinline__ void sum_slots(const Sum2dPlan& p, int lo, int hi,
                                          int q, LanePiece<I, VEC>& lp) {
  int mine = chunk_ids(p, lo, hi);
  for (int cb = lo; cb < hi; cb += 32) {
    const int nxt = chunk_ids(p, cb + 32, hi);
    sum_chunk<I, VEC, U>(p, mine, cb, min(32, hi - cb), q, lp);
    mine = nxt;
  }
}

// A light warp: node n's two offsets, then its slots in order, U rows at
// a time; an empty node is a store of zeros, a heavy one the anchored
// blocks' (nothing here).
template <class I, int VEC, int U>
__device__ void light_warp(const Sum2dPlan& p, int n) {
  const int lane = threadIdx.x & 31;
  const int lo = p.ptr[n], hi = p.ptr[n + 1];
  if (hi - lo >= p.heavy_min) return;
  LanePiece<I, VEC> lp;
  for (int q0 = 0; q0 < p.hd; q0 += 32) {
    lp.zero();
    sum_slots<I, VEC, U>(p, lo, hi, q0 + lane, lp);
    lp.store(p, n, q0 + lane, false);
  }
}

// An anchored block: a piece of the heavy node holding slot a * S, if any.
template <class I, int VEC>
__device__ void anchored_block(const Sum2dPlan& p, int a) {
  __shared__ float warp_rows[PDP_R2D_WARPS][32 * VEC];
  __shared__ int last;
  constexpr int S = PDP_R2D_HEAVY;
  const int s = a * S;
  if (s >= p.n_slots) return;
  // every thread decides alike, so the block stays together
  const int es = p.perm ? p.perm[s] : s;
  const long long id =
      p.ids64 ? static_cast<const long long*>(p.ids)[es]
              : (long long)static_cast<const int*>(p.ids)[es];
  if (id < 0 || id >= p.n_seg) return;
  const int n = (int)id;
  const int lo = p.ptr[n], hi = p.ptr[n + 1];
  if (hi - lo < p.heavy_min) return;
  const int a0 = (lo + S - 1) / S, a1 = (hi - 1) / S;  // its anchors
  const int j0 = a == a0 ? lo : s, j1 = min(s + S, hi);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  LanePiece<I, VEC> lp;
  for (int q0 = 0; q0 < p.hd; q0 += 32) {
    const int q = q0 + lane;
    lp.zero();
    // warp w: the chunks w, w + 8, ... of 32 slots of the piece, the next
    // one's edge ids fetched while this one is summed
    int cb = j0 + 32 * w;
    int mine = chunk_ids(p, cb, j1);
    for (; cb < j1; cb += 32 * PDP_R2D_WARPS) {
      const int nxt = chunk_ids(p, cb + 32 * PDP_R2D_WARPS, j1);
      sum_chunk<I, VEC, PDP_R2D_ROWS>(p, mine, cb, min(32, j1 - cb), q,
                                      lp);
      mine = nxt;
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) warp_rows[w][lane * VEC + v] = lp.acc[v];
    __syncthreads();
    const int ncol = min(p.hd - q0, 32) * VEC;
    for (int c = threadIdx.x; c < ncol; c += blockDim.x) {
      float tot = warp_rows[0][c];
      for (int u = 1; u < PDP_R2D_WARPS; ++u) tot += warp_rows[u][c];
      const int col = q0 * VEC + c;
      if (a0 == a1)  // the node is one piece
        p.out[(long)n * p.d + col] = tot;
      else
        p.partials[(long)a * p.d + col] = tot;
    }
    __syncthreads();
  }
  if (a0 == a1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&p.counters[a0], 1) == a1 - a0;
  __syncthreads();
  if (!last) return;
  // the last piece in: every other piece's row is in scratch. Warp w adds
  // the pieces [a0 + w m, a0 + w m + m) in anchor order, m = ceil(pieces /
  // warps), its lanes on the columns; then the warps' rows in warp order
  __threadfence();
  const int m = (a1 - a0 + PDP_R2D_WARPS) / PDP_R2D_WARPS;
  const int k0 = a0 + w * m, k1 = min(k0 + m, a1 + 1);
  constexpr int COLS = 32 * VEC;  // columns of warp_rows a warp
  for (int c0 = 0; c0 < p.d; c0 += COLS) {
    for (int c = c0 + lane; c < min(p.d, c0 + COLS); c += 32) {
      const float* col = p.partials + c;
      float sum = 0.0f;
      int k = k0;
      for (; k + 8 <= k1; k += 8) {
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = __ldcg(col + (long)(k + i) * p.d);
#pragma unroll
        for (int i = 0; i < 8; ++i) sum += v[i];
      }
      for (; k < k1; ++k) sum += __ldcg(col + (long)k * p.d);
      warp_rows[w][c - c0] = sum;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < min(p.d - c0, COLS); c += blockDim.x) {
      float tot = warp_rows[0][c];
      for (int u = 1; u < PDP_R2D_WARPS; ++u) tot += warp_rows[u][c];
      p.out[(long)n * p.d + c0 + c] = tot;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) p.counters[a0] = 0;
}

template <class I, int VEC, int MODE>
__global__ void __launch_bounds__(PDP_THREADS,
                                  MODE == PDP_R2D_ANCHORED
                                      ? PDP_R2D_HEAVY_MIN_BLOCKS
                                      : MODE == PDP_R2D_SHORT_NODES ? 8 : 1)
    segment_sum_2d_kernel(Sum2dPlan p) {
  if constexpr (MODE == PDP_R2D_ANCHORED) {
    anchored_block<I, VEC>(p, (int)blockIdx.x);
  } else {
    const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    if (warp >= p.n_seg) return;
    light_warp<I, VEC,
               MODE == PDP_R2D_SHORT_NODES ? PDP_R2D_SHORT_ROWS
                                           : PDP_R2D_ROWS>(p, (int)warp);
  }
}

// One reduce's arguments (the field order matches ops/_build.py
// SegSum2dArgs): x [*, d], f32 or (x_bf16) bf16; ptr i32[n_seg + 1]; perm
// i32[n_slots] or null; ids [*] of each edge's node, i64 (ids64) or i32;
// heavy: some node may
// hold PDP_R2D_HEAVY slots or more, and then partials f32[anchors * d] and
// counters i32[anchors] (zeros), anchors = ceil(n_slots /
// PDP_R2D_HEAVY); out f32[n_seg, d].
struct SegSum2dArgs {
  const void* x;
  int x_bf16;
  int d;
  const int* ptr;
  const int* perm;
  const void* ids;
  int ids64;
  int n_seg;
  int n_slots;
  int heavy;
  float* partials;
  int* counters;
  void* out;
  void* stream;
};

// the anchored blocks (when heavy nodes may exist), then the light warps
template <class I, int VEC>
static void launch_sum(Sum2dPlan p, bool heavy, cudaStream_t st) {
  p.hd = p.d / VEC;
  if (heavy) {
    const int anchors = (p.n_slots + PDP_R2D_HEAVY - 1) / PDP_R2D_HEAVY;
    if (anchors > 0)
      segment_sum_2d_kernel<I, VEC, PDP_R2D_ANCHORED>
          <<<anchors, PDP_THREADS, 0, st>>>(p);
  }
  const unsigned blocks =
      (unsigned)(((long)p.n_seg * 32 + PDP_THREADS - 1) / PDP_THREADS);
  if ((long)p.n_slots < (long)PDP_R2D_SHORT * p.n_seg)
    segment_sum_2d_kernel<I, VEC, PDP_R2D_SHORT_NODES>
        <<<blocks, PDP_THREADS, 0, st>>>(p);
  else
    segment_sum_2d_kernel<I, VEC, PDP_R2D_LONG>
        <<<blocks, PDP_THREADS, 0, st>>>(p);
}

// the widest VEC that divides d and the alignment of the rows (VEC
// elements) and of the output (VEC floats, in words of up to 16 bytes)
template <class I>
static void launch_type(const Sum2dPlan& p, bool heavy, cudaStream_t st) {
  const uintptr_t at_x = reinterpret_cast<uintptr_t>(p.x);
  const uintptr_t at_o = reinterpret_cast<uintptr_t>(p.out);
  auto fits = [&](int v) {
    const int out_word = v * 4 < 16 ? v * 4 : 16;
    return p.d % v == 0 && at_x % (v * sizeof(typename I::Raw)) == 0 &&
           at_o % out_word == 0;
  };
  if constexpr (sizeof(typename I::Raw) == 2) {
    if (fits(8)) return launch_sum<I, 8>(p, heavy, st);
  }
  if (fits(4))
    launch_sum<I, 4>(p, heavy, st);
  else if (fits(2))
    launch_sum<I, 2>(p, heavy, st);
  else
    launch_sum<I, 1>(p, heavy, st);
}

// nodes and out f32, minus of type M
template <class M, int VEC, bool MINUS, class IdT>
__global__ void gather_2d_kernel(const void* __restrict__ nodes, int d,
                                 const IdT* __restrict__ ids,
                                 const void* __restrict__ minus,
                                 long n_rows, int tile,
                                 void* __restrict__ out) {
  using W = typename Piece<F32, VEC>::W;
  using MW = typename Piece<M, VEC>::W;
  __shared__ long long row_at[PDP_THREADS];  // node row start, in pieces
  const int hd = d / VEC;                    // pieces a row
  const long row0 = (long)blockIdx.x * tile;
  const int rows = (int)min((long)tile, n_rows - row0);
  if ((int)threadIdx.x < rows)
    row_at[threadIdx.x] = (long long)ids[row0 + threadIdx.x] * hd;
  __syncthreads();
  const W* src = static_cast<const W*>(nodes);
  const MW* sub = MINUS ? static_cast<const MW*>(minus) + row0 * hd
                        : nullptr;
  W* dst = static_cast<W*>(out) + row0 * hd;
  const int n = rows * hd;
  // piece u of the tile is column c of tile row r; stepping u by the block
  // steps (r, c) by (qr, qc) with one carry, and no thread divides again
  const int qr = PDP_THREADS / hd, qc = PDP_THREADS - qr * hd;
  int r = (int)threadIdx.x / hd, c = (int)threadIdx.x - r * hd;
#pragma unroll 4
  for (int u = threadIdx.x; u < n; u += PDP_THREADS) {
    Piece<F32, VEC> a;
    a.w = __ldg(src + row_at[r] + c);
    if (MINUS) {
      Piece<M, VEC> b;
      b.w = sub[u];
#pragma unroll
      for (int k = 0; k < VEC; ++k) a.v[k] -= M::get(b.v[k]);
    }
    __stcs(dst + u, a.w);
    c += qc;
    r += qr;
    if (c >= hd) {
      c -= hd;
      ++r;
    }
  }
}

// One gather's arguments (the field order matches ops/_build.py
// GatherArgs): nodes [*, d]; ids i64[n_rows] (ids64) or i32[n_rows];
// minus [n_rows, d], f32 or (minus_bf16) bf16, or null; out [n_rows, d];
// nodes and out f32.
struct GatherArgs {
  const void* nodes;
  int d;
  int ids64;
  const void* ids;
  const void* minus;
  long n_rows;
  void* out;
  int minus_bf16;
  void* stream;
};

// the kernel for one (subtrahend type, VEC, MINUS, id type)
template <class M, int VEC, bool MINUS>
static void launch_gather_ids(const GatherArgs* g, cudaStream_t st) {
  // tiles of 256 rows, or of fewer (down to 32) while that leaves fewer
  // than PDP_G2D_MIN_BLOCKS blocks: a small batch still fills the card
  const long n_rows = g->n_rows;
  int tile = PDP_THREADS;
  while (tile > 32 && (n_rows + tile - 1) / tile < PDP_G2D_MIN_BLOCKS)
    tile >>= 1;
  const unsigned blocks = (unsigned)((n_rows + tile - 1) / tile);
  if (g->ids64)
    gather_2d_kernel<M, VEC, MINUS><<<blocks, PDP_THREADS, 0, st>>>(
        g->nodes, g->d, static_cast<const int64_t*>(g->ids), g->minus,
        n_rows, tile, g->out);
  else
    gather_2d_kernel<M, VEC, MINUS><<<blocks, PDP_THREADS, 0, st>>>(
        g->nodes, g->d, static_cast<const int32_t*>(g->ids), g->minus,
        n_rows, tile, g->out);
}

// the widest VEC (of 4, 2, 1: a piece of f32 within 16 bytes) that divides
// d and every array's alignment, then the launch
template <class M, bool MINUS>
static void launch_gather(const GatherArgs* g, cudaStream_t st) {
  const int d = g->d;
  const uintptr_t at_n = reinterpret_cast<uintptr_t>(g->nodes);
  const uintptr_t at_m = reinterpret_cast<uintptr_t>(g->minus);
  const uintptr_t at_o = reinterpret_cast<uintptr_t>(g->out);
  auto fits = [&](int v) {
    return d % v == 0 && at_n % (v * sizeof(float)) == 0 &&
           at_m % (v * sizeof(typename M::Raw)) == 0 &&
           at_o % (v * sizeof(float)) == 0;
  };
  if (fits(4))
    launch_gather_ids<M, 4, MINUS>(g, st);
  else if (fits(2))
    launch_gather_ids<M, 2, MINUS>(g, st);
  else
    launch_gather_ids<M, 1, MINUS>(g, st);
}

extern "C" {

// Returns cudaGetLastError(), or cudaErrorInvalidValue for heavy nodes
// without scratch (nothing launched).
int pdp_segment_sum_2d(const SegSum2dArgs* a) {
  if (a->n_seg > 0 && a->d > 0) {
    if (a->heavy && (!a->partials || !a->counters))
      return (int)cudaErrorInvalidValue;
    Sum2dPlan p;
    p.x = a->x;
    p.ptr = a->ptr;
    p.perm = a->perm;
    p.ids = a->ids;
    p.partials = a->partials;
    p.counters = a->counters;
    p.out = static_cast<float*>(a->out);
    p.d = a->d;
    p.hd = a->d;
    p.ids64 = a->ids64;
    p.n_seg = a->n_seg;
    p.n_slots = a->n_slots;
    p.heavy_min = a->heavy ? PDP_R2D_HEAVY : 0x7fffffff;
    cudaStream_t st = static_cast<cudaStream_t>(a->stream);
    if (a->x_bf16)
      launch_type<BF16>(p, a->heavy, st);
    else
      launch_type<F32>(p, a->heavy, st);
  }
  return (int)cudaGetLastError();
}

// Returns cudaGetLastError().
int pdp_gather_2d(const GatherArgs* g) {
  cudaStream_t st = static_cast<cudaStream_t>(g->stream);
  if (g->n_rows > 0 && g->d > 0) {
    if (!g->minus)
      launch_gather<F32, false>(g, st);
    else if (g->minus_bf16)
      launch_gather<BF16, true>(g, st);
    else
      launch_gather<F32, true>(g, st);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
