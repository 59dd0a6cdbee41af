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
// pdp_segment_sum_2d: out[n, :] = sum of x[e, :] over the edges the CSR
//   lists for node n: perm[ptr[n] .. ptr[n+1]) (or the edges ptr[n] ..
//   ptr[n+1] themselves when perm is null, as for clause-major clauses), in
//   that order. x is f32 or bf16, out f32. One warp per node;
//   each lane accumulates 64 / 32 columns of a pass in f32 registers: f32
//   rows a column at a time (two 4-byte loads a lane), bf16 rows of even
//   width a pair at a time (one 4-byte load a lane, so a warp still reads
//   128 bytes at once; a bf16 row of 50 is 100 bytes, 4-byte aligned but
//   not 16-byte aligned). The warp loads 32 edge ids at once and
//   broadcasts them with shuffles. Each sum is taken in one fixed order
//   and no float atomics are used: the result does not change from run to
//   run. Padding edges are not in the CSR and take part in no sum. Nodes
//   with no edges get 0.
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
// 49 us). All do one add per element: bound by bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

// columns of a row a warp takes in one pass of the reduce
#define PDP_R2D_COLS 64
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

// P = elements a lane loads at once (1, or 2 for bf16 rows of even width);
// out is f32
template <class I, int P>
__global__ void segment_sum_2d_kernel(const void* __restrict__ x, int d,
                                      const int* __restrict__ ptr,
                                      const int* __restrict__ perm,
                                      int n_seg, void* __restrict__ out) {
  constexpr int CH = PDP_R2D_COLS / (32 * P);  // pieces a lane holds
  using IW = typename Piece<I, P>::W;
  using OW = typename Piece<F32, P>::W;
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_seg) return;
  const int beg = ptr[warp], end = ptr[warp + 1];
  const int hd = d / P;  // pieces a row
  for (int q0 = 0; q0 < hd; q0 += 32 * CH) {
    float acc[CH][P];
#pragma unroll
    for (int k = 0; k < CH; ++k)
#pragma unroll
      for (int p = 0; p < P; ++p) acc[k][p] = 0.0f;
    for (int j0 = beg; j0 < end; j0 += 32) {
      const int j = j0 + lane;
      const int mine = j < end ? (perm ? perm[j] : j) : 0;
      const int n = min(32, end - j0);
#pragma unroll 4
      for (int t = 0; t < n; ++t) {
        const long e = __shfl_sync(0xffffffffu, mine, t);
        const IW* row = static_cast<const IW*>(x) + e * hd;
#pragma unroll
        for (int k = 0; k < CH; ++k) {
          const int q = q0 + k * 32 + lane;
          if (q < hd) {
            Piece<I, P> v;
            v.w = row[q];
#pragma unroll
            for (int p = 0; p < P; ++p) acc[k][p] += I::get(v.v[p]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int q = q0 + k * 32 + lane;
      if (q < hd) {
        Piece<F32, P> o;
#pragma unroll
        for (int p = 0; p < P; ++p) o.v[p] = acc[k][p];
        static_cast<OW*>(out)[warp * hd + q] = o.w;
      }
    }
  }
}

template <class I, int P>
static void launch_sum(const void* x, int d, const int* ptr, const int* perm,
                       int n_seg, void* out, cudaStream_t st) {
  const long threads = (long)n_seg * 32;
  const int blocks = (int)((threads + PDP_THREADS - 1) / PDP_THREADS);
  segment_sum_2d_kernel<I, P><<<blocks, PDP_THREADS, 0, st>>>(
      x, d, ptr, perm, n_seg, out);
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

// x: [*, d] row-major, f32 or (x_bf16) bf16; ptr: i32[n_seg + 1]; perm:
// i32[ptr[n_seg]] or null; out: f32[n_seg, d]. Returns cudaGetLastError().
int pdp_segment_sum_2d(const void* x, int x_bf16, int d, const int* ptr,
                       const int* perm, int n_seg, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_seg > 0 && d > 0) {
    if (!x_bf16)
      launch_sum<F32, 1>(x, d, ptr, perm, n_seg, out, st);
    else if (d % 2 || reinterpret_cast<uintptr_t>(x) % 4)
      launch_sum<BF16, 1>(x, d, ptr, perm, n_seg, out, st);
    else
      launch_sum<BF16, 2>(x, d, ptr, perm, n_seg, out, st);
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
