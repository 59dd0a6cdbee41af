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
// pdp_segment_sum_2d: out[n, :] = sum of x[e, :] over the edges the CSR
//   lists for node n: perm[ptr[n] .. ptr[n+1]) (or the edges ptr[n] ..
//   ptr[n+1] themselves when perm is null, as for clause-major clauses), in
//   that order. One warp per node; lane l accumulates columns l, l+32, ...
//   in registers, so each edge row is read by one coalesced warp load. The
//   warp loads 32 edge ids at once and broadcasts them with shuffles. Each
//   sum is taken in one fixed order and no float atomics are used: the
//   result does not change from run to run. Padding edges are not in the
//   CSR and take part in no sum. Nodes with no edges get 0.
// pdp_gather_2d: out[e, c] = nodes[ids[e], c] (- minus[e, c]) for every
//   row e < n_rows (padding edges included), ids i32 or i64. It streams
//   the output: a block of 256 threads takes a tile of 256 rows, whose
//   output (and subtrahend) is one contiguous run of 256 * d floats. The
//   tile's threads read one row's id each into shared memory (an id is
//   read once), then the block moves the run in pieces of VEC floats (VEC
//   = 4, 2 or 1: the widest that divides d and the pointers' alignment,
//   so a piece never crosses a row), neighbouring threads on neighbouring
//   pieces: every thread moves d / VEC pieces and no lane idles whatever
//   d is. A small batch takes tiles of fewer rows (down to 32), so that
//   the launch still has four blocks an SM; there the last pass of a tile
//   leaves lanes idle. A piece's node row comes from L2 (the np-nd-np
//   table is 3.3 MB of the 50 MB); the output, written once, goes out
//   with streaming stores that do not push the table out of L2.
//
// Bound on the H100 at the np-nd-np shapes (E = 524,288 edges of which
// 460,800 real, V = 16,384, d = 50, f32): the reduce reads 92 MB of rows
// and writes 3.3 MB, about 29 us at 3.35 TB/s; the gather-minus reads the
// 105 MB subtrahend, 3.3 MB of node rows (reused from L2) and 2-4 MB of
// ids (i32 or i64), and writes 105 MB, about 64 us; without the subtract
// about 33 us. Both do one add per element: bound by bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

// columns held per lane in one pass: 32 * CH columns of a row per pass
#define PDP_R2D_CH 2
// the gather's tiles shrink until the launch has this many blocks (four a
// streaming multiprocessor of the H100)
#define PDP_G2D_MIN_BLOCKS 528

__global__ void segment_sum_2d_kernel(const float* __restrict__ x, int d,
                                      const int* __restrict__ ptr,
                                      const int* __restrict__ perm,
                                      int n_seg, float* __restrict__ out) {
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_seg) return;
  const int beg = ptr[warp], end = ptr[warp + 1];
  for (int c0 = 0; c0 < d; c0 += 32 * PDP_R2D_CH) {
    float acc[PDP_R2D_CH];
#pragma unroll
    for (int k = 0; k < PDP_R2D_CH; ++k) acc[k] = 0.0f;
    for (int j0 = beg; j0 < end; j0 += 32) {
      const int j = j0 + lane;
      const int mine = j < end ? (perm ? perm[j] : j) : 0;
      const int n = min(32, end - j0);
#pragma unroll 4
      for (int t = 0; t < n; ++t) {
        const long e = __shfl_sync(0xffffffffu, mine, t);
        const float* row = x + e * d;
#pragma unroll
        for (int k = 0; k < PDP_R2D_CH; ++k) {
          const int c = c0 + k * 32 + lane;
          if (c < d) acc[k] += row[c];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < PDP_R2D_CH; ++k) {
      const int c = c0 + k * 32 + lane;
      if (c < d) out[warp * d + c] = acc[k];
    }
  }
}

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static T sub(T a, T b) { return a - b; }
};
template <>
struct Vec<2> {
  using T = float2;
  __device__ static T sub(T a, T b) {
    return make_float2(a.x - b.x, a.y - b.y);
  }
};
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T sub(T a, T b) {
    return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
  }
};

template <int VEC, bool MINUS, class IdT>
__global__ void gather_2d_kernel(const float* __restrict__ nodes, int d,
                                 const IdT* __restrict__ ids,
                                 const float* __restrict__ minus, long n_rows,
                                 int tile, float* __restrict__ out) {
  using T = typename Vec<VEC>::T;
  __shared__ long long row_at[PDP_THREADS];  // node row start, in pieces
  const int hd = d / VEC;                    // pieces a row
  const long row0 = (long)blockIdx.x * tile;
  const int rows = (int)min((long)tile, n_rows - row0);
  if ((int)threadIdx.x < rows)
    row_at[threadIdx.x] = (long long)ids[row0 + threadIdx.x] * hd;
  __syncthreads();
  const T* src = reinterpret_cast<const T*>(nodes);
  const T* sub = MINUS ? reinterpret_cast<const T*>(minus) + row0 * hd
                       : nullptr;
  T* dst = reinterpret_cast<T*>(out) + row0 * hd;
  const int n = rows * hd;
  // piece u of the tile is column c of tile row r; stepping u by the block
  // steps (r, c) by (qr, qc) with one carry, and no thread divides again
  const int qr = PDP_THREADS / hd, qc = PDP_THREADS - qr * hd;
  int r = (int)threadIdx.x / hd, c = (int)threadIdx.x - r * hd;
#pragma unroll 4
  for (int u = threadIdx.x; u < n; u += PDP_THREADS) {
    T v = __ldg(src + row_at[r] + c);
    if (MINUS) v = Vec<VEC>::sub(v, sub[u]);
    __stcs(dst + u, v);
    c += qc;
    r += qr;
    if (c >= hd) {
      c -= hd;
      ++r;
    }
  }
}

// the kernel for one (VEC, MINUS, id type)
template <int VEC, bool MINUS>
static void launch_gather_ids(const float* nodes, int d, const void* ids,
                              bool ids64, const float* minus, long n_rows,
                              float* out, cudaStream_t st) {
  // tiles of 256 rows, or of fewer (down to 32) while that leaves fewer
  // than PDP_G2D_MIN_BLOCKS blocks: a small batch still fills the card
  int tile = PDP_THREADS;
  while (tile > 32 && (n_rows + tile - 1) / tile < PDP_G2D_MIN_BLOCKS)
    tile >>= 1;
  const unsigned blocks = (unsigned)((n_rows + tile - 1) / tile);
  if (ids64)
    gather_2d_kernel<VEC, MINUS><<<blocks, PDP_THREADS, 0, st>>>(
        nodes, d, static_cast<const int64_t*>(ids), minus, n_rows, tile,
        out);
  else
    gather_2d_kernel<VEC, MINUS><<<blocks, PDP_THREADS, 0, st>>>(
        nodes, d, static_cast<const int32_t*>(ids), minus, n_rows, tile,
        out);
}

template <int VEC>
static void launch_gather(const float* nodes, int d, const void* ids,
                          bool ids64, const float* minus, long n_rows,
                          float* out, cudaStream_t st) {
  if (minus)
    launch_gather_ids<VEC, true>(nodes, d, ids, ids64, minus, n_rows, out,
                                 st);
  else
    launch_gather_ids<VEC, false>(nodes, d, ids, ids64, minus, n_rows, out,
                                  st);
}

extern "C" {

// x: f32[*, d] row-major; ptr: i32[n_seg + 1]; perm: i32[ptr[n_seg]] or
// null; out: f32[n_seg, d]. Returns cudaGetLastError().
int pdp_segment_sum_2d(const float* x, int d, const int* ptr,
                       const int* perm, int n_seg, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_seg > 0 && d > 0) {
    const long threads = (long)n_seg * 32;
    const int blocks = (int)((threads + PDP_THREADS - 1) / PDP_THREADS);
    segment_sum_2d_kernel<<<blocks, PDP_THREADS, 0, st>>>(x, d, ptr, perm,
                                                          n_seg, out);
  }
  return (int)cudaGetLastError();
}

// One gather's arguments (the field order matches ops/_build.py
// GatherArgs): nodes f32[*, d]; ids i64[n_rows] (ids64) or i32[n_rows];
// minus f32[n_rows, d] or null; out f32[n_rows, d].
struct GatherArgs {
  const float* nodes;
  int d;
  int ids64;
  const void* ids;
  const float* minus;
  long n_rows;
  float* out;
  void* stream;
};

// Returns cudaGetLastError().
int pdp_gather_2d(const GatherArgs* g) {
  cudaStream_t st = static_cast<cudaStream_t>(g->stream);
  const int d = g->d;
  if (g->n_rows > 0 && d > 0) {
    const uintptr_t at = reinterpret_cast<uintptr_t>(g->nodes) |
                         reinterpret_cast<uintptr_t>(g->out) |
                         reinterpret_cast<uintptr_t>(g->minus);
    if (d % 4 == 0 && at % 16 == 0)
      launch_gather<4>(g->nodes, d, g->ids, g->ids64, g->minus, g->n_rows,
                       g->out, st);
    else if (d % 2 == 0 && at % 8 == 0)
      launch_gather<2>(g->nodes, d, g->ids, g->ids64, g->minus, g->n_rows,
                       g->out, st);
    else
      launch_gather<1>(g->nodes, d, g->ids, g->ids64, g->minus, g->n_rows,
                       g->out, st);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
