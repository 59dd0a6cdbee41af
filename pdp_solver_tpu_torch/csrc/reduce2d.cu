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
//   row e < n_rows (padding edges included). One warp per row, lanes over
//   its columns, so each row is read and written by coalesced warp accesses
//   and no thread divides an index.
//
// Bound on the H100 at the np-nd-np shapes (E = 524,288 edges of which
// 460,800 real, V = 16,384, d = 50, f32): the reduce reads 92 MB of rows
// and writes 3.3 MB, about 29 us at 3.35 TB/s; the gather-minus reads the
// 105 MB subtrahend, 3.3 MB of node rows (reused from L2) and 4 MB of ids,
// and writes 105 MB, about 65 us. Both do one add per element: bound by
// bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

// columns held per lane in one pass: 32 * CH columns of a row per pass
#define PDP_R2D_CH 2

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

__global__ void gather_2d_kernel(const float* __restrict__ nodes, int d,
                                 const int64_t* __restrict__ ids,
                                 const float* __restrict__ minus, long n_rows,
                                 float* __restrict__ out) {
  const long row = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const float* src = nodes + ids[row] * d;
  const long base = row * d;
  for (int c = lane; c < d; c += 32) {
    float v = src[c];
    if (minus) v -= minus[base + c];
    out[base + c] = v;
  }
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

// nodes: f32[*, d]; ids: i64[n_rows]; minus: f32[n_rows, d] or null; out:
// f32[n_rows, d]. Returns cudaGetLastError().
int pdp_gather_2d(const float* nodes, int d, const int64_t* ids,
                  const float* minus, long n_rows, float* out,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_rows > 0 && d > 0) {
    const long blocks = (n_rows * 32 + PDP_THREADS - 1) / PDP_THREADS;
    gather_2d_kernel<<<(unsigned)blocks, PDP_THREADS, 0, st>>>(
        nodes, d, ids, minus, n_rows, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
