// Multi-column segment sum over a CSR of each node's edges.
//
// One kernel computes the functions of three TPU kernels:
//   pdp_solver_tpu/ops/pallas_reduce.py windowed_segment_sum_cols (:224) and
//     its [E, C] form windowed_segment_sum (:240) (body _make_kernel :45,
//     pallas_call :91): C f32[E] columns -> f32[C, N] sums, ids that meet
//     the pack-time window invariant;
//   pdp_solver_tpu/ops/pallas_reduce.py windowed_segment_sum_cols_based
//     (:209, body _make_based_kernel :122, pallas_call :172): the same sum
//     for batches that fail the invariant, with host-chosen window bases
//     and a residual scatter for the edges outside them;
//   pdp_solver_tpu/ops/pallas_segment.py sorted_segment_sum (:120, body
//     _kernel :40, pallas_call :83): C = 1 over sorted ids.
// The TPU kernels contract a [TILE, WINDOW] one-hot on the matrix unit and
// keep the whole [C, N] output in VMEM; the window invariant, the bases and
// the residual scatter exist only to make that one-hot fit. None of it is
// carried over: here each node's edges are listed by a CSR built at pack
// time (FGBatch.var_ptr/var_perm for variables, clause_ptr for clauses) or
// from the sorted ids, which needs no invariant, so every batch takes the
// same kernel.
//
// pdp_segment_sum_cols: out[c, n] = sum over j in [ptr[n], ptr[n+1]) of
//   col_c[e_j * stride] with e_j = perm[j] (or j when perm is null), for
//   c < C <= 8. One thread per node walks its CSR slice in increasing edge
//   order and keeps the C sums in registers: each sum has one fixed order
//   and no float atomics, so the result does not change from run to run.
//   The columns are C separate f32[E] arrays (stride 1) or the C columns of
//   one row-major f32[E, C] array (col_c = base + c, stride C). Edges
//   outside the CSR (the padding edges) take part in no sum; nodes with no
//   edges get 0.
//
// Bound on the H100 at the shared-set shapes (E = 524,288 padded / 460,800
// real edges, V = 16,384): C = 2 reads 3.7 MB of columns, 1.8 MB of
// var_perm and 66 KB of ptr and writes 131 KB, about 1.7 us at 3.35 TB/s;
// one add per element. That is far below a launch's cost, so the kernel is
// bound by latency: the launch and each thread's chain of ~28 dependent
// gathers. One thread per node (rather than reduce2d.cu's warp per node,
// which would leave 30 of 32 lanes idle at C = 2) keeps 16,384 threads in
// flight.

#include <cuda_runtime.h>

#include "common.cuh"

#define PDP_RED_MAXC 8

struct ColPtrs {
  const float* c[PDP_RED_MAXC];
};

template <int C>
__global__ void segment_sum_cols_kernel(ColPtrs x, long stride,
                                        const int* __restrict__ ptr,
                                        const int* __restrict__ perm,
                                        int n_seg, float* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_seg) return;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  const int j1 = ptr[n + 1];
  for (int j = ptr[n]; j < j1; ++j) {
    const long e = (perm ? perm[j] : j) * stride;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] += x.c[c][e];
  }
#pragma unroll
  for (int c = 0; c < C; ++c) out[(size_t)c * n_seg + n] = acc[c];
}

extern "C" {

// cols: n_cols (1..8) column base pointers, column c's edge e at
// cols[c][e * stride]; ptr: i32[n_seg + 1]; perm: i32[ptr[n_seg]] or null;
// out: f32[n_cols, n_seg]. Returns cudaGetLastError(), or -1 for n_cols
// outside 1..8.
int pdp_segment_sum_cols(const void* const* cols, int n_cols, long stride,
                         const int* ptr, const int* perm, int n_seg,
                         float* out, void* stream) {
  if (n_cols < 1 || n_cols > PDP_RED_MAXC) return -1;
  ColPtrs x;
  for (int c = 0; c < PDP_RED_MAXC; ++c)
    x.c[c] = static_cast<const float*>(cols[c < n_cols ? c : 0]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_seg > 0) {
    const int blocks = (n_seg + PDP_THREADS - 1) / PDP_THREADS;
    switch (n_cols) {
#define PDP_RED_CASE(C)                                              \
  case C:                                                            \
    segment_sum_cols_kernel<C><<<blocks, PDP_THREADS, 0, st>>>(      \
        x, stride, ptr, perm, n_seg, out);                           \
    break;
      PDP_RED_CASE(1) PDP_RED_CASE(2) PDP_RED_CASE(3) PDP_RED_CASE(4)
      PDP_RED_CASE(5) PDP_RED_CASE(6) PDP_RED_CASE(7) PDP_RED_CASE(8)
#undef PDP_RED_CASE
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
