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
// time (FGBatch.var_ptr/var_perm for variables, clause_ptr for clauses), or
// found in the sorted ids by binary search in the same launch, which needs
// no invariant, so every batch takes the same kernel.
//
// pdp_segment_sum_cols: out[c, n] = sum over the slots j of node n of
//   col_c[e_j * stride] with e_j = perm[j] (or j when perm is null), for
//   c < C <= 8. The columns are C separate f32[E] arrays (stride 1) or the C
//   columns of one row-major f32[E, C] array (col_c = base + c, stride C).
//   Edges outside the CSR (the padding edges) take part in no sum; nodes
//   with no edges get 0. With sorted ids (C = 1, no perm) node n's slots
//   are the run of ids equal to n, and ids outside [0, N) are dropped.
//
// The work is split by the group walk of common.cuh: G lanes per node (G
// from the mean degree, chosen by the caller), and a node of
// PDP_HEAVY_ITERS * G edges or more split among blocks of 256 threads.
// Each sum has one fixed order and no float atomics, so the result is the
// same from run to run.
//
// Bound on the H100 at the shared-set shapes (E = 524,288 padded / 460,800
// real edges, V = 16,384): C = 2 reads 3.7 MB of columns, 1.8 MB of
// var_perm and 66 KB of ptr and writes 131 KB, about 1.7 us at 3.35 TB/s;
// one add per element. The time goes to latency: the launch, and the chain
// perm[j] -> col[perm[j]] of gathers. One thread a node would leave 64 CTAs
// on 132 SMs, each thread walking ~28 gathers; G = 8 lanes a node put 512
// CTAs in flight with ~4 gathers a lane, and a node of 63,488 edges is cut
// among 16 to 124 blocks.

#include <cuda_runtime.h>

#include "common.cuh"

#define PDP_RED_MAXC 8

// One launch's arguments, filled once per plan by ops/reduce.py and
// passed by pointer (the field order matches its ctypes Structure).
struct SegSumArgs {
  const void* cols[PDP_RED_MAXC];  // column base pointers
  int n_cols;
  int sorted;      // 1: segments are runs of sorted ids (ptr unused)
  long stride;     // column c's edge e at cols[c][e * stride]
  const int* ptr;  // i32[n_seg + 1]
  const int* perm;  // i32[ptr[n_seg]] or null
  const void* ids;  // edge -> node, i32 or i64
  int ids64;
  int n_seg;
  int n_slots;  // ptr[n_seg] for a CSR; the number of ids when sorted
  int group;    // lanes a node, a power of two from 4 to 32
  int heavy;    // 1: a node may hold PDP_HEAVY_ITERS * group slots or more
  float* out;   // f32[n_cols, n_seg]
  float* partials;  // the walk's scratch (common.cuh WalkPlan), with heavy
  int* counters;
  void* stream;
};

struct ColPtrs {
  const float* c[PDP_RED_MAXC];
};

template <int C>
struct ColTerm {
  ColPtrs x;
  long stride;
  __device__ __forceinline__ void operator()(int e, float* r) const {
    const long o = (long)e * stride;
#pragma unroll
    for (int c = 0; c < C; ++c) r[c] = x.c[c][o];
  }
};

template <int C, class Seg>
__global__ void segment_sum_cols_kernel(WalkPlan p, Seg seg, ColTerm<C> term,
                                        SegOut store) {
  walk_block<C>(p, seg, term, store);
}

template <int C, class Seg>
static void launch_cols(const WalkPlan& p, const Seg& seg, const ColPtrs& x,
                        long stride, float* out, cudaStream_t st) {
  const int blocks = p.group_blocks + p.anchor_blocks;
  segment_sum_cols_kernel<C, Seg><<<blocks, PDP_THREADS, 0, st>>>(
      p, seg, ColTerm<C>{x, stride}, SegOut{out, p.n_seg});
}

template <class Seg>
static int launch_any(int n_cols, const WalkPlan& p, const Seg& seg,
                      const ColPtrs& x, long stride, float* out,
                      cudaStream_t st) {
  switch (n_cols) {
#define PDP_RED_CASE(C)                               \
  case C:                                             \
    launch_cols<C>(p, seg, x, stride, out, st);       \
    break;
    PDP_RED_CASE(1) PDP_RED_CASE(2) PDP_RED_CASE(3) PDP_RED_CASE(4)
    PDP_RED_CASE(5) PDP_RED_CASE(6) PDP_RED_CASE(7) PDP_RED_CASE(8)
#undef PDP_RED_CASE
    default:
      return -1;
  }
  return 0;
}

extern "C" {

// Returns cudaGetLastError(), or -1 for n_cols outside 1..8 (1 when
// sorted), a group width that is not a power of two from 4 to 32, a
// missing id array, or heavy without scratch.
int pdp_segment_sum_cols(const SegSumArgs* a) {
  if (a->n_cols < 1 || a->n_cols > PDP_RED_MAXC || !a->ids) return -1;
  if (a->sorted && a->n_cols != 1) return -1;
  WalkPlan p;
  if (!make_walk_plan(a->n_seg, a->n_slots, a->group, a->heavy != 0,
                      a->partials, a->counters, &p))
    return -1;
  ColPtrs x;
  for (int c = 0; c < PDP_RED_MAXC; ++c)
    x.c[c] = static_cast<const float*>(a->cols[c < a->n_cols ? c : 0]);
  cudaStream_t st = static_cast<cudaStream_t>(a->stream);
  if (a->n_seg <= 0) return (int)cudaGetLastError();
  int rc;
  if (a->sorted) {
    if (a->ids64) {
      SortedSeg<long long> seg{static_cast<const long long*>(a->ids),
                               a->n_slots};
      launch_cols<1>(p, seg, x, a->stride, a->out, st);
    } else {
      SortedSeg<int> seg{static_cast<const int*>(a->ids), a->n_slots};
      launch_cols<1>(p, seg, x, a->stride, a->out, st);
    }
    rc = 0;
  } else if (a->ids64) {
    CsrSeg<long long> seg{a->ptr, a->perm,
                          static_cast<const long long*>(a->ids)};
    rc = launch_any(a->n_cols, p, seg, x, a->stride, a->out, st);
  } else {
    CsrSeg<int> seg{a->ptr, a->perm, static_cast<const int*>(a->ids)};
    rc = launch_any(a->n_cols, p, seg, x, a->stride, a->out, st);
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
