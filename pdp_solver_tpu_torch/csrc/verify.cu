// CNF verification, the freeze of solved instances and the next edge masks
// in one launch.
//
// Replaces the TPU kernel pdp_solver_tpu/ops/pallas_verify.py
// verify_and_masks (:170, body _build_verify :45, pallas_call :158). It
// computes the same function as the port's split path (train/loss.py
// cnf_evaluate -> active' = active * (solved <= 0.5) ->
// problem/state.py edge_masks_pair, i.e. chained_edge_pass[cnf_chain]
// then fused_edge_pass[em_ae]):
//   per instance b: max_sat = #real clauses with cm, got_sat = #those with
//   a literal satisfied under the prediction (sign * p + (1 - sign) / 2 >
//   0.5 on a live edge); solved = (max_sat == got_sat), unsat = max_sat -
//   got_sat, active'[b] = active[b] * (not solved);
//   per edge: em = av[var] * ac[clause] * edge_mask, ae = active'[instance
//   of the edge's variable].
// The TPU kernel's two-phase sequential grid, its bf16 one-hot products
// and its IWIN instance window are layout answers for the TPU and are not
// carried over.
//
// Design: a thread-block cluster of cs CTAs per instance (common.cuh). The
// masks of an instance's edges need its verdict, and the packed layout keeps
// an instance's clauses and edges contiguous (inst_clause_ptr, clause_ptr).
// Each CTA of the cluster counts its share of the instance's clauses: a
// clause's k edges on one thread, its literal sum in edge order as CnfChain
// takes it, and the em of those edges on the way (it needs no verdict, and
// the thread has just read their variables and masks, so the prediction and
// av are gathered side by side; staging the instance's predictions in shared
// memory first was 0.4-0.6 us slower on the H100, one more dependent step).
// The CTA reduces its two integer counts over the block and writes them into
// its slot of every CTA's table (distributed shared memory; no float
// atomics, and an integer sum has one value in any order). After the cluster
// barrier every CTA adds the table, rank 0 writes the verdict, and each CTA
// writes the ae of the edges of its clauses. Padding edges [e_real, e_total)
// belong to no instance: clusters after the instances' take
// PDP_VERIFY_PAD_CHUNK of them a CTA, and each such cluster counts the
// instance their variable belongs to (the last real one, by the packing
// contract; another instance is counted on the spot by one thread).
//
// Bound on the H100 at the shared-set shapes (E = 524,288 padded / 460,800
// real edges, V = 16,384, F = 131,072, B = 128): edge_var, sign and
// edge_mask read (6.3 MB; edge_clause only on padding edges), em and ae
// written (4.2 MB), the V- and F-length flags (~1.8 MB): ~12 MB, about 4 us
// at 3.35 TB/s, a few operations an edge. Bound by bytes; one CTA an
// instance walked ~3,600 edges a CTA through dependent gathers of p[var]
// (latency-bound: 24 us in p-nd-np's loop, where the inputs come from
// device memory); the cluster cuts each CTA's share by cs and fills the
// card with B * cs CTAs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define PDP_VERIFY_PAD_CHUNK 512

// One call's arguments, filled once per batch plan by ops/verify.py and
// passed by pointer (the field order matches its ctypes Structure); the
// kernel takes a copy by value. f32 inputs: pred[V] (the prediction's
// column), sign[E], edge_mask[E], av[V], ac[F], cm[F] (the real-clause
// flags), active[B]; i32 ev, ec [E], clause_ptr [F + 1], inst_clause_ptr
// [B + 1]; i64 var_batch [V]. Outputs: solved, unsat f32[B]; em, ae f32[E].
// n_inst: the instances launched, a prefix of the n_rows = B rows (the
// real ones); the rows after them, instances with no clause, are solved.
// cluster: CTAs an instance.
struct VerifyArgs {
  const float* pred;
  const float* sign;
  const float* edge_mask;
  const float* av;
  const float* ac;
  const float* cm;
  const float* active;
  const int* ev;
  const int* ec;
  const int* clause_ptr;
  const int* inst_clause_ptr;
  const long long* var_batch;
  float* solved;
  float* unsat;
  float* em;
  float* ae;
  int n_inst;
  int n_rows;
  int e_real;
  int e_total;
  int cluster;
  void* stream;
};

// clause c's literal sum (CnfChain f1/f2: the flags of its live literals
// summed in edge order); with EM also the em of its edges (EmAe's product:
// ec[e] is c on them)
template <bool EM>
__device__ __forceinline__ float clause_lits(const VerifyArgs& a, int c) {
  float s = 0.0f;
  const int e1 = a.clause_ptr[c + 1];
  const float ac = EM ? a.ac[c] : 0.0f;
  for (int e = a.clause_ptr[c]; e < e1; ++e) {
    const int v = a.ev[e];
    const float sign = a.sign[e], mask = a.edge_mask[e];
    const float lit = sign * a.pred[v] + (1.0f - sign) / 2.0f;
    s += flag(lit > 0.5f) * mask;
    if (EM) a.em[e] = a.av[v] * ac * mask;
  }
  return s;
}

// one thread's share of (max_sat, got_sat) over clauses [c, c1) strided by
// `step` (with EM, the em of their edges too)
template <bool EM>
__device__ __forceinline__ void count_clauses(const VerifyArgs& a, int c,
                                              int c1, int step, int* mx,
                                              int* got) {
  int m = 0, g = 0;
  for (; c < c1; c += step) {
    const float s = clause_lits<EM>(a, c);
    if (a.cm[c] != 0.0f) {
      ++m;
      g += s > 0.0f ? 1 : 0;
    }
  }
  *mx = m;
  *got = g;
}

// the block-wide sum of (mx, got); every thread gets the totals
__device__ __forceinline__ void block_counts(int* mx, int* got) {
  __shared__ int sh[2][PDP_THREADS / 32];
  int m = *mx, g = *got;
  for (int off = 16; off > 0; off >>= 1) {
    m += __shfl_down_sync(0xffffffffu, m, off);
    g += __shfl_down_sync(0xffffffffu, g, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sh[0][warp] = m;
    sh[1][warp] = g;
  }
  __syncthreads();
  m = g = 0;
  for (int w = 0; w < PDP_THREADS / 32; ++w) {
    m += sh[0][w];
    g += sh[1][w];
  }
  *mx = m;
  *got = g;
}

__global__ void __launch_bounds__(PDP_THREADS) verify_kernel(VerifyArgs a) {
  __shared__ int table[PDP_CLUSTER_MAX][2];  // each CTA's (mx, got)
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int q = (int)blockIdx.x / cs;  // the instance, or a padding cluster
  if (blockIdx.x == 0)
    for (int r = a.n_inst + (int)threadIdx.x; r < a.n_rows; r += PDP_THREADS) {
      a.solved[r] = 1.0f;
      a.unsat[r] = 0.0f;
    }
  // b: the instance counted; [ea, eb): the edges this CTA writes
  int b, ea, eb;
  const bool pad = q >= a.n_inst;  // every CTA of the cluster alike
  if (pad) {
    b = (int)a.var_batch[a.ev[a.e_real]];
    ea = a.e_real + ((q - a.n_inst) * cs + rank) * PDP_VERIFY_PAD_CHUNK;
    eb = min(a.e_total, ea + PDP_VERIFY_PAD_CHUNK);
  } else {
    b = q;
  }
  const int c0 = a.inst_clause_ptr[b], nc = a.inst_clause_ptr[b + 1] - c0;
  if (!pad && nc == 0) {  // an instance with no clause (a padding row)
    if (rank == 0 && threadIdx.x == 0) {
      a.solved[b] = 1.0f;
      a.unsat[b] = 0.0f;
    }
    return;
  }
  cluster_arrive_relaxed();
  const int ca = c0 + cluster_share(nc, rank, cs);
  const int cb = c0 + cluster_share(nc, rank + 1, cs);
  if (!pad) {
    ea = a.clause_ptr[ca];
    eb = a.clause_ptr[cb];
  }
  // the count, and the em of the instance's edges on the way (pad
  // clusters count the instance of their edges and write the em of their
  // own edges below)
  int mx, got;
  if (pad)
    count_clauses<false>(a, ca + (int)threadIdx.x, cb, PDP_THREADS, &mx,
                         &got);
  else
    count_clauses<true>(a, ca + (int)threadIdx.x, cb, PDP_THREADS, &mx,
                        &got);
  block_counts(&mx, &got);
  cluster_wait();
  if (threadIdx.x < cs) {
    int* slot = cluster.map_shared_rank(&table[rank][0], threadIdx.x);
    slot[0] = mx;
    slot[1] = got;
  }
  cluster_arrive();
  if (pad) {  // em needs no verdict: written before the wait
    for (int e = ea + (int)threadIdx.x; e < eb; e += PDP_THREADS)
      a.em[e] = a.av[a.ev[e]] * a.ac[a.ec[e]] * a.edge_mask[e];
  }
  cluster_wait();
  mx = got = 0;
  for (int r = 0; r < cs; ++r) {
    mx += table[r][0];
    got += table[r][1];
  }
  if (!pad && rank == 0 && threadIdx.x == 0) {
    a.solved[b] = flag(mx == got);
    a.unsat[b] = (float)(mx - got);
  }
  const float act = a.active[b] * flag(mx != got);
  if (!pad) {
    for (int e = ea + (int)threadIdx.x; e < eb; e += PDP_THREADS)
      a.ae[e] = act;
    return;
  }
  const int v_last = a.ev[a.e_real];
  for (int e = ea + (int)threadIdx.x; e < eb; e += PDP_THREADS) {
    const int v = a.ev[e];
    float ae = act;
    const int b2 = v == v_last ? b : (int)a.var_batch[v];
    if (b2 != b) {
      int m, g;
      count_clauses<false>(a, a.inst_clause_ptr[b2],
                           a.inst_clause_ptr[b2 + 1], 1, &m, &g);
      ae = a.active[b2] * flag(m != g);
    }
    a.ae[e] = ae;
  }
}

extern "C" {

// One call. Returns the launch's error, or -1 for a cluster that is not a
// power of two from 1 to PDP_CLUSTER_MAX.
int pdp_verify_and_masks(const VerifyArgs* a) {
  const int cs = a->cluster;
  if (cs < 1 || cs > PDP_CLUSTER_MAX || (cs & (cs - 1))) return -1;
  const int n_pad = (a->e_total - a->e_real + PDP_VERIFY_PAD_CHUNK - 1) /
                    PDP_VERIFY_PAD_CHUNK;
  const int n_clusters = a->n_inst + (n_pad + cs - 1) / cs;
  if (n_clusters > 0) {
    const cudaError_t err =
        launch_clusters(&verify_kernel, n_clusters, cs, 0,
                        static_cast<cudaStream_t>(a->stream), *a);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
