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
// Design: one CTA per instance. The masks of an instance's edges need its
// verdict, and the packed layout keeps an instance's clauses and edges
// contiguous (inst_clause_ptr, clause_ptr), so one CTA counts its clauses
// (a clause's k edges on one thread, the clause's literal sum in edge
// order as CnfChain takes it), reduces the two integer counts over the
// block (no float atomics; an integer sum has one value in any order),
// syncs, and writes its edges' masks. Padding edges [e_real, e_total)
// belong to no instance: CTAs after the instances take
// PDP_VERIFY_PAD_CHUNK of them each and recompute the verdict of the
// instance their variable belongs to (the last real one, by the packing
// contract; another instance is counted on the spot by one thread).
//
// Bound on the H100 at the shared-set shapes (E = 524,288 padded / 460,800
// real edges, V = 16,384, F = 131,072, B = 128): edge_var, edge_clause,
// sign and edge_mask read (8.4 MB; edge_clause only for em), em and ae
// written (4.2 MB), the V- and F-length flags (~1.8 MB): ~12-14 MB, about
// 4 us at 3.35 TB/s, a few operations an edge. Bound by bytes; 128 CTAs
// walking ~3,600 edges each through dependent gathers of p[var] make it
// latency-bound in practice, as the SP sweep is.

#include <cuda_runtime.h>

#include "common.cuh"

#define PDP_VERIFY_PAD_CHUNK 4096

struct VerifyArgs {
  const float *pred, *sign, *edge_mask, *av, *ac, *cm, *active;
  const int* ev;                // edge -> variable
  const int* ec;                // edge -> clause
  const int* clause_ptr;        // [F + 1]
  const int* inst_clause_ptr;   // [B + 1]
  const long long* var_batch;   // [V] variable -> instance
  float *solved, *unsat, *em, *ae;
  int n_inst, e_real, e_total;
};

// 1 if clause c is satisfied under the prediction (CnfChain f1/f2: the
// flags of its live literals summed in edge order, then > 0)
__device__ __forceinline__ bool clause_sat(const VerifyArgs& a, int c) {
  float s = 0.0f;
  const int e1 = a.clause_ptr[c + 1];
  for (int e = a.clause_ptr[c]; e < e1; ++e) {
    const float sign = a.sign[e];
    const float lit = sign * a.pred[a.ev[e]] + (1.0f - sign) / 2.0f;
    s += flag(lit > 0.5f) * a.edge_mask[e];
  }
  return s > 0.0f;
}

// one thread's share of instance b's (max_sat, got_sat), clauses strided
// by `step` from `first`
__device__ __forceinline__ void count_clauses(const VerifyArgs& a, int b,
                                              int first, int step, int* mx,
                                              int* got) {
  int m = 0, g = 0;
  const int c1 = a.inst_clause_ptr[b + 1];
  for (int c = a.inst_clause_ptr[b] + first; c < c1; c += step) {
    if (a.cm[c] != 0.0f) {
      ++m;
      g += clause_sat(a, c) ? 1 : 0;
    }
  }
  *mx = m;
  *got = g;
}

// instance b's new active flag from its counts (its verdict written by the
// instance's own CTA only)
__device__ __forceinline__ float frozen_flag(const VerifyArgs& a, int b,
                                             int mx, int got) {
  return a.active[b] * flag(mx != got);
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
  for (int w = 0; w < (int)(blockDim.x / 32); ++w) {
    m += sh[0][w];
    g += sh[1][w];
  }
  *mx = m;
  *got = g;
}

__device__ __forceinline__ void write_em(const VerifyArgs& a, int e) {
  a.em[e] = a.av[a.ev[e]] * a.ac[a.ec[e]] * a.edge_mask[e];
}

__global__ void verify_kernel(VerifyArgs a) {
  const int tid = threadIdx.x, nt = blockDim.x;
  int mx, got;
  if ((int)blockIdx.x < a.n_inst) {
    const int b = blockIdx.x;
    count_clauses(a, b, tid, nt, &mx, &got);
    block_counts(&mx, &got);
    if (tid == 0) {
      a.solved[b] = flag(mx == got);
      a.unsat[b] = (float)(mx - got);
    }
    const float act = frozen_flag(a, b, mx, got);
    const int c0 = a.inst_clause_ptr[b], c1 = a.inst_clause_ptr[b + 1];
    const int e1 = a.clause_ptr[c1];
    for (int e = a.clause_ptr[c0] + tid; e < e1; e += nt) {
      write_em(a, e);
      a.ae[e] = act;
    }
    return;
  }
  // padding edges: the verdict of the instance of their variable
  const int e0 =
      a.e_real + ((int)blockIdx.x - a.n_inst) * PDP_VERIFY_PAD_CHUNK;
  const int e1 = min(a.e_total, e0 + PDP_VERIFY_PAD_CHUNK);
  const int b_last = (int)a.var_batch[a.ev[a.e_real]];
  count_clauses(a, b_last, tid, nt, &mx, &got);
  block_counts(&mx, &got);
  const float act_last = frozen_flag(a, b_last, mx, got);
  for (int e = e0 + tid; e < e1; e += nt) {
    write_em(a, e);
    const int b = (int)a.var_batch[a.ev[e]];
    float act = act_last;
    if (b != b_last) {
      int m, g;
      count_clauses(a, b, 0, 1, &m, &g);
      act = frozen_flag(a, b, m, g);
    }
    a.ae[e] = act;
  }
}

extern "C" {

// f32 inputs: pred[V] (the prediction's column), sign[E], edge_mask[E],
// av[V], ac[F], cm[F] (the real-clause flags), active[B]; i32 ev, ec [E],
// clause_ptr [F + 1], inst_clause_ptr [B + 1]; i64 var_batch [V]. Outputs:
// solved, unsat f32[B]; em, ae f32[E]. Returns cudaGetLastError().
int pdp_verify_and_masks(const float* pred, const float* sign,
                         const float* edge_mask, const float* av,
                         const float* ac, const float* cm,
                         const float* active, const int* ev, const int* ec,
                         const int* clause_ptr, const int* inst_clause_ptr,
                         const long long* var_batch, float* solved,
                         float* unsat, float* em, float* ae, int n_inst,
                         int e_real, int e_total, void* stream) {
  VerifyArgs a;
  a.pred = pred;
  a.sign = sign;
  a.edge_mask = edge_mask;
  a.av = av;
  a.ac = ac;
  a.cm = cm;
  a.active = active;
  a.ev = ev;
  a.ec = ec;
  a.clause_ptr = clause_ptr;
  a.inst_clause_ptr = inst_clause_ptr;
  a.var_batch = var_batch;
  a.solved = solved;
  a.unsat = unsat;
  a.em = em;
  a.ae = ae;
  a.n_inst = n_inst;
  a.e_real = e_real;
  a.e_total = e_total;
  const int n_pad = e_real < e_total
                        ? (e_total - e_real + PDP_VERIFY_PAD_CHUNK - 1) /
                              PDP_VERIFY_PAD_CHUNK
                        : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_inst + n_pad > 0)
    verify_kernel<<<n_inst + n_pad, PDP_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
