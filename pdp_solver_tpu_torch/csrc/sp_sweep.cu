// The whole Survey Propagation sweep in one launch (pi >= 0).
//
// Replaces the TPU kernel pdp_solver_tpu/ops/pallas_sp.py sp_full_sweep
// (:166, body _build_sp_sweep :51, pallas_call :152), for login=False
// (plain SP) and login=True (p-nd-np's adaptors hand over u already in log
// space; a compile-time flag of the same kernel, sp_log_u<LOGIN> in
// common.cuh). It computes the same function: the clause-direction log-u
// sums and the eta surveys, and the var-direction polarity-split sums of
// log(1 - eta_in) and the (q_u, q_s, q_dc) triplet with the REINFORCE
// force factor pi.
// The TPU kernel runs a two-phase sequential grid over edge tiles, with
// one-hot windows on the matrix unit and a [2, N] VMEM scratch carried
// from the first phase to the second. None of that is carried over.
//
// Design: one CTA per instance. The packed layout keeps an instance's
// clauses, edges and variables contiguous (inst_clause_ptr, inst_var_ptr,
// clause_ptr; var_ptr/var_perm list each variable's edges), so an
// instance's sweep needs nothing outside its CTA: no grid-wide sync and no
// atomics.
//   1. Threads over the instance's clauses: each sums its clause's log u
//      over the clause's k edges (thread-local, in edge order) and writes
//      the new eta of those edges. Then the polarity-split sums of
//      log(1 - eta_in) * em of the instance's variables, to shared memory,
//      in the order of the group walk (common.cuh walk_block) with the
//      chained pass's G: a group of G lanes a variable, 256 / G variables
//      at a time, lane l taking the variable's slots l, l + G, ... and a
//      xor butterfly over the group; then every variable of S =
//      PDP_HEAVY_ITERS * G slots or more piece by piece, one piece for
//      each multiple of S inside it in increasing order, the whole CTA on
//      a piece as one anchored block of the walk takes it (thread t its
//      slots t, t + 256, ..., a butterfly in each warp, the warp totals in
//      warp order) and the pieces added in order. Both read the input eta
//      only.
//   2. __syncthreads(), then threads over the instance's edges compute the
//      q-triplet from their variable's two sums.
// Each sum is taken in the same order, with the same operations (the
// sp_* helpers of common.cuh), as the two-launch path (edge_pass.cu
// chained_clause_kernel / chained_var_kernel with SpChain or SpChainLogin,
// then SpPassC), so the two give the same bits.
// The two sums of an instance's variables take 8 bytes a variable of
// shared memory; when the caller passes a global scratch f32[2, V] (it
// does above 6,144 variables per instance, 48 KB) they go there instead,
// still inside the one CTA (L2-resident, slower). One CTA per instance
// also means a batch of few large instances runs on few SMs: B instances
// keep at most B of the 132 SMs busy.
// Padding edges [e_real, e_total) belong to no instance. They still get
// their outputs, as in the two-launch path: CTAs after the instances take
// PDP_SWEEP_PAD_CHUNK of them each, recompute the clause sum and the
// variable sums their edges point at (the last real clause and variable,
// by the packing contract: the CTA sums that variable as an instance's CTA
// does; any other id is summed on the spot, one thread repeating the
// walk's order lane by lane), and apply the same per-edge formulas.
//
// Bound on the H100 at the shared-set shapes (E = 524,288 padded / 460,800
// real edges, V = 16,384, F = 131,072, B = 128): the 10 f32[E] inputs
// (21 MB), edge_var (2.1 MB), var_perm (1.8 MB) and the CSR offsets, and
// the 4 f32[E] outputs (8.4 MB): ~33 MB, about 10 us at 3.35 TB/s, with
// ~40 flops an edge. Bound by bytes. 128 CTAs on 132 SMs, each walking
// ~3,600 edges with 256 threads, make it latency-bound in practice: the
// dependent gathers of the var walks and the 14 edges a thread handles.

#include <cuda_runtime.h>

#include "common.cuh"

#define PDP_SWEEP_PAD_CHUNK 4096

struct SweepArgs {
  const float *u, *eta_in, *em, *mask, *eta_state, *sign, *force, *v0, *v1,
      *v2;
  float *eta_out, *nv0, *nv1, *nv2;
  const int* ev;               // edge -> variable
  const int* ec;               // edge -> clause
  const int* clause_ptr;       // [F + 1]
  const int* var_ptr;          // [V + 1]
  const int* var_perm;         // [e_real]
  const int* inst_clause_ptr;  // [B + 1]
  const int* inst_var_ptr;     // [B + 1]
  float* scratch;              // f32[2, V], or null when sums fit in smem
  int n_inst, n_vars, e_real, e_total;
  int g_shift;                 // log2 G, the chained pass's var walk
  int heavy;                   // 1: a variable may hold S slots or more
  float pi;
};

template <bool LOGIN>
__device__ __forceinline__ float clause_log_u_sum(const SweepArgs& a,
                                                  int c) {
  float s = 0.0f;
  const int e1 = a.clause_ptr[c + 1];
  for (int e = a.clause_ptr[c]; e < e1; ++e)
    s += sp_log_u<LOGIN>(a.u[e], a.em[e]);
  return s;
}

// edge e's two terms of its variable's polarity sums (SpChainOps::f3's)
__device__ __forceinline__ void lm_terms(const SweepArgs& a, int e, float& p,
                                         float& n) {
  const float lm = sp_lm(a.eta_in[e], a.em[e]);
  const float sign = a.sign[e];
  p = lm * flag(sign == 1.0f);
  n = lm * flag(sign == -1.0f);
}

// the polarity sums of the instance's nv variables from vb, in the walk's
// order (see the top of the file); every thread of the CTA calls it
__device__ void cta_var_sums(const SweepArgs& a, int vb, int nv, float* pos,
                             float* neg) {
  __shared__ float warp_p[PDP_THREADS / 32], warp_n[PDP_THREADS / 32];
  const int tid = threadIdx.x, gs = a.g_shift, G = 1 << gs;
  const int S = PDP_HEAVY_ITERS << gs;
  const int heavy_min = a.heavy ? S : 0x7fffffff;  // as common.cuh's plan
  const int lane = tid & (G - 1);
  for (int base = 0; base < nv; base += (int)blockDim.x >> gs) {
    const int i = base + (tid >> gs);
    float p = 0.0f, n = 0.0f, tp, tn;
    bool mine = false;
    if (i < nv) {
      const int lo = a.var_ptr[vb + i], hi = a.var_ptr[vb + i + 1];
      mine = hi - lo < heavy_min;
      if (mine) {
#pragma unroll 4
        for (int j = lo + lane; j < hi; j += G) {
          lm_terms(a, a.var_perm[j], tp, tn);
          p += tp;
          n += tn;
        }
      }
    }
    for (int off = G >> 1; off > 0; off >>= 1) {
      p += __shfl_xor_sync(PDP_FULL_MASK, p, off);
      n += __shfl_xor_sync(PDP_FULL_MASK, n, off);
    }
    if (mine && lane == 0) {
      pos[i] = p;
      neg[i] = n;
    }
  }
  // the heavy variables: the multiples of S in the instance's slots, in
  // order; every thread decides alike
  if (!a.heavy) return;
  const int s0 = a.var_ptr[vb], s1 = a.var_ptr[vb + nv];
  float run_p = 0.0f, run_n = 0.0f;  // thread 0's sums of a variable's pieces
  for (int s = (s0 + S - 1) / S * S; s < s1; s += S) {
    const int v = a.ev[a.var_perm[s]];
    const int lo = a.var_ptr[v], hi = a.var_ptr[v + 1];
    if (hi - lo < S) continue;
    const int a0 = (lo + S - 1) / S, a1 = (hi - 1) / S, k = s / S;
    float p = 0.0f, n = 0.0f, tp, tn;
#pragma unroll 8
    for (int j = (k == a0 ? lo : s) + tid; j < min(s + S, hi);
         j += blockDim.x) {
      lm_terms(a, a.var_perm[j], tp, tn);
      p += tp;
      n += tn;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      p += __shfl_xor_sync(PDP_FULL_MASK, p, off);
      n += __shfl_xor_sync(PDP_FULL_MASK, n, off);
    }
    if ((tid & 31) == 0) {
      warp_p[tid >> 5] = p;
      warp_n[tid >> 5] = n;
    }
    __syncthreads();
    if (tid == 0) {
      p = warp_p[0];
      n = warp_n[0];
      for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
        p += warp_p[w];
        n += warp_n[w];
      }
      run_p = k == a0 ? p : run_p + p;
      run_n = k == a0 ? n : run_n + n;
      if (k == a1) {
        pos[v - vb] = run_p;
        neg[v - vb] = run_n;
      }
    }
    __syncthreads();
  }
}

// a xor butterfly over x[0, width) taken by one thread: each step gives
// lanes l and l ^ off the sum x[l] + x[l ^ off], as the shuffles do
__device__ __forceinline__ void serial_butterfly(float* x, int width) {
  for (int off = width >> 1; off > 0; off >>= 1)
    for (int l = 0; l < width; ++l)
      if (!(l & off)) x[l] = x[l | off] = x[l] + x[l | off];
}

// one thread: variable v's polarity sums in the walk's order (a padding
// edge of another variable than the last real one), lane by lane and piece
// by piece as cta_var_sums takes them
__device__ void var_lm_sums(const SweepArgs& a, int v, float* pos,
                            float* neg) {
  const int G = 1 << a.g_shift, S = PDP_HEAVY_ITERS << a.g_shift;
  const int lo = a.var_ptr[v], hi = a.var_ptr[v + 1];
  float p[32], n[32], tp, tn;
  if (!a.heavy || hi - lo < S) {
    for (int l = 0; l < G; ++l) {
      p[l] = n[l] = 0.0f;
      for (int j = lo + l; j < hi; j += G) {
        lm_terms(a, a.var_perm[j], tp, tn);
        p[l] += tp;
        n[l] += tn;
      }
    }
    serial_butterfly(p, G);
    serial_butterfly(n, G);
    *pos = p[0];
    *neg = n[0];
    return;
  }
  const int a0 = (lo + S - 1) / S, a1 = (hi - 1) / S;
  float run_p = 0.0f, run_n = 0.0f;
  for (int k = a0; k <= a1; ++k) {
    const int j0 = k == a0 ? lo : k * S, j1 = min(k * S + S, hi);
    float piece_p = 0.0f, piece_n = 0.0f;
    for (int w = 0; w < PDP_THREADS / 32; ++w) {
      for (int l = 0; l < 32; ++l) {
        p[l] = n[l] = 0.0f;
        for (int j = j0 + w * 32 + l; j < j1; j += PDP_THREADS) {
          lm_terms(a, a.var_perm[j], tp, tn);
          p[l] += tp;
          n[l] += tn;
        }
      }
      serial_butterfly(p, 32);
      serial_butterfly(n, 32);
      piece_p = w == 0 ? p[0] : piece_p + p[0];
      piece_n = w == 0 ? n[0] : piece_n + n[0];
    }
    run_p = k == a0 ? piece_p : run_p + piece_p;
    run_n = k == a0 ? piece_n : run_n + piece_n;
  }
  *pos = run_p;
  *neg = run_n;
}

template <bool LOGIN>
__device__ __forceinline__ void edge_outputs(const SweepArgs& a, int e,
                                             float cl, float pos,
                                             float neg) {
  const float mask = a.mask[e];
  a.eta_out[e] = sp_new_eta(cl, sp_log_u<LOGIN>(a.u[e], a.em[e]), mask,
                            a.eta_state[e]);
  float o[3];
  sp_q_triplet(pos, neg, a.eta_in[e], a.em[e], mask, a.sign[e], a.force[e],
               a.pi, a.v0[e], a.v1[e], a.v2[e], o);
  a.nv0[e] = o[0];
  a.nv1[e] = o[1];
  a.nv2[e] = o[2];
}

template <bool LOGIN>
__global__ void sp_sweep_kernel(SweepArgs a) {
  extern __shared__ float sh[];
  const int tid = threadIdx.x, nt = blockDim.x;
  if ((int)blockIdx.x < a.n_inst) {
    const int b = blockIdx.x;
    const int c0 = a.inst_clause_ptr[b], c1 = a.inst_clause_ptr[b + 1];
    const int vb = a.inst_var_ptr[b], nv = a.inst_var_ptr[b + 1] - vb;
    if (c0 == c1 && nv == 0) return;  // an empty (padding) instance
    float* pos = a.scratch ? a.scratch + vb : sh;
    float* neg = a.scratch ? a.scratch + a.n_vars + vb : sh + nv;
    // phase 1: the clause sums and eta; the variables' polarity sums
    for (int c = c0 + tid; c < c1; c += nt) {
      const float cl = clause_log_u_sum<LOGIN>(a, c);
      const int e1 = a.clause_ptr[c + 1];
      for (int e = a.clause_ptr[c]; e < e1; ++e)
        a.eta_out[e] = sp_new_eta(cl, sp_log_u<LOGIN>(a.u[e], a.em[e]),
                                  a.mask[e], a.eta_state[e]);
    }
    cta_var_sums(a, vb, nv, pos, neg);
    __syncthreads();
    // phase 2: the q-triplet of every edge of the instance
    const int e1 = a.clause_ptr[c1];
    for (int e = a.clause_ptr[c0] + tid; e < e1; e += nt) {
      const int i = a.ev[e] - vb;
      float o[3];
      sp_q_triplet(pos[i], neg[i], a.eta_in[e], a.em[e], a.mask[e],
                   a.sign[e], a.force[e], a.pi, a.v0[e], a.v1[e], a.v2[e],
                   o);
      a.nv0[e] = o[0];
      a.nv1[e] = o[1];
      a.nv2[e] = o[2];
    }
    return;
  }
  // padding edges
  const int e0 = a.e_real + ((int)blockIdx.x - a.n_inst) * PDP_SWEEP_PAD_CHUNK;
  const int e1 = min(a.e_total, e0 + PDP_SWEEP_PAD_CHUNK);
  const int c_last = a.ec[a.e_real], v_last = a.ev[a.e_real];
  cta_var_sums(a, v_last, 1, sh + 1, sh + 2);
  if (tid == 0) sh[0] = clause_log_u_sum<LOGIN>(a, c_last);
  __syncthreads();
  for (int e = e0 + tid; e < e1; e += nt) {
    const int c = a.ec[e], v = a.ev[e];
    float cl = sh[0], pos = sh[1], neg = sh[2];
    if (c != c_last) cl = clause_log_u_sum<LOGIN>(a, c);
    if (v != v_last) var_lm_sums(a, v, &pos, &neg);
    edge_outputs<LOGIN>(a, e, cl, pos, neg);
  }
}

extern "C" {

// cols: the 10 f32[E] inputs u, eta_in, em, mask, eta_state, sign, force,
// v0, v1, v2; outs: the 4 f32[E] outputs eta, nv0, nv1, nv2. ev, ec:
// i32[E]; the CSR tables as in FGBatch. scratch: f32[2, n_vars] for the
// variables' sums, or null to keep them in 8 * max_inst_vars bytes of
// shared memory. group: G of the chained pass's var walk (a power of two
// from 4 to 32), whose order the variable sums take; heavy: a variable
// may hold PDP_HEAVY_ITERS * G edges or more (else no CTA looks for one).
// login: u holds log u (p-nd-np's adaptors). Returns cudaGetLastError(),
// or -1 for a group that is not such a power of two.
int pdp_sp_sweep(const void* const* cols, float* const* outs, const int* ev,
                 const int* ec, const int* clause_ptr, const int* var_ptr,
                 const int* var_perm, const int* inst_clause_ptr,
                 const int* inst_var_ptr, int n_inst, int n_vars,
                 int max_inst_vars, int e_real, int e_total, float* scratch,
                 int group, int heavy, float pi, int login, void* stream) {
  int shift = 2;
  while (shift < 5 && (1 << shift) < group) ++shift;
  if ((1 << shift) != group) return -1;
  SweepArgs a;
  a.g_shift = shift;
  a.heavy = heavy;
  const float* const* in = reinterpret_cast<const float* const*>(cols);
  a.u = in[0];
  a.eta_in = in[1];
  a.em = in[2];
  a.mask = in[3];
  a.eta_state = in[4];
  a.sign = in[5];
  a.force = in[6];
  a.v0 = in[7];
  a.v1 = in[8];
  a.v2 = in[9];
  a.eta_out = outs[0];
  a.nv0 = outs[1];
  a.nv1 = outs[2];
  a.nv2 = outs[3];
  a.ev = ev;
  a.ec = ec;
  a.clause_ptr = clause_ptr;
  a.var_ptr = var_ptr;
  a.var_perm = var_perm;
  a.inst_clause_ptr = inst_clause_ptr;
  a.inst_var_ptr = inst_var_ptr;
  const bool in_smem = scratch == nullptr;
  a.scratch = scratch;
  a.n_inst = n_inst;
  a.n_vars = n_vars;
  a.e_real = e_real;
  a.e_total = e_total;
  a.pi = pi;
  const int n_pad = e_real < e_total
                        ? (e_total - e_real + PDP_SWEEP_PAD_CHUNK - 1) /
                              PDP_SWEEP_PAD_CHUNK
                        : 0;
  const size_t smem =
      (size_t)(in_smem ? 2 * (max_inst_vars > 2 ? max_inst_vars : 2) : 3) *
      sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_inst + n_pad > 0) {
    if (login)
      sp_sweep_kernel<true><<<n_inst + n_pad, PDP_THREADS, smem, st>>>(a);
    else
      sp_sweep_kernel<false><<<n_inst + n_pad, PDP_THREADS, smem, st>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
