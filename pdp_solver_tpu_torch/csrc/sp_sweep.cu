// The whole Survey Propagation sweep in one launch (plain SP, pi >= 0).
//
// Replaces the TPU kernel pdp_solver_tpu/ops/pallas_sp.py sp_full_sweep
// (:166, body _build_sp_sweep :51, pallas_call :152) for login=False. It
// computes the same function: the clause-direction log-u sums and the eta
// surveys, and the var-direction polarity-split sums of log(1 - eta_in)
// and the (q_u, q_s, q_dc) triplet with the REINFORCE force factor pi.
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
//      the new eta of those edges. Threads over the instance's variables:
//      each walks its var_perm slice in increasing edge order and writes
//      the polarity-split sums of log(1 - eta_in) * em to shared memory.
//      Both read the input eta only, so they run side by side.
//   2. __syncthreads(), then threads over the instance's edges compute the
//      q-triplet from their variable's two sums.
// Each sum is taken in the same order, with the same operations (the
// sp_* helpers of common.cuh), as the two-launch path (edge_pass.cu
// chained_clause_kernel / chained_var_kernel with SpChain, then SpPassC),
// so the two give the same bits.
// The two sums of an instance's variables take 8 bytes a variable of
// shared memory; when the caller passes a global scratch f32[2, V] (it
// does above 6,144 variables per instance, 48 KB) they go there instead,
// still inside the one CTA (L2-resident, slower). One CTA per instance also means a batch of few
// large instances runs on few SMs: B instances keep at most B of the 132
// SMs busy.
// Padding edges [e_real, e_total) belong to no instance. They still get
// their outputs, as in the two-launch path: CTAs after the instances take
// PDP_SWEEP_PAD_CHUNK of them each, recompute the clause sum and the
// variable sums their edges point at (the last real clause and variable,
// by the packing contract; any other id is summed on the spot) and apply
// the same per-edge formulas.
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
  float pi;
};

__device__ __forceinline__ float clause_log_u_sum(const SweepArgs& a,
                                                  int c) {
  float s = 0.0f;
  const int e1 = a.clause_ptr[c + 1];
  for (int e = a.clause_ptr[c]; e < e1; ++e) s += sp_log_u(a.u[e], a.em[e]);
  return s;
}

__device__ __forceinline__ void var_lm_sums(const SweepArgs& a, int v,
                                            float* pos, float* neg) {
  float p = 0.0f, n = 0.0f;
  const int j1 = a.var_ptr[v + 1];
  for (int j = a.var_ptr[v]; j < j1; ++j) {
    const int e = a.var_perm[j];
    const float lm = sp_lm(a.eta_in[e], a.em[e]);
    const float sign = a.sign[e];
    p += lm * flag(sign == 1.0f);
    n += lm * flag(sign == -1.0f);
  }
  *pos = p;
  *neg = n;
}

__device__ __forceinline__ void edge_outputs(const SweepArgs& a, int e,
                                             float cl, float pos,
                                             float neg) {
  const float mask = a.mask[e];
  a.eta_out[e] = sp_new_eta(cl, sp_log_u(a.u[e], a.em[e]), mask,
                            a.eta_state[e]);
  float o[3];
  sp_q_triplet(pos, neg, a.eta_in[e], a.em[e], mask, a.sign[e], a.force[e],
               a.pi, a.v0[e], a.v1[e], a.v2[e], o);
  a.nv0[e] = o[0];
  a.nv1[e] = o[1];
  a.nv2[e] = o[2];
}

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
      const float cl = clause_log_u_sum(a, c);
      const int e1 = a.clause_ptr[c + 1];
      for (int e = a.clause_ptr[c]; e < e1; ++e)
        a.eta_out[e] = sp_new_eta(cl, sp_log_u(a.u[e], a.em[e]), a.mask[e],
                                  a.eta_state[e]);
    }
    for (int i = tid; i < nv; i += nt) var_lm_sums(a, vb + i, pos + i, neg + i);
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
  if (tid == 0) {
    sh[0] = clause_log_u_sum(a, c_last);
    var_lm_sums(a, v_last, sh + 1, sh + 2);
  }
  __syncthreads();
  for (int e = e0 + tid; e < e1; e += nt) {
    const int c = a.ec[e], v = a.ev[e];
    float cl = sh[0], pos = sh[1], neg = sh[2];
    if (c != c_last) cl = clause_log_u_sum(a, c);
    if (v != v_last) var_lm_sums(a, v, &pos, &neg);
    edge_outputs(a, e, cl, pos, neg);
  }
}

extern "C" {

// cols: the 10 f32[E] inputs u, eta_in, em, mask, eta_state, sign, force,
// v0, v1, v2; outs: the 4 f32[E] outputs eta, nv0, nv1, nv2. ev, ec:
// i32[E]; the CSR tables as in FGBatch. scratch: f32[2, n_vars] for the
// variables' sums, or null to keep them in 8 * max_inst_vars bytes of
// shared memory. Returns cudaGetLastError().
int pdp_sp_sweep(const void* const* cols, float* const* outs, const int* ev,
                 const int* ec, const int* clause_ptr, const int* var_ptr,
                 const int* var_perm, const int* inst_clause_ptr,
                 const int* inst_var_ptr, int n_inst, int n_vars,
                 int max_inst_vars, int e_real, int e_total, float* scratch,
                 float pi, void* stream) {
  SweepArgs a;
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
  if (n_inst + n_pad > 0)
    sp_sweep_kernel<<<n_inst + n_pad, PDP_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
