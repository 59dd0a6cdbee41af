// Shared definitions of the port's CUDA kernels (sm_90a).
//
// The kernels have a plain C interface and are loaded with ctypes
// (pdp_solver_tpu_torch/ops/_build.py); no source includes PyTorch's
// headers. Every C entry point launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>

// reference clamps (pdp_solver_tpu/ops/segment.py, mirrored in
// pdp_solver_tpu_torch/ops/segment.py)
#define PDP_LOG_EPS_PROP 1.1754944e-38f
#define PDP_LOG_EPS_SCORE 1e-10f
#define PDP_MAX_LOGIT 30.0f

#define PDP_MAX_IN 12
#define PDP_MAX_EOUT 4
#define PDP_THREADS 256
#define PDP_N1(x) ((x) > 0 ? (x) : 1)

__device__ __forceinline__ float safe_log(float x, float eps) {
  return logf(fmaxf(x, eps));
}

__device__ __forceinline__ float safe_exp(float x) {
  return expf(fminf(x, PDP_MAX_LOGIT));
}

__device__ __forceinline__ float flag(bool b) { return b ? 1.0f : 0.0f; }

// --- the SP sweep's per-edge arithmetic (propagate.py _sp_chain_f1/_f3,
// _sp_pass_c), shared by the two-launch path (edge_pass.cu SpChainOps,
// SpPassC) and the one-launch sweep (sp_sweep.cu) so both compile to the
// same operations ---

// log u of an edge, masked by its liveness: the clause sum's term. With
// LOGIN the input already is log u (p-nd-np's adaptors, propagate.py
// _sp_chain_f1_login); its product is rounded on its own (no FMA
// contraction), so every caller gets the same bits.
template <bool LOGIN>
__device__ __forceinline__ float sp_log_u(float u, float em) {
  return LOGIN ? __fmul_rn(u, em) : safe_log(u, PDP_LOG_EPS_PROP) * em;
}

// the eta survey from its clause's log-u sum, frozen where mask is 0
__device__ __forceinline__ float sp_new_eta(float cl_sum, float log_u,
                                            float mask, float eta_state) {
  const float eta = safe_exp(cl_sum - log_u);
  return mask * eta + (1.0f - mask) * eta_state;
}

// log(1 - eta_in) of an edge, masked: the polarity-split var sums' term
__device__ __forceinline__ float sp_lm(float eta_in, float em) {
  return safe_log(1.0f - eta_in, PDP_LOG_EPS_PROP) * em;
}

// the (q_u, q_s, q_dc) triplet of an edge from its variable's polarity
// sums, with the REINFORCE force factor pi, normalised with the stable
// shift (propagate.py q_triplet_stable) and frozen where mask is 0
__device__ __forceinline__ void sp_q_triplet(float pos, float neg,
                                             float eta_in, float em,
                                             float mask, float sign,
                                             float force, float pi,
                                             float v0, float v1, float v2,
                                             float* o) {
  const float lm = sp_lm(eta_in, em);
  float same = 0.5f * (1.0f + sign) * pos + 0.5f * (1.0f - sign) * neg - lm;
  same = same + safe_log(1.0f - pi * flag(force == sign), PDP_LOG_EPS_PROP);
  float opp = 0.5f * (1.0f - sign) * pos + 0.5f * (1.0f + sign) * neg;
  opp = opp + safe_log(1.0f - pi * flag(force == -sign), PDP_LOG_EPS_PROP);
  const float b = fmaxf(same, opp);
  const float sx = safe_exp(same - b), ox = safe_exp(opp - b);
  const float d = safe_exp(same + opp - b);
  const float qu = fmaxf(sx - d, 0.0f), qs = fmaxf(ox - d, 0.0f);
  const float total = fmaxf(qu + qs + d, 1e-20f);
  o[0] = mask * (qu / total) + (1.0f - mask) * v0;
  o[1] = mask * (qs / total) + (1.0f - mask) * v1;
  o[2] = mask * (d / total) + (1.0f - mask) * v2;
}

// Columns of one edge-pass call, passed to the kernel by value. What each
// `in[i]` holds (a node column indexed by ev/ec, an edge column indexed by
// the edge, a clause column indexed by the clause) is fixed by the functor.
struct Cols {
  const float* in[PDP_MAX_IN];
  float* eo[PDP_MAX_EOUT];
  const int* ev;  // edge -> variable
  const int* ec;  // edge -> clause
  float s;        // one scalar parameter (SP's pi)
};
