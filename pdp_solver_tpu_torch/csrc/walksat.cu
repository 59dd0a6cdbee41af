// K WalkSAT iterations per launch.
//
// Replaces the TPU kernel of pdp_solver_tpu/ops/pallas_walksat.py
// walksat_block (:285, body _build_walksat :51, pallas_call :258). Per
// iteration: clause energies, break-count flip deltas, eps-greedy
// per-instance selection (first-index argmax, the same _hash01 stream and
// salts), then one flip per instance that is still unsat. The result
// matches the JAX kernel bit for bit.
//
// Design: one CTA per instance, the instance's assignment and its two
// per-variable sums in shared memory for all K iterations; the instance's
// clauses are contiguous, one thread per clause. Energies and break counts
// are small integers in f32, so shared-memory atomics give exact sums in
// any order. The selection is a block argmax with first-index ties.
//
// Bound on the H100: each iteration reads each of the instance's edge
// columns once (w, dm, em, edge_var: 16 B/edge, ~7.4 MB per iteration at
// the bench batch, ~2 us at 3.35 TB/s, mostly from L2 after the first
// iteration); with 128 instances only 128 of the 132 SMs hold a CTA, and
// the per-iteration __syncthreads chain and the dependent shared-memory
// gathers bound it, not bytes. K iterations per launch amortise the launch.

#include <cuda_runtime.h>

#include "common.cuh"

#define WS_BIG 3e38f

// splitmix-style U[0,1) from (index, salt): pallas_walksat.py _hash01 with
// int32 wrap-around arithmetic and arithmetic right shifts
__device__ __forceinline__ float hash01(int x, int salt) {
  int h = (int)((unsigned)x * 2654435769u + (unsigned)salt);  // 0x9E3779B9
  h = h ^ (h >> 15);
  h = (int)((unsigned)h * 2246822519u);  // 0x85EBCA77
  h = h ^ (h >> 13);
  return (float)(h & 0x7FFFFF) * (1.0f / 8388608.0f);
}

struct ArgMax {
  float v;
  int i;
};

__device__ __forceinline__ ArgMax better(ArgMax a, ArgMax b) {
  if (b.v > a.v || (b.v == a.v && b.i < a.i)) return b;
  return a;
}

// block-wide argmax with first-index ties; every thread gets the result
__device__ ArgMax block_argmax(ArgMax x, ArgMax* sh) {
  for (int off = 16; off > 0; off >>= 1) {
    ArgMax o;
    o.v = __shfl_down_sync(0xffffffffu, x.v, off);
    o.i = __shfl_down_sync(0xffffffffu, x.i, off);
    x = better(x, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    x = lane < nw ? sh[lane] : ArgMax{-WS_BIG, 0x7fffffff};
    for (int off = 16; off > 0; off >>= 1) {
      ArgMax o;
      o.v = __shfl_down_sync(0xffffffffu, x.v, off);
      o.i = __shfl_down_sync(0xffffffffu, x.i, off);
      x = better(x, o);
    }
    if (lane == 0) sh[32] = x;
  }
  __syncthreads();
  return sh[32];
}

__global__ void walksat_block_kernel(
    const int* __restrict__ ev, const float* __restrict__ w,
    const float* __restrict__ dm, const float* __restrict__ em,
    const float* __restrict__ ac, const int* __restrict__ clause_ptr,
    const int* __restrict__ inst_clause_ptr,
    const int* __restrict__ inst_var_ptr, float* __restrict__ assign,
    const float* __restrict__ av, const float* __restrict__ vmask,
    float* __restrict__ energy_out, int K, int seed, float eps) {
  extern __shared__ float smem[];
  __shared__ ArgMax red[33];
  __shared__ float energy;
  const int b = blockIdx.x;
  const int v0 = inst_var_ptr[b], nv = inst_var_ptr[b + 1] - v0;
  const int c0 = inst_clause_ptr[b], c1 = inst_clause_ptr[b + 1];
  float* asg = smem;            // [nv] assignment
  float* delta = smem + nv;     // [nv] flip delta (critical * dist)
  float* unsat_v = smem + 2 * nv;  // [nv] unsat clauses per variable

  for (int i = threadIdx.x; i < nv; i += blockDim.x) asg[i] = assign[v0 + i];

  for (int kk = 0; kk < K; ++kk) {
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      delta[i] = 0.0f;
      unsat_v[i] = 0.0f;
    }
    if (threadIdx.x == 0) energy = 0.0f;
    __syncthreads();

    // edge phase: clause energies, break counts
    for (int c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
      const int e0 = clause_ptr[c], e1 = clause_ptr[c + 1];
      float agg = 0.0f, deg = 0.0f;
      for (int e = e0; e < e1; ++e) {
        agg += w[e] * asg[ev[e] - v0];
        deg += dm[e];
      }
      const float unsat = flag(agg == -deg) * ac[c];
      if (unsat != 0.0f) atomicAdd(&energy, unsat);
      for (int e = e0; e < e1; ++e) {
        const int lv = ev[e] - v0;
        const float dist = w[e] * asg[lv];
        const float critical = flag(agg - dist == 1.0f - deg) * em[e];
        const float d = critical * dist, u = unsat * dm[e];
        if (d != 0.0f) atomicAdd(&delta[lv], d);
        if (u != 0.0f) atomicAdd(&unsat_v[lv], u);
      }
    }
    __syncthreads();
    const float en = energy;
    if (kk == K - 1 && threadIdx.x == 0) energy_out[b] = en;

    // selection + flip, only where a clause is still unsat (the flip is
    // gated on it; the choice is not needed otherwise)
    if (en > 0.0f) {
      const int salt = (int)((unsigned)seed + (unsigned)kk * 1000003u);
      ArgMax best{-WS_BIG, 0x7fffffff}, rnd{-WS_BIG, 0x7fffffff};
      for (int i = threadIdx.x; i < nv; i += blockDim.x) {
        const int g = v0 + i;
        if (vmask[g] > 0.0f) {
          best = better(best, ArgMax{-delta[i], g});
          if (eps >= 0.0f) {
            const float uv = unsat_v[i] * av[g];
            rnd = better(rnd, ArgMax{hash01(g, salt) * flag(uv > 0.0f), g});
          }
        }
      }
      best = block_argmax(best, red);
      int chosen = best.i;
      if (eps >= 0.0f) {
        rnd = block_argmax(rnd, red);
        const float coin = hash01(b, salt ^ 0x5BD1E995);
        chosen = coin > eps ? best.i : rnd.i;
      }
      if (threadIdx.x == 0 && chosen >= v0 && chosen < v0 + nv)
        asg[chosen - v0] = asg[chosen - v0] * (1.0f - 2.0f);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nv; i += blockDim.x) assign[v0 + i] = asg[i];
}

extern "C" {

// K iterations on `assign` (f32[V], updated in place) for instances
// [0, n_inst). energy_out: f32[n_inst], the unsat count entering the last
// iteration. max_inst_vars sizes the shared memory (3 floats a variable).
int pdp_walksat_block(const int* ev, const float* w, const float* dm,
                      const float* em, const float* ac, const int* clause_ptr,
                      const int* inst_clause_ptr, const int* inst_var_ptr,
                      float* assign, const float* av, const float* vmask,
                      float* energy_out, int n_inst, int max_inst_vars, int K,
                      int seed, float eps, void* stream) {
  const size_t smem = (size_t)3 * max_inst_vars * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        walksat_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_inst > 0 && K > 0)
    walksat_block_kernel<<<n_inst, PDP_THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        ev, w, dm, em, ac, clause_ptr, inst_clause_ptr, inst_var_ptr, assign,
        av, vmask, energy_out, K, seed, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
