// eps-greedy WalkSAT: a whole local search (n blocks of K iterations) in
// one launch.
//
// Replaces the TPU kernel of pdp_solver_tpu/ops/pallas_walksat.py
// walksat_block (:285, body _build_walksat :51, pallas_call :258), run
// once per block there. Per iteration: clause energies, break-count flip
// deltas, eps-greedy per-instance selection (first-index argmax, the same
// _hash01 stream; block j's iteration kk salts with seeds[j] + kk *
// 1000003, as the TPU kernel does with its block's seed), then one flip per
// instance that is still unsat. The result matches the JAX kernel chained
// over the same seeds bit for bit.
//
// Bound on the H100: the launch reads each edge column once (ev, w, dm,
// em: 16 B an edge, ~7.4 MB on the shared set, ~2.2 us at 3.35 TB/s). The
// operations are fewer: the first iteration takes every clause (~10
// operations an edge), each later one only the flipped variable's ~36
// clauses and a selection over the instance's variables, so a
// 200-iteration walk needs ~1.4 us of them and bytes bound it (~2.4 us).
// What the card takes instead is one iteration's chain of dependent
// steps, n * K times, on one SM an instance:
//   - the instances are independent, so one CTA per instance walks all n
//     blocks without a grid-wide sync, and an instance stops once its
//     energy entering an iteration is not positive (nothing flips after
//     that: the inputs are constant, so the assignment is final);
//   - the working set is staged on chip once per launch: the assignment
//     and the per-variable sums in shared memory and, where they fit, the
//     clauses (w, dm, em and the local variable ids, clause-major with 4
//     or 8 slots a clause so that a clause is five vector loads; each
//     clause's ac and active degree) and the instance's var-major CSR of
//     clause references. The parts that depend on the batch alone (the
//     local ids, the references) come from the plan, built once;
//   - the sums are kept, not recomputed: a flip changes only the clauses
//     of the flipped variable, so the first iteration takes every clause
//     and each later one only those, dealt through the CSR to consecutive
//     threads. Each adds the difference of its clause's terms after and
//     before the flip to its variables' break and unsat counts; the terms
//     for the flipped variable's own counts, and the energy's, are summed
//     over the warp with redux.sync and added once;
//   - two barriers an iteration: after the clause phase, and after the
//     warps' selection keys. The coin is drawn first, so only the argmax
//     it calls for is taken (greedy, or random among the variables of
//     unsat clauses), as a 64-bit key (the float's order above,
//     0xFFFFFFFF - index below, so the max is the first index of the
//     largest value), reduced with redux.sync in each warp and again over
//     the warps' keys by every warp. The chosen flip is applied on read
//     in the next clause phase and written once the next barrier passes;
//     the next block's seed is loaded a block ahead.
// The flags (active_vars, active_clauses, em, and w = sign * mask * av,
// dm = mask * av) are 0/1 and +-1 values, as every caller passes them, so
// each term is an integer and each sum a small integer: the kernel keeps
// the sums in int32 (native shared-memory atomics; f32 ones are
// compare-and-swap loops), exact in any order and equal to the plain
// version's f32 sums. Instances too large to stage keep their clauses
// (template SE = false) or also their variables (SV = false: the output
// and a global scratch) in global memory, in the same kernel. W is the
// widest clause the kernel's registers take (4 or 8). An instance is its
// real variables and clauses, [inst_var_ptr[b], var_end[b]) and
// [inst_clause_ptr[b], clause_end[b]), and the var-major CSR of its real
// edges: a replicated batch keeps each replica's padding (but the last's)
// inside its last real instance's ranges (fg/batch.py), which the walk
// leaves out, copying those variables as they are, so an instance is
// sized, staged and walked as in the packed batch (fg/batch.py RealRows).
//
// Replicas (a batch replicated R times, instance r * B0 + b a replica of
// b): the JAX package runs its blocks while some instance has no solved
// replica, testing after each block (solvers/base.py block_done :658),
// which freezes the unsolved replicas of the solved instances. That test
// spans the whole grid, and the CTAs of a launch (512 with staged shared
// memory) are not all resident at once, so no CTA may wait on it inside a
// launch. With R > 1 the wrapper launches once a block, in place: each
// CTA, after writing its energy, counts itself in on an arrival counter
// (a fence, then an atomic add); the last one reads every energy and
// writes the done flag (every instance has a replica whose energy is not
// positive) and sets the counter back to 0; a launch whose flag is set
// returns at once in every CTA. So the walk never waits on the host, and
// a launch after the walk is done costs an empty grid. R = 1 keeps the
// single launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

#define WS_MAX_WIDTH 8
#define WS_NARROW 4
#define WS_MAX_THREADS 1024

// The launch's arguments, passed by one pointer from the plan
// (ops/walksat.py, mirrored in ops/_build.py WalkArgs).
struct WalkArgs {
  const int* ev;               // i32[E] edge -> variable
  const float* w;              // f32[E] sign * mask * active_var
  const float* dm;             // f32[E] mask * active_var
  const float* em;             // f32[E] edge mask
  const float* ac;             // f32[F] active clauses
  const int* var_ptr;          // i32[V+1] the var-major CSR of the real
                               // edges (edge_mask 1)
  const int* vref;             // i32[E real] its edges' local clauses, -1
                               // on a variable's second slot in a clause
  const short* lv;             // i16[F real * W] clause-major local
                               // variable ids, W slots a clause (SE)
  const int* inst_clause_ptr;  // i32[B+1]
  const int* inst_var_ptr;     // i32[B+1]
  const float* assign;         // f32[V] the assignment entering the walk
  const float* av;             // f32[V] active variables
  const int* seeds;            // i32[n_blocks]
  float* out;                  // f32[V] the assignment leaving the walk
  float* energy;               // f32[n_rows]
  int* sums;                   // i32[2V] scratch when SV is false
  const int* var_end;          // i32[n_rows] each row's real variables
  const int* clause_end;       // and clauses end here
  const float* inst_mask;      // f32[n_rows] (replicas > 1)
  int* flags;                  // i32[2]: arrivals, done (replicas > 1)
  int n_inst;                  // the rows launched: [0, n_inst)
  int n_rows;
  int n_vars;
  int width;                   // the uniform clause width, 1..8
  int max_vars;                // the largest instance's variables
  int max_clauses;             // and clauses
  int n_blocks;
  int K;
  float eps;
  int threads;
  int stage_vars;
  int stage_edges;
  int replicas;                // R; the rows are R * B0
  int check_done;              // return at once if flags[1] is set
  void* stream;
};

// splitmix-style U[0,1) from (index, salt): pallas_walksat.py _hash01 with
// int32 wrap-around arithmetic and arithmetic right shifts
__device__ __forceinline__ float hash01(int x, int salt) {
  int h = (int)((unsigned)x * 2654435769u + (unsigned)salt);  // 0x9E3779B9
  h = h ^ (h >> 15);
  h = (int)((unsigned)h * 2246822519u);  // 0x85EBCA77
  h = h ^ (h >> 13);
  return (float)(h & 0x7FFFFF) * (1.0f / 8388608.0f);
}

// A key whose unsigned order is (v, -i)'s: the float's bits made monotone
// (-0 taken as +0, which compares equal to it), then 0xFFFFFFFF - i.
__device__ __forceinline__ unsigned long long sel_key(float v, int i) {
  unsigned u = __float_as_uint(v);
  if ((u << 1) == 0u) u = 0u;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xFFFFFFFFu - (unsigned)i);
}

__device__ __forceinline__ unsigned long long warp_max_key(
    unsigned long long k) {
  const unsigned hi = (unsigned)(k >> 32);
  const unsigned mh = __reduce_max_sync(0xffffffffu, hi);
  const unsigned ml =
      __reduce_max_sync(0xffffffffu, hi == mh ? (unsigned)k : 0u);
  return ((unsigned long long)mh << 32) | ml;
}

// The widest clause a kernel instantiation's registers take: 4 or 8.
static int walk_width(int k) {
  return k <= WS_NARROW ? WS_NARROW : WS_MAX_WIDTH;
}

// Dynamic shared memory: asg (f32), delta and unsat_v (i32), av (f32) x
// max_vars (SV); then (SE), clause-major with W slots a clause, w, dm, em
// (f32) and the local variable ids (u16) x max_clauses * W, (ac, deg)
// (f32 x 2) x max_clauses, the var-major clause references (i32) x
// max_clauses * width and the var-major offsets (i32) x max_vars + 1.
static size_t walk_smem(const WalkArgs& a) {
  size_t n = 0;
  const size_t mc = a.max_clauses, W = walk_width(a.width);
  if (a.stage_vars) n += 16 * (size_t)a.max_vars;
  if (a.stage_edges)
    n += 14 * mc * W + 8 * mc + 4 * mc * a.width +
         4 * ((size_t)a.max_vars + 1);
  return n;
}

// Differences of an instance's energy and of one variable's break and
// unsat counts.
struct WalkTerms {
  int energy, delta, uvs;
};

// One instance's clauses: staged clause-major in shared memory (SE: slot
// j of local clause c at c * W + j, so a clause is a few vector loads) or
// read from global memory.
template <int W, bool SE>
struct WalkClauses {
  const WalkArgs& a;
  int c0, nc, v0, k;
  const float *ws, *dms, *ems;
  const uint16_t* lvs;
  const float2* acdeg;

  __device__ __forceinline__ void load(int c, int (&lvj)[W], float (&w)[W],
                                       float (&dm)[W], float (&em)[W],
                                       float& ac, float& deg) const {
    if constexpr (SE) {
#pragma unroll
      for (int h = 0; h < W / 4; ++h) {
        const float4 x = reinterpret_cast<const float4*>(ws + c * W)[h];
        const float4 y = reinterpret_cast<const float4*>(dms + c * W)[h];
        const float4 z = reinterpret_cast<const float4*>(ems + c * W)[h];
        const uint2 u = reinterpret_cast<const uint2*>(lvs + c * W)[h];
        w[4 * h] = x.x, w[4 * h + 1] = x.y, w[4 * h + 2] = x.z;
        w[4 * h + 3] = x.w;
        dm[4 * h] = y.x, dm[4 * h + 1] = y.y, dm[4 * h + 2] = y.z;
        dm[4 * h + 3] = y.w;
        em[4 * h] = z.x, em[4 * h + 1] = z.y, em[4 * h + 2] = z.z;
        em[4 * h + 3] = z.w;
        lvj[4 * h] = (int)(u.x & 0xFFFFu), lvj[4 * h + 1] = (int)(u.x >> 16);
        lvj[4 * h + 2] = (int)(u.y & 0xFFFFu);
        lvj[4 * h + 3] = (int)(u.y >> 16);
      }
      const float2 d = acdeg[c];
      ac = d.x, deg = d.y;
    } else {
      deg = 0.0f;
#pragma unroll
      for (int j = 0; j < W; ++j) {
        if (j < k) {
          const int e = (c0 + c) * k + j;
          lvj[j] = a.ev[e] - v0;
          w[j] = a.w[e], dm[j] = a.dm[e], em[j] = a.em[e];
          deg += dm[j];
        }
      }
      ac = a.ac[c0 + c];
    }
  }

  // Adds clause c's terms with variable p flipped (p < 0: none) less its
  // terms as asg holds them (none when fresh) to the break counts and the
  // unsat counts of its variables other than p; returns the differences
  // of the energy and of p's two counts, which the caller sums over its
  // warp (every clause of p adds to p's counts). The differences are
  // taken in f32, exact on these small integers, and converted once.
  __device__ __forceinline__ WalkTerms update(int c, int p, bool fresh,
                                              const float* asg, int* delta,
                                              int* uvs, bool rand) const {
    int lvj[W];
    float wv[W], dmv[W], emv[W], acv, deg;
    load(c, lvj, wv, dmv, emv, acv, deg);
    float dd[W], du[W], de = 0.0f;
#pragma unroll
    for (int j = 0; j < W; ++j) dd[j] = du[j] = 0.0f;
    // pass 0: the clause before the flip (none when fresh), pass 1: after
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const float sgn = pass ? 1.0f : fresh ? 0.0f : -1.0f;
      float dist[W], agg = 0.0f;
#pragma unroll
      for (int j = 0; j < W; ++j) {
        if (j < k) {
          float x = asg[lvj[j]];
          if (pass && lvj[j] == p) x = -x;
          dist[j] = wv[j] * x;
          agg += dist[j];
        }
      }
      const float unsat = flag(agg == -deg) * acv;
      de += sgn * unsat;
#pragma unroll
      for (int j = 0; j < W; ++j) {
        if (j < k) {
          const float critical = flag(agg - dist[j] == 1.0f - deg) * emv[j];
          dd[j] += sgn * (critical * dist[j]);
          du[j] += sgn * (unsat * dmv[j]);
        }
      }
    }
    WalkTerms out{(int)de, 0, 0};
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (j < k) {
        const int dj = (int)dd[j], uj = (int)du[j];
        if (lvj[j] == p) {
          out.delta += dj, out.uvs += uj;
        } else {
          if (dj) atomicAdd(&delta[lvj[j]], dj);
          if (rand && uj) atomicAdd(&uvs[lvj[j]], uj);
        }
      }
    }
    return out;
  }
};

// After a CTA of a replicated walk has written its energy: the last CTA
// to arrive sets flags[1] to 1 if every instance b < B0 with inst_mask 1
// has a replica r whose energy (row r * B0 + b) is not positive, else to
// 0, and sets the arrival counter back to 0. CTA 0 writes the rows after
// n_inst before it arrives.
__device__ void replicas_done(const WalkArgs& a) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&a.flags[0], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int b0 = a.n_rows / a.replicas;
  int open = 0;
  for (int b = threadIdx.x; b < b0; b += blockDim.x) {
    if (!(a.inst_mask[b] > 0.0f)) continue;
    bool solved = false;
    for (int r = 0; r < a.replicas && !solved; ++r)
      solved = !(__ldcg(&a.energy[r * b0 + b]) > 0.0f);
    open |= !solved;
  }
  open = __syncthreads_or(open);
  if (threadIdx.x == 0) {
    a.flags[1] = open ? 0 : 1;
    a.flags[0] = 0;
  }
}

template <int W, bool SV, bool SE>
__global__ void __launch_bounds__(WS_MAX_THREADS, 1)
    walksat_walk_kernel(const WalkArgs a) {
  extern __shared__ __align__(16) float ws_smem[];
  // the warps' selection keys, by iteration parity
  __shared__ unsigned long long keys[2][32];
  __shared__ int energy;
  // a replicated walk that an earlier launch found done
  if (a.check_done && *(volatile const int*)&a.flags[1]) return;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, wid = tid >> 5, nw = nt >> 5;
  const int v0 = a.inst_var_ptr[b], nv = a.var_end[b] - v0;
  const int c0 = a.inst_clause_ptr[b], nc = a.clause_end[b] - c0;
  const int k = a.width;
  const bool rand = a.eps >= 0.0f;

  if (b == 0) {
    // the variables and rows of no instance: unchanged, and 0 energy
    for (int i = a.inst_var_ptr[a.n_inst] + tid; i < a.n_vars; i += nt)
      a.out[i] = a.assign[i];
    for (int r = a.n_inst + tid; r < a.n_rows; r += nt) a.energy[r] = 0.0f;
  }
  // the padding variables inside the row's range: unchanged
  for (int i = v0 + nv + tid; i < a.inst_var_ptr[b + 1]; i += nt)
    a.out[i] = a.assign[i];

  float* asg;
  int *delta, *uvs;
  const float* avs;
  if constexpr (SV) {
    asg = ws_smem;
    delta = (int*)(asg + a.max_vars);
    uvs = delta + a.max_vars;
    float* av_s = (float*)(uvs + a.max_vars);
    for (int i = tid; i < nv; i += nt) av_s[i] = a.av[v0 + i];
    avs = av_s;
  } else {
    asg = a.out + v0;
    delta = a.sums + v0;
    uvs = a.sums + a.n_vars + v0;
    avs = a.av + v0;
  }
  for (int i = tid; i < nv; i += nt) {
    asg[i] = a.assign[v0 + i];
    delta[i] = 0;
    uvs[i] = 0;
  }
  // the instance's var-major CSR: variable i's clauses are vref[vptr[i]]
  // to vref[vptr[i + 1] - 1] (staged in SE)
  const int e0 = c0 * k, q0 = a.var_ptr[v0];
  WalkClauses<W, SE> cl{a, c0, nc, v0, k, nullptr, nullptr, nullptr,
                        nullptr, nullptr};
  const int *vptr = a.var_ptr + v0, *vref = a.vref;
  if constexpr (SE) {
    const int mw = a.max_clauses * W;
    float *ww = ws_smem + 4 * a.max_vars, *dmw = ww + mw, *emw = dmw + mw;
    uint16_t* lvw = (uint16_t*)(emw + mw);
    float2* adw = (float2*)(lvw + mw);
    int* vrw = (int*)(adw + a.max_clauses);
    int* vpw = vrw + a.max_clauses * k;
    // unrolled so that each thread has several clauses' loads in flight
#pragma unroll 4
    for (int c = tid; c < nc; c += nt) {
      float deg = 0.0f;
#pragma unroll
      for (int j = 0; j < W; ++j) {
        if (j < k) {
          const int e = e0 + c * k + j, s = c * W + j;
          const float dm = a.dm[e];
          ww[s] = a.w[e];
          dmw[s] = dm;
          emw[s] = a.em[e];
          deg += dm;
        }
      }
      adw[c] = make_float2(a.ac[c0 + c], deg);
    }
#pragma unroll 4
    for (int s = tid; s < nc * W; s += nt)
      lvw[s] = (uint16_t)a.lv[c0 * W + s];
#pragma unroll 4
    for (int e = tid; e < nc * k; e += nt) vrw[e] = a.vref[q0 + e];
    for (int i = tid; i <= nv; i += nt) vpw[i] = a.var_ptr[v0 + i] - q0;
    cl.ws = ww, cl.dms = dmw, cl.ems = emw, cl.lvs = lvw, cl.acdeg = adw;
    vptr = vpw, vref = vrw;
  }
  if (tid == 0) energy = 0;
  __syncthreads();

  // pend: the flip chosen by the last iteration, taken on read by the
  // clause phase and written into asg after the next barrier
  int pend = -1;
  float en = 0.0f;
  int seed = a.seeds[0], next_seed = a.seeds[a.n_blocks > 1 ? 1 : 0];
  const int total = a.n_blocks * a.K;
  for (int t = 0, blk = 0, kk = 0; t < total; ++t) {
    // clause phase: every clause, then the clauses of the flipped
    // variable, a warp's worth at a time
    if (t == 0) {
      for (int base = wid << 5; base < nc; base += nt) {
        const int c = base + lane;
        int de = 0;
        if (c < nc)
          de = cl.update(c, -1, true, asg, delta, uvs, rand).energy;
        de = __reduce_add_sync(0xffffffffu, de);
        if (lane == 0 && de) atomicAdd(&energy, de);
      }
    } else if (pend >= 0) {
      const int lo = vptr[pend], hi = vptr[pend + 1];
      for (int base = lo + (wid << 5); base < hi; base += nt) {
        const int q = base + lane;
        WalkTerms d{0, 0, 0};
        // a clause holding the variable twice is taken once, at its first
        // slot of it
        const int c = q < hi ? vref[q] : -1;
        if (c >= 0) d = cl.update(c, pend, false, asg, delta, uvs, rand);
        d.energy = __reduce_add_sync(0xffffffffu, d.energy);
        d.delta = __reduce_add_sync(0xffffffffu, d.delta);
        d.uvs = __reduce_add_sync(0xffffffffu, d.uvs);
        if (lane == 0) {
          if (d.energy) atomicAdd(&energy, d.energy);
          if (d.delta) atomicAdd(&delta[pend], d.delta);
          if (rand && d.uvs) atomicAdd(&uvs[pend], d.uvs);
        }
      }
    }
    __syncthreads();
    en = (float)energy;
    // the flip is gated on a positive energy; without one nothing flips
    // again, so the walk ends here with the same bits
    if (!(en > 0.0f)) break;
    if (tid == 0 && pend >= 0) asg[pend] = -asg[pend];

    // selection: the coin first, then each warp's key of the argmax it
    // calls for (greedy, or random among the variables of unsat clauses)
    const int salt = (int)((unsigned)seed + (unsigned)kk * 1000003u);
    const bool rnd = rand && !(hash01(b, salt ^ 0x5BD1E995) > a.eps);
    unsigned long long key = 0ull;
    if ((wid << 5) < nv) {
      for (int i = tid; i < nv; i += nt) {
        const unsigned long long kv =
            rnd ? sel_key(hash01(v0 + i, salt) *
                              flag((float)uvs[i] * avs[i] > 0.0f),
                          i)
                : sel_key(-(float)delta[i], i);
        key = kv > key ? kv : key;
      }
      key = warp_max_key(key);
    }
    if (lane == 0) keys[t & 1][wid] = key;
    __syncthreads();
    key = warp_max_key(lane < nw ? keys[t & 1][lane] : 0ull);
    pend = key ? (int)(0xFFFFFFFFu - (unsigned)key) : -1;
    if (++kk == a.K) {
      kk = 0, seed = next_seed;
      if (++blk + 1 < a.n_blocks) next_seed = a.seeds[blk + 1];
    }
  }
  if (tid == 0 && pend >= 0) asg[pend] = -asg[pend];
  __syncthreads();
  if constexpr (SV)
    for (int i = tid; i < nv; i += nt) a.out[v0 + i] = asg[i];
  if (tid == 0) a.energy[b] = en;
  if (a.replicas > 1) replicas_done(a);
}

typedef void (*WalkKernel)(const WalkArgs);

template <int W>
static WalkKernel walk_kernel_w(const WalkArgs& a) {
  if (a.stage_vars && a.stage_edges) return walksat_walk_kernel<W, true, true>;
  if (a.stage_vars) return walksat_walk_kernel<W, true, false>;
  if (!a.stage_edges && a.sums) return walksat_walk_kernel<W, false, false>;
  return nullptr;
}

static WalkKernel walk_kernel(const WalkArgs& a) {
  if (a.width < 1 || a.width > WS_MAX_WIDTH || a.threads < 32 ||
      a.threads > WS_MAX_THREADS || a.threads % 32)
    return nullptr;
  return walk_width(a.width) == WS_NARROW ? walk_kernel_w<WS_NARROW>(a)
                                          : walk_kernel_w<WS_MAX_WIDTH>(a);
}

extern "C" {

// Once per plan: lets the plan's kernel take its shared memory (above 48
// KB only after this attribute is set).
int pdp_walksat_setup(const WalkArgs* a) {
  WalkKernel kernel = walk_kernel(*a);
  if (!kernel) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)walk_smem(*a));
}

// n_blocks * K iterations from `assign` into `out` (the same buffer, or
// buffers that do not overlap) for instances [0, n_inst); energy:
// f32[n_rows], each instance's unsat count entering the last iteration it
// ran, 0 on the rows of no instance. With replicas > 1: the done flag's
// arrival protocol above; with check_done, nothing is written if the flag
// is set.
int pdp_walksat_walk(const WalkArgs* a) {
  WalkKernel kernel = walk_kernel(*a);
  if (!kernel || a->n_blocks < 1 || a->K < 1 || a->replicas < 1 ||
      a->n_rows % a->replicas || !a->var_end || !a->clause_end ||
      (a->replicas > 1 && (!a->flags || !a->inst_mask)))
    return (int)cudaErrorInvalidValue;
  kernel<<<a->n_inst > 0 ? a->n_inst : 1, a->threads, walk_smem(*a),
           static_cast<cudaStream_t>(a->stream)>>>(*a);
  return (int)cudaGetLastError();
}

}  // extern "C"
