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

// --- a thread-block cluster per instance (sp_sweep.cu, verify.cu) ---
//
// Kernels 9 and 10 run one cluster of `cs` CTAs per instance (cs a power
// of two up to PDP_CLUSTER_MAX, chosen by ops/_build.py cluster_size from
// the batch's shape): CTA r of the cluster takes the share
// [cluster_share(n, r, cs), cluster_share(n, r + 1, cs)) of the instance's
// clauses (and their edges) and of its variables, the CTAs exchange what
// the next phase needs through distributed shared memory, and
// cluster.sync() stands between the phases.
#define PDP_CLUSTER_MAX 16
#define PDP_CLUSTER_PORTABLE 8

__device__ __forceinline__ int cluster_share(int n, int r, int cs) {
  return (int)((long long)n * r / cs);
}

// The cluster barrier in two halves (cluster.sync() is both at once), so
// that work can run between a CTA's arrival and its wait. The relaxed
// arrival orders no memory: a kernel arrives so as its CTA starts and
// waits before its CTA's first access to another CTA's shared memory, so
// that every CTA of the cluster has started by then. The plain arrival
// releases this thread's writes (shared memory of any CTA of the cluster,
// and global memory) to the threads of the cluster that pass the next
// wait, which acquires them. Every thread of the cluster takes arrivals
// and waits in turn.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Launches kernel(args) on n_clusters clusters of cs CTAs of PDP_THREADS
// threads, with smem bytes of dynamic shared memory. Opts in to a cluster
// above the portable 8 and to more than 48 KB of dynamic shared memory
// where the launch needs it. Returns the launch's error (a cluster the
// card cannot place is refused here).
template <class Args>
inline cudaError_t launch_clusters(void (*kernel)(Args), int n_clusters,
                                   int cs, size_t smem, cudaStream_t st,
                                   const Args& args) {
  cudaError_t err;
  if (cs > PDP_CLUSTER_PORTABLE) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n_clusters * cs);
  cfg.blockDim = dim3(PDP_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args);
}

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
// contraction), so every caller gets the same bits. In two steps: the log
// (sp_u_log), then the masked product (sp_log_u_masked), so that a caller
// can take the log once for two uses.
template <bool LOGIN>
__device__ __forceinline__ float sp_u_log(float u) {
  return LOGIN ? u : safe_log(u, PDP_LOG_EPS_PROP);
}

template <bool LOGIN>
__device__ __forceinline__ float sp_log_u_masked(float lu, float em) {
  return LOGIN ? __fmul_rn(lu, em) : lu * em;
}

template <bool LOGIN>
__device__ __forceinline__ float sp_log_u(float u, float em) {
  return sp_log_u_masked<LOGIN>(sp_u_log<LOGIN>(u), em);
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
// sums, normalised with the stable shift (propagate.py q_triplet_stable)
// and frozen where mask is 0; lf_same, lf_opp: the logs of the REINFORCE
// force factors, safe_log(1 - pi * flag(force == sign)) and
// safe_log(1 - pi * flag(force == -sign))
__device__ __forceinline__ void sp_q_triplet_lf(float pos, float neg,
                                                float eta_in, float em,
                                                float mask, float sign,
                                                float lf_same, float lf_opp,
                                                float v0, float v1, float v2,
                                                float* o) {
  const float lm = sp_lm(eta_in, em);
  float same = 0.5f * (1.0f + sign) * pos + 0.5f * (1.0f - sign) * neg - lm;
  same = same + lf_same;
  float opp = 0.5f * (1.0f - sign) * pos + 0.5f * (1.0f + sign) * neg;
  opp = opp + lf_opp;
  const float b = fmaxf(same, opp);
  const float sx = safe_exp(same - b), ox = safe_exp(opp - b);
  const float d = safe_exp(same + opp - b);
  const float qu = fmaxf(sx - d, 0.0f), qs = fmaxf(ox - d, 0.0f);
  const float total = fmaxf(qu + qs + d, 1e-20f);
  o[0] = mask * (qu / total) + (1.0f - mask) * v0;
  o[1] = mask * (qs / total) + (1.0f - mask) * v1;
  o[2] = mask * (d / total) + (1.0f - mask) * v2;
}

// the same with the force factor pi: a factor's log is safe_log(1 - pi)
// where the force agrees and log(1) = 0 where it does not, so a caller
// with pi fixed for many edges passes lpi = safe_log(1 - pi) and gets
// these bits from sp_q_triplet_lf with (force == sign ? lpi : 0)
__device__ __forceinline__ void sp_q_triplet(float pos, float neg,
                                             float eta_in, float em,
                                             float mask, float sign,
                                             float force, float pi,
                                             float v0, float v1, float v2,
                                             float* o) {
  sp_q_triplet_lf(
      pos, neg, eta_in, em, mask, sign,
      safe_log(1.0f - pi * flag(force == sign), PDP_LOG_EPS_PROP),
      safe_log(1.0f - pi * flag(force == -sign), PDP_LOG_EPS_PROP), v0, v1,
      v2, o);
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

// --- the group walk: segmented sums over a CSR, shared by reduce.cu
// (segment_sum_cols) and edge_pass.cu (the var-side fused pass) ---
//
// One launch sums n_seg segments that hold n_slots slots between them.
//   Blocks [0, group_blocks): a group of G lanes per segment (G a power of
//   two from 4 to 32, aligned inside a warp). Lane l takes the slots
//   lo + l, lo + l + G, ... of its segment in order and keeps the sums in
//   registers; a butterfly over the group (xor G/2, ..., 1) then gives
//   every lane the same totals. Neighbouring lanes read neighbouring
//   slots, so a group's index reads are contiguous.
//   Blocks [group_blocks, group_blocks + anchor_blocks): block a is
//   anchored on slot a * S, S = PDP_HEAVY_ITERS * G. A segment of S slots
//   or more (a heavy one) is left by its group and split among the blocks
//   anchored inside it: the first takes [lo, its anchor + S), each later
//   one [its anchor, its anchor + S), cut at hi. In a block thread t takes
//   the piece's slots t, t + blockDim, ...; a butterfly in each warp, then
//   thread 0 adds the warp totals in warp order. A piece's total goes to
//   scratch, and the block that counts itself last in (an integer atomic)
//   adds the pieces in anchor order. No lane of a group walks more than
//   PDP_HEAVY_ITERS slots, no block more than S / blockDim a thread, and a
//   heavy segment is found with a few loads, with no list made in advance.
//   When the caller knows that no segment reaches S (the pack-time largest
//   degree), the launch has no anchored blocks and groups take every
//   segment.
// Every order follows from G and the CSR alone, so the sums are the same
// from run to run, with no float atomics (the decimator takes an argmax of
// |score|). ops/reduce.py walk_order_sum repeats them in PyTorch.
//
// A segment policy Seg gives, for segment n, its slots [lo, hi) (bounds),
// the edge of slot j (slot_edge), and the heavy segment holding slot s,
// if any (heavy_at). All lanes of a warp call bounds together (a policy
// may shuffle inside it).

#define PDP_HEAVY_ITERS 128
#define PDP_WALK_MAXR 10  // the SP sweep folds' ten variable sums
#define PDP_FULL_MASK 0xffffffffu

struct WalkPlan {
  int n_seg;          // segments
  int n_slots;        // slots of the CSR (the anchors cover [0, n_slots))
  int g_shift;        // log2 G
  int heavy_min;      // slots from which a segment is heavy (S, or above
                      // any segment when there are no anchored blocks)
  int group_blocks;   // blocks of groups
  int anchor_blocks;  // anchored blocks
  float* partials;    // f32[anchor_blocks, PDP_WALK_MAXR] scratch
  int* counters;      // i32[anchor_blocks], 0 between launches
};

// The plan of a launch with PDP_THREADS threads a block; false unless G is
// a power of two from 4 to 32 and, with heavy segments possible, the
// scratch is given. heavy: some segment may hold S slots or more.
inline bool make_walk_plan(int n_seg, int n_slots, int group, bool heavy,
                           float* partials, int* counters, WalkPlan* p) {
  int shift = 2;
  while (shift < 5 && (1 << shift) < group) ++shift;
  if ((1 << shift) != group) return false;
  const long stride = (long)PDP_HEAVY_ITERS << shift;
  p->n_seg = n_seg;
  p->n_slots = n_slots;
  p->g_shift = shift;
  p->group_blocks =
      (int)(((long)n_seg * group + PDP_THREADS - 1) / PDP_THREADS);
  p->anchor_blocks = heavy ? (int)((n_slots + stride - 1) / stride) : 0;
  p->heavy_min = heavy ? (int)stride : 0x7fffffff;
  p->partials = partials;
  p->counters = counters;
  return !heavy || (partials && counters);
}

// Segments listed by a CSR: segment n holds slots [ptr[n], ptr[n+1]); slot
// j is edge perm[j] (j itself when perm is null); ids[e] is edge e's
// segment.
template <class IdT>
struct CsrSeg {
  const int* ptr;
  const int* perm;
  const IdT* ids;
  __device__ __forceinline__ void bounds(int n, int& lo, int& hi) const {
    lo = ptr[n];
    hi = ptr[n + 1];
  }
  __device__ __forceinline__ int slot_edge(int j) const {
    return perm ? perm[j] : j;
  }
  __device__ bool heavy_at(int s, int S, int n_seg, int& n, int& lo,
                           int& hi) const {
    const long long id = (long long)ids[slot_edge(s)];
    if (id < 0 || id >= n_seg) return false;
    n = (int)id;
    bounds(n, lo, hi);
    return hi - lo >= S;
  }
};

// Segments of sorted ids: segment n is the run of slots whose id is n;
// ids outside [0, n_seg) belong to no segment. Bounds are found by binary
// search, the lanes of each pair searching n and n + 1 at once.
template <class IdT>
struct SortedSeg {
  const IdT* ids;
  int n_ids;
  __device__ __forceinline__ int lower_bound(long long key) const {
    int lo = 0, hi = n_ids;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((long long)ids[mid] < key)
        lo = mid + 1;
      else
        hi = mid;
    }
    return lo;
  }
  __device__ __forceinline__ void bounds(int n, int& lo, int& hi) const {
    const int lane = threadIdx.x & 31;
    const int pos = lower_bound((long long)n + (lane & 1));
    lo = __shfl_sync(PDP_FULL_MASK, pos, lane & ~1);
    hi = __shfl_sync(PDP_FULL_MASK, pos, lane | 1);
  }
  __device__ __forceinline__ int slot_edge(int j) const { return j; }
  __device__ bool heavy_at(int s, int S, int n_seg, int& n, int& lo,
                           int& hi) const {
    const long long id = (long long)ids[s];
    if (id < 0 || id >= n_seg) return false;
    // a run of S or more slots that holds s holds s - S/2 or s + S/2 - 1
    // too: most anchors stop here, before any search
    const int a = s - S / 2, b = s + S / 2 - 1;
    if (!((a >= 0 && (long long)ids[a] == id) ||
          (b < n_ids && (long long)ids[b] == id)))
      return false;
    n = (int)id;
    bounds(n, lo, hi);
    return hi - lo >= S;
  }
};

// store(n, c, v) of the walk: sum c of segment n to out[c, n]
struct SegOut {
  float* out;
  int n_seg;
  __device__ __forceinline__ void operator()(int n, int c, float v) const {
    out[(size_t)c * n_seg + n] = v;
  }
};

// The walk of one block. term(e, r) gives edge e's NR terms (and writes
// any edge outputs); store(n, c, v) writes segment n's sum c.
template <int NR, class Seg, class Term, class Store>
__device__ __forceinline__ void walk_block(const WalkPlan& p, const Seg& seg,
                                           const Term& term,
                                           const Store& store) {
  static_assert(NR <= PDP_WALK_MAXR, "too many sums for the walk");
  float acc[NR], r[NR];
#pragma unroll
  for (int c = 0; c < NR; ++c) acc[c] = 0.0f;
  const int G = 1 << p.g_shift;
  if ((int)blockIdx.x < p.group_blocks) {
    const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = (t >> p.g_shift) < p.n_seg;
    // lanes past the last segment walk nothing but join the shuffles
    const int n = live ? (int)(t >> p.g_shift) : p.n_seg - 1;
    const int lane = threadIdx.x & (G - 1);
    int lo, hi;
    seg.bounds(n, lo, hi);
    const bool mine = live && hi - lo < p.heavy_min;
    if (mine) {
#pragma unroll 4
      for (int j = lo + lane; j < hi; j += G) {
        term(seg.slot_edge(j), r);
#pragma unroll
        for (int c = 0; c < NR; ++c) acc[c] += r[c];
      }
    }
    for (int off = G >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int c = 0; c < NR; ++c)
        acc[c] += __shfl_xor_sync(PDP_FULL_MASK, acc[c], off);
    }
    if (mine) {
#pragma unroll
      for (int c = 0; c < NR; ++c)
        if ((c & (G - 1)) == lane) store(n, c, acc[c]);
    }
    return;
  }
  // an anchored block: every thread decides alike, so the block stays
  // together for the shuffles and the barrier
  const int S = p.heavy_min;
  const int a = (int)blockIdx.x - p.group_blocks;
  const int s = a * S;
  int n, lo, hi;
  if (s >= p.n_slots || !seg.heavy_at(s, S, p.n_seg, n, lo, hi)) return;
  const int a0 = (lo + S - 1) / S, a1 = (hi - 1) / S;  // its anchors
  const int j1 = min(s + S, hi);
  // unrolled, a thread keeps up to 8 gathers in flight
#pragma unroll 8
  for (int j = (a == a0 ? lo : s) + (int)threadIdx.x; j < j1;
       j += blockDim.x) {
    term(seg.slot_edge(j), r);
#pragma unroll
    for (int c = 0; c < NR; ++c) acc[c] += r[c];
  }
  __shared__ float warp_sums[PDP_THREADS / 32][NR];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < NR; ++c)
      acc[c] += __shfl_xor_sync(PDP_FULL_MASK, acc[c], off);
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int c = 0; c < NR; ++c) warp_sums[threadIdx.x >> 5][c] = acc[c];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float tot[NR];
#pragma unroll
  for (int c = 0; c < NR; ++c) {
    tot[c] = warp_sums[0][c];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) tot[c] += warp_sums[w][c];
  }
  if (a0 == a1) {  // the segment is one piece
#pragma unroll
    for (int c = 0; c < NR; ++c) store(n, c, tot[c]);
    return;
  }
#pragma unroll
  for (int c = 0; c < NR; ++c) p.partials[a * PDP_WALK_MAXR + c] = tot[c];
  __threadfence();
  if (atomicAdd(&p.counters[a0], 1) != a1 - a0) return;
  // the last piece in: every other piece's total is in scratch
  __threadfence();
#pragma unroll
  for (int c = 0; c < NR; ++c) {
    float sum = __ldcg(&p.partials[a0 * PDP_WALK_MAXR + c]);
    for (int k = a0 + 1; k <= a1; ++k)
      sum += __ldcg(&p.partials[k * PDP_WALK_MAXR + c]);
    store(n, c, sum);
  }
  p.counters[a0] = 0;
}
