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
// Design: a thread-block cluster of cs CTAs per instance (common.cuh). The
// packed layout keeps an instance's clauses, edges and variables contiguous
// (inst_clause_ptr, inst_var_ptr, clause_ptr; var_ptr/var_perm list each
// variable's edges), so an instance's sweep needs nothing outside its
// cluster: no grid-wide sync and no atomics. CTA r of the cluster:
//   1. clauses, on warps 0-3: its share of the instance's clauses in tiles
//      of 128 clauses. A tile's log u (the log taken once an edge) and em
//      are loaded coalesced (a lane an edge) into shared memory; one thread
//      a clause sums its masked log u there in edge order, and the lanes
//      then write each edge's new eta, again a lane an edge. A tile holds at
//      most PDP_THREADS clauses of at most PDP_SWEEP_MAX_K edges
//      (ops/sp_sweep.py refuses a batch with wider clauses; the route takes
//      widths up to 8 only).
//   2. variables, on warps 4-7 at the same time (the two phases are
//      independent, and their chains of dependent loads overlap): its share
//      of the instance's variables. Each variable's polarity sums of log(1 -
//      eta_in) * em are taken in the order of the group walk (common.cuh
//      walk_block) with the chained pass's G: a group of G lanes a variable,
//      lane l its slots l, l + G, ..., then the xor butterfly over the
//      group. The group's lane 0 writes the two sums into every CTA of the
//      cluster (distributed shared memory, cluster.map_shared_rank), after a
//      wait that makes sure every CTA has started (its arrival is taken as
//      the kernel starts). When a variable may hold S = PDP_HEAVY_ITERS * G
//      slots or more (a heavy one), the whole CTA takes the two phases in
//      turn, and a heavy variable goes piece by piece, one piece for each
//      multiple of S inside it: the instance's pieces are dealt round the
//      cluster's CTAs; a CTA takes a piece as one anchored block of the walk
//      does (thread t its slots t, t + 256, ..., a butterfly in each warp,
//      the warp totals in warp order) and writes its total to global
//      scratch; after a cluster barrier the CTA that owns the variable adds
//      its pieces in anchor order. So each sum keeps its bits whichever CTA
//      takes it.
//   3. cluster.sync(), then the q-triplet of the edges of its clauses from
//      the sums in its own shared memory, the force factor's log taken once
//      (safe_log(1 - pi) where the force agrees with the sign, log 1 = 0
//      elsewhere).
// Each sum is taken in the same order, with the same operations (the sp_*
// helpers of common.cuh), as the two-launch path (edge_pass.cu
// chained_clause_kernel / chained_var_kernel with SpChain or SpChainLogin,
// then SpPassC), so the two give the same bits. The two sums of an
// instance's variables take 8 bytes a variable of each CTA's shared memory;
// when the caller passes a global scratch f32[2, V] (it does above SMEM_VARS
// = 6,144 variables an instance) each CTA writes its variables' sums there
// instead, and no CTA reads another's shared memory. The cluster barrier's
// release/acquire at cluster scope orders those global writes (and the heavy
// pieces' totals) before the reads after it; the reads bypass L1 (__ldcg).
// Padding edges [e_real, e_total) belong to no instance. They still get
// their outputs, as in the two-launch path: clusters after the instances'
// take PDP_SWEEP_PAD_CHUNK of them a CTA, each CTA alone: it recomputes the
// clause sum and the variable sums its edges point at (the last real clause
// and variable, by the packing contract: the CTA sums that variable in the
// walk's order; any other id is summed on the spot, one thread repeating the
// walk's order lane by lane), and applies the same per-edge formulas.
// Padding edges inside [0, e_real) (a replicated batch, inner_pad 1) sit
// in padding clauses' ranges; their eta takes the sum of the clause their
// edge_clause names, as edge_pass.cu's clause phase does.
// Tried on the H100 and not kept (device us, shared set, against 20-21 for
// the two phases in turn): variables before clauses with the clauses
// between the barrier's arrival and wait (21-25); the walk's terms staged in
// each CTA's shared memory and read across the cluster (22.7-24); the sums
// exchanged through global memory instead of distributed shared memory (no
// faster); phase 2 two edges a step (no faster). The warps split of phase 1
// was kept: 19.1-20.1 on the shared set, 8.4-8.5 -> 7.0 on a compacted
// batch.
//
// Bound on the H100 at the shared-set shapes (E = 524,288 padded / 460,800
// real edges, V = 16,384, F = 131,072, B = 128): the 10 f32[E] inputs
// (21 MB), edge_var (2.1 MB), var_perm (1.8 MB) and the CSR offsets, and
// the 4 f32[E] outputs (8.4 MB): ~33 MB, about 10 us at 3.35 TB/s, with
// ~40 flops an edge. Bound by bytes. One CTA an instance left 128 CTAs of
// 256 threads walking ~3,600 edges each through dependent gathers
// (latency-bound, 8 of 64 warps on an SM); the cluster cuts each CTA's
// share by cs and fills the card with B * cs CTAs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define PDP_SWEEP_PAD_CHUNK 1024
#define PDP_SWEEP_MAX_K 8  // the widest clause, ops/sp_sweep.py MAX_WIDTH
#define PDP_SWEEP_TILE_E (PDP_SWEEP_MAX_K * PDP_THREADS)

// the input columns of SweepArgs::ins and the outputs of SweepArgs::outs
enum { IN_U, IN_ETA, IN_EM, IN_MASK, IN_ETA_STATE, IN_SIGN, IN_FORCE, IN_V0,
       IN_V1, IN_V2 };
enum { OUT_ETA, OUT_V0, OUT_V1, OUT_V2 };

// One sweep's arguments, filled once per batch plan by ops/sp_sweep.py and
// passed by pointer (the field order matches its ctypes Structure); the
// kernel takes a copy by value. ins: the 10 f32[E] columns in the enum's
// order; outs: the 4 f32[E] outputs. sums: f32[2, V] for the variables'
// sums, or null to keep them in shared memory (2 * max_inst_vars floats).
// pieces: f32[2 * ceil(e_real / S)] for the heavy pieces' totals, needed
// when heavy (a variable may hold S = PDP_HEAVY_ITERS * group slots or
// more). group: G of the chained pass's var walk (a power of two from 4 to
// 32); cluster: CTAs an instance.
struct SweepArgs {
  const float* ins[PDP_MAX_IN];
  float* outs[PDP_MAX_EOUT];
  const int* ev;
  const int* ec;
  const int* clause_ptr;
  const int* var_ptr;
  const int* var_perm;
  const int* inst_clause_ptr;
  const int* inst_var_ptr;
  float* sums;
  float* pieces;
  int n_inst;
  int n_vars;
  int max_inst_vars;
  int e_real;
  int e_total;
  int inner_pad;
  int group;
  int heavy;
  int cluster;
  int login;
  float pi;
  void* stream;
};

template <bool LOGIN>
__device__ __forceinline__ float clause_log_u_sum(const SweepArgs& a,
                                                  int c) {
  float s = 0.0f;
  const int e1 = a.clause_ptr[c + 1];
  for (int e = a.clause_ptr[c]; e < e1; ++e)
    s += sp_log_u<LOGIN>(a.ins[IN_U][e], a.ins[IN_EM][e]);
  return s;
}

// edge e's two terms of its variable's polarity sums (SpChainOps::f3's)
__device__ __forceinline__ void lm_terms(const SweepArgs& a, int e, float& p,
                                         float& n) {
  const float lm = sp_lm(a.ins[IN_ETA][e], a.ins[IN_EM][e]);
  const float sign = a.ins[IN_SIGN][e];
  p = lm * flag(sign == 1.0f);
  n = lm * flag(sign == -1.0f);
}

__device__ __forceinline__ int heavy_min(const SweepArgs& a) {
  return a.heavy ? PDP_HEAVY_ITERS * a.group : 0x7fffffff;
}

// a barrier of the CTA's first nt threads (all of them: __syncthreads)
__device__ __forceinline__ void part_sync(int nt) {
  if (nt == PDP_THREADS)
    __syncthreads();
  else
    asm volatile("bar.sync 1, %0;" ::"r"(nt) : "memory");
}

// phase 1, clauses [ca, cb): their log-u sums and their edges' new eta,
// taken by the CTA's first nt threads (tid: this thread's index among
// them), nt clauses a tile (nt * PDP_SWEEP_MAX_K <= PDP_SWEEP_TILE_E edges)
template <bool LOGIN>
__device__ void clause_phase(const SweepArgs& a, int ca, int cb,
                             float* tile, int tid, int nt) {
  float* tu = tile;  // log u
  float* tem = tile + PDP_SWEEP_TILE_E;
  float* tcl = tile + 2 * PDP_SWEEP_TILE_E;
  for (int t0 = ca; t0 < cb; t0 += nt) {
    const int t1 = min(cb, t0 + nt), c = t0 + tid;
    const int e0 = a.clause_ptr[t0], n = a.clause_ptr[t1] - e0;
    for (int i = tid; i < n; i += nt) {
      tu[i] = sp_u_log<LOGIN>(a.ins[IN_U][e0 + i]);
      tem[i] = a.ins[IN_EM][e0 + i];
    }
    part_sync(nt);
    if (c < t1) {
      const int lo = a.clause_ptr[c] - e0, hi = a.clause_ptr[c + 1] - e0;
      float s = 0.0f;
      for (int i = lo; i < hi; ++i)
        s += sp_log_u_masked<LOGIN>(tu[i], tem[i]);
      for (int i = lo; i < hi; ++i) tcl[i] = s;
      if (a.inner_pad) {
        // padding edges inside the prefix: the sum of the clause their
        // edge_clause names (fg/batch.py, edge_pass.cu)
        for (int i = lo; i < hi; ++i) {
          const int ce = a.ec[e0 + i];
          if (ce != c) tcl[i] = clause_log_u_sum<LOGIN>(a, ce);
        }
      }
    }
    part_sync(nt);
    for (int i = tid; i < n; i += nt) {
      const int e = e0 + i;
      a.outs[OUT_ETA][e] =
          sp_new_eta(tcl[i], sp_log_u_masked<LOGIN>(tu[i], tem[i]),
                     a.ins[IN_MASK][e], a.ins[IN_ETA_STATE][e]);
    }
    part_sync(nt);  // the next tile reuses the buffers
  }
}

// The polarity sums of the variables [v0, v1) below the heavy size, in the
// walk's order: a group of G lanes a variable, nt / G variables a round;
// store(v, p, n) on the group's lane 0. nt threads of the CTA, whole
// warps, call it (tid: this thread's index among them).
template <class Store>
__device__ void group_sums(const SweepArgs& a, int v0, int v1,
                           const Store& store, int tid = threadIdx.x,
                           int nt = PDP_THREADS) {
  const int G = a.group, gs = __ffs(G) - 1, hmin = heavy_min(a);
  const int lane = tid & (G - 1);
  for (int base = v0; base < v1; base += nt >> gs) {
    const int v = base + (tid >> gs);
    float p = 0.0f, n = 0.0f, tp, tn;
    bool mine = false;
    if (v < v1) {
      const int lo = a.var_ptr[v], hi = a.var_ptr[v + 1];
      mine = hi - lo < hmin;
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
    if (mine && lane == 0) store(v, p, n);
  }
}

// The piece of anchor s (a multiple of S) when it lies in a heavy
// variable, taken by the whole CTA as an anchored block of the walk takes
// it. Returns alike on every thread whether it does; then v, a0, a1 are
// the variable and its first and last anchors (in units of S), and thread
// 0 holds the piece's totals in p, n.
__device__ bool piece_sums(const SweepArgs& a, int s, int& v, int& a0,
                           int& a1, float& p, float& n) {
  __shared__ float warp_p[PDP_THREADS / 32], warp_n[PDP_THREADS / 32];
  const int S = PDP_HEAVY_ITERS * a.group, tid = threadIdx.x;
  v = a.ev[a.var_perm[s]];
  const int lo = a.var_ptr[v], hi = a.var_ptr[v + 1];
  if (hi - lo < S) return false;
  a0 = (lo + S - 1) / S;
  a1 = (hi - 1) / S;
  float tp, tn;
  p = n = 0.0f;
#pragma unroll 8
  for (int j = (s / S == a0 ? lo : s) + tid; j < min(s + S, hi);
       j += PDP_THREADS) {
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
    for (int w = 1; w < PDP_THREADS / 32; ++w) {
      p += warp_p[w];
      n += warp_n[w];
    }
  }
  __syncthreads();
  return true;
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
// by piece as group_sums and piece_sums take them
__device__ void var_lm_sums(const SweepArgs& a, int v, float* pos,
                            float* neg) {
  const int G = a.group, S = PDP_HEAVY_ITERS * G;
  const int lo = a.var_ptr[v], hi = a.var_ptr[v + 1];
  float p[32], n[32], tp, tn;
  if (hi - lo < heavy_min(a)) {
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
  const float mask = a.ins[IN_MASK][e];
  a.outs[OUT_ETA][e] =
      sp_new_eta(cl, sp_log_u<LOGIN>(a.ins[IN_U][e], a.ins[IN_EM][e]), mask,
                 a.ins[IN_ETA_STATE][e]);
  float o[3];
  sp_q_triplet(pos, neg, a.ins[IN_ETA][e], a.ins[IN_EM][e], mask,
               a.ins[IN_SIGN][e], a.ins[IN_FORCE][e], a.pi, a.ins[IN_V0][e],
               a.ins[IN_V1][e], a.ins[IN_V2][e], o);
  a.outs[OUT_V0][e] = o[0];
  a.outs[OUT_V1][e] = o[1];
  a.outs[OUT_V2][e] = o[2];
}

// A padding CTA: the outputs of padding edges [e0, e0 + chunk), alone (no
// cluster barrier on this path). sh: 3 floats.
template <bool LOGIN>
__device__ void pad_edges(const SweepArgs& a, int e0, float* sh) {
  const int e1 = min(a.e_total, e0 + PDP_SWEEP_PAD_CHUNK);
  const int c_last = a.ec[a.e_real], v_last = a.ev[a.e_real];
  const int lo = a.var_ptr[v_last], hi = a.var_ptr[v_last + 1];
  if (hi - lo < heavy_min(a)) {
    group_sums(a, v_last, v_last + 1, [&](int, float p, float n) {
      sh[1] = p;
      sh[2] = n;
    });
  } else {
    const int S = PDP_HEAVY_ITERS * a.group;
    float run_p = 0.0f, run_n = 0.0f, p, n;
    int v, a0, a1;
    for (int k = (lo + S - 1) / S; k * S < hi; ++k) {
      piece_sums(a, k * S, v, a0, a1, p, n);
      run_p = k == a0 ? p : run_p + p;
      run_n = k == a0 ? n : run_n + n;
    }
    if (threadIdx.x == 0) {
      sh[1] = run_p;
      sh[2] = run_n;
    }
  }
  if (threadIdx.x == 0) sh[0] = clause_log_u_sum<LOGIN>(a, c_last);
  __syncthreads();
  for (int e = e0 + threadIdx.x; e < e1; e += PDP_THREADS) {
    const int c = a.ec[e], v = a.ev[e];
    float cl = sh[0], pos = sh[1], neg = sh[2];
    if (c != c_last) cl = clause_log_u_sum<LOGIN>(a, c);
    if (v != v_last) var_lm_sums(a, v, &pos, &neg);
    edge_outputs<LOGIN>(a, e, cl, pos, neg);
  }
}

// The heavy variables of the instance at vb (nv variables): its pieces
// dealt round the cluster, their totals to global scratch; after a cluster
// barrier each owner (the CTA whose share [va, vz) holds the variable)
// adds its variables' pieces in anchor order. Every thread of the cluster
// calls it.
template <class Store>
__device__ void heavy_sums(const SweepArgs& a, cg::cluster_group& cluster,
                           int vb, int nv, int va, int vz,
                           const Store& store) {
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int S = PDP_HEAVY_ITERS * a.group;
  const int s0 = a.var_ptr[vb], s1 = a.var_ptr[vb + nv];
  for (int s = ((s0 + S - 1) / S + rank) * S; s < s1; s += cs * S) {
    int v, a0, a1;
    float p, n;
    if (piece_sums(a, s, v, a0, a1, p, n) && threadIdx.x == 0) {
      a.pieces[2 * (s / S)] = p;
      a.pieces[2 * (s / S) + 1] = n;
    }
  }
  cluster.sync();
  for (int v = va + threadIdx.x; v < vz; v += PDP_THREADS) {
    const int lo = a.var_ptr[v], hi = a.var_ptr[v + 1];
    if (hi - lo < S) continue;
    const int a0 = (lo + S - 1) / S, a1 = (hi - 1) / S;
    float p = __ldcg(&a.pieces[2 * a0]), n = __ldcg(&a.pieces[2 * a0 + 1]);
    for (int k = a0 + 1; k <= a1; ++k) {
      p += __ldcg(&a.pieces[2 * k]);
      n += __ldcg(&a.pieces[2 * k + 1]);
    }
    store(v, p, n);
  }
}

// Five CTAs an SM (at most 51 registers a thread): the shared set's 512
// instance CTAs and their padding CTAs run in one wave (the log-input form
// took 64 registers, four CTAs an SM, and a second wave).
template <bool LOGIN>
__global__ void __launch_bounds__(PDP_THREADS, 5)
    sp_sweep_kernel(SweepArgs a) {
  extern __shared__ float sh[];  // the clause tile, then pos and neg
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int q = (int)blockIdx.x / cs;  // the instance, or a padding cluster
  if (q >= a.n_inst) {
    const int e0 =
        a.e_real + ((q - a.n_inst) * cs + rank) * PDP_SWEEP_PAD_CHUNK;
    if (e0 < a.e_total) pad_edges<LOGIN>(a, e0, sh);
    return;
  }
  const int c0 = a.inst_clause_ptr[q], nc = a.inst_clause_ptr[q + 1] - c0;
  const int vb = a.inst_var_ptr[q], nv = a.inst_var_ptr[q + 1] - vb;
  if (nc == 0 && nv == 0) return;  // an empty (padding) instance
  const bool global = a.sums != nullptr;
  if (!global) cluster_arrive_relaxed();
  float* pos = global ? a.sums + vb : sh + 3 * PDP_SWEEP_TILE_E;
  float* neg = global ? a.sums + a.n_vars + vb : pos + a.max_inst_vars;
  // a variable's sums go to the global scratch, or into every CTA of the
  // cluster (the same offsets in each)
  const auto store = [&](int v, float p, float n) {
    const int i = v - vb;
    if (global) {
      pos[i] = p;
      neg[i] = n;
      return;
    }
    for (int r = 0; r < cs; ++r) {
      cluster.map_shared_rank(pos, r)[i] = p;
      cluster.map_shared_rank(neg, r)[i] = n;
    }
  };
  const int ca = c0 + cluster_share(nc, rank, cs);
  const int cb = c0 + cluster_share(nc, rank + 1, cs);
  const int va = vb + cluster_share(nv, rank, cs);
  const int vz = vb + cluster_share(nv, rank + 1, cs);
  // phase 1 (every CTA of the cluster has started by the wait)
  if (!a.heavy) {
    // warps 0-3 take the clauses while warps 4-7 take the variables: the
    // two are independent, and their chains of dependent loads overlap
    constexpr int half = PDP_THREADS / 2;
    if ((int)threadIdx.x < half) {
      clause_phase<LOGIN>(a, ca, cb, sh, threadIdx.x, half);
      if (!global) cluster_wait();
    } else {
      if (!global) cluster_wait();
      group_sums(a, va, vz, store, threadIdx.x - half, half);
    }
  } else {
    clause_phase<LOGIN>(a, ca, cb, sh, threadIdx.x, PDP_THREADS);
    if (!global) cluster_wait();
    group_sums(a, va, vz, store);
    heavy_sums(a, cluster, vb, nv, va, vz, store);
  }
  cluster.sync();
  // phase 2: the q-triplet of the edges of this CTA's clauses; the force
  // factor's log is safe_log(1 - pi) where the force agrees, else log(1) =
  // 0 (common.cuh sp_q_triplet)
  const int e1 = a.clause_ptr[cb];
  const float lpi = safe_log(1.0f - a.pi, PDP_LOG_EPS_PROP);
  for (int e = a.clause_ptr[ca] + threadIdx.x; e < e1; e += PDP_THREADS) {
    const int i = a.ev[e] - vb;
    const float p = global ? __ldcg(pos + i) : pos[i];
    const float n = global ? __ldcg(neg + i) : neg[i];
    float o[3];
    const float sign = a.ins[IN_SIGN][e], force = a.ins[IN_FORCE][e];
    sp_q_triplet_lf(p, n, a.ins[IN_ETA][e], a.ins[IN_EM][e],
                    a.ins[IN_MASK][e], sign, force == sign ? lpi : 0.0f,
                    force == -sign ? lpi : 0.0f, a.ins[IN_V0][e],
                    a.ins[IN_V1][e], a.ins[IN_V2][e], o);
    a.outs[OUT_V0][e] = o[0];
    a.outs[OUT_V1][e] = o[1];
    a.outs[OUT_V2][e] = o[2];
  }
}

extern "C" {

// One sweep. Returns the launch's error, or -1 for a group that is not a
// power of two from 4 to 32, a cluster that is not one from 1 to
// PDP_CLUSTER_MAX, or heavy without the pieces' scratch.
int pdp_sp_sweep(const SweepArgs* a) {
  const int g = a->group, cs = a->cluster;
  if (g < 4 || g > 32 || (g & (g - 1)) || cs < 1 || cs > PDP_CLUSTER_MAX ||
      (cs & (cs - 1)) || (a->heavy && !a->pieces))
    return -1;
  const int n_pad = (a->e_total - a->e_real + PDP_SWEEP_PAD_CHUNK - 1) /
                    PDP_SWEEP_PAD_CHUNK;
  const int n_clusters = a->n_inst + (n_pad + cs - 1) / cs;
  const size_t smem =
      (3 * PDP_SWEEP_TILE_E +
       (a->sums ? 0 : 2 * (a->max_inst_vars > 1 ? a->max_inst_vars : 1))) *
      sizeof(float);
  if (n_clusters > 0) {
    const cudaError_t err = launch_clusters(
        a->login ? &sp_sweep_kernel<true> : &sp_sweep_kernel<false>,
        n_clusters, cs, smem, static_cast<cudaStream_t>(a->stream), *a);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
