// Fused and chained edge passes: gather -> elementwise -> reduce.
//
// Replaces the TPU kernels of pdp_solver_tpu/ops/pallas_fused.py:
//   fused_edge_pass   (:553, body _build :167, pallas_call :283)
//   chained_edge_pass (:442, body _build_chained :291, pallas_call :429)
// They compute the same functions; none of the TPU layout machinery
// (one-hot windows, uniform one-hots, VMEM residency) is carried over.
//
// The JAX callers pass closures f / (f1, f2, f3); here each caller is a
// functor struct that fixes its column counts at compile time, and each
// kernel is a template instantiated once per functor.
//
// Layout: the real edges of clause c are [clause_ptr[c], clause_ptr[c+1])
// (clause-major, contiguous); the real edges of variable v are
// var_perm[var_ptr[v] .. var_ptr[v+1]) in increasing edge order. Padding
// edges [e_real, e_total) take part in no reduce (their contributions are
// masked to zero in every functor) but still get their edge outputs.
// A replicated batch (fg/batch.py) also holds padding edges inside
// [0, e_real), each in a padding clause's clause_ptr range while its
// edge_clause names its replica's last real clause (inner_pad 1): the
// clause phase gives such an edge's outputs the columns of the clause
// edge_clause names, recomputed from that clause's edges, as the plain
// version does.
//
// Reduces: one thread per clause (its edges are contiguous) in the chained
// pass's first phase; every reduce to variables (the fused pass's var side
// and the chained pass's second phase) with the group walk of common.cuh
// over the var-major permutation (a group of lanes a variable, several
// blocks for a variable of very high degree). Each sum is taken in one
// fixed order and no float atomics are used: the decimator takes an argmax
// of |score|, so a sum in another order can change which variable is
// fixed. The one-launch SP sweep (sp_sweep.cu) takes its variable sums in
// the walk's order too, so it gives the bits of sp_chain + sp_pass_c.
//
// Bound on the H100: at the bench batch (E = 524,288 padded edges) one pass
// moves a few MB, i.e. a few microseconds at 3.35 TB/s, and does a few
// flops per byte; launch overhead (~3-5 us) and the latency of the
// dependent gathers dominate. The design keeps each pass to one launch
// (two or three for a chained pass: the var walk needs every clause's
// broadcast columns) and every intermediate in registers. Each pass's
// arguments come in one structure that a plan per (functor, batch) fills
// once (ops/fused.py), so a call costs one ctypes call.

#include <cuda_runtime.h>
#include <string.h>

#include "common.cuh"

// ---------------------------------------------------------------------------
// functors. Input layouts must match pdp_solver_tpu_torch/ops/fused.py.
// SIDE: 0 = no reduce (one thread per edge), 1 = reduce to variables.
// (Reduces to clauses are the chained pass's first phase.)
// ---------------------------------------------------------------------------

// SP pass C (propagate.py _sp_pass_c): q-triplet from the polarity-split
// variable sums. in: pos[V], neg[V], eta_in, em, mask, sign, force, v0, v1,
// v2; s = pi. out: three new var messages.
struct SpPassC {
  static const char* name() { return "sp_pass_c"; }
  static constexpr int SIDE = 0, NIN = 10, NR = 0, NE = 3;
  __device__ static void f(const Cols& a, int e, float*, float* o) {
    const int v = a.ev[e];
    sp_q_triplet(a.in[0][v], a.in[1][v], a.in[2][e], a.in[3][e], a.in[4][e],
                 a.in[5][e], a.in[6][e], a.s, a.in[7][e], a.in[8][e],
                 a.in[9][e], o);
  }
};

// SP pass C for the folded p-d-p loop (propagate.py _sp_pass_c_lean): q_u
// alone, the one message of the triplet the loop reads next. in: pos[V],
// neg[V], eta_in, em, mask, sign, force, v0; s = pi. out: the new q_u, the
// bits of sp_pass_c's first output.
struct SpPassCLean {
  static const char* name() { return "sp_pass_c_lean"; }
  static constexpr int SIDE = 0, NIN = 8, NR = 0, NE = 1;
  __device__ static void f(const Cols& a, int e, float*, float* o) {
    const int v = a.ev[e];
    const float v0 = a.in[7][e];
    float q[3];
    sp_q_triplet(a.in[0][v], a.in[1][v], a.in[2][e], a.in[3][e], a.in[4][e],
                 a.in[5][e], a.in[6][e], a.s, v0, v0, v0, q);
    o[0] = q[0];  // q_s and q_dc are dead: the compiler drops them
  }
};

// the eight columns of the decimator's pass (decimate.py
// _smax_scorer_pass) for one edge: the convergence and paramagnetic
// smooth-max columns and the survey scorer's aggregation. Shared by
// SmaxScorer and the sweep folds, which compute them from the sweep's new
// eta, so that both give the same bits. The two products of floats are
// rounded on their own (__fmul_rn), so that no walk contracts one with
// its sum into a multiply-add: the sums are then the bits of the walk's
// order over these terms (ops/reduce.py walk_order_sum); every other
// product here has a 0/1 or +-1 factor and is exact.
__device__ __forceinline__ void smax_scorer_terms(float ac_e, float prev,
                                                  float eta, float em,
                                                  float bmask, float force,
                                                  float sign, float* r) {
  const float diff = fabsf(prev - eta) * em;
  const float cd = safe_exp(30.0f * diff) * bmask;
  const float ce = safe_exp(30.0f * eta) * bmask;
  const float em_s = ac_e * bmask;
  const float fm1 = safe_log(1.0f - eta, PDP_LOG_EPS_SCORE) * em_s;
  r[0] = __fmul_rn(diff, cd);
  r[1] = cd;
  r[2] = __fmul_rn(eta, ce);
  r[3] = ce;
  r[4] = force * bmask;
  r[5] = fm1 * flag(sign == 1.0f);
  r[6] = fm1 * flag(sign == -1.0f);
  r[7] = fm1;
}

// decimator convergence + paramagnetic smooth-max columns and the survey
// scorer's aggregation (decimate.py _smax_scorer_pass). in: ac[F],
// prev_eta, eta, em, bmask, force, sign.
struct SmaxScorer {
  static const char* name() { return "smax_scorer"; }
  static constexpr int SIDE = 1, NIN = 7, NR = 8, NE = 0;
  __device__ static void f(const Cols& a, int e, float* r, float*) {
    smax_scorer_terms(a.in[0][a.ec[e]], a.in[1][e], a.in[2][e], a.in[3][e],
                      a.in[4][e], a.in[5][e], a.in[6][e], r);
  }
};

// decimator convergence smooth-max columns (decimate.py _smax_pass2 :114,
// the same as columns 0-1 of _smax_pass4 :122). in: prev_eta, eta, em,
// bmask. The JAX package takes _smax_pass4 whenever termination is
// tracked, but its paramagnetic columns 2-3 are read for classical message
// states only (decimate.py :270); np-d-np's sequential decimator, over the
// neural propagator's fn[:, 0], reads columns 0-1 alone, so this one
// 2-column functor gives every output np-d-np uses, with or without
// termination tracking.
struct Smax {
  static const char* name() { return "smax"; }
  static constexpr int SIDE = 1, NIN = 4, NR = 2, NE = 0;
  __device__ static void f(const Cols& a, int e, float* r, float*) {
    const float diff = fabsf(a.in[0][e] - a.in[1][e]) * a.in[2][e];
    const float c = safe_exp(30.0f * diff) * a.in[3][e];
    r[0] = diff * c;
    r[1] = c;
  }
};

// survey scorer aggregation (predict.py _scorer_pass). in: ac[F], eta,
// force, sign, mask.
struct Scorer {
  static const char* name() { return "scorer"; }
  static constexpr int SIDE = 1, NIN = 5, NR = 4, NE = 0;
  __device__ static void f(const Cols& a, int e, float* r, float*) {
    const float ac_e = a.in[0][a.ec[e]];
    const float eta = a.in[1][e], force = a.in[2][e], sign = a.in[3][e];
    const float mask = a.in[4][e];
    const float em = ac_e * mask;
    const float fm1 = safe_log(1.0f - eta, PDP_LOG_EPS_SCORE) * em;
    r[0] = force * mask;
    r[1] = fm1 * flag(sign == 1.0f);
    r[2] = fm1 * flag(sign == -1.0f);
    r[3] = fm1;
  }
};

// edge liveness + per-edge instance flag (state.py edge_masks_pair).
// in: av[V], abv[V], ac[F], mask.
struct EmAe {
  static const char* name() { return "em_ae"; }
  static constexpr int SIDE = 0, NIN = 4, NR = 0, NE = 2;
  __device__ static void f(const Cols& a, int e, float*, float* o) {
    const int v = a.ev[e];
    o[0] = a.in[0][v] * a.in[2][a.ec[e]] * a.in[3][e];
    o[1] = a.in[1][v];
  }
};

// edge liveness (state.py compute_edge_mask). in: av[V], ac[F], mask.
struct Em {
  static const char* name() { return "em"; }
  static constexpr int SIDE = 0, NIN = 3, NR = 0, NE = 1;
  __device__ static void f(const Cols& a, int e, float*, float* o) {
    o[0] = a.in[0][a.ev[e]] * a.in[1][a.ec[e]] * a.in[2][e];
  }
};

// per-edge instance flag (state.py edge_active_instance_mask). in: abv[V].
struct Ae {
  static const char* name() { return "ae"; }
  static constexpr int SIDE = 0, NIN = 1, NR = 0, NE = 1;
  __device__ static void f(const Cols& a, int e, float*, float* o) {
    o[0] = a.in[0][a.ev[e]];
  }
};

// --- chained functors: f1 per edge (summed per clause), f2 per clause,
// f3 per edge (summed per variable) ---

// SP sweep A+B (propagate.py _sp_chain_f1/_f2/_f3). in: u_in, eta_in, em,
// mask, eta_state, sign. vred: polarity-split log(1 - eta_in); eout: eta.
// LOGIN: u_in is already log u, p-nd-np's adaptor output
// (_sp_chain_f1_login / _sp_chain_f3(login=True)).
template <bool LOGIN>
struct SpChainOps {
  __device__ static void f1(const Cols& a, int e, float* cr) {
    cr[0] = sp_log_u<LOGIN>(a.in[0][e], a.in[2][e]);
  }
  __device__ static void f2(const Cols&, int, const float* cred, float*,
                            float* bc, float*) {
    bc[0] = cred[0];
  }
  __device__ static void f3(const Cols& a, int e, const float* bc, float* vr,
                            float* o) {
    const float em = a.in[2][e], sign = a.in[5][e];
    o[0] = sp_new_eta(bc[0], sp_log_u<LOGIN>(a.in[0][e], em), a.in[3][e],
                      a.in[4][e]);
    const float lm = sp_lm(a.in[1][e], em);
    vr[0] = lm * flag(sign == 1.0f);
    vr[1] = lm * flag(sign == -1.0f);
  }
};

#define PDP_SP_CHAIN_FORWARD(LOGIN)                                      \
  __device__ static void f1(const Cols& a, int e, float* cr) {            \
    SpChainOps<LOGIN>::f1(a, e, cr);                                      \
  }                                                                       \
  __device__ static void f2(const Cols& a, int c, const float* cred,      \
                            float* co, float* bc, float* ir) {            \
    SpChainOps<LOGIN>::f2(a, c, cred, co, bc, ir);                        \
  }                                                                       \
  __device__ static void f3(const Cols& a, int e, const float* bc,        \
                            float* vr, float* o) {                        \
    SpChainOps<LOGIN>::f3(a, e, bc, vr, o);                               \
  }

struct SpChain {
  static const char* name() { return "sp_chain"; }
  static constexpr int NIN = 6, NCRED = 1, NCOUT = 0, NBC = 1, NVRED = 2,
                       NE = 1, NIRED = 0;
  PDP_SP_CHAIN_FORWARD(false)
};

// the same with u_in = log u (in: log_u_in, eta_in, em, mask, eta_state,
// sign)
struct SpChainLogin {
  static const char* name() { return "sp_chain_login"; }
  static constexpr int NIN = 6, NCRED = 1, NCOUT = 0, NBC = 1, NVRED = 2,
                       NE = 1, NIRED = 0;
  PDP_SP_CHAIN_FORWARD(true)
};
#undef PDP_SP_CHAIN_FORWARD

// one fused simplify round (simplify.py _sround_f1/_f2/_f3). in: av[V],
// sol[V], sign, mask, ac[F]. cout: new active clauses; vred: unit forcing
// (input_num, var_eval) and pure-literal degrees.
struct SimplifyRound {
  static const char* name() { return "sround"; }
  static constexpr int NIN = 5, NCRED = 2, NCOUT = 1, NBC = 2, NVRED = 4,
                       NE = 0, NIRED = 0;
  __device__ static void f1(const Cols& a, int e, float* cr) {
    const int v = a.ev[e];
    const float av_e = a.in[0][v], sol_e = a.in[1][v];
    const float sign = a.in[2][e], mask = a.in[3][e];
    const float lit_true = sign > 0.0f ? flag(sol_e >= 1.0f)
                                       : flag(sol_e <= 0.0f);
    const float assigned = flag(av_e <= 0.0f);
    cr[0] = av_e * mask;
    cr[1] = lit_true * assigned * mask;
  }
  __device__ static void f2(const Cols& a, int c, const float* cred,
                            float* co, float* bc, float*) {
    const float ac2 = cred[1] > 0.0f ? 0.0f : a.in[4][c];
    co[0] = ac2;
    bc[0] = ac2;
    bc[1] = flag(cred[0] == 1.0f) * ac2;
  }
  __device__ static void f3(const Cols& a, int e, const float* bc, float* vr,
                            float*) {
    const float sign = a.in[2][e], mask = a.in[3][e];
    const float s_e = bc[1] * mask, c_e = bc[0] * mask;
    vr[0] = s_e;
    vr[1] = sign * s_e;
    vr[2] = c_e;
    vr[3] = sign * c_e;
  }
};

// hard verification (loss.py _cnf_chain_f1/_f2). in: p[V], sign, mask,
// cm[F]. ired: per-instance (max_sat, got_sat).
struct CnfChain {
  static const char* name() { return "cnf_chain"; }
  static constexpr int NIN = 4, NCRED = 1, NCOUT = 0, NBC = 0, NVRED = 0,
                       NE = 0, NIRED = 2;
  __device__ static void f1(const Cols& a, int e, float* cr) {
    const float sign = a.in[1][e];
    const float lit = sign * a.in[0][a.ev[e]] + (1.0f - sign) / 2.0f;
    cr[0] = flag(lit > 0.5f) * a.in[2][e];
  }
  __device__ static void f2(const Cols& a, int c, const float* cred, float*,
                            float*, float* ir) {
    const float cm = a.in[3][c];
    ir[0] = cm;
    ir[1] = flag(cred[0] > 0.0f) * cm;
  }
  __device__ static void f3(const Cols&, int, const float*, float*, float*) {}
};

// one WalkSAT iteration's energies and flip deltas (solvers/base.py
// _ws_cf1/_ws_cf2_ired/_ws_cf3). in: sa[V] (= assign * av), av[V], sign,
// mask, em, ac[F]. vred: flip delta, unsat count; ired: energy.
struct WalksatChain {
  static const char* name() { return "ws_chain"; }
  static constexpr int NIN = 6, NCRED = 2, NCOUT = 0, NBC = 3, NVRED = 2,
                       NE = 0, NIRED = 1;
  __device__ static void f1(const Cols& a, int e, float* cr) {
    const int v = a.ev[e];
    const float sign = a.in[2][e], mask = a.in[3][e];
    cr[0] = sign * a.in[0][v] * mask;
    cr[1] = a.in[1][v] * mask;
  }
  __device__ static void f2(const Cols& a, int c, const float* cred, float*,
                            float* bc, float* ir) {
    const float unsat = flag(cred[0] == -cred[1]) * a.in[5][c];
    bc[0] = cred[0];
    bc[1] = cred[1];
    bc[2] = unsat;
    ir[0] = unsat;
  }
  __device__ static void f3(const Cols& a, int e, const float* bc, float* vr,
                            float*) {
    const float sign = a.in[2][e], mask = a.in[3][e], em = a.in[4][e];
    const float dist = sign * a.in[0][a.ev[e]] * mask;
    const float agg_e = bc[0] - dist;
    const float critical = flag(agg_e == 1.0f - bc[1]) * em;
    vr[0] = critical * dist;
    vr[1] = bc[2] * mask;
  }
};

// --- the sweep folds of the classical p-d-p loop (propagate.py
// :274-386): the SP sweep's chained pass with the sequential decimator's
// eight columns (SmaxScorer's, from the new eta, with the sweep's
// eta_state as prev_eta: the p-d-p loop's prev_eta) summed per variable
// beside the polarity sums, so the decimator's own pass goes; with the
// mask fold also the edge masks, from active_vars, the per-variable
// instance flag and active_clauses (0/1, so the clause factor is exact at
// f2), emitted as edge outputs in place of the em_ae pass; with the verify
// fold also the CNF check of the current solution, a second clause sum
// and the per-instance (max_sat, got_sat) in place of cnf_chain. Each
// term is computed as the split functors compute it (SpChainOps, EmAe,
// CnfChain, smax_scorer_terms), so the variable sums are their bits. ---

// the sweep's variable terms and eta from the clause's log-u sum: vr[0..1]
// the polarity-split log(1 - eta_in), vr[2..9] the decimator's columns;
// returns the new eta
__device__ __forceinline__ float sp_fold_f3(float cl_sum, float ac_e,
                                            float u_in, float eta_in,
                                            float em, float mask,
                                            float eta_state, float sign,
                                            float force, float bmask,
                                            float* vr) {
  const float new_eta =
      sp_new_eta(cl_sum, sp_log_u<false>(u_in, em), mask, eta_state);
  const float lm = sp_lm(eta_in, em);
  vr[0] = lm * flag(sign == 1.0f);
  vr[1] = lm * flag(sign == -1.0f);
  smax_scorer_terms(ac_e, eta_state, new_eta, em, bmask, force, sign,
                    vr + 2);
  return new_eta;
}

// the decimator fold (propagate.py _sp_chain_f1_dec/_f2_dec/_f3_dec). in:
// ac[F], u_in, eta_in, em, mask, eta_state, sign, force, bmask. vred: the
// polarity sums then the decimator's eight; eout: eta.
struct SpChainDec {
  static const char* name() { return "sp_chain_dec"; }
  static constexpr int NIN = 9, NCRED = 1, NCOUT = 0, NBC = 2, NVRED = 10,
                       NE = 1, NIRED = 0;
  __device__ static void f1(const Cols& a, int e, float* cr) {
    cr[0] = sp_log_u<false>(a.in[1][e], a.in[3][e]);
  }
  __device__ static void f2(const Cols& a, int c, const float* cred, float*,
                            float* bc, float*) {
    bc[0] = cred[0];
    bc[1] = a.in[0][c];
  }
  __device__ static void f3(const Cols& a, int e, const float* bc, float* vr,
                            float* o) {
    o[0] = sp_fold_f3(bc[0], bc[1], a.in[1][e], a.in[2][e], a.in[3][e],
                      a.in[4][e], a.in[5][e], a.in[6][e], a.in[7][e],
                      a.in[8][e], vr);
  }
};

// the mask fold (propagate.py _sp_chain_f1_mask/_f2_mask/_f3_mask) and,
// with VERIFY, the verify fold (_sp_chain_f1_maskv/_f2_maskv). in: av[V],
// abv[V] (the instance flag of each variable), [sol[V],] ac[F], [cm[F],]
// u_in, eta_in, eta_state, sign, force, bmask. vred as SpChainDec's;
// eouts: eta, em, ae; with VERIFY ired: (max_sat, got_sat) per instance.
template <bool VERIFY>
struct SpChainMaskOps {
  static constexpr int V = VERIFY ? 1 : 0;  // the solution's column
  static constexpr int AC = 2 + V, CM = 3 + V, E0 = 3 + 2 * V;
  __device__ static void f1(const Cols& a, int e, float* cr) {
    const int v = a.ev[e];
    const float bm = a.in[E0 + 5][e];
    // the clause factor of em lands at f2 (exact: active_clauses is 0/1)
    cr[0] = sp_u_log<false>(a.in[E0][e]) * a.in[0][v] * bm;
    if (VERIFY) {
      const float sign = a.in[E0 + 3][e];
      const float lit = sign * a.in[2][v] + (1.0f - sign) / 2.0f;
      cr[1] = flag(lit > 0.5f) * bm;
    }
  }
  __device__ static void f2(const Cols& a, int c, const float* cred, float*,
                            float* bc, float* ir) {
    const float ac = a.in[AC][c];
    bc[0] = cred[0] * ac;
    bc[1] = ac;
    if (VERIFY) {
      const float cm = a.in[CM][c];
      ir[0] = cm;
      ir[1] = flag(cred[1] > 0.0f) * cm;
    }
  }
  __device__ static void f3(const Cols& a, int e, const float* bc, float* vr,
                            float* o) {
    const int v = a.ev[e];
    const float bm = a.in[E0 + 5][e];
    const float em = a.in[0][v] * bc[1] * bm;
    const float ae = a.in[1][v];
    o[0] = sp_fold_f3(bc[0], bc[1], a.in[E0][e], a.in[E0 + 1][e], em, ae,
                      a.in[E0 + 2][e], a.in[E0 + 3][e], a.in[E0 + 4][e], bm,
                      vr);
    o[1] = em;
    o[2] = ae;
  }
};

#define PDP_SP_MASK_FORWARD(VERIFY)                                      \
  __device__ static void f1(const Cols& a, int e, float* cr) {            \
    SpChainMaskOps<VERIFY>::f1(a, e, cr);                                 \
  }                                                                       \
  __device__ static void f2(const Cols& a, int c, const float* cred,      \
                            float* co, float* bc, float* ir) {            \
    SpChainMaskOps<VERIFY>::f2(a, c, cred, co, bc, ir);                   \
  }                                                                       \
  __device__ static void f3(const Cols& a, int e, const float* bc,        \
                            float* vr, float* o) {                        \
    SpChainMaskOps<VERIFY>::f3(a, e, bc, vr, o);                          \
  }

struct SpChainMask {
  static const char* name() { return "sp_chain_mask"; }
  static constexpr int NIN = 9, NCRED = 1, NCOUT = 0, NBC = 2, NVRED = 10,
                       NE = 3, NIRED = 0;
  PDP_SP_MASK_FORWARD(false)
};

struct SpChainMaskv {
  static const char* name() { return "sp_chain_maskv"; }
  static constexpr int NIN = 11, NCRED = 2, NCOUT = 0, NBC = 2, NVRED = 10,
                       NE = 3, NIRED = 2;
  PDP_SP_MASK_FORWARD(true)
};
#undef PDP_SP_MASK_FORWARD

#define PDP_FUSED_FNS(X)                                                \
  X(SpPassC) X(SmaxScorer) X(Smax) X(Scorer) X(EmAe) X(Em) X(Ae)         \
  X(SpPassCLean)
#define PDP_CHAINED_FNS(X)                                               \
  X(SpChain) X(SpChainLogin) X(SimplifyRound) X(CnfChain) X(WalksatChain) \
  X(SpChainDec) X(SpChainMask) X(SpChainMaskv)

enum {
#define PDP_ENUM(F) FN_##F,
  PDP_FUSED_FNS(PDP_ENUM) PDP_CHAINED_FNS(PDP_ENUM)
#undef PDP_ENUM
  FN_COUNT
};

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

// no reduce: one thread per edge, all edges (padding included)
template <class F>
__global__ void fused_edge_kernel(Cols a, int e_total) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= e_total) return;
  float r[PDP_N1(F::NR)], o[PDP_N1(F::NE)];
  F::f(a, e, r, o);
#pragma unroll
  for (int c = 0; c < F::NE; ++c) a.eo[c][e] = o[c];
}

// reduce to variables: the group walk of common.cuh over the var-major
// CSR (a group of lanes per variable, several blocks for a variable of
// very high degree), lane by lane F::f on the variable's edges; the
// blocks after the walk's compute the padding edges' outputs.
template <class F>
struct FnTerm {
  Cols a;
  __device__ __forceinline__ void operator()(int e, float* r) const {
    float o[PDP_N1(F::NE)];
    F::f(a, e, r, o);
#pragma unroll
    for (int c = 0; c < F::NE; ++c) a.eo[c][e] = o[c];
  }
};

template <class F>
__global__ void fused_reduce_kernel(WalkPlan p, Cols a, const int* ptr,
                                    const int* perm, float* red, int e_real,
                                    int e_total) {
  const int walk_blocks = p.group_blocks + p.anchor_blocks;
  if ((int)blockIdx.x < walk_blocks) {
    walk_block<F::NR>(p, CsrSeg<int>{ptr, perm, a.ev}, FnTerm<F>{a},
                      SegOut{red, p.n_seg});
    return;
  }
  if (F::NE > 0) {
    const int e =
        e_real + ((int)blockIdx.x - walk_blocks) * blockDim.x + threadIdx.x;
    if (e >= e_total) return;
    float r[PDP_N1(F::NR)], o[PDP_N1(F::NE)];
    F::f(a, e, r, o);
#pragma unroll
    for (int c = 0; c < F::NE; ++c) a.eo[c][e] = o[c];
  }
}

// chained phase 1: one thread per clause. f1 over its edges, the clause
// sum, f2; writes the clause outputs, the broadcast columns and the
// clause-level columns of the instance reduce, and f3's edge outputs of
// the clause's edges (they need only the clause's columns and the edge's
// own inputs, and the clause's edges are contiguous, so neighbouring
// threads write neighbouring runs; the var walk then reads only what its
// sums need).
// clause c's sum of f1 over its edges and f2 of it
template <class F>
__device__ __forceinline__ void clause_columns(const Cols& a,
                                               const int* clause_ptr, int c,
                                               float* co, float* b,
                                               float* ir) {
  float cr[F::NCRED], t[F::NCRED];
#pragma unroll
  for (int i = 0; i < F::NCRED; ++i) cr[i] = 0.0f;
  const int e1 = clause_ptr[c + 1];
  for (int e = clause_ptr[c]; e < e1; ++e) {
    F::f1(a, e, t);
#pragma unroll
    for (int i = 0; i < F::NCRED; ++i) cr[i] += t[i];
  }
  F::f2(a, c, cr, co, b, ir);
}

template <class F>
__global__ void chained_clause_kernel(Cols a, const int* clause_ptr,
                                      int n_clauses, float* cout, float* bc,
                                      float* irc, int inner_pad) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_clauses) return;
  float co[PDP_N1(F::NCOUT)], b[PDP_N1(F::NBC)], ir[PDP_N1(F::NIRED)];
  clause_columns<F>(a, clause_ptr, c, co, b, ir);
  if (F::NE > 0) {
    const int e1 = clause_ptr[c + 1];
    for (int e = clause_ptr[c]; e < e1; ++e) {
      float vr[PDP_N1(F::NVRED)], o[PDP_N1(F::NE)];
      if (inner_pad && a.ec[e] != c) {
        // a padding edge inside the prefix: its own clause's columns
        float co2[PDP_N1(F::NCOUT)], b2[PDP_N1(F::NBC)],
            ir2[PDP_N1(F::NIRED)];
        clause_columns<F>(a, clause_ptr, a.ec[e], co2, b2, ir2);
        F::f3(a, e, b2, vr, o);
      } else {
        F::f3(a, e, b, vr, o);
      }
#pragma unroll
      for (int i = 0; i < F::NE; ++i) a.eo[i][e] = o[i];
    }
  }
#pragma unroll
  for (int i = 0; i < F::NCOUT; ++i) cout[(size_t)i * n_clauses + c] = co[i];
#pragma unroll
  for (int i = 0; i < F::NBC; ++i) bc[(size_t)i * n_clauses + c] = b[i];
#pragma unroll
  for (int i = 0; i < F::NIRED; ++i) irc[(size_t)i * n_clauses + c] = ir[i];
}

// chained phase 2: the group walk of common.cuh over the var-major CSR,
// lane by lane F::f3's variable terms of each edge from its broadcast
// clause columns (the term of the walk; its edge outputs, written by
// phase 1, are dropped unread); the blocks after the walk's compute the
// padding edges' outputs, which are in no clause.
template <class F>
struct ChainTerm {
  Cols a;
  const float* bc;
  int n_clauses;
  // f3 of edge e on its clause's broadcast columns: variable terms r,
  // edge outputs o
  __device__ __forceinline__ void f3(int e, float* r, float* o) const {
    const int c = a.ec[e];
    float b[PDP_N1(F::NBC)];
#pragma unroll
    for (int i = 0; i < F::NBC; ++i) b[i] = bc[(size_t)i * n_clauses + c];
    F::f3(a, e, b, r, o);
  }
  __device__ __forceinline__ void operator()(int e, float* r) const {
    float o[PDP_N1(F::NE)];
    f3(e, r, o);  // o is dead: the compiler drops it and what only it reads
  }
};

template <class F>
__global__ void chained_var_kernel(WalkPlan p, Cols a, const float* bc,
                                   int n_clauses, const int* var_ptr,
                                   const int* var_perm, float* vred,
                                   int e_real, int e_total) {
  static_assert(F::NVRED > 0, "the var phase sums at least one column");
  const ChainTerm<F> term{a, bc, n_clauses};
  const int walk_blocks = p.group_blocks + p.anchor_blocks;
  if ((int)blockIdx.x < walk_blocks) {
    walk_block<F::NVRED>(p, CsrSeg<int>{var_ptr, var_perm, a.ev}, term,
                         SegOut{vred, p.n_seg});
    return;
  }
  if (F::NE > 0) {
    const int e =
        e_real + ((int)blockIdx.x - walk_blocks) * blockDim.x + threadIdx.x;
    if (e >= e_total) return;
    float r[F::NVRED], o[PDP_N1(F::NE)];
    term.f3(e, r, o);
#pragma unroll
    for (int i = 0; i < F::NE; ++i) a.eo[i][e] = o[i];
  }
}

// per-instance sum of clause-level columns: one block per (instance,
// column); strided per-thread sums then a shared-memory tree, a fixed order
// for a fixed block size.
__global__ void instance_sum_kernel(const float* irc, int n_clauses,
                                    const int* inst_clause_ptr, int n_inst,
                                    float* out) {
  __shared__ float sh[PDP_THREADS];
  const int b = blockIdx.x, col = blockIdx.y;
  const float* x = irc + (size_t)col * n_clauses;
  float acc = 0.0f;
  for (int c = inst_clause_ptr[b] + threadIdx.x; c < inst_clause_ptr[b + 1];
       c += blockDim.x)
    acc += x[c];
  sh[threadIdx.x] = acc;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[(size_t)col * n_inst + b] = sh[0];
}

// One chained pass's arguments, filled once per (functor, batch) plan by
// ops/fused.py and passed by pointer (the field order matches its ctypes
// Structure). Clause-major edges [clause_ptr[c], clause_ptr[c+1]), the
// var-major CSR var_ptr/var_perm, the instances' clauses inst_clause_ptr;
// group, heavy, partials, counters: the var walk's (common.cuh WalkPlan).
// cout f32[n_cout, F], vred f32[n_vred, V] and ired f32[n_ired, B] are
// outputs; bc f32[n_bcast, F] and irc f32[n_ired, F] clause-level scratch.
struct ChainedArgs {
  int fn;
  int n_in;
  int n_eout;
  int n_vars;
  int n_clauses;
  int n_inst;
  int e_real;
  int e_total;
  int inner_pad;
  const void* ins[PDP_MAX_IN];
  float* eouts[PDP_MAX_EOUT];
  const int* ev;
  const int* ec;
  const int* var_ptr;
  const int* var_perm;
  const int* clause_ptr;
  const int* inst_clause_ptr;
  int group;
  int heavy;
  float* partials;
  int* counters;
  float* cout;
  float* bc;
  float* irc;
  float* vred;
  float* ired;
  void* stream;
};

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

static int blocks_for(long n) {
  return (int)((n + PDP_THREADS - 1) / PDP_THREADS);
}

template <class F>
static int launch_fused(const Cols& a, const int* ptr, const int* perm,
                        int n_seg, int e_real, int e_total, int group,
                        bool heavy, float* partials, int* counters,
                        float* red, cudaStream_t st) {
  if constexpr (F::SIDE == 0) {
    if (e_total > 0)
      fused_edge_kernel<F><<<blocks_for(e_total), PDP_THREADS, 0, st>>>(
          a, e_total);
  } else {
    WalkPlan p;
    if (!make_walk_plan(n_seg, e_real, group, heavy, partials, counters, &p))
      return -1;
    const long n = (long)p.group_blocks + p.anchor_blocks +
                   (F::NE > 0 ? blocks_for(e_total - e_real) : 0);
    if (n_seg > 0 && n > 0)
      fused_reduce_kernel<F><<<(int)n, PDP_THREADS, 0, st>>>(
          p, a, ptr, perm, red, e_real, e_total);
  }
  return 0;
}

template <class F>
static int launch_chained(const ChainedArgs& f, const Cols& a,
                          cudaStream_t st) {
  static_assert(F::NVRED > 0 || F::NE == 0,
                "edge outputs come from the var phase");
  if (f.n_clauses > 0)
    chained_clause_kernel<F><<<blocks_for(f.n_clauses), PDP_THREADS, 0, st>>>(
        a, f.clause_ptr, f.n_clauses, f.cout, f.bc, f.irc, f.inner_pad);
  if constexpr (F::NVRED > 0) {
    WalkPlan p;
    if (!make_walk_plan(f.n_vars, f.e_real, f.group, f.heavy != 0,
                        f.partials, f.counters, &p))
      return -1;
    const long n = (long)p.group_blocks + p.anchor_blocks +
                   (F::NE > 0 ? blocks_for(f.e_total - f.e_real) : 0);
    if (f.n_vars > 0 && n > 0)
      chained_var_kernel<F><<<(int)n, PDP_THREADS, 0, st>>>(
          p, a, f.bc, f.n_clauses, f.var_ptr, f.var_perm, f.vred, f.e_real,
          f.e_total);
  }
  if (F::NIRED > 0 && f.n_inst > 0)
    instance_sum_kernel<<<dim3(f.n_inst, F::NIRED), PDP_THREADS, 0, st>>>(
        f.irc, f.n_clauses, f.inst_clause_ptr, f.n_inst, f.ired);
  return 0;
}

struct FnInfo {
  const char* name;
  int meta[10];  // kind, side, n_in, n_red, n_eout, n_cred, n_cout, n_bcast,
                 // n_vred, n_ired
};

template <class F>
static FnInfo fused_info() {
  return {F::name(), {0, F::SIDE, F::NIN, F::NR, F::NE, 0, 0, 0, 0, 0}};
}

template <class F>
static FnInfo chained_info() {
  return {F::name(),
          {1, 0, F::NIN, 0, F::NE, F::NCRED, F::NCOUT, F::NBC, F::NVRED,
           F::NIRED}};
}

static bool fn_info(int id, FnInfo* out) {
  switch (id) {
#define PDP_INFO_F(F) \
  case FN_##F:        \
    *out = fused_info<F>(); \
    return true;
#define PDP_INFO_C(F) \
  case FN_##F:        \
    *out = chained_info<F>(); \
    return true;
    PDP_FUSED_FNS(PDP_INFO_F)
    PDP_CHAINED_FNS(PDP_INFO_C)
#undef PDP_INFO_F
#undef PDP_INFO_C
    default:
      return false;
  }
}

static Cols make_cols(const void* const* ins, int n_in, float* const* eouts,
                      int n_eout, const int* ev, const int* ec, float s) {
  Cols a;
  memset(&a, 0, sizeof(a));
  for (int i = 0; i < n_in && i < PDP_MAX_IN; ++i)
    a.in[i] = static_cast<const float*>(ins[i]);
  for (int i = 0; i < n_eout && i < PDP_MAX_EOUT; ++i) a.eo[i] = eouts[i];
  a.ev = ev;
  a.ec = ec;
  a.s = s;
  return a;
}

extern "C" {

// Id of the functor `name`, with its column counts in meta[10]; -1 if the
// library has no such functor.
int pdp_fn_lookup(const char* name, int* meta) {
  for (int id = 0; id < FN_COUNT; ++id) {
    FnInfo info;
    if (fn_info(id, &info) && strcmp(info.name, name) == 0) {
      for (int i = 0; i < 10; ++i) meta[i] = info.meta[i];
      return id;
    }
  }
  return -1;
}

// One fused pass's arguments, filled once per (functor, batch) plan by
// ops/fused.py and passed by pointer (the field order matches its ctypes
// Structure). ptr/perm: var_ptr/var_perm for a var-side reduce, unused
// otherwise; group: lanes a variable of the walk, heavy: a variable may
// hold PDP_HEAVY_ITERS * group edges or more, partials/counters: the
// walk's scratch with heavy (common.cuh WalkPlan); red: f32[n_red, n_seg].
struct FusedArgs {
  int fn;
  int n_in;
  int n_eout;
  int n_seg;
  const void* ins[PDP_MAX_IN];
  float* eouts[PDP_MAX_EOUT];
  const int* ev;
  const int* ec;
  const int* ptr;
  const int* perm;
  int e_real;
  int e_total;
  int group;
  float scalar;
  float* red;
  int heavy;
  float* partials;
  int* counters;
  void* stream;
};

// One fused pass. Returns cudaGetLastError(), or -1 for an id that is not
// a fused functor, a group width that is not a power of two from 4 to 32,
// or heavy without scratch.
int pdp_fused_edge_pass(const FusedArgs* f) {
  const Cols a = make_cols(f->ins, f->n_in, f->eouts, f->n_eout, f->ev,
                           f->ec, f->scalar);
  cudaStream_t st = static_cast<cudaStream_t>(f->stream);
  int rc;
  switch (f->fn) {
#define PDP_CASE(F)                                                     \
  case FN_##F:                                                          \
    rc = launch_fused<F>(a, f->ptr, f->perm, f->n_seg, f->e_real,       \
                         f->e_total, f->group, f->heavy != 0,           \
                         f->partials, f->counters, f->red, st);         \
    break;
    PDP_FUSED_FNS(PDP_CASE)
#undef PDP_CASE
    default:
      return -1;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// One chained pass (two or three launches). Returns cudaGetLastError(), or
// -1 for an id that is not a chained functor, a group width that is not a
// power of two from 4 to 32, or heavy without scratch.
int pdp_chained_edge_pass(const ChainedArgs* f) {
  const Cols a = make_cols(f->ins, f->n_in, f->eouts, f->n_eout, f->ev,
                           f->ec, 0.0f);
  cudaStream_t st = static_cast<cudaStream_t>(f->stream);
  int rc;
  switch (f->fn) {
#define PDP_CASE(F)                      \
  case FN_##F:                           \
    rc = launch_chained<F>(*f, a, st);   \
    break;
    PDP_CHAINED_FNS(PDP_CASE)
#undef PDP_CASE
    default:
      return -1;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
