// step_linesearch: rung pick, step recovery, fraction-to-boundary, the
// filter line search and the masked state update.
//
// Replaces: the JAX package's solver/ipm.py :1126-1196 (the step and the
// filter line search of the Newton body), whose trials re-evaluate
// models/obca.py objective / eq_constraints / ineq_constraints.
// Bound on this card: latency. Per lane the work is up to n_backtracks
// evaluations of the objective and ~400-6500 constraint rows plus a
// handful of reductions, a few KB of input; a trial spread over a whole
// CTA is a chain of barriers with one or two rows a thread between them.
//
// The JAX code evaluates every trial alpha_j = a_s 2^-j and takes the
// largest accepted alpha. The alphas decrease, so that is the first
// accepted trial: a trial after it changes nothing, and the search may
// stop there. Two routes, picked on the host by ls_route (mirrored by
// kernels.ls_route) from the batch, the trial count and the widths:
//
//  * group: one CTA a lane. The pick, the recovery of ds / dw and the
//    step bounds and reference point are CTA-wide; then G trial groups (a
//    warp each, or 2-4 warps at wide lanes) evaluate G trials at once, in
//    trial order, each forming its own trial point and reducing with warp
//    shuffles (a group barrier, never a CTA barrier, inside a trial).
//    After each round one barrier, and one thread applies the filter rule
//    in trial order; the search ends at the first round holding an
//    accepted trial. A lane whose step is bad evaluates no trial.
//  * spread: where B x n_backtracks is small against the card's 132 SMs
//    (the open loop's 2-5 lanes at N = 50-74), a CTA per (lane, trial)
//    recovers the step and evaluates its one trial CTA-wide with the
//    provider's own evaluation code, writing phi and theta to a (B, nb)
//    workspace (trial 0's CTA also writes ds, dw and the scalars); a
//    second launch, a CTA a lane, applies the filter and the update. No
//    early stop: the trials run at once on otherwise idle SMs.
//
// A lane's sums run in the group route's order on both routes, so that a
// lane's bits do not depend on its route, which the batch size picks (a
// compacted solve, solver/compact.py, runs the same lanes at smaller
// batches): every term rounded alone before it is added (ls_add), the
// reference point's terms summed by as many threads as the group route's
// CTA has, a trial's by as many as one of its groups, with the same
// shuffles. The spread route's whole CTA evaluates the terms, LS_STAGE at
// a time into shared memory, and that many of its threads sum each chunk.
// A CTA's arrays live in shared memory, or in a per-CTA device workspace
// once they outgrow 227 KB (common.cuh ArenaPlace). The update selects,
// never multiplies (a rejected direction may hold NaN); a trial whose phi
// is not finite is not accepted; the fraction-to-boundary ratio divides
// only where the step is negative. Sums stay in T. Every variant: the trial
// rows come from obca_eval.cuh (the heading band of fix_eq_band, the
// offsets moved with T under coupled motion) and a block's dense rows read
// its S = 3 or 4 spine slots (T, position 0, the fourth).
#include "obca_eval.cuh"

// The route's constants, each mirrored in kernels/__init__.py under the
// same name.
#define LS_MAX_G 4            // trial groups a CTA, group route
#define LS_NARROW_ROWS 512    // mE + mI up to which a group is one warp
#define LS_WIDE_ROWS 2048     // ... two warps; above, four
#define LS_SPREAD_CTAS 264    // B x nb up to which the spread route runs (2 x 132 SMs; at the
                              // host driver's 2-5 lanes faster than the group route,
                              // scripts/kernel_turns.py --times)
#define LS_SPREAD_THREADS 512 // threads a CTA, spread route (both launches)
#define LS_MAX_NB 32          // n_backtracks, at most
#define LS_SC 16              // shared scalars a CTA
#define LS_RED (4 * 32)       // CTA reduction scratch: 4 values x 32 warps
#define LS_WS 8               // scalars a lane in the spread route's workspace
#define LS_STAGE 1024         // trial terms a chunk, spread route (a multiple of every group's
                              // threads, so that a chunk keeps each thread's order)

#ifndef VMP_NAMED_BARRIER
#define VMP_NAMED_BARRIER(id, n) __syncthreads()
#endif

template <typename T>
struct LSArgs {
  const T* sols;
  const unsigned char* goods;
  const T *ladder, *zv, *s, *y, *w, *mu_b, *delta, *cI, *cE, *f0, *JD_sp, *JDb_p, *JDb_q, *sgn,
      *id_off, *data, *sf, *scE, *scD, *ds;
  const long long* id_idx;
  T *zv_n, *s_n, *y_n, *w_n, *delta_n;
  T* work;  // spread route: (B, ls_work_elems) per-lane workspace
};

struct LSOpt {
  double tau_min, kappa_sigma, delta0, delta_max, dual_reg;
  int R, nb;
  int cgw, cthreads;   // the group route's warps a group and threads a CTA (ls_group_shape)
};

// ------------------------------------------------------------ the route
struct LsRoute {
  int spread;         // 0 group, 1 spread
  int ctas;           // CTAs a lane: 1 group, nb spread (the update launch: 1)
  int groups;         // trial groups a CTA (spread: 1, the whole CTA)
  int group_warps;    // warps a group
  int threads;        // threads a CTA
  size_t arena;       // bytes a CTA
};

inline size_t ls_r8(size_t count, size_t elem) { return (count * elem + 7) / 8 * 8; }

// Bytes of a CTA's arena (kernels.ls_arena_bytes): the lane's packed
// data, dz, ds, the reduction scratch and the scalars; spread: the trial
// point, its block terms and two chunks of staged terms; group: dw, phi / theta of every trial and,
// per group, its trial point, block terms and reduction slots.
inline size_t ls_arena(const Dims& D, const DataOff& O, int nb, size_t e, int spread, int G,
                       int GW) {
  const size_t lane = ls_r8(O.total, e) + ls_r8(D.n, e) + ls_r8(D.mI, e) + ls_r8(LS_RED, e) +
                      ls_r8(LS_SC, e);
  if (spread) return lane + ls_r8(D.n, e) + 8 * ls_r8(D.K, e) + 2 * ls_r8(LS_STAGE, e);
  return lane + ls_r8(D.mI, e) + 2 * ls_r8(nb, e) +
         size_t(G) * (ls_r8(D.n, e) + 8 * ls_r8(D.K, e) + ls_r8(3 * GW, e));
}

// The group route's shape, whatever the batch: min(nb, LS_MAX_G) groups
// (fewer where the arena would outgrow shared memory) of GW = 1, 2 or 4
// warps by the lane's rows.
inline void ls_group_shape(const Dims& D, const DataOff& O, int nb, size_t e, int& G, int& GW) {
  const int rows = D.mE + D.mI;
  GW = rows <= LS_NARROW_ROWS ? 1 : (rows <= LS_WIDE_ROWS ? 2 : 4);
  G = nb < LS_MAX_G ? nb : LS_MAX_G;
  while (G > 1 && ls_arena(D, O, nb, e, 0, G, GW) > VMP_SMEM_MAX) --G;
}

// The route (kernels.ls_route): spread where B x nb <= LS_SPREAD_CTAS;
// else a CTA a lane of the group shape (ls_group_shape).
inline LsRoute ls_route(const Dims& D, const DataOff& O, long long B, int nb, size_t e) {
  LsRoute r;
  if (B * nb <= LS_SPREAD_CTAS) {
    r.spread = 1;
    r.ctas = nb;
    r.groups = 1;
    r.group_warps = LS_SPREAD_THREADS / 32;
    r.threads = LS_SPREAD_THREADS;
    r.arena = ls_arena(D, O, nb, e, 1, 1, 1);
    return r;
  }
  int G, GW;
  ls_group_shape(D, O, nb, e, G, GW);
  r.spread = 0;
  r.ctas = 1;
  r.groups = G;
  r.group_warps = GW;
  r.threads = G * GW * 32;
  r.arena = ls_arena(D, O, nb, e, 0, G, GW);
  return r;
}

// Elements a lane of the spread route's workspace (kernels.ls_work_elems):
// phi and theta of every trial, LS_WS scalars, ds and dw.
__host__ __device__ inline size_t ls_work_elems(const Dims& D, int nb) {
  return 2 * size_t(nb) + LS_WS + 2 * size_t(D.mI);
}

enum { WS_BAD, WS_AS, WS_AW, WS_PHI0, WS_TH0 };           // workspace scalars
enum { SC_PICK, SC_GOOD, SC_ALPHA, SC_FOUND };             // shared scalars

// ----------------------------------------------------------- reductions
// A product rounded alone, never fused into the subtraction that follows,
// so that the two routes' kernels round phi alike; a sum whose terms are
// each rounded alone before they are added, whether a term was just
// computed (group route) or staged (spread route).
__device__ __forceinline__ float ls_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double ls_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float ls_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double ls_add(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
  for (int o = 16; o > 0; o >>= 1) v = nan_min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// NV values reduced over the CTA in one pass (two barriers); value k is a
// NaN-propagating min where bit k of min_mask is set, else a sum. Every
// thread gets the results. scratch holds LS_RED values (NV <= 4).
template <int NV, typename T>
__device__ __forceinline__ void cta_reduce(T (&v)[NV], unsigned min_mask, T* scratch) {
  for (int k = 0; k < NV; ++k) v[k] = ((min_mask >> k) & 1u) ? warp_min(v[k]) : warp_sum(v[k]);
  const int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  __syncthreads();   // the previous reduction's reads are done
  if ((threadIdx.x & 31) == 0)
    for (int k = 0; k < NV; ++k) scratch[k * 32 + w] = v[k];
  __syncthreads();
  for (int k = 0; k < NV; ++k) {
    T r = scratch[k * 32];
    for (int i = 1; i < nw; ++i) r = ((min_mask >> k) & 1u) ? nan_min(r, scratch[k * 32 + i])
                                                            : r + scratch[k * 32 + i];
    v[k] = r;
  }
}

// ------------------------------------------------------------- the lane
template <typename T>
struct LsLane {
  const T *s, *w, *cI, *cE, *sgn, *id_off, *JD, *JDp, *JDq, *scE, *scD, *zv;
  T mu, sf;
};

template <typename T>
__device__ __forceinline__ LsLane<T> lane_of(const LSArgs<T>& a, const Dims& D, int b) {
  LsLane<T> l;
  l.s = a.s + size_t(b) * D.mI;
  l.w = a.w + size_t(b) * D.mI;
  l.cI = a.cI + size_t(b) * D.mI;
  l.cE = a.cE + size_t(b) * D.mE;
  l.sgn = a.sgn + size_t(b) * D.m_id;
  l.id_off = a.id_off + size_t(b) * D.m_id;
  l.JD = a.JD_sp + size_t(b) * D.mD_sp * D.np_;
  l.JDp = a.JDb_p + size_t(b) * D.K * 2 * D.S;
  l.JDq = a.JDb_q + size_t(b) * D.K * 2 * D.bq;
  l.scE = a.scE + size_t(b) * D.mE;
  l.scD = a.scD + size_t(b) * D.mD;
  l.zv = a.zv + size_t(b) * D.n;
  l.mu = a.mu_b[b];
  l.sf = a.sf[b];
  return l;
}

// The picked rung: the first good one, else the last (sc[SC_PICK],
// sc[SC_GOOD]); CTA-wide, ends synced.
template <typename T>
__device__ __forceinline__ void ls_pick(const LSArgs<T>& a, int b, int R, T* sc) {
  if (threadIdx.x == 0) {
    int first = -1;
    for (int j = 0; j < R; ++j)
      if (a.goods[b * R + j]) { first = j; break; }
    sc[SC_PICK] = T(first >= 0 ? first : R - 1);
    sc[SC_GOOD] = T(first >= 0 ? 1 : 0);
    sc[SC_FOUND] = T(0);
  }
  __syncthreads();
}

// dz of the picked rung into dz and whether the step is bad (no good rung
// or a non-finite direction); when it is not, ds = JI dz + (cI - s) into
// dsr: the identity and box rows a thread a row, the dense rows JD_sp a
// warp a row (coalesced). CTA-wide, after ls_pick; ends synced.
template <typename T>
__device__ __forceinline__ bool ls_recover(const LSArgs<T>& a, const Dims& D, const LsLane<T>& l,
                                           const T* sol, T* dz, T* dsr, T* red, T* sc) {
  const int tid = threadIdx.x, nt = blockDim.x, n = D.n;
  T nonfin[1] = {T(0)};
  for (int i = tid; i < n + D.mE; i += nt) {
    const T v = sol[i];
    nonfin[0] += isfinite(v) ? T(0) : T(1);
    if (i < n) dz[i] = v;
  }
  cta_reduce<1>(nonfin, 0u, red);   // also publishes dz
  if (!(sc[SC_GOOD] > T(0) && nonfin[0] == T(0))) return true;
  for (int j = tid; j < D.mI; j += nt) {
    T v;
    if (j < D.m_id) {
      v = l.sgn[j] * dz[a.id_idx[j]];
    } else {
      const int r = j - D.m_id - D.mD_sp;
      if (r < 0) continue;   // a dense row: below
      const int rr = r / D.K, kb = r % D.K;
      v = 0;
      for (int sl = 0; sl < D.S; ++sl)
        v += l.JDp[(kb * 2 + rr) * D.S + sl] * dz[p_flat(D, slot_pos(D, sl, kb))];
      for (int c = 0; c < D.bq; ++c) v += l.JDq[(kb * 2 + rr) * D.bq + c] * dz[q_flat(D, kb, c)];
    }
    dsr[j] = v + (l.cI[j] - l.s[j]);
  }
  const int lane = tid & 31;
  for (int r = tid >> 5; r < D.mD_sp; r += nt >> 5) {
    T v = 0;
    for (int c = lane; c < D.np_; c += 32) v += l.JD[size_t(r) * D.np_ + c] * dz[p_flat(D, c)];
    v = warp_sum(v);
    if (lane == 0) {
      const int j = D.m_id + r;
      dsr[j] = v + (l.cI[j] - l.s[j]);
    }
  }
  __syncthreads();
  return false;
}

// Inequality row j's share of the step bounds (minima, into v[0], v[1]:
// their order does not matter) and its terms of sum log s (lgj) and of
// theta0 (thj); dw_j into dw where it is given.
template <typename T>
__device__ __forceinline__ void ref_row(const LsLane<T>& l, const T* dsr, T* dw, T mu, T tau,
                                        int j, T (&v)[4], T& lgj, T& thj) {
  const T s = l.s[j], w = l.w[j], d = dsr[j];
  const T dwj = -(s * w - mu + w * d) / s;
  if (dw) dw[j] = dwj;
  if (d < T(0)) v[0] = nan_min(v[0], -tau * s / d);
  if (dwj < T(0)) v[1] = nan_min(v[1], -tau * w / dwj);
  lgj = log(s);
  thj = fabs(l.cI[j] - s);
}

// The step bounds a_s, a_w (fraction to the boundary) and the filter's
// reference point phi0, theta0; dw = -(s w - mu + w ds) / s into dw where
// it is given. The two sums run in the group route's order on both
// routes: each term rounded alone, summed by ntc threads (the group
// route's CTA width), rows tid, tid + ntc, ... (the inequality rows, then
// |cE|). A CTA of ntc threads (group route, stage null) sums as it goes;
// a wider one (spread route) evaluates the rows over all its threads into
// stage / stage2, LS_STAGE rows at a time, and its first ntc threads sum
// each chunk. CTA-wide: every thread gets the four values.
template <typename T>
__device__ __forceinline__ void ls_reference(const LSArgs<T>& a, const Dims& D, const LsLane<T>& l,
                                             int b, const T* dsr, T* dw, T tau_min, int ntc,
                                             T* stage, T* stage2, T* red, T (&out)[4]) {
  const T mu = l.mu;
  const T tau = nan_max(tau_min, T(1) - mu);
  const int tid = threadIdx.x, nt = blockDim.x;
  T v[4] = {T(1), T(1), T(0), T(0)};   // a_s, a_w, sum log s, theta0
  if (stage == nullptr) {
    for (int j = tid; j < D.mI; j += nt) {
      T lgj, thj;
      ref_row(l, dsr, dw, mu, tau, j, v, lgj, thj);
      v[2] = ls_add(v[2], lgj);
      v[3] = ls_add(v[3], thj);
    }
    for (int r = tid; r < D.mE; r += nt) v[3] = ls_add(v[3], fabs(l.cE[r]));
  } else {
    const bool sums = tid < ntc;
    for (int c0 = 0; c0 < D.mI; c0 += LS_STAGE) {
      const int c1 = min(D.mI, c0 + LS_STAGE);
      for (int j = c0 + tid; j < c1; j += nt)
        ref_row(l, dsr, dw, mu, tau, j, v, stage2[j - c0], stage[j - c0]);
      __syncthreads();
      if (sums)
        for (int j = c0 + tid; j < c1; j += ntc) {
          v[2] = ls_add(v[2], stage2[j - c0]);
          v[3] = ls_add(v[3], stage[j - c0]);
        }
      __syncthreads();
    }
    for (int c0 = 0; c0 < D.mE; c0 += LS_STAGE) {
      const int c1 = min(D.mE, c0 + LS_STAGE);
      for (int r = c0 + tid; r < c1; r += nt) stage[r - c0] = fabs(l.cE[r]);
      __syncthreads();
      if (sums)
        for (int r = c0 + tid; r < c1; r += ntc) v[3] = ls_add(v[3], stage[r - c0]);
      __syncthreads();
    }
  }
  cta_reduce<4>(v, 3u, red);
  out[0] = nan_min(v[0], T(1));
  out[1] = nan_min(v[1], T(1));
  out[2] = a.f0[b] - ls_mul(mu, v[2]);   // phi0
  out[3] = v[3];                         // theta0
}

// Filter acceptance (g_th = 1e-5, ipm.py:1156).
template <typename T>
__device__ __forceinline__ bool ls_accept(T ph, T th, T phi0, T th0) {
  const T g_th = T(1e-5);
  return isfinite(ph) && ((th <= T(1.0 - 1e-5) * th0) || (ph <= phi0 - g_th * th0));
}

template <typename T>
__device__ __forceinline__ T pow2m(int j) { return T(1.0 / double(1ull << j)); }   // 2^-j, exact

// The filter over trials [j0, j1) in trial order, by one thread: at the
// first accepted one sc[SC_ALPHA] = a_s 2^-j and sc[SC_FOUND] = 1.
template <typename T>
__device__ __forceinline__ void ls_first_accepted(const T* phi, const T* th, int j0, int j1, T as,
                                                  T phi0, T th0, T* sc) {
  for (int j = j0; j < j1; ++j)
    if (ls_accept(phi[j], th[j], phi0, th0)) {
      sc[SC_ALPHA] = as * pow2m<T>(j);
      sc[SC_FOUND] = T(1);
      return;
    }
}

// Equality row r's term of theta at the trial (al, zn): |scE_r cE_r|.
template <typename T>
__device__ __forceinline__ T eq_term(const LaneView<T>& L, const BlockTerms<T>& bt,
                                     const LsLane<T>& l, int r) {
  return fabs(l.scE[r] * eq_row(L, bt, r));
}

// Inequality row j's terms at the trial: log st into lgj and |cI_j - st|
// into thj, st = s + al ds (identity rows from zv + al dz directly).
template <typename T>
__device__ __forceinline__ void ineq_terms(const LSArgs<T>& a, const LaneView<T>& L,
                                           const BlockTerms<T>& bt, const LsLane<T>& l,
                                           const T* dz, const T* dsr, T al, int j, T& lgj,
                                           T& thj) {
  const Dims& D = L.D;
  const T st = l.s[j] + al * dsr[j];
  lgj = log(st);
  T ci;
  if (j < D.m_id) {
    const long long i = a.id_idx[j];
    ci = l.sgn[j] * (l.zv[i] + al * dz[i]) + l.id_off[j];
  } else {
    ci = l.scD[j - D.m_id] * dineq_row(L, bt, j - D.m_id);
  }
  thj = fabs(ci - st);
}

// This thread's share of theta and of sum log s at the trial: the
// equality rows' terms, then the inequality rows', rows rank, rank + size,
// ... (the order the spread route's staged sums keep).
template <typename T>
__device__ __forceinline__ void trial_rows(const LSArgs<T>& a, const LaneView<T>& L,
                                           const BlockTerms<T>& bt, const LsLane<T>& l,
                                           const T* dz, const T* dsr, T al, int rank, int size,
                                           T& th, T& lg) {
  const Dims& D = L.D;
  for (int r = rank; r < D.mE; r += size) th = ls_add(th, eq_term(L, bt, l, r));
  for (int j = rank; j < D.mI; j += size) {
    T lgj, thj;
    ineq_terms(a, L, bt, l, dz, dsr, al, j, lgj, thj);
    lg = ls_add(lg, lgj);
    th = ls_add(th, thj);
  }
}

// The masked update with the kappa_Sigma safeguard and the delta memory;
// dz is the picked direction (sol's first n entries), dy = -sol[n:].
template <typename T>
__device__ __forceinline__ void ls_update(const LSArgs<T>& a, const Dims& D, const LSOpt& opt,
                                          const LsLane<T>& l, int b, int pick, const T* sol,
                                          const T* dz, const T* dsr, const T* dw, T alpha, T a_wd,
                                          bool step_ok) {
  const int tid = threadIdx.x, nt = blockDim.x, n = D.n;
  if (tid == 0) {
    const T dused = a.ladder[b * opt.R + pick], dl0 = a.delta[b];
    a.delta_n[b] = step_ok ? nan_max(T(opt.delta0), dused / T(30))
                           : nan_min(T(opt.delta_max), nan_max(dl0 * T(100), T(1e-4)));
  }
  for (int i = tid; i < n; i += nt)
    a.zv_n[size_t(b) * n + i] = step_ok ? l.zv[i] + alpha * dz[i] : l.zv[i];
  const T* y = a.y + size_t(b) * D.mE;
  for (int r = tid; r < D.mE; r += nt)
    a.y_n[size_t(b) * D.mE + r] = step_ok ? y[r] + alpha * (-sol[n + r]) : y[r];
  const T ks = T(opt.kappa_sigma), mu = l.mu;
  for (int j = tid; j < D.mI; j += nt) {
    const T sn = step_ok ? l.s[j] + alpha * dsr[j] : l.s[j];
    const T wt = step_ok ? l.w[j] + a_wd * dw[j] : l.w[j];
    a.s_n[size_t(b) * D.mI + j] = sn;
    a.w_n[size_t(b) * D.mI + j] = nan_min(nan_max(wt, mu / (ks * sn)), ks * mu / sn);
  }
}

template <typename T>
__device__ __forceinline__ void stage_data(const LSArgs<T>& a, const DataOff& O, int b, T* sd) {
  const T* dl = a.data + size_t(b) * O.total;
  for (int i = threadIdx.x; i < O.total; i += blockDim.x) sd[i] = dl[i];
}

// ----------------------------------------------------------- group route
// A trial group: `size` threads (one or more whole warps), rank 0..size-1.
struct LsGroup {
  int g, rank, size;
  __device__ __forceinline__ void sync() const {
    if (size == 32) {
      __syncwarp();
    } else {
#if defined(__CUDA_ARCH__)
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "r"(size) : "memory");
#else
      VMP_NAMED_BARRIER(1 + g, size);
#endif
    }
  }
};

// The arena's base: dynamic shared memory (SHARED, known at compile time,
// so that the arrays are addressed as shared memory) or this CTA's slice of
// the device workspace.
template <bool SHARED>
__device__ __forceinline__ void* arena_base(const ArenaPlace& place, double* smem) {
  return SHARED ? static_cast<void*>(smem)
                : static_cast<void*>(place.work + size_t(blockIdx.x) * place.bytes);
}

template <typename T, bool SHARED>
__global__ void __launch_bounds__(512)
    ls_group_kernel(LSArgs<T> a, Dims D, DataOff O, LSOpt opt, LsRoute rt, ArenaPlace place) {
  extern __shared__ double smem_raw[];
  SmemArena ar(arena_base<SHARED>(place, smem_raw));
  const int b = blockIdx.x, n = D.n, nb = opt.nb, K = D.K;
  const int G = rt.groups, gsize = rt.group_warps * 32;

  T* sd = ar.take<T>(O.total);
  T* dz = ar.take<T>(n);
  T* dsr = ar.take<T>(D.mI);
  T* red = ar.take<T>(LS_RED);
  T* sc = ar.take<T>(LS_SC);
  T* dw = ar.take<T>(D.mI);
  T* phis = ar.take<T>(nb);
  T* ths = ar.take<T>(nb);
  const LsGroup grp{int(threadIdx.x) / gsize, int(threadIdx.x) % gsize, gsize};
  T *zn = nullptr, *gred = nullptr;
  BlockTerms<T> bt;
  for (int g = 0; g < G; ++g) {   // every group's slice; keep this thread's
    T* z = ar.take<T>(n);
    BlockTerms<T> t;
    t.take(ar, K);
    T* r = ar.take<T>(3 * rt.group_warps);
    if (g == grp.g) {
      zn = z;
      bt = t;
      gred = r;
    }
  }

  stage_data(a, O, b, sd);
  ls_pick(a, b, opt.R, sc);
  const int pick = int(sc[SC_PICK]);
  const T* sol = a.sols + (size_t(b) * opt.R + pick) * (n + D.mE);
  const LsLane<T> l = lane_of(a, D, b);
  const bool bad = ls_recover(a, D, l, sol, dz, dsr, red, sc);
  T alpha = 0, a_wd = 0;
  bool step_ok = false;
  if (!bad) {
    T ref[4];
    ls_reference(a, D, l, b, dsr, dw, T(opt.tau_min), opt.cthreads, (T*)nullptr, (T*)nullptr,
                 red, ref);
    const T as = ref[0], phi0 = ref[2], th0 = ref[3];
    const LaneView<T> L{D, O, sd, zn};
    const T dual_reg = T(opt.dual_reg);
    const int warp = grp.rank >> 5, lane = grp.rank & 31;
    for (int r0 = 0; r0 < nb; r0 += G) {
      const int jt = r0 + grp.g;
      if (jt < nb) {   // uniform over the group
        const T al = as * pow2m<T>(jt);
        for (int i = grp.rank; i < n; i += gsize) zn[i] = (l.zv[i] + al * dz[i]) * a.ds[i];
        grp.sync();
        for (int kb = grp.rank; kb < K; kb += gsize) block_term(L, bt, kb);
        grp.sync();
        const T dt = L.dt();
        T f = 0, th = 0, lg = 0;
        for (int i = grp.rank; i < objective_items(D); i += gsize)
          f = ls_add(f, objective_item(L, i, dt, dual_reg));
        trial_rows(a, L, bt, l, dz, dsr, al, grp.rank, gsize, th, lg);
        f = warp_sum(f);
        th = warp_sum(th);
        lg = warp_sum(lg);
        if (gsize > 32) {
          if (lane == 0) {
            gred[3 * warp] = f;
            gred[3 * warp + 1] = th;
            gred[3 * warp + 2] = lg;
          }
          grp.sync();
          f = gred[0];
          th = gred[1];
          lg = gred[2];
          for (int k = 1; k < rt.group_warps; ++k) {
            f += gred[3 * k];
            th += gred[3 * k + 1];
            lg += gred[3 * k + 2];
          }
        }
        if (grp.rank == 0) {
          phis[jt] = ls_mul(l.sf, f) - ls_mul(l.mu, lg);
          ths[jt] = th;
        }
      }
      __syncthreads();
      if (threadIdx.x == 0)   // the filter, in trial order
        ls_first_accepted(phis, ths, r0, r0 + G < nb ? r0 + G : nb, as, phi0, th0, sc);
      __syncthreads();
      if (sc[SC_FOUND] > T(0)) break;
    }
    step_ok = sc[SC_FOUND] > T(0);
    alpha = step_ok ? sc[SC_ALPHA] : T(0);
    a_wd = step_ok ? ref[1] : T(0);
  }
  ls_update(a, D, opt, l, b, pick, sol, dz, dsr, dw, alpha, a_wd, step_ok);
}

// ---------------------------------------------------------- spread route
template <typename T>
__device__ __forceinline__ T* lane_work(const LSArgs<T>& a, const Dims& D, int nb, int b) {
  return a.work + size_t(b) * ls_work_elems(D, nb);
}

// Launch 1: a CTA per (lane, trial), blockIdx.x = b * nb + j.
template <typename T, bool SHARED>
__global__ void __launch_bounds__(LS_SPREAD_THREADS)
    ls_trial_kernel(LSArgs<T> a, Dims D, DataOff O, LSOpt opt, ArenaPlace place) {
  extern __shared__ double smem_raw[];
  SmemArena ar(arena_base<SHARED>(place, smem_raw));
  const int nb = opt.nb, b = blockIdx.x / nb, jt = blockIdx.x % nb;
  const int tid = threadIdx.x, nt = blockDim.x, n = D.n;

  T* sd = ar.take<T>(O.total);
  T* dz = ar.take<T>(n);
  T* dsr = ar.take<T>(D.mI);
  T* red = ar.take<T>(LS_RED);
  T* sc = ar.take<T>(LS_SC);
  T* zn = ar.take<T>(n);
  BlockTerms<T> bt;
  bt.take(ar, D.K);
  T* stage = ar.take<T>(LS_STAGE);    // a chunk of terms (theta's, beside log st's)
  T* stage2 = ar.take<T>(LS_STAGE);

  T* wl = lane_work(a, D, nb, b);   // phi[nb], theta[nb], scalars, ds, dw
  T* ws = wl + 2 * nb;
  stage_data(a, O, b, sd);
  ls_pick(a, b, opt.R, sc);
  const T* sol = a.sols + (size_t(b) * opt.R + int(sc[SC_PICK])) * (n + D.mE);
  const LsLane<T> l = lane_of(a, D, b);
  const bool bad = ls_recover(a, D, l, sol, dz, dsr, red, sc);
  if (bad) {
    if (jt == 0 && tid == 0) ws[WS_BAD] = T(1);
    return;
  }
  T ref[4];
  ls_reference(a, D, l, b, dsr, jt == 0 ? ws + LS_WS + D.mI : nullptr, T(opt.tau_min),
               opt.cthreads, stage, stage2, red, ref);
  if (jt == 0) {
    for (int j = tid; j < D.mI; j += nt) ws[LS_WS + j] = dsr[j];
    if (tid == 0) {
      ws[WS_BAD] = T(0);
      ws[WS_AS] = ref[0];
      ws[WS_AW] = ref[1];
      ws[WS_PHI0] = ref[2];
      ws[WS_TH0] = ref[3];
    }
  }
  const T al = ref[0] * pow2m<T>(jt);
  for (int i = tid; i < n; i += nt) zn[i] = (l.zv[i] + al * dz[i]) * a.ds[i];
  __syncthreads();
  const LaneView<T> L{D, O, sd, zn};
  block_terms(L, bt);   // ends synced
  // the trial's terms, a chunk of LS_STAGE at a time over the whole CTA,
  // each chunk then summed by the first gsize threads in one trial group's
  // order (thread r: terms r, r + gsize, ...; objective, equality rows,
  // inequality rows); then the group's shuffles and warp order
  const int gsize = 32 * opt.cgw, lane = tid & 31, warp = tid >> 5;
  const bool sums = tid < gsize;
  const T dt = L.dt(), dual_reg = T(opt.dual_reg);
  T f = 0, th = 0, lg = 0;
  const int nobj = objective_items(D);
  for (int c0 = 0; c0 < nobj; c0 += LS_STAGE) {
    const int c1 = min(nobj, c0 + LS_STAGE);
    for (int i = c0 + tid; i < c1; i += nt) stage[i - c0] = objective_item(L, i, dt, dual_reg);
    __syncthreads();
    if (sums)
      for (int i = c0 + tid; i < c1; i += gsize) f = ls_add(f, stage[i - c0]);
    __syncthreads();
  }
  for (int c0 = 0; c0 < D.mE; c0 += LS_STAGE) {
    const int c1 = min(D.mE, c0 + LS_STAGE);
    for (int r = c0 + tid; r < c1; r += nt) stage[r - c0] = eq_term(L, bt, l, r);
    __syncthreads();
    if (sums)
      for (int r = c0 + tid; r < c1; r += gsize) th = ls_add(th, stage[r - c0]);
    __syncthreads();
  }
  for (int c0 = 0; c0 < D.mI; c0 += LS_STAGE) {
    const int c1 = min(D.mI, c0 + LS_STAGE);
    for (int j = c0 + tid; j < c1; j += nt)
      ineq_terms(a, L, bt, l, dz, dsr, al, j, stage2[j - c0], stage[j - c0]);
    __syncthreads();
    if (sums)
      for (int j = c0 + tid; j < c1; j += gsize) {
        lg = ls_add(lg, stage2[j - c0]);
        th = ls_add(th, stage[j - c0]);
      }
    __syncthreads();
  }
  f = warp_sum(f);
  th = warp_sum(th);
  lg = warp_sum(lg);
  if (gsize > 32) {   // red's last reads were before the chunks' barriers
    if (lane == 0 && warp < opt.cgw) {
      red[3 * warp] = f;
      red[3 * warp + 1] = th;
      red[3 * warp + 2] = lg;
    }
    __syncthreads();
    f = red[0];
    th = red[1];
    lg = red[2];
    for (int k = 1; k < opt.cgw; ++k) {
      f += red[3 * k];
      th += red[3 * k + 1];
      lg += red[3 * k + 2];
    }
  }
  if (tid == 0) {
    wl[jt] = ls_mul(l.sf, f) - ls_mul(l.mu, lg);
    wl[nb + jt] = th;
  }
}

// Launch 2: a CTA a lane applies the filter in trial order and the update.
template <typename T>
__global__ void __launch_bounds__(LS_SPREAD_THREADS) ls_filter_kernel(LSArgs<T> a, Dims D,
                                                                      LSOpt opt) {
  __shared__ T sc[LS_SC];
  const int nb = opt.nb, b = blockIdx.x;
  const T* wl = lane_work(a, D, nb, b);
  const T* ws = wl + 2 * nb;
  const bool bad = ws[WS_BAD] > T(0);
  ls_pick(a, b, opt.R, sc);
  if (threadIdx.x == 0 && !bad)
    ls_first_accepted(wl, wl + nb, 0, nb, ws[WS_AS], ws[WS_PHI0], ws[WS_TH0], sc);
  __syncthreads();
  const bool step_ok = sc[SC_FOUND] > T(0);
  const int pick = int(sc[SC_PICK]);
  const T* sol = a.sols + (size_t(b) * opt.R + pick) * (D.n + D.mE);
  ls_update(a, D, opt, lane_of(a, D, b), b, pick, sol, sol, ws + LS_WS, ws + LS_WS + D.mI,
            step_ok ? sc[SC_ALPHA] : T(0), step_ok ? ws[WS_AW] : T(0), step_ok);
}

// ------------------------------------------------------------ the entry
static bool ls_setup(const long long* ints, int nint, Dims& D, DataOff& O, long long& B, int& R,
                     int& nb) {
  if (nint < VMP_DIMS_END + 2 || !dims_from(ints, D)) return false;
  O = make_data_off(D);
  B = ints[1];
  R = int(ints[VMP_DIMS_END]);
  nb = int(ints[VMP_DIMS_END + 1]);
  return B >= 0 && R >= 1 && nb >= 1 && nb <= LS_MAX_NB;
}

template <typename T>
static int launch_ls(void** p, const long long* ints, int nint, const double* reals,
                     cudaStream_t st) {
  Dims D;
  DataOff O;
  long long B;
  int R, nb;
  const long long* own = ints + VMP_DIMS_END;   // R, nb, data width, the route, the arena
  if (nint != VMP_DIMS_END + 9 || !ls_setup(ints, nint, D, O, B, R, nb) || own[2] != O.total)
    return VMP_BAD_ARGS;
  const LsRoute rt = ls_route(D, O, B, nb, sizeof(T));
  if (own[3] != rt.spread || own[4] != rt.groups || own[5] != rt.group_warps ||
      own[6] != rt.threads)
    return VMP_BAD_ARGS;
  int cG, cGW;
  ls_group_shape(D, O, nb, sizeof(T), cG, cGW);
  LSOpt opt{reals[0], reals[1], reals[2], reals[3], reals[4], R, nb, cGW, 32 * cG * cGW};
  LSArgs<T> a{(const T*)p[0], (const unsigned char*)p[1], (const T*)p[2], (const T*)p[3],
              (const T*)p[4], (const T*)p[5], (const T*)p[6], (const T*)p[7], (const T*)p[8],
              (const T*)p[9], (const T*)p[10], (const T*)p[11], (const T*)p[12], (const T*)p[13],
              (const T*)p[14], (const T*)p[15], (const T*)p[16], (const T*)p[17], (const T*)p[18],
              (const T*)p[19], (const T*)p[20], (const T*)p[21], (const long long*)p[22],
              (T*)p[23], (T*)p[24], (T*)p[25], (T*)p[26], (T*)p[27], (T*)p[29]};
  if (rt.spread && B > 0 && a.work == nullptr) return VMP_BAD_ARGS;
  ArenaPlace place;
  size_t smem;
  const int rc = arena_from(own + 7, p[28], rt.arena, place, smem);
  if (rc != 0) return rc;
  const bool shared = place.work == nullptr;
  if (rt.spread) {
    auto trial = shared ? ls_trial_kernel<T, true> : ls_trial_kernel<T, false>;
    cudaError_t e = vmp_allow_smem(trial, smem);
    if (e != cudaSuccess) return int(e);
    if (B == 0) return 0;
    VMP_LAUNCH(trial, unsigned(B * nb), rt.threads, smem, st)(a, D, O, opt, place);
    e = cudaGetLastError();
    if (e != cudaSuccess) return int(e);
    VMP_LAUNCH(ls_filter_kernel<T>, unsigned(B), LS_SPREAD_THREADS, 0, st)(a, D, opt);
    return int(cudaGetLastError());
  }
  auto group = shared ? ls_group_kernel<T, true> : ls_group_kernel<T, false>;
  cudaError_t e = vmp_allow_smem(group, smem);
  if (e != cudaSuccess) return int(e);
  if (B == 0) return 0;
  VMP_LAUNCH(group, unsigned(B), rt.threads, smem, st)(a, D, O, opt, rt, place);
  return int(cudaGetLastError());
}

// ptrs: sols, goods (uint8), ladder, zv, s, y, w, mu_b, delta, cI, cE, f0,
//       JD_sp, JDb_p, JDb_q, sgn_eff, id_off, data, sf, scE, scD, ds,
//       id_idx (int64) | zv_n, s_n, y_n, w_n, delta_n | arena workspace
//       (CTAs x bytes), spread workspace (B x ls_work_elems)
// ints: dtype, B, dims (common.cuh dims_from), R, n_backtracks, packed data
//       width, the route (spread 0/1, groups, warps a group, threads),
//       arena in device memory (0/1), arena bytes per CTA
// reals: tau_min, kappa_sigma, delta0, delta_max, dual_reg
VMP_ENTRY(step_linesearch) {
  if (nptr != 30 || nreal != 5) return VMP_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ints[0] == 0) return launch_ls<float>(ptrs, ints, nint, reals, st);
  if (ints[0] == 1) return launch_ls<double>(ptrs, ints, nint, reals, st);
  return VMP_BAD_DTYPE;
}

// The route this library picks for ints = dtype, B, dims, R, n_backtracks:
// out = spread (0/1), CTAs a lane, groups, warps a group, threads, arena
// bytes a CTA, workspace elements a lane (kernels.ls_route_of_library).
extern "C" int step_linesearch_route_info(const long long* ints, int nint, long long* out) {
  Dims D;
  DataOff O;
  long long B;
  int R, nb;
  if (!ls_setup(ints, nint, D, O, B, R, nb) || (ints[0] != 0 && ints[0] != 1)) return VMP_BAD_ARGS;
  const LsRoute rt = ls_route(D, O, B, nb, ints[0] == 0 ? 4 : 8);
  out[0] = rt.spread;
  out[1] = rt.ctas;
  out[2] = rt.groups;
  out[3] = rt.group_warps;
  out[4] = rt.threads;
  out[5] = (long long)rt.arena;
  out[6] = (long long)ls_work_elems(D, nb);
  return 0;
}
