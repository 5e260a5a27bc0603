// step_linesearch: rung pick, step recovery, fraction-to-boundary, the
// vectorized filter line search and the masked state update.
//
// Replaces: the JAX package's solver/ipm.py :1126-1196 (the step and the
// filter line search of the Newton body), whose trials re-evaluate
// models/obca.py objective / eq_constraints / ineq_constraints.
// Bound on this card: latency. Per lane the work is n_backtracks
// evaluations of the objective and ~900 constraint rows plus a handful
// of reductions; in plain PyTorch each trial is ~100 small kernels.
// Design: one CTA per lane. The lane's data, the direction dz and the
// recovered ds / dw live in shared memory (in a per-lane device
// workspace once they outgrow 227 KB: demo9 at N = 74 in float64 needs
// 248 KB); each trial point is formed there, evaluated with the same
// obca_eval.cuh code the provider uses, and reduced with block
// reductions; thread 0 applies the filter
// rule, then every thread writes its share of the masked update
// (select, never multiply: a rejected direction may hold NaN). The
// fraction-to-boundary ratio divides only where the step is negative,
// as the JAX code does, so no inf or NaN is formed there.
#include "obca_eval.cuh"

template <typename T>
struct LSArgs {
  const T* sols;
  const unsigned char* goods;
  const T *ladder, *zv, *s, *y, *w, *mu_b, *delta, *cI, *cE, *f0, *JD_sp, *JDb_p, *JDb_q, *sgn,
      *id_off, *data, *sf, *scE, *scD, *ds;
  const long long* id_idx;
  T *zv_n, *s_n, *y_n, *w_n, *delta_n;
};

struct LSOpt {
  double tau_min, kappa_sigma, delta0, delta_max, dual_reg;
  int R, nb;
};

template <typename T>
__host__ __device__ inline size_t r8(int count) { return ((size_t(count) * sizeof(T) + 7) / 8) * 8; }

template <typename T>
__host__ __device__ inline size_t ls_smem(const Dims& D, const DataOff& O, int nb) {
  return r8<T>(O.total) + 3 * r8<T>(D.n) + 2 * r8<T>(D.mI) + 8 * r8<T>(D.K) + r8<T>(32) +
         2 * r8<T>(nb) + r8<T>(8);
}

template <typename T>
__global__ void __launch_bounds__(256) step_linesearch_kernel(LSArgs<T> a, Dims D, DataOff O, LSOpt opt,
                                                              ArenaPlace place) {
  extern __shared__ double smem_raw[];
  SmemArena ar(place.base(smem_raw));
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int n = D.n, mE = D.mE, mI = D.mI, m_id = D.m_id, np_ = D.np_, K = D.K, bq = D.bq;
  const int R = opt.R, nb = opt.nb;

  T* sd = ar.take<T>(O.total);
  T* dz = ar.take<T>(n);
  T* zt = ar.take<T>(n);      // trial point, scaled variables
  T* zn = ar.take<T>(n);      // trial point, natural units
  T* dsr = ar.take<T>(mI);
  T* dw = ar.take<T>(mI);
  BlockTerms<T> bt;
  bt.take(ar, K);
  T* red = ar.take<T>(32);
  T* phis = ar.take<T>(nb);
  T* ths = ar.take<T>(nb);
  T* sc = ar.take<T>(8);      // alpha, a_wd, step_ok, pick, any_good

  const T* dl = a.data + size_t(b) * O.total;
  for (int i = tid; i < O.total; i += nt) sd[i] = dl[i];
  if (tid == 0) {
    int first = -1;
    for (int j = 0; j < R; ++j)
      if (a.goods[b * R + j]) { first = j; break; }
    sc[3] = T(first >= 0 ? first : R - 1);
    sc[4] = T(first >= 0 ? 1 : 0);
  }
  __syncthreads();
  const int pick = int(sc[3]);
  const bool any_good = sc[4] > T(0);
  const T* sol = a.sols + (size_t(b) * R + pick) * (n + mE);
  T nonfin = 0;
  for (int i = tid; i < n + mE; i += nt) {
    const T v = sol[i];
    nonfin += isfinite(v) ? T(0) : T(1);
    if (i < n) dz[i] = v;
  }
  nonfin = block_reduce(nonfin, SumOp(), red);   // also publishes dz
  const bool bad = !(any_good && nonfin == T(0));

  const T* s = a.s + size_t(b) * mI;
  const T* w = a.w + size_t(b) * mI;
  const T* cI = a.cI + size_t(b) * mI;
  const T* cE = a.cE + size_t(b) * mE;
  const T* sgn = a.sgn + size_t(b) * m_id;
  const T* id_off = a.id_off + size_t(b) * m_id;
  const T* JD = a.JD_sp + size_t(b) * D.mD_sp * np_;
  const T* JDp = a.JDb_p + size_t(b) * K * 2 * 3;
  const T* JDq = a.JDb_q + size_t(b) * K * 2 * bq;
  const T* scE = a.scE + size_t(b) * mE;
  const T* scD = a.scD + size_t(b) * D.mD;
  const T* zv = a.zv + size_t(b) * n;
  const T mu = a.mu_b[b], sf = a.sf[b];

  // ds = JI dz + (cI - s), dw = -(s w - mu + w ds) / s
  for (int j = tid; j < mI; j += nt) {
    T v;
    if (j < m_id) {
      v = sgn[j] * dz[a.id_idx[j]];
    } else {
      const int r = j - m_id;
      v = 0;
      if (r < D.mD_sp) {
        for (int c = 0; c < np_; ++c) v += JD[r * np_ + c] * dz[p_flat(D, c)];
      } else {
        const int rr = (r - D.mD_sp) / K, kb = (r - D.mD_sp) % K;
        for (int sl = 0; sl < 3; ++sl) v += JDp[(kb * 2 + rr) * 3 + sl] * dz[p_flat(D, slot_pos(D, sl, kb))];
        for (int c = 0; c < bq; ++c) v += JDq[(kb * 2 + rr) * bq + c] * dz[q_flat(D, kb, c)];
      }
    }
    const T d = v + (cI[j] - s[j]);
    dsr[j] = d;
    dw[j] = -(s[j] * w[j] - mu + w[j] * d) / s[j];
  }
  __syncthreads();

  // fraction-to-boundary and the filter's reference point
  const T tau = nan_max(T(opt.tau_min), T(1) - mu);
  T as = 1, aw = 1, lg0 = 0, th0 = 0;
  for (int j = tid; j < mI; j += nt) {
    if (dsr[j] < T(0)) as = nan_min(as, -tau * s[j] / dsr[j]);
    if (dw[j] < T(0)) aw = nan_min(aw, -tau * w[j] / dw[j]);
    lg0 += log(s[j]);
    th0 += fabs(cI[j] - s[j]);
  }
  for (int r = tid; r < mE; r += nt) th0 += fabs(cE[r]);
  as = nan_min(block_reduce(as, MinOp(), red), T(1));
  aw = nan_min(block_reduce(aw, MinOp(), red), T(1));
  lg0 = block_reduce(lg0, SumOp(), red);
  th0 = block_reduce(th0, SumOp(), red);
  const T phi0 = a.f0[b] - mu * lg0;

  // trials at alpha_j = a_s * 2^-j
  const LaneView<T> L{D, O, sd, zn};
  T pw = 1;
  for (int jt = 0; jt < nb; ++jt, pw *= T(0.5)) {
    const T al = as * pw;
    for (int i = tid; i < n; i += nt) {
      zt[i] = zv[i] + al * dz[i];
      zn[i] = zt[i] * a.ds[i];
    }
    __syncthreads();
    block_terms(L, bt);
    const T f = block_reduce(objective_partial(L, T(opt.dual_reg)), SumOp(), red);
    T th = 0, lg = 0;
    for (int r = tid; r < mE; r += nt) th += fabs(scE[r] * eq_row(L, bt, r));
    for (int j = tid; j < mI; j += nt) {
      const T st = s[j] + al * dsr[j];
      lg += log(st);
      const T ci = (j < m_id) ? sgn[j] * zt[a.id_idx[j]] + id_off[j]
                              : scD[j - m_id] * dineq_row(L, bt, j - m_id);
      th += fabs(ci - st);
    }
    th = block_reduce(th, SumOp(), red);
    lg = block_reduce(lg, SumOp(), red);
    if (tid == 0) {
      phis[jt] = sf * f - mu * lg;
      ths[jt] = th;
    }
  }
  __syncthreads();

  // filter acceptance (g_th = 1e-5, ipm.py:1156)
  if (tid == 0) {
    const T g_th = T(1e-5);
    bool any_ok = false;
    T alpha = 0, p2 = 1;
    for (int jt = 0; jt < nb; ++jt, p2 *= T(0.5)) {
      const T ph = phis[jt], th = ths[jt];
      const bool ok = isfinite(ph) && ((th <= T(1.0 - 1e-5) * th0) || (ph <= phi0 - g_th * th0));
      if (ok) {
        const T al = as * p2;
        alpha = any_ok ? nan_max(alpha, al) : nan_max(T(0), al);
        any_ok = true;
      }
    }
    const bool step_ok = !bad && any_ok;
    sc[0] = step_ok ? alpha : T(0);
    sc[1] = step_ok ? aw : T(0);
    sc[2] = step_ok ? T(1) : T(0);
    const T dused = a.ladder[b * R + pick], dl0 = a.delta[b];
    a.delta_n[b] = step_ok ? nan_max(T(opt.delta0), dused / T(30))
                           : nan_min(T(opt.delta_max), nan_max(dl0 * T(100), T(1e-4)));
  }
  __syncthreads();
  const T alpha = sc[0], a_wd = sc[1];
  const bool step_ok = sc[2] > T(0);

  // masked update + kappa_Sigma safeguard
  for (int i = tid; i < n; i += nt)
    a.zv_n[size_t(b) * n + i] = step_ok ? zv[i] + alpha * dz[i] : zv[i];
  const T* y = a.y + size_t(b) * mE;
  for (int r = tid; r < mE; r += nt)
    a.y_n[size_t(b) * mE + r] = step_ok ? y[r] + alpha * (-sol[n + r]) : y[r];
  const T ks = T(opt.kappa_sigma);
  for (int j = tid; j < mI; j += nt) {
    const T sn = step_ok ? s[j] + alpha * dsr[j] : s[j];
    const T wt = step_ok ? w[j] + a_wd * dw[j] : w[j];
    a.s_n[size_t(b) * mI + j] = sn;
    a.w_n[size_t(b) * mI + j] = nan_min(nan_max(wt, mu / (ks * sn)), ks * mu / sn);
  }
}

template <typename T>
static int launch_ls(void** p, const long long* ints, const double* reals, cudaStream_t st) {
  const int B = int(ints[1]);
  Dims D;
  if (!dims_from(ints, D)) return VMP_BAD_ARGS;
  const DataOff O = make_data_off(D);
  if (ints[12] != O.total) return VMP_BAD_ARGS;
  LSOpt opt{reals[0], reals[1], reals[2], reals[3], reals[4], int(ints[10]), int(ints[11])};
  LSArgs<T> a{(const T*)p[0], (const unsigned char*)p[1], (const T*)p[2], (const T*)p[3],
              (const T*)p[4], (const T*)p[5], (const T*)p[6], (const T*)p[7], (const T*)p[8],
              (const T*)p[9], (const T*)p[10], (const T*)p[11], (const T*)p[12], (const T*)p[13],
              (const T*)p[14], (const T*)p[15], (const T*)p[16], (const T*)p[17], (const T*)p[18],
              (const T*)p[19], (const T*)p[20], (const T*)p[21], (const long long*)p[22],
              (T*)p[23], (T*)p[24], (T*)p[25], (T*)p[26], (T*)p[27]};
  ArenaPlace place;
  size_t smem;
  const int rc = arena_from(ints + 13, p[28], ls_smem<T>(D, O, opt.nb), place, smem);
  if (rc != 0) return rc;
  cudaError_t e = vmp_allow_smem(step_linesearch_kernel<T>, smem);
  if (e != cudaSuccess) return int(e);
  if (B == 0) return 0;
  VMP_LAUNCH(step_linesearch_kernel<T>, B, 256, smem, st)(a, D, O, opt, place);
  return int(cudaGetLastError());
}

// ptrs: sols, goods (uint8), ladder, zv, s, y, w, mu_b, delta, cI, cE, f0,
//       JD_sp, JDb_p, JDb_q, sgn_eff, id_off, data, sf, scE, scD, ds,
//       id_idx (int64) | zv_n, s_n, y_n, w_n, delta_n | arena workspace (B x bytes)
// ints: dtype, B, dims (common.cuh dims_from), R, n_backtracks, packed data
//       width, arena in device memory (0/1), arena bytes per lane
// reals: tau_min, kappa_sigma, delta0, delta_max, dual_reg
VMP_ENTRY(step_linesearch) {
  if (nptr != 29 || nint != 15 || nreal != 5) return VMP_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ints[0] == 0) return launch_ls<float>(ptrs, ints, reals, st);
  if (ints[0] == 1) return launch_ls<double>(ptrs, ints, reals, st);
  return VMP_BAD_DTYPE;
}
