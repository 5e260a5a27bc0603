// obca_kkt_provider: every KKTBundle field of the OBCA NLP at one iterate.
//
// Replaces: the JAX package's models/obca_struct.py make_provider.provider
// (:292-605), the analytic KKT provider of the fused Newton body.
// Bound on this card: memory traffic and launch count. Per lane it reads
// ~7 KB of problem data and the iterate and writes ~40 KB of Jacobian and
// Hessian blocks (demo9, N = 10, float64); the arithmetic is a few
// thousand flops. In plain PyTorch the same bundle is ~300 small kernels
// with every intermediate in device memory.
// Design: one CTA per lane. The lane's packed data, its natural-unit
// variables and the per-block terms (q1 = A^T lam, cos/sin, the ego
// point) are staged once in shared memory; then every output element is
// computed by its own thread straight from them and written once, with
// threads over rows for residuals, over (row, column) for the spine
// Jacobians and Hpp, and over (block, slot, entry) for the block pieces.
// Variants free, fix_terminal and fix_free_end without coupled motion
// (every runtime path); the wrapper raises for the others.
#include "obca_eval.cuh"

template <typename T>
struct ProvOut {
  T *f, *g, *cE, *cD, *JE_sp, *JEb_th, *JEb_q, *JD_sp, *JDb_p, *JDb_q, *Hpp, *Hpq_c, *Hqq;
};

template <typename T>
struct ProvIn {
  const T *zv, *data, *sf, *scE, *scD, *y, *wd, *ds;
};

template <typename T>
__host__ __device__ inline size_t r8(int count) { return ((size_t(count) * sizeof(T) + 7) / 8) * 8; }

template <typename T>
__host__ __device__ inline size_t provider_smem(const Dims& D, const DataOff& O) {
  return r8<T>(O.total) + r8<T>(D.n) + 8 * r8<T>(D.K) + r8<T>(D.K) + r8<T>(D.N + 1) +
         4 * r8<T>(D.N) + r8<T>(2 * D.N) + r8<T>(32);
}

// position type of a spine index: 0 = T, 1 = u(i, t), 2 = x(i, t)
__device__ inline int pos_type(const Dims& D, int p, int& i, int& t) {
  if (p < D.off_u) { i = 0; t = 0; return 0; }
  const int q = p - D.off_u;
  if (q < 2 * D.N) { i = q / D.N; t = q % D.N; return 1; }
  const int r = q - 2 * D.N;
  i = r / (D.N + 1);
  t = r % (D.N + 1);
  return 2;
}

template <typename T>
__global__ void __launch_bounds__(256) provider_kernel(ProvIn<T> in, ProvOut<T> o, Dims D, DataOff O,
                                                       T dual_reg) {
  extern __shared__ double smem_raw[];
  SmemArena ar(smem_raw);
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int N = D.N, K = D.K, E = D.E, bq = D.bq, np_ = D.np_;

  T* sd = ar.take<T>(O.total);
  T* z = ar.take<T>(D.n);
  BlockTerms<T> bt;
  bt.take(ar, K);
  T* hb = ar.take<T>(K);          // block (theta_k, theta_k) curvature
  T* thth = ar.take<T>(N + 1);    // spine (theta_t, theta_t) curvature
  T* hthv = ar.take<T>(N);
  T* hthT = ar.take<T>(N);
  T* hvT = ar.take<T>(N);
  T* hwT = ar.take<T>(N);
  T* gacc = ar.take<T>(2 * N);    // g_acc(c, t)
  T* red = ar.take<T>(32);

  const T* dl = in.data + size_t(b) * O.total;
  for (int i = tid; i < O.total; i += nt) sd[i] = dl[i];
  const T* zl = in.zv + size_t(b) * D.n;
  for (int j = tid; j < D.n; j += nt) z[j] = zl[j] * in.ds[j];
  __syncthreads();

  LaneView<T> L{D, O, sd, z};
  block_terms(L, bt);

  const T sf = in.sf[b];
  const T* scE = in.scE + size_t(b) * D.mE;
  const T* scD = in.scD + size_t(b) * D.mD;
  const T* y = in.y + size_t(b) * D.mE;
  const T* wd = in.wd + size_t(b) * D.mD;
  const T dt = L.dt(), Ts = L.Ts(), Tt = D.free ? L.Tv() : T(1);
  const T dt2 = dt * dt;
  const T off = sd[O.ego_offset];
  const T c1 = sd[O.time_c1], c2 = sd[O.time_c2];
  auto R12 = [&](int i, int j) { return L.R1m(i, j) + L.R1m(j, i); };
  auto R22 = [&](int i, int j) { return L.R2m(i, j) + L.R2m(j, i); };
  auto Q2 = [&](int i, int j) { return L.Qm(i, j) + L.Qm(j, i); };
  auto P2 = [&](int i, int j) { return L.Pm(i, j) + L.Pm(j, i); };
  auto dsp = [&](int p) { return in.ds[p_flat(D, p)]; };

  // ---- scalars: objective and the acceleration cost
  const T f_nat = block_reduce(objective_partial(L, dual_reg), SumOp(), red);
  T ca = 0;
  for (int t = tid; t < N; t += nt)
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j) ca += L.du_c(i, t) * R22(i, j) * L.du_c(j, t);
  ca = block_reduce(ca, SumOp(), red);
  const T cost_acc = T(0.5) * ca / dt2;
  if (tid == 0) o.f[b] = sf * f_nat;

  // ---- per-step Hessian pieces and the acceleration gradient
  for (int t = tid; t < N; t += nt) {
    const T y1 = scE[t] * y[t], y2 = scE[N + t] * y[N + t], y3 = scE[2 * N + t] * y[2 * N + t];
    const T v = L.u(0, t), th = L.x(2, t);
    const T c = cos(th), s = sin(th);
    thth[t] = -(y1 * dt * v * c + y2 * dt * v * s);
    hthv[t] = -(y1 * dt * s - y2 * dt * c);
    hthT[t] = -(y1 * Ts * v * s - y2 * Ts * v * c);
    hvT[t] = -(-y1 * Ts * c - y2 * Ts * s);
    hwT[t] = y3 * Ts;
    for (int cc = 0; cc < 2; ++cc) {
      T a0 = 0, a1 = 0;
      for (int j = 0; j < 2; ++j) {
        a0 += R22(cc, j) * L.du_c(j, t);
        if (t + 1 < N) a1 += R22(cc, j) * L.du_c(j, t + 1);
      }
      gacc[cc * N + t] = a0 / dt2 - (t + 1 < N ? a1 / dt2 : T(0));
    }
  }
  for (int kb = tid; kb < K; kb += nt) {
    const T yg0 = scE[D.mE_sp + kb] * y[D.mE_sp + kb];
    const T yg1 = scE[D.mE_sp + K + kb] * y[D.mE_sp + K + kb];
    const T wdd = scD[D.mD_sp + K + kb] * wd[D.mD_sp + K + kb];
    const T m = bt.m[kb], ck = bt.ck[kb], sk = bt.sk[kb], qx = bt.q1x[kb], qy = bt.q1y[kb];
    hb[kb] = -(yg0 * m * (-ck * qx - sk * qy) + yg1 * m * (sk * qx - ck * qy) +
               wdd * m * off * (-ck * qx - sk * qy));
  }
  __syncthreads();
  for (int t = tid; t <= N; t += nt) {
    T v = (t < N) ? thth[t] : T(0);
    if (t >= D.k_lo) {
      T acc = 0;
      for (int i = 0; i < D.nO; ++i) acc += hb[(t - D.k_lo) * D.nO + i];
      v += acc;
    }
    thth[t] = v;
  }
  __syncthreads();

  // ---- residuals
  for (int r = tid; r < D.mE; r += nt) o.cE[size_t(b) * D.mE + r] = eq_row(L, bt, r) * scE[r];
  for (int r = tid; r < D.mD; r += nt) o.cD[size_t(b) * D.mD + r] = dineq_row(L, bt, r) * scD[r];

  // ---- gradient (natural, then scaled)
  for (int j = tid; j < D.n; j += nt) {
    T gn;
    if (j < D.off_u) {
      gn = T(-2) * cost_acc / Tt + T(N + 1) * (c1 + T(2) * c2 * Tt);
    } else if (j < D.off_u + K * E) {
      const int kb = (j - D.off_u) / E, e = (j - D.off_u) % E;
      const T lm = L.lam_mask(kb % D.nO, e);
      gn = (T(VMP_PIN_RHO) * (T(1) - lm) * (T(1) - lm) + dual_reg * lm * lm) * z[j];
    } else if (j < D.base_u) {
      const int kb = (j - D.off_u - K * E) / 4;
      const T om = L.obs_mask(kb % D.nO);
      gn = (T(VMP_PIN_RHO) * (T(1) - om) * (T(1) - om) + dual_reg * om * om) * z[j];
    } else if (j < D.base_x) {
      const int c = (j - D.base_u) / N, t = (j - D.base_u) % N;
      gn = R12(c, 0) * L.u(0, t) + R12(c, 1) * L.u(1, t) + gacc[c * N + t];
    } else {
      const int i = (j - D.base_x) / (N + 1), t = (j - D.base_x) % (N + 1);
      gn = 0;
      for (int jj = 0; jj < 3; ++jj)
        gn += (t < N ? Q2(i, jj) : P2(i, jj)) * (L.x(jj, t) - L.xref(jj, t));
    }
    o.g[size_t(b) * D.n + j] = sf * gn * in.ds[j];
  }

  // ---- JE_sp: dynamics, init and (free) terminal rows; column 0 is T
  // only in the free variant
  const int cT = D.free ? 0 : -1;
  for (int idx = tid; idx < D.mE_sp * np_; idx += nt) {
    const int r = idx / np_, c = idx % np_;
    T v = 0;
    if (r < 3 * N) {
      const int f = r / N, t = r % N;
      const T uv = L.u(0, t), cth = cos(L.x(2, t)), sth = sin(L.x(2, t));
      if (f == 0) {
        if (c == xpos(D, 0, t + 1)) v = 1;
        else if (c == xpos(D, 0, t)) v = -1;
        else if (c == xpos(D, 2, t)) v = dt * uv * sth;
        else if (c == upos(D, 0, t)) v = -dt * cth;
        else if (c == cT) v = -Ts * uv * cth;
      } else if (f == 1) {
        if (c == xpos(D, 1, t + 1)) v = 1;
        else if (c == xpos(D, 1, t)) v = -1;
        else if (c == xpos(D, 2, t)) v = -dt * uv * cth;
        else if (c == upos(D, 0, t)) v = -dt * sth;
        else if (c == cT) v = -Ts * uv * sth;
      } else {
        if (c == xpos(D, 2, t + 1)) v = 1;
        else if (c == xpos(D, 2, t)) v = -1;
        else if (c == upos(D, 1, t)) v = -dt;
        else if (c == cT) v = -Ts * L.u(1, t);
      }
    } else if (r < 3 * N + 3) {
      if (c == xpos(D, r - 3 * N, 0)) v = 1;
    } else {
      if (c == xpos(D, r - 3 * N - 3, N)) v = 1;
    }
    o.JE_sp[size_t(b) * D.mE_sp * np_ + idx] = scE[r] * v * dsp(c);
  }

  // ---- JD_sp: acceleration rows [a hi, a lo, alpha hi, alpha lo], then
  // (fix_terminal) the terminal-set rows x_N - ts00, y_N - ts10, ts11 - y_N
  for (int idx = tid; idx < D.mD_sp * np_; idx += nt) {
    const int r = idx / np_, c = idx % np_;
    T v = 0;
    if (r < 4 * N) {
      const int f = r / N, t = r % N, cc = f / 2;
      const bool hi = (f % 2) == 0;
      const T lim = cc == 0 ? sd[O.a_max] : sd[O.alpha_max];
      if (c == upos(D, cc, t)) v = hi ? T(1) : T(-1);
      else if (t >= 1 && c == upos(D, cc, t - 1)) v = hi ? T(-1) : T(1);
      else if (c == cT) v = lim * Ts;
    } else {
      const int j = r - 4 * N;
      if (c == xpos(D, j == 0 ? 0 : 1, N)) v = j == 2 ? T(-1) : T(1);
    }
    o.JD_sp[size_t(b) * D.mD_sp * np_ + idx] = scD[r] * v * dsp(c);
  }

  // ---- block Jacobians
  for (int kb = tid; kb < K; kb += nt) {
    const int k = D.k_lo + kb / D.nO, i = kb % D.nO;
    const T m = bt.m[kb], ck = bt.ck[kb], sk = bt.sk[kb], qx = bt.q1x[kb], qy = bt.q1y[kb];
    const T sE0 = scE[D.mE_sp + kb], sE1 = scE[D.mE_sp + K + kb];
    const T sD0 = scD[D.mD_sp + kb], sD1 = scD[D.mD_sp + K + kb];
    const T ds0 = dsp(slot_pos(D, 0, kb)), ds1 = dsp(slot_pos(D, 1, kb)), ds2 = dsp(slot_pos(D, 2, kb));
    T* jth = o.JEb_th + (size_t(b) * K + kb) * 2;
    jth[0] = sE0 * (m * (-sk * qx + ck * qy)) * ds2;
    jth[1] = sE1 * (-m * (ck * qx + sk * qy)) * ds2;
    T* jq = o.JEb_q + (size_t(b) * K + kb) * 2 * bq;
    T* dq = o.JDb_q + (size_t(b) * K + kb) * 2 * bq;
    for (int e = 0; e < E; ++e) {
      const T a0 = L.A(k, i, e, 0), a1 = L.A(k, i, e, 1);
      jq[e] = sE0 * (m * (ck * a0 + sk * a1));
      jq[bq + e] = sE1 * (m * (-sk * a0 + ck * a1));
      dq[e] = sD0 * (T(-2) * m * (qx * a0 + qy * a1));
      dq[bq + e] = sD1 * (m * (bt.tx[kb] * a0 + bt.ty[kb] * a1 - L.bv(k, i, e)));
    }
    for (int j = 0; j < 4; ++j) {
      jq[E + j] = sE0 * T(j == 0 ? 1 : (j == 2 ? -1 : 0));
      jq[bq + E + j] = sE1 * T(j == 1 ? 1 : (j == 3 ? -1 : 0));
      dq[E + j] = T(0);
      dq[bq + E + j] = sD1 * (-m * sd[O.ego_g + j]);
    }
    T* dp = o.JDb_p + (size_t(b) * K + kb) * 2 * 3;
    dp[0] = T(0);
    dp[1] = T(0);
    dp[2] = T(0);
    dp[3] = sD1 * (m * qx) * ds0;
    dp[4] = sD1 * (m * qy) * ds1;
    dp[5] = sD1 * (m * off * (-sk * qx + ck * qy)) * ds2;
  }

  // ---- Hpp: Lagrangian Hessian, spine block
  for (int idx = tid; idx < np_ * np_; idx += nt) {
    int r = idx / np_, c = idx % np_;
    int ir, tr, ic, tc;
    int ty_r = pos_type(D, r, ir, tr), ty_c = pos_type(D, c, ic, tc);
    if (ty_r > ty_c) {  // entry is symmetric: order the pair by type
      int tmp = ty_r; ty_r = ty_c; ty_c = tmp;
      tmp = ir; ir = ic; ic = tmp;
      tmp = tr; tr = tc; tc = tmp;
    }
    T v = 0;
    if (ty_r == 0 && ty_c == 0) {
      v = sf * (T(6) * cost_acc / (Tt * Tt) + T(2) * c2 * T(N + 1));
    } else if (ty_r == 0 && ty_c == 1) {
      v = sf * (T(-2) * gacc[ic * N + tc] / Tt) + (ic == 0 ? hvT[tc] : hwT[tc]);
    } else if (ty_r == 0 && ty_c == 2) {
      v = (ic == 2 && tc < N) ? hthT[tc] : T(0);
    } else if (ty_r == 1 && ty_c == 1) {
      if (tr == tc) {
        const T cnt = tr < N - 1 ? T(2) : T(1);
        v = sf * (R12(ir, ic) + R22(ir, ic) * cnt / dt2);
      } else if (tr - tc == 1 || tc - tr == 1) {
        v = sf * (-R22(ir, ic) / dt2);
      }
    } else if (ty_r == 1 && ty_c == 2) {
      v = (ir == 0 && ic == 2 && tr == tc) ? hthv[tr] : T(0);
    } else {
      if (tr == tc) {
        v = sf * (tr < N ? Q2(ir, ic) : P2(ir, ic));
        if (ir == 2 && ic == 2) v += thth[tr];
      }
    }
    o.Hpp[size_t(b) * np_ * np_ + idx] = v * dsp(r) * dsp(c);
  }

  // ---- Hpq_c (K, 3, bq): spine slots x, y, theta against lam
  for (int idx = tid; idx < K * 3 * bq; idx += nt) {
    const int kb = idx / (3 * bq), s = (idx / bq) % 3, e = idx % bq;
    T v = 0;
    if (e < E) {
      const int k = D.k_lo + kb / D.nO, i = kb % D.nO;
      const T m = bt.m[kb], ck = bt.ck[kb], sk = bt.sk[kb];
      const T a0 = L.A(k, i, e, 0), a1 = L.A(k, i, e, 1);
      const T wdd = scD[D.mD_sp + K + kb] * wd[D.mD_sp + K + kb];
      if (s == 0) {
        v = -wdd * m * a0;
      } else if (s == 1) {
        v = -wdd * m * a1;
      } else {
        const T yg0 = scE[D.mE_sp + kb] * y[D.mE_sp + kb];
        const T yg1 = scE[D.mE_sp + K + kb] * y[D.mE_sp + K + kb];
        const T dl1 = m * (-sk * a0 + ck * a1), dl2 = m * (-ck * a0 - sk * a1);
        v = -(yg0 * dl1 + yg1 * dl2 + wdd * off * dl1);
      }
      v *= dsp(slot_pos(D, s, kb));
    }
    o.Hpq_c[size_t(b) * K * 3 * bq + idx] = v;
  }

  // ---- Hqq (K, bq, bq): norm-row curvature + pin/prox diagonals
  for (int idx = tid; idx < K * bq * bq; idx += nt) {
    const int kb = idx / (bq * bq), a = (idx / bq) % bq, c = idx % bq;
    const int k = D.k_lo + kb / D.nO, i = kb % D.nO;
    T v = 0;
    if (a < E && c < E) {
      const T wn = scD[D.mD_sp + kb] * wd[D.mD_sp + kb];
      const T aa = L.A(k, i, a, 0) * L.A(k, i, c, 0) + L.A(k, i, a, 1) * L.A(k, i, c, 1);
      v = T(2) * wn * bt.m[kb] * aa;
      if (a == c) {
        const T lm = L.lam_mask(i, a);
        v += sf * (T(VMP_PIN_RHO) * (T(1) - lm) * (T(1) - lm) + dual_reg * lm * lm);
      }
    } else if (a >= E && a == c) {
      const T om = L.obs_mask(i);
      v = sf * (T(VMP_PIN_RHO) * (T(1) - om) * (T(1) - om) + dual_reg * om * om);
    }
    o.Hqq[size_t(b) * K * bq * bq + idx] = v;
  }
}

template <typename T>
static int launch_provider(void** p, const long long* ints, double dual_reg, cudaStream_t st) {
  const int B = int(ints[1]);
  Dims D;
  if (!dims_from(ints, D)) return VMP_BAD_ARGS;
  const DataOff O = make_data_off(D);
  if (ints[10] != O.total) return VMP_BAD_ARGS;
  ProvIn<T> in{(const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
               (const T*)p[4], (const T*)p[5], (const T*)p[6], (const T*)p[7]};
  ProvOut<T> o{(T*)p[8],  (T*)p[9],  (T*)p[10], (T*)p[11], (T*)p[12], (T*)p[13], (T*)p[14],
               (T*)p[15], (T*)p[16], (T*)p[17], (T*)p[18], (T*)p[19], (T*)p[20]};
  const size_t smem = provider_smem<T>(D, O);
  if (smem > 227 * 1024) return VMP_TOO_LARGE;
  cudaError_t e = vmp_allow_smem(provider_kernel<T>, smem);
  if (e != cudaSuccess) return int(e);
  if (B == 0) return 0;
  VMP_LAUNCH(provider_kernel<T>, B, 256, smem, st)(in, o, D, O, T(dual_reg));
  return int(cudaGetLastError());
}

// ptrs: zv, data, sf, scE, scD, y, w_d, ds | f, g, cE, cD, JE_sp, JEb_th,
//       JEb_q, JD_sp, JDb_p, JDb_q, Hpp, Hpq_c, Hqq
// ints: dtype, B, dims (common.cuh dims_from), packed data width;  reals: dual_reg
VMP_ENTRY(obca_kkt_provider) {
  if (nptr != 21 || nint != 11 || nreal != 1) return VMP_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ints[0] == 0) return launch_provider<float>(ptrs, ints, reals[0], st);
  if (ints[0] == 1) return launch_provider<double>(ptrs, ints, reals[0], st);
  return VMP_BAD_DTYPE;
}
