// newton_*: the fused block-arrow Newton solve of the OBCA KKT system.
//
// Replaces: the JAX package's solver/ipm.py fused Newton step — G assembly
// (:882-927), kkt_solve_fused (:937-980) with its helpers (:654-732), and
// the unrolled ladder rungs (:982-994). Three entry points around the
// SPD inverses of spd_inv.cu:
//   newton_assemble  W = H + JI^T (W/S) JI and G = W + JE^T JE / dd in
//                    compressed arrow form, Gqq + delta*I for every rung;
//   newton_schur     Yq = Gqq^-1 Gqp and S = Gpp + delta*I - clique(Gpq Yq);
//   newton_al_solve  the augmented-Lagrangian solve, n_refine refinement
//                    passes against the delta_d-regularized saddle system,
//                    and the curvature test -> (sol, good) per rung.
// Bound on this card: latency. Per (lane, rung) the work is a few dozen
// dependent matrix-vector passes over ~60 KB of operands (Wpp, Sinv,
// the (K, 8, 8) blocks); there is no large product to feed tensor cores.
// Design: one CTA per lane (assembly) or per (lane, rung) (Schur, AL
// solve), every vector of the solve in shared memory (for the AL solve,
// in a per-(lane, rung) device workspace once they outgrow 227 KB: demo9
// at N = 74 in float64 needs 298 KB), every pass a loop
// of threads over output entries followed by one __syncthreads; the
// block->spine accumulations are sums over the nO obstacles of a step,
// computed by the thread that owns the spine entry (no atomics).
// Variants free, fix_terminal and fix_free_end (the layout's counts come
// through dims_from); S = 3 spine slots per block (no coupled motion).
#include "common.cuh"

template <typename T>
__host__ __device__ inline size_t r8(int count) { return ((size_t(count) * sizeof(T) + 7) / 8) * 8; }

// ------------------------------------------------------------ assemble
template <typename T>
struct AsmArgs {
  const T *Hpp, *Hpq, *Hqq, *JE_sp, *JEb_th, *JEb_q, *JD_sp, *JDb_p, *JDb_q, *sigma, *sgn,
      *ladder;
  const long long* id_p_pos;
  T *Wpp, *Wpq, *Wqq, *Gpp0, *Gpq0, *Gqq;
};

template <typename T>
__global__ void __launch_bounds__(256) newton_assemble_kernel(AsmArgs<T> a, Dims D, int R, T dd) {
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int np_ = D.np_, K = D.K, bq = D.bq, nO = D.nO;
  const int n_box = D.m_id - K * bq;
  const T* sigma = a.sigma + size_t(b) * D.mI;
  const T* sgn = a.sgn + size_t(b) * D.m_id;
  const T* JE = a.JE_sp + size_t(b) * D.mE_sp * np_;
  const T* JD = a.JD_sp + size_t(b) * D.mD_sp * np_;
  const T* JEth = a.JEb_th + size_t(b) * K * 2;
  const T* JEq = a.JEb_q + size_t(b) * K * 2 * bq;
  const T* JDp = a.JDb_p + size_t(b) * K * 2 * 3;
  const T* JDq = a.JDb_q + size_t(b) * K * 2 * bq;
  const T* sig_sp = sigma + D.m_id;
  const T* sig_b = sigma + D.m_id + D.mD_sp;   // [rr * K + kb]

  // spine block: Wpp and Gpp0
  for (int idx = tid; idx < np_ * np_; idx += nt) {
    const int r = idx / np_, c = idx % np_;
    T w = a.Hpp[size_t(b) * np_ * np_ + idx];
    T jd = 0;
    for (int row = 0; row < D.mD_sp; ++row) jd += JD[row * np_ + r] * sig_sp[row] * JD[row * np_ + c];
    w += jd;
    if (r == c) {
      T dg = 0;
      for (int j = 0; j < n_box; ++j)
        if (a.id_p_pos[j] == r) {
          const T s = sgn[K * bq + j];
          dg += s * s * sigma[K * bq + j];
        }
      w += dg;
    }
    T th2 = 0;
    int sr, tr, sc, tc;
    if (pos_slot(D, r, sr, tr) && pos_slot(D, c, sc, tc) && tr == tc && tr >= D.k_lo) {
      T cl = 0;
      for (int i = 0; i < nO; ++i) {
        const int kb = (tr - D.k_lo) * nO + i;
        for (int rr = 0; rr < 2; ++rr)
          cl += sig_b[rr * K + kb] * JDp[(kb * 2 + rr) * 3 + sr] * JDp[(kb * 2 + rr) * 3 + sc];
        if (sr == 2 && sc == 2)
          th2 += JEth[kb * 2] * JEth[kb * 2] + JEth[kb * 2 + 1] * JEth[kb * 2 + 1];
      }
      w += cl;
      th2 /= dd;
    }
    a.Wpp[size_t(b) * np_ * np_ + idx] = w;
    T je = 0;
    for (int row = 0; row < D.mE_sp; ++row) je += JE[row * np_ + r] * JE[row * np_ + c];
    a.Gpp0[size_t(b) * np_ * np_ + idx] = w + je / dd + th2;
  }

  // coupling: Wpq and Gpq0 (K, 3, bq)
  for (int idx = tid; idx < K * 3 * bq; idx += nt) {
    const int kb = idx / (3 * bq), s = (idx / bq) % 3, c = idx % bq;
    T w = a.Hpq[size_t(b) * K * 3 * bq + idx];
    T g = 0;
    for (int rr = 0; rr < 2; ++rr) {
      w += sig_b[rr * K + kb] * JDp[(kb * 2 + rr) * 3 + s] * JDq[(kb * 2 + rr) * bq + c];
      g += JEth[kb * 2 + rr] * JEq[(kb * 2 + rr) * bq + c];
    }
    a.Wpq[size_t(b) * K * 3 * bq + idx] = w;
    a.Gpq0[size_t(b) * K * 3 * bq + idx] = (s == 2) ? w + g / dd : w;
  }

  // blocks: Wqq and Gqq + delta_j I for every rung
  for (int idx = tid; idx < K * bq * bq; idx += nt) {
    const int kb = idx / (bq * bq), r = (idx / bq) % bq, c = idx % bq;
    T w = a.Hqq[size_t(b) * K * bq * bq + idx];
    T g = 0;
    for (int rr = 0; rr < 2; ++rr) {
      w += sig_b[rr * K + kb] * JDq[(kb * 2 + rr) * bq + r] * JDq[(kb * 2 + rr) * bq + c];
      g += JEq[(kb * 2 + rr) * bq + r] * JEq[(kb * 2 + rr) * bq + c];
    }
    if (r == c) {
      const int f = r < D.E ? kb * D.E + r : K * D.E + kb * 4 + (r - D.E);
      w += sgn[f] * sgn[f] * sigma[f];
    }
    a.Wqq[size_t(b) * K * bq * bq + idx] = w;
    const T g0 = w + g / dd;
    for (int j = 0; j < R; ++j)
      a.Gqq[(size_t(b) * R + j) * K * bq * bq + idx] = (r == c) ? g0 + a.ladder[b * R + j] : g0;
  }
}

// --------------------------------------------------------------- schur
template <typename T>
__global__ void __launch_bounds__(256) newton_schur_kernel(const T* __restrict__ Qinv,
                                                           const T* __restrict__ Gpq0,
                                                           const T* __restrict__ Gpp0,
                                                           const T* __restrict__ ladder,
                                                           T* __restrict__ Yq, T* __restrict__ S,
                                                           Dims D, int R) {
  extern __shared__ double smem_raw[];
  SmemArena ar(smem_raw);
  const int br = blockIdx.x, lane = br / R, tid = threadIdx.x, nt = blockDim.x;
  const int np_ = D.np_, K = D.K, bq = D.bq, nO = D.nO;
  T* Ysh = ar.take<T>(K * bq * 3);
  T* SS = ar.take<T>(K * 9);
  const T* Qi = Qinv + size_t(br) * K * bq * bq;
  const T* G = Gpq0 + size_t(lane) * K * 3 * bq;
  const T delta = ladder[br];

  for (int idx = tid; idx < K * bq * 3; idx += nt) {
    const int kb = idx / (bq * 3), r = (idx / 3) % bq, s = idx % 3;
    T acc = 0;
    for (int c = 0; c < bq; ++c) acc += Qi[(kb * bq + r) * bq + c] * G[(kb * 3 + s) * bq + c];
    Ysh[idx] = acc;
    Yq[size_t(br) * K * bq * 3 + idx] = acc;
  }
  __syncthreads();
  for (int idx = tid; idx < K * 9; idx += nt) {
    const int kb = idx / 9, s = (idx / 3) % 3, t = idx % 3;
    T acc = 0;
    for (int c = 0; c < bq; ++c) acc += G[(kb * 3 + s) * bq + c] * Ysh[(kb * bq + c) * 3 + t];
    SS[idx] = acc;
  }
  __syncthreads();
  for (int idx = tid; idx < np_ * np_; idx += nt) {
    const int r = idx / np_, c = idx % np_;
    T v = Gpp0[size_t(lane) * np_ * np_ + idx];
    if (r == c) v += delta;
    int sr, tr, sc, tc;
    if (pos_slot(D, r, sr, tr) && pos_slot(D, c, sc, tc) && tr == tc && tr >= D.k_lo) {
      T cl = 0;
      for (int i = 0; i < nO; ++i) cl += SS[((tr - D.k_lo) * nO + i) * 9 + sr * 3 + sc];
      v -= cl;
    }
    S[size_t(br) * np_ * np_ + idx] = v;
  }
}

// ------------------------------------------------------------ AL solve
template <typename T>
struct ALCtx {
  Dims D;
  T dd;
  const T *JE, *JEth, *JEq, *Wpp, *Wpq, *Wqq, *Gpq, *Qi, *Yq, *Si;

  // JE^T yv -> (op, oq)
  __device__ void jeT(const T* yv, T* op, T* oq) const {
    const int tid = threadIdx.x, nt = blockDim.x, np_ = D.np_, K = D.K, bq = D.bq;
    for (int p = tid; p < np_; p += nt) {
      T acc = 0;
      for (int row = 0; row < D.mE_sp; ++row) acc += JE[row * np_ + p] * yv[row];
      int s, t;
      if (pos_slot(D, p, s, t) && s == 2 && t >= D.k_lo)
        for (int i = 0; i < D.nO; ++i) {
          const int kb = (t - D.k_lo) * D.nO + i;
          acc += yv[D.mE_sp + kb] * JEth[kb * 2] + yv[D.mE_sp + K + kb] * JEth[kb * 2 + 1];
        }
      op[p] = acc;
    }
    for (int idx = tid; idx < K * bq; idx += nt) {
      const int kb = idx / bq, c = idx % bq;
      oq[idx] = yv[D.mE_sp + kb] * JEq[(kb * 2) * bq + c] + yv[D.mE_sp + K + kb] * JEq[(kb * 2 + 1) * bq + c];
    }
    __syncthreads();
  }

  // JE (dp, dq) -> om
  __device__ void jev(const T* dp, const T* dq, T* om) const {
    const int tid = threadIdx.x, nt = blockDim.x, np_ = D.np_, K = D.K, bq = D.bq;
    for (int r = tid; r < D.mE; r += nt) {
      T acc = 0;
      if (r < D.mE_sp) {
        for (int c = 0; c < np_; ++c) acc += JE[r * np_ + c] * dp[c];
      } else {
        const int rr = (r - D.mE_sp) / K, kb = (r - D.mE_sp) % K;
        acc = JEth[kb * 2 + rr] * dp[slot_pos(D, 2, kb)];
        for (int c = 0; c < bq; ++c) acc += JEq[(kb * 2 + rr) * bq + c] * dq[kb * bq + c];
      }
      om[r] = acc;
    }
    __syncthreads();
  }

  // W (dp, dq) -> (op, oq)
  __device__ void wmv(const T* dp, const T* dq, T* op, T* oq) const {
    const int tid = threadIdx.x, nt = blockDim.x, np_ = D.np_, K = D.K, bq = D.bq;
    for (int p = tid; p < np_; p += nt) {
      T acc = 0;
      for (int c = 0; c < np_; ++c) acc += Wpp[p * np_ + c] * dp[c];
      int s, t;
      if (pos_slot(D, p, s, t) && t >= D.k_lo)
        for (int i = 0; i < D.nO; ++i) {
          const int kb = (t - D.k_lo) * D.nO + i;
          for (int c = 0; c < bq; ++c) acc += Wpq[(kb * 3 + s) * bq + c] * dq[kb * bq + c];
        }
      op[p] = acc;
    }
    for (int idx = tid; idx < K * bq; idx += nt) {
      const int kb = idx / bq, c = idx % bq;
      T acc = 0;
      for (int s = 0; s < 3; ++s) acc += Wpq[(kb * 3 + s) * bq + c] * dp[slot_pos(D, s, kb)];
      for (int d = 0; d < bq; ++d) acc += Wqq[(kb * bq + c) * bq + d] * dq[kb * bq + d];
      oq[idx] = acc;
    }
    __syncthreads();
  }

  // G^-1 (bp, bqv) by block elimination -> (dp, dq); wq, rp are scratch
  __device__ void gsolve(const T* bp, const T* bqv, T* dp, T* dq, T* wq, T* rp) const {
    const int tid = threadIdx.x, nt = blockDim.x, np_ = D.np_, K = D.K, bq = D.bq;
    for (int idx = tid; idx < K * bq; idx += nt) {
      const int kb = idx / bq, c = idx % bq;
      T acc = 0;
      for (int d = 0; d < bq; ++d) acc += Qi[(kb * bq + c) * bq + d] * bqv[kb * bq + d];
      wq[idx] = acc;
    }
    __syncthreads();
    for (int p = tid; p < np_; p += nt) {
      T acc = bp[p];
      int s, t;
      if (pos_slot(D, p, s, t) && t >= D.k_lo)
        for (int i = 0; i < D.nO; ++i) {
          const int kb = (t - D.k_lo) * D.nO + i;
          for (int c = 0; c < bq; ++c) acc -= Gpq[(kb * 3 + s) * bq + c] * wq[kb * bq + c];
        }
      rp[p] = acc;
    }
    __syncthreads();
    for (int p = tid; p < np_; p += nt) {
      T acc = 0;
      for (int c = 0; c < np_; ++c) acc += Si[p * np_ + c] * rp[c];
      dp[p] = acc;
    }
    __syncthreads();
    for (int idx = tid; idx < K * bq; idx += nt) {
      const int kb = idx / bq, c = idx % bq;
      T acc = wq[idx];
      for (int s = 0; s < 3; ++s) acc -= Yq[(kb * bq + c) * 3 + s] * dp[slot_pos(D, s, kb)];
      dq[idx] = acc;
    }
    __syncthreads();
  }
};

template <typename T>
struct ALBufs {
  T *r1p, *dp, *P[6], *r1q, *dq, *Q[6], *r2, *v, *M[4], *red;
};

template <typename T>
__host__ __device__ inline size_t al_smem(const Dims& D) {
  return 8 * r8<T>(D.np_) + 8 * r8<T>(D.K * D.bq) + 6 * r8<T>(D.mE) + r8<T>(32);
}

// dp, dq, v = AL solve of (bp, bq) with the precomputed JE^T r2 / dd
template <typename T>
__device__ void al_solve(const ALCtx<T>& c, ALBufs<T>& B, const T* bp, const T* bqv, const T* r2,
                         const T* jtp, const T* jtq, T* odp, T* odq, T* ov) {
  const int tid = threadIdx.x, nt = blockDim.x, np_ = c.D.np_, nq = c.D.K * c.D.bq;
  for (int p = tid; p < np_; p += nt) B.P[1][p] = bp[p] + jtp[p];
  for (int i = tid; i < nq; i += nt) B.Q[1][i] = bqv[i] + jtq[i];
  __syncthreads();
  c.gsolve(B.P[1], B.Q[1], odp, odq, B.Q[2], B.P[2]);
  c.jev(odp, odq, B.M[0]);
  for (int r = tid; r < c.D.mE; r += nt) ov[r] = (B.M[0][r] - r2[r]) / c.dd;
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(256) newton_al_solve_kernel(ALCtx<T> base, const T* __restrict__ rhs1,
                                                              const T* __restrict__ rhs2,
                                                              const T* __restrict__ ladder,
                                                              T* __restrict__ sol,
                                                              unsigned char* __restrict__ good, int R,
                                                              T delta_d, int n_refine, ArenaPlace place) {
  extern __shared__ double smem_raw[];
  SmemArena ar(place.base(smem_raw));
  const Dims& D = base.D;
  const int br = blockIdx.x, lane = br / R, tid = threadIdx.x, nt = blockDim.x;
  const int np_ = D.np_, K = D.K, bq = D.bq, nq = K * bq, mE = D.mE;

  ALCtx<T> c = base;  // offset every operand to this (lane, rung)
  c.JE += size_t(lane) * D.mE_sp * np_;
  c.JEth += size_t(lane) * K * 2;
  c.JEq += size_t(lane) * K * 2 * bq;
  c.Wpp += size_t(lane) * np_ * np_;
  c.Wpq += size_t(lane) * K * 3 * bq;
  c.Wqq += size_t(lane) * K * bq * bq;
  c.Gpq += size_t(lane) * K * 3 * bq;
  c.Qi += size_t(br) * K * bq * bq;
  c.Yq += size_t(br) * K * bq * 3;
  c.Si += size_t(br) * np_ * np_;
  const T delta = ladder[br], dd = c.dd;

  ALBufs<T> B;
  B.r1p = ar.take<T>(np_);
  B.dp = ar.take<T>(np_);
  for (int i = 0; i < 6; ++i) B.P[i] = ar.take<T>(np_);
  B.r1q = ar.take<T>(nq);
  B.dq = ar.take<T>(nq);
  for (int i = 0; i < 6; ++i) B.Q[i] = ar.take<T>(nq);
  B.r2 = ar.take<T>(mE);
  B.v = ar.take<T>(mE);
  for (int i = 0; i < 4; ++i) B.M[i] = ar.take<T>(mE);
  B.red = ar.take<T>(32);

  const T* r1 = rhs1 + size_t(lane) * D.n;
  for (int p = tid; p < np_; p += nt) B.r1p[p] = r1[p_flat(D, p)];
  for (int i = tid; i < nq; i += nt) B.r1q[i] = r1[q_flat(D, i / bq, i % bq)];
  for (int r = tid; r < mE; r += nt) B.r2[r] = rhs2[size_t(lane) * mE + r];
  __syncthreads();

  // JE^T r2 / dd
  c.jeT(B.r2, B.P[0], B.Q[0]);
  for (int p = tid; p < np_; p += nt) B.P[0][p] /= dd;
  for (int i = tid; i < nq; i += nt) B.Q[0][i] /= dd;
  __syncthreads();
  al_solve(c, B, B.r1p, B.r1q, B.r2, B.P[0], B.Q[0], B.dp, B.dq, B.v);

  for (int it = 0; it < n_refine; ++it) {
    c.wmv(B.dp, B.dq, B.P[3], B.Q[3]);
    c.jeT(B.v, B.P[0], B.Q[0]);
    for (int p = tid; p < np_; p += nt) B.P[4][p] = B.P[3][p] + delta * B.dp[p] + B.P[0][p] - B.r1p[p];
    for (int i = tid; i < nq; i += nt) B.Q[4][i] = B.Q[3][i] + delta * B.dq[i] + B.Q[0][i] - B.r1q[i];
    __syncthreads();
    c.jev(B.dp, B.dq, B.M[1]);
    for (int r = tid; r < mE; r += nt) B.M[2][r] = B.M[1][r] - delta_d * B.v[r] - B.r2[r];
    __syncthreads();
    c.jeT(B.M[2], B.P[0], B.Q[0]);
    for (int p = tid; p < np_; p += nt) B.P[0][p] /= dd;
    for (int i = tid; i < nq; i += nt) B.Q[0][i] /= dd;
    __syncthreads();
    al_solve(c, B, B.P[4], B.Q[4], B.M[2], B.P[0], B.Q[0], B.P[5], B.Q[5], B.M[3]);
    for (int p = tid; p < np_; p += nt) B.dp[p] -= B.P[5][p];
    for (int i = tid; i < nq; i += nt) B.dq[i] -= B.Q[5][i];
    for (int r = tid; r < mE; r += nt) B.v[r] -= B.M[3][r];
    __syncthreads();
  }

  // sol = [dz (flat order), v]; good = all finite & curvature > 0
  T* so = sol + size_t(br) * (D.n + mE);
  T bad = 0;
  for (int p = tid; p < np_; p += nt) {
    so[p_flat(D, p)] = B.dp[p];
    bad += isfinite(B.dp[p]) ? T(0) : T(1);
  }
  for (int i = tid; i < nq; i += nt) {
    so[q_flat(D, i / bq, i % bq)] = B.dq[i];
    bad += isfinite(B.dq[i]) ? T(0) : T(1);
  }
  for (int r = tid; r < mE; r += nt) {
    so[D.n + r] = B.v[r];
    bad += isfinite(B.v[r]) ? T(0) : T(1);
  }
  bad = block_reduce(bad, SumOp(), B.red);
  c.wmv(B.dp, B.dq, B.P[3], B.Q[3]);
  T s1 = 0, s2 = 0;
  for (int p = tid; p < np_; p += nt) {
    s1 += B.dp[p] * B.P[3][p];
    s2 += B.dp[p] * B.dp[p];
  }
  for (int i = tid; i < nq; i += nt) {
    s1 += B.dq[i] * B.Q[3][i];
    s2 += B.dq[i] * B.dq[i];
  }
  s1 = block_reduce(s1, SumOp(), B.red);
  s2 = block_reduce(s2, SumOp(), B.red);
  if (tid == 0) good[br] = (bad == T(0)) && (s1 + delta * s2 > T(0));
}

// ------------------------------------------------------------ launchers
template <typename T>
static int launch_assemble(void** p, const long long* ints, double dd, cudaStream_t st) {
  const int B = int(ints[1]), R = int(ints[10]);
  Dims D;
  if (!dims_from(ints, D)) return VMP_BAD_ARGS;
  AsmArgs<T> a{(const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3], (const T*)p[4],
               (const T*)p[5], (const T*)p[6], (const T*)p[7], (const T*)p[8], (const T*)p[9],
               (const T*)p[10], (const T*)p[11], (const long long*)p[12],
               (T*)p[13], (T*)p[14], (T*)p[15], (T*)p[16], (T*)p[17], (T*)p[18]};
  if (B == 0) return 0;
  VMP_LAUNCH(newton_assemble_kernel<T>, B, 256, 0, st)(a, D, R, T(dd));
  return int(cudaGetLastError());
}

template <typename T>
static int launch_schur(void** p, const long long* ints, cudaStream_t st) {
  const int B = int(ints[1]), R = int(ints[10]);
  Dims D;
  if (!dims_from(ints, D)) return VMP_BAD_ARGS;
  const size_t smem = r8<T>(D.K * D.bq * 3) + r8<T>(D.K * 9);
  if (smem > 227 * 1024) return VMP_TOO_LARGE;
  cudaError_t e = vmp_allow_smem(newton_schur_kernel<T>, smem);
  if (e != cudaSuccess) return int(e);
  if (B * R == 0) return 0;
  VMP_LAUNCH(newton_schur_kernel<T>, B * R, 256, smem, st)((const T*)p[0], (const T*)p[1], (const T*)p[2],
                                                   (const T*)p[3], (T*)p[4], (T*)p[5], D, R);
  return int(cudaGetLastError());
}

template <typename T>
static int launch_al_solve(void** p, const long long* ints, const double* reals, cudaStream_t st) {
  const int B = int(ints[1]), R = int(ints[10]), n_refine = int(ints[11]);
  Dims D;
  if (!dims_from(ints, D)) return VMP_BAD_ARGS;
  ALCtx<T> c{D, T(reals[0]), (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
             (const T*)p[4], (const T*)p[5], (const T*)p[6], (const T*)p[7], (const T*)p[8],
             (const T*)p[9]};
  ArenaPlace place;
  size_t smem;
  const int rc = arena_from(ints + 12, p[15], al_smem<T>(D), place, smem);
  if (rc != 0) return rc;
  cudaError_t e = vmp_allow_smem(newton_al_solve_kernel<T>, smem);
  if (e != cudaSuccess) return int(e);
  if (B * R == 0) return 0;
  VMP_LAUNCH(newton_al_solve_kernel<T>, B * R, 256, smem, st)(c, (const T*)p[10], (const T*)p[11],
                                                      (const T*)p[12], (T*)p[13],
                                                      (unsigned char*)p[14], R, T(reals[1]),
                                                      n_refine, place);
  return int(cudaGetLastError());
}

// ptrs: Hpp, Hpq_c, Hqq, JE_sp, JEb_th, JEb_q, JD_sp, JDb_p, JDb_q, sigma,
//       sgn_eff, ladder, id_p_pos (int64) | Wpp, Wpq, Wqq, Gpp0, Gpq0, Gqq
// ints: dtype, B, dims (common.cuh dims_from), R;  reals: dd
VMP_ENTRY(newton_assemble) {
  if (nptr != 19 || nint != 11 || nreal != 1) return VMP_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ints[0] == 0) return launch_assemble<float>(ptrs, ints, reals[0], st);
  if (ints[0] == 1) return launch_assemble<double>(ptrs, ints, reals[0], st);
  return VMP_BAD_DTYPE;
}

// ptrs: Qinv, Gpq0, Gpp0, ladder | Yq, S
// ints: dtype, B, dims (common.cuh dims_from), R
VMP_ENTRY(newton_schur) {
  if (nptr != 6 || nint != 11 || nreal != 0) return VMP_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ints[0] == 0) return launch_schur<float>(ptrs, ints, st);
  if (ints[0] == 1) return launch_schur<double>(ptrs, ints, st);
  return VMP_BAD_DTYPE;
}

// ptrs: JE_sp, JEb_th, JEb_q, Wpp, Wpq, Wqq, Gpq0, Qinv, Yq, Sinv, rhs1,
//       rhs2, ladder | sol, good (uint8) | arena workspace (B*R x bytes)
// ints: dtype, B, dims (common.cuh dims_from), R, n_refine, arena in
//       device memory (0/1), arena bytes per (lane, rung);  reals: dd, delta_d
VMP_ENTRY(newton_al_solve) {
  if (nptr != 16 || nint != 14 || nreal != 2) return VMP_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ints[0] == 0) return launch_al_solve<float>(ptrs, ints, reals, st);
  if (ints[0] == 1) return launch_al_solve<double>(ptrs, ints, reals, st);
  return VMP_BAD_DTYPE;
}
