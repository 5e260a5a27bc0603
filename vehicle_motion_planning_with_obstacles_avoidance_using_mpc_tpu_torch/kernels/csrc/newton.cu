// newton_*: the fused block-arrow Newton solve of the OBCA KKT system.
//
// Replaces: the JAX package's solver/ipm.py fused Newton step — G assembly
// (:882-927), kkt_solve_fused (:937-980) with its helpers (:654-732), and
// the unrolled ladder rungs (:982-994). Three entry points around the
// SPD inverses of spd_inv.cu:
//   newton_assemble  W = H + JI^T (W/S) JI and G = W + JE^T JE / dd in
//                    compressed arrow form, Gqq + delta*I for every rung
//                    (only the W pieces with w_only);
//   newton_schur     Yq = Gqq^-1 Gqp and S = Gpp + delta*I - clique(Gpq Yq);
//   newton_al_solve  the augmented-Lagrangian solve, n_refine refinement
//                    passes against the delta_d-regularized saddle system,
//                    and the curvature test -> (sol, good) per rung.
// Bound on this card: latency at the batch shapes. Per (lane, rung) the
// work is a few dozen dependent matrix-vector passes over ~60 KB of
// operands (Wpp, Sinv, the (K, 8, 8) blocks). At long horizons the
// assembly's two spine products (JD^T diag(sigma) JD and JE^T JE, ~2 np^2
// (mD_sp + mE_sp) flops a lane: 147 MFLOP at N = 74) bound it by
// operations instead; see the assembly's section for its tile grid.
// Design: the assembly as a grid of spine tiles (its section below); one
// CTA per (lane, rung) for the Schur and AL solve, every vector of the
// solve in shared memory (in a per-(lane, rung) device workspace once
// they outgrow 227 KB: demo9 at N = 74 in float64 needs 298 KB), every
// pass a loop of threads over output entries followed by one
// __syncthreads; the
// block->spine accumulations are sums over the nO obstacles of a step,
// computed by the thread that owns the spine entry (no atomics).
// Variants free, fix_terminal and fix_free_end (the layout's counts come
// through dims_from); S = 3 spine slots per block (no coupled motion).
#include "common.cuh"

template <typename T>
__host__ __device__ inline size_t r8(int count) { return ((size_t(count) * sizeof(T) + 7) / 8) * 8; }

// ------------------------------------------------------------ assemble
// A grid of (lane x upper triangular ASM_TILE^2 tile of the spine) plus,
// per lane, one CTA for every ASM_SMALL_KB blocks of the (K, 3, bq) and
// (K, bq, bq) pieces. A tile CTA streams ASM_ROWS rows of the sigma-scaled
// JD (then of JE) through shared memory, the next chunk's loads in flight
// while the current one is multiplied out, and accumulates both symmetric
// products in 4x4 register blocks; an off-diagonal tile stores its entries
// and their mirror images, a diagonal tile first sums the box rows of each
// of its positions once. At demo9's N = 74 (np = 374, 527 rows) that is
// 21 tile CTAs per lane instead of one CTA for ~147 MFLOP; at the batch
// shapes (np = 33-54, one tile) it beat one CTA per lane with a thread per
// spine entry (PERF.md section 6). With w_only (the QR rung) JE^T JE, Gpp0,
// Gpq0 and Gqq are not formed.
#define ASM_TILE 64
#define ASM_ROWS 16
#define ASM_SMALL_KB 16

template <typename T>
struct AsmArgs {
  const T *Hpp, *Hpq, *Hqq, *JE_sp, *JEb_th, *JEb_q, *JD_sp, *JDb_p, *JDb_q, *sigma, *sgn,
      *ladder;
  const long long* id_p_pos;
  T *Wpp, *Wpq, *Wqq, *Gpp0, *Gpq0, *Gqq;
};

// the box rows' diagonal sgn^2 sigma at spine position r of lane b, summed
// in row order
template <typename T>
__device__ T asm_box_diag(const AsmArgs<T>& a, const Dims& D, int b, int r) {
  const int K = D.K, bq = D.bq, n_box = D.m_id - K * bq;
  const T* sigma = a.sigma + size_t(b) * D.mI + K * bq;
  const T* sgn = a.sgn + size_t(b) * D.m_id + K * bq;
  T dg = 0;
#pragma unroll 8
  for (int j = 0; j < n_box; ++j)
    if (a.id_p_pos[j] == r) dg += sgn[j] * sgn[j] * sigma[j];
  return dg;
}

// spine entry (r, c) of lane b from its products jd = (JD^T diag(sigma) JD)[r][c]
// and je = (JE^T JE)[r][c] and, where r == c, the box diagonal dg: Wpp adds
// Hpp, dg and the clique, Gpp0 the JE product / dd and the theta rows'
// diagonal
template <typename T>
__device__ void asm_spine_store(const AsmArgs<T>& a, const Dims& D, T dd, bool w_only, int b,
                                int r, int c, T jd, T je, T dg) {
  const int np_ = D.np_, K = D.K, nO = D.nO;
  const T* sigma = a.sigma + size_t(b) * D.mI;
  const T* JEth = a.JEb_th + size_t(b) * K * 2;
  const T* JDp = a.JDb_p + size_t(b) * K * 2 * 3;
  const T* sig_b = sigma + D.m_id + D.mD_sp;   // [rr * K + kb]
  const size_t idx = size_t(b) * np_ * np_ + size_t(r) * np_ + c;
  T w = a.Hpp[idx];
  w += jd;
  if (r == c) w += dg;
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
  a.Wpp[idx] = w;
  if (!w_only) a.Gpp0[idx] = w + je / dd + th2;
}

// coupling Wpq/Gpq0 (K, 3, bq) and blocks Wqq/Gqq + delta_j I of lane b
// for the blocks kb0 .. kb1-1, strided over the CTA's threads
template <typename T>
__device__ void asm_small(const AsmArgs<T>& a, const Dims& D, int R, T dd, bool w_only, int b,
                          int kb0, int kb1) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int K = D.K, bq = D.bq;
  const T* sigma = a.sigma + size_t(b) * D.mI;
  const T* sgn = a.sgn + size_t(b) * D.m_id;
  const T* JEth = a.JEb_th + size_t(b) * K * 2;
  const T* JEq = a.JEb_q + size_t(b) * K * 2 * bq;
  const T* JDp = a.JDb_p + size_t(b) * K * 2 * 3;
  const T* JDq = a.JDb_q + size_t(b) * K * 2 * bq;
  const T* sig_b = sigma + D.m_id + D.mD_sp;   // [rr * K + kb]

  for (int idx = kb0 * 3 * bq + tid; idx < kb1 * 3 * bq; idx += nt) {
    const int kb = idx / (3 * bq), s = (idx / bq) % 3, c = idx % bq;
    T w = a.Hpq[size_t(b) * K * 3 * bq + idx];
    T g = 0;
    for (int rr = 0; rr < 2; ++rr) {
      w += sig_b[rr * K + kb] * JDp[(kb * 2 + rr) * 3 + s] * JDq[(kb * 2 + rr) * bq + c];
      g += JEth[kb * 2 + rr] * JEq[(kb * 2 + rr) * bq + c];
    }
    a.Wpq[size_t(b) * K * 3 * bq + idx] = w;
    if (!w_only) a.Gpq0[size_t(b) * K * 3 * bq + idx] = (s == 2) ? w + g / dd : w;
  }

  for (int idx = kb0 * bq * bq + tid; idx < kb1 * bq * bq; idx += nt) {
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
    if (w_only) continue;
    const T g0 = w + g / dd;
    for (int j = 0; j < R; ++j)
      a.Gqq[(size_t(b) * R + j) * K * bq * bq + idx] = (r == c) ? g0 + a.ladder[b * R + j] : g0;
  }
}

// acc[i][j] += sum over the rows of X[row][r0 + ty + 16 i] * X[row][c0 + tx + 16 j]
// for a (rows, np) row-major X, scaled by scale[row] on the left when given
template <typename T>
__device__ void asm_tile_product(const T* X, const T* scale, int rows, int np_, int r0, int c0,
                                 T (*Xs)[ASM_TILE], T (*Ys)[ASM_TILE], T acc[4][4]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  constexpr int PER = ASM_ROWS * ASM_TILE / 256;   // entries a thread stages per chunk
  T xr[PER], yr[PER];
  auto fetch = [&](int row0) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = tid + 256 * q, row = row0 + e / ASM_TILE, cc = e % ASM_TILE;
      xr[q] = yr[q] = T(0);
      if (row < rows) {
        if (r0 + cc < np_) {
          xr[q] = X[size_t(row) * np_ + r0 + cc];
          if (scale) xr[q] *= scale[row];
        }
        if (c0 + cc < np_) yr[q] = X[size_t(row) * np_ + c0 + cc];
      }
    }
  };
  fetch(0);
  for (int row0 = 0; row0 < rows; row0 += ASM_ROWS) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = tid + 256 * q;
      Xs[e / ASM_TILE][e % ASM_TILE] = xr[q];
      Ys[e / ASM_TILE][e % ASM_TILE] = yr[q];
    }
    __syncthreads();
    if (row0 + ASM_ROWS < rows) fetch(row0 + ASM_ROWS);
#pragma unroll 4
    for (int rr = 0; rr < ASM_ROWS; ++rr) {
      T xv[4], yv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xv[i] = Xs[rr][ty + 16 * i];
        yv[i] = Ys[rr][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += xv[i] * yv[j];
    }
    __syncthreads();
  }
}

// grid (lane, tile): tiles 0 .. n_up-1 are the upper triangle of the
// spine's ASM_TILE tiles, the rest ASM_SMALL_KB blocks each of the small
// pieces
template <typename T>
__global__ void __launch_bounds__(256) newton_assemble_kernel(AsmArgs<T> a, Dims D, int R, T dd,
                                                              int w_only) {
  __shared__ T Xs[ASM_ROWS][ASM_TILE], Ys[ASM_ROWS][ASM_TILE], dgs[ASM_TILE];
  const int b = blockIdx.x, np_ = D.np_;
  const int nT = (np_ + ASM_TILE - 1) / ASM_TILE, n_up = nT * (nT + 1) / 2;
  int t = blockIdx.y;
  if (t >= n_up) {
    const int kb0 = (t - n_up) * ASM_SMALL_KB;
    asm_small(a, D, R, dd, w_only != 0, b, kb0, min(D.K, kb0 + ASM_SMALL_KB));
    return;
  }
  int ti = 0;
  while (t >= nT - ti) {
    t -= nT - ti;
    ++ti;
  }
  const int tj = ti + t, r0 = ti * ASM_TILE, c0 = tj * ASM_TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  if (ti == tj)   // read after the products' barriers
    for (int p = threadIdx.x; p < ASM_TILE && r0 + p < np_; p += blockDim.x)
      dgs[p] = asm_box_diag(a, D, b, r0 + p);
  T jd[4][4] = {}, je[4][4] = {};
  asm_tile_product(a.JD_sp + size_t(b) * D.mD_sp * np_, a.sigma + size_t(b) * D.mI + D.m_id,
                   D.mD_sp, np_, r0, c0, Xs, Ys, jd);
  if (!w_only)
    asm_tile_product(a.JE_sp + size_t(b) * D.mE_sp * np_, (const T*)nullptr, D.mE_sp, np_, r0,
                     c0, Xs, Ys, je);
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + ty + 16 * i, c = c0 + tx + 16 * j;
      if (r >= np_ || c >= np_) continue;
      const T dg = r == c ? dgs[r - r0] : T(0);
      asm_spine_store(a, D, dd, w_only != 0, b, r, c, jd[i][j], je[i][j], dg);
      if (ti != tj) asm_spine_store(a, D, dd, w_only != 0, b, c, r, jd[i][j], je[i][j], T(0));
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
  const int B = int(ints[1]), R = int(ints[10]), w_only = int(ints[11]);
  Dims D;
  if (!dims_from(ints, D) || (w_only != 0 && w_only != 1)) return VMP_BAD_ARGS;
  AsmArgs<T> a{(const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3], (const T*)p[4],
               (const T*)p[5], (const T*)p[6], (const T*)p[7], (const T*)p[8], (const T*)p[9],
               (const T*)p[10], (const T*)p[11], (const long long*)p[12],
               (T*)p[13], (T*)p[14], (T*)p[15], (T*)p[16], (T*)p[17], (T*)p[18]};
  if (B == 0) return 0;
  const int nT = (D.np_ + ASM_TILE - 1) / ASM_TILE;
  const int n_small = (D.K + ASM_SMALL_KB - 1) / ASM_SMALL_KB;
  VMP_LAUNCH(newton_assemble_kernel<T>, dim3(B, nT * (nT + 1) / 2 + n_small), 256, 0, st)(
      a, D, R, T(dd), w_only);
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
//       (the G outputs are not written with w_only)
// ints: dtype, B, dims (common.cuh dims_from), R, w_only (0/1);  reals: dd
VMP_ENTRY(newton_assemble) {
  if (nptr != 19 || nint != 12 || nreal != 1) return VMP_BAD_ARGS;
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
