// kkt_qr: the QR rescue solve of the full OBCA saddle system.
//
// Replaces: the JAX package's solver/ipm.py _dense_kkt.kkt_solve_qr
// (:1341-1360). For every (lane, rung delta) it solves
//     K = [[W + delta*I, JE^T], [JE, -delta_d*I]]   (order M = n + mE)
// by Householder QR: sol = R^-1 Q^T rhs, one refinement pass
// sol -= R^-1 Q^T (K sol - rhs), then the curvature test
// dz^T W dz + delta dz^T dz > 0; good = all finite & curvature > 0.
// Bound on this card: operations, ~(4/3) M^3 flops of the factorization
// per (lane, rung) (M = 294 for the fix-time step at N = 6: 34 MFLOP), in
// the matrix's own precision outside the tensor cores; the inputs are the
// small arrow pieces. M^2 values (346 KB in float32 at M = 294, 2.1 MB at
// demo8's M = 730) do not fit a block's shared memory, so the matrix lives
// in a device workspace the wrapper allocates. The sweep's rescue rungs
// carry ~30 matrices, so one CTA per matrix leaves most SMs idle and the
// time is one CTA's chain of dependent steps.
// Design: blocked Householder with a compact-WY trailing update, as
// several launches on the stream of one call (safe inside a captured CUDA
// graph: no host sync, no allocation):
//   qr_assemble  a CTA per (matrix, 32-column tile): K column-major into the
//                workspace straight from the arrow pieces (W in
//                Wpp/Wpq/Wqq form and the provider's JE pieces, mapped to
//                flat z order through inv_perm);
//   per panel of QR_NB = 32 columns (an order whose (M x 32) panel does
//   not fit shared memory, M > 838 in float64, is refused: VMP_TOO_LARGE):
//     qr_panel   one CTA per matrix (16 warps) factors the panel in shared
//                memory, one column at a time with one barrier per column
//                (the warps share the later columns; the one that updates
//                the next column also takes its norm), and forms the
//                QR_NB x QR_NB T of I - V T V^T from the Gram matrix V^T V
//                (LAPACK dlarft, forward, columnwise);
//     qr_update  a CTA per (matrix, 32-column tile of the trailing matrix):
//                C -= V T^T (V^T C) as two products through shared
//                memory, so each trailing tile is read and written once
//                per panel instead of once per column;
//   qr_solve     one CTA per matrix: Q^T b panel by panel from the kept
//                V and T (three barriers a panel), back-substitution by
//                QR_NB-blocks (one warp solves the diagonal triangle, staged
//                in shared memory, the block then updates the rows above
//                it; two barriers a block), the refinement pass (the
//                residual K sol - rhs recomputes each entry of K from the
//                arrow pieces) and the curvature test.
// Second entry point, kkt_qr_dense: the same solve of saddle matrices the
// caller has assembled, K (B*R, M, M) row-major (the JAX package's
// kkt_solve_qr as written, which the AD solver's kkt="qr" runs). Only the
// first and last launches differ: qr_dense_load copies each K into its
// workspace column-major through a shared 32 x 32 tile (a CTA per
// (matrix, 32-column tile), reads and writes coalesced), and qr_solve reads
// K's entries from memory where the OBCA route recomputes them from the
// arrow pieces (DenseK); the panel and trailing-update launches are the
// same kernels. The curvature test reads W + delta*I from K's leading
// (n, n) block. Bound: the same ~(4/3) M^3 flops a matrix.
// The reflectors keep LAPACK's sign convention, v_k = a_k - r_k with
// r_k = -sign(a_k) ||a||, beta = 1 / (sigma (sigma + |a_k|)); R's
// diagonal is kept apart (rdiag) and V's head sits on A's diagonal. IEEE
// sqrt and division (no fast math): a NaN or Inf anywhere reaches the
// solution, and good is false there.
#include "common.cuh"

#define QR_TILE 32     // columns per CTA of qr_assemble and qr_update
#define QR_NB 32       // panel width: one warp
#define QR_LD (QR_NB + 1)   // padded leading dimension of staged blocks

template <typename T>
struct QRCtx {
  Dims D;
  const T *JE, *JEth, *JEq, *Wpp, *Wpq, *Wqq;
  const int* pos;  // flat z index -> position in [spine (np); blocks (K*bq)]
  T delta, delta_d;
  int M;

  // offset every operand to lane `lane`
  __device__ void at_lane(int lane) {
    const int np_ = D.np_, K = D.K, bq = D.bq;
    JE += size_t(lane) * D.mE_sp * np_;
    JEth += size_t(lane) * K * 2;
    JEq += size_t(lane) * K * 2 * bq;
    Wpp += size_t(lane) * np_ * np_;
    Wpq += size_t(lane) * K * D.S * bq;
    Wqq += size_t(lane) * K * bq * bq;
  }

  // W[i][j], flat order (i, j < n)
  __device__ T w(int i, int j) const {
    const int np_ = D.np_, bq = D.bq;
    const int pi = pos[i], pj = pos[j];
    if (pi < np_ && pj < np_) return Wpp[pi * np_ + pj];
    if (pi >= np_ && pj >= np_) {
      const int qi = pi - np_, qj = pj - np_;
      if (qi / bq != qj / bq) return T(0);
      return Wqq[qi * bq + qj % bq];
    }
    const int p = pi < np_ ? pi : pj, q = (pi < np_ ? pj : pi) - np_;
    const int kb = q / bq;
    int s, t;
    if (D.S == 4 && p == 0) return Wpq[(kb * 4 + 3) * bq + q % bq];   // T: slot 3 of every block
    if (!pos_slot(D, p, s, t) || t != D.k_lo + kb / D.nO) return T(0);
    return Wpq[(kb * D.S + s) * bq + q % bq];
  }

  // JE[r][j], j < n flat
  __device__ T je(int r, int j) const {
    const int np_ = D.np_, bq = D.bq, K = D.K;
    const int pj = pos[j];
    if (r < D.mE_sp) return pj < np_ ? JE[r * np_ + pj] : T(0);
    const int rr = (r - D.mE_sp) / K, kb = (r - D.mE_sp) % K;
    if (pj < np_) return pj == slot_pos(D, 2, kb) ? JEth[kb * 2 + rr] : T(0);
    const int q = pj - np_;
    return q / bq == kb ? JEq[(kb * 2 + rr) * bq + q % bq] : T(0);
  }

  __device__ T k(int i, int j) const {
    const int n = D.n;
    if (i < n && j < n) return i == j ? w(i, j) + delta : w(i, j);
    if (i < n) return je(j - n, i);
    if (j < n) return je(i - n, j);
    return i == j ? -delta_d : T(0);
  }

  // solve-kernel setup of matrix br: the position map in shared memory,
  // the lane's operands and the rung's delta
  __device__ void begin(SmemArena& ar, int br, int R, const T* ladder,
                        const long long* inv_perm);
};

// An assembled saddle matrix (kkt_qr_dense): K's entries read from memory.
template <typename T>
struct DenseK {
  const T* K;  // (B*R, M, M) row-major
  int M, n;

  __device__ void begin(SmemArena&, int br, int, const T*, const long long*) {
    K += size_t(br) * M * M;
  }
  __device__ T k(int i, int j) const { return K[size_t(i) * M + j]; }
};

// One matrix's slice of the workspace: A (M x M, column-major: R above the
// diagonal, V on and below it), then T of every panel (QR_NB x QR_NB,
// row-major; its diagonal holds the panel's beta) and R's diagonal (M).
// kernels.qr_workspace_elems mirrors it.
struct QRWork {
  int M, npan;
  size_t stride, t_off, rdiag_off;
};

inline QRWork qr_work(int M) {
  QRWork q;
  q.M = M;
  q.npan = (M + QR_NB - 1) / QR_NB;
  q.t_off = size_t(M) * M;
  q.rdiag_off = q.t_off + size_t(q.npan) * QR_NB * QR_NB;
  q.stride = q.rdiag_off + M;
  return q;
}

__device__ inline void load_pos(int* pos, const long long* inv_perm, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) pos[i] = int(inv_perm[i]);
  __syncthreads();
}

template <typename T>
__device__ void QRCtx<T>::begin(SmemArena& ar, int br, int R, const T* ladder,
                                const long long* inv_perm) {
  int* p = ar.take<int>(D.n);
  load_pos(p, inv_perm, D.n);
  at_lane(br / R);
  pos = p;
  delta = ladder[br];
}

// ------------------------------------------------------------ assemble
template <typename T>
__global__ void __launch_bounds__(256) qr_assemble_kernel(QRCtx<T> c, const T* __restrict__ ladder,
                                                          const long long* __restrict__ inv_perm,
                                                          T* __restrict__ work, QRWork q, int R) {
  extern __shared__ double smem_raw[];
  SmemArena ar(smem_raw);
  const int M = q.M, nct = (M + QR_TILE - 1) / QR_TILE;
  const int br = blockIdx.x / nct, j0 = (blockIdx.x % nct) * QR_TILE, ncol = min(QR_TILE, M - j0);
  int* pos = ar.take<int>(c.D.n);
  load_pos(pos, inv_perm, c.D.n);
  c.at_lane(br / R);
  c.pos = pos;
  c.delta = ladder[br];
  T* A = work + size_t(br) * q.stride;
  for (int idx = threadIdx.x; idx < ncol * M; idx += blockDim.x) {
    const int j = j0 + idx / M, i = idx % M;
    A[size_t(j) * M + i] = c.k(i, j);
  }
}

// K (row-major) -> the workspace (column-major), a CTA per (matrix,
// 32-column tile), 32-row chunks through a padded shared tile
template <typename T>
__global__ void __launch_bounds__(256) qr_dense_load_kernel(const T* __restrict__ K,
                                                            T* __restrict__ work, QRWork q) {
  __shared__ T tile[32][33];
  const int M = q.M, nct = (M + 31) / 32;
  const int br = blockIdx.x / nct, j0 = (blockIdx.x % nct) * 32;
  const T* Kb = K + size_t(br) * M * M;
  T* A = work + size_t(br) * q.stride;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;   // 32 x 8 threads
  for (int i0 = 0; i0 < M; i0 += 32) {
    for (int r = ty; r < 32; r += 8) {
      const int i = i0 + r, j = j0 + tx;
      tile[r][tx] = (i < M && j < M) ? Kb[size_t(i) * M + j] : T(0);
    }
    __syncthreads();
    for (int cc = ty; cc < 32; cc += 8) {
      const int j = j0 + cc, i = i0 + tx;
      if (i < M && j < M) A[size_t(j) * M + i] = tile[tx][cc];
    }
    __syncthreads();
  }
}

// --------------------------------------------------------------- panel
inline size_t r8_bytes(size_t bytes) { return (bytes + 7) / 8 * 8; }

// shared memory of qr_panel_kernel for an (m x w) panel
template <typename T>
inline size_t panel_smem(int m, int w) {
  const size_t e = sizeof(T);
  return r8_bytes(size_t(m) * w * e) + r8_bytes(size_t(w) * QR_LD * e) +
         r8_bytes(size_t(w) * w * e) + 3 * r8_bytes(size_t(w + 1) * e) + r8_bytes(32 * e);
}

// factor columns k0 .. k0+w-1 (rows k0 .. M-1) of every matrix
template <typename T>
__global__ void __launch_bounds__(512) qr_panel_kernel(T* __restrict__ work, QRWork q, int k0, int w) {
  extern __shared__ double smem_raw[];
  SmemArena ar(smem_raw);
  const int br = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int wid = tid >> 5, wl = tid & 31, nw = nt >> 5;
  const int M = q.M, m = M - k0;
  T* A = work + size_t(br) * q.stride;
  T* P = ar.take<T>(m * w);    // P[j * m + i] = A[k0 + i][k0 + j]
  T* G = ar.take<T>(w * QR_LD);   // V^T V (strict upper part), padded rows
  T* Ts = ar.take<T>(w * w);   // T (upper triangular)
  T* bt = ar.take<T>(w + 1);   // beta of the panel's columns
  T* vh = ar.take<T>(w + 1);   // V's head of each column
  T* sq = ar.take<T>(w + 1);   // squared norm of column j below row j
  T* red = ar.take<T>(32);

  for (int idx = tid; idx < m * w; idx += nt) {
    const int j = idx / m, i = idx % m;
    P[idx] = A[size_t(k0 + j) * M + k0 + i];
  }
  __syncthreads();
  T s0 = 0;
  for (int i = tid; i < m; i += nt) s0 += P[i] * P[i];
  s0 = block_reduce(s0, SumOp(), red);
  if (tid == 0) sq[0] = s0;
  __syncthreads();

  for (int j = 0; j < w; ++j) {
    const T* col = P + j * m;
    const T sigma = sqrt(sq[j]);
    const T alpha = col[j];
    const T r = alpha >= T(0) ? -sigma : sigma;
    const bool zero = sigma == T(0);
    const T vj = alpha - r;
    const T bk = zero ? T(0) : T(1) / (sigma * (sigma + fabs(alpha)));
    if (tid == 0) {
      vh[j] = vj;
      bt[j] = bk;
      A[q.rdiag_off + k0 + j] = zero ? alpha : r;
    }
    // the panel's later columns; the warp of column j + 1 takes its norm
    for (int cc = j + 1 + wid; cc < w; cc += nw) {
      T* ac = P + cc * m;
      T d = 0;
#pragma unroll 4
      for (int i = j + wl; i < m; i += 32) d += (i == j ? vj : col[i]) * ac[i];
      const T s = bk * warp_sum(d);
      T ss = 0;
#pragma unroll 4
      for (int i = j + wl; i < m; i += 32) {
        const T a = ac[i] - s * (i == j ? vj : col[i]);
        ac[i] = a;
        if (i > j) ss += a * a;
      }
      if (cc == j + 1) {
        ss = warp_sum(ss);
        if (wl == 0) sq[j + 1] = ss;
      }
    }
    __syncthreads();
  }
  for (int j = tid; j < w; j += nt) P[j * m + j] = vh[j];
  __syncthreads();

  // Gram matrix G[a][b] = v_a^T v_b (a < b), a thread per pair
  for (int pr = tid; pr < w * w; pr += nt) {
    const int a = pr / w, b = pr % w;
    if (a >= b) continue;
    T d = 0;
#pragma unroll 4
    for (int i = b; i < m; ++i) d += P[a * m + i] * P[b * m + i];
    G[a * QR_LD + b] = d;
  }
  __syncthreads();
  // T[0:i, i] = -beta_i T[0:i, 0:i] G[0:i, i], one warp
  if (wid == 0) {
    for (int i = 0; i < w; ++i) {
      T z = 0;
      if (wl < i) {
#pragma unroll 4
        for (int b = wl; b < i; ++b) z += Ts[wl * w + b] * G[b * QR_LD + i];
      }
      __syncwarp();
      if (wl < i) Ts[wl * w + i] = -bt[i] * z;
      if (wl == i) Ts[i * w + i] = bt[i];
      if (wl > i && wl < w) Ts[wl * w + i] = T(0);
      __syncwarp();
    }
  }
  __syncthreads();

  for (int idx = tid; idx < m * w; idx += nt) {
    const int j = idx / m, i = idx % m;
    A[size_t(k0 + j) * M + k0 + i] = P[idx];
  }
  T* Tw = A + q.t_off + size_t(k0 / QR_NB) * QR_NB * QR_NB;
  for (int idx = tid; idx < w * w; idx += nt) Tw[(idx / w) * QR_NB + idx % w] = Ts[idx];
}

// -------------------------------------------------------------- update
// C = the trailing columns c0 .. c0+QR_TILE-1, rows k0 .. M-1:
// C -= V (T^T (V^T C)), 256 threads; a 1-D grid with a matrix's column
// tiles adjacent, so that they read its V while it sits in L2. Each pass
// over the rows prefetches its next 32-row chunk into registers while the
// current one is multiplied out of shared memory.
template <typename T>
__global__ void __launch_bounds__(256) qr_update_kernel(T* __restrict__ work, QRWork q, int k0, int w) {
  __shared__ T Vs[32][33], Cs[32][QR_TILE + 1], Ws[32][QR_TILE + 1], Tsh[32][33];
  const int tid = threadIdx.x, M = q.M, m = M - k0;
  const int ntile = (M - k0 - w + QR_TILE - 1) / QR_TILE;
  const int br = blockIdx.x / ntile;
  const int c0 = k0 + w + (blockIdx.x % ntile) * QR_TILE, nc = min(QR_TILE, M - c0);
  const int a = tid % 32, jg = (tid / 32) * 4;   // 8 groups of 4 columns
  T* A = work + size_t(br) * q.stride;
  const T* Tw = A + q.t_off + size_t(k0 / QR_NB) * QR_NB * QR_NB;

  for (int idx = tid; idx < 32 * 32; idx += 256) {
    const int i = idx / 32, j = idx % 32;
    Tsh[i][j] = (i < w && j < w) ? Tw[i * QR_NB + j] : T(0);
  }
  // this thread's 4 entries of a 32-row chunk: row rr = tid % 32 of the
  // columns j = tid / 32 + 8 t; V is zero above its head, C past nc
  T vr[4], cr[4];
  auto fetch = [&](int r0, bool with_c) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int rr = tid % 32, j = tid / 32 + 8 * t, i = r0 + rr;
      vr[t] = (i < m && j < w && i >= j) ? A[size_t(k0 + j) * M + k0 + i] : T(0);
      if (with_c) cr[t] = (i < m && j < nc) ? A[size_t(c0 + j) * M + k0 + i] : T(0);
    }
  };

  // W = V^T C: thread (a, jg) owns W[a][jg .. jg+3]
  T acc[4] = {0, 0, 0, 0};
  fetch(0, true);
  for (int r0 = 0; r0 < m; r0 += 32) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      Vs[tid % 32][tid / 32 + 8 * t] = vr[t];
      Cs[tid % 32][tid / 32 + 8 * t] = cr[t];
    }
    __syncthreads();
    if (r0 + 32 < m) fetch(r0 + 32, true);
#pragma unroll 8
    for (int rr = 0; rr < 32; ++rr) {
      const T v = Vs[rr][a];
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[t] += v * Cs[rr][jg + t];
    }
    __syncthreads();
  }
  for (int t = 0; t < 4; ++t) Ws[a][jg + t] = acc[t];
  __syncthreads();
  // W <- T^T W
  for (int t = 0; t < 4; ++t) {
    T s = 0;
    for (int b = 0; b <= a; ++b) s += Tsh[b][a] * Ws[b][jg + t];
    acc[t] = s;
  }
  __syncthreads();
  for (int t = 0; t < 4; ++t) Ws[a][jg + t] = acc[t];
  // C -= V W: thread (rr = a, jg) updates rows r0 + rr of its 4 columns
  fetch(0, false);
  for (int r0 = 0; r0 < m; r0 += 32) {
#pragma unroll
    for (int t = 0; t < 4; ++t) Vs[tid % 32][tid / 32 + 8 * t] = vr[t];
    __syncthreads();
    if (r0 + 32 < m) fetch(r0 + 32, false);
    const int i = r0 + a;
    if (i < m)
      for (int t = 0; t < 4; ++t) {
        const int j = jg + t;
        if (j >= nc) break;
        T s = 0;
#pragma unroll 8
        for (int b = 0; b < w; ++b) s += Vs[a][b] * Ws[b][j];
        A[size_t(c0 + j) * M + k0 + i] -= s;
      }
    __syncthreads();
  }
}

// --------------------------------------------------------------- solve
// c <- Q^T c, panel by panel: c -= V (T^T (V^T c)); y, z hold QR_NB and
// Ts QR_NB x QR_LD (the panel's T, staged beside the V^T c pass)
template <typename T>
__device__ void apply_qt(const T* A, const QRWork& q, T* c, T* y, T* z, T* Ts) {
  const int tid = threadIdx.x, nt = blockDim.x, wid = tid >> 5, wl = tid & 31, nw = nt >> 5;
  const int M = q.M;
  for (int p = 0; p < q.npan; ++p) {
    const int k0 = p * QR_NB, w = min(QR_NB, M - k0);
    const T* Tw = A + q.t_off + size_t(p) * QR_NB * QR_NB;
    for (int idx = tid; idx < w * w; idx += nt) Ts[(idx / w) * QR_LD + idx % w] = Tw[(idx / w) * QR_NB + idx % w];
    for (int j = wid; j < w; j += nw) {
      const T* v = A + size_t(k0 + j) * M;
      T d = 0;
#pragma unroll 4
      for (int i = k0 + j + wl; i < M; i += 32) d += v[i] * c[i];
      d = warp_sum(d);
      if (wl == 0) y[j] = d;
    }
    __syncthreads();
    if (tid < w) {
      T s = 0;
      for (int a = 0; a <= tid; ++a) s += Ts[a * QR_LD + tid] * y[a];
      z[tid] = s;
    }
    __syncthreads();
    for (int i = k0 + tid; i < M; i += nt) {
      const int jm = min(w - 1, i - k0);
      T s = 0;
#pragma unroll 8
      for (int j = 0; j <= jm; ++j) s += A[size_t(k0 + j) * M + i] * z[j];
      c[i] -= s;
    }
    __syncthreads();
  }
}

// stage block p's diagonal triangle of R (Rt[i * QR_LD + j] = R[k0+i][k0+j])
// and its diagonal rd
template <typename T>
__device__ void stage_block(const T* A, const QRWork& q, int p, T* Rt, T* rd) {
  const int k0 = p * QR_NB, w = min(QR_NB, q.M - k0);
  for (int idx = threadIdx.x; idx < w * w; idx += blockDim.x) {
    const int j = idx / w, i = idx % w;
    Rt[i * QR_LD + j] = A[size_t(k0 + j) * q.M + k0 + i];
  }
  for (int j = threadIdx.x; j < w; j += blockDim.x) rd[j] = A[q.rdiag_off + k0 + j];
}

// x <- R^-1 c (c is destroyed), block of QR_NB by block from the last: warp
// 0 solves the staged diagonal triangle while nothing else runs, then the
// block's columns update the rows above it and the next block is staged
template <typename T>
__device__ void back_sub(const T* A, const QRWork& q, T* c, T* x, T* Rt, T* rd) {
  const int tid = threadIdx.x, nt = blockDim.x, wl = tid & 31;
  const int M = q.M;
  stage_block(A, q, q.npan - 1, Rt, rd);
  __syncthreads();
  for (int p = q.npan - 1; p >= 0; --p) {
    const int k0 = p * QR_NB, w = min(QR_NB, M - k0);
    if (tid < 32) {
      T cl = wl < w ? c[k0 + wl] : T(0);
      for (int j = w - 1; j >= 0; --j) {
        const T xj = __shfl_sync(0xffffffffu, cl, j) / rd[j];
        if (wl < j) cl -= xj * Rt[wl * QR_LD + j];
        if (wl == j) x[k0 + j] = xj;
      }
    }
    __syncthreads();
    for (int i = tid; i < k0; i += nt) {
      T s = 0;
#pragma unroll 8
      for (int j = 0; j < w; ++j) s += A[size_t(k0 + j) * M + i] * x[k0 + j];
      c[i] -= s;
    }
    if (p > 0) stage_block(A, q, p - 1, Rt, rd);
    __syncthreads();
  }
}

// Ctx: QRCtx (the OBCA route) or DenseK; rhs1/rhs2 rows of ld1/ld2
// elements a lane, n primal rows
template <typename T, typename Ctx>
__global__ void __launch_bounds__(256) qr_solve_kernel(Ctx c, const T* __restrict__ rhs1,
                                                       const T* __restrict__ rhs2, int ld1,
                                                       int ld2, int n,
                                                       const T* __restrict__ ladder,
                                                       const long long* __restrict__ inv_perm,
                                                       const T* __restrict__ work, QRWork q,
                                                       T* __restrict__ sol,
                                                       unsigned char* __restrict__ good, int R) {
  extern __shared__ double smem_raw[];
  SmemArena ar(smem_raw);
  const int br = blockIdx.x, lane = br / R, tid = threadIdx.x, nt = blockDim.x;
  const int M = q.M;

  c.begin(ar, br, R, ladder, inv_perm);
  T* x = ar.take<T>(M);
  T* cv = ar.take<T>(M);
  T* dx = ar.take<T>(M);
  T* y = ar.take<T>(QR_NB);
  T* z = ar.take<T>(QR_NB);
  T* rd = ar.take<T>(QR_NB);
  T* Rt = ar.take<T>(QR_NB * QR_LD);
  T* red = ar.take<T>(32);
  const T* A = work + size_t(br) * q.stride;

  // sol = R^-1 Q^T rhs
  const T* b1 = rhs1 + size_t(lane) * ld1;
  const T* b2 = rhs2 + size_t(lane) * ld2;
  for (int i = tid; i < M; i += nt) cv[i] = i < n ? b1[i] : b2[i - n];
  __syncthreads();
  apply_qt(A, q, cv, y, z, Rt);
  back_sub(A, q, cv, x, Rt, rd);

  // one refinement pass: sol -= R^-1 Q^T (K sol - rhs)
  for (int i = tid; i < M; i += nt) {
    T acc = 0;
    for (int j = 0; j < M; ++j) acc += c.k(i, j) * x[j];
    cv[i] = acc - (i < n ? b1[i] : b2[i - n]);
  }
  __syncthreads();
  apply_qt(A, q, cv, y, z, Rt);
  back_sub(A, q, cv, dx, Rt, rd);
  for (int i = tid; i < M; i += nt) x[i] -= dx[i];
  __syncthreads();

  // good = all finite & dz^T W dz + delta dz^T dz > 0
  T bad = 0, curv = 0;
  T* so = sol + size_t(br) * M;
  for (int i = tid; i < M; i += nt) {
    so[i] = x[i];
    bad += isfinite(x[i]) ? T(0) : T(1);
    if (i < n) {
      T acc = 0;
      for (int j = 0; j < n; ++j) acc += c.k(i, j) * x[j];
      curv += x[i] * acc;
    }
  }
  bad = block_reduce(bad, SumOp(), red);
  curv = block_reduce(curv, SumOp(), red);
  if (tid == 0) good[br] = (bad == T(0)) && (curv > T(0));
}

// ------------------------------------------------------------ launcher
// the panel and trailing-update launches of every panel
template <typename T>
static int qr_factor(T* work, const QRWork& q, int BR, cudaStream_t st) {
  cudaError_t e;
  const int M = q.M;
  for (int k0 = 0; k0 < M; k0 += QR_NB) {
    const int w = min(QR_NB, M - k0), rest = M - k0 - w;
    VMP_LAUNCH(qr_panel_kernel<T>, BR, 512, panel_smem<T>(M - k0, w), st)(work, q, k0, w);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
    if (rest == 0) continue;
    VMP_LAUNCH(qr_update_kernel<T>, BR * ((rest + QR_TILE - 1) / QR_TILE), 256, 0, st)(
        work, q, k0, w);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  return 0;
}

template <typename T>
static int launch_kkt_qr(void** p, const long long* ints, double delta_d, cudaStream_t st) {
  const int B = int(ints[1]), R = int(ints[VMP_DIMS_END]);
  Dims D;
  if (!dims_from(ints, D)) return VMP_BAD_ARGS;
  const int M = D.n + D.mE, BR = B * R;
  const QRWork q = qr_work(M);
  QRCtx<T> c{D, (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
             (const T*)p[4], (const T*)p[5], nullptr, T(0), T(delta_d), M};
  const T* ladder = (const T*)p[8];
  const long long* inv_perm = (const long long*)p[9];
  T* work = (T*)p[10];
  const size_t smem_asm = r8_bytes(size_t(D.n) * sizeof(int));
  const size_t smem_panel = panel_smem<T>(M, QR_NB);
  const size_t smem_solve = smem_asm + 3 * r8_bytes(size_t(M) * sizeof(T)) +
                            3 * r8_bytes(QR_NB * sizeof(T)) +
                            r8_bytes(QR_NB * QR_LD * sizeof(T)) + 32 * sizeof(T);
  if (smem_panel > VMP_SMEM_MAX || smem_solve > VMP_SMEM_MAX) return VMP_TOO_LARGE;
  cudaError_t e;
  if ((e = vmp_allow_smem(qr_assemble_kernel<T>, smem_asm)) != cudaSuccess) return int(e);
  if ((e = vmp_allow_smem(qr_panel_kernel<T>, smem_panel)) != cudaSuccess) return int(e);
  if ((e = vmp_allow_smem(qr_solve_kernel<T, QRCtx<T>>, smem_solve)) != cudaSuccess) return int(e);
  if (BR == 0) return 0;
  VMP_LAUNCH(qr_assemble_kernel<T>, BR * ((M + QR_TILE - 1) / QR_TILE), 256, smem_asm, st)(
      c, ladder, inv_perm, work, q, R);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  const int rc = qr_factor<T>(work, q, BR, st);
  if (rc != 0) return rc;
  auto solve = qr_solve_kernel<T, QRCtx<T>>;   // (a template comma cannot pass the macro)
  VMP_LAUNCH(solve, BR, 256, smem_solve, st)(c, (const T*)p[6], (const T*)p[7], D.n, D.mE, D.n,
                                             ladder, inv_perm, work, q, (T*)p[11],
                                             (unsigned char*)p[12], R);
  return int(cudaGetLastError());
}

template <typename T>
static int launch_kkt_qr_dense(void** p, const long long* ints, cudaStream_t st) {
  const int B = int(ints[1]), R = int(ints[2]), M = int(ints[3]), n = int(ints[4]);
  if (B < 0 || R < 1 || M < 1 || n < 0 || n > M) return VMP_BAD_ARGS;
  const int BR = B * R;
  const QRWork q = qr_work(M);
  const T* K = (const T*)p[0];
  const T* rhs = (const T*)p[1];
  T* work = (T*)p[2];
  const size_t smem_panel = panel_smem<T>(M, QR_NB);
  const size_t smem_solve = 3 * r8_bytes(size_t(M) * sizeof(T)) + 3 * r8_bytes(QR_NB * sizeof(T)) +
                            r8_bytes(QR_NB * QR_LD * sizeof(T)) + 32 * sizeof(T);
  if (smem_panel > VMP_SMEM_MAX || smem_solve > VMP_SMEM_MAX) return VMP_TOO_LARGE;
  cudaError_t e;
  if ((e = vmp_allow_smem(qr_panel_kernel<T>, smem_panel)) != cudaSuccess) return int(e);
  if ((e = vmp_allow_smem(qr_solve_kernel<T, DenseK<T>>, smem_solve)) != cudaSuccess) return int(e);
  if (BR == 0) return 0;
  VMP_LAUNCH(qr_dense_load_kernel<T>, BR * ((M + 31) / 32), 256, 0, st)(K, work, q);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  const int rc = qr_factor<T>(work, q, BR, st);
  if (rc != 0) return rc;
  DenseK<T> c{K, M, n};
  auto solve = qr_solve_kernel<T, DenseK<T>>;
  VMP_LAUNCH(solve, BR, 256, smem_solve, st)(c, rhs, rhs + n, M, M, n, (const T*)nullptr,
                                             (const long long*)nullptr, work, q, (T*)p[3],
                                             (unsigned char*)p[4], R);
  return int(cudaGetLastError());
}

// ptrs: JE_sp, JEb_th, JEb_q, Wpp, Wpq, Wqq, rhs1, rhs2, ladder,
//       inv_perm (int64) | work (B*R x kernels.qr_workspace_elems),
//       sol (B, R, M), good (uint8)
// ints: dtype, B, dims (common.cuh dims_from), R;
// reals: delta_d
VMP_ENTRY(kkt_qr) {
  if (nptr != 13 || nint != VMP_DIMS_END + 1 || nreal != 1) return VMP_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ints[0] == 0) return launch_kkt_qr<float>(ptrs, ints, reals[0], st);
  if (ints[0] == 1) return launch_kkt_qr<double>(ptrs, ints, reals[0], st);
  return VMP_BAD_DTYPE;
}

// ptrs: K (B*R, M, M), rhs (B, M) | work (B*R x kernels.qr_workspace_elems),
//       sol (B*R, M), good (uint8)
// ints: dtype, B, R, M, n
VMP_ENTRY(kkt_qr_dense) {
  if (nptr != 5 || nint != 5 || nreal != 0) return VMP_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ints[0] == 0) return launch_kkt_qr_dense<float>(ptrs, ints, st);
  if (ints[0] == 1) return launch_kkt_qr_dense<double>(ptrs, ints, st);
  return VMP_BAD_DTYPE;
}
