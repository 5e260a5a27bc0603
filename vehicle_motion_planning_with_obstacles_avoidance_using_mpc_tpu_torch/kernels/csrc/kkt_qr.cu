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
// small arrow pieces. This first version is bound instead by its memory
// traffic: M^2 values (346 KB in float32) do not fit a block's shared
// memory, so the matrix lives in a device workspace the wrapper allocates
// and every column step streams the trailing submatrix through L2.
// Design: one CTA per (lane, rung). K is assembled column-major into the
// workspace straight from the arrow pieces (W in Wpp/Wpq/Wqq form and the
// provider's JE pieces, mapped to flat z order through inv_perm). Column
// k: a block reduction for its norm, the reflector v (LAPACK's sign
// convention, R's diagonal kept apart) stored in place of the column,
// then one warp per trailing column (coalesced, column-major) forms
// v^T a with a shuffle reduction and updates the column. Q^T b applies
// the stored reflectors one block reduction each; back-substitution is
// column-oriented, one barrier per column. The refinement's residual
// K sol - rhs recomputes each entry of K from the arrow pieces instead of
// keeping a copy. IEEE sqrt and division (no fast math): a NaN or Inf
// anywhere reaches the solution, and good is false there.
#include "common.cuh"

template <typename T>
struct QRCtx {
  Dims D;
  const T *JE, *JEth, *JEq, *Wpp, *Wpq, *Wqq;
  const int* pos;  // flat z index -> position in [spine (np); blocks (K*bq)]
  T delta, delta_d;
  int M;

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
    if (!pos_slot(D, p, s, t) || t != D.k_lo + kb / D.nO) return T(0);
    return Wpq[(kb * 3 + s) * bq + q % bq];
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
};

template <typename T>
__device__ inline T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// c <- Q^T c with the reflectors stored in the columns of A
template <typename T>
__device__ void apply_qt(const T* A, const T* beta, T* c, int M, T* red) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int k = 0; k < M; ++k) {
    const T* v = A + size_t(k) * M;
    T d = 0;
    for (int i = k + tid; i < M; i += nt) d += v[i] * c[i];
    const T s = beta[k] * block_reduce(d, SumOp(), red);
    for (int i = k + tid; i < M; i += nt) c[i] -= s * v[i];
    __syncthreads();
  }
}

// x <- R^-1 c (c is destroyed); R above the diagonal of A, diagonal rdiag
template <typename T>
__device__ void back_sub(const T* A, const T* rdiag, T* c, T* x, int M) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int k = M - 1; k >= 0; --k) {
    const T xk = c[k] / rdiag[k];
    if (tid == 0) x[k] = xk;
    const T* col = A + size_t(k) * M;
    for (int i = tid; i < k; i += nt) c[i] -= xk * col[i];
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(256) kkt_qr_kernel(QRCtx<T> base, const T* __restrict__ rhs1,
                                                     const T* __restrict__ rhs2,
                                                     const T* __restrict__ ladder,
                                                     const long long* __restrict__ inv_perm,
                                                     T* __restrict__ work, T* __restrict__ sol,
                                                     unsigned char* __restrict__ good, int R) {
  extern __shared__ double smem_raw[];
  SmemArena ar(smem_raw);
  const Dims& D = base.D;
  const int br = blockIdx.x, lane = br / R, tid = threadIdx.x, nt = blockDim.x;
  const int n = D.n, mE = D.mE, M = base.M, np_ = D.np_, K = D.K, bq = D.bq;
  const int wid = tid >> 5, wl = tid & 31, nw = nt >> 5;

  QRCtx<T> c = base;
  c.JE += size_t(lane) * D.mE_sp * np_;
  c.JEth += size_t(lane) * K * 2;
  c.JEq += size_t(lane) * K * 2 * bq;
  c.Wpp += size_t(lane) * np_ * np_;
  c.Wpq += size_t(lane) * K * 3 * bq;
  c.Wqq += size_t(lane) * K * bq * bq;
  c.delta = ladder[br];

  int* pos = ar.take<int>(n);
  T* v = ar.take<T>(M);
  T* beta = ar.take<T>(M);
  T* rdiag = ar.take<T>(M);
  T* x = ar.take<T>(M);
  T* cv = ar.take<T>(M);
  T* red = ar.take<T>(32);
  for (int i = tid; i < n; i += nt) pos[i] = int(inv_perm[i]);
  c.pos = pos;
  __syncthreads();

  // K, column-major: A[j * M + i] = K[i][j]
  T* A = work + size_t(br) * M * M;
  for (size_t idx = tid; idx < size_t(M) * M; idx += nt) {
    const int j = int(idx / M), i = int(idx % M);
    A[idx] = c.k(i, j);
  }
  __syncthreads();

  // Householder QR in place
  for (int k = 0; k < M; ++k) {
    T* col = A + size_t(k) * M;
    T ss = 0;
    for (int i = k + tid; i < M; i += nt) {
      const T a = col[i];
      v[i] = a;
      ss += a * a;
    }
    const T sigma = sqrt(block_reduce(ss, SumOp(), red));
    const T alpha = v[k];
    const T r = alpha >= T(0) ? -sigma : sigma;
    __syncthreads();
    if (tid == 0) {
      const bool zero = sigma == T(0);
      v[k] = alpha - r;
      col[k] = alpha - r;
      beta[k] = zero ? T(0) : T(1) / (sigma * (sigma + fabs(alpha)));
      rdiag[k] = zero ? alpha : r;
    }
    __syncthreads();
    const T bk = beta[k];
    for (int j = k + 1 + wid; j < M; j += nw) {
      T* aj = A + size_t(j) * M;
      T d = 0;
      for (int i = k + wl; i < M; i += 32) d += v[i] * aj[i];
      const T s = bk * warp_sum(d);
      for (int i = k + wl; i < M; i += 32) aj[i] -= s * v[i];
    }
    __syncthreads();
  }

  // sol = R^-1 Q^T rhs
  const T* b1 = rhs1 + size_t(lane) * n;
  const T* b2 = rhs2 + size_t(lane) * mE;
  for (int i = tid; i < M; i += nt) cv[i] = i < n ? b1[i] : b2[i - n];
  __syncthreads();
  apply_qt(A, beta, cv, M, red);
  back_sub(A, rdiag, cv, x, M);

  // one refinement pass: sol -= R^-1 Q^T (K sol - rhs)
  for (int i = tid; i < M; i += nt) {
    T acc = 0;
    for (int j = 0; j < M; ++j) acc += c.k(i, j) * x[j];
    cv[i] = acc - (i < n ? b1[i] : b2[i - n]);
  }
  __syncthreads();
  apply_qt(A, beta, cv, M, red);
  back_sub(A, rdiag, cv, v, M);
  for (int i = tid; i < M; i += nt) x[i] -= v[i];
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

template <typename T>
static int launch_kkt_qr(void** p, const long long* ints, double delta_d, cudaStream_t st) {
  const int B = int(ints[1]), R = int(ints[10]);
  Dims D;
  if (!dims_from(ints, D)) return VMP_BAD_ARGS;
  const int M = D.n + D.mE;
  QRCtx<T> c{D, (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
             (const T*)p[4], (const T*)p[5], nullptr, T(0), T(delta_d), M};
  const size_t smem = ((size_t(D.n) * sizeof(int) + 7) / 8) * 8 + 5 * ((size_t(M) * sizeof(T) + 7) / 8) * 8 +
                      32 * sizeof(T);
  if (smem > 227 * 1024) return VMP_TOO_LARGE;
  cudaError_t e = vmp_allow_smem(kkt_qr_kernel<T>, smem);
  if (e != cudaSuccess) return int(e);
  if (B * R == 0) return 0;
  VMP_LAUNCH(kkt_qr_kernel<T>, B * R, 256, smem, st)((c), (const T*)p[6], (const T*)p[7],
                                                     (const T*)p[8], (const long long*)p[9],
                                                     (T*)p[10], (T*)p[11], (unsigned char*)p[12], R);
  return int(cudaGetLastError());
}

// ptrs: JE_sp, JEb_th, JEb_q, Wpp, Wpq, Wqq, rhs1, rhs2, ladder,
//       inv_perm (int64) | work (B*R, M, M), sol (B, R, M), good (uint8)
// ints: dtype, B, dims (common.cuh dims_from), R;  reals: delta_d
VMP_ENTRY(kkt_qr) {
  if (nptr != 13 || nint != 11 || nreal != 1) return VMP_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ints[0] == 0) return launch_kkt_qr<float>(ptrs, ints, reals[0], st);
  if (ints[0] == 1) return launch_kkt_qr<double>(ptrs, ints, reals[0], st);
  return VMP_BAD_DTYPE;
}
