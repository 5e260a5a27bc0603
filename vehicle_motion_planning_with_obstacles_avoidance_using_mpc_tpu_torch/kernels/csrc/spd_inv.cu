// spd_inv: batched inverse of symmetric positive definite matrices of
// order m <= 120, NaN (the whole matrix) wherever one is not SPD.
//
// Replaces: the JAX package's solver/ipm.py _chol_inv_small (:261-302, the
// (K, 8, 8) dual blocks) and _spd_inv (:317-356, the spine Schur
// complement, m = np = 29-119). The JAX code runs an unrolled Cholesky
// batch-minor for TPU lanes and a recursive 2x2 block-Schur inverse to
// dodge the TPU's serial Cholesky custom call; SPD(A) <=> SPD(A11) and
// SPD(Schur), so a direct Cholesky here keeps the same NaN-on-non-SPD
// rejection signal. Above m = 120, spd_inv_blocked.cu.
// Bound on this card: bytes in principle (61440 blocks of 8 x 8 and 2560
// spines of 33 x 33 at the fix step's 1280 lanes x R = 2), ~m^3
// operations on m^2 entries each; in practice the chain of dependent
// steps of one matrix (3m column or row steps), which the design shortens
// and overlaps across matrices. One CTA a matrix (this kernel's first
// design) left it at ~4% of the byte bound.
// Design: one launch a call, two routes chosen by m (spd_route below,
// kernels.spd_inv_route in Python); no workspace, no host sync, no
// allocation, so it is safe inside the captured Newton loop. Both read the
// lower triangle and run LAPACK potri's order in place (potrf, trtri,
// lauum) with the same sums:
//   Cholesky by columns (Crout): l_ij = (a_ij - sum_{k < j} l_ik l_jk) /
//     l_jj, l_jj = sqrt(a_jj - sum_{k < j} l_jk^2);
//   X = L^-1 by rows (forward substitution): x_ii = 1 / l_ii, x_ik =
//     -(sum_{k <= l < i} l_il x_lk) x_ii;
//   B = X^T X: b_ij = sum_{k >= i} x_ki x_kj, j <= i.
//   * m <= 16 (SPD_SMALL_M, the dual blocks): a thread a matrix, the
//     packed lower triangle in registers (M a template argument, every
//     loop unrolled), P matrices a CTA (up to 128, as many as the stage
//     fits in 48 KB). The CTA loads its P consecutive matrices with
//     coalesced loads into a shared stage laid out entry-major (entry e of
//     matrix t at e (P + 1) + t: the thread-per-matrix reads hit
//     consecutive words, the transposing stores an odd stride: no bank
//     conflicts), and writes back through it the same way. Two barriers,
//     after the load and before the store; none inside the factorization.
//   * 17 <= m <= 120: a warp a matrix, in one m x LD array in shared
//     memory (LD: an odd number of 16-byte vectors, at least m; rows read
//     as vectors, consecutive rows on distinct banks), at most 2 a CTA
//     (small CTAs spread the fix step's 2560 spines evenly over the 132
//     SMs: no warp shares anything). Copied in with cp.async.
//     Each phase runs in steps of 4 columns (rows), SPD_NB: one pass of
//     dot products over the finished part for the four at once (a lane's
//     rows, lane + 32 g, read once for all four), then the four in
//     registers: a Cholesky step shuffles each pivot and l_jk from its
//     row's lane; X is kept transposed in the upper triangle, and a row of
//     L is zeroed once its step is done, so that every dot product runs
//     over an aligned range (the extra terms are 0); B is written into the
//     lower triangle with its mirror, and the matrix is copied out row by
//     row. No __syncthreads: every warp runs on its own, with __syncwarp
//     between the steps' reads and writes.
// A pivot that is not > 0 or not finite (a NaN entry of the lower
// triangle reaches a pivot) stops the matrix, and its whole output is
// written NaN, as spd_inv_blocked does and as the plain version's NaN
// propagation gives; the regularisation ladder reads that as a rejected
// rung. IEEE sqrt and division (no fast math), FMA in the tensor's own
// precision. Every sum runs in ascending order on both routes, except
// that the warp route's Cholesky subtracts the terms of its step's own
// columns one at a time after the rest.
#include "common.cuh"

#define SPD_MAX_M 120
#define SPD_SMALL_M 16               // up to here a thread a matrix
#define SPD_SMALL_MAX_P 128          // matrices (threads) a CTA, thread route
#define SPD_SMALL_STAGE (48 * 1024)  // the thread route's stage, at most
#define SPD_WARP_MAX_W 2             // matrices (warps) a CTA, warp route
#define SPD_WARP_BUDGET (100 * 1024) // the warp route's matrices, at most
#define SPD_FULL 0xffffffffu

__device__ inline float spd_nan(float) { return nanf(""); }
__device__ inline double spd_nan(double) { return nan(""); }

template <typename T>
__device__ inline bool spd_bad_pivot(T d) { return !(d > T(0)) || isinf(d); }

// The row stride of the warp route: a multiple of a 16-byte vector, an odd
// number of vectors (lanes reading vectors of consecutive rows hit
// distinct banks), at least m.
__host__ __device__ inline int spd_ld(int m, int elem) {
  const int w = 16 / elem;
  return w * (((m + w - 1) / w) | 1);
}

// The launch shape of one call (kernels.spd_inv_route mirrors it).
struct SpdRoute {
  int warp;      // 0: a thread a matrix, 1: a warp a matrix
  int per_cta;   // matrices a CTA
  int threads;
  size_t smem;   // dynamic shared bytes a CTA
};

inline SpdRoute spd_route(int m, size_t elem) {
  SpdRoute r;
  if (m <= SPD_SMALL_M) {
    int P = SPD_SMALL_MAX_P;
    while (P > 1 && size_t(m) * m * (P + 1) * elem > SPD_SMALL_STAGE) P /= 2;
    r.warp = 0;
    r.per_cta = P;
    r.threads = P;
    r.smem = size_t(m) * m * (P + 1) * elem;
  } else {
    const size_t per = size_t(m) * spd_ld(m, int(elem)) * elem;
    int W = int(SPD_WARP_BUDGET / per);
    W = W < 1 ? 1 : (W > SPD_WARP_MAX_W ? SPD_WARP_MAX_W : W);
    r.warp = 1;
    r.per_cta = W;
    r.threads = 32 * W;
    r.smem = W * per;
  }
  return r;
}

// ------------------------------------------------ a thread a matrix
// (i, j), i >= j, in a packed lower triangle
__host__ __device__ constexpr int spd_tri(int i, int j) { return i * (i + 1) / 2 + j; }

// The inverse of the SPD matrix whose lower triangle is a, in place;
// true (a left partly factored) where a pivot is bad.
template <typename T, int M>
__device__ inline bool spd_invert_packed(T (&a)[M * (M + 1) / 2]) {
#pragma unroll
  for (int j = 0; j < M; ++j) {
    T v[M];   // v_i = a_ij - sum_{k < j} l_ik l_jk, i >= j
#pragma unroll
    for (int i = j; i < M; ++i) {
      T s = T(0);
#pragma unroll
      for (int k = 0; k < j; ++k) s += a[spd_tri(i, k)] * a[spd_tri(j, k)];
      v[i] = a[spd_tri(i, j)] - s;
    }
    if (spd_bad_pivot(v[j])) return true;
    const T p = sqrt(v[j]);
    a[spd_tri(j, j)] = p;
#pragma unroll
    for (int i = j + 1; i < M; ++i) a[spd_tri(i, j)] = v[i] / p;
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const T r = T(1) / a[spd_tri(i, i)];
#pragma unroll
    for (int k = 0; k < i; ++k) {
      T s = T(0);
#pragma unroll
      for (int l = k; l < i; ++l) s += a[spd_tri(i, l)] * a[spd_tri(l, k)];
      a[spd_tri(i, k)] = -s * r;
    }
    a[spd_tri(i, i)] = r;
  }
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      T s = T(0);
#pragma unroll
      for (int k = i; k < M; ++k) s += a[spd_tri(k, i)] * a[spd_tri(k, j)];
      a[spd_tri(i, j)] = s;
    }
  return false;
}

template <typename T, int M>
__global__ void __launch_bounds__(SPD_SMALL_MAX_P) spd_thread_kernel(const T* __restrict__ A,
                                                                     T* __restrict__ out,
                                                                     long long count) {
  extern __shared__ __align__(16) double smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);   // entry e of matrix t at e * LD + t
  constexpr int MM = M * M;
  const int P = blockDim.x, LD = P + 1, t = threadIdx.x;
  const long long first = (long long)blockIdx.x * P;
  const int n = int(count - first < P ? count - first : P);
  const size_t base = size_t(first) * MM;
  for (int g = t; g < n * MM; g += P) S[(g % MM) * LD + g / MM] = A[base + g];
  __syncthreads();
  if (t < n) {
    T a[M * (M + 1) / 2];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) a[spd_tri(i, j)] = S[(i * M + j) * LD + t];
    const bool bad = spd_invert_packed<T, M>(a);
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j)
        S[(i * M + j) * LD + t] = bad ? spd_nan(T(0)) : a[i >= j ? spd_tri(i, j) : spd_tri(j, i)];
  }
  __syncthreads();
  for (int g = t; g < n * MM; g += P) out[base + g] = S[(g % MM) * LD + g / MM];
}

// --------------------------------------------------- a warp a matrix
// 16-byte vectors of T: the dot products below read rows of the matrix
template <typename T> struct SpdVec;
template <> struct SpdVec<float> {
  typedef float4 V;
  static constexpr int W = 4;
  __device__ static float at(const float4& v, int t) {
    return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
  }
};
template <> struct SpdVec<double> {
  typedef double2 V;
  static constexpr int W = 2;
  __device__ static double at(const double2& v, int t) { return t == 0 ? v.x : v.y; }
};

// One element global -> shared without a register (cp.async), and the wait
// for this thread's copies; a plain copy where there is no device code.
template <typename T>
__device__ inline void spd_copy_async(T* dst, const T* src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "n"(sizeof(T)));
#else
  *dst = *src;
#endif
}

__device__ inline void spd_copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

#define SPD_NB 4   // columns (rows) a step of the warp route

// acc[g][c] += sum_{lo <= l < hi} a[g][l] b[c][l] for the G rows a[g] of
// the lanes and the SPD_NB rows b[c] of the warp, in ascending l: lo a
// multiple of the vector width, the rows 16-byte aligned with room for a
// whole vector past hi (the stride). Read as vectors; the G x SPD_NB sums
// are independent chains. The last vector's terms past hi are left out.
template <typename T, int G>
__device__ inline void spd_dots(const T* const (&a)[4], const T* const (&b)[SPD_NB], int lo,
                                int hi, T (&acc)[4][SPD_NB]) {
  typedef SpdVec<T> Vt;
  typedef typename Vt::V V;
  constexpr int W = Vt::W;
  int l = lo;
#pragma unroll 2
  for (; l + W <= hi; l += W) {
    V y[SPD_NB];
#pragma unroll
    for (int c = 0; c < SPD_NB; ++c) y[c] = *reinterpret_cast<const V*>(b[c] + l);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const V x = *reinterpret_cast<const V*>(a[g] + l);
#pragma unroll
      for (int t = 0; t < W; ++t)
#pragma unroll
        for (int c = 0; c < SPD_NB; ++c) acc[g][c] += Vt::at(x, t) * Vt::at(y[c], t);
    }
  }
  if (l < hi) {
    V y[SPD_NB];
#pragma unroll
    for (int c = 0; c < SPD_NB; ++c) y[c] = *reinterpret_cast<const V*>(b[c] + l);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const V x = *reinterpret_cast<const V*>(a[g] + l);
#pragma unroll
      for (int t = 0; t < W; ++t)
        if (l + t < hi) {
#pragma unroll
          for (int c = 0; c < SPD_NB; ++c) acc[g][c] += Vt::at(x, t) * Vt::at(y[c], t);
        }
    }
  }
}

// spd_dots over the first ng (<= NQ, the same on every lane) lane rows,
// from zeroed sums
template <typename T, int NQ>
__device__ inline void spd_dots_n(int ng, const T* const (&a)[4], const T* const (&b)[SPD_NB],
                                  int lo, int hi, T (&acc)[4][SPD_NB]) {
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int c = 0; c < SPD_NB; ++c) acc[g][c] = T(0);
  if constexpr (NQ >= 4) {
    if (ng >= 4) return spd_dots<T, 4>(a, b, lo, hi, acc);
  }
  if constexpr (NQ >= 3) {
    if (ng == 3) return spd_dots<T, 3>(a, b, lo, hi, acc);
  }
  if constexpr (NQ >= 2) {
    if (ng == 2) return spd_dots<T, 2>(a, b, lo, hi, acc);
  }
  if (ng >= 1) spd_dots<T, 1>(a, b, lo, hi, acc);
}

// NQ = ceil(m / 32): the most rows a lane takes in a step, as lane + 32 g.
// Each phase runs in steps of SPD_NB columns (rows) j0..j0+3: one pass of
// dot products over the finished part of the matrix for the four at once
// (the lane's rows read once for all four), then the four in registers.
template <typename T, int NQ>
__global__ void __launch_bounds__(SPD_WARP_MAX_W * 32) spd_warp_kernel(const T* __restrict__ A,
                                                                       T* __restrict__ out,
                                                                       long long count, int m) {
  extern __shared__ __align__(16) double smem_raw[];
  const int LD = spd_ld(m, sizeof(T)), warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long mat = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (mat >= count) return;   // the whole warp: no CTA-wide barrier follows
  T* S = reinterpret_cast<T*>(smem_raw) + size_t(warp) * m * LD;
  const T* a = A + size_t(mat) * m * m;
  const int mm = m * m;
  // (row, column) of the flat index g < m^2 <= 14400 without a division:
  // g / m in float is at least 0.5 / m from an integer
  const float inv_m = 1.0f / float(m);
  for (int g = lane; g < mm; g += 32) {   // the whole matrix, coalesced
    const int r = int((float(g) + 0.5f) * inv_m), c = g - r * m;
    spd_copy_async(S + r * LD + c, a + g);
  }
  spd_copy_wait();
  __syncwarp();
  const T* rows[4];        // the lane's rows of a step (past the end: the last row)
  const T* brow[SPD_NB];   // the step's rows j0 + c (past the end: the last row)
  T acc[4][SPD_NB];

  // Cholesky by columns (Crout): l_ij = (a_ij - sum_{k < j} l_ik l_jk) / l_jj
  // for the rows i = j0 + lane + 32 g >= j; the sum over k < j0 in one pass,
  // the terms j0 <= k < j in registers (l_jk from row j's lane, shuffled)
  bool bad = false;
  for (int j0 = 0; j0 < m && !bad; j0 += SPD_NB) {
#pragma unroll
    for (int g = 0; g < 4; ++g) rows[g] = S + min(j0 + lane + 32 * g, m - 1) * LD;
#pragma unroll
    for (int c = 0; c < SPD_NB; ++c) brow[c] = S + min(j0 + c, m - 1) * LD;
    spd_dots_n<T, NQ>((m - j0 + 31) >> 5, rows, brow, 0, j0, acc);
#pragma unroll
    for (int g = 0; g < NQ; ++g) {
      const int i = min(j0 + lane + 32 * g, m - 1);
#pragma unroll
      for (int c = 0; c < SPD_NB; ++c) acc[g][c] = S[i * LD + min(j0 + c, m - 1)] - acc[g][c];
    }
#pragma unroll
    for (int c = 0; c < SPD_NB; ++c) {
      const int j = j0 + c;
      if (j >= m) break;                                // the same on every lane
      const T d = __shfl_sync(SPD_FULL, acc[0][c], c);  // the pivot: row j, lane c
      bad = spd_bad_pivot(d);                           // the same on every lane
      if (bad) break;
      const T p = sqrt(d);
      T l[NQ];
#pragma unroll
      for (int g = 0; g < NQ; ++g) {
        if (32 * g >= m - j0) break;   // the same on every lane
        const int i = j0 + lane + 32 * g;
        l[g] = i == j ? p : acc[g][c] / p;
        if (i >= j && i < m) S[i * LD + j] = l[g];
      }
#pragma unroll
      for (int c2 = c + 1; c2 < SPD_NB; ++c2) {
        const T ljc = __shfl_sync(SPD_FULL, l[0], c2);   // l_{j0+c2, j}
#pragma unroll
        for (int g = 0; g < NQ; ++g) {
          if (32 * g >= m - j0) break;
          acc[g][c2] -= l[g] * ljc;
        }
      }
    }
    __syncwarp();   // the columns written before the next step reads them
  }

  if (!bad) {
    // X = L^-1 by rows, x_ik = -(sum_{k <= l < i} l_il x_lk) / l_ii, kept
    // transposed in the upper triangle (row i of X is column i of X^T),
    // the lanes over k. Row i of L is zeroed once its step is done (no
    // later step needs it), so that the sums over l < i0 run from 0 for
    // every lane: the terms l < k are 0. Then the rows i0 <= i < i0 + 4 in
    // registers, each from the ones before it.
    for (int i0 = 0; i0 < m; i0 += SPD_NB) {
#pragma unroll
      for (int g = 0; g < 4; ++g) rows[g] = S + min(lane + 32 * g, m - 1) * LD;
#pragma unroll
      for (int c = 0; c < SPD_NB; ++c) brow[c] = S + min(i0 + c, m - 1) * LD;
      const int nk = min(i0 + SPD_NB, m);   // the lanes k < nk take part
      spd_dots_n<T, NQ>((nk + 31) >> 5, rows, brow, 0, i0, acc);
      T r[SPD_NB], lb[SPD_NB][SPD_NB];
#pragma unroll
      for (int c = 0; c < SPD_NB; ++c) {
        const int i = min(i0 + c, m - 1);
        r[c] = T(1) / S[i * LD + i];
#pragma unroll
        for (int c2 = 0; c2 < c; ++c2) lb[c][c2] = i0 + c < m ? S[i * LD + i0 + c2] : T(0);
      }
      T x[NQ][SPD_NB];
#pragma unroll
      for (int g = 0; g < NQ; ++g) {
        if (32 * g >= nk) break;   // the same on every lane
        const int k = lane + 32 * g;
#pragma unroll
        for (int c = 0; c < SPD_NB; ++c) {
          T t = k < i0 ? acc[g][c] : T(0);   // rows k >= i0: x_lk = 0 for l < i0
#pragma unroll
          for (int c2 = 0; c2 < c; ++c2) t += lb[c][c2] * x[g][c2];
          x[g][c] = k == i0 + c ? r[c] : (k < i0 + c ? -t * r[c] : T(0));
        }
      }
      __syncwarp();   // rows i0.. of L and the columns < i0 of X^T read by every lane
#pragma unroll
      for (int g = 0; g < NQ; ++g) {
        if (32 * g >= nk) break;   // the same on every lane
        const int k = lane + 32 * g;
#pragma unroll
        for (int c = 0; c < SPD_NB; ++c) {
          const int i = i0 + c;
          if (i < m && k <= i) S[k * LD + i] = x[g][c];
          if (i < m && k < i) S[i * LD + k] = T(0);
        }
      }
      __syncwarp();   // columns i0.. of X^T written before the next step reads them
    }
    // B = X^T X, b_ij = sum_{k >= i} x_ki x_kj for j <= i: rows of X^T from
    // i0 on (the terms k < i are 0: rows i0.. of the strict lower
    // triangle, zeroed above, take b_ij only once every lane has read
    // them), written with its mirror b_ji: later steps read the rows of
    // X^T only from column i0 + 4 on
    for (int i0 = 0; i0 < m; i0 += SPD_NB) {
#pragma unroll
      for (int g = 0; g < 4; ++g) rows[g] = S + min(lane + 32 * g, m - 1) * LD;
#pragma unroll
      for (int c = 0; c < SPD_NB; ++c) brow[c] = S + min(i0 + c, m - 1) * LD;
      const int nj = min(i0 + SPD_NB, m);   // the lanes j < nj take part
      spd_dots_n<T, NQ>((nj + 31) >> 5, rows, brow, i0, m, acc);
      __syncwarp();   // rows i0.. read by every lane before they are written
#pragma unroll
      for (int g = 0; g < NQ; ++g) {
        if (32 * g >= nj) break;   // the same on every lane
        const int j = lane + 32 * g;
#pragma unroll
        for (int c = 0; c < SPD_NB; ++c)
          if (i0 + c < m && j <= i0 + c) {
            S[(i0 + c) * LD + j] = acc[g][c];
            S[j * LD + i0 + c] = acc[g][c];
          }
      }
    }
    __syncwarp();
  }

  T* o = out + size_t(mat) * m * m;
  const T nanv = spd_nan(T(0));
#pragma unroll 4
  for (int g = lane; g < mm; g += 32) {
    const int r = int((float(g) + 0.5f) * inv_m), c = g - r * m;
    o[g] = bad ? nanv : S[r * LD + c];
  }
}

// -------------------------------------------------------- the launch
template <typename T, int M>
static int launch_thread(const void* A, void* out, long long count, const SpdRoute& r,
                         cudaStream_t st) {
  const unsigned grid = unsigned((count + r.per_cta - 1) / r.per_cta);
  void (*kernel)(const T*, T*, long long) = spd_thread_kernel<T, M>;
  VMP_LAUNCH(kernel, grid, r.threads, r.smem, st)((const T*)A, (T*)out, count);
  return int(cudaGetLastError());
}

template <typename T>
static int launch_spd_inv(void** p, long long count, int m, cudaStream_t st) {
  if (m < 1 || m > SPD_MAX_M) return VMP_TOO_LARGE;
  const SpdRoute r = spd_route(m, sizeof(T));
  if (r.warp) {
    void (*kernel)(const T*, T*, long long, int) =
        m <= 32 ? spd_warp_kernel<T, 1> : m <= 64 ? spd_warp_kernel<T, 2>
                : m <= 96 ? spd_warp_kernel<T, 3> : spd_warp_kernel<T, 4>;
    cudaError_t e = vmp_allow_smem(kernel, r.smem);
    if (e != cudaSuccess) return int(e);
    if (count == 0) return 0;
    const unsigned grid = unsigned((count + r.per_cta - 1) / r.per_cta);
    VMP_LAUNCH(kernel, grid, r.threads, r.smem, st)((const T*)p[0], (T*)p[1], count, m);
    return int(cudaGetLastError());
  }
  if (count == 0) return 0;   // the stage stays within the 48 KB default
  switch (m) {
#define SPD_CASE(M) \
  case M: return launch_thread<T, M>(p[0], p[1], count, r, st);
    SPD_CASE(1) SPD_CASE(2) SPD_CASE(3) SPD_CASE(4) SPD_CASE(5) SPD_CASE(6) SPD_CASE(7)
    SPD_CASE(8) SPD_CASE(9) SPD_CASE(10) SPD_CASE(11) SPD_CASE(12) SPD_CASE(13)
    SPD_CASE(14) SPD_CASE(15) SPD_CASE(16)
#undef SPD_CASE
  }
  return VMP_TOO_LARGE;
}

// ptrs: A (count, m, m), out (count, m, m)
// ints: dtype, count, m
VMP_ENTRY(spd_inv) {
  if (nptr != 2 || nint != 3 || nreal != 0) return VMP_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ints[0] == 0) return launch_spd_inv<float>(ptrs, ints[1], int(ints[2]), st);
  if (ints[0] == 1) return launch_spd_inv<double>(ptrs, ints[1], int(ints[2]), st);
  return VMP_BAD_DTYPE;
}

// The route of order m in dtype code dtype (0 float32, 1 float64) as
// out = {warp, per_cta, threads, smem}, for kernels.spd_inv_route to be
// checked against; VMP_TOO_LARGE above SPD_MAX_M.
extern "C" int spd_inv_route_info(int m, int dtype, long long* out) {
  if (m < 1 || m > SPD_MAX_M) return VMP_TOO_LARGE;
  if (dtype != 0 && dtype != 1) return VMP_BAD_DTYPE;
  const SpdRoute r = spd_route(m, dtype == 0 ? sizeof(float) : sizeof(double));
  out[0] = r.warp;
  out[1] = r.per_cta;
  out[2] = r.threads;
  out[3] = (long long)r.smem;
  return 0;
}
