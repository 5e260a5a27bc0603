// spd_inv_blocked: batched inverse of symmetric positive definite matrices
// of any order m, NaN (the whole matrix) wherever one is not SPD.
//
// Replaces: the JAX package's solver/ipm.py _spd_inv above
// _BLOCK_INV_LIMIT (:352-356: a Cholesky, a triangular solve against I,
// then L^-T L^-1) for the spine Schur complements of long horizons (m =
// 5N + 4 at free time: 204 at N = 40, 374 at N = 74), which spd_inv.cu
// cannot hold (m <= 120: two m x m arrays in shared memory).
// Bound on this card: operations, ~m^3 per matrix (m^3 / 3 for the
// factor, m^3 / 3 for L^-1, m^3 / 3 for the product, multiply and add
// counted as two), 8 us for 10 matrices of m = 374 at 67 TFLOP/s. The
// batch is small (the open loop's 5 candidates x 2 rungs: 10 CTAs on
// 132 SMs), so this first version's time is the latency of its block
// loop and its shared-memory traffic, not the card's arithmetic rate.
// Design: one CTA per matrix. The factor L and the inverse X = L^-1 live
// in a device workspace (1.1 MB each at m = 374 in float64, so they stay
// in L2); the work is staged through shared memory in column blocks of NB
// (32 in float64, 64 in float32) and row chunks of CH = 256:
//   1. right-looking blocked Cholesky: the NB x NB diagonal block is
//      factored in shared memory, the panel below it solved by one thread
//      per row, the trailing lower triangle updated chunk pair by chunk
//      pair;
//   2. X = L^-1 by block forward substitution of I: one thread per column
//      solves a block row against the diagonal block, then the rows below
//      are updated chunk by chunk;
//   3. out = X^T X, accumulated block row by block row over the lower
//      triangle, then mirrored.
// A pivot that is not > 0 (or NaN) sets a flag and the CTA writes NaN to
// the whole inverse, as the plain version (cholesky_ex's info > 0) and
// the JAX package's cholesky do; the regularisation ladder reads that as
// a rejected rung. IEEE sqrt and division (no fast math).
#include "common.cuh"

#define SPDB_THREADS 256
#define SPDB_CH 256       // rows of a chunk (one per thread in the panel solve)
#define SPDB_PS (SPDB_CH + 1)

template <typename T> struct SpdbNB;
template <> struct SpdbNB<float> { static constexpr int value = 64; };
template <> struct SpdbNB<double> { static constexpr int value = 32; };

template <typename T>
__host__ __device__ inline size_t spdb_smem() {
  constexpr int NB = SpdbNB<T>::value;
  return (size_t(NB) * (NB + 1) + 2 * size_t(NB) * SPDB_PS) * sizeof(T);
}

__device__ inline float spdb_nan(float) { return nanf(""); }
__device__ inline double spdb_nan(double) { return nan(""); }

// P[l * PS + r] = M[(row0 + r) * m + col0 + l] for r < rows, l < kb
template <typename T>
__device__ inline void load_rows(T* P, const T* M, int m, int row0, int rows, int col0, int kb) {
  for (int idx = threadIdx.x; idx < rows * kb; idx += blockDim.x) {
    const int r = idx / kb, l = idx % kb;
    P[l * SPDB_PS + r] = M[size_t(row0 + r) * m + col0 + l];
  }
}

// P[l * PS + c] = M[(row0 + l) * m + col0 + c] for l < kb, c < cols
template <typename T>
__device__ inline void load_cols(T* P, const T* M, int m, int row0, int kb, int col0, int cols) {
  for (int idx = threadIdx.x; idx < kb * cols; idx += blockDim.x) {
    const int l = idx / cols, c = idx % cols;
    P[l * SPDB_PS + c] = M[size_t(row0 + l) * m + col0 + c];
  }
}

// Dg (kb x kb, row stride NB + 1) = lower triangle of M's diagonal block at k0
template <typename T, int NB>
__device__ inline void load_diag(T* Dg, const T* M, int m, int k0, int kb) {
  for (int idx = threadIdx.x; idx < kb * kb; idx += blockDim.x) {
    const int r = idx / kb, c = idx % kb;
    Dg[r * (NB + 1) + c] = c <= r ? M[size_t(k0 + r) * m + k0 + c] : T(0);
  }
}

template <typename T>
__global__ void __launch_bounds__(SPDB_THREADS) spd_inv_blocked_kernel(const T* __restrict__ A,
                                                                       T* __restrict__ work,
                                                                       T* __restrict__ out,
                                                                       int m) {
  constexpr int NB = SpdbNB<T>::value, DS = NB + 1, CH = SPDB_CH, PS = SPDB_PS;
  extern __shared__ double smem_raw[];
  T* Dg = reinterpret_cast<T*>(smem_raw);  // diagonal block
  T* Pa = Dg + NB * DS;                     // NB x CH, [l * PS + r]
  T* Pb = Pa + NB * PS;
  __shared__ int bad;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t mm = size_t(m) * m;
  const T* Ab = A + size_t(blockIdx.x) * mm;
  T* L = work + 2 * size_t(blockIdx.x) * mm;   // workspace (count, 2, m, m)
  T* X = L + mm;
  T* O = out + size_t(blockIdx.x) * mm;
  if (tid == 0) bad = 0;
  for (size_t i = tid; i < mm; i += nt) {
    L[i] = Ab[i];
    X[i] = (i / m == i % m) ? T(1) : T(0);
    O[i] = T(0);
  }
  __syncthreads();

  // ---- 1. blocked Cholesky, lower triangle of L
  for (int k0 = 0; k0 < m; k0 += NB) {
    const int kb = min(NB, m - k0);
    load_diag<T, NB>(Dg, L, m, k0, kb);
    __syncthreads();
    for (int j = 0; j < kb; ++j) {
      if (tid == 0) {
        const T d = Dg[j * DS + j];
        if (!(d > T(0))) bad = 1;
        Dg[j * DS + j] = sqrt(d);
      }
      __syncthreads();
      const T piv = Dg[j * DS + j];
      for (int i = j + 1 + tid; i < kb; i += nt) Dg[i * DS + j] /= piv;
      __syncthreads();
      const int w = kb - j - 1;
      for (int idx = tid; idx < w * w; idx += nt) {
        const int i = j + 1 + idx / w, c = j + 1 + idx % w;
        if (c <= i) Dg[i * DS + c] -= Dg[i * DS + j] * Dg[c * DS + j];
      }
      __syncthreads();
    }
    if (bad) break;  // uniform: set before the last barrier
    for (int idx = tid; idx < kb * kb; idx += nt) {
      const int r = idx / kb, c = idx % kb;
      if (c <= r) L[size_t(k0 + r) * m + k0 + c] = Dg[r * DS + c];
    }
    // panel: L[i, k0:k0+kb] = A[i, k0:k0+kb] L_kk^-T, one thread per row
    const int r0 = k0 + kb, rows = m - r0;
    for (int c0 = 0; c0 < rows; c0 += CH) {
      const int ch = min(CH, rows - c0);
      load_rows(Pa, L, m, r0 + c0, ch, k0, kb);
      __syncthreads();
      for (int r = tid; r < ch; r += nt)
        for (int j = 0; j < kb; ++j) {
          T acc = Pa[j * PS + r];
          for (int l = 0; l < j; ++l) acc -= Pa[l * PS + r] * Dg[j * DS + l];
          Pa[j * PS + r] = acc / Dg[j * DS + j];
        }
      __syncthreads();
      for (int idx = tid; idx < ch * kb; idx += nt) {
        const int r = idx / kb, l = idx % kb;
        L[size_t(r0 + c0 + r) * m + k0 + l] = Pa[l * PS + r];
      }
      __syncthreads();
    }
    // trailing lower triangle: L[i][j] -= sum_l L[i][k0+l] L[j][k0+l]
    for (int ci = 0; ci < rows; ci += CH) {
      const int ni = min(CH, rows - ci);
      load_rows(Pa, L, m, r0 + ci, ni, k0, kb);
      for (int cj = 0; cj <= ci; cj += CH) {
        const int nj = min(CH, rows - cj);
        const T* Q = Pa;
        if (cj != ci) {
          load_rows(Pb, L, m, r0 + cj, nj, k0, kb);
          Q = Pb;
        }
        __syncthreads();
        for (int idx = tid; idx < ni * nj; idx += nt) {
          const int i = idx / nj, j = idx % nj;
          if (cj + j > ci + i) continue;
          T acc = 0;
#pragma unroll 8
          for (int l = 0; l < kb; ++l) acc += Pa[l * PS + i] * Q[l * PS + j];
          L[size_t(r0 + ci + i) * m + r0 + cj + j] -= acc;
        }
        __syncthreads();
      }
    }
  }

  if (!bad) {
    __syncthreads();  // the last diagonal block's write-back reads Dg
    // ---- 2. X = L^-1 (lower triangular; X starts as I)
    for (int k0 = 0; k0 < m; k0 += NB) {
      const int kb = min(NB, m - k0), nc = k0 + kb;
      load_diag<T, NB>(Dg, L, m, k0, kb);
      // block row k0: L_kk Y = X[k0:k0+kb, c], one thread per column c < nc
      for (int c0 = 0; c0 < nc; c0 += CH) {
        const int cols = min(CH, nc - c0);
        load_cols(Pa, X, m, k0, kb, c0, cols);
        __syncthreads();
        for (int c = tid; c < cols; c += nt)
          for (int r = 0; r < kb; ++r) {
            T acc = Pa[r * PS + c];
            for (int l = 0; l < r; ++l) acc -= Dg[r * DS + l] * Pa[l * PS + c];
            Pa[r * PS + c] = acc / Dg[r * DS + r];
          }
        __syncthreads();
        for (int idx = tid; idx < kb * cols; idx += nt) {
          const int l = idx / cols, c = idx % cols;
          X[size_t(k0 + l) * m + c0 + c] = Pa[l * PS + c];
        }
        __syncthreads();
      }
      // rows below: X[i][c] -= sum_l L[i][k0+l] X[k0+l][c], c < nc
      const int r0 = nc, rows = m - r0;
      for (int ci = 0; ci < rows; ci += CH) {
        const int ni = min(CH, rows - ci);
        load_rows(Pa, L, m, r0 + ci, ni, k0, kb);
        for (int cc = 0; cc < nc; cc += CH) {
          const int ncc = min(CH, nc - cc);
          load_cols(Pb, X, m, k0, kb, cc, ncc);
          __syncthreads();
          for (int idx = tid; idx < ni * ncc; idx += nt) {
            const int i = idx / ncc, c = idx % ncc;
            T acc = 0;
#pragma unroll 8
            for (int l = 0; l < kb; ++l) acc += Pa[l * PS + i] * Pb[l * PS + c];
            X[size_t(r0 + ci + i) * m + cc + c] -= acc;
          }
          __syncthreads();
        }
      }
    }

    // ---- 3. out = X^T X: O[i][j] += sum_l X[k0+l][i] X[k0+l][j], i >= j
    for (int k0 = 0; k0 < m; k0 += NB) {
      const int kb = min(NB, m - k0), nc = k0 + kb;  // X[k][c] = 0 for c > k
      for (int ci = 0; ci < nc; ci += CH) {
        const int ni = min(CH, nc - ci);
        load_cols(Pa, X, m, k0, kb, ci, ni);
        for (int cj = 0; cj <= ci; cj += CH) {
          const int nj = min(CH, nc - cj);
          const T* Q = Pa;
          if (cj != ci) {
            load_cols(Pb, X, m, k0, kb, cj, nj);
            Q = Pb;
          }
          __syncthreads();
          for (int idx = tid; idx < ni * nj; idx += nt) {
            const int i = idx / nj, j = idx % nj;
            if (cj + j > ci + i) continue;
            T acc = 0;
#pragma unroll 8
            for (int l = 0; l < kb; ++l) acc += Pa[l * PS + i] * Q[l * PS + j];
            O[size_t(ci + i) * m + cj + j] += acc;
          }
          __syncthreads();
        }
      }
    }
    for (size_t idx = tid; idx < mm; idx += nt) {
      const size_t i = idx / m, j = idx % m;
      if (j > i) O[idx] = O[j * m + i];
    }
  } else {
    const T q = spdb_nan(T(0));
    for (size_t i = tid; i < mm; i += nt) O[i] = q;
  }
}

template <typename T>
static int launch_spd_inv_blocked(void** p, long long count, int m, cudaStream_t st) {
  if (m < 1) return VMP_BAD_ARGS;
  const size_t smem = spdb_smem<T>();
  cudaError_t e = vmp_allow_smem(spd_inv_blocked_kernel<T>, smem);
  if (e != cudaSuccess) return int(e);
  if (count == 0) return 0;
  VMP_LAUNCH(spd_inv_blocked_kernel<T>, unsigned(count), SPDB_THREADS, smem, st)(
      (const T*)p[0], (T*)p[1], (T*)p[2], m);
  return int(cudaGetLastError());
}

// ptrs: A (count, m, m), work (count, 2, m, m), out (count, m, m)
// ints: dtype, count, m
VMP_ENTRY(spd_inv_blocked) {
  if (nptr != 3 || nint != 3 || nreal != 0) return VMP_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ints[0] == 0) return launch_spd_inv_blocked<float>(ptrs, ints[1], int(ints[2]), st);
  if (ints[0] == 1) return launch_spd_inv_blocked<double>(ptrs, ints[1], int(ints[2]), st);
  return VMP_BAD_DTYPE;
}
