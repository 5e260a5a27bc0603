// spd_inv: batched inverse of symmetric positive definite matrices,
// NaN wherever a matrix is not SPD.
//
// Replaces: the JAX package's solver/ipm.py _chol_inv_small (:261-302, the
// (K, 8, 8) dual blocks) and _spd_inv (:317-356, the spine Schur
// complement). The JAX code runs an unrolled Cholesky batch-minor for
// TPU lanes and a recursive 2x2 block-Schur inverse to dodge the TPU's
// serial Cholesky custom call; SPD(A) <=> SPD(A11) and SPD(Schur), so a
// direct Cholesky here keeps the same NaN-on-non-SPD rejection signal.
// Bound on this card: latency of the sequential column loop; the matrices
// are tiny (8x8 and 54x54 at demo9 N = 10) and the batch is 15360 and
// 256 matrices, so the card is filled by CTAs, not by one matrix's work.
// Design: one CTA per matrix, the matrix in shared memory; a right-looking
// Cholesky (one synchronisation per column), then one thread per column
// of the identity runs forward substitution for L^-1, then threads over
// entries form L^-T L^-1. IEEE sqrt and division (no fast math): a
// non-positive pivot gives NaN or inf, which propagates to every entry.
// Supports m <= 120 (two m x m float64 arrays in 227 KB of shared memory).
#include "common.cuh"

#define SPD_MAX_M 120

template <typename T>
__global__ void spd_inv_kernel(const T* __restrict__ A, T* __restrict__ out, int m) {
  extern __shared__ double smem_raw[];
  T* L = reinterpret_cast<T*>(smem_raw);   // m x m, lower triangle used
  T* X = L + m * m;                         // L^-1, lower triangle used
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t base = size_t(blockIdx.x) * m * m;
  for (int i = tid; i < m * m; i += nt) L[i] = A[base + i];
  __syncthreads();

  for (int j = 0; j < m; ++j) {
    if (tid == 0) L[j * m + j] = sqrt(L[j * m + j]);
    __syncthreads();
    const T piv = L[j * m + j];
    for (int i = j + 1 + tid; i < m; i += nt) L[i * m + j] /= piv;
    __syncthreads();
    // trailing update of the lower triangle: L[i][k] -= L[i][j] L[k][j]
    const int w = m - j - 1;
    for (int idx = tid; idx < w * w; idx += nt) {
      const int i = j + 1 + idx / w, k = j + 1 + idx % w;
      if (k <= i) L[i * m + k] -= L[i * m + j] * L[k * m + j];
    }
    __syncthreads();
  }

  // X = L^-1 column by column (forward substitution on e_c)
  for (int c = tid; c < m; c += nt) {
    for (int i = 0; i < m; ++i) {
      if (i < c) { X[i * m + c] = T(0); continue; }
      T acc = (i == c) ? T(1) : T(0);
      for (int k = c; k < i; ++k) acc -= L[i * m + k] * X[k * m + c];
      X[i * m + c] = acc / L[i * m + i];
    }
  }
  __syncthreads();

  // inv[i][j] = sum_k X[k][i] X[k][j], k >= max(i, j)
  for (int idx = tid; idx < m * m; idx += nt) {
    const int i = idx / m, j = idx % m;
    T acc = 0;
    for (int k = (i > j ? i : j); k < m; ++k) acc += X[k * m + i] * X[k * m + j];
    out[base + idx] = acc;
  }
}

template <typename T>
static int launch_spd_inv(void** p, long long count, int m, cudaStream_t st) {
  if (m < 1 || m > SPD_MAX_M) return VMP_TOO_LARGE;
  const size_t smem = 2 * size_t(m) * m * sizeof(T);
  cudaError_t e = vmp_allow_smem(spd_inv_kernel<T>, smem);
  if (e != cudaSuccess) return int(e);
  if (count == 0) return 0;
  const int threads = m <= 16 ? 64 : 256;
  VMP_LAUNCH(spd_inv_kernel<T>, unsigned(count), threads, smem, st)((const T*)p[0], (T*)p[1], m);
  return int(cudaGetLastError());
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

extern "C" int spd_inv_max_m() { return SPD_MAX_M; }
