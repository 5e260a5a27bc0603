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
// batch is small (the open loop's 5 candidates x 2 rungs: 10 matrices), so
// one CTA a matrix would leave 122 of 132 SMs idle and its time would be
// the latency of one CTA's chain of column steps.
// Design: a fixed sequence of launches on the caller's stream (no host
// sync, no allocation: safe inside a captured CUDA graph) over a device
// workspace per matrix (SpdbWork: L, X = L^-1, the inverse diagonal
// blocks, a flag; 2.3 MB at m = 374 in float64, so it stays in L2), each
// matrix spread over many CTAs:
//   per panel of SPDB_NB = 32 columns at k0:
//     spdb_panel  a CTA per (matrix, 64-row chunk of rows k0..m-1): one
//                 warp factors the 32 x 32 diagonal block in shared
//                 memory (a lane a row, three __syncwarp a column) and
//                 inverts it (a lane a column), in every CTA (~11k FMAs)
//                 rather than in a launch of its own; each CTA then forms
//                 its rows of the panel as a product, L[i, k0:k0+32] =
//                 A[i, k0:k0+32] inv(L_kk)^T; chunk 0 keeps inv(L_kk)
//                 and the flag;
//     spdb_syrk   a CTA per (matrix, lower-triangular 64 x 64 tile of the
//                 trailing matrix): L[I, J] -= P_I P_J^T over the panel P,
//                 a 4 x 4 register block a thread from the two 64 x 32
//                 panel slices in shared memory (210 CTAs for the first
//                 panel at m = 374 x 10);
//   spdb_trtri    a CTA per (matrix, 32-column block cb): down the block
//                 rows, X[cb, cb] = inv(L_cb,cb) and X[r, cb] = -inv(L_rr)
//                 sum_{cb <= t < r} L[r, t] X[t, cb], the 32 x 32 tiles
//                 streamed from the workspace (the next pair loaded while
//                 the current one is multiplied);
//   spdb_lauum    a CTA per (matrix, lower-triangular 64 x 64 tile of the
//                 output): out[I, J] = sum_k X[k, I] X[k, J] from I's first
//                 row on (X is lower triangular; its upper triangle, never
//                 written, reads as 0), written with its mirror through
//                 shared memory.
// That is 2 npan + 1 launches (npan = ceil(m / 32); 25 at m = 374: no
// update follows the last panel), kernels.spdb_launch_plan in Python. A
// pivot that is not > 0 (or NaN) sets the matrix's flag (reset by the
// first panel launch); the later updates and the inverse skip that matrix
// and spdb_lauum writes NaN over all of it, as the plain version
// (cholesky_ex's info > 0) and the JAX package's cholesky do; the
// regularisation ladder reads that as a rejected rung. Arithmetic in the
// tensor's own precision (FMA; never TF32), IEEE sqrt and division (no
// fast math).
#include "common.cuh"

#define SPDB_NB 32        // panel width: one warp's lanes
#define SPDB_TILE 64      // panel row chunks; update and product tiles
#define SPDB_THREADS 256
#define SPDB_FULL 0xffffffffu

__host__ __device__ inline int spdb_cdiv(int a, int b) { return (a + b - 1) / b; }

// Workspace elements per matrix (kernels.spdb_workspace_elems).
__host__ __device__ inline size_t spdb_elems(int m) {
  return 2 * size_t(m) * m + size_t(spdb_cdiv(m, SPDB_NB)) * SPDB_NB * SPDB_NB + 1;
}

// One matrix's workspace: L and X (m x m, row-major; of L the panels
// below the diagonal blocks, of X the lower block triangle), each panel's
// inv(L_kk) (SPDB_NB x SPDB_NB, identity past the order) and the flag (an
// int in the last element).
template <typename T>
struct SpdbWork {
  T *L, *X, *Dinv;
  int* flag;
  __device__ SpdbWork(T* work, int mat, int m) {
    const size_t mm = size_t(m) * m;
    L = work + size_t(mat) * spdb_elems(m);
    X = L + mm;
    Dinv = X + mm;
    flag = reinterpret_cast<int*>(Dinv + size_t(spdb_cdiv(m, SPDB_NB)) * SPDB_NB * SPDB_NB);
  }
};

// (I, J), I >= J, of lower-triangular tile t (row by row)
__device__ inline void spdb_tile(int t, int& I, int& J) {
  I = 0;
  while ((I + 1) * (I + 2) / 2 <= t) ++I;
  J = t - I * (I + 1) / 2;
}

__device__ inline float spdb_nan(float) { return nanf(""); }
__device__ inline double spdb_nan(double) { return nan(""); }

// ------------------------------------------------------------ the panel
template <typename T>
__global__ void __launch_bounds__(SPDB_THREADS) spdb_panel_kernel(const T* __restrict__ A,
                                                                  T* __restrict__ work, int m,
                                                                  int k0, int nchunk) {
  constexpr int NB = SPDB_NB, CH = SPDB_TILE, LD = NB + 1;
  __shared__ T D[NB * LD];    // the updated diagonal block (identity past the order), then L_kk
  __shared__ T Di[NB * LD];   // inv(L_kk)
  __shared__ T Pc[CH * LD];   // the chunk's rows of the panel columns, [row][l]
  __shared__ int bad_s;
  const int mat = blockIdx.x / nchunk, chunk = blockIdx.x % nchunk, tid = threadIdx.x;
  const int kb = min(NB, m - k0), row0 = k0 + chunk * CH;
  SpdbWork<T> w(work, mat, m);
  const T* src = k0 == 0 ? A + size_t(mat) * m * m : w.L;
  for (int idx = tid; idx < NB * NB; idx += blockDim.x) {
    const int r = idx / NB, c = idx % NB;
    D[r * LD + c] = (r < kb && c < kb) ? (c <= r ? src[size_t(k0 + r) * m + k0 + c] : T(0))
                                       : T(r == c ? 1 : 0);
  }
  for (int idx = tid; idx < CH * NB; idx += blockDim.x) {
    const int r = idx / NB, l = idx % NB, i = row0 + r;
    Pc[r * LD + l] = (i >= k0 + kb && i < m && l < kb) ? src[size_t(i) * m + k0 + l] : T(0);
  }
  __syncthreads();
  if (tid < 32) {   // warp 0 factors the block in shared memory, lane = row
    const int lane = tid;
    bool bad = false;
    for (int j = 0; j < NB; ++j) {   // right-looking: pivot, column, update
      const T djj = D[j * LD + j];
      bad |= !(djj > T(0));
      const T piv = sqrt(djj);
      __syncwarp();   // every lane has read the pivot before lane j rewrites it
      const T lij = lane > j ? D[lane * LD + j] / piv : (lane == j ? piv : T(0));
      D[lane * LD + j] = lij;
      __syncwarp();
      for (int c = j + 1; c <= lane; ++c) D[lane * LD + c] -= lij * D[c * LD + j];
      __syncwarp();
    }
    // inv(L_kk), lane = column: forward substitution of the unit vector
    for (int r = 0; r < NB; ++r) {
      T acc = T(r == lane ? 1 : 0);
      for (int l = lane; l < r; ++l) acc -= D[r * LD + l] * Di[l * LD + lane];
      Di[r * LD + lane] = r < lane ? T(0) : acc / D[r * LD + r];
    }
    bad = __any_sync(SPDB_FULL, bad);
    if (lane == 0) bad_s = bad;
  }
  __syncthreads();
  if (chunk == 0) {
    // only inv(L_kk) is kept: no later step reads L_kk, and the other
    // chunks of this launch still read the block it would overwrite
    T* Dk = w.Dinv + size_t(k0 / NB) * NB * NB;
    for (int idx = tid; idx < NB * NB; idx += blockDim.x) Dk[idx] = Di[(idx / NB) * LD + idx % NB];
    if (tid == 0 && (k0 == 0 || bad_s)) *w.flag = bad_s;
  }
  // L[i, k0 + c] = sum_l A[i, k0 + l] inv(L_kk)[c, l]: 8 columns a thread
  const int r = tid >> 2, cq = tid & 3, i = row0 + r;
  T acc[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) acc[q] = T(0);
#pragma unroll 8
  for (int l = 0; l < NB; ++l) {
    const T x = Pc[r * LD + l];
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[q] += x * Di[(cq + 4 * q) * LD + l];
  }
  if (i >= k0 + kb && i < m) {
#pragma unroll
    for (int q = 0; q < 8; ++q) w.L[size_t(i) * m + k0 + cq + 4 * q] = acc[q];
  }
}

// ------------------------------------------------ the trailing update
template <typename T>
__global__ void __launch_bounds__(SPDB_THREADS) spdb_syrk_kernel(const T* __restrict__ A,
                                                                 T* __restrict__ work, int m,
                                                                 int k0, int nt) {
  constexpr int NB = SPDB_NB, TL = SPDB_TILE, LD = TL + 1;
  __shared__ T Pi[NB * LD];   // panel rows of tile row I, [l][row]
  __shared__ T Pj[NB * LD];   // of tile column J
  const int ntri = nt * (nt + 1) / 2, mat = blockIdx.x / ntri, tid = threadIdx.x;
  int I, J;
  spdb_tile(blockIdx.x % ntri, I, J);
  SpdbWork<T> w(work, mat, m);
  if (*w.flag) return;   // not SPD: nothing downstream is read
  const T* src = k0 == 0 ? A + size_t(mat) * m * m : w.L;
  const int r0 = k0 + NB, i0 = r0 + I * TL, j0 = r0 + J * TL;
  for (int idx = tid; idx < TL * NB; idx += blockDim.x) {
    const int r = idx / NB, l = idx % NB;
    Pi[l * LD + r] = i0 + r < m ? w.L[size_t(i0 + r) * m + k0 + l] : T(0);
    if (I != J) Pj[l * LD + r] = j0 + r < m ? w.L[size_t(j0 + r) * m + k0 + l] : T(0);
  }
  __syncthreads();
  const T* Q = I == J ? Pi : Pj;
  const int tx = tid & 15, ty = tid >> 4;
  T acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = T(0);
#pragma unroll 8
  for (int l = 0; l < NB; ++l) {
    T a[4], b[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      a[u] = Pi[l * LD + ty + 16 * u];
      b[u] = Q[l * LD + tx + 16 * u];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] += a[u] * b[v];
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int gi = i0 + ty + 16 * u;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int gj = j0 + tx + 16 * v;
      if (gi < m && gj <= gi) w.L[size_t(gi) * m + gj] = src[size_t(gi) * m + gj] - acc[u][v];
    }
  }
}

// ---------------------------------------------------- X = L^-1 by blocks
template <typename T>
__global__ void __launch_bounds__(SPDB_THREADS) spdb_trtri_kernel(T* __restrict__ work, int m,
                                                                  int npan) {
  constexpr int NB = SPDB_NB, LD = NB + 1;
  __shared__ T Ls[NB * LD];   // L[r, t], [k][row]
  __shared__ T Xs[NB * LD];   // X[t, cb], [k][col]
  __shared__ T Ys[NB * LD];   // -sum_t L[r, t] X[t, cb], [row][col]
  __shared__ T Ds[NB * LD];   // inv(L_rr), [row][k]
  const int mat = blockIdx.x / npan, cb = blockIdx.x % npan, tid = threadIdx.x;
  SpdbWork<T> w(work, mat, m);
  if (*w.flag) return;
  const int tx = tid & 15, ty = tid >> 4;
  const int c0 = cb * NB, cw = min(NB, m - c0);
  const T* Dcb = w.Dinv + size_t(cb) * NB * NB;
  for (int idx = tid; idx < NB * NB; idx += blockDim.x) {
    const int r = idx / NB, c = idx % NB;
    if (r < cw && c < cw) w.X[size_t(c0 + r) * m + c0 + c] = Dcb[idx];
  }
  __syncthreads();   // X[cb, cb] is read below
  for (int r = cb + 1; r < npan; ++r) {
    const int q0 = r * NB, rw = min(NB, m - q0);
    T lr[4], xr[4];
    // tile pair t: 4 entries a thread of L[r, t] and of X[t, cb] (t < r:
    // a full block)
    auto load = [&](int t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = tid + e * SPDB_THREADS, a = idx / NB, b = idx % NB;
        lr[e] = a < rw ? w.L[size_t(q0 + a) * m + t * NB + b] : T(0);
        xr[e] = b < cw ? w.X[size_t(t * NB + a) * m + c0 + b] : T(0);
      }
    };
    T acc[2][2] = {{T(0), T(0)}, {T(0), T(0)}};
    load(cb);
    for (int t = cb; t < r; ++t) {
      __syncthreads();   // the last pair's readers are done
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = tid + e * SPDB_THREADS, a = idx / NB, b = idx % NB;
        Ls[b * LD + a] = lr[e];
        Xs[a * LD + b] = xr[e];
      }
      __syncthreads();
      if (t + 1 < r) load(t + 1);
#pragma unroll 8
      for (int k = 0; k < NB; ++k) {
        const T l0 = Ls[k * LD + ty], l1 = Ls[k * LD + ty + 16];
        const T x0 = Xs[k * LD + tx], x1 = Xs[k * LD + tx + 16];
        acc[0][0] += l0 * x0;
        acc[0][1] += l0 * x1;
        acc[1][0] += l1 * x0;
        acc[1][1] += l1 * x1;
      }
    }
    const T* Dr = w.Dinv + size_t(r) * NB * NB;
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 2; ++v) Ys[(ty + 16 * u) * LD + tx + 16 * v] = -acc[u][v];
    for (int idx = tid; idx < NB * NB; idx += blockDim.x) Ds[(idx / NB) * LD + idx % NB] = Dr[idx];
    __syncthreads();
    T o[2][2] = {{T(0), T(0)}, {T(0), T(0)}};
#pragma unroll 8
    for (int k = 0; k < NB; ++k) {
      const T d0 = Ds[ty * LD + k], d1 = Ds[(ty + 16) * LD + k];
      const T y0 = Ys[k * LD + tx], y1 = Ys[k * LD + tx + 16];
      o[0][0] += d0 * y0;
      o[0][1] += d0 * y1;
      o[1][0] += d1 * y0;
      o[1][1] += d1 * y1;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int a = ty + 16 * u, b = tx + 16 * v;
        if (a < rw && b < cw) w.X[size_t(q0 + a) * m + c0 + b] = o[u][v];
      }
    // the next block row's first barrier orders these writes before its
    // reads of X[r, cb] and the reuse of Ys and Ds
  }
}

// ------------------------------------------------------- out = X^T X
template <typename T>
__global__ void __launch_bounds__(SPDB_THREADS) spdb_lauum_kernel(T* __restrict__ work,
                                                                  T* __restrict__ out, int m,
                                                                  int nt) {
  constexpr int NB = SPDB_NB, TL = SPDB_TILE, LD = TL + 1, PER = NB * TL / SPDB_THREADS;
  __shared__ T S[2 * NB * LD];   // X rows k of I's and J's columns, [k][col];
                                 // then the (TL x TL) tile, [row][col]
  T* Xi = S;
  T* Xj = S + NB * LD;
  const int ntri = nt * (nt + 1) / 2, mat = blockIdx.x / ntri, tid = threadIdx.x;
  int I, J;
  spdb_tile(blockIdx.x % ntri, I, J);
  SpdbWork<T> w(work, mat, m);
  T* O = out + size_t(mat) * m * m;
  const int i0 = I * TL, j0 = J * TL;
  if (*w.flag) {   // not SPD: NaN over the whole matrix
    const T q = spdb_nan(T(0));
    for (int idx = tid; idx < TL * TL; idx += blockDim.x) {
      const int a = i0 + idx / TL, b = j0 + idx % TL;
      if (a < m && b < m) O[size_t(a) * m + b] = q;
      const int a2 = j0 + idx / TL, b2 = i0 + idx % TL;
      if (a2 < m && b2 < m) O[size_t(a2) * m + b2] = q;
    }
    return;
  }
  const int tx = tid & 15, ty = tid >> 4;
  T xi[PER], xj[PER];
  // rows kk..kk+NB of X in I's and J's columns, 0 above the diagonal
  auto load = [&](int kk) {
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int idx = tid + e * SPDB_THREADS, k = kk + idx / TL, c = idx % TL;
      xi[e] = (k < m && i0 + c <= k) ? w.X[size_t(k) * m + i0 + c] : T(0);
      if (I != J) xj[e] = (k < m && j0 + c <= k) ? w.X[size_t(k) * m + j0 + c] : T(0);
    }
  };
  T acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = T(0);
  const T* Q = I == J ? Xi : Xj;
  load(i0);
  for (int kk = i0; kk < m; kk += NB) {
    __syncthreads();
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int idx = tid + e * SPDB_THREADS, k = idx / TL, c = idx % TL;
      Xi[k * LD + c] = xi[e];
      if (I != J) Xj[k * LD + c] = xj[e];
    }
    __syncthreads();
    if (kk + NB < m) load(kk + NB);
#pragma unroll 8
    for (int k = 0; k < NB; ++k) {
      T a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[u] = Xi[k * LD + ty + 16 * u];
        b[u] = Q[k * LD + tx + 16 * u];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] += a[u] * b[v];
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) S[(ty + 16 * u) * LD + tx + 16 * v] = acc[u][v];
  __syncthreads();
  for (int idx = tid; idx < TL * TL; idx += blockDim.x) {
    const int a = idx / TL, b = idx % TL;
    if (i0 + a < m && j0 + b < m) O[size_t(i0 + a) * m + j0 + b] = S[a * LD + b];
    if (I != J && j0 + a < m && i0 + b < m) O[size_t(j0 + a) * m + i0 + b] = S[b * LD + a];
  }
}

// ------------------------------------------------------------ launcher
template <typename T>
static int launch_spd_inv_blocked(void** p, long long count, int m, cudaStream_t st) {
  if (m < 1 || count < 0) return VMP_BAD_ARGS;
  if (count == 0) return 0;
  const T* A = (const T*)p[0];
  T* work = (T*)p[1];
  T* out = (T*)p[2];
  const int TL = SPDB_TILE;
  cudaError_t e;
  for (int k0 = 0; k0 < m; k0 += SPDB_NB) {
    const int nchunk = spdb_cdiv(m - k0, TL);
    VMP_LAUNCH(spdb_panel_kernel<T>, unsigned(count * nchunk), SPDB_THREADS, 0, st)(
        A, work, m, k0, nchunk);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
    const int rest = m - k0 - SPDB_NB;
    if (rest <= 0) continue;
    const int nt = spdb_cdiv(rest, TL);
    VMP_LAUNCH(spdb_syrk_kernel<T>, unsigned(count * (nt * (nt + 1) / 2)), SPDB_THREADS, 0, st)(
        A, work, m, k0, nt);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  const int npan = spdb_cdiv(m, SPDB_NB), nt = spdb_cdiv(m, TL);
  VMP_LAUNCH(spdb_trtri_kernel<T>, unsigned(count * npan), SPDB_THREADS, 0, st)(work, m, npan);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  VMP_LAUNCH(spdb_lauum_kernel<T>, unsigned(count * (nt * (nt + 1) / 2)), SPDB_THREADS, 0, st)(
      work, out, m, nt);
  return int(cudaGetLastError());
}

// ptrs: A (count, m, m), work (count x kernels.spdb_workspace_elems(m)),
//       out (count, m, m)
// ints: dtype, count, m
VMP_ENTRY(spd_inv_blocked) {
  if (nptr != 3 || nint != 3 || nreal != 0) return VMP_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ints[0] == 0) return launch_spd_inv_blocked<float>(ptrs, ints[1], int(ints[2]), st);
  if (ints[0] == 1) return launch_spd_inv_blocked<double>(ptrs, ints[1], int(ints[2]), st);
  return VMP_BAD_DTYPE;
}
