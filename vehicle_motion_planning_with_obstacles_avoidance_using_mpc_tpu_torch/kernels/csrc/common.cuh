// Shared layout, argument unpacking and block reductions for the OBCA
// solver's kernels. Every kernel library exports C functions of one
// signature (see VMP_ENTRY below), called through ctypes from
// kernels/__init__.py, which checks device, dtype, shape and contiguity
// before it passes the pointers.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

// ---------------------------------------------------------------- layout
// Problem dimensions of the OBCA NLP: flat z = [T] lam(K, E) mu(K, 4)
// u(2, N) x(3, N+1), K = n_k * nO blocks. The row counts come from the
// layout (models/obca_struct.py make_layout) through the entry point's
// ints; the kernels read the variant from them: T is present when
// off_u = 1 (free time); the equality rows after the 3N dynamics and 3
// initial rows are the terminal rows x_N = xref_N (free: 3; fix_eq_band:
// x and y, 2); the dense inequality rows after the 4N acceleration rows
// are the terminal-set rows x_N - ts00, y_N - ts10, ts11 - y_N
// (fix_terminal, 3) or the heading band theta_band -/+ (theta_N -
// thetaref_N) (fix_eq_band, 2). S = 4 spine slots a block (x, y, theta,
// T) is coupled motion (free time only): the obstacles' offsets move with
// T, which the row counts cannot tell.
struct Dims {
  int N, nO, E, k_lo;
  bool free;
  int off_u, n_k, K, bq, base_u, base_x, n, np_;
  int mE_sp, mD_sp, mE, mD, m_id, mI;
  int S;              // spine slots a block: 3, or 4 under coupled motion
  bool band;          // fix_eq_band: the dense terminal rows are the heading band
  double theta_band;  // its half width (OBCASpec.theta_band)
};

// ints[2..11] of every OBCA entry point (kernels._dims): N, nO, E, k_lo,
// then the layout's off_u, mE_sp, mD_sp, m_id, then S and the bits of
// theta_band (a float64). The entry's own ints follow from VMP_DIMS_END.
// False for row counts of no variant, or S = 4 without free time.
#define VMP_DIMS_END 12

inline bool dims_from(const long long* ints, Dims& d) {
  d.N = int(ints[2]); d.nO = int(ints[3]); d.E = int(ints[4]); d.k_lo = int(ints[5]);
  d.off_u = int(ints[6]); d.mE_sp = int(ints[7]); d.mD_sp = int(ints[8]); d.m_id = int(ints[9]);
  d.S = int(ints[10]);
  const long long tb = ints[11];
  memcpy(&d.theta_band, &tb, sizeof(double));
  const int N = d.N, tE = d.mE_sp - 3 * N - 3, tD = d.mD_sp - 4 * N;
  // free (3, 0), fix_terminal (0, 3), fix_free_end (0, 0), fix_eq_band (2, 2)
  const bool rows_ok = d.off_u == 1 ? tE == 3 && tD == 0
                       : d.off_u == 0 && ((tE == 0 && (tD == 0 || tD == 3)) || (tE == 2 && tD == 2));
  if (!rows_ok || !(d.S == 3 || (d.S == 4 && d.off_u == 1))) return false;
  d.band = tD == 2;
  d.free = d.off_u == 1;  // free time: T is flat index 0 and spine position 0
  d.n_k = N + 1 - d.k_lo;
  d.K = d.n_k * d.nO;
  d.bq = d.E + 4;
  d.base_u = d.off_u + d.K * d.bq;
  d.base_x = d.base_u + 2 * N;
  d.n = d.base_x + 3 * (N + 1);
  d.np_ = d.off_u + 2 * N + 3 * (N + 1);
  d.mE = d.mE_sp + 2 * d.K;
  d.mD = d.mD_sp + 2 * d.K;
  d.mI = d.m_id + d.mD;
  return true;
}

// spine positions and flat indices
__host__ __device__ inline int upos(const Dims& D, int i, int t) { return D.off_u + i * D.N + t; }
__host__ __device__ inline int xpos(const Dims& D, int i, int t) { return D.off_u + 2 * D.N + i * (D.N + 1) + t; }
__host__ __device__ inline int p_flat(const Dims& D, int p) { return p < D.off_u ? p : p + D.K * D.bq; }
__host__ __device__ inline int q_flat(const Dims& D, int kb, int b) {
  return D.off_u + (b < D.E ? kb * D.E + b : D.K * D.E + kb * 4 + (b - D.E));
}
// spine position of slot s (x, y, theta, T) of block kb: T is position 0
__host__ __device__ inline int slot_pos(const Dims& D, int s, int kb) {
  return s < 3 ? xpos(D, s, D.k_lo + kb / D.nO) : 0;
}
// decode a spine position into (slot s, step t) when it is a state;
// returns false for T and u positions
__host__ __device__ inline bool pos_slot(const Dims& D, int p, int& s, int& t) {
  int r = p - D.off_u - 2 * D.N;
  if (r < 0) return false;
  s = r / (D.N + 1);
  t = r % (D.N + 1);
  return true;
}

// Offsets of the packed per-lane data (kernels.pack_obca_data): the
// OBCAData fields in declaration order, each flattened.
struct DataOff {
  int x0, u0, xref, A, b, edge_mask, obs_mask, x_lo, x_hi, u_lo, u_hi, Q, R1, R2, P,
      Ts, dmin, ego_g, ego_offset, terminal_set, T_max, a_max, alpha_max, time_c1,
      time_c2, T_lo, obs_vel, total;
};

__host__ __device__ inline DataOff make_data_off(const Dims& D) {
  DataOff o;
  int c = 0;
  const int N1 = D.N + 1;
  o.x0 = c; c += 3;
  o.u0 = c; c += 2;
  o.xref = c; c += 3 * N1;
  o.A = c; c += N1 * D.nO * D.E * 2;
  o.b = c; c += N1 * D.nO * D.E;
  o.edge_mask = c; c += D.nO * D.E;
  o.obs_mask = c; c += D.nO;
  o.x_lo = c; c += 2;
  o.x_hi = c; c += 2;
  o.u_lo = c; c += 2;
  o.u_hi = c; c += 2;
  o.Q = c; c += 9;
  o.R1 = c; c += 4;
  o.R2 = c; c += 4;
  o.P = c; c += 9;
  o.Ts = c; c += 1;
  o.dmin = c; c += 1;
  o.ego_g = c; c += 4;
  o.ego_offset = c; c += 1;
  o.terminal_set = c; c += 4;
  o.T_max = c; c += 1;
  o.a_max = c; c += 1;
  o.alpha_max = c; c += 1;
  o.time_c1 = c; c += 1;
  o.time_c2 = c; c += 1;
  o.T_lo = c; c += 1;
  o.obs_vel = c; c += D.nO * 2;
  o.total = c;
  return o;
}

// ------------------------------------------------------------ reductions
// NaN-propagating min/max (jnp.min/max and torch.amin/amax semantics;
// fminf/fmaxf would drop a NaN).
template <typename T>
__device__ inline T nan_min(T a, T b) { return (a != a) ? a : ((b != b) ? b : (b < a ? b : a)); }
template <typename T>
__device__ inline T nan_max(T a, T b) { return (a != a) ? a : ((b != b) ? b : (b > a ? b : a)); }

struct SumOp { template <typename T> __device__ T operator()(T a, T b) const { return a + b; } };
struct MinOp { template <typename T> __device__ T operator()(T a, T b) const { return nan_min(a, b); } };
struct MaxOp { template <typename T> __device__ T operator()(T a, T b) const { return nan_max(a, b); } };

// Sum over a warp; every lane gets the result.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Reduce one value per thread over the block; every thread gets the
// result. blockDim.x must be a multiple of 32; scratch holds >= 32 T.
template <typename T, typename Op>
__device__ T block_reduce(T v, Op op, T* scratch) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[w] = v;
  __syncthreads();
  T r = scratch[0];
  for (int i = 1; i < nw; ++i) r = op(r, scratch[i]);
  __syncthreads();
  return r;
}

// Kernel launch, as a macro so that every launch site reads the same:
//   VMP_LAUNCH(kernel, grid, block, smem_bytes, stream)(args...)
#ifndef VMP_LAUNCH
#define VMP_LAUNCH(kernel, grid, block, smem, stream) kernel<<<grid, block, smem, stream>>>
#endif

// --------------------------------------------------------- C entry point
// All libraries export functions of this signature:
//   ptrs  — device pointers, in the order the wrapper documents
//   ints  — ints[0] is the dtype (0 float32, 1 float64), ints[1] the batch,
//           then sizes (for the OBCA kernels ints[2..11], see dims_from)
//   reals — scalar options
// The return value is 0, a cudaError_t from the launch, or one of the
// argument codes below.
#define VMP_ENTRY(name)                                                        \
  extern "C" int name(void** ptrs, int nptr, const long long* ints, int nint, \
                      const double* reals, int nreal, void* stream)

enum { VMP_BAD_ARGS = 10001, VMP_BAD_DTYPE = 10002, VMP_TOO_LARGE = 10003 };

// One definition per library: each .cu is built into its own .so.
extern "C" const char* vmp_error_string(int code) {
  switch (code) {
    case VMP_BAD_ARGS: return "wrong number of kernel arguments";
    case VMP_BAD_DTYPE: return "unsupported dtype";
    case VMP_TOO_LARGE: return "problem size above what the kernel supports";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

// Set the dynamic shared memory a kernel may use above the 48 KB default.
template <typename K>
inline cudaError_t vmp_allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Shared memory a block may use on this card (227 KB of the SM's 256 KB).
#define VMP_SMEM_MAX (227 * 1024)

// Bump allocator (8-byte aligned) over a block's arena: the dynamic
// shared memory, or the block's slice of a device workspace.
struct SmemArena {
  char* base;
  size_t off;
  __device__ explicit SmemArena(void* p) : base(static_cast<char*>(p)), off(0) {}
  template <typename T>
  __device__ T* take(int count) {
    T* p = reinterpret_cast<T*>(base + off);
    off += ((static_cast<size_t>(count) * sizeof(T) + 7) / 8) * 8;
    return p;
  }
};

// A kernel whose per-block arrays outgrow shared memory keeps them in a
// device workspace instead: the wrapper (kernels.arena_in_device_memory)
// picks the storage from the same byte count, passes it as two ints
// (in device memory 0/1, bytes per block) and the workspace pointer, and
// the same code runs over either base.
struct ArenaPlace {
  char* work;    // nullptr: dynamic shared memory
  size_t bytes;  // per block
  __device__ void* base(void* smem) const {
    return work ? static_cast<void*>(work + size_t(blockIdx.x) * bytes) : smem;
  }
};

// The place of an arena of ``bytes`` per block from the wrapper's two
// ints; 0, VMP_BAD_ARGS when its byte count disagrees or the workspace is
// missing, VMP_TOO_LARGE when a shared-memory arena would not fit.
inline int arena_from(const long long* ints, void* work, size_t bytes, ArenaPlace& a,
                      size_t& smem) {
  const bool in_device = ints[0] != 0;
  if (size_t(ints[1]) != bytes || (in_device && work == nullptr)) return VMP_BAD_ARGS;
  if (!in_device && bytes > VMP_SMEM_MAX) return VMP_TOO_LARGE;
  a.work = in_device ? static_cast<char*>(work) : nullptr;
  a.bytes = bytes;
  smem = in_device ? 0 : bytes;
  return 0;
}

