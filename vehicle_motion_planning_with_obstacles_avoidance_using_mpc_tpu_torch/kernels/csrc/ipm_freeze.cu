// ipm_freeze: the loop step of the Newton iteration's while_loop, one
// launch per iteration.
//
// Replaces: the JAX package's solver/ipm.py iterate_fn (:1369-1380), a
// lax.while_loop over the Newton body whose vmapped form keeps a finished
// lane's state unchanged and whose condition (it < cap) & ~done is tested
// on the device. The port replays the body as a captured CUDA graph; this
// kernel closes each replay: for every lane that was active it copies the
// body's new state over the loop's state buffers (in place), then it
// writes the lane's next active flag, (it < cap) & ~done of the state it
// leaves, and raises the loop's device flag when any lane stays active.
// The cap is read from device memory, so one captured graph serves every
// chunk boundary, as JAX's traced cap does.
// Bound on this card: bytes (a masked copy: the new state read and the
// old state written where a lane is active; the active flags and the cap
// read, the flags and the loop flag written); no arithmetic.
// Design: one CTA per lane walks the state's fields (element size 1, 4 or
// 8 bytes, a width per lane) and copies its rows when the lane is active;
// an inactive lane writes nothing, so its state stays bit-identical. The
// loop flag is an int cleared by cudaMemsetAsync before the launch and set
// with an integer atomicOr (the order does not matter). A field's new and
// old buffers may be the same memory (fields the body passes through).
#include "common.cuh"

#define FREEZE_MAX_FIELDS 24

struct FreezeFields {
  const void* src[FREEZE_MAX_FIELDS];  // the body's new state
  void* dst[FREEZE_MAX_FIELDS];        // the loop's state buffers
  long long width[FREEZE_MAX_FIELDS];  // elements per lane
  int esize[FREEZE_MAX_FIELDS];        // bytes per element: 1, 4 or 8
  int nf, it_f, done_f;                // field count; the it and done fields
};

template <typename E>
__device__ inline void copy_row(const void* src, void* dst, long long width, int lane) {
  const E* s = static_cast<const E*>(src) + size_t(lane) * width;
  E* d = static_cast<E*>(dst) + size_t(lane) * width;
  for (long long i = threadIdx.x; i < width; i += blockDim.x) d[i] = s[i];
}

__global__ void ipm_freeze_kernel(FreezeFields f, bool* __restrict__ active,
                                  const int* __restrict__ cap, int* __restrict__ flag) {
  const int lane = blockIdx.x;
  const bool on = active[lane];
  if (on) {
    for (int k = 0; k < f.nf; ++k) {
      switch (f.esize[k]) {
        case 8: copy_row<unsigned long long>(f.src[k], f.dst[k], f.width[k], lane); break;
        case 4: copy_row<unsigned int>(f.src[k], f.dst[k], f.width[k], lane); break;
        default: copy_row<unsigned char>(f.src[k], f.dst[k], f.width[k], lane); break;
      }
    }
  }
  __syncthreads();  // every thread has read active[lane] before it is rewritten
  if (threadIdx.x == 0) {
    // the state the lane leaves with: the body's when active, else its own
    const int it = static_cast<const int*>(on ? f.src[f.it_f] : f.dst[f.it_f])[lane];
    const bool done = static_cast<const bool*>(on ? f.src[f.done_f] : f.dst[f.done_f])[lane];
    const bool next = it < *cap && !done;
    active[lane] = next;
    if (next) atomicOr(flag, 1);
  }
}

// ptrs: new[0..F), old[0..F), active (B,) bool, cap () int32, flag () int32
// ints: dtype code, B, F, it field, done field, then F pairs (element
//       bytes, elements per lane)
VMP_ENTRY(ipm_freeze) {
  (void)reals; (void)nreal;
  if (nint < 5) return VMP_BAD_ARGS;
  const long long B = ints[1];
  const int F = int(ints[2]);
  if (F < 1 || F > FREEZE_MAX_FIELDS) return VMP_TOO_LARGE;
  if (nptr != 2 * F + 3 || nint != 5 + 2 * F) return VMP_BAD_ARGS;
  FreezeFields f;
  f.nf = F;
  f.it_f = int(ints[3]);
  f.done_f = int(ints[4]);
  if (f.it_f < 0 || f.it_f >= F || f.done_f < 0 || f.done_f >= F) return VMP_BAD_ARGS;
  if (ints[5 + 2 * f.it_f] != 4 || ints[5 + 2 * f.done_f] != 1) return VMP_BAD_ARGS;
  for (int k = 0; k < F; ++k) {
    const int es = int(ints[5 + 2 * k]);
    if (es != 1 && es != 4 && es != 8) return VMP_BAD_DTYPE;
    f.src[k] = ptrs[k];
    f.dst[k] = ptrs[F + k];
    f.esize[k] = es;
    f.width[k] = ints[6 + 2 * k];
  }
  bool* active = static_cast<bool*>(ptrs[2 * F]);
  const int* cap = static_cast<const int*>(ptrs[2 * F + 1]);
  int* flag = static_cast<int*>(ptrs[2 * F + 2]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(flag, 0, sizeof(int), st);
  if (e != cudaSuccess) return int(e);
  if (B == 0) return 0;
  VMP_LAUNCH(ipm_freeze_kernel, unsigned(B), 128, 0, st)(f, active, cap, flag);
  return int(cudaGetLastError());
}
