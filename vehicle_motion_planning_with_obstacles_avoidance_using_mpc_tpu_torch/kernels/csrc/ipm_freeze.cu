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
// leaves, and the loop's device flag, 1 when any lane stays active, else
// 0. The cap is read from device memory, so one captured graph serves
// every chunk boundary, as JAX's traced cap does.
// Bound on this card: bytes (a masked copy: the new state read and the
// old state written where a lane is active; the active flags and the cap
// read, the flags and the loop flag written); no arithmetic.
// Design: a static copy plan per (state layout, lanes, field modes),
// made by the host code below (freeze_plan) from the fields' sizes and
// modes at each call (kernels.freeze_launch_plan reads it back). A field
// the body passes through (its new and old buffers are the same memory)
// is left out of the plan. Each lane of every other field is cut into
// slots: where both buffers are 16-byte aligned and a row holds at least
// 16 bytes, up to 16 / esize - 1 element slots for the row's ragged head,
// a 16-byte slot for each vector and as many element slots for its tail;
// else one slot an element. Items are
// (field, lane, slot), field-major after one flag item a lane, so that a
// warp reads a field's consecutive rows; a grid of FREEZE_THREADS-thread
// CTAs takes FREEZE_MAX_PER_THREAD items a thread where that still gives
// FREEZE_FILL_CTAS CTAs (else fewer), and each thread issues all its
// loads before any store. A lane's flag item computes its next active
// flag from the state the lane leaves (the body's when it was active,
// else its own, neither written here) into the plan's device workspace.
// Every CTA reads active[] for its lanes, so only the last CTA to finish
// (an atomic ticket after a __threadfence, in the same workspace) copies
// the next flags into active[], stores the loop flag and resets the
// ticket: no memset, and no atomic on the flag. An inactive lane writes
// nothing, so its state stays bit-identical.
#include "common.cuh"

#define FREEZE_MAX_FIELDS 24
#define FREEZE_THREADS 128
#define FREEZE_MAX_PER_THREAD 4
#define FREEZE_FILL_CTAS 264   // 2 CTAs on each of the card's 132 SMs
#define FREEZE_WS_HEAD 16      // workspace: the ticket, then the next flags

enum { FREEZE_SKIP = 0, FREEZE_ELEM = 1, FREEZE_VEC = 2 };

struct FreezePlan {
  const char* src[FREEZE_MAX_FIELDS];  // the body's new state
  char* dst[FREEZE_MAX_FIELDS];        // the loop's state buffers
  long long row[FREEZE_MAX_FIELDS];    // bytes a lane
  long long start[FREEZE_MAX_FIELDS + 1];  // first item of field k; start[nf] = items
  int slots[FREEZE_MAX_FIELDS];        // slots a lane (0: the field is skipped)
  int esize[FREEZE_MAX_FIELDS];        // bytes an element: 1, 4 or 8
  int mode[FREEZE_MAX_FIELDS];
  int nf, it_f, done_f, B;
  int per_thread;                      // items a thread: 1, 2 or 4
  unsigned ctas;
  long long items;                     // B flag items + every field's B x slots
};

// slots a lane of a field of `row` bytes of `esize`-byte elements
__host__ __device__ inline int freeze_slots(int mode, int esize, long long row) {
  if (mode == FREEZE_SKIP) return 0;
  if (mode == FREEZE_ELEM) return int(row / esize);
  return 2 * (16 / esize - 1) + int(row >> 4);
}

// One item: where it goes and what it carries (nb bytes: 0, 1, 4, 8, 16).
struct FreezeItem {
  char* dst;
  uint4 v;
  int nb;
};

__device__ inline void freeze_load(FreezeItem& t, const char* s) {
  switch (t.nb) {
    case 16: t.v = __ldg(reinterpret_cast<const uint4*>(s)); break;
    case 8: {
      const unsigned long long x = __ldg(reinterpret_cast<const unsigned long long*>(s));
      t.v.x = unsigned(x);
      t.v.y = unsigned(x >> 32);
      break;
    }
    case 4: t.v.x = __ldg(reinterpret_cast<const unsigned*>(s)); break;
    case 1: t.v.x = __ldg(reinterpret_cast<const unsigned char*>(s)); break;
    default: break;
  }
}

__device__ inline void freeze_store(const FreezeItem& t) {
  switch (t.nb) {
    case 16: *reinterpret_cast<uint4*>(t.dst) = t.v; break;
    case 8:
      *reinterpret_cast<unsigned long long*>(t.dst) =
          (static_cast<unsigned long long>(t.v.y) << 32) | t.v.x;
      break;
    case 4: *reinterpret_cast<unsigned*>(t.dst) = t.v.x; break;
    case 1: *reinterpret_cast<unsigned char*>(t.dst) = static_cast<unsigned char>(t.v.x); break;
    default: break;
  }
}

// Item i of the plan: a flag item (i < B) computes the lane's next flag
// into the workspace; a field item its source and destination.
__device__ inline void freeze_item(const FreezePlan& p, long long i, const bool* active,
                                   int cap, unsigned char* next, FreezeItem& t) {
  t.nb = 0;
  if (i >= p.items) return;
  if (i < p.B) {
    const int lane = int(i);
    const bool on = active[lane];
    const int it = reinterpret_cast<const int*>(on ? p.src[p.it_f] : p.dst[p.it_f])[lane];
    const bool done =
        reinterpret_cast<const bool*>(on ? p.src[p.done_f] : p.dst[p.done_f])[lane];
    t.dst = reinterpret_cast<char*>(next + lane);
    t.v.x = (it < cap && !done) ? 1u : 0u;
    t.nb = 1;
    return;
  }
  int k = 0;
  while (i >= p.start[k + 1]) ++k;
  const unsigned j = unsigned(i - p.start[k]), S = unsigned(p.slots[k]);
  const unsigned lane = j / S, slot = j - lane * S;
  if (!active[lane]) return;
  const int es = p.esize[k];
  const long long row = p.row[k], off = (long long)lane * row;
  long long pos;
  if (p.mode[k] == FREEZE_ELEM) {
    pos = off + (long long)slot * es;
    t.nb = es;
  } else {
    const int H = 16 / es - 1, V = int(row >> 4);
    const long long head = (16 - (off & 15)) & 15;
    const long long body = (row - head) >> 4;   // vectors of this lane
    if (int(slot) < H) {                           // the ragged head
      pos = (long long)slot * es;
      if (pos >= head) return;
    } else if (int(slot) < H + V) {                // the 16-byte vectors
      const long long v = slot - H;
      if (v >= body) return;
      pos = head + 16 * v;
      t.nb = 16;
    } else {                                       // the ragged tail
      pos = head + 16 * body + (long long)(slot - H - V) * es;
      if (pos >= row) return;
    }
    pos += off;
    if (t.nb == 0) t.nb = es;
  }
  t.dst = p.dst[k] + pos;
  freeze_load(t, p.src[k] + pos);
}

template <int U>
__global__ void __launch_bounds__(FREEZE_THREADS) ipm_freeze_kernel(
    const __grid_constant__ FreezePlan p, bool* __restrict__ active, const int* __restrict__ cap,
    int* __restrict__ flag, unsigned char* __restrict__ ws) {
  __shared__ bool last;
  unsigned char* next = ws + FREEZE_WS_HEAD;
  unsigned* ticket = reinterpret_cast<unsigned*>(ws);
  const int c = *cap;
  const long long base = (long long)blockIdx.x * U * FREEZE_THREADS + threadIdx.x;
  FreezeItem t[U];
#pragma unroll
  for (int u = 0; u < U; ++u) freeze_item(p, base + u * FREEZE_THREADS, active, c, next, t[u]);
#pragma unroll
  for (int u = 0; u < U; ++u) freeze_store(t[u]);
  if (base < p.B) __threadfence();   // this thread wrote a next flag (flag items come first)
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // the last CTA: every other CTA has read active[] and written its next flags
  __threadfence();
  unsigned any = 0;
  const int B = p.B;
  int done_bytes = 0;
  if ((reinterpret_cast<uintptr_t>(active) & 15) == 0) {
    done_bytes = B & ~15;
    for (int w = threadIdx.x; w < (B >> 4); w += FREEZE_THREADS) {
      const uint4 v = __ldcg(reinterpret_cast<const uint4*>(next) + w);
      reinterpret_cast<uint4*>(active)[w] = v;
      any |= v.x | v.y | v.z | v.w;
    }
  }
  for (int l = done_bytes + threadIdx.x; l < B; l += FREEZE_THREADS) {
    const unsigned char v = __ldcg(next + l);
    active[l] = v != 0;
    any |= v;
  }
  any = __syncthreads_or(any != 0);
  if (threadIdx.x == 0) {
    *flag = any ? 1 : 0;
    *ticket = 0u;
  }
}

// The plan of one call: 0, or an argument code. ints: dtype code, B, F,
// it field, done field, workspace bytes, then F triples (element bytes,
// elements a lane, mode); ptrs (may be null for the plan alone): new[0..F),
// old[0..F).
static int freeze_plan(const long long* ints, int nint, void* const* ptrs, FreezePlan& p) {
  if (nint < 6) return VMP_BAD_ARGS;
  const long long B = ints[1];
  const int F = int(ints[2]);
  if (F < 1 || F > FREEZE_MAX_FIELDS) return VMP_TOO_LARGE;
  if (nint != 6 + 3 * F || B < 0) return VMP_BAD_ARGS;
  p.nf = F;
  p.B = int(B);
  p.it_f = int(ints[3]);
  p.done_f = int(ints[4]);
  if (p.it_f < 0 || p.it_f >= F || p.done_f < 0 || p.done_f >= F) return VMP_BAD_ARGS;
  if (ints[6 + 3 * p.it_f] != 4 || ints[6 + 3 * p.done_f] != 1) return VMP_BAD_ARGS;
  if (ints[5] < FREEZE_WS_HEAD + B) return VMP_BAD_ARGS;
  long long items = B;
  for (int k = 0; k < F; ++k) {
    const int es = int(ints[6 + 3 * k]), mode = int(ints[8 + 3 * k]);
    const long long width = ints[7 + 3 * k];
    if (es != 1 && es != 4 && es != 8) return VMP_BAD_DTYPE;
    if (width < 0 || mode < FREEZE_SKIP || mode > FREEZE_VEC) return VMP_BAD_ARGS;
    const long long row = width * es;
    if (mode == FREEZE_VEC && row < 16) return VMP_BAD_ARGS;
    if (ptrs) {
      const char* s = static_cast<const char*>(ptrs[k]);
      const char* d = static_cast<const char*>(ptrs[F + k]);
      // a skipped field must be its own source; a vector field 16-byte aligned
      if (mode == FREEZE_SKIP && s != d) return VMP_BAD_ARGS;
      if (mode == FREEZE_VEC && ((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(d)) & 15))
        return VMP_BAD_ARGS;
      p.src[k] = s;
      p.dst[k] = const_cast<char*>(d);
    }
    p.esize[k] = es;
    p.mode[k] = mode;
    p.row[k] = row;
    p.slots[k] = freeze_slots(mode, es, row);
    p.start[k] = items;
    items += B * p.slots[k];
  }
  p.start[F] = items;
  for (int k = F + 1; k <= FREEZE_MAX_FIELDS; ++k) p.start[k] = items;
  if (items > 0x7fffffffLL) return VMP_TOO_LARGE;
  p.items = items;
  int U = FREEZE_MAX_PER_THREAD;
  while (U > 1 && (items + U * FREEZE_THREADS - 1) / (U * FREEZE_THREADS) < FREEZE_FILL_CTAS) U /= 2;
  p.per_thread = U;
  const long long ctas = (items + U * FREEZE_THREADS - 1) / (U * FREEZE_THREADS);
  p.ctas = unsigned(ctas < 1 ? 1 : ctas);
  return 0;
}

// The plan the library makes for these ints (ipm_freeze's, without
// pointers): out = slots a lane (the flag slot included), items, items a
// thread, CTAs, threads a CTA.
extern "C" int ipm_freeze_plan_info(const long long* ints, int nint, long long* out) {
  FreezePlan p;
  const int rc = freeze_plan(ints, nint, nullptr, p);
  if (rc) return rc;
  out[0] = p.B ? p.items / p.B : 1;
  out[1] = p.items;
  out[2] = p.per_thread;
  out[3] = p.ctas;
  out[4] = FREEZE_THREADS;
  return 0;
}

// ptrs: new[0..F), old[0..F), active (B,) bool, cap () int32, flag () int32,
//       workspace (FREEZE_WS_HEAD + B bytes; its ticket 0 between calls)
// ints: as freeze_plan's
VMP_ENTRY(ipm_freeze) {
  (void)reals; (void)nreal;
  if (nint < 3) return VMP_BAD_ARGS;
  const int F = int(ints[2]);
  if (F < 1 || F > FREEZE_MAX_FIELDS) return VMP_TOO_LARGE;
  if (nptr != 2 * F + 4) return VMP_BAD_ARGS;
  FreezePlan p;
  const int rc = freeze_plan(ints, nint, ptrs, p);
  if (rc) return rc;
  bool* active = static_cast<bool*>(ptrs[2 * F]);
  const int* cap = static_cast<const int*>(ptrs[2 * F + 1]);
  int* flag = static_cast<int*>(ptrs[2 * F + 2]);
  unsigned char* ws = static_cast<unsigned char*>(ptrs[2 * F + 3]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p.per_thread) {
    case 4: VMP_LAUNCH(ipm_freeze_kernel<4>, p.ctas, FREEZE_THREADS, 0, st)(p, active, cap, flag, ws); break;
    case 2: VMP_LAUNCH(ipm_freeze_kernel<2>, p.ctas, FREEZE_THREADS, 0, st)(p, active, cap, flag, ws); break;
    default: VMP_LAUNCH(ipm_freeze_kernel<1>, p.ctas, FREEZE_THREADS, 0, st)(p, active, cap, flag, ws); break;
  }
  return int(cudaGetLastError());
}
