// astar_wavefront: the batched wavefront A* of the scenario sweep -- the
// 8-neighbour min-plus cost-to-go field of every map, and the greedy
// descent through it.
//
// Replaces: the JAX package's ops/astar.py cost_to_go (:45-89) and
// extract_path (:92-128), vmapped over maps (bench_sweep.py:194-213).
// Bound on this card: by the roofline, operations -- at the sweep's shape
// (1024 maps of 11 x 40 cells, ~35 relaxations each) ~0.25 GFLOP of adds
// and compares against ~3.6 MB of grid in and field out, a few
// microseconds. What costs in practice is latency: the chain of
// relaxations, each a step every cell of a map must finish before the
// next starts, and in extract_path the 64 dependent moves.
//
// Semantics, both routes: Jacobi relaxation exactly as the JAX package
// does it. Every free cell becomes min(d, min over the 8 neighbours of
// d_nb + step), read from the previous buffer; a blocked cell is 1e9; an
// out-of-bounds neighbour counts as 1e9; the loop stops when no cell
// changed or after max_iters further relaxations. Each value is then the
// same single addition and exact minimum as in the plain version, so the
// fields are equal bit for bit, which extract_path's strict '<'
// tie-break needs. IEEE arithmetic throughout (sqrt(2) correctly rounded).
//
// cost_to_go, two routes (astar_route below, kernels.astar_route in
// Python):
//   * warp route, many maps (B >= ASTAR_WARP_MIN_MAPS) whose two padded
//     buffers fit a warp's share of shared memory (ASTAR_WARP_SMEM): a warp
//     a map, up to ASTAR_MAX_WARPS maps a CTA (the sweep's 1024 maps: 128
//     CTAs of 8 warps, one wave over the 132 SMs). The map's field is
//     double-buffered in the warp's slice of shared memory inside a border
//     (warp_buffer_bytes) that, like every blocked cell, holds +inf: a
//     neighbour is a fixed offset (no division, no bounds test) and
//     no mask is read. A candidate from such a cell, inf + step, is never
//     below a free cell's own value (at most 1e9), and neither is the plain
//     version's 1e9 + step, so the bits agree; a cell that holds +inf is
//     blocked and stays +inf, and is written out as 1e9. Each lane owns
//     NR <= ASTAR_MAX_ROUNDS column segments of seg_h rows (segment s =
//     lane + 32 r: column s % C, rows seg_h (s / C) onwards; seg_h
//     minimises NR (seg_h + 2), seg_height) and walks them down together,
//     row k of every segment before row k + 1, each with a rolling 3 x 3
//     window: three shared loads a cell and NR independent chains, which
//     a warp needs, as only ~8 maps (warps) share an SM. Every lane runs
//     the same NR x seg_h cells without a test: the buffer has the rows
//     of the last chunk below R and a column past the border, all +inf,
//     where a lane without a segment runs one (a test a cell costs more
//     than the cells it would skip). The eight candidates are grouped by
//     step, min(orth) + 1 and min(diag) + sqrt(2): rounding is monotone,
//     so min(a + s, b + s) = min(a, b) + s
//     exactly, the same bits with two additions a cell; the minima are
//     fminf / fmin, exact as no value is NaN. A relaxation ends with
//     __syncwarp and __any_sync on the changed flag; no CTA barrier
//     anywhere, each warp runs on its own.
//   * CTA route, few maps or large grids: one CTA a map, the field
//     double-buffered in shared memory
//     (7 KB at 11 x 40 in float64, 40 KB at 61 x 41), threads striding
//     over the cells, the loop test a __syncthreads_or that is also the
//     barrier between buffers; any grid of up to ~13k cells (float64) or
//     ~25k (float32) fits.
// extract_path: a warp a map, up to ASTAR_MAX_WARPS a CTA (astar_walk
// below). The warp stages its map's field into shared memory with
// coalesced loads (or walks it in device memory where it does not fit),
// then makes the moves: each group of 8 lanes reads the eight neighbours
// in parallel (lane & 7 is the neighbour's index in the reference's
// order) and a butterfly of shuffles finds the smallest candidate, ties
// to the lowest index -- the sequential strict '<' scan in that order, a
// NaN never winning. Lane 0 writes path and valid.
#include "common.cuh"

// (dy, dx) neighbour offsets in the reference's order (src/a_star.py:20)
__constant__ int kOffY[8] = {0, 0, 1, -1, 1, 1, -1, -1};
__constant__ int kOffX[8] = {1, -1, 0, 0, 1, -1, 1, -1};

#define ASTAR_WARP_MIN_MAPS 132                 // fewer maps: a CTA a map (one per SM)
#define ASTAR_MAX_WARPS 8                       // maps (warps) a CTA, warp routes
#define ASTAR_SMS 132                           // the card's SMs, to spread the maps over
#define ASTAR_WARP_SMEM (VMP_SMEM_MAX / 4)      // a warp's share: >= 4 warps an SM
#define ASTAR_MAX_ROUNDS 8                      // a lane's column segments, warp route
#define ASTAR_FULL 0xffffffffu

// The exact minimum of two values that are not NaN (the field never holds
// one): one instruction (fminf / fmin), where a compare and a select take
// two.
__device__ __forceinline__ float tmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double tmin(double a, double b) { return fmin(a, b); }

// 16 bytes of +inf, to fill a warp's buffers a vector at a time
template <typename T>
__device__ __forceinline__ uint4 inf16();
template <>
__device__ __forceinline__ uint4 inf16<float>() {
  return make_uint4(0x7f800000u, 0x7f800000u, 0x7f800000u, 0x7f800000u);
}
template <>
__device__ __forceinline__ uint4 inf16<double>() {
  return make_uint4(0u, 0x7ff00000u, 0u, 0x7ff00000u);
}

// ------------------------------------------------------- the launch plans
struct AstarRoute {
  int warp;      // 1: a warp a map; 0: a CTA a map
  int per_cta;   // maps a CTA
  int threads;
  size_t smem;   // dynamic shared bytes a CTA
  int seg_h;     // rows of a lane's column segment (warp route; 0 otherwise)
};

// A warp's buffer, warp route: (ceil(R / seg_h) seg_h + 2) rows (the
// border and the last chunk's rows below R, all +inf) of C + 3 columns
// (the border and a column of +inf where a lane without a segment runs
// a harmless one).
__host__ __device__ inline int warp_rows(int R, int seg_h) {
  return (R + seg_h - 1) / seg_h * seg_h + 2;
}

// Bytes of a warp's two buffers, rounded to 16.
__host__ __device__ inline size_t warp_buffer_bytes(int R, int C, int seg_h, size_t elem) {
  return (2 * size_t(warp_rows(R, seg_h)) * (C + 3) * elem + 15) / 16 * 16;
}

// Rounds of 32 column segments of h rows that cover R x C.
static long long seg_rounds(int R, int C, int h) {
  return ((long long)C * ((R + h - 1) / h) + 31) / 32;
}

// The segment height h (1..R) of least rounds x (h + 2), the rows a
// segment loads, among those of at most ASTAR_MAX_ROUNDS rounds; ties to
// the smaller h. 0 where none is (more than 32 x ASTAR_MAX_ROUNDS
// columns).
static int seg_height(int R, int C) {
  int best = 0;
  long long best_cost = -1;
  for (int h = 1; h <= R; ++h) {
    const long long rounds = seg_rounds(R, C, h);
    const long long cost = rounds * (h + 2);
    if (rounds <= ASTAR_MAX_ROUNDS && (best_cost < 0 || cost < best_cost))
      best_cost = cost, best = h;
  }
  return best;
}

// Maps a CTA on a warp route: enough CTAs to spread B maps over the SMs,
// at most ASTAR_MAX_WARPS and as many as fit per_map bytes each.
static int warps_per_cta(long long B, size_t per_map) {
  long long W = (B + ASTAR_SMS - 1) / ASTAR_SMS;
  W = W < 1 ? 1 : (W > ASTAR_MAX_WARPS ? ASTAR_MAX_WARPS : W);
  if (per_map > 0 && (long long)(VMP_SMEM_MAX / per_map) < W) W = VMP_SMEM_MAX / per_map;
  return int(W);
}

static AstarRoute astar_route(long long B, int R, int C, size_t elem) {
  const int h = seg_height(R, C);
  const size_t per_warp = h > 0 ? warp_buffer_bytes(R, C, h, elem) : 0;
  if (B >= ASTAR_WARP_MIN_MAPS && h > 0 && per_warp <= ASTAR_WARP_SMEM) {
    const int W = warps_per_cta(B, per_warp);
    return {1, W, 32 * W, W * per_warp, h};
  }
  const int n = R * C;
  const int threads = n >= 1024 ? 1024 : ((n + 31) / 32) * 32;
  return {0, 1, threads, 2 * size_t(n) * elem + size_t(n), 0};
}

struct AstarWalk {
  int per_cta;   // maps (warps) a CTA
  int threads;
  size_t smem;   // dynamic shared bytes a CTA; 0: the walk reads device memory
};

// Bytes of a map's staged field, rounded to 16.
__host__ __device__ inline size_t walk_field_bytes(int R, int C, size_t elem) {
  return (size_t(R) * C * elem + 15) / 16 * 16;
}

static AstarWalk astar_walk(long long B, int R, int C, size_t elem) {
  const size_t per_map = walk_field_bytes(R, C, elem);
  const bool staged = per_map <= VMP_SMEM_MAX;
  const int W = warps_per_cta(B, staged ? per_map : 0);
  return {W, 32 * W, staged ? W * per_map : 0};
}

// ------------------------------------------------ cost_to_go, CTA route

// One Jacobi relaxation of the field `src` into `dst`; returns whether
// any of this thread's cells changed.
template <typename T>
__device__ bool relax_once(const T* src, T* dst, const unsigned char* blocked, int R, int C,
                           T inf, T sq2) {
  bool changed = false;
  for (int c = threadIdx.x; c < R * C; c += blockDim.x) {
    T v = inf;
    if (!blocked[c]) {
      const int y = c / C, x = c % C;
      v = src[c];
      for (int o = 0; o < 8; ++o) {
        // the shifted field of ops/astar.py _shift_pad: d[y - dy][x - dx]
        const int ny = y - kOffY[o], nx = x - kOffX[o];
        const T nb = (ny >= 0 && ny < R && nx >= 0 && nx < C) ? src[ny * C + nx] : inf;
        const T cand = nb + ((kOffY[o] != 0 && kOffX[o] != 0) ? sq2 : T(1));
        v = cand < v ? cand : v;
      }
    }
    dst[c] = v;
    changed |= (v != src[c]);
  }
  return changed;
}

template <typename T>
__global__ void cost_to_go_kernel(const T* __restrict__ grid, const int* __restrict__ goal,
                                  T* __restrict__ out, int* __restrict__ relaxations, int R,
                                  int C, int max_iters) {
  extern __shared__ double smem_raw[];
  const int n = R * C;
  T* a = reinterpret_cast<T*>(smem_raw);
  T* b = a + n;
  unsigned char* blocked = reinterpret_cast<unsigned char*>(b + n);
  const size_t base = size_t(blockIdx.x) * n;
  const int gy = goal[2 * blockIdx.x], gx = goal[2 * blockIdx.x + 1];
  const T inf = T(1e9), sq2 = sqrt(T(2));
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const bool bl = grid[base + c] > T(0.5);
    blocked[c] = bl;
    a[c] = (!bl && c / C == gy && c % C == gx) ? T(0) : inf;
  }
  __syncthreads();
  // prev = a, d = b = relax(a); then relax while the last one changed
  int it = 0;
  T* prev = a;
  T* d = b;
  int changed = __syncthreads_or(relax_once(prev, d, blocked, R, C, inf, sq2));
  while (changed && it < max_iters) {
    T* t = prev;
    prev = d;
    d = t;
    changed = __syncthreads_or(relax_once(prev, d, blocked, R, C, inf, sq2));
    ++it;
  }
  for (int c = threadIdx.x; c < n; c += blockDim.x) out[base + c] = d[c];
  if (threadIdx.x == 0) relaxations[blockIdx.x] = it + 1;
}

// ------------------------------------------------ cost_to_go, warp route

// One Jacobi relaxation of the field `src` into `dst` over this lane's NR
// column segments of seg_h rows, row k of every segment before row k + 1
// (NR independent chains); off[r] is the index of segment r's window
// top-left. Every lane runs the same rows, without a test: the cells past
// the map hold +inf and stay so. Returns the least (new - old) over its
// cells, < 0 where one changed (a blocked cell's inf - inf is NaN, which
// fmin passes over).
template <typename T, int NR>
__device__ __forceinline__ T relax_segments(const T* __restrict__ src, T* __restrict__ dst,
                                            const int (&off)[NR], int W2, int seg_h, T sq2) {
  const T inf = T(INFINITY);
  const T* p[NR];   // the window's row below, left column
  T* q[NR];         // the window's centre in dst
  T m0[NR], m1[NR], lr0[NR], lr1[NR];   // the window's centre column and min(left, right)
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    p[r] = src + off[r];
    q[r] = dst + off[r] + W2 + 1;
    m0[r] = p[r][1], lr0[r] = tmin(p[r][0], p[r][2]);
    m1[r] = p[r][W2 + 1], lr1[r] = tmin(p[r][W2], p[r][W2 + 2]);
    p[r] += 2 * W2;
  }
  T acc = T(0);
  for (int k = 0; k < seg_h; ++k) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const T m2 = p[r][1], lr2 = tmin(p[r][0], p[r][2]);
      const T c = tmin(tmin(tmin(lr1[r], m0[r]), m2) + T(1), tmin(lr0[r], lr2) + sq2);
      const T v = m1[r] == inf ? inf : tmin(m1[r], c);
      *q[r] = v;
      acc = tmin(acc, v - m1[r]);
      m0[r] = m1[r], m1[r] = m2, lr0[r] = lr1[r], lr1[r] = lr2;
      p[r] += W2;
      q[r] += W2;
    }
  }
  return acc;
}

template <typename T, int NR>
__global__ void __launch_bounds__(ASTAR_MAX_WARPS * 32)
    cost_to_go_warp_kernel(const T* __restrict__ grid, const int* __restrict__ goal,
                           T* __restrict__ out, int* __restrict__ relaxations, long long B,
                           int R, int C, int max_iters, int seg_h) {
  extern __shared__ double smem_raw[];
  const int lane = threadIdx.x & 31;
  const long long m = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (m >= B) return;   // a whole warp
  const int W2 = C + 3, n = R * C, dy = 32 / C, dx = 32 - dy * C;
  const size_t bytes = warp_buffer_bytes(R, C, seg_h, sizeof(T));
  char* slice = reinterpret_cast<char*>(smem_raw) + (threadIdx.x >> 5) * bytes;
  T* a = reinterpret_cast<T*>(slice);
  const int P = warp_rows(R, seg_h) * W2;   // the second buffer: a + P
  const T inf = T(INFINITY), sq2 = sqrt(T(2));
  const uint4 fill = inf16<T>();
  for (int i = lane; i < int(bytes / 16); i += 32)   // both buffers, border included
    reinterpret_cast<uint4*>(slice)[i] = fill;
  __syncwarp();
  const T* g = grid + m * n;
  const int gy = goal[2 * m], gx = goal[2 * m + 1];
  {
    int y = lane / C, x = lane - y * C;
#pragma unroll 4
    for (int c = lane; c < n; c += 32) {
      a[(y + 1) * W2 + x + 1] = g[c] > T(0.5) ? inf : (y == gy && x == gx) ? T(0) : T(1e9);
      x += dx, y += dy;
      if (x >= C) x -= C, ++y;
    }
  }
  // segment s = lane + 32 r: column s % C, rows seg_h (s / C) onwards; past
  // the last one, the +inf column C (padded C + 1)
  int off[NR];
  {
    const int nseg = C * ((R + seg_h - 1) / seg_h);
    int j = lane / C, x = lane - j * C;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      off[r] = lane + 32 * r < nseg ? j * seg_h * W2 + x : C;
      x += dx, j += dy;
      if (x >= C) x -= C, ++j;
    }
  }
  __syncwarp();
  // prev = a, d = b = relax(a); then relax while the last one changed
  int it = 0;
  T* prev = a;
  T* d = a + P;
  T least = relax_segments<T, NR>(prev, d, off, W2, seg_h, sq2);
  __syncwarp();
  bool changed = __any_sync(ASTAR_FULL, least < T(0));
  while (changed && it < max_iters) {
    T* t = prev;
    prev = d;
    d = t;
    least = relax_segments<T, NR>(prev, d, off, W2, seg_h, sq2);
    __syncwarp();
    changed = __any_sync(ASTAR_FULL, least < T(0));
    ++it;
  }
  T* o = out + m * n;
  int y = lane / C, x = lane - y * C;
#pragma unroll 4
  for (int c = lane; c < n; c += 32) {
    const T v = d[(y + 1) * W2 + x + 1];
    o[c] = v == inf ? T(1e9) : v;
    x += dx, y += dy;
    if (x >= C) x -= C, ++y;
  }
  if (lane == 0) relaxations[m] = it + 1;
}

// ------------------------------------------------------------ extract_path
template <typename T>
__global__ void __launch_bounds__(ASTAR_MAX_WARPS * 32)
    extract_path_kernel(const T* __restrict__ field, const int* __restrict__ start,
                        int* __restrict__ path, bool* __restrict__ valid, long long B, int R,
                        int C, int L, int staged) {
  extern __shared__ double smem_raw[];
  const int lane = threadIdx.x & 31;
  const long long m = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (m >= B) return;   // a whole warp
  const int n = R * C;
  const T* f = field + m * n;
  if (staged) {
    T* s = reinterpret_cast<T*>(reinterpret_cast<char*>(smem_raw) +
                                (threadIdx.x >> 5) * walk_field_bytes(R, C, sizeof(T)));
    for (int i = lane; i < n; i += 32) s[i] = f[i];
    __syncwarp();
    f = s;
  }
  const T inf = T(INFINITY);
  const int o = lane & 7;   // this lane's neighbour, in each group of 8 lanes
  const int oy = kOffY[o], ox = kOffX[o];
  int y = min(max(start[2 * m], 0), R - 1);
  int x = min(max(start[2 * m + 1], 0), C - 1);
  int goal_entries = 0;
  T here = f[y * C + x];
  for (int s = 0; s < L; ++s) {
    const int ty = y + oy, tx = x + ox;
    T cand = (ty >= 0 && ty < R && tx >= 0 && tx < C) ? f[ty * C + tx] : T(1e9);
    cand = cand == cand ? cand : inf;   // a NaN never wins; nor does +inf
    int idx = o;
#pragma unroll
    for (int w = 4; w > 0; w >>= 1) {   // the smallest, ties to the lowest index
      const T oc = __shfl_xor_sync(ASTAR_FULL, cand, w);
      const int oi = __shfl_xor_sync(ASTAR_FULL, idx, w);
      if (oc < cand || (oc == cand && oi < idx)) cand = oc, idx = oi;
    }
    if (cand < here && !(here <= T(0))) {
      y = min(max(y + kOffY[idx], 0), R - 1);   // idx is the same on every lane
      x = min(max(x + kOffX[idx], 0), C - 1);
      here = f[y * C + x];
    }
    goal_entries += here <= T(0);
    if (lane == 0) {
      const size_t k = size_t(m) * L + s;
      path[2 * k] = y;
      path[2 * k + 1] = x;
      valid[k] = goal_entries <= 1;
    }
  }
}

// ------------------------------------------------------------- launches
template <typename T>
static int launch_cost_to_go(void** p, long long B, int R, int C, int max_iters,
                             cudaStream_t st) {
  if (R < 1 || C < 1) return VMP_TOO_LARGE;
  const AstarRoute r = astar_route(B, R, C, sizeof(T));
  if (r.smem > VMP_SMEM_MAX) return VMP_TOO_LARGE;
  if (r.warp) {
    const int nr = int(seg_rounds(R, C, r.seg_h));
    auto kernel = nr == 1 ? cost_to_go_warp_kernel<T, 1> : nr == 2 ? cost_to_go_warp_kernel<T, 2>
                  : nr == 3 ? cost_to_go_warp_kernel<T, 3> : nr == 4 ? cost_to_go_warp_kernel<T, 4>
                  : nr == 5 ? cost_to_go_warp_kernel<T, 5> : nr == 6 ? cost_to_go_warp_kernel<T, 6>
                  : nr == 7 ? cost_to_go_warp_kernel<T, 7> : cost_to_go_warp_kernel<T, 8>;
    cudaError_t e = vmp_allow_smem(kernel, r.smem);
    if (e != cudaSuccess) return int(e);
    const unsigned grid = unsigned((B + r.per_cta - 1) / r.per_cta);
    VMP_LAUNCH(kernel, grid, r.threads, r.smem, st)(
        (const T*)p[0], (const int*)p[1], (T*)p[2], (int*)p[3], B, R, C, max_iters, r.seg_h);
    return int(cudaGetLastError());
  }
  auto kernel = cost_to_go_kernel<T>;
  cudaError_t e = vmp_allow_smem(kernel, r.smem);
  if (e != cudaSuccess) return int(e);
  if (B == 0) return 0;
  VMP_LAUNCH(kernel, unsigned(B), r.threads, r.smem, st)(
      (const T*)p[0], (const int*)p[1], (T*)p[2], (int*)p[3], R, C, max_iters);
  return int(cudaGetLastError());
}

template <typename T>
static int launch_extract_path(void** p, long long B, int R, int C, int L, cudaStream_t st) {
  if (R < 1 || C < 1 || L < 1) return VMP_BAD_ARGS;
  const AstarWalk w = astar_walk(B, R, C, sizeof(T));
  auto kernel = extract_path_kernel<T>;
  cudaError_t e = vmp_allow_smem(kernel, w.smem);
  if (e != cudaSuccess) return int(e);
  if (B == 0) return 0;
  const unsigned grid = unsigned((B + w.per_cta - 1) / w.per_cta);
  VMP_LAUNCH(kernel, grid, w.threads, w.smem, st)(
      (const T*)p[0], (const int*)p[1], (int*)p[2], (bool*)p[3], B, R, C, L, w.smem > 0);
  return int(cudaGetLastError());
}

// ptrs: grid (B, R, C), goal (B, 2) int32, field out (B, R, C),
//       relaxations out (B,) int32
// ints: dtype, B, R, C, max_iters
VMP_ENTRY(astar_cost_to_go) {
  if (nptr != 4 || nint != 5 || nreal != 0) return VMP_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = int(ints[2]), C = int(ints[3]), it = int(ints[4]);
  if (ints[0] == 0) return launch_cost_to_go<float>(ptrs, ints[1], R, C, it, st);
  if (ints[0] == 1) return launch_cost_to_go<double>(ptrs, ints[1], R, C, it, st);
  return VMP_BAD_DTYPE;
}

// ptrs: field (B, R, C), start (B, 2) int32, path out (B, L, 2) int32,
//       valid out (B, L) bool
// ints: dtype, B, R, C, L
VMP_ENTRY(astar_extract_path) {
  if (nptr != 4 || nint != 5 || nreal != 0) return VMP_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = int(ints[2]), C = int(ints[3]), L = int(ints[4]);
  if (ints[0] == 0) return launch_extract_path<float>(ptrs, ints[1], R, C, L, st);
  if (ints[0] == 1) return launch_extract_path<double>(ptrs, ints[1], R, C, L, st);
  return VMP_BAD_DTYPE;
}

// The launch plans of B maps of R x C in dtype code dtype (0 float32, 1
// float64), for kernels.astar_route and kernels.astar_walk to be checked
// against: out = {warp, per_cta, threads, smem, seg_h} of cost_to_go,
// then {per_cta, threads, smem} of extract_path; VMP_TOO_LARGE where
// cost_to_go refuses the grid.
extern "C" int astar_route_info(long long B, int R, int C, int dtype, long long* out) {
  if (dtype != 0 && dtype != 1) return VMP_BAD_DTYPE;
  if (R < 1 || C < 1) return VMP_TOO_LARGE;
  const size_t elem = dtype == 0 ? sizeof(float) : sizeof(double);
  const AstarRoute r = astar_route(B, R, C, elem);
  if (r.smem > VMP_SMEM_MAX) return VMP_TOO_LARGE;
  const AstarWalk w = astar_walk(B, R, C, elem);
  out[0] = r.warp;
  out[1] = r.per_cta;
  out[2] = r.threads;
  out[3] = (long long)r.smem;
  out[4] = r.seg_h;
  out[5] = w.per_cta;
  out[6] = w.threads;
  out[7] = (long long)w.smem;
  return 0;
}
