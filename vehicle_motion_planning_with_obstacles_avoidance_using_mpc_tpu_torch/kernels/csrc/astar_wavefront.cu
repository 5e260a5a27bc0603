// astar_wavefront: the batched wavefront A* of the scenario sweep -- the
// 8-neighbour min-plus cost-to-go field of every map, and the greedy
// descent through it.
//
// Replaces: the JAX package's ops/astar.py cost_to_go (:45-89) and
// extract_path (:92-128), vmapped over maps (bench_sweep.py:194-213).
// Bound on this card: by the roofline, operations -- at the sweep's shape
// (1024 maps of 11 x 40 cells, ~40 relaxations each) ~0.3 GFLOP of
// adds and compares against ~3.6 MB of grid in and field out, a few
// microseconds. What costs in practice is latency: the chain of
// relaxations, each a step every cell of a map must finish before the
// next starts, and in extract_path the 64 dependent moves.
// Design: cost_to_go runs one CTA per map with the field double-buffered
// in shared memory (7 KB at 11 x 40 in float64, 40 KB at 61 x 41), so the
// relaxation chain never leaves the SM; threads stride over the cells,
// so any grid of up to ~13k cells fits. It is Jacobi relaxation exactly as
// the JAX package does it: every free cell becomes min(d, min over the
// neighbours of d_nb + step), read from the previous buffer; a blocked cell
// is reset to 1e9; the loop stops when no cell changed (__syncthreads_or,
// which is also the barrier between buffers) or after max_iters further
// relaxations. Each value is then the same single addition and exact
// minimum as in the plain version, so the two fields are equal bit for
// bit, which extract_path's strict '<' tie-break needs. extract_path is
// one thread per map: the walk is sequential and the field is read from
// L2. IEEE arithmetic throughout (sqrt(2) correctly rounded).
#include "common.cuh"

// (dy, dx) neighbour offsets in the reference's order (src/a_star.py:20)
__constant__ int kOffY[8] = {0, 0, 1, -1, 1, 1, -1, -1};
__constant__ int kOffX[8] = {1, -1, 0, 0, 1, -1, 1, -1};

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

template <typename T>
__global__ void extract_path_kernel(const T* __restrict__ field, const int* __restrict__ start,
                                    int* __restrict__ path, bool* __restrict__ valid, int B,
                                    int R, int C, int L) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= B) return;
  const T* f = field + size_t(m) * R * C;
  const T inf = T(1e9);
  int y = min(max(start[2 * m], 0), R - 1);
  int x = min(max(start[2 * m + 1], 0), C - 1);
  int goal_entries = 0;
  for (int s = 0; s < L; ++s) {
    const T here = f[y * C + x];
    T best = here;
    int by = y, bx = x;
    for (int o = 0; o < 8; ++o) {
      const int ty = y + kOffY[o], tx = x + kOffX[o];
      const int ny = min(max(ty, 0), R - 1), nx = min(max(tx, 0), C - 1);
      const T cand = (ty == ny && tx == nx) ? f[ny * C + nx] : inf;
      if (cand < best) {
        best = cand;
        by = ny;
        bx = nx;
      }
    }
    if (!(here <= T(0))) {
      y = by;
      x = bx;
    }
    const size_t o = size_t(m) * L + s;
    path[2 * o] = y;
    path[2 * o + 1] = x;
    goal_entries += f[y * C + x] <= T(0);
    valid[o] = goal_entries <= 1;
  }
}

template <typename T>
static int launch_cost_to_go(void** p, long long B, int R, int C, int max_iters,
                             cudaStream_t st) {
  const int n = R * C;
  const size_t smem = 2 * size_t(n) * sizeof(T) + size_t(n);
  if (R < 1 || C < 1 || smem > 227 * 1024) return VMP_TOO_LARGE;
  cudaError_t e = vmp_allow_smem(cost_to_go_kernel<T>, smem);
  if (e != cudaSuccess) return int(e);
  if (B == 0) return 0;
  const int threads = n >= 1024 ? 1024 : ((n + 31) / 32) * 32;
  VMP_LAUNCH(cost_to_go_kernel<T>, unsigned(B), threads, smem, st)(
      (const T*)p[0], (const int*)p[1], (T*)p[2], (int*)p[3], R, C, max_iters);
  return int(cudaGetLastError());
}

template <typename T>
static int launch_extract_path(void** p, long long B, int R, int C, int L, cudaStream_t st) {
  if (R < 1 || C < 1 || L < 1) return VMP_BAD_ARGS;
  if (B == 0) return 0;
  const int threads = 128;
  VMP_LAUNCH(extract_path_kernel<T>, unsigned((B + threads - 1) / threads), threads, 0, st)(
      (const T*)p[0], (const int*)p[1], (int*)p[2], (bool*)p[3], int(B), R, C, L);
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
