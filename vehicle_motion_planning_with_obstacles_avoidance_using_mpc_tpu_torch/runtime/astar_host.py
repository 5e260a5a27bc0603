"""Host-side 8-connected grid A* with reference-exact semantics (numpy).

A copy of the JAX package's ``runtime/astar_host.py``, which is plain
Python but is reachable only through that package's jax-importing
``__init__``. Closed-loop trajectory parity with the reference requires
the *same* optimal path among ties. This implementation reproduces the search
semantics of ``src/a_star.py:39-102`` — pop order keyed on
``(f, (row, col))`` lexicographic tuples, the fixed neighbor iteration
order, improve-or-new push rule, and goal-back-to-start path extraction
that excludes the start cell — but with O(1) open-set membership
(a live-entry counter) instead of the reference's O(n) heap scan, and as a
plain function rather than stateful class.

The closed loop runs this once per scenario (``src/closed_loop.py:329``),
so it is not on the hot path.
"""

from __future__ import annotations

import heapq
import math

import numpy as np

# (d_row, d_col) in the reference's iteration order (src/a_star.py:20)
_NEIGHBORS = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1))


def solve_grid_astar(grid, start_yx, goal_yx):
    """A* over an occupancy grid.

    Args:
      grid: (rows, cols) array-like, 1 = blocked. Indexed [row][col].
      start_yx, goal_yx: (row, col) int tuples.

    Returns:
      List of (row, col) from goal back to the first cell after start
      (start excluded), or None when unreachable — the reference's
      ``solve`` contract (returns False there).
    """
    grid = np.asarray(grid)
    rows, cols = grid.shape
    start = (int(start_yx[0]), int(start_yx[1]))
    goal = (int(goal_yx[0]), int(goal_yx[1]))

    def h(a):
        return math.sqrt((goal[0] - a[0]) ** 2 + (goal[1] - a[1]) ** 2)

    g = {start: 0.0}
    parent = {}
    closed = set()
    open_heap = [(h(start), start)]
    live = {start: 1}  # open-set membership count incl. stale duplicates

    while open_heap:
        _, cur = heapq.heappop(open_heap)
        live[cur] -= 1
        if cur == goal:
            path = []
            node = cur
            while node in parent:
                path.append(node)
                node = parent[node]
            return path
        closed.add(cur)
        for dr, dc in _NEIGHBORS:
            nb = (cur[0] + dr, cur[1] + dc)
            if not (0 <= nb[0] < rows and 0 <= nb[1] < cols):
                continue
            if grid[nb[0], nb[1]] == 1:
                continue
            step = math.sqrt(dr * dr + dc * dc)
            tentative = g[cur] + step
            # reference quirk preserved: closed-set test uses gscore default
            # 0 (src/a_star.py:90) — harmless with a consistent heuristic
            if nb in closed and tentative >= g.get(nb, 0.0):
                continue
            if tentative < g.get(nb, 0.0) or live.get(nb, 0) <= 0:
                parent[nb] = cur
                g[nb] = tentative
                heapq.heappush(open_heap, (tentative + h(nb), nb))
                live[nb] = live.get(nb, 0) + 1
    return None


def path_goal_to_xy(route):
    """Reverse a goal->start (row, col) route into start->goal (x, y) pairs
    (the reference's ``rebuild_path``, src/a_star.py:137-147)."""
    return [[c, r] for r, c in reversed(route)]


def add_headings(path_xy):
    """Append theta = atan2(dy, dx) toward the next point; last point keeps
    the previous heading (src/a_star.py:189-200)."""
    out = []
    n = len(path_xy)
    for i in range(n - 1):
        yaw = math.atan2(
            path_xy[i + 1][1] - path_xy[i][1], path_xy[i + 1][0] - path_xy[i][0]
        )
        out.append([path_xy[i][0], path_xy[i][1], yaw])
    out.append([path_xy[-1][0], path_xy[-1][1], out[-1][2]])
    return out


def interpolate_path(path_xy, step_size):
    """Densify a piecewise-linear (x, y) path at ``step_size`` spacing.

    Equivalent of ``a_star.interpolate`` (src/a_star.py:149-187, unused in
    the reference's main flow but part of its public surface): vertical
    segments are sampled along y (descending segments keep the travel
    direction); all other segments are sampled along x with linear
    interpolation of y. Segment endpoints are excluded (the next segment
    supplies them); the final goal point is appended.
    """
    path = np.asarray(path_xy, dtype=float)
    out = []
    for i in range(len(path) - 1):
        (x1, y1), (x2, y2) = path[i], path[i + 1]
        if x2 == x1:
            if y1 > y2:
                ys = np.flip(np.arange(y2, y1, step_size))
            else:
                ys = np.arange(y1, y2, step_size)
            out.extend([x1, y] for y in ys)
        else:
            xs = np.arange(x1, x2, step_size) if x1 < x2 else np.flip(
                np.arange(x2, x1, step_size))
            t = (xs - x1) / (x2 - x1)
            out.extend([x, y1 + ti * (y2 - y1)] for x, ti in zip(xs, t))
    out.append([path[-1][0], path[-1][1]])
    return out


def reference_path_for(grid, start_pose, goal_pose, native=False):
    """Full front-end: A* + reverse + headings -> (3, L) float64 array.

    start/goal poses are (x, y, theta); grid indexing is [y][x] so the
    search runs on (row=y, col=x) exactly like ``src/closed_loop.py:23-24``.
    ``native=True`` runs the C++ search (:mod:`..native`, built with g++
    on first use; a failed build raises): the same optimal cost, possibly
    another path among equal-cost ones, so the default is the
    reference-exact Python search, which parity relies on.
    """
    start_yx = (int(start_pose[1]), int(start_pose[0]))
    goal_yx = (int(goal_pose[1]), int(goal_pose[0]))
    if native:
        from ..native import astar_solve_native

        cells = astar_solve_native(grid, start_yx, goal_yx)
        # the native path includes the start cell; the reference's excludes
        # it (src/a_star.py:58-65)
        route = None if cells is None else [tuple(c) for c in cells[:-1]]
    else:
        route = solve_grid_astar(np.asarray(grid), start_yx, goal_yx)
    if route is None:
        raise ValueError("A*: goal unreachable from start")
    ref = add_headings(path_goal_to_xy(route))
    return np.asarray(ref, dtype=np.float64).T
