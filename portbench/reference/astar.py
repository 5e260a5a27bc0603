"""Grid shortest paths in plain Python and numpy.

``reference_path`` is a frozen copy of the port's host A*
(``runtime/astar_host.py``: the reference repository's ``src/a_star.py``
search order, tie-breaks and headings); the benchmark makes demo9's
reference path with it, and hands the same path to the program and to
the checks.

``exact_cost_to_go`` is the optimal 8-connected cost-to-go of every cell
as integer pairs ``(straight moves, diagonal moves)``: a cost ``a + b
sqrt(2)`` names its pair uniquely, so a path is optimal exactly when its
moves' pairs add up to the pair its start cell holds, with no rounding
anywhere. ``check_path`` holds a program's grid path to it.
"""

from __future__ import annotations

import heapq
import math

import numpy as np

_NEIGHBORS = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1))
SQRT2 = math.sqrt(2.0)


def solve_grid_astar(grid, start_yx, goal_yx):
    """The reference's A*: (row, col) cells from the goal back to the
    first cell after the start, or None when unreachable."""
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
    live = {start: 1}
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
            tentative = g[cur] + math.sqrt(dr * dr + dc * dc)
            if nb in closed and tentative >= g.get(nb, 0.0):
                continue
            if tentative < g.get(nb, 0.0) or live.get(nb, 0) <= 0:
                parent[nb] = cur
                g[nb] = tentative
                heapq.heappush(open_heap, (tentative + h(nb), nb))
                live[nb] = live.get(nb, 0) + 1
    return None


def reference_path(grid, start_pose, goal_pose):
    """(3, L) float64 [x, y, theta] from the start's successor to the goal
    (``reference_path_for``): cells searched as (row = y, col = x) of the
    poses truncated to ints, headings toward the next point, the last
    point keeping the one before."""
    route = solve_grid_astar(grid, (int(start_pose[1]), int(start_pose[0])),
                             (int(goal_pose[1]), int(goal_pose[0])))
    if route is None:
        raise ValueError("A*: goal unreachable from start")
    xy = [[c, r] for r, c in reversed(route)]
    out = []
    for i in range(len(xy) - 1):
        yaw = math.atan2(xy[i + 1][1] - xy[i][1], xy[i + 1][0] - xy[i][0])
        out.append([xy[i][0], xy[i][1], yaw])
    out.append([xy[-1][0], xy[-1][1], out[-1][2]])
    return np.asarray(out, dtype=np.float64).T


def exact_cost_to_go(grid, goal_yx):
    """(rows, cols, 2) int64 ``(straight, diagonal)`` moves of an optimal
    path from each cell to the goal; -1 where blocked or unreachable.
    Dijkstra keyed on the exact cost's float value (distinct pairs of
    small integers never share one)."""
    grid = np.asarray(grid)
    rows, cols = grid.shape
    out = np.full((rows, cols, 2), -1, np.int64)
    gy, gx = int(goal_yx[0]), int(goal_yx[1])
    if grid[gy, gx] == 1:
        return out
    heap = [(0.0, 0, 0, gy, gx)]
    while heap:
        _, a, b, y, x = heapq.heappop(heap)
        if out[y, x, 0] >= 0:
            continue
        out[y, x] = (a, b)
        for dy, dx in _NEIGHBORS:
            ny, nx = y + dy, x + dx
            if 0 <= ny < rows and 0 <= nx < cols and grid[ny, nx] != 1 and out[ny, nx, 0] < 0:
                na, nb = (a, b + 1) if dy and dx else (a + 1, b)
                heapq.heappush(heap, (na + nb * SQRT2, na, nb, ny, nx))
    return out


def check_path(ctg, start_yx, cells, n_valid):
    """Whether the program's grid path ``cells`` ((L, 2) [row, col], the
    positions after each move, the first ``n_valid`` real) is an optimal
    path's beginning from ``start_yx``: every move to a free 8-neighbour
    whose exact cost-to-go is the cell's less the move, and the goal
    reached within the path's length where the optimum allows. Returns a
    reason string, or None when it is."""
    y, x = int(start_yx[0]), int(start_yx[1])
    here = ctg[y, x]
    if here[0] < 0:
        return "start cell blocked or cut off"
    if n_valid < 1:
        return "no move"
    for i in range(n_valid):
        ny, nx = int(cells[i][0]), int(cells[i][1])
        dy, dx = ny - y, nx - x
        if max(abs(dy), abs(dx)) != 1:
            return f"move {i} is not to a neighbour"
        nxt = ctg[ny, nx]
        if nxt[0] < 0:
            return f"move {i} enters a blocked cell"
        step = (0, 1) if dy and dx else (1, 0)
        if (here[0] - step[0], here[1] - step[1]) != (nxt[0], nxt[1]):
            return f"move {i} leaves every optimal path"
        y, x, here = ny, nx, nxt
    at_goal = here[0] == 0 and here[1] == 0
    if not at_goal and n_valid < len(cells):
        return "the path stops short of the goal"
    return None


def path_headings(xy, n_valid):
    """(L,) headings of ``ops/astar.path_to_reference``: toward the next
    point where it is real, else the last such heading, 0 before the
    first."""
    L = len(xy)
    th = np.zeros(L)
    last = None
    for i in range(L):
        if i + 1 < n_valid:
            last = math.atan2(xy[i + 1][1] - xy[i][1], xy[i + 1][0] - xy[i][0])
        th[i] = 0.0 if last is None else last
    return th
