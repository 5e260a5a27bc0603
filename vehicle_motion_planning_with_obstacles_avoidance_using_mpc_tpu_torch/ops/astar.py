"""Batched grid shortest paths: the wavefront A* front-end.

PyTorch counterpart of the JAX package's ``ops/astar.py``. The reference
runs a heap-based 8-connected A* on the occupancy grid
(``src/a_star.py:39-102``); the wavefront form relaxes the cost-to-go
field as a dense 8-neighbour min-plus stencil to a fixed point, batched
over maps (B, rows, cols), then walks a greedy steepest descent.

Conventions match the reference: grids are indexed [y][x], 1 = blocked;
moves are the 8 neighbours with Euclidean step costs (1 or sqrt(2));
diagonal corner-cutting is allowed.

:func:`cost_to_go` and :func:`extract_path` launch the hand-written kernels
of ``kernels/csrc/astar_wavefront.cu`` on CUDA tensors and run their plain
versions (:func:`cost_to_go_plain`, :func:`extract_path_plain`) on CPU
tensors. The two give the same bits: every field value is the same float
additions and exact ``min`` in the same relaxation order.
"""

from __future__ import annotations

import math

import torch

from .. import kernels

_INF = 1e9
# (dy, dx) neighbour offsets in the reference's iteration order
# (src/a_star.py:20) -- the order matters only for tie-breaking during
# greedy path extraction.
_OFFS = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1))


def field_dtype(grid):
    """The cost field's dtype: the grid's, at least float32."""
    return torch.promote_types(grid.dtype, torch.float32)


def default_max_iters(grid):
    """The relaxation bound of ``ops/astar.py``: 2 * (rows + cols)."""
    return 2 * (grid.shape[-2] + grid.shape[-1])


def _shift_pad(field, dy, dx, fill):
    """out[..., y, x] = field[..., y - dy, x - dx], ``fill`` outside."""
    out = torch.full_like(field, fill)
    R, C = field.shape[-2:]
    out[..., max(dy, 0):R + min(dy, 0), max(dx, 0):C + min(dx, 0)] = \
        field[..., max(-dy, 0):R + min(-dy, 0), max(-dx, 0):C + min(-dx, 0)]
    return out


def cost_to_go_plain(grid, goal_yx, max_iters=None):
    """Plain PyTorch version: ``(field (B, rows, cols), relaxations (B,)
    int32)``. Each map relaxes until no cell changes or after
    ``max_iters`` further relaxations (``ops/astar.py:72-88``: the loop
    body runs while ``it < max_iters`` and the last relaxation changed a
    cell); a map that is done stays frozen while others go on."""
    B, R, C = grid.shape
    dev = grid.device
    if max_iters is None:
        max_iters = default_max_iters(grid)
    dtype = field_dtype(grid)
    blocked = grid > 0.5
    goal = goal_yx.to(device=dev, dtype=torch.long)
    ys = torch.arange(R, device=dev)[None, :, None]
    xs = torch.arange(C, device=dev)[None, None, :]
    at_goal = (ys == goal[:, 0, None, None]) & (xs == goal[:, 1, None, None])
    inf = torch.full((), _INF, dtype=dtype, device=dev)
    d0 = torch.where(at_goal, torch.zeros((), dtype=dtype, device=dev), inf)
    d0 = torch.where(blocked, inf, d0)
    one = torch.ones((), dtype=dtype, device=dev)
    # correctly rounded in the field's dtype (torch.sqrt of a float64
    # scalar on the CPU is not: 1.414213562373095)
    sqrt2 = torch.full((), math.sqrt(2.0), dtype=dtype, device=dev)

    def relax(d):
        best = d
        for dy, dx in _OFFS:
            step = sqrt2 if (dy != 0 and dx != 0) else one
            best = torch.minimum(best, _shift_pad(d, dy, dx, _INF) + step)
        return torch.where(blocked, inf, best)

    prev, d = d0, relax(d0)
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    while True:
        active = (it < max_iters) & (d != prev).flatten(1).any(1)
        if not bool(active.any()):
            return d, it + 1
        nxt = relax(d)
        a = active[:, None, None]
        prev, d = torch.where(a, d, prev), torch.where(a, nxt, d)
        it = it + active.to(torch.int32)


def cost_to_go(grid, goal_yx, max_iters=None, impl=None):
    """Optimal 8-connected cost-to-go field of every map.

    Args:
      grid: (B, rows, cols), 1.0 = blocked.
      goal_yx: (B, 2) int [row, col].
      max_iters: relaxation bound; default 2 * (rows + cols).

    Returns the (B, rows, cols) field in :func:`field_dtype`; blocked and
    unreachable cells hold ~1e9.
    """
    if max_iters is None:
        max_iters = default_max_iters(grid)
    if kernels.runs_plain(grid, impl):
        return cost_to_go_plain(grid, goal_yx, max_iters)[0]
    g = grid.to(field_dtype(grid)).contiguous()
    return kernels.astar_cost_to_go(g, goal_yx.to(torch.int32).contiguous(), max_iters)[0]


def extract_path_plain(dfield, start_yx, max_len):
    """Plain PyTorch version of :func:`extract_path`."""
    B, R, C = dfield.shape
    dev = dfield.device
    flat = dfield.reshape(B, R * C)
    rows = torch.arange(B, device=dev)
    y = start_yx[:, 0].to(device=dev, dtype=torch.long).clamp(0, R - 1)
    x = start_yx[:, 1].to(device=dev, dtype=torch.long).clamp(0, C - 1)
    inf = torch.full((B,), _INF, dtype=dfield.dtype, device=dev)
    traj, d_along = [], []
    for _ in range(max_len):
        d_here = flat[rows, y * C + x]
        best_d, by, bx = d_here, y, x
        for dy, dx in _OFFS:
            ny = (y + dy).clamp(0, R - 1)
            nx = (x + dx).clamp(0, C - 1)
            inb = (y + dy == ny) & (x + dx == nx)
            cand = torch.where(inb, flat[rows, ny * C + nx], inf)
            better = cand < best_d
            best_d = torch.where(better, cand, best_d)
            by = torch.where(better, ny, by)
            bx = torch.where(better, nx, bx)
        at_goal = d_here <= 0.0
        y = torch.where(at_goal, y, by)
        x = torch.where(at_goal, x, bx)
        traj.append(torch.stack([y, x], dim=1))
        d_along.append(flat[rows, y * C + x])
    path = torch.stack(traj, dim=1).to(torch.int32)
    reached = torch.cumsum((torch.stack(d_along, dim=1) <= 0.0).to(torch.int32), dim=1)
    return path, reached <= 1


def extract_path(dfield, start_yx, max_len, impl=None):
    """Greedy steepest-descent path through the cost-to-go fields.

    Follows the reference's neighbour order for ties (strict ``<``; an
    out-of-bounds neighbour counts as 1e9). Returns (path (B, max_len, 2)
    int32 [row, col], valid (B, max_len) bool): the positions after each
    of ``max_len`` moves; once the goal (d <= 0) is reached the position
    repeats and is masked invalid after the first goal entry
    (``ops/astar.py:92-128``).
    """
    if kernels.runs_plain(dfield, impl):
        return extract_path_plain(dfield, start_yx, max_len)
    return kernels.astar_extract_path(dfield.contiguous(),
                                      start_yx.to(torch.int32).contiguous(), max_len)


def plan_grid_path(grid, start_yx, goal_yx, max_len, impl=None):
    """:func:`cost_to_go` then :func:`extract_path`, batched over maps."""
    d = cost_to_go(grid, goal_yx, impl=impl)
    return extract_path(d, start_yx, max_len, impl=impl)


def path_to_reference(path_xy, valid):
    """Append headings: (B, L, 2) float path -> (B, L, 3) [x, y, theta].

    theta_i = atan2(dy, dx) to the next point where that point is valid;
    otherwise the last such heading carries on (0 before the first), as
    the scan of ``ops/astar.py:138-157``.
    """
    B, L, _ = path_xy.shape
    nxt = torch.cat([path_xy[:, 1:], path_xy[:, -1:]], dim=1)
    nxt_valid = torch.cat([valid[:, 1:], torch.zeros_like(valid[:, :1])], dim=1)
    theta_raw = torch.atan2(nxt[..., 1] - path_xy[..., 1], nxt[..., 0] - path_xy[..., 0])
    idx = torch.arange(L, device=path_xy.device).expand(B, L)
    last = torch.cummax(torch.where(nxt_valid, idx, torch.full_like(idx, -1)), dim=1).values
    theta = torch.where(last >= 0, torch.gather(theta_raw, 1, last.clamp(min=0)),
                        torch.zeros_like(theta_raw))
    return torch.cat([path_xy, theta[..., None]], dim=-1)
