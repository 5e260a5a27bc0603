"""numpy wrappers over the native A* library.

Paths come back as (L, 2) int32 (row, col) cells in goal->start order,
the start cell included, as the JAX package's ``native/astar_native.py``
gives them; an unreachable goal gives None.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .build import load_native_astar

_I32 = ctypes.POINTER(ctypes.c_int32)


def _grid(grid):
    return np.ascontiguousarray(np.asarray(grid) != 0, dtype=np.uint8)


def astar_solve_native(grid, start_yx, goal_yx):
    """One search on ``grid`` (nonzero = blocked): (L, 2) cells from goal
    to start, or None when the goal is unreachable."""
    lib = load_native_astar()
    g = _grid(grid)
    h, w = g.shape
    out = np.empty((h * w, 2), dtype=np.int32)
    n = lib.astar_solve(g.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
                        int(start_yx[0]), int(start_yx[1]), int(goal_yx[0]), int(goal_yx[1]),
                        out.ctypes.data_as(_I32), h * w)
    return None if n < 0 else out[:n].copy()


def astar_solve_batch_native(grid, starts_yx, goals_yx):
    """B searches on one grid: a list of (L_b, 2) cell arrays (None where a
    goal is unreachable)."""
    lib = load_native_astar()
    g = _grid(grid)
    h, w = g.shape
    starts = np.ascontiguousarray(starts_yx, dtype=np.int32)
    goals = np.ascontiguousarray(goals_yx, dtype=np.int32)
    b = starts.shape[0]
    out = np.empty((b, h * w, 2), dtype=np.int32)
    lens = np.empty(b, dtype=np.int32)
    lib.astar_solve_batch(g.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
                          starts.ctypes.data_as(_I32), goals.ctypes.data_as(_I32), b,
                          out.ctypes.data_as(_I32), h * w, lens.ctypes.data_as(_I32))
    return [out[i, : lens[i]].copy() if lens[i] >= 0 else None for i in range(b)]
