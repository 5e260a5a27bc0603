"""The named demo worlds, transcribed as plain data (numpy only).

A copy of the JAX package's ``scenarios/demos.py``: importing that module
runs the JAX package's ``__init__`` (which imports jax), so the port keeps
its own copy and ``tests/test_torch_world.py`` holds the two equal.

Source of truth: ``src/demo_setting.py:82-341`` in the reference (map bounds,
start/goal, static obstacle polylines for the NLP, closed grid rectangles for
rasterization, dynamic obstacle specs, terminal sets), plus the per-demo
recommended closed-loop tunings documented at ``src/simulation.py:66-99`` and
the defaults at ``src/closed_loop.py:32-104``.

Two intentionally distinct obstacle representations: ``static_lobs`` are
open polylines used for the OBCA H-rep (walls with zero thickness) while
``grid_rects`` are closed rectangles rasterized for the A* occupancy grid.

Dynamic obstacle spec is the reference's 11-tuple
(``src/demo_setting.py:379-384``):
  [cx, cy, theta, length, width, v, end_cx, end_cy, end_theta,
   start_time, end_time]
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

PI = math.pi

XY = Tuple[float, float]
Polyline = Tuple[XY, ...]


@dataclasses.dataclass(frozen=True)
class TerminalPolicy:
    """Terminal-set schedule used during fix-time closed-loop replans.

    The closed-loop driver rebuilds the terminal set each step as
    ``bounds[i][j] = base[i][j] + x0[rel[i][j]]`` with ``rel = -1`` meaning
    absolute. The reference hardcodes demo1's policy at
    ``src/closed_loop.py:371`` (lower-x = x0[0] + 5); the per-demo policies
    come from the ``run_closedLoop`` docstring (``src/simulation.py:66-99``).
    """

    base: Tuple[Tuple[float, float], Tuple[float, float]]
    rel: Tuple[Tuple[int, int], Tuple[int, int]] = ((-1, -1), (-1, -1))

    def resolve(self, x0):
        out = np.array(self.base, dtype=np.float64)
        for i in range(2):
            for j in range(2):
                r = self.rel[i][j]
                if r >= 0:
                    out[i, j] += float(x0[r])
        return out


@dataclasses.dataclass(frozen=True)
class MPCParams:
    """Solver tunables; defaults from ``src/closed_loop.py:32-104``."""

    Ts: float = 0.1
    # free-time mode (src/closed_loop.py:77-84)
    q_free: float = 0.1
    r1_free: float = 0.01
    r2_free: float = 0.1
    N_free: int = 6
    # fix-time mode (src/closed_loop.py:94-101)
    q_fix: float = 0.001
    r1_fix: float = 0.01
    r2_fix: float = 1.0
    N_fix: int = 6
    # shared bounds (src/closed_loop.py:39-42)
    v_max: float = 0.6
    w_max: float = PI / 6
    a_max: float = 0.6       # hardcoded accel bounds, src/obca.py:932-933
    alpha_max: float = PI / 6
    # ego vehicle & clearance (src/closed_loop.py:63-64)
    ego: Tuple[float, float, float, float] = (1.7, 0.75, 1.7, 0.75)
    dmin: float = 0.05
    # time-cost coefficients: sum_t c1*T + c2*T^2 (src/obca.py:887-888)
    time_c1: float = 10.0
    time_c2: float = 1.0


@dataclasses.dataclass(frozen=True)
class DemoSpec:
    name: str
    x_lo: XY
    x_hi: XY
    start: Tuple[float, float, float]
    goal: Tuple[float, float, float]
    static_lobs: Tuple[Polyline, ...]
    grid_rects: Tuple[Polyline, ...]
    dyn_obs_info: Tuple[Tuple[float, ...], ...]
    terminal_set: Tuple[Tuple[float, float], Tuple[float, float]]
    terminal_policy: TerminalPolicy = TerminalPolicy(((5.0, 99.0), (1.0, 9.0)), ((0, -1), (-1, -1)))
    sense_dis: float = 10.0  # src/demo_setting.py:70
    params: MPCParams = MPCParams()
    resolution: float = 1.0  # src/demo_setting.py:66

    @property
    def map_size(self):
        # src/demo_setting.py:86: [x-extent, y-extent]
        return (
            self.x_hi[0] - self.x_lo[0] + 1,
            self.x_hi[1] - self.x_lo[1] + 1,
        )


def _corridor_lobs(xu: XY):
    """The standard two-wall corridor polylines used by most demos."""
    return (
        (((xu[0], xu[1] - 1), (0, xu[1] - 1))),
        ((0, 1), (xu[0], 1)),
    )


def _corridor_rects(xu: XY):
    return (
        ((xu[0], xu[1] - 1), (0, xu[1] - 1), (0, xu[1]), (xu[0], xu[1])),
        ((0, 1), (xu[0], 1), (xu[0], 0), (0, 0)),
    )


def _corridor_with_block(xu: XY, block: Polyline):
    lobs = (
        ((xu[0], xu[1] - 1), (0, xu[1] - 1)),
        tuple(block),
        ((0, 1), (xu[0], 1)),
    )
    rects = (
        ((xu[0], xu[1] - 1), (0, xu[1] - 1), (0, xu[1]), (xu[0], xu[1])),
        tuple(block),
        ((0, 1), (xu[0], 1), (xu[0], 0), (0, 0)),
    )
    return lobs, rects


_BLOCK_10_15 = ((10, 1), (10, 5), (15, 5), (15, 1), (10, 1))
_BLOCK_20_25 = ((25, 8), (25, 3), (20, 3), (20, 8), (25, 8))

_D1_LOBS, _D1_RECTS = _corridor_with_block((39, 10), _BLOCK_10_15)
_D2_LOBS, _D2_RECTS = _corridor_with_block((39, 10), _BLOCK_20_25)


def _mk(name, xu, start, goal, lobs, rects, dyn, tset, **kw):
    return DemoSpec(
        name=name,
        x_lo=(0.0, 0.0),
        x_hi=(float(xu[0]), float(xu[1])),
        start=tuple(float(v) for v in start),
        goal=tuple(float(v) for v in goal),
        static_lobs=tuple(tuple(tuple(float(c) for c in v) for v in o) for o in lobs),
        grid_rects=tuple(tuple(tuple(float(c) for c in v) for v in o) for o in rects),
        dyn_obs_info=tuple(tuple(float(v) for v in row) for row in dyn),
        terminal_set=((float(tset[0][0]), float(tset[0][1])), (float(tset[1][0]), float(tset[1][1]))),
        **kw,
    )


DEMOS = {
    # src/demo_setting.py:82-105
    "demo1": _mk(
        "demo1", (39, 10), (3, 4, 0), (38, 4, 0), _D1_LOBS, _D1_RECTS,
        [(22.5, 0, PI / 2, 3, 3, 0.2, 22.5, 9, PI / 2, 0, 55)],
        ((25, 39), (1, 9)),
        terminal_policy=TerminalPolicy(((5.0, 99.0), (1.0, 9.0)), ((0, -1), (-1, -1))),
    ),
    # :107-129
    "demo2": _mk(
        "demo2", (39, 10), (3, 4, 0), (38, 4, 0), _D2_LOBS, _D2_RECTS,
        [(18.5, 0, PI / 2, 3, 3, 0.2, 18.5, 9, PI / 2, 0, 55)],
        ((25, 39), (1, 9)),
    ),
    # :131-153
    "demo3": _mk(
        "demo3", (39, 10), (3, 4, 0), (38, 4, 0), _D2_LOBS, _D2_RECTS,
        [(18.5, 0, PI / 2, 3, 3, 0.15, 18.5, 9, PI / 2, 0, 55)],
        ((25, 39), (1, 9)),
    ),
    # :155-177
    "demo4": _mk(
        "demo4", (39, 10), (3, 4, 0), (38, 4, 0), _D2_LOBS, _D2_RECTS,
        [(18.5, 0, PI / 2, 3, 3, 0.1, 18.5, 9, PI / 2, 0, 55)],
        ((25, 39), (1, 9)),
    ),
    # :179-202
    "demo5": _mk(
        "demo5", (39, 10), (3, 4, 0), (38, 4, 0), _D1_LOBS, _D1_RECTS,
        [(22.5, 0, PI / 2, 3, 3, 0.1, 22.5, 9, PI / 2, 0, 55)],
        ((25, 39), (1, 9)),
    ),
    # :204-224
    "demo6": _mk(
        "demo6", (39, 10), (3, 4, 0), (38, 4, 0),
        _corridor_lobs((39, 10)), _corridor_rects((39, 10)),
        [(13.5, 0, PI / 2, 3, 3, 0.2, 13.5, 9, PI / 2, 0, 100),
         (22.5, 0, PI / 2, 3, 3, 0.1, 22.5, 9, PI / 2, 0, 200)],
        ((25, 39), (1, 9)),
    ),
    # :226-246
    "demo7": _mk(
        "demo7", (39, 10), (3, 4, 0), (38, 4, 0),
        _corridor_lobs((39, 10)), _corridor_rects((39, 10)),
        [(13.5, 0, PI / 2, 3, 3, 0.1, 13.5, 9, PI / 2, 0, 100),
         (22.5, 0, PI / 2, 3, 3, 0.05, 22.5, 9, PI / 2, 0, 200)],
        ((28, 39), (1, 9)),
    ),
    # :321-341; recommended tuning src/simulation.py:85-91
    "demo8": _mk(
        "demo8", (39, 10), (3, 4, 0), (38, 4, 0),
        _corridor_lobs((39, 10)), _corridor_rects((39, 10)),
        [(13.5, 0, PI / 2, 3, 3, 0.1, 13.5, 9, PI / 2, 0, 100),
         (22.5, 9, -PI / 2, 3, 3, 0.1, 22.5, 0, -PI / 2, 0, 200)],
        ((25, 39), (2, 6)),
        terminal_policy=TerminalPolicy(((6.0, 99.0), (1.0, 9.0)), ((0, -1), (-1, -1))),
        sense_dis=12.0,
        params=MPCParams(N_free=15, N_fix=15),
    ),
    # :270-297; recommended tuning src/simulation.py:68-74
    "demo9": _mk(
        "demo9", (40, 60), (1, 5, 0), (37, 58, PI / 2),
        (
            ((8, 0), (8, 6), (40, 6)),
            ((12, 30), (34, 30), (34, 14), (12, 14), (12, 30)),
            ((13, 49), (34, 49), (34, 34), (13, 34), (13, 49)),
            ((4, 60), (4, 10), (0, 10)),
            ((33, 60), (33, 55), (4, 55)),
        ),
        (
            ((8, 6), (40, 6), (40, 0), (8, 0)),
            ((12, 30), (34, 30), (34, 14), (12, 14)),
            ((12, 50), (34, 50), (34, 34), (12, 34)),
            ((0, 60), (4, 60), (4, 10), (0, 10)),
            ((4, 60), (34, 60), (34, 54), (4, 54)),
        ),
        [(8, 50, -PI / 2, 2, 2, 0.5, 8, 10, -PI / 2, 0, 100)],
        ((34, 40), (54, 60)),
        terminal_policy=TerminalPolicy(((5.0, 30.0), (4.0, 60.0)), ((-1, -1), (1, -1))),
        sense_dis=8.0,
        params=MPCParams(q_free=0.5, N_free=5, N_fix=5),
    ),
    # :299-319; recommended tuning src/simulation.py:76-83
    "demo10": _mk(
        "demo10", (99, 10), (3, 4, 0), (98, 4, 0),
        _corridor_lobs((99, 10)), _corridor_rects((99, 10)),
        [(99, 5, -PI, 3, 3, 0.5, 0, 5, -PI, 0, 100)],
        ((60, 99), (1, 9)),
        terminal_policy=TerminalPolicy(((6.0, 99.0), (1.0, 9.0)), ((0, -1), (-1, -1))),
        sense_dis=12.0,
        params=MPCParams(N_free=15, N_fix=15),
    ),
    # :248-268
    "demo11": _mk(
        "demo11", (80, 10), (3, 4, 0), (77, 4, 0),
        _corridor_lobs((80, 10)), _corridor_rects((80, 10)),
        [(30.5, 0, PI / 2, 3, 3, 0.1, 30.5, 9, PI / 2, 0, 100),
         (39.5, 9, -PI / 2, 3, 3, 0.1, 39.5, 0, -PI / 2, 0, 200)],
        ((25, 39), (2, 6)),
    ),
}


def demo_names():
    return sorted(DEMOS.keys(), key=lambda n: int(n[4:]))


def get_demo(name: str) -> DemoSpec:
    return DEMOS[name]


def default_params_for(name: str) -> MPCParams:
    return DEMOS[name].params
