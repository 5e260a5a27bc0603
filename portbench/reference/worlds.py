"""The benchmark's worlds as plain data, and their geometry, in numpy.

Frozen copies, kept apart from the port so that the yardstick does not
move when the port does:

* a world as its configuration's file states it (``configs/<name>.json``
  ``world``: the reference repository's ``src/demo_setting.py`` demo, its
  map, obstacles, start, goal, terminal set and sensing radius);
* the randomized demo1 corridors of the port's ``scenarios/random_gen.py``
  (its ``np.random.default_rng`` draws, in the same order: one stream
  gives world after world, and its first B worlds are
  ``random_scenarios(seed, B)``'s);
* a polyline's hyperplanes (the reference's ``src/model_obstacle.py``
  edge cases), a rectangle's clockwise vertices and the occupancy grid
  rasterization of ``src/model_map.py``.

A world is a dict with the fields of the port's ``DemoSpec`` that the
benchmark uses; a new map is a new configuration file, never an edit here.
"""

from __future__ import annotations

import math

import numpy as np

def world_of(d):
    """A world from its configuration's ``world`` block (plain JSON: the
    fields above, lists for tuples), its tuples restored."""
    tup = lambda a: tuple(tup(v) for v in a) if isinstance(a, (list, tuple)) else a
    w = {k: tup(d[k]) for k in ("x_lo", "x_hi", "start", "goal", "static_lobs", "grid_rects",
                                "dyn_obs_info", "terminal_set", "ts_base", "ts_rel")}
    w["sense_dis"] = float(d["sense_dis"])
    return w


def corridor_world(rng, base):
    """The next randomized corridor of ``rng`` (``random_gen.py``'s draws
    for one world, in order, endpoints randomized)."""
    bx = float(rng.uniform(8.0, 26.0))
    bw = float(rng.uniform(3.0, 6.0))
    by0 = float(rng.choice([1.0, 3.0]))
    bh = float(rng.uniform(3.0, 5.0))
    block = ((bx, by0), (bx, by0 + bh), (bx + bw, by0 + bh), (bx + bw, by0), (bx, by0))
    xu = base["x_hi"]
    lobs = (((xu[0], xu[1] - 1), (0.0, xu[1] - 1)), block, ((0.0, 1.0), (xu[0], 1.0)))
    rects = (((xu[0], xu[1] - 1), (0.0, xu[1] - 1), (0.0, xu[1]), (xu[0], xu[1])), block,
             ((0.0, 1.0), (xu[0], 1.0), (xu[0], 0.0), (0.0, 0.0)))
    right_lo, right_hi = bx + bw + 4.0, xu[0] - 6.0
    if right_lo < right_hi:
        dcx = float(rng.uniform(right_lo, right_hi))
    else:
        dcx = float(rng.uniform(6.0, bx - 4.0))
    dv = float(rng.uniform(0.1, 0.3))
    dyn = ((dcx, 0.0, np.pi / 2, 3.0, 3.0, dv, dcx, 9.0, np.pi / 2, 0.0, 55.0),)
    start = (float(rng.uniform(1.0, max(bx - 4.0, 2.0))),
             float(rng.uniform(3.0, xu[1] - 3.0)), 0.0)
    goal = (float(rng.uniform(min(bx + bw + 4.0, xu[0] - 2.0), xu[0] - 1.0)),
            float(rng.uniform(3.0, xu[1] - 3.0)), 0.0)
    w = dict(base)
    w.update(start=start, goal=goal, static_lobs=lobs, grid_rects=rects, dyn_obs_info=dyn)
    return w


# ------------------------------------------------------------------ geometry

def rect_vertices(cx, cy, theta, length, width):
    """(5, 2) clockwise closed rectangle (src/demo_setting.py:405-429)."""
    c, s = math.cos(theta), math.sin(theta)
    hl, hw = length / 2.0, width / 2.0
    v1 = (cx - hl * c - hw * s, cy - hl * s + hw * c)
    v2 = (cx + hl * c - hw * s, cy + hl * s + hw * c)
    v3 = (cx + hl * c + hw * s, cy + hl * s - hw * c)
    v4 = (cx - hl * c + hw * s, cy - hl * s - hw * c)
    return np.array((v1, v2, v3, v4, v1), dtype=np.float64)


def polyline_hrep(verts, e_max):
    """Hyperplanes ``A y <= b`` of a polyline's edges (src/model_obstacle.py
    :63-89), padded with zero rows to ``e_max``: ``(A (e_max, 2), b
    (e_max,), edge_mask (e_max,))``."""
    v = np.asarray(verts, np.float64)
    A = np.zeros((e_max, 2))
    b = np.zeros(e_max)
    m = np.zeros(e_max)
    for j in range(len(v) - 1):
        (x1, y1), (x2, y2) = v[j], v[j + 1]
        if x2 - x1 == 0:
            sgn = 1.0 if y2 < y1 else -1.0
            A[j], b[j] = (sgn, 0.0), sgn * x1
        elif y2 - y1 == 0:
            sgn = 1.0 if x1 < x2 else -1.0
            A[j], b[j] = (0.0, sgn), sgn * y1
        else:
            a = (y2 - y1) / (x2 - x1)
            b0 = y1 - a * x1
            sgn = 1.0 if x2 - x1 > 0 else -1.0
            A[j], b[j] = (-a * sgn, sgn), sgn * b0
        m[j] = 1.0
    return A, b, m


def grid_shape(world):
    """(rows, cols) of the occupancy grid (src/model_map.py:17)."""
    return int(world["x_hi"][1] - world["x_lo"][1]) + 1, int(world["x_hi"][0] - world["x_lo"][0]) + 1


def occupancy_grid(world, shape=None):
    """(rows, cols) 0/1 grid, 1 = blocked: each grid rectangle's bounding
    box, cells floor(lo) .. floor(lo) + floor(hi - lo) inclusive
    (src/model_map.py:21-101)."""
    rows, cols = shape or grid_shape(world)
    g = np.zeros((rows, cols))
    for poly in world["grid_rects"]:
        p = np.asarray(poly)
        x0, y0 = math.floor(p[:, 0].min()), math.floor(p[:, 1].min())
        x1 = x0 + math.floor(p[:, 0].max() - p[:, 0].min())
        y1 = y0 + math.floor(p[:, 1].max() - p[:, 1].min())
        g[max(y0, 0):max(y1 + 1, 0), max(x0, 0):max(x1 + 1, 0)] = 1.0
    return g


def shape_of(world):
    """(n_static, n_dyn, e_max) of a world's NLP: one slot an obstacle,
    at least 4 hyperplanes an obstacle (``scenarios/build.py``)."""
    return (len(world["static_lobs"]), len(world["dyn_obs_info"]),
            max(max(len(o) - 1 for o in world["static_lobs"]), 4))


def obstacles(world, n_static, n_dyn, e_max):
    """The world's obstacles in the NLP's slot order (static, then
    dynamic at spawn): ``A (nO, E, 2)``, ``b (nO, E)``, ``edge_mask (nO,
    E)``, ``static_mask (nO,)`` (1 for a real static obstacle), and the
    dynamic ones' ``vel (n_dyn, 2)``, ``rect (n_dyn, 5)`` (cx, cy, theta,
    length, width at spawn), ``start_time (n_dyn,)`` and ``real (n_dyn,)``."""
    nO = n_static + n_dyn
    A = np.zeros((nO, e_max, 2))
    b = np.zeros((nO, e_max))
    em = np.zeros((nO, e_max))
    smask = np.zeros(nO)
    for i, poly in enumerate(world["static_lobs"]):
        A[i], b[i], em[i] = polyline_hrep(poly, e_max)
        smask[i] = 1.0
    vel = np.zeros((n_dyn, 2))
    rect = np.zeros((n_dyn, 5))
    t0 = np.zeros(n_dyn)
    real = np.zeros(n_dyn)
    for j, row in enumerate(world["dyn_obs_info"]):
        i = n_static + j
        A[i], b[i], em[i] = polyline_hrep(rect_vertices(*row[:5]), e_max)
        em[i, 4:] = 0.0
        vel[j] = (row[5] * math.cos(row[2]), row[5] * math.sin(row[2]))
        rect[j] = row[:5]
        t0[j] = row[9]
        real[j] = 1.0
    return {"A": A, "b": b, "edge_mask": em, "static_mask": smask, "vel": vel,
            "rect": rect, "start_time": t0, "real": real}
