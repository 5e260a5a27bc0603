"""Padded-tensor scenarios.

Converts a :class:`DemoSpec` (ragged Python data) into a :class:`Scenario`
of fixed-shape tensors, so that every demo of one :class:`ShapeSpec`
shares one problem shape. PyTorch counterpart of the JAX package's
``scenarios/build.py``; replaces the reference's ``problemSetting``
instance state (``src/demo_setting.py:11-70``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops import geometry, rasterize
from .demos import DemoSpec


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """Static padding shapes for one problem family."""

    n_static: int   # padded static obstacle count
    n_dyn: int      # padded dynamic obstacle count
    e_max: int      # padded hyperplanes (edges) per obstacle
    rows: int       # occupancy grid rows (y)
    cols: int       # occupancy grid cols (x)

    @property
    def n_obs(self):
        """Total padded obstacle slots in the NLP (static + dynamic)."""
        return self.n_static + self.n_dyn


class Scenario(NamedTuple):
    """One world as dense tensors."""

    x_lo: torch.Tensor        # (2,) map lower bounds
    x_hi: torch.Tensor        # (2,) map upper bounds
    start: torch.Tensor       # (3,) start pose
    goal: torch.Tensor        # (3,) goal pose
    sA: torch.Tensor          # (nS, E, 2) static obstacles, H-rep
    sb: torch.Tensor          # (nS, E)
    s_edge_mask: torch.Tensor  # (nS, E) 1.0 = real hyperplane
    s_mask: torch.Tensor      # (nS,) 1.0 = real obstacle
    dA: torch.Tensor          # (nD, E, 2) dynamic obstacles at spawn
    db: torch.Tensor          # (nD, E)
    d_edge_mask: torch.Tensor  # (nD, E)
    d_mask: torch.Tensor      # (nD,)
    dyn_info: torch.Tensor    # (nD, 11) raw reference 11-tuples
    d_vel: torch.Tensor       # (nD, 2) v * [cos th, sin th]
    d_start_time: torch.Tensor  # (nD,) spawn step (info[9])
    terminal_set: torch.Tensor  # (2, 2) per-demo static set
    ts_base: torch.Tensor     # (2, 2) closed-loop policy base
    ts_rel: torch.Tensor      # (2, 2) int32: -1 absolute, else x0 index
    grid: torch.Tensor        # (rows, cols) occupancy, 1 = blocked
    sense_dis: torch.Tensor   # () lidar radius


def shape_spec_for(spec: DemoSpec, n_static=None, n_dyn=None, e_max=None,
                   rows=None, cols=None) -> ShapeSpec:
    ns = max(len(spec.static_lobs), n_static or 0)
    nd = max(len(spec.dyn_obs_info), n_dyn or 0)
    em = max(max(len(o) - 1 for o in spec.static_lobs), 4, e_max or 0)
    r, c = rasterize.grid_shape(spec.map_size, spec.resolution)
    return ShapeSpec(n_static=ns, n_dyn=nd, e_max=em,
                     rows=max(r, rows or 0), cols=max(c, cols or 0))


def build_scenario(spec: DemoSpec, shape: ShapeSpec | None = None,
                   dtype=torch.float32, device=torch.device("cuda")
                   ) -> tuple[Scenario, ShapeSpec]:
    """Build the dense :class:`Scenario` for one demo on ``device``.

    Geometry is computed in float64 on the host and cast once, so every
    dtype sees the same rounded hyperplanes.
    """
    if shape is None:
        shape = shape_spec_for(spec)
    ns, nd, em = shape.n_static, shape.n_dyn, shape.e_max
    v_max = em + 1
    f64 = torch.float64

    # static obstacles -> padded polylines -> H-rep
    s_verts = np.zeros((ns, v_max, 2))
    s_edge_mask = np.zeros((ns, em))
    s_mask = np.zeros((ns,))
    for i, poly in enumerate(spec.static_lobs):
        padded, nv = geometry.pad_polyline(np.asarray(poly), v_max)
        s_verts[i] = padded
        s_edge_mask[i, : nv - 1] = 1.0
        s_mask[i] = 1.0
    sA, sb = geometry.batched_hrep(torch.as_tensor(s_verts, dtype=f64),
                                   torch.as_tensor(s_edge_mask, dtype=f64))

    # dynamic obstacles: rectangle H-rep at the spawn pose
    d_verts = np.zeros((nd, 5, 2))
    d_edge_mask = np.zeros((nd, em))
    d_mask = np.zeros((nd,))
    dyn_info = np.zeros((nd, 11))
    d_vel = np.zeros((nd, 2))
    d_start = np.zeros((nd,))
    for i, row in enumerate(spec.dyn_obs_info):
        cx, cy, th, L, W = row[0], row[1], row[2], row[3], row[4]
        d_verts[i] = geometry.rect_vertices(cx, cy, th, L, W).numpy()
        d_edge_mask[i, :4] = 1.0
        d_mask[i] = 1.0
        dyn_info[i] = np.asarray(row)
        d_vel[i] = (row[5] * np.cos(th), row[5] * np.sin(th))
        d_start[i] = row[9]
    d_verts_p = np.zeros((nd, v_max, 2))
    d_verts_p[:, :5] = d_verts
    d_verts_p[:, 5:] = d_verts[:, -1:] if nd else 0.0
    dA, db = geometry.batched_hrep(torch.as_tensor(d_verts_p, dtype=f64),
                                   torch.as_tensor(d_edge_mask, dtype=f64))

    # occupancy grid from the closed grid rectangles
    n_rects = len(spec.grid_rects)
    rect_v = np.zeros((max(n_rects, 1), v_max, 2))
    rect_mask = np.zeros((max(n_rects, 1),))
    for i, poly in enumerate(spec.grid_rects):
        rect_v[i], _ = geometry.pad_polyline(np.asarray(poly), v_max)
        rect_mask[i] = 1.0
    bboxes = rasterize.polygon_bboxes(torch.as_tensor(rect_v, dtype=f64))
    grid = rasterize.rects_to_grid(bboxes, torch.as_tensor(rect_mask, dtype=f64),
                                   shape.rows, shape.cols, spec.resolution)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=f64).to(device=device,
                                                             dtype=dtype)

    scn = Scenario(
        x_lo=t(spec.x_lo), x_hi=t(spec.x_hi),
        start=t(spec.start), goal=t(spec.goal),
        sA=t(sA), sb=t(sb), s_edge_mask=t(s_edge_mask), s_mask=t(s_mask),
        dA=t(dA), db=t(db), d_edge_mask=t(d_edge_mask), d_mask=t(d_mask),
        dyn_info=t(dyn_info), d_vel=t(d_vel), d_start_time=t(d_start),
        terminal_set=t(spec.terminal_set),
        ts_base=t(spec.terminal_policy.base),
        ts_rel=torch.as_tensor(spec.terminal_policy.rel, dtype=torch.int32,
                               device=device),
        grid=t(grid), sense_dis=t(spec.sense_dis),
    )
    return scn, shape
