"""Geometry, rasterization, unicycle dynamics and the wavefront A* on
tensors."""

from . import astar

from .geometry import (
    batched_hrep,
    grid_obstacle_vertices,
    pad_polyline,
    polygon_hrep,
    rect_vertices,
    replicate_hrep_over_horizon,
    translate_hrep_b,
)
from .dynamics import unicycle_rollout, unicycle_step
from .rasterize import dilate_grid, erode_grid, grid_shape, polygon_bboxes, rects_to_grid

__all__ = [
    "batched_hrep", "grid_obstacle_vertices", "pad_polyline", "polygon_hrep", "rect_vertices",
    "replicate_hrep_over_horizon", "translate_hrep_b", "grid_shape",
    "polygon_bboxes", "rects_to_grid", "dilate_grid", "erode_grid",
    "unicycle_rollout", "unicycle_step", "astar",
]
