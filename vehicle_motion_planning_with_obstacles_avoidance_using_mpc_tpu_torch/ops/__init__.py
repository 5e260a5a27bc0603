"""Geometry and rasterization on tensors."""

from .geometry import (
    batched_hrep,
    pad_polyline,
    polygon_hrep,
    rect_vertices,
    replicate_hrep_over_horizon,
    translate_hrep_b,
)
from .rasterize import grid_shape, polygon_bboxes, rects_to_grid

__all__ = [
    "batched_hrep", "pad_polyline", "polygon_hrep", "rect_vertices",
    "replicate_hrep_over_horizon", "translate_hrep_b", "grid_shape",
    "polygon_bboxes", "rects_to_grid",
]
