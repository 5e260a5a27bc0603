"""Occupancy-grid rasterization of rectangular obstacles.

PyTorch counterpart of the JAX package's ``ops/rasterize.py``. Reference
semantics (``src/model_map.py:21-101``): each obstacle polygon is reduced
to its bounding box, scaled by the map resolution, and every covered cell
[floor(y_min) .. floor(y_min) + floor(y_max - y_min)] x
[floor(x_min) .. floor(x_min) + floor(x_max - x_min)] (inclusive) is
marked 1. Grid shape is (rows, cols) = (y-extent, x-extent). Disk
dilation and erosion of a grid (``src/model_map.py:103-113``) are a max
or min over shifted copies.
"""

from __future__ import annotations

import torch


def grid_shape(map_size, resolution=1.0):
    """(rows, cols) of the occupancy grid, per ``src/model_map.py:17``.

    map_size = [x_extent, y_extent] = [xU0 - xL0 + 1, xU1 - xL1 + 1].
    """
    rows = int((map_size[1] - 1) / resolution) + 1
    cols = int((map_size[0] - 1) / resolution) + 1
    return rows, cols


def rects_to_grid(bboxes, rect_mask, rows, cols, resolution=1.0):
    """Rasterize (nR, 4) [x_min, y_min, x_max, y_max] boxes (``rect_mask``
    1.0 for real rectangles) into a (rows, cols) 0/1 grid, row index = y."""
    x0 = torch.floor(bboxes[:, 0] / resolution)
    y0 = torch.floor(bboxes[:, 1] / resolution)
    # inclusive span, truncated like int() in src/model_map.py:45-46
    x1 = x0 + torch.floor((bboxes[:, 2] - bboxes[:, 0]) / resolution)
    y1 = y0 + torch.floor((bboxes[:, 3] - bboxes[:, 1]) / resolution)

    cy = torch.arange(rows, dtype=bboxes.dtype, device=bboxes.device)[:, None, None]
    cx = torch.arange(cols, dtype=bboxes.dtype, device=bboxes.device)[None, :, None]
    inside = ((cx >= x0) & (cx <= x1) & (cy >= y0) & (cy <= y1)
              & (rect_mask > 0))
    return inside.any(dim=-1).to(bboxes.dtype)


def polygon_bboxes(verts):
    """Min/max bbox of each padded polygon (nR, V, 2) -> (nR, 4)
    [x_min, y_min, x_max, y_max]; padding repeats a vertex, harmless."""
    return torch.stack([verts[..., 0].amin(-1), verts[..., 1].amin(-1),
                        verts[..., 0].amax(-1), verts[..., 1].amax(-1)],
                       dim=-1)


def _disk_offsets(radius: int):
    """(dy, dx) offsets of a discrete disk of ``radius`` (the footprint of
    ``skimage.morphology.disk``, ``src/model_map.py:103-113``)."""
    return [(dy, dx) for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1) if dx * dx + dy * dy <= radius * radius]


def _shifted(grid, level, init, op):
    """``op`` over the disk-shifted copies of ``grid`` (..., rows, cols),
    cells outside the map counting as free (0)."""
    r, c = grid.shape[-2], grid.shape[-1]
    g = torch.nn.functional.pad(grid, (level, level, level, level), value=0.0)
    out = torch.full_like(grid, init)
    for dy, dx in _disk_offsets(level):
        out = op(out, g[..., level + dy:level + dy + r, level + dx:level + dx + c])
    return out


def dilate_grid(grid, level: int):
    """Morphological dilation of a 0/1 grid with a disk of radius
    ``level`` (``mapModel.dilate_map``, ``src/model_map.py:103``)."""
    if level <= 0:
        return grid
    return _shifted(grid, level, 0.0, torch.maximum)


def erode_grid(grid, level: int):
    """Morphological erosion with a disk of radius ``level``
    (``mapModel.erode_map``, ``src/model_map.py:109``)."""
    if level <= 0:
        return grid
    return _shifted(grid, level, 1.0, torch.minimum)
