"""Polytope geometry: rectangle vertices and half-space (H-rep) tensors.

PyTorch counterpart of the JAX package's ``ops/geometry.py``; the
reference semantics are the same:
  * rectangle -> 5 clockwise vertices: ``src/demo_setting.py:405-429``
  * polyline -> {x : A x <= b} hyperplanes with vertical / horizontal /
    general-slope edge cases: ``src/model_obstacle.py:37-102``
  * obstacle motion over the MPC horizon is a pure translation, so A is
    invariant and ``b_k = b + A @ (k * Ts * d)``.

Obstacles live in dense padded tensors ``A[..., nO, E, 2]``,
``b[..., nO, E]`` with an ``edge_mask[..., nO, E]``; every function here
takes arbitrary leading batch dimensions.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def rect_vertices(cx, cy, theta, length, width):
    """Clockwise closed rectangle vertices: a (5, 2) float64 tensor from
    floats, or (..., 5, 2) in their dtype from tensors of one shape.

    Order (``src/demo_setting.py:420-427``): left-bottom, left-top,
    right-top, right-bottom, left-bottom — "left/right" along the heading
    ``theta``, length measured along the moving direction.
    """
    batched = isinstance(theta, torch.Tensor)
    if batched:
        c, s = torch.cos(theta), torch.sin(theta)
    else:
        c, s = math.cos(theta), math.sin(theta)
    hl, hw = length / 2.0, width / 2.0
    v1 = (cx - hl * c - hw * s, cy - hl * s + hw * c)
    v2 = (cx + hl * c - hw * s, cy + hl * s + hw * c)
    v3 = (cx + hl * c + hw * s, cy + hl * s - hw * c)
    v4 = (cx - hl * c + hw * s, cy - hl * s - hw * c)
    vs = (v1, v2, v3, v4, v1)
    if batched:
        return torch.stack([torch.stack(v, dim=-1) for v in vs], dim=-2)
    return torch.tensor(vs, dtype=torch.float64)


def pad_polyline(verts, v_max):
    """Pad a (nv, 2) polyline to (v_max, 2) by repeating the last vertex
    (padded "edges" are degenerate and masked). Returns
    ``(padded_verts, n_vertices)`` as numpy."""
    verts = np.asarray(verts, dtype=np.float64)
    nv = verts.shape[0]
    if nv > v_max:
        raise ValueError(f"polyline has {nv} vertices > v_max={v_max}")
    pad = np.repeat(verts[-1:], v_max - nv, axis=0)
    return np.concatenate([verts, pad], axis=0), nv


def polygon_hrep(verts, edge_mask):
    """Hyperplanes of (padded) clockwise polylines.

    Args:
      verts: (..., V, 2); edge j joins verts[j] -> verts[j+1].
      edge_mask: (..., V-1) 1.0 for real edges, 0.0 for padding.

    Returns ``A (..., V-1, 2), b (..., V-1)`` with padded rows zeroed.
    Edge classification (``src/model_obstacle.py:63-89``):
      vertical   (x1 == x2): A = [sgn, 0],  b = sgn * x1,  sgn = +1 if y2 < y1
      horizontal (y1 == y2): A = [0, sgn],  b = sgn * y1,  sgn = +1 if x1 < x2
      general: slope a = dy/dx, intercept b0 = y1 - a*x1;
               A = [-a, 1], b = b0 if x1 < x2 else A = [a, -1], b = -b0
    """
    v1 = verts[..., :-1, :]
    v2 = verts[..., 1:, :]
    dx = v2[..., 0] - v1[..., 0]
    dy = v2[..., 1] - v1[..., 1]
    vertical = dx == 0
    horizontal = (~vertical) & (dy == 0)
    one = torch.ones_like(dx)

    sgn_v = torch.where(v2[..., 1] < v1[..., 1], one, -one)
    A_vert = torch.stack([sgn_v, torch.zeros_like(sgn_v)], dim=-1)
    b_vert = sgn_v * v1[..., 0]

    sgn_h = torch.where(v1[..., 0] < v2[..., 0], one, -one)
    A_horz = torch.stack([torch.zeros_like(sgn_h), sgn_h], dim=-1)
    b_horz = sgn_h * v1[..., 1]

    safe_dx = torch.where(vertical, one, dx)
    a = dy / safe_dx
    b0 = v1[..., 1] - a * v1[..., 0]
    sgn_g = torch.where(dx > 0, one, -one)
    A_gen = torch.stack([-a * sgn_g, sgn_g], dim=-1)
    b_gen = sgn_g * b0

    A = torch.where(vertical[..., None], A_vert,
                    torch.where(horizontal[..., None], A_horz, A_gen))
    b = torch.where(vertical, b_vert, torch.where(horizontal, b_horz, b_gen))
    m = edge_mask.to(A.dtype)
    return A * m[..., None], b * m


def batched_hrep(verts, edge_mask):
    """(nO, V, 2), (nO, E) -> (nO, E, 2), (nO, E): the obstacle axis is a
    plain batch dimension of :func:`polygon_hrep`."""
    if verts.dim() != 3:
        raise ValueError(f"expected (nO, V, 2) vertices, got {tuple(verts.shape)}")
    return polygon_hrep(verts, edge_mask)


def translate_hrep_b(A, b, delta):
    """b of the same polytope translated by ``delta``: A x <= b + A @ delta.

    A: (..., E, 2), b: (..., E), delta: (..., 2).
    """
    return b + torch.einsum("...ed,...d->...e", A, delta)


def replicate_hrep_over_horizon(A, b, vel_vec, N, Ts):
    """Time-replicated H-rep tensors for the MPC horizon: obstacle i at
    step k is the base polytope translated by ``k * Ts * vel_vec[i]``
    (``src/demo_setting.py:457-473``).

    Args:
      A: (..., nO, E, 2), b: (..., nO, E), vel_vec: (..., nO, 2).
      N: horizon; output covers k = 0..N.
      Ts: prediction sampling time, a float or a tensor of the leading
        batch shape.

    Returns ``A_t (..., N+1, nO, E, 2)`` and ``b_t (..., N+1, nO, E)``.
    """
    lead = b.shape[:-2]
    ks = torch.arange(N + 1, dtype=b.dtype, device=b.device)
    Ts = torch.as_tensor(Ts, dtype=b.dtype, device=b.device)
    kTs = ks * Ts[..., None]                                  # (..., N+1)
    deltas = kTs[..., :, None, None] * vel_vec[..., None, :, :]  # (..., N+1, nO, 2)
    b_t = translate_hrep_b(A[..., None, :, :, :], b[..., None, :, :], deltas)
    A_t = A[..., None, :, :, :].expand(lead + (N + 1,) + A.shape[-3:])
    return A_t, b_t
