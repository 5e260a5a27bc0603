"""Euclidean distance between the ego's box and an obstacle, in numpy.

An obstacle is ``{y : A y <= b}`` over its real hyperplanes (a closed
polygon's edges, or an open polyline's: a wall is a half-plane). It is
clipped to a box far larger than any map, so that every obstacle is a
convex polygon; the distance between two convex polygons is the least
vertex-to-edge distance when a separating axis exists, and minus the
least overlap along the axes when none does.
"""

from __future__ import annotations

import numpy as np

FAR = 1e3


def clip_polygon(A, b, mask):
    """Vertices (V, 2) of ``{A y <= b}`` over the rows ``mask`` selects,
    inside the box [-FAR, FAR]^2 (Sutherland-Hodgman)."""
    poly = [(-FAR, -FAR), (-FAR, FAR), (FAR, FAR), (FAR, -FAR)]
    for a, c, m in zip(A, b, mask):
        if m <= 0:
            continue
        out = []
        n = len(poly)
        for i in range(n):
            p, q = np.asarray(poly[i]), np.asarray(poly[(i + 1) % n])
            fp, fq = a @ p - c, a @ q - c
            if fp <= 0:
                out.append(tuple(p))
            if (fp < 0 < fq) or (fq < 0 < fp):
                t = fp / (fp - fq)
                out.append(tuple(p + t * (q - p)))
        poly = out
        if not poly:
            break
    return np.asarray(poly, np.float64).reshape(-1, 2)


def pad(polys, V=None):
    """Stack polygons (lists of (v_i, 2)) into (n, V, 2) by repeating each
    one's last vertex (a repeated vertex adds no edge and no extent)."""
    V = V or max(len(p) for p in polys)
    out = np.zeros((len(polys), V, 2))
    for i, p in enumerate(polys):
        out[i, :len(p)] = p
        out[i, len(p):] = p[-1]
    return out


def ego_boxes(x, ego):
    """(..., 4, 2) corners of the ego at poses ``x`` (..., 3): length
    ``ego[0] + ego[2]`` along the heading, width ``ego[1] + ego[3]``,
    centred ``(ego[0] + ego[2]) / 2 - ego[2]`` ahead of the pose."""
    L, W = ego[0] + ego[2], ego[1] + ego[3]
    off = L / 2 - ego[2]
    c, s = np.cos(x[..., 2]), np.sin(x[..., 2])
    cx, cy = x[..., 0] + off * c, x[..., 1] + off * s
    corners = []
    for sl, sw in ((-1, 1), (1, 1), (1, -1), (-1, -1)):
        corners.append(np.stack([cx + sl * L / 2 * c - sw * W / 2 * s,
                                 cy + sl * L / 2 * s + sw * W / 2 * c], -1))
    return np.stack(corners, -2)


def _edges(P):
    Q = np.roll(P, -1, axis=-2)
    e = Q - P
    ln = np.linalg.norm(e, axis=-1)
    return P, Q, e, ln, ln > 1e-12


def _point_segment(p, a, b):
    """(...,) distance from points p to segments ab (all (..., 2))."""
    ab = b - a
    t = np.clip(((p - a) * ab).sum(-1) / np.maximum((ab * ab).sum(-1), 1e-300), 0.0, 1.0)
    return np.linalg.norm(a + t[..., None] * ab - p, axis=-1)


def distance(P, Q):
    """(n,) signed distance between convex polygons P (n, U, 2) and Q (n,
    V, 2): the gap when apart, minus the least overlap along the edge
    normals when they meet."""
    gaps = []
    for A, B in ((P, Q), (Q, P)):
        _, _, e, ln, ok = _edges(A)
        nrm = np.stack([e[..., 1], -e[..., 0]], -1) / np.maximum(ln, 1e-300)[..., None]
        pa = np.einsum("nkd,nvd->nkv", nrm, A)
        pb = np.einsum("nkd,nvd->nkv", nrm, B)
        g = np.maximum(pb.min(-1) - pa.max(-1), pa.min(-1) - pb.max(-1))
        gaps.append(np.where(ok, g, -np.inf).max(-1))
    sep = np.maximum(*gaps)
    d = []
    for A, B in ((P, Q), (Q, P)):
        b0, b1, _, _, ok = _edges(B)
        dd = _point_segment(A[:, :, None, :], b0[:, None], b1[:, None])
        d.append(np.where(ok[:, None, :], dd, np.inf).min((-1, -2)))
    return np.where(sep > 0, np.minimum(*d), sep)
