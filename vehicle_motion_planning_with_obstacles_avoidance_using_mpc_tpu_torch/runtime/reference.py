"""Reference-trajectory construction and windowing for the MPC.

PyTorch counterpart of the JAX package's ``runtime/reference.py``
(reference: ``src/closed_loop.py:502-587``). Every function takes an
optional leading batch dimension on its pose arguments.
"""

from __future__ import annotations

import torch


def window_reference(ref_traj, valid_len, x0, N):
    """Nearest-point window of the reference starting at the point closest
    to ``x0``; columns past the path end repeat the final point.

    ``ref_traj`` is one (3, L) path shared by every lane, with ``x0`` (3,)
    or (B, 3) and an int ``valid_len``, or one path per lane, (B, 3, L)
    with ``valid_len`` (B,) and ``x0`` (B, 3). Returns (3, N+1) or
    (B, 3, N+1). ``valid_len`` is the number of real columns in a padded
    path. Matches ``src/closed_loop.py:502-528`` including its clamp at
    ``L-1``. Ties in the distance go to the first index (``torch.argmin``
    and ``jnp.argmin`` agree on that).
    """
    L = ref_traj.shape[-1]
    dev = ref_traj.device
    per_lane = ref_traj.dim() == 3
    last = torch.as_tensor(valid_len, device=dev) - 1
    if per_lane:
        last = last[:, None]
    in_path = torch.arange(L, device=dev) <= last
    d2 = ((x0[..., 0, None] - ref_traj[..., 0, :]) ** 2
          + (x0[..., 1, None] - ref_traj[..., 1, :]) ** 2)      # (..., L)
    d2 = torch.where(in_path, d2, torch.full_like(d2, float("inf")))
    start_idx = torch.argmin(d2, dim=-1)                        # (...)
    cols = start_idx[..., None] + torch.arange(N + 1, device=dev)
    cols = torch.minimum(cols, last)
    if per_lane:
        return torch.gather(ref_traj, 2, cols[:, None, :].expand(-1, 3, -1))
    return ref_traj[:, cols].movedim(0, -2)


def start_goal_reference(x0, xF, N):
    """(3, N+1): column 0 = start, columns 1..N = goal
    (src/closed_loop.py:535-544)."""
    return torch.stack([x0] + [xF] * N, dim=-1)


def start_goal_smooth_reference(x0, xF, N):
    """Linear x/y interpolation with headings (src/closed_loop.py:545-553)."""
    ks = torch.arange(N + 1, dtype=x0.dtype, device=x0.device)
    xs = (xF[0] - x0[0]) / N * ks + x0[0]
    ys = (xF[1] - x0[1]) / N * ks + x0[1]
    th = torch.atan2(torch.diff(ys), torch.diff(xs))
    th = torch.cat([th, th[-1:]])
    return torch.stack([xs, ys, th], dim=0)


def reinterpolate_openloop(xref, N_free, N_fix):
    """Fix-time reference from the free-time plan (allAviable=1 semantics,
    src/closed_loop.py:570-587), over any leading batch dimensions.

    Splits each of the ``N_free`` segments of ``xref`` (..., 3, N_free+1)
    (only x/y used) into ``int(N_fix / N_free)`` linear sub-points
    (endpoint excluded), appends the final point, then recomputes every
    heading as ``atan2`` of the x/y differences; a zero-length segment
    gets heading 0 (unlike ``candidate_inits_traced``, which keeps the
    previous heading there), as in the JAX package.

    Returns (ref (..., 3, N_new+1), N_new) where
    ``N_new = N_free * int(N_fix / N_free)`` -- the caller must rescale
    ``Ts_opt *= N_free / N_new`` (src/closed_loop.py:586).
    """
    m = int(N_fix / N_free)
    if m < 1:
        raise ValueError("N_fix must be >= N_free")
    lead = xref.shape[:-2]
    fr = torch.arange(m, dtype=xref.dtype, device=xref.device) / m

    def sub(row):
        seg = (xref[..., row, :N_free, None] * (1 - fr)
               + xref[..., row, 1:N_free + 1, None] * fr)
        return torch.cat([seg.reshape(lead + (N_free * m,)),
                          xref[..., row, N_free:N_free + 1]], dim=-1)

    xs, ys = sub(0), sub(1)
    th = torch.atan2(torch.diff(ys, dim=-1), torch.diff(xs, dim=-1))
    th = torch.cat([th, th[..., -1:]], dim=-1)
    return torch.stack([xs, ys, th], dim=-2), N_free * m


def splice_previous_plan(xref, x_prev, n_cols):
    """Overwrite the first ``n_cols`` columns of the window (..., 3, N+1)
    with the previous open-loop plan shifted by one (src/closed_loop.py
    :363-364: ``xref[:, i] = xOpt[:, i + 1]`` for i < N_fix - 5). Returns
    a new tensor."""
    if n_cols <= 0:
        return xref
    out = xref.clone()
    out[..., :n_cols] = x_prev[..., 1:n_cols + 1]
    return out


def goal_reached(x0, goal, tol_sq=0.1):
    """Loop termination test (src/closed_loop.py:345-346)."""
    return (x0[..., 0] - goal[0]) ** 2 + (x0[..., 1] - goal[1]) ** 2 < tol_sq
