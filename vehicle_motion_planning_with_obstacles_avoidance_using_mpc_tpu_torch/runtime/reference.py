"""Reference-trajectory construction and windowing for the MPC.

PyTorch counterpart of the JAX package's ``runtime/reference.py``
(reference: ``src/closed_loop.py:502-587``). Every function takes an
optional leading batch dimension on its pose arguments.
"""

from __future__ import annotations

import torch


def window_reference(ref_traj, valid_len, x0, N):
    """Nearest-point window of (3, L) ``ref_traj`` starting at the point
    closest to ``x0`` ((3,) or (B, 3)); columns past the path end repeat
    the final point. Returns (3, N+1) or (B, 3, N+1).

    ``valid_len`` is the number of real columns in a padded path. Matches
    ``src/closed_loop.py:502-528`` including its clamp at ``L-1``. Ties
    in the distance go to the first index (``torch.argmin`` and
    ``jnp.argmin`` agree on that).
    """
    L = ref_traj.shape[1]
    in_path = torch.arange(L, device=ref_traj.device) < valid_len
    d2 = ((x0[..., 0, None] - ref_traj[0]) ** 2
          + (x0[..., 1, None] - ref_traj[1]) ** 2)            # (..., L)
    d2 = torch.where(in_path, d2, torch.full_like(d2, float("inf")))
    start_idx = torch.argmin(d2, dim=-1)                        # (...)
    cols = start_idx[..., None] + torch.arange(N + 1, device=ref_traj.device)
    cols = torch.clamp(cols, max=valid_len - 1)
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


def goal_reached(x0, goal, tol_sq=0.1):
    """Loop termination test (src/closed_loop.py:345-346)."""
    return (x0[..., 0] - goal[0]) ** 2 + (x0[..., 1] - goal[1]) ** 2 < tol_sq
