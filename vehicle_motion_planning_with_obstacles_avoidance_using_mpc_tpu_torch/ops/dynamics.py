"""Unicycle kinematics, forward Euler (the JAX package's
``ops/dynamics.py``; reference ``src/obca.py``'s dynamics constraints)."""

from __future__ import annotations

import torch


def unicycle_step(state, u, dt):
    """One forward-Euler step: state (..., 3), u (..., 2), dt scalar or
    broadcastable to the leading dimensions."""
    x, y, th = state[..., 0], state[..., 1], state[..., 2]
    v, w = u[..., 0], u[..., 1]
    return torch.stack([x + dt * v * torch.cos(th), y + dt * v * torch.sin(th),
                        th + dt * w], dim=-1)

