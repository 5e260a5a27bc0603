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



def unicycle_rollout(x0, us, dt):
    """Roll out a control sequence: x0 (..., 3), us (..., N, 2) ->
    (..., N+1, 3), the start first (the JAX package's scan, one step at a
    time)."""
    xs = [x0]
    for t in range(us.shape[-2]):
        xs.append(unicycle_step(xs[-1], us[..., t, :], dt))
    return torch.stack(xs, dim=-2)
