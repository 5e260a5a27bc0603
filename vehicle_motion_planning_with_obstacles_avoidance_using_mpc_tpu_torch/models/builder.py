"""Assemble batched :class:`OBCAData` from a Scenario + per-lane state.

PyTorch counterpart of the JAX package's ``models/builder.py`` (the
reference's ``update_obstacle_constraint`` plumbing,
``src/closed_loop.py:488-500``): static + dynamic obstacle slots always
present at a fixed shape, with masks deciding what the NLP sees. One world
(an unbatched :class:`Scenario`) serves all B lanes; the lane dimension
comes from ``x0``.
"""

from __future__ import annotations

import math

import torch

from ..ops import geometry
from ..scenarios.build import Scenario
from .obca import OBCAData, OBCASpec


def build_obca_data(
    spec: OBCASpec,
    scn: Scenario,
    *,
    x0,
    u0,
    xref,
    Ts,
    dyn_active=None,
    dyn_delta=None,
    Ts_pred=None,
    terminal_set=None,
    q=0.1,
    r1=0.01,
    r2=0.1,
    p=None,
    v_max=0.6,
    w_max=math.pi / 6,
    a_max=0.6,
    alpha_max=math.pi / 6,
    ego=(1.7, 0.75, 1.7, 0.75),
    dmin=0.05,
    time_c1=10.0,
    time_c2=1.0,
    t_bounds=None,
) -> OBCAData:
    """Build the NLP data for B solves in one world.

    Args:
      spec: static shapes; ``spec.n_obs`` must equal nS + nD of ``scn``.
      x0: (B, 3) current states; u0: (B, 2) previously applied inputs.
      xref: (B, 3, N+1) reference windows.
      Ts: sampling time of the NLP dynamics/cost (float or (B,)).
      dyn_active: (nD,) or (B, nD) 1.0 for sensed dynamic obstacles;
        None -> none (free-time branch).
      dyn_delta: (nD, 2) or (B, nD, 2) displacement from spawn; None -> 0.
      Ts_pred: sampling time predicting obstacle motion over the horizon;
        None -> obstacles frozen (the free-time cursor-reset semantics).
      terminal_set: (2, 2) or (B, 2, 2) for the 'fix_terminal' variant.
      q/r1/r2/p: scalar weights (Q = q*I etc.); p defaults to q.
    """
    dtype, dev = scn.sA.dtype, scn.sA.device
    N = spec.N
    nS, nD = scn.sA.shape[0], scn.dA.shape[0]
    if spec.n_obs != nS + nD:
        raise ValueError(f"spec.n_obs={spec.n_obs} != nS + nD = {nS + nD}")
    x0 = torch.as_tensor(x0, dtype=dtype, device=dev)
    B = x0.shape[0]

    def lane(v, tail):
        """Broadcast a per-world or per-lane value to (B,) + tail."""
        v = torch.as_tensor(v, dtype=dtype, device=dev)
        return v.expand((B,) + tuple(tail)).contiguous()

    dyn_active = lane(0.0 if dyn_active is None else dyn_active, (nD,))
    dyn_delta = lane(0.0 if dyn_delta is None else dyn_delta, (nD, 2))
    dyn_active = dyn_active * scn.d_mask

    db_now = geometry.translate_hrep_b(scn.dA, scn.db, dyn_delta)   # (B, nD, E)
    A_all = torch.cat([scn.sA, scn.dA], dim=0).expand((B,) + (nS + nD,) + scn.sA.shape[1:])
    b_all = torch.cat([scn.sb.expand((B,) + scn.sb.shape), db_now], dim=1)
    edge_mask = lane(torch.cat([scn.s_edge_mask, scn.d_edge_mask], dim=0),
                     (nS + nD, spec.e_max))
    obs_mask = torch.cat([scn.s_mask.expand(B, nS), dyn_active], dim=1)

    vel_dyn = scn.d_vel * dyn_active[..., None]                      # (B, nD, 2)
    zeros_s = torch.zeros((B, nS, 2), dtype=dtype, device=dev)
    if Ts_pred is None:
        vel = torch.zeros((B, nS + nD, 2), dtype=dtype, device=dev)
        Ts_rep = lane(0.0, ())
    else:
        vel = torch.cat([zeros_s, vel_dyn], dim=1)
        Ts_rep = lane(Ts_pred, ())
    A_t, b_t = geometry.replicate_hrep_over_horizon(A_all, b_all, vel, N, Ts_rep)

    xref = torch.as_tensor(xref, dtype=dtype, device=dev)
    Ts = lane(Ts, ())
    p = q if p is None else p

    # free-time bounds on the time scale (src/obca.py:961-963 — the signed
    # coordinate-sum "distance", reproduced as-is)
    if t_bounds is None:
        dis = (xref[:, 0, N] - x0[:, 0]) + (xref[:, 1, N] - x0[:, 1])
        T_max = dis / (N * v_max * Ts) + 1.0
        T_lo = lane(1e-4, ())
    else:
        T_lo = lane(t_bounds[0], ())
        T_max = lane(t_bounds[1], ())

    L = ego[0] + ego[2]
    W = ego[1] + ego[3]

    def eye(k, c):
        return lane(c * torch.eye(k, dtype=dtype, device=dev), (k, k))

    return OBCAData(
        x0=x0,
        u0=lane(u0, (2,)),
        xref=xref.expand(B, 3, N + 1).contiguous(),
        A=A_t.contiguous(),
        b=b_t.contiguous(),
        edge_mask=edge_mask,
        obs_mask=obs_mask.contiguous(),
        x_lo=lane(scn.x_lo, (2,)),
        x_hi=lane(scn.x_hi, (2,)),
        u_lo=lane([-v_max, -w_max], (2,)),
        u_hi=lane([v_max, w_max], (2,)),
        Q=eye(3, q), R1=eye(2, r1), R2=eye(2, r2), P=eye(3, p),
        Ts=Ts,
        dmin=lane(dmin, ()),
        ego_g=lane([L / 2, W / 2, L / 2, W / 2], (4,)),
        ego_offset=lane((ego[0] + ego[2]) / 2 - ego[2], ()),
        terminal_set=lane(0.0 if terminal_set is None else terminal_set, (2, 2)),
        T_max=T_max.contiguous(),
        a_max=lane(a_max, ()),
        alpha_max=lane(alpha_max, ()),
        time_c1=lane(time_c1, ()),
        time_c2=lane(time_c2, ()),
        T_lo=T_lo,
        # world velocities for spec.coupled_motion (in-graph prediction)
        obs_vel=torch.cat([zeros_s, vel_dyn], dim=1),
    )
