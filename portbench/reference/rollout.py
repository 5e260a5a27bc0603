"""One closed-loop rollout step worked out again, in numpy.

For each world-step of the window (the state before it, the step's
outputs, the state after it) this follows the reference repository's
``closed_loop_mpc4`` step (``src/closed_loop.py:323-486, 591-630``) from
the world's own description:

* the dynamic obstacles move by Ts_opt times their velocity once started;
* the lidar senses an appeared obstacle whose corners come within
  ``sense_dis`` of the ego's front; a sensed obstacle makes the step fix
  time, never the first step;
* a feasible plan's second state becomes the pose, its first input the
  applied input, the plan the previous plan, and its step the new Ts
  (``Ts_cur`` follows in fix time); an infeasible one leaves the world as
  it was and fails it; a world within sqrt(0.1) of its goal has reached
  it and stops.

And each applied plan is held to the model it was solved under, from its
states alone (the rollout reports no duals): its start, the first step's
dynamics under the applied input, the sideways (non-holonomic) residual
of every later step, the applied input's bounds and acceleration, the
map's bounds, and the ego box's distance to every obstacle of its NLP at
steps 1..N (the static ones; in fix time also each sensed dynamic one,
predicted at its velocity over the horizon).

The check follows the program step by step from the program's own state
before each step; a world's first step is held to its fresh state (at its
start, at rest, Ts, its obstacles at their spawn points) by itself.

Numbers (see ``check_steps``): ``state_err``, ``state_flags``,
``plan_viol``.
"""

from __future__ import annotations

import math

import numpy as np

from . import geometry, worlds

REACHED_SQ = 0.1     # src/closed_loop.py:345-346
# a test whose two sides differ by less than this share of its threshold
# may fall either way in the program's float32
BAND = 1e-4


class WorldTable:
    """Per-world arrays the checks gather by world id: goal, sense radius,
    map bounds, the static obstacles as clipped polygons, the dynamic ones'
    spawn rectangles, velocities and start steps."""

    def __init__(self, world_list, n_static, n_dyn, e_max):
        n = len(world_list)
        self.start = np.array([w["start"] for w in world_list])
        self.goal = np.array([w["goal"][:2] for w in world_list])
        self.sense = np.array([w["sense_dis"] for w in world_list])
        self.x_lo = np.array([w["x_lo"] for w in world_list])
        self.x_hi = np.array([w["x_hi"] for w in world_list])
        self.rect = np.zeros((n, n_dyn, 5))
        self.vel = np.zeros((n, n_dyn, 2))
        self.t0 = np.zeros((n, n_dyn))
        self.live = np.zeros((n, n_dyn), bool)
        polys = []
        for i, w in enumerate(world_list):
            o = worlds.obstacles(w, n_static, n_dyn, e_max)
            polys.append([geometry.clip_polygon(o["A"][j], o["b"][j], o["edge_mask"][j])
                          for j in range(n_static)])
            self.rect[i], self.vel[i], self.t0[i] = o["rect"], o["vel"], o["start_time"]
            self.live[i] = o["real"] > 0
        V = max(len(p) for ps in polys for p in ps)
        self.static = np.stack([geometry.pad(ps, V) for ps in polys])   # (n, nS, V, 2)


def spawn_corners(rect):
    """(..., 4, 2) corners of rectangles (cx, cy, theta, length, width)."""
    cx, cy, th, L, W = (rect[..., i] for i in range(5))
    c, s = np.cos(th), np.sin(th)
    hl, hw = L / 2, W / 2
    return np.stack([np.stack([cx - hl * c - hw * s, cy - hl * s + hw * c], -1),
                     np.stack([cx + hl * c - hw * s, cy + hl * s + hw * c], -1),
                     np.stack([cx + hl * c + hw * s, cy + hl * s - hw * c], -1),
                     np.stack([cx - hl * c + hw * s, cy - hl * s - hw * c], -1)], -2)


def expected(wt, wid, before, p, rnd=None):
    """The step's bookkeeping from the state before it: ``dyn_pos`` after
    the move, ``sensed`` (M, nD), ``fixtime`` (M,) and ``ambiguous`` (M,)
    where the lidar test lies within its float32 band."""
    r = rnd or (lambda a: a)
    k = before["k"][:, None].astype(np.float64)
    live = wt.live[wid]
    started = (k > wt.t0[wid]) & live
    move = r(r(before["Ts_opt"][:, None, None] * wt.vel[wid]))
    dyn_pos = np.where(started[..., None], r(before["dyn_pos"] + move), before["dyn_pos"])
    appeared = (k >= wt.t0[wid]) & live
    th = before["x0"][:, 2]
    ego0 = p["ego"][0]
    front = np.stack([r(before["x0"][:, 0] + r(ego0 * r(np.cos(th)))),
                      r(before["x0"][:, 1] + r(ego0 * r(np.sin(th))))], -1)
    corners = spawn_corners(wt.rect[wid]) + (dyn_pos - wt.rect[wid][..., :2])[..., None, :]
    dmin = np.sqrt(((corners - front[:, None, None, :]) ** 2).sum(-1)).min(-1)   # (M, nD)
    sense = wt.sense[wid][:, None]
    sensed = appeared & (dmin <= sense)
    amb = (appeared & (np.abs(dmin - sense) <= BAND * sense)).any(-1)
    fixtime = sensed.any(-1) & (before["k"] > 0)
    return dyn_pos, sensed, fixtime, amb


def check_steps(wt, wid, before, out, after, p, N, viol_tol, rnd=None, plan_rows=None):
    """``(state_err, state_flags, plan_viol)`` over M world-steps (rows of
    ``before``, ``out``, ``after``: dicts of arrays; ``wid`` (M,) world
    ids). ``plan_rows`` limits the plan check to those rows (a sample)."""
    dyn_pos, sensed, fixtime, amb = expected(wt, wid, before, p)
    if rnd is not None:   # the control: the reference's step in TF32 in the program's place
        after = dict(after)
        after["dyn_pos"] = np.where(before["active"][:, None, None],
                                    expected(wt, wid, before, p, rnd)[0], before["dyn_pos"])
        after["x0"] = rnd(after["x0"])
    act = before["active"]
    feas = out["feas"]
    ok = act & feas
    flags = 0
    flags += int(((out["fixtime"] != (fixtime & act)) & ~amb).sum())
    flags += int((after["k"] != before["k"] + act).sum())
    goal = wt.goal[wid]
    d2 = ((after["x0"][:, :2] - goal) ** 2).sum(-1)
    reached = d2 < REACHED_SQ
    amb_r = np.abs(d2 - REACHED_SQ) <= BAND * REACHED_SQ
    flags += int(((after["reached"] != (before["reached"] | (act & reached))) & ~amb_r).sum())
    flags += int((after["failed"] != (before["failed"] | (act & ~feas))).sum())
    flags += int(((after["active"] != (act & feas & ~reached)) & ~amb_r).sum())

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        err = np.abs(a - b) / np.maximum(1.0, np.abs(b))
        return float(err.max()) if err.size else 0.0

    # a world's first step starts from its fresh state: at its start, at
    # rest, at the configuration's Ts, its obstacles at their spawn points
    new = before["k"] == 0
    flags += int((~before["active"][new] | before["reached"][new] | before["failed"][new]).sum())
    start = wt.start[wid][new]
    fresh = max(rel(before["x0"][new], start), rel(before["u0"][new], 0.0 * before["u0"][new]),
                rel(before["Ts_cur"][new], np.full(new.sum(), p["Ts"])),
                rel(before["Ts_opt"][new], np.full(new.sum(), p["Ts"])),
                rel(before["dyn_pos"][new], wt.rect[wid][new][..., :2]),
                rel(before["prev_plan"][new], np.repeat(start[:, :, None], N + 1, 2)))

    plan = out["plan"]
    x0_exp = np.where(ok[:, None], plan[:, :, 1], before["x0"])
    dyn_exp = np.where(act[:, None, None], dyn_pos, before["dyn_pos"])
    prev_exp = np.where(ok[:, None, None], plan, before["prev_plan"])
    u0_ok = np.where(ok[:, None], after["u0"], before["u0"])
    fix = out["fixtime"]
    Ts_opt_exp = np.where(ok & fix, before["Ts_opt"], np.where(ok, after["Ts_opt"], before["Ts_opt"]))
    Ts_cur_exp = np.where(ok & fix, before["Ts_opt"], before["Ts_cur"])
    err = max(fresh, rel(after["x0"], x0_exp), rel(after["dyn_pos"], dyn_exp),
              rel(after["prev_plan"], prev_exp), rel(after["u0"], u0_ok),
              rel(after["Ts_opt"], Ts_opt_exp), rel(after["Ts_cur"], Ts_cur_exp),
              rel(out["x"], after["x0"]), rel(out["u"], after["u0"]))

    rows = np.nonzero(ok)[0] if plan_rows is None else np.intersect1d(np.nonzero(ok)[0], plan_rows)
    pv = plan_violation(wt, wid[rows], {k: v[rows] for k, v in before.items()},
                        plan[rows], after["u0"][rows], after["Ts_opt"][rows], fix[rows],
                        dyn_pos[rows], sensed[rows], p, N) if rows.size else 0.0
    return err, flags, pv


def plan_violation(wt, wid, before, plan, u_app, dt, fix, dyn_pos, sensed, p, N):
    """The largest violation, in the model's units, of the applied plans
    (see the module docstring); the sideways residual is divided by
    sqrt(2) and the clearance shortfall by 1 + dmin / 2, the most by which
    a plan within a violation v can show them."""
    th = plan[:, 2]
    dx, dy, dth = (np.diff(plan[:, i], axis=1) for i in range(3))
    dt_ = dt[:, None]
    parts = [np.abs(plan[:, :, 0] - before["x0"]).max(1)]
    parts += [np.abs(dx[:, 0] - dt * u_app[:, 0] * np.cos(th[:, 0])),
              np.abs(dy[:, 0] - dt * u_app[:, 0] * np.sin(th[:, 0])),
              np.abs(dth[:, 0] - dt * u_app[:, 1])]
    side = np.abs(dx * np.sin(th[:, :N]) - dy * np.cos(th[:, :N]))[:, 1:]
    parts.append(side.max(1) / math.sqrt(2.0) if side.shape[1] else np.zeros(len(plan)))
    parts += [np.abs(u_app[:, 0]) - p["v_max"], np.abs(u_app[:, 1]) - p["w_max"]]
    du = before["u0"] - u_app
    parts += [np.abs(du[:, 0]) - p["a_max"] * dt, np.abs(du[:, 1]) - p["alpha_max"] * dt]
    lo, hi = wt.x_lo[wid][:, :, None], wt.x_hi[wid][:, :, None]
    parts.append(np.maximum(lo - plan[:, :2], plan[:, :2] - hi).max((1, 2)))
    # clearance at steps 1..N
    boxes = geometry.ego_boxes(np.moveaxis(plan[:, :, 1:], 1, 2), p["ego"])   # (M, N, 4, 2)
    M = len(plan)
    short = np.zeros(M)
    stat = wt.static[wid]                                                     # (M, nS, V, 2)
    for j in range(stat.shape[1]):
        Q = np.repeat(stat[:, j], N, axis=0)
        dist = geometry.distance(boxes.reshape(M * N, 4, 2), Q).reshape(M, N)
        short = np.maximum(short, (p["dmin"] - dist).max(1))
    ks = np.arange(1, N + 1, dtype=np.float64)
    corners0 = spawn_corners(wt.rect[wid])                                    # (M, nD, 4, 2)
    for j in range(corners0.shape[1]):
        use = fix & sensed[:, j]
        if not use.any():
            continue
        shift = (dyn_pos[:, j] - wt.rect[wid][:, j, :2])[:, None, :] + (
            ks[None, :, None] * dt_[:, :, None] * wt.vel[wid][:, j][:, None, :])     # (M, N, 2)
        Q = corners0[:, j][:, None] + shift[:, :, None, :]                    # (M, N, 4, 2)
        dist = geometry.distance(boxes.reshape(M * N, 4, 2), Q.reshape(M * N, 4, 2)).reshape(M, N)
        short = np.where(use, np.maximum(short, (p["dmin"] - dist).max(1)), short)
    parts.append(short / (1.0 + p["dmin"] / 2))
    return float(np.max(np.stack(parts, 1))) if M else 0.0
