"""Host-side matplotlib rendering, parity with the reference's
``src/draw.py`` (class ``plotClass``): static world plots (``plot_map``,
:40), the A*-vs-MPC comparison (``plot_fullDimension``, :98), the
open-loop animation (``fullDimension_animate``, :211), the closed-loop
animation with the lidar circle and the recorded dynamic-obstacle
positions (``fullDimension_closedLoop_animate``, :333), car boxes
(:469-487) and the sensor circle (:458-467). GIFs use the pillow writer
(``draw.py:451``).

PyTorch counterpart of the JAX package's ``viz/plotting.py``: the same
figures from the port's result types (:mod:`..runtime`), any tensor moved
to numpy first. Optional host tooling: the solver path never imports it,
and it raises ``ImportError`` where matplotlib is not installed.
"""

from __future__ import annotations

import math

import numpy as np

try:
    import matplotlib
except ImportError as e:   # pragma: no cover - the card's machine has none
    raise ImportError("the port's viz/ needs matplotlib, which is not installed") from e

matplotlib.use("Agg")
import matplotlib.animation as animation  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402


def _np(a):
    """A tensor (any device) or array-like as a numpy array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def car_outline(x, ego):
    """(5, 2) closed outline of the ego box at pose ``x`` = (cx, cy, theta).

    ``ego`` = (front, half_width, rear, half_width) as in
    src/closed_loop.py:63; the reference's carBox (draw.py:469-474) draws
    the box centered ``offset`` ahead of the rear-axle reference point.
    """
    fx, hw, rx, _ = ego
    x = _np(x)
    c, s = math.cos(x[2]), math.sin(x[2])
    pts = np.array([
        [fx, hw], [fx, -hw], [-rx, -hw], [-rx, hw], [fx, hw],
    ])
    rot = np.array([[c, -s], [s, c]])
    return pts @ rot.T + _np(x[:2])


def dyn_obstacle_outline(row, pos=None):
    """(5, 2) closed outline of a dynamic obstacle given its 11-tuple spec
    (src/demo_setting.py:379-384) and an optional center override."""
    cx, cy = (row[0], row[1]) if pos is None else (pos[0], pos[1])
    th, L, W = row[2], row[3], row[4]
    c, s = math.cos(th), math.sin(th)
    hl, hw = L / 2, W / 2
    pts = np.array([
        [-hl, hw], [hl, hw], [hl, -hw], [-hl, -hw], [-hl, hw],
    ])
    rot = np.array([[c, -s], [s, c]])
    return pts @ rot.T + np.array([cx, cy])


def plot_world(ax, demo, grid=None):
    """Static map: bounds, obstacle polylines, optional occupancy grid,
    start/goal markers (draw.py:19-96)."""
    if grid is not None:
        g = _np(grid)
        ax.imshow(
            g, origin="lower", cmap="Greys", alpha=0.25,
            extent=(demo.x_lo[0] - 0.5, demo.x_lo[0] + g.shape[1] - 0.5,
                    demo.x_lo[1] - 0.5, demo.x_lo[1] + g.shape[0] - 0.5),
        )
    for poly in demo.static_lobs:
        p = np.asarray(poly, float)
        ax.plot(p[:, 0], p[:, 1], "k-", lw=2)
    ax.plot(demo.start[0], demo.start[1], "g^", ms=9, label="start")
    ax.plot(demo.goal[0], demo.goal[1], "r*", ms=12, label="goal")
    ax.set_xlim(demo.x_lo[0] - 1, demo.x_hi[0] + 1)
    ax.set_ylim(demo.x_lo[1] - 1, demo.x_hi[1] + 1)
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")


def plot_comparison(demo, ref_path=None, trajs=None, grid=None,
                    out_path=None):
    """A*-vs-MPC comparison plot (draw.py:98-209). ``trajs`` maps label ->
    (3, T) trajectory."""
    fig, ax = plt.subplots(figsize=(8, 6))
    plot_world(ax, demo, grid)
    if ref_path is not None:
        r = _np(ref_path)
        ax.plot(r[0], r[1], "b--", lw=1, label="A* reference")
    for label, tr in (trajs or {}).items():
        t = _np(tr)
        ax.plot(t[0], t[1], lw=1.5, marker=".", ms=3, label=label)
    ax.legend(loc="upper right", fontsize=8)
    ax.set_title(demo.name)
    if out_path:
        fig.savefig(out_path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        return out_path
    return fig


def _sensor_circle(ax, x, ego_l, r, detected):
    """Lidar circle anchored at the car front, red when detecting
    (draw.py:458-467, closed_loop.py:591-601)."""
    cx = x[0] + ego_l * math.cos(x[2])
    cy = x[1] + ego_l * math.sin(x[2])
    th = np.linspace(0, 2 * np.pi, 80)
    color = "r" if detected else "g"
    return ax.plot(cx + r * np.cos(th), cy + r * np.sin(th),
                   color + "--", lw=0.8)[0]


def animate_closed_loop(demo, result, gif_path, fps=5, sense_dis=None):
    """Closed-loop animation (draw.py:333-456): reference path, executed
    trajectory, per-step open-loop prediction, recorded dynamic-obstacle
    outlines, lidar circle. ``result`` is a :class:`..runtime.ClosedLoopResult`."""
    steps = result.steps
    if not steps:
        raise ValueError("no steps to animate")
    ego = demo.params.ego
    r = sense_dis if sense_dis is not None else demo.sense_dis
    xs = np.array([_np(s.x) for s in steps])

    fig, ax = plt.subplots(figsize=(8, 6))

    def frame(i):
        ax.clear()
        plot_world(ax, demo)
        if result.x_ref is not None:
            ref = _np(result.x_ref)
            ax.plot(ref[0], ref[1], "b--", lw=0.8, label="A* reference")
        s = steps[i]
        ax.plot(xs[: i + 1, 0], xs[: i + 1, 1], "g.-", lw=1.2, ms=4,
                label="executed")
        plan = _np(s.x_open_loop)
        ax.plot(plan[:, 0], plan[:, 1], "m.:", lw=1, ms=3,
                label="open-loop plan")
        box = car_outline(s.x, ego)
        ax.plot(box[:, 0], box[:, 1], "g-", lw=1.5)
        detected = False
        if s.dyn_vertices:
            for dv in s.dyn_vertices:
                if dv is None:
                    continue
                verts, sensed = dv
                detected = detected or sensed
                verts = _np(verts)
                v = np.vstack([verts, verts[:1]])
                ax.plot(v[:, 0], v[:, 1], "r-" if sensed else "k-", lw=1.5)
        _sensor_circle(ax, s.x, ego[0], r, detected)
        mode = "fix-time" if s.fixtime else "free-time"
        ax.set_title(f"{demo.name}  k={s.k}  [{mode}]"
                     f"{'' if s.feas else '  INFEASIBLE'}")
        ax.legend(loc="upper right", fontsize=7)

    ani = animation.FuncAnimation(fig, frame, frames=len(steps))
    ani.save(gif_path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return gif_path


def plot_states_inputs(records, out_prefix):
    """State/input comparison plots (draw-side of
    ``simulation.show_performance``, src/simulation.py:146-208): x, y,
    theta per step in one figure; v, omega per step in another.

    ``records`` maps label -> {"x": (3, T) [, "u": (2, T')]}; entries with
    missing pieces are skipped. Writes ``{out_prefix}_states.png`` and
    ``{out_prefix}_inputs.png``; returns both paths.
    """
    names = ["x [m]", "y [m]", "theta [rad]"]
    fig, axes = plt.subplots(3, 1, figsize=(8, 9), sharex=True)
    for label, rec in records.items():
        xs = rec.get("x")
        if xs is None:
            continue
        xs = _np(xs)
        for i, ax in enumerate(axes):
            ax.plot(np.arange(xs.shape[1]), xs[i], marker=".", ms=3,
                    lw=1, label=label)
    for i, ax in enumerate(axes):
        ax.set_ylabel(names[i])
        ax.grid(alpha=0.3)
    axes[0].legend(loc="best", fontsize=8)
    axes[-1].set_xlabel("step")
    states_path = f"{out_prefix}_states.png"
    fig.savefig(states_path, dpi=110, bbox_inches="tight")
    plt.close(fig)

    names_u = ["v [m/s]", "omega [rad/s]"]
    fig, axes = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
    for label, rec in records.items():
        us = rec.get("u")
        if us is None:
            continue
        us = _np(us)
        for i, ax in enumerate(axes):
            ax.plot(np.arange(us.shape[1]), us[i], marker=".", ms=3,
                    lw=1, label=label)
    for i, ax in enumerate(axes):
        ax.set_ylabel(names_u[i])
        ax.grid(alpha=0.3)
    axes[0].legend(loc="best", fontsize=8)
    axes[-1].set_xlabel("step")
    inputs_path = f"{out_prefix}_inputs.png"
    fig.savefig(inputs_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return states_path, inputs_path


def animate_open_loop(demo, result, gif_path, fps=5):
    """Open-loop animation (draw.py:211-331): the planned trajectory is
    traversed frame by frame while dynamic obstacles advance by
    Ts_opt * v per frame (draw.py:277-288). ``result`` is an
    :class:`..runtime.OpenLoopResult`."""
    x = _np(result.x)
    ego = demo.params.ego
    Ts_opt = float(result.Ts_opt)
    info = np.asarray(demo.dyn_obs_info, float) if demo.dyn_obs_info else None

    fig, ax = plt.subplots(figsize=(8, 6))

    def frame(k):
        ax.clear()
        plot_world(ax, demo)
        ax.plot(x[0], x[1], "m.:", lw=1, ms=3, label="plan")
        ax.plot(x[0, : k + 1], x[1, : k + 1], "g.-", lw=1.2, ms=4)
        box = car_outline(x[:, k], ego)
        ax.plot(box[:, 0], box[:, 1], "g-", lw=1.5)
        if info is not None:
            for row in info:
                c, s = math.cos(row[2]), math.sin(row[2])
                pos = (row[0] + k * Ts_opt * row[5] * c,
                       row[1] + k * Ts_opt * row[5] * s)
                v = dyn_obstacle_outline(row, pos)
                ax.plot(v[:, 0], v[:, 1], "k-", lw=1.5)
        ax.set_title(f"{demo.name}  open-loop k={k}  Ts_opt={Ts_opt:.3f}")
        ax.legend(loc="upper right", fontsize=7)

    ani = animation.FuncAnimation(fig, frame, frames=x.shape[1])
    ani.save(gif_path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return gif_path
