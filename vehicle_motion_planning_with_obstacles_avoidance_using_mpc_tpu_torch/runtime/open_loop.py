"""Open-loop two-phase pipeline (the reference's ``simulation.run``,
src/simulation.py:20-62, driving ``mpc_openLoop_freeTime`` /
``mpc_openLoop_fixTime``, src/closed_loop.py:113-140).

PyTorch counterpart of the JAX package's ``runtime/open_loop.py``.
Phase 1 (free time) solves the time scale over the static world from a
goal-only reference, as a 5-candidate multistart: the goal-only window,
the straight line, and the A* path resampled to N + 1 knots (as found,
and on the grid dilated by 2 and by 1 with the first chord along the
start heading). Phase 2 (fix time, when the demo has dynamic obstacles)
re-interpolates phase 1's plan to N_fix points with the Ts rescale, adds
the obstacles predicted over the horizon and the terminal set, and
solves ``fix_terminal`` over 2 candidates with the ``fix_free_end``
fallback.

One problem is a batch of B = 1 for the port's batched solver; its
candidates are the multistart's lanes. Tensors go to the card unless
``device`` says otherwise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import OBCASpec, build_obca_data, init_vars
from ..ops.rasterize import dilate_grid
from ..scenarios import build_scenario, get_demo
from ..scenarios.demos import MPCParams
from ..solver import IPMOptions, make_obca_solver
from . import astar_host
from .multistart import make_multistart_solver
from .reference import (reinterpolate_openloop, start_goal_reference,
                        start_goal_smooth_reference)

N_CAND_OPEN = 5       # free-time candidates
N_CAND_OPEN_FIX = 2   # fix-time candidates (the re-interpolated plan twice)
OPEN_OPTIONS = IPMOptions(max_iters=200, acceptable_tol=5e-3, feas_tol=1e-4)


@dataclasses.dataclass
class OpenLoopResult:
    demo: str
    feas: bool
    x: np.ndarray          # (3, N+1) final plan (phase 2 if run, else 1)
    u: np.ndarray          # (2, N)
    Ts_opt: float
    free: dict             # phase-1 record: x, u, Ts_opt, feas, iters, kkt_err
    fix: dict | None       # phase-2 record (None without dynamic obstacles)


def _resampled_astar_init(scn, demo, N, dtype, dilation=0, align_start=False):
    """(3, N+1) A* path resampled to N + 1 knots with recomputed headings,
    on ``scn``'s device.

    ``dilation`` searches a disk-dilated grid (start and goal cells kept
    free) so the knots keep clearance from walls; when that seals the
    corridor the plain grid is searched. ``align_start`` moves knot 1 so
    the first chord points along the start heading (x_0 pins theta_0 and
    the unicycle can only leave along it).
    """
    grid = scn.grid.cpu().numpy()
    if dilation > 0:
        g = dilate_grid(scn.grid.cpu(), dilation).numpy().copy()
        g[int(demo.start[1]), int(demo.start[0])] = 0
        g[int(demo.goal[1]), int(demo.goal[0])] = 0
        try:
            ref = astar_host.reference_path_for(g, demo.start, demo.goal)
        except ValueError:  # dilation sealed the corridor
            ref = astar_host.reference_path_for(grid, demo.start, demo.goal)
    else:
        ref = astar_host.reference_path_for(grid, demo.start, demo.goal)
    L = ref.shape[1]
    idx = np.linspace(0, L - 1, N + 1)
    xy = np.stack([np.interp(idx, np.arange(L), ref[i]) for i in range(2)])
    if align_start:
        d1 = float(np.hypot(*(xy[:, 1] - xy[:, 0])))
        th0 = float(demo.start[2])
        xy[:, 1] = np.asarray(demo.start[:2]) + d1 * np.array([np.cos(th0), np.sin(th0)])
    th = np.arctan2(np.diff(xy[1]), np.diff(xy[0]))
    th = np.concatenate([th, th[-1:]])
    out = np.concatenate([xy, th[None]])
    out[:, 0] = np.asarray(demo.start)
    return torch.as_tensor(out, dtype=dtype, device=scn.grid.device)


def free_time_problem(demo, scn, shape, N, p, dtype):
    """(spec, data (B = 1), candidates (1, 5, 3, N+1)) of phase 1: the
    goal-only free-time NLP and its five starting trajectories."""
    spec = OBCASpec(N=N, n_obs=shape.n_obs, e_max=shape.e_max, variant="free")
    xref = start_goal_reference(scn.start, scn.goal, N)
    data = build_obca_data(
        spec, scn, x0=scn.start[None], u0=torch.zeros(2, dtype=dtype), xref=xref[None],
        Ts=p.Ts, q=p.q_free, r1=p.r1_free, r2=p.r2_free, v_max=p.v_max, w_max=p.w_max,
        a_max=p.a_max, alpha_max=p.alpha_max, ego=p.ego, dmin=p.dmin,
        time_c1=p.time_c1, time_c2=p.time_c2)
    cands = torch.stack([
        xref,
        start_goal_smooth_reference(scn.start, scn.goal, N),
        _resampled_astar_init(scn, demo, N, dtype),
        _resampled_astar_init(scn, demo, N, dtype, dilation=2, align_start=True),
        _resampled_astar_init(scn, demo, N, dtype, dilation=1, align_start=True),
    ])[None]
    return spec, data, cands


def fix_time_problem(demo, scn, shape, plan, N, N_fix, Ts_opt, p, dtype,
                     variant="fix_terminal"):
    """(spec, data (B = 1), candidates (1, 2, 3, N_new+1), Ts2) of phase 2:
    the free-time ``plan`` (3, N+1) re-interpolated to N_new =
    N * int(N_fix / N) points with Ts2 = N * Ts_opt / N_new, the dynamic
    obstacles predicted over the horizon from their spawn positions and
    the demo's terminal set (src/closed_loop.py:122-140, :570-587)."""
    xref2, N_new = reinterpolate_openloop(plan, N, N_fix)
    Ts2 = (N * Ts_opt) / N_new
    dev = scn.grid.device
    terminal_set = demo.terminal_policy.resolve(scn.start.cpu().numpy())
    spec = OBCASpec(N=N_new, n_obs=shape.n_obs, e_max=shape.e_max, variant=variant)
    data = build_obca_data(
        spec, scn, x0=scn.start[None], u0=torch.zeros(2, dtype=dtype), xref=xref2[None],
        Ts=Ts2, dyn_active=scn.d_mask, dyn_delta=torch.zeros_like(scn.dyn_info[:, :2]),
        Ts_pred=Ts2, terminal_set=torch.as_tensor(terminal_set, dtype=dtype, device=dev),
        q=p.q_fix, r1=p.r1_fix, r2=p.r2_fix, v_max=p.v_max, w_max=p.w_max, a_max=p.a_max,
        alpha_max=p.alpha_max, ego=p.ego, dmin=p.dmin)
    return spec, data, torch.stack([xref2, xref2])[None], Ts2


def _record(res, Ts):
    return {"x": res.z["x"][0].cpu().numpy(), "u": res.z["u"][0].cpu().numpy(),
            "Ts_opt": Ts, "feas": bool(res.feas[0]), "iters": int(res.iters[0]),
            "kkt_err": float(res.kkt_err[0])}


def run_open_loop(demo_name: str, N: int = 50, N_fix: int | None = None,
                  params: MPCParams | None = None, dtype=torch.float64,
                  ipm_options: IPMOptions | None = None, fix_phase: bool = True,
                  device=torch.device("cuda")) -> OpenLoopResult:
    """Two-phase open-loop pipeline (see the module docstring).

    ``fix_phase=False`` stops after the free-time phase even when the demo
    has dynamic obstacles (the reference's ``calc_time`` entry does so).
    """
    demo = get_demo(demo_name)
    p = params or demo.params
    scn, shape = build_scenario(demo, dtype=dtype, device=device)
    opt = ipm_options or OPEN_OPTIONS
    N_fix = N_fix or N

    # ---- phase 1: free time, static world
    spec_f, data_f, cands = free_time_problem(demo, scn, shape, N, p, dtype)
    solve_f = make_multistart_solver(spec_f, make_obca_solver(spec_f, opt),
                                     init_vars, N_CAND_OPEN)
    res_f, _ = solve_f(data_f, cands)
    Ts_opt = float(res_f.z["T"][0]) * p.Ts  # src/obca.py:1059
    free_rec = _record(res_f, Ts_opt)

    if not (bool(scn.d_mask.any()) and fix_phase):
        return OpenLoopResult(demo=demo_name, feas=free_rec["feas"], x=free_rec["x"],
                              u=free_rec["u"], Ts_opt=Ts_opt, free=free_rec, fix=None)

    # ---- phase 2: fix time, dynamic world (src/closed_loop.py:122-140)
    spec_x, data_x, cands2, Ts2 = fix_time_problem(demo, scn, shape, res_f.z["x"][0], N,
                                                   N_fix, Ts_opt, p, dtype)
    solve_x = make_multistart_solver(spec_x, make_obca_solver(spec_x, opt),
                                     init_vars, N_CAND_OPEN_FIX)
    res_x, _ = solve_x(data_x, cands2)
    fallback = not bool(res_x.feas[0])
    if fallback:  # src/closed_loop.py:134-140
        spec_8 = dataclasses.replace(spec_x, variant="fix_free_end")
        solve_8 = make_multistart_solver(spec_8, make_obca_solver(spec_8, opt),
                                         init_vars, N_CAND_OPEN_FIX)
        res_x, _ = solve_8(data_x, cands2)
    fix_rec = dict(_record(res_x, Ts2), fallback=fallback)
    return OpenLoopResult(demo=demo_name, feas=fix_rec["feas"], x=fix_rec["x"],
                          u=fix_rec["u"], Ts_opt=Ts2, free=free_rec, fix=fix_rec)
