"""Closed-loop receding-horizon driver (host orchestration, solves on the
card).

PyTorch counterpart of the JAX package's ``runtime/closed_loop.py``; it
reproduces the reference's main entry ``closedLoop.closed_loop_mpc4``
(src/closed_loop.py:323-443) step for step:

  per step k:
    1. advance the dynamic obstacles by the *previous* optimal sampling
       time (``update_obstacle``, :445-486: they appear at their
       start_time, then translate by Ts_opt * v each step),
    2. simulate the circular-range lidar at the car front and switch this
       step to fix time if any dynamic obstacle vertex is in range
       (``sensor``, :591-630),
    3. free-time branch (k == 0 or nothing sensed): window the A*
       reference at the nearest point and solve the free-time OBCA
       (``obca_mpc4``), Ts_opt = T * Ts (:353-358, :380-385); when it is
       infeasible, the fix_free_end NLP (``obca_mpc8``) and then its QR
       rescue,
    4. fix-time branch: window, splice the previous plan into the first
       N_fix - 5 columns (:362-364), re-interpolate and rescale Ts (:366,
       :570-587, with the Ts feedback self.Ts = Ts_opt), the terminal set
       from the demo's policy, the moving obstacles predicted with Ts_opt
       (:374), then mpc6 -> mpc8 (:387-398) -> the QR rescue of each,
    5. apply the first input and step the plant with the perfect model
       x0 = xOpt[:, 1] (:416-419), record, stop at the goal or k == 30
       (:345, :431).

One problem is a batch of B = 1 for the port's batched solver; its
candidates are the multistart's lanes. The solvers are built once per
(variant, N, candidates, kkt) and cached; the bookkeeping stays numpy on
the host, and only the solves run on the card (unless ``device`` says
otherwise). The batched rollout over many worlds is
:mod:`.scan_loop`.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from ..models import OBCASpec, build_obca_data, init_vars
from ..scenarios import build_scenario
from ..scenarios.demos import DemoSpec, MPCParams
from ..solver import IPMOptions, make_obca_solver
from ..utils.metrics import MetricsLogger
from . import astar_host
from .multistart import candidate_inits, make_multistart_solver
from .reference import (goal_reached, reinterpolate_openloop, splice_previous_plan,
                        window_reference)


@dataclasses.dataclass
class StepRecord:
    k: int
    fixtime: bool
    feas: bool
    fallback: bool          # fix-time needed the no-terminal fallback
    x: np.ndarray           # state after applying the step (3,)
    u: np.ndarray           # applied input (2,)
    Ts_opt: float
    x_open_loop: np.ndarray  # (N+1, 3) predicted open-loop plan
    iters: int
    kkt_err: float
    solve_ms: float = 0.0
    dyn_vertices: Optional[list] = None  # per dyn obstacle (4,2) + sensed flag


@dataclasses.dataclass
class ClosedLoopResult:
    demo: str
    reached_goal: bool
    aborted_infeasible: bool
    steps: list
    x_ref: np.ndarray       # the A* reference path (3, L)

    @property
    def x_history(self):
        return np.stack([s.x for s in self.steps])

    @property
    def u_history(self):
        return np.stack([s.u for s in self.steps])

    @property
    def ts_history(self):
        return np.asarray([s.Ts_opt for s in self.steps])


class ClosedLoopRunner:
    """Host-side closed-loop MPC driver for one demo.

    ``metrics`` (a :class:`MetricsLogger`, made here when None) gets per
    replan ``replan_ms`` (the solve ladder, ending in the host read of its
    feasibility), ``prep_ms``, ``iters`` and the counters ``replans``,
    ``freetime_steps``, ``fixtime_steps``, ``fallbacks``, ``infeasible`` and
    ``qr_rescues``. With ``record_problems`` every replan's NLP is kept in
    ``problems`` (spec, data, the winning candidate's start, the result,
    the world state it was built from). ``impl`` and ``loop`` go to the
    solvers (:func:`..solver.make_obca_solver`).
    """

    def __init__(self, demo: DemoSpec, params: MPCParams = None,
                 ipm_options: IPMOptions = None, dtype=torch.float64,
                 max_steps: int = 30, metrics=None, record_problems: bool = False,
                 device=torch.device("cuda"), impl=None, loop=None):
        self.demo = demo
        self.record_problems = record_problems
        self.problems = []
        self.metrics = MetricsLogger() if metrics is None else metrics
        self.p = params or demo.params
        self.dtype = dtype
        self.device = torch.device(device)
        self.max_steps = max_steps  # src/closed_loop.py:431 caps k at 30
        self.impl, self.loop = impl, loop
        self.scn, self.shape = build_scenario(demo, dtype=dtype, device=self.device)
        # host copies of the world the bookkeeping reads
        self._dyn_info = self.scn.dyn_info.cpu().double().numpy()
        self._d_mask = self.scn.d_mask.cpu().numpy()
        # acceptable-level defaults of the JAX package's runner: at exactly
        # dmin clearance the contact duals only polish to ~1e-3
        self.opt = ipm_options or IPMOptions(max_iters=100, acceptable_tol=5e-3,
                                             feas_tol=1e-4)
        self._solvers = {}

    def _t(self, a):
        return torch.as_tensor(np.asarray(a), device=self.device).to(self.dtype)

    def _solver(self, variant: str, N: int, n_candidates: int, kkt: str = None):
        """(spec, multistart solver), built once per (variant, N,
        n_candidates, kkt). ``kkt="qr"`` is the last rescue rung: a
        Householder QR of the full saddle system, for the degenerate
        contacts where the AL path rejects every regularization rung."""
        key = (variant, N, n_candidates, kkt)
        if key not in self._solvers:
            spec = OBCASpec(N=N, n_obs=self.shape.n_obs, e_max=self.shape.e_max,
                            variant=variant)
            opt = self.opt if kkt is None else dataclasses.replace(self.opt, kkt=kkt)
            base = make_obca_solver(spec, opt, impl=self.impl, loop=self.loop)
            self._solvers[key] = (spec, make_multistart_solver(spec, base, init_vars,
                                                               n_candidates))
        return self._solvers[key]

    def _msolve(self, msolve, data, cands):
        """One multistart solve of the B = 1 problem ``data`` from the host
        candidates (nC, 3, N+1): (picked result, best index)."""
        res, best = msolve(data, self._t(np.stack(cands))[None])
        return res, int(best[0])

    def _data(self, spec, x0, u0, xref, Ts, **kw):
        return build_obca_data(spec, self.scn, x0=self._t(x0)[None], u0=self._t(u0),
                               xref=xref[None], Ts=Ts, **kw)

    def _dyn_boxes(self, N, sensed, dyn_pos, Ts_pred):
        """(N+1, 4) union bbox of sensed dynamic obstacles per horizon step."""
        boxes = np.full((N + 1, 4), np.nan)
        any_obs = False
        for i, row in enumerate(self._dyn_info):
            if not sensed[i]:
                continue
            any_obs = True
            th, L, W, v = row[2], row[3], row[4], row[5]
            c, s = math.cos(th), math.sin(th)
            ex = abs(L / 2 * c) + abs(W / 2 * s)
            ey = abs(L / 2 * s) + abs(W / 2 * c)
            for k in range(N + 1):
                cx = dyn_pos[i, 0] + k * Ts_pred * v * c
                cy = dyn_pos[i, 1] + k * Ts_pred * v * s
                b = [cx - ex, cy - ey, cx + ex, cy + ey]
                if np.isnan(boxes[k, 0]):
                    boxes[k] = b
                else:
                    boxes[k] = [min(boxes[k, 0], b[0]), min(boxes[k, 1], b[1]),
                                max(boxes[k, 2], b[2]), max(boxes[k, 3], b[3])]
        return boxes if any_obs else None

    # --- world simulation -------------------------------------------------

    def _advance_obstacles(self, k, Ts_opt, dyn_pos):
        """src/closed_loop.py:445-486: appear at start_time, then translate.
        Returns (dyn_pos, appeared (nD,) bool)."""
        appeared = np.zeros(len(self._dyn_info), bool)
        for i, row in enumerate(self._dyn_info):
            if not bool(self._d_mask[i]):
                continue
            start_t = row[9]
            if k == start_t:
                appeared[i] = True
            elif k > start_t:
                v, th = row[5], row[2]
                dyn_pos[i, 0] += Ts_opt * v * math.cos(th)
                dyn_pos[i, 1] += Ts_opt * v * math.sin(th)
                appeared[i] = True
        return dyn_pos, appeared

    def _sense(self, x0, dyn_pos, appeared):
        """src/closed_loop.py:591-630: lidar at the car front; an obstacle
        is sensed when any of its 4 vertices is within senseDis."""
        ego_l = self.p.ego[0]
        front = np.array([x0[0] + ego_l * math.cos(x0[2]),
                          x0[1] + ego_l * math.sin(x0[2])])
        sense_dis = float(self.scn.sense_dis)
        sensed = np.zeros(len(self._dyn_info), bool)
        verts_out = []
        for i, row in enumerate(self._dyn_info):
            if not appeared[i]:
                verts_out.append(None)
                continue
            cx, cy = dyn_pos[i]
            th, L, W = row[2], row[3], row[4]
            c, s = math.cos(th), math.sin(th)
            hl, hw = L / 2, W / 2
            verts = np.array([
                [cx - hl * c - hw * s, cy - hl * s + hw * c],
                [cx + hl * c - hw * s, cy + hl * s + hw * c],
                [cx + hl * c + hw * s, cy + hl * s - hw * c],
                [cx - hl * c + hw * s, cy - hl * s - hw * c],
            ])
            d = np.sqrt(((verts - front) ** 2).sum(axis=1))
            sensed[i] = bool(np.any(d <= sense_dis))
            verts_out.append((verts, sensed[i]))
        return sensed, verts_out

    def _reference(self):
        """The A* reference path (3, L), computed once per run
        (src/closed_loop.py:329), and it on the device."""
        ref = astar_host.reference_path_for(self.scn.grid.cpu().numpy(),
                                            self.demo.start, self.demo.goal)
        return ref, self._t(ref)

    # --- main loop --------------------------------------------------------

    def run(self, verbose: bool = False) -> ClosedLoopResult:
        demo, p = self.demo, self.p
        ref, ref_t = self._reference()
        L = ref.shape[1]

        x0 = np.asarray(demo.start, float)
        u0 = np.zeros(2)
        Ts_cur = p.Ts           # mutated by the fix-time re-interpolation
        Ts_opt = p.Ts
        N_free, N_fix = p.N_free, p.N_fix
        x_prev_plan = None      # previous open-loop plan (3, N+1)
        goal = np.asarray(demo.goal, float)
        dyn_pos = self._dyn_info[:, :2].copy()
        spawn_pos = dyn_pos.copy()
        bounds = dict(v_max=p.v_max, w_max=p.w_max, a_max=p.a_max,
                      alpha_max=p.alpha_max, ego=p.ego, dmin=p.dmin)
        fix_w = dict(q=p.q_fix, r1=p.r1_fix, r2=p.r2_fix, **bounds)

        steps = []
        aborted = False
        k = 0
        while not goal_reached(x0, goal):
            dyn_pos, appeared = self._advance_obstacles(k, Ts_opt, dyn_pos)
            sensed, dyn_verts = self._sense(x0, dyn_pos, appeared)
            fixtime = bool(np.any(sensed))

            t_prep = time.time()
            if k == 0 or not fixtime:
                xref = window_reference(ref_t, L, self._t(x0), N_free)
                spec, msolve = self._solver("free", N_free, 2)
                data = self._data(spec, x0, u0, xref, Ts_cur, q=p.q_free, r1=p.r1_free,
                                  r2=p.r2_free, time_c1=p.time_c1, time_c2=p.time_c2,
                                  **bounds)
                prev = x_prev_plan if (
                    x_prev_plan is not None and x_prev_plan.shape[1] == N_free + 1) else None
                cands = candidate_inits(xref.cpu().numpy(), x0, prev_plan=prev)[:2]
                while len(cands) < 2:
                    cands.append(cands[0])
                # host prep (windowing, data, candidates) is timed apart
                # from the solve ladder
                t_solve = time.time()
                res, best = self._msolve(msolve, data, cands)
                feas = bool(res.feas[0])
                fallback = False
                Ts_opt = float(res.z["T"][0]) * Ts_cur  # src/obca.py:1059
                if not feas:
                    # free-branch fallback (beyond the reference, which
                    # aborts here): the fixed-time no-terminal NLP
                    # (obca_mpc8, src/obca.py:1415) escapes the free-time
                    # NLP's local infeasibilities
                    spec8, msolve8 = self._solver("fix_free_end", N_free, 2)
                    data8 = self._data(spec8, x0, u0, xref, Ts_cur, **fix_w)
                    res, best = self._msolve(msolve8, data8, cands)
                    feas = bool(res.feas[0])
                    fallback = True
                    Ts_opt = Ts_cur
                    data, spec = data8, spec8  # last_failure's problem == res's
                    if not feas:
                        # last rescue rung: the QR saddle solve
                        spec, msolveq = self._solver("fix_free_end", N_free, 2, kkt="qr")
                        res, best = self._msolve(msolveq, data8, cands)
                        feas = bool(res.feas[0])
                        self.metrics.bump("qr_rescues")
            else:
                xref = window_reference(ref_t, L, self._t(x0), N_fix)
                if x_prev_plan is not None:
                    xref = splice_previous_plan(xref, self._t(x_prev_plan), N_fix - 5)
                xref, N_new = reinterpolate_openloop(xref, N_free, N_fix)
                Ts_opt = (N_free * Ts_opt) / N_new  # src/closed_loop.py:586
                Ts_cur = Ts_opt                     # :587 feedback
                N_fix = N_new
                terminal_set = demo.terminal_policy.resolve(x0)

                spec, msolve = self._solver("fix_terminal", N_fix, 5)
                data = self._data(spec, x0, u0, xref, Ts_cur, dyn_active=self._t(sensed),
                                  dyn_delta=self._t(dyn_pos - spawn_pos), Ts_pred=Ts_opt,
                                  terminal_set=self._t(terminal_set), **fix_w)
                boxes = self._dyn_boxes(N_fix, sensed, dyn_pos, Ts_opt)
                prev = x_prev_plan if (
                    x_prev_plan is not None and x_prev_plan.shape[1] == N_fix + 1) else None
                cands = candidate_inits(
                    xref.cpu().numpy(), x0, dyn_boxes=boxes,
                    y_bounds=(float(self.scn.x_lo[1]), float(self.scn.x_hi[1])),
                    prev_plan=prev)
                while len(cands) < 5:
                    cands.append(cands[0])
                cands = cands[:5]
                t_solve = time.time()
                res, best = self._msolve(msolve, data, cands)
                feas = bool(res.feas[0])
                fallback = False
                if not feas:  # src/closed_loop.py:393-398
                    spec8, msolve8 = self._solver("fix_free_end", N_fix, 5)
                    res, best = self._msolve(msolve8, data, cands)
                    feas = bool(res.feas[0])
                    fallback = True
                    spec = spec8
                if not feas:
                    # last rescue rung: QR saddle solve of the terminal-set
                    # NLP, then of the no-terminal one
                    for var in ("fix_terminal", "fix_free_end"):
                        spec, msolveq = self._solver(var, N_fix, 5, kkt="qr")
                        res, best = self._msolve(msolveq, data, cands)
                        feas = bool(res.feas[0])
                        self.metrics.bump("qr_rescues")
                        fallback = var == "fix_free_end"
                        if feas:
                            break
            solve_ms = (time.time() - t_solve) * 1e3
            prep_ms = (t_solve - t_prep) * 1e3
            iters = int(res.iters[0])
            if self.record_problems:
                self.problems.append({
                    "k": k, "fixtime": fixtime, "fallback": fallback,
                    "spec": spec, "data": data,
                    "x_init": np.asarray(cands[min(best, len(cands) - 1)]), "res": res,
                    # the world state the data tensors were built from
                    "dyn_delta": (dyn_pos - spawn_pos).copy(),
                    "sensed": sensed.copy(),
                })
            self.metrics.record("replan_ms", solve_ms)
            self.metrics.record("prep_ms", prep_ms)
            self.metrics.record("iters", iters)
            self.metrics.bump("replans")
            self.metrics.bump("fixtime_steps" if fixtime else "freetime_steps")
            if fallback:
                self.metrics.bump("fallbacks")
            if not feas:
                self.metrics.bump("infeasible")

            x_plan = res.z["x"][0].cpu().double().numpy()
            u_plan = res.z["u"][0].cpu().double().numpy()
            kkt_err = float(res.kkt_err[0])

            if not feas:
                aborted = True
                # the failing problem, for offline diagnosis
                self.last_failure = {
                    "k": k, "fixtime": fixtime, "data": data, "res": res,
                    "N_fix": N_fix, "x0": x0.copy(), "u0": u0.copy(),
                    "Ts_cur": Ts_cur, "Ts_opt": Ts_opt,
                }
                steps.append(StepRecord(
                    k=k, fixtime=fixtime, feas=False, fallback=fallback, x=x0.copy(),
                    u=u0.copy(), Ts_opt=Ts_opt, x_open_loop=x_plan.T, iters=iters,
                    kkt_err=kkt_err, solve_ms=solve_ms, dyn_vertices=dyn_verts))
                if verbose:
                    print(f"step {k}: MPC failed (fixtime={int(fixtime)})")
                break

            u0 = u_plan[:, 0]
            x0 = x_plan[:, 1]          # perfect-model plant step
            x_prev_plan = x_plan
            steps.append(StepRecord(
                k=k, fixtime=fixtime, feas=True, fallback=fallback, x=x0.copy(),
                u=u0.copy(), Ts_opt=Ts_opt, x_open_loop=x_plan.T, iters=iters,
                kkt_err=kkt_err, solve_ms=solve_ms, dyn_vertices=dyn_verts))
            if verbose:
                print(f"step {k}: fixtime={int(fixtime)} feas=1 Ts_opt={Ts_opt:.3f} "
                      f"x={np.round(x0, 3)} ({iters} it, {solve_ms:.0f} ms)")

            k += 1
            if k == self.max_steps:  # src/closed_loop.py:431
                break

        return ClosedLoopResult(demo=demo.name, reached_goal=bool(goal_reached(x0, goal)),
                                aborted_infeasible=aborted, steps=steps, x_ref=ref)

    # --- legacy drivers -----------------------------------------------------

    def run_legacy(self, mode: str = "mpc1", verbose: bool = False) -> ClosedLoopResult:
        """Legacy closed-loop drivers over the same solver variants.

        ``mode="mpc1"`` reproduces ``closedLoop.closed_loop_mpc``
        (src/closed_loop.py:142-209): every step is a free-time solve with
        the obstacle constraints static-only (dynamic obstacles move in the
        world but are invisible to the solver), no sensor, no mode switch.

        ``mode="mpc3"`` reproduces ``closed_loop_mpc3`` (:211-321): the
        sensor-driven switch of the live driver, but the fix-time branch
        takes the demo's configured terminal set and re-interpolates the
        windowed reference without splicing the previous plan.
        """
        if mode not in ("mpc1", "mpc3"):
            raise ValueError(f"mode must be 'mpc1' or 'mpc3', got {mode!r}")
        demo, p = self.demo, self.p
        ref, ref_t = self._reference()
        L = ref.shape[1]

        x0 = np.asarray(demo.start, float)
        u0 = np.zeros(2)
        Ts_cur = p.Ts
        Ts_opt = p.Ts
        N_free, N_fix = p.N_free, p.N_fix
        goal = np.asarray(demo.goal, float)
        dyn_pos = self._dyn_info[:, :2].copy()
        spawn_pos = dyn_pos.copy()
        no_dyn = torch.zeros(self.scn.d_mask.shape, dtype=self.dtype, device=self.device)
        bounds = dict(v_max=p.v_max, w_max=p.w_max, a_max=p.a_max,
                      alpha_max=p.alpha_max, ego=p.ego, dmin=p.dmin)

        steps = []
        aborted = False
        k = 0
        while not goal_reached(x0, goal):
            dyn_pos, appeared = self._advance_obstacles(k, Ts_opt, dyn_pos)
            if mode == "mpc3":
                sensed, dyn_verts = self._sense(x0, dyn_pos, appeared)
                fixtime = bool(np.any(sensed))
            else:
                sensed = np.zeros(len(dyn_pos), bool)
                dyn_verts = None
                fixtime = False

            t_solve = time.time()
            if not fixtime:
                # free time against static obstacles only
                # (src/closed_loop.py:163,241: dynObs_exist = 0)
                xref = window_reference(ref_t, L, self._t(x0), N_free)
                spec, msolve = self._solver("free", N_free, 2)
                data = self._data(spec, x0, u0, xref, Ts_cur, dyn_active=no_dyn,
                                  q=p.q_free, r1=p.r1_free, r2=p.r2_free,
                                  time_c1=p.time_c1, time_c2=p.time_c2, **bounds)
                cands = candidate_inits(xref.cpu().numpy(), x0)[:2]
                while len(cands) < 2:
                    cands.append(cands[0])
                res, _ = self._msolve(msolve, data, cands)
                feas = bool(res.feas[0])
                fallback = False
                Ts_opt = float(res.z["T"][0]) * Ts_cur
            else:
                # fix time: window at N_fix, re-interpolate (no splice,
                # src/closed_loop.py:247-249), the configured terminal set
                xref = window_reference(ref_t, L, self._t(x0), N_fix)
                xref, N_new = reinterpolate_openloop(xref, N_free, N_fix)
                Ts_opt = (N_free * Ts_opt) / N_new
                Ts_cur = Ts_opt
                N_fix = N_new
                terminal_set = np.array(demo.terminal_policy.base, float)

                spec, msolve = self._solver("fix_terminal", N_fix, 5)
                data = self._data(spec, x0, u0, xref, Ts_cur, dyn_active=self._t(sensed),
                                  dyn_delta=self._t(dyn_pos - spawn_pos), Ts_pred=Ts_opt,
                                  terminal_set=self._t(terminal_set), q=p.q_fix,
                                  r1=p.r1_fix, r2=p.r2_fix, **bounds)
                boxes = self._dyn_boxes(N_fix, sensed, dyn_pos, Ts_opt)
                cands = candidate_inits(
                    xref.cpu().numpy(), x0, dyn_boxes=boxes,
                    y_bounds=(float(self.scn.x_lo[1]), float(self.scn.x_hi[1])))
                while len(cands) < 5:
                    cands.append(cands[0])
                cands = cands[:5]
                res, _ = self._msolve(msolve, data, cands)
                feas = bool(res.feas[0])
                fallback = False
                if not feas:  # src/closed_loop.py:274-279
                    _, msolve8 = self._solver("fix_free_end", N_fix, 5)
                    res, _ = self._msolve(msolve8, data, cands)
                    feas = bool(res.feas[0])
                    fallback = True
            solve_ms = (time.time() - t_solve) * 1e3
            self.metrics.record("replan_ms", solve_ms)
            self.metrics.bump("replans")

            x_plan = res.z["x"][0].cpu().double().numpy()
            u_plan = res.z["u"][0].cpu().double().numpy()
            steps.append(StepRecord(
                k=k, fixtime=fixtime, feas=feas, fallback=fallback,
                x=(x_plan[:, 1] if feas else x0).copy(),
                u=(u_plan[:, 0] if feas else u0).copy(), Ts_opt=Ts_opt,
                x_open_loop=x_plan.T, iters=int(res.iters[0]),
                kkt_err=float(res.kkt_err[0]), solve_ms=solve_ms, dyn_vertices=dyn_verts))
            if not feas:
                aborted = True
                if verbose:
                    print(f"step {k}: legacy {mode} MPC failed")
                break
            u0 = u_plan[:, 0]
            x0 = x_plan[:, 1]
            if verbose:
                print(f"step {k}: {mode} fixtime={int(fixtime)} "
                      f"Ts_opt={Ts_opt:.3f} x={np.round(x0, 3)}")
            k += 1
            if k == self.max_steps:
                break

        return ClosedLoopResult(demo=demo.name, reached_goal=bool(goal_reached(x0, goal)),
                                aborted_infeasible=aborted, steps=steps, x_ref=ref)


def run_closed_loop(demo_name: str, **kw) -> ClosedLoopResult:
    """Convenience entry mirroring ``simulation.run_closedLoop``
    (src/simulation.py:64-112): ``kw`` goes to :class:`ClosedLoopRunner`
    (``verbose`` to its ``run``)."""
    from ..scenarios import get_demo

    verbose = kw.pop("verbose", False)
    return ClosedLoopRunner(get_demo(demo_name), **kw).run(verbose=verbose)


__all__ = ["ClosedLoopResult", "ClosedLoopRunner", "StepRecord", "run_closed_loop"]
