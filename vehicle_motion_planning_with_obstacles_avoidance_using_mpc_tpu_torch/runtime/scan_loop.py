"""The closed-loop rollout over a batch of worlds.

PyTorch counterpart of the JAX package's ``runtime/scan_loop.py``
(``make_scan_rollout``; the receding-horizon loop of the reference's
``closed_loop_mpc4``, src/closed_loop.py:323-443). The JAX package writes
one world's loop as a ``lax.scan`` and ``vmap``s it over worlds; here the
B worlds are the leading dimension of every tensor and the steps are a
Python loop. Each step:

  1. moves the dynamic obstacles (src/closed_loop.py:445-486);
  2. senses them with the lidar; a sensed one switches the step to fix
     time, never on the first step;
  3. free-time branch: a 2-candidate multistart of the free-time NLP, its
     fallback (the fix_free_end NLP on the same window at ``Ts_cur`` with
     the fix weights) and the fallback's QR rescue;
  4. fix-time branch: the window spliced with the previous plan and
     re-interpolated, the terminal set, the dodge boxes of the predicted
     obstacles, then the ladder mpc6 -> mpc8 -> QR mpc6 -> QR mpc8, each a
     5-candidate multistart, selected in ladder order;
  5. picks the branch of its mode, applies the plan's first step and
     freezes a world that reached its goal or found no feasible plan.

Every rung is skip-gated as in the JAX package: a world iterates only the
rungs its mode and the rungs before reach (``make_multistart_solver``'s
``skip`` leaves the others out of the iterated batch). No duals are carried
from step to step (``warm=None``, see the JAX package's docstring).

Restriction, as in the JAX package: N_fix must equal N_free.
"""

from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace
from typing import NamedTuple

import torch

from ..models import OBCASpec, build_obca_data, init_vars
from ..ops import geometry
from ..scenarios.build import Scenario, ShapeSpec
from ..scenarios.demos import MPCParams
from ..solver import IPMOptions, make_obca_solver
from .multistart import candidate_inits_traced, dodge_boxes, make_multistart_solver
from .reference import reinterpolate_openloop, splice_previous_plan, window_reference

N_CAND_FREE = 2
N_CAND_FIX = 5
PRIMAL = ("x", "u", "lam", "mu")
RUNGS = ("free", "free_fb", "free_qr", "fix6", "fix8", "qr6", "qr8")
# the scan's own options on every rung (scan_loop.py:93-95), with kkt="qr"
# on the three QR rungs
SCAN_OPTIONS = IPMOptions(max_iters=100, acceptable_tol=5e-3, feas_tol=1e-4)


class LoopState(NamedTuple):
    """Per-world loop state, one row per world."""

    x0: torch.Tensor        # (B, 3)
    u0: torch.Tensor        # (B, 2)
    Ts_cur: torch.Tensor    # (B,) mutated sampling time (src/closed_loop.py:587)
    Ts_opt: torch.Tensor    # (B,) last optimal step duration
    dyn_pos: torch.Tensor   # (B, nD, 2)
    prev_plan: torch.Tensor  # (B, 3, N+1)
    k: torch.Tensor         # (B,) int32
    active: torch.Tensor    # (B,) bool: still replanning
    reached: torch.Tensor   # (B,) bool
    failed: torch.Tensor    # (B,) bool: aborted on infeasibility


def make_scan_rollout(shape: ShapeSpec, p: MPCParams = MPCParams(),
                      max_steps: int = 30, options: IPMOptions | None = None,
                      dtype=torch.float32, qr_rescue: bool = True,
                      device=torch.device("cuda"), impl=None):
    """Build ``rollout(scn, ref_path, ref_len, st0=None, profile=None) ->
    (final LoopState, traj)`` over a batch of B worlds.

    ``scn`` is a batched :class:`Scenario` of ``shape``; ``ref_path`` (B, 3,
    L) the reference paths (padding repeats the last column) and
    ``ref_len`` (B,) their valid lengths. Inputs are moved to ``device``
    and ``dtype``. ``traj`` holds, per world and step (leading (B,
    max_steps)): ``x``, ``u``, ``Ts_opt``, ``fixtime``, ``feas``, ``active``
    and ``plan``. ``st0`` continues from an earlier call's final state
    (``rollout.initial_state(scn)`` is the fresh one): two chained calls
    equal one call of the summed length. A ``profile`` list gets, per step,
    ``{rung: (worlds run, host-loop iterations, seconds)}`` for the rungs
    in :data:`RUNGS` (seconds on the host clock from the rung's start to
    its end; a rung that iterates waits for its device work).
    ``impl="plain"`` runs the kernels' plain versions.
    """
    if p.N_free != p.N_fix:
        raise NotImplementedError("scanned loop requires N_fix == N_free")
    N = p.N_free
    opt = options or SCAN_OPTIONS
    opt_qr = dataclasses.replace(opt, kkt="qr")

    def spec(variant):
        return OBCASpec(N=N, n_obs=shape.n_obs, e_max=shape.e_max, variant=variant)

    spec_free, spec_fixT, spec_fix8 = spec("free"), spec("fix_terminal"), spec("fix_free_end")

    def ms(sp, o, nC):
        return make_multistart_solver(sp, make_obca_solver(sp, o, impl=impl), init_vars, nC)

    ms_free = ms(spec_free, opt, N_CAND_FREE)
    ms_fixT = ms(spec_fixT, opt, N_CAND_FIX)
    ms_fix8 = ms(spec_fix8, opt, N_CAND_FIX)
    # free-branch fallback: the fix_free_end NLP escapes the free-time
    # NLP's local infeasibilities (closed_loop.py free branch)
    ms_fb = ms(spec_fix8, opt, N_CAND_FREE)
    if qr_rescue:
        ms_qrT = ms(spec_fixT, opt_qr, N_CAND_FIX)
        ms_qr8 = ms(spec_fix8, opt_qr, N_CAND_FIX)
        ms_qr_fb = ms(spec_fix8, opt_qr, N_CAND_FREE)

    def to_dev(t):
        return t.to(device=device, dtype=dtype if t.is_floating_point() else t.dtype)

    def initial_state(scn: Scenario) -> LoopState:
        """Fresh loop state of every world (also the carry format between
        chained calls, see ``rollout``'s ``st0``)."""
        scn = Scenario(*[to_dev(f) for f in scn])
        B = scn.start.shape[0]
        full = lambda v: torch.full((B,), v, dtype=dtype, device=device)
        flag = lambda v: torch.full((B,), v, dtype=torch.bool, device=device)
        return LoopState(
            x0=scn.start.clone(), u0=torch.zeros((B, 2), dtype=dtype, device=device),
            Ts_cur=full(p.Ts), Ts_opt=full(p.Ts), dyn_pos=scn.dyn_info[..., :2].clone(),
            prev_plan=scn.start[:, :, None].expand(B, 3, N + 1).clone(),
            k=torch.zeros((B,), dtype=torch.int32, device=device),
            active=flag(True), reached=flag(False), failed=flag(False))

    def rollout(scn: Scenario, ref_path, ref_len, st0: LoopState | None = None,
                profile=None):
        scn = Scenario(*[to_dev(f) for f in scn])
        ref_path = to_dev(torch.as_tensor(ref_path))
        ref_len = torch.as_tensor(ref_len, device=device)
        st = initial_state(scn) if st0 is None else st0
        B = scn.start.shape[0]
        info = scn.dyn_info
        spawn = info[..., :2]
        verts_spawn = geometry.rect_vertices(
            *info[..., :5].unbind(-1))[..., :4, :]                  # (B, nD, 4, 2)
        # ts_rel: -1 picks the appended 0 (JAX's x0_ext[-1])
        ts_idx = torch.where(scn.ts_rel < 0, 3, scn.ts_rel).long().reshape(B, 4)
        y_bounds = (scn.x_lo[:, 1], scn.x_hi[:, 1])
        weights = dict(v_max=p.v_max, w_max=p.w_max, a_max=p.a_max,
                       alpha_max=p.alpha_max, ego=p.ego, dmin=p.dmin)
        fix_w = dict(q=p.q_fix, r1=p.r1_fix, r2=p.r2_fix, **weights)

        outs = []
        for _ in range(max_steps):
            prof = {}

            def run(name, msolve, data, cands, skip):
                t0 = time.perf_counter()
                res, _ = msolve(data, cands, skip)
                prof[name] = (msolve.last["rows"], msolve.last["iters"],
                              time.perf_counter() - t0)
                return res

            k, active = st.k, st.active
            # 1. world update (src/closed_loop.py:445-486)
            live = scn.d_mask > 0
            started = k[:, None] > scn.d_start_time
            dyn_pos = st.dyn_pos + torch.where(
                (started & live)[..., None], st.Ts_opt[:, None, None] * scn.d_vel,
                torch.zeros((), dtype=dtype, device=device))
            appeared = (k[:, None] >= scn.d_start_time) & live

            # 2. lidar (src/closed_loop.py:591-630)
            th = st.x0[:, 2]
            front = st.x0[:, :2] + p.ego[0] * torch.stack([torch.cos(th), torch.sin(th)], 1)
            verts = verts_spawn + (dyn_pos - spawn)[:, :, None, :]
            dists = torch.sqrt(((verts - front[:, None, None, :]) ** 2).sum(-1))
            sensed = appeared & (dists.amin(-1) <= scn.sense_dis[:, None])
            fixtime = sensed.any(-1) & (k > 0)

            # 3. free-time branch
            xref_free = window_reference(ref_path, ref_len, st.x0, N)
            data_free = build_obca_data(
                spec_free, scn, x0=st.x0, u0=st.u0, xref=xref_free, Ts=st.Ts_cur,
                q=p.q_free, r1=p.r1_free, r2=p.r2_free, time_c1=p.time_c1,
                time_c2=p.time_c2, **weights)
            cands_f = candidate_inits_traced(xref_free, st.x0,
                                             prev_plan=st.prev_plan)[:, :N_CAND_FREE]
            res_free0 = run("free", ms_free, data_free, cands_f, fixtime | ~active)
            data_fb = build_obca_data(spec_fix8, scn, x0=st.x0, u0=st.u0,
                                      xref=xref_free, Ts=st.Ts_cur, **fix_w)
            res_fb = run("free_fb", ms_fb, data_fb, cands_f,
                         fixtime | ~active | res_free0.feas)
            res_fbq = res_fb
            if qr_rescue:
                res_fbq = run("free_qr", ms_qr_fb, data_fb, cands_f,
                              fixtime | ~active | res_free0.feas | res_fb.feas)
            use_fbq = ~res_free0.feas & ~res_fb.feas
            use_fb = ~res_free0.feas

            def mergef(a, b, c):
                sel = lambda m: m.view((-1,) + (1,) * (a.dim() - 1))
                return torch.where(sel(use_fbq), c, torch.where(sel(use_fb), b, a))

            res_free = SimpleNamespace(
                z={key: mergef(res_free0.z[key], res_fb.z[key], res_fbq.z[key])
                   for key in PRIMAL},
                feas=mergef(res_free0.feas, res_fb.feas, res_fbq.feas))
            Ts_opt_free = torch.where(use_fb, st.Ts_cur, res_free0.z["T"] * st.Ts_cur)

            # 4. fix-time branch (src/closed_loop.py:360-398)
            xref_fix = window_reference(ref_path, ref_len, st.x0, N)
            xref_fix = splice_previous_plan(xref_fix, st.prev_plan, max(N - 5, 0))
            xref_fix, _ = reinterpolate_openloop(xref_fix, N, N)
            Ts_fix = st.Ts_opt    # N * Ts_opt / N: the rescale is the identity
            x0_ext = torch.cat([st.x0, torch.zeros((B, 1), dtype=dtype, device=device)], 1)
            tset = scn.ts_base + torch.gather(x0_ext, 1, ts_idx).reshape(B, 2, 2)
            sensed_f = sensed.to(dtype)
            data_fix = build_obca_data(
                spec_fixT, scn, x0=st.x0, u0=st.u0, xref=xref_fix, Ts=Ts_fix,
                dyn_active=sensed_f, dyn_delta=dyn_pos - spawn, Ts_pred=Ts_fix,
                terminal_set=tset, **fix_w)
            boxes = dodge_boxes(info, dyn_pos, scn.d_vel, Ts_fix, sensed, N)
            cands_x = candidate_inits_traced(xref_fix, st.x0, dyn_boxes=boxes,
                                             y_bounds=y_bounds, prev_plan=st.prev_plan)
            not_fix = ~fixtime | ~active
            res_fixT = run("fix6", ms_fixT, data_fix, cands_x, not_fix)
            res_fix8 = run("fix8", ms_fix8, data_fix, cands_x, not_fix | res_fixT.feas)
            lads = [res_fixT, res_fix8]
            if qr_rescue:
                feas_68 = res_fixT.feas | res_fix8.feas
                res_qT = run("qr6", ms_qrT, data_fix, cands_x, not_fix | feas_68)
                res_q8 = run("qr8", ms_qr8, data_fix, cands_x,
                             not_fix | feas_68 | res_qT.feas)
                lads += [res_qT, res_q8]
            # the ladder as a masked select over the primal fields (the
            # variants differ in dual-row counts)
            feas_any = res_fixT.feas
            z_sel = {key: res_fixT.z[key] for key in PRIMAL}
            for r in lads[1:]:
                use = ~feas_any
                z_sel = {key: torch.where(use.view((-1,) + (1,) * (v.dim() - 1)),
                                          r.z[key], v) for key, v in z_sel.items()}
                feas_any = feas_any | r.feas

            # 5. mode selection + plant step (src/closed_loop.py:400-429)
            sel = fixtime
            pick = lambda a, b: torch.where(sel.view((-1,) + (1,) * (a.dim() - 1)), a, b)
            x_plan = pick(z_sel["x"], res_free.z["x"])
            u_plan = pick(z_sel["u"], res_free.z["u"])
            feas = pick(feas_any, res_free.feas)
            Ts_opt_new = pick(Ts_fix, Ts_opt_free)
            Ts_cur_new = pick(Ts_fix, st.Ts_cur)

            ok = active & feas
            okv = ok[:, None]
            x0_new = torch.where(okv, x_plan[:, :, 1], st.x0)
            u0_new = torch.where(okv, u_plan[:, :, 0], st.u0)
            prev_new = torch.where(ok[:, None, None], x_plan, st.prev_plan)
            reached = ((x0_new[:, 0] - scn.goal[:, 0]) ** 2
                       + (x0_new[:, 1] - scn.goal[:, 1]) ** 2) < 0.1
            st = LoopState(
                x0=x0_new, u0=u0_new,
                Ts_cur=torch.where(ok, Ts_cur_new, st.Ts_cur),
                Ts_opt=torch.where(ok, Ts_opt_new, st.Ts_opt),
                dyn_pos=torch.where(active[:, None, None], dyn_pos, st.dyn_pos),
                prev_plan=prev_new,
                k=k + active.to(torch.int32),
                active=active & feas & ~reached,
                reached=st.reached | (active & reached),
                failed=st.failed | (active & ~feas))
            outs.append({"x": x0_new, "u": u0_new, "Ts_opt": st.Ts_opt,
                         "fixtime": sel & active, "feas": feas, "active": active,
                         "plan": x_plan})
            if profile is not None:
                profile.append(prof)

        traj = {key: torch.stack([o[key] for o in outs], dim=1) for key in outs[0]}
        return st, traj

    rollout.initial_state = initial_state
    return rollout


__all__ = ["LoopState", "make_scan_rollout", "N_CAND_FREE", "N_CAND_FIX", "RUNGS",
           "SCAN_OPTIONS"]
