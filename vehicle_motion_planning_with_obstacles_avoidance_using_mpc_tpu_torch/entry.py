"""The port's normal problems: the entry replan, bench's free-time batch
and bench's production fix-time step.

``demo1_problem`` mirrors the JAX package's ``__graft_entry__._demo1_problem``
(one free-time replan, demo1, N = 6, reference window from the A* path).
``demo9_window_batch`` mirrors ``bench.py:128-150``: the free-time NLP on
demo9 at N = 10 for B replan problems whose x0 sit at points along the A*
path drawn by ``np.random.RandomState(0)``. ``BENCH_FREE_OPTIONS`` are
the tuned free-time options of ``bench.py:170-173``.

``fix_fixture_batch`` mirrors ``bench.py:316-376``: the 98 recorded real
fix-time replans of ``goldens/bench_fix_fixture.npz`` (demos 1, 2, 3, 5)
tiled to B lanes, with their 5 multistart candidates. ``make_fix_step``
is the step bench and the scanned loop run on them: the mpc6 -> mpc8
ladder (``bench.py:407-428``) with ``FIX6_OPTIONS``/``FIX8_OPTIONS``
(``bench.py:393-404``), optionally followed by the two QR rescue rungs of
``runtime/scan_loop.py:273-294``.

Every function here that makes a problem puts its tensors on the card
unless ``device`` says otherwise.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .models import OBCASpec, build_obca_data, init_vars
from .models.obca import OBCAData
from .runtime import astar_host
from .runtime.multistart import candidate_inits_traced, make_multistart_solver
from .runtime.reference import window_reference
from .scenarios import build_scenario, get_demo
from .solver import IPMOptions, make_obca_solver

BENCH_FREE_OPTIONS = IPMOptions(
    max_iters=100, tol=1e-4, acceptable_tol=5e-3, feas_tol=1e-3,
    n_deltas=1, n_refine=1, n_backtracks=8, acceptable_iter=1,
)

ENTRY_OPTIONS = IPMOptions(max_iters=60)

# mpc6, the rung with a fallback behind it, stalls aggressively; mpc8, the
# last rung, keeps the viol-gated stall and a second refinement pass
FIX6_OPTIONS = IPMOptions(
    max_iters=100, tol=1e-4, acceptable_tol=5e-3, feas_tol=1e-3, n_deltas=2,
    stall_iters=10, stall_viol_gate=False, acceptable_iter=1, n_backtracks=8,
    n_refine=1,
)
FIX8_OPTIONS = IPMOptions(
    max_iters=100, tol=1e-4, acceptable_tol=5e-3, feas_tol=1e-3, n_deltas=2,
    stall_iters=20, acceptable_iter=1, n_backtracks=8, n_refine=2,
)
N_CAND_FIX = 5

FIX_FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "goldens", "bench_fix_fixture.npz")


def demo1_problem(dtype=torch.float32, device=torch.device("cuda")):
    """One replan-step NLP (B = 1): demo1, free time, N = 6.

    Returns ``(spec, data, scn, shape)``.
    """
    demo = get_demo("demo1")
    scn, shape = build_scenario(demo, dtype=dtype, device=device)
    N = 6
    spec = OBCASpec(N=N, n_obs=shape.n_obs, e_max=shape.e_max, variant="free")
    ref = astar_host.reference_path_for(scn.grid.cpu().numpy(), demo.start,
                                        demo.goal)
    refj = torch.as_tensor(ref, dtype=dtype, device=device)
    x0 = scn.start[None]
    xref = window_reference(refj, ref.shape[1], x0, N)
    data = build_obca_data(spec, scn, x0=x0, u0=torch.zeros(2, dtype=dtype),
                           xref=xref, Ts=0.1)
    return spec, data, scn, shape


def demo9_starts(B):
    """Indices along the demo9 A* path of bench's B replan starts, and
    the path itself ((3, L) float64)."""
    demo = get_demo("demo9")
    scn, _ = build_scenario(demo, dtype=torch.float64, device="cpu")
    ref = astar_host.reference_path_for(scn.grid.numpy(), demo.start,
                                        demo.goal)
    rng = np.random.RandomState(0)
    starts = np.sort(rng.randint(0, ref.shape[1] - 2, size=B))
    return starts, ref


def demo9_window_batch(B, N=10, dtype=torch.float32, device=torch.device("cuda"),
                       starts=None):
    """bench.py's headline batch: demo9, free time, horizon N, B lanes.

    ``starts`` optionally selects a subset of the lane indices of the
    B = 256 batch's path points (e.g. ``starts[::32]``); by default the
    first ``B`` draws of ``RandomState(0)`` as bench.py makes them.
    Returns ``(spec, data, scn, shape)``.
    """
    demo = get_demo("demo9")
    scn, shape = build_scenario(demo, dtype=dtype, device=device)
    spec = OBCASpec(N=N, n_obs=shape.n_obs, e_max=shape.e_max, variant="free")
    if starts is None:
        starts, ref = demo9_starts(B)
    else:
        _, ref = demo9_starts(1)
    refj = torch.as_tensor(ref, dtype=dtype, device=device)
    x0s = refj[:, torch.as_tensor(np.asarray(starts), device=device)].T
    xref = window_reference(refj, ref.shape[1], x0s, N)
    data = build_obca_data(spec, scn, x0=x0s, u0=torch.zeros(2, dtype=dtype),
                           xref=xref, Ts=0.1)
    return spec, data, scn, shape


def fix_fixture_batch(B=256, dtype=torch.float32, device=torch.device("cuda"),
                      rows=None):
    """bench.py's fix-time step batch: fixture row ``b % 98`` on lane b
    (or the fixture rows ``rows``), every demo built with one shared
    ShapeSpec. Returns ``(spec6, spec8, data, cands)``: the
    ``fix_terminal`` and ``fix_free_end`` specs, the OBCAData of the
    ``fix_terminal`` NLP (both variants read the same data) and the
    (B, 5, 3, N+1) candidates with the predicted-obstacle dodge boxes."""
    fx = np.load(FIX_FIXTURE)
    n_rows = fx["x0"].shape[0]
    Nf = fx["xref"].shape[-1] - 1
    lane_rows = np.arange(B) % n_rows if rows is None else np.asarray(rows)
    B = lane_rows.shape[0]
    demo_of = fx["demo"][lane_rows]
    fix_demos = sorted(set(fx["demo"].tolist()))
    scns, shape = {}, None
    for nm in fix_demos:
        scns[nm], shape = build_scenario(get_demo(nm), shape, dtype=dtype,
                                         device=device)
    spec6 = OBCASpec(N=Nf, n_obs=shape.n_obs, e_max=shape.e_max,
                     variant="fix_terminal")
    spec8 = dataclasses.replace(spec6, variant="fix_free_end")
    p = get_demo(fix_demos[0]).params
    take = lambda k: torch.as_tensor(fx[k][lane_rows], device=device).to(dtype)
    x0, u0, xref, Ts = take("x0"), take("u0"), take("xref"), take("Ts")
    tset, delta, sensed = take("terminal_set"), take("dyn_delta"), take("sensed")

    parts, order = [], []
    boxes = torch.empty((B, Nf + 1, 4), dtype=dtype, device=device)
    y_lo = torch.empty((B,), dtype=dtype, device=device)
    y_hi = torch.empty_like(y_lo)
    for nm in fix_demos:
        sel = np.nonzero(demo_of == nm)[0]
        if sel.size == 0:
            continue
        r = torch.as_tensor(sel, device=device)
        scn = scns[nm]
        parts.append(build_obca_data(
            spec6, scn, x0=x0[r], u0=u0[r], xref=xref[r], Ts=Ts[r],
            dyn_active=sensed[r], dyn_delta=delta[r], Ts_pred=Ts[r],
            terminal_set=tset[r], q=p.q_fix, r1=p.r1_fix, r2=p.r2_fix,
            v_max=p.v_max, w_max=p.w_max, a_max=p.a_max,
            alpha_max=p.alpha_max, ego=p.ego, dmin=p.dmin))
        order.append(sel)
        # dodge boxes of the predicted obstacle positions (bench.py:350-367)
        info = scn.dyn_info
        th_o = info[:, 2]
        ex = (torch.abs(info[:, 3] / 2 * torch.cos(th_o))
              + torch.abs(info[:, 4] / 2 * torch.sin(th_o)))
        ey = (torch.abs(info[:, 3] / 2 * torch.sin(th_o))
              + torch.abs(info[:, 4] / 2 * torch.cos(th_o)))
        ks = torch.arange(Nf + 1, dtype=dtype, device=device)
        centers = (info[None, None, :, :2] + delta[r][:, None]
                   + ks[None, :, None, None] * Ts[r][:, None, None, None]
                   * scn.d_vel[None, None])                    # (b, N+1, nD, 2)
        sm = sensed[r][:, None, :] > 0
        inf = torch.full((), float("inf"), dtype=dtype, device=device)
        boxes[r] = torch.stack([
            torch.where(sm, centers[..., 0] - ex, inf).amin(2),
            torch.where(sm, centers[..., 1] - ey, inf).amin(2),
            torch.where(sm, centers[..., 0] + ex, -inf).amax(2),
            torch.where(sm, centers[..., 1] + ey, -inf).amax(2)], dim=-1)
        y_lo[r], y_hi[r] = scn.x_lo[1], scn.x_hi[1]
    inv = torch.as_tensor(np.argsort(np.concatenate(order)), device=device)
    data = OBCAData(*[torch.cat(f, dim=0)[inv].contiguous() for f in zip(*parts)])
    cands = candidate_inits_traced(xref, x0, dyn_boxes=boxes,
                                   y_bounds=(y_lo, y_hi))
    return spec6, spec8, data, cands


def make_fix_step(spec6, spec8, opt6=FIX6_OPTIONS, opt8=FIX8_OPTIONS,
                  qr_rescue=False, impl=None):
    """The production fix-time step over a batch of problems.

    Returns ``step(data, cands) -> (res, rungs)``: mpc6, a 5-candidate
    multistart of ``spec6``; mpc8, the same of ``spec8``, run only on the
    mpc6-infeasible problems and polish-started from mpc6's iterate;
    merged as ``bench.py:420-428`` (``iters`` is the sum over the rungs).
    With ``qr_rescue`` two more rungs follow, ``kkt="qr"`` multistarts of
    ``spec6`` then ``spec8`` (options ``opt8`` with ``kkt="qr"``), each run
    only on the problems every earlier rung left infeasible, their primal
    fields selected in ladder order (``scan_loop.py:273-294``). ``rungs``
    holds each rung's own picked result, in ladder order.
    """
    def ms(spec, opt):
        return make_multistart_solver(
            spec, make_obca_solver(spec, opt, impl=impl), init_vars, N_CAND_FIX)

    ms6, ms8 = ms(spec6, opt6), ms(spec8, opt8)
    if qr_rescue:
        opt_qr = dataclasses.replace(opt8, kkt="qr")
        msq6, msq8 = ms(spec6, opt_qr), ms(spec8, opt_qr)

    def merge(res, r, use):
        """``res`` with the primal fields of rung ``r`` where ``use``; the
        rungs' feasibility and iterations accumulate."""
        m = lambda a, b: torch.where(use.view((-1,) + (1,) * (a.dim() - 1)), b, a)
        return res._replace(z={k: m(res.z[k], r.z[k]) for k in res.z},
                            f=m(res.f, r.f), viol=m(res.viol, r.viol),
                            kkt_err=m(res.kkt_err, r.kkt_err),
                            feas=res.feas | r.feas, iters=res.iters + r.iters)

    def step(data, cands):
        r6, _ = ms6(data, cands)
        r8, _ = ms8(data, cands, skip=r6.feas, z_override=r6.z)
        res = merge(r6, r8, ~r6.feas & r8.feas)
        rungs = [r6, r8]
        if qr_rescue:
            rq6, _ = msq6(data, cands, skip=res.feas)
            res = merge(res, rq6, ~res.feas)
            rq8, _ = msq8(data, cands, skip=res.feas)
            res = merge(res, rq8, ~res.feas)
            rungs += [rq6, rq8]
        return res, rungs

    return step
