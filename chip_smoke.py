"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py               # all phases, one card
    python3 chip_smoke.py --phases 3    # phases 1-2, then only the listed ones

Phases, each of which raises (exit code != 0) when it fails:
  1. the card: nvidia-smi name and power limit, TF32 switched off;
  2. the kernel build (one nvcc per CUDA source, in parallel);
  3. every kernel against its plain PyTorch version on the card, in
     float64 and float32: at the free-time shapes (demo9 N = 10, B = 256,
     R = 1 and 2) and at the fix-time shapes of the production step
     (goldens/bench_fix_fixture.npz tiled to 256 rows x 5 candidates =
     1280 lanes, fix_terminal and fix_free_end, R = 2), kkt_qr at the fix
     shapes; at the rollout's shapes (R = 2): the sweep's free rung (step
     0, 1024 worlds x 2 candidates = 2048 lanes, N = 6) and demo8's N = 15
     replans (K = 60, np = 79, QR saddle order ~720) in all three
     variants, from its goldens' 30 closed-loop states; times (CUDA events) of the kernel, its plain version and, for
     spd_inv and kkt_qr, the PyTorch library call for the same function,
     at the free-time and the fix_terminal float32 shapes;
  4. the entry problem (demo1, N = 6, IPMOptions(max_iters=60)) through
     the kernels in float64 and float32; float64 must match the plain
     version run on the CPU (same iters, z within 1e-6);
  5. the free-time slice at full size: demo9_window_batch(256) with
     BENCH_FREE_OPTIONS in float32, through the kernels and through the
     plain versions on the card: feasible fraction, iterations,
     lane-iterations, solves/s (median of 3 timed reps after a warm-up);
  6. the production fix-time step: make_fix_step(qr_rescue=True) on
     fix_fixture_batch(256) in float32 (mpc6 -> mpc8 -> QR rescue, 1280
     solver lanes per rung), through the kernels (5 timed reps after a
     warm-up) and once through the plain versions: ladder feasible
     fraction (>= 0.99), the rows each rung made feasible, iterations per
     rung, steps/s, launches per kernel;
  7. the QR rescue rung on its own: the kkt="qr" fix_terminal multistart,
     no skip, on the first 32 fixture rows (160 lanes) in float32 through
     the kernels (kkt_qr must launch); then rows 0 and 1 in float64 on the
     card against the same solve run plain on the CPU (same iters, z
     within 1e-6);
  8. the random sweep at full width: sweep_inputs(1024, seed=0) in float32
     (1024 demo1-family worlds, reference paths from the wavefront A*
     kernels), then make_scan_rollout(max_steps=30, qr_rescue=True)
     through the kernels: failed_frac <= 0.03 and mean_progress_frac >=
     0.17 (the JAX package's float32 run of the same worlds:
     SWEEP_r04.json, 0.0104 and 0.1966); replans, wall seconds, replans/s,
     the rungs' world-steps and host-loop iterations per step, launches.
     Then 64 worlds x 3 steps through the kernels and through the plain
     versions, both feasible on every step;
  9. the 11 demos, 30 steps each in float32 through the kernels: no abort,
     end distance at most the golden's + 0.2 d0 (test_demos_e2e.py); demo1
     and demo3 also in float64: mode flags equal to goldens/demo*.npz and
     states within 1e-6 at every step;
then one JSON line of every kernel (launches on its main path, errors,
times, bound), the nvidia-smi line and the device line.

Tolerances (phase 3), max-normalised errors |k - p|_max / |p|_max over
the finite entries; non-finite entries must sit where the plain version
has them:
  * float64: <= 1e-9 on every output of the provider, the three Newton
    stages, the line search and kkt_qr (only the summation order, or the
    factorization, differs);
  * float32: <= 1e-3 on the provider, the Newton assembly and Schur
    stages and the line search. newton_al_solve and kkt_qr instead hold
    the saddle-system residual ||K sol - rhs||_inf / ||rhs||_inf
    (evaluated in float64) of every (lane, rung) the curvature test
    accepts to at most 3x the plain version's residual of the same
    (lane, rung), + 1e3 eps, because the kernels factor differently
    (direct Cholesky against the JAX package's block-Schur recursion;
    hand-written Householder QR against the library's) and float32
    rounding of an ill-conditioned saddle system moves the solution, not
    the residual. The AL solve's residual is not zero even in exact
    arithmetic (a fixed number of refinement steps): its limit is 3x the
    larger of the plain version's and the same algorithm's run in float64
    on the same inputs;
  * newton_al_solve and kkt_qr, both dtypes: the rung flags `good` agree
    (kkt_qr also with a NaN planted in W);
  * spd_inv, both dtypes: the backward error ||A X - I|| / (||A|| ||X||)
    <= 1e3 eps, and NaN (the non-SPD signal) where the plain version has
    it, except on a matrix whose smallest eigenvalue lies within
    SPD_BORDER * m * eps ||A|| of zero, where either answer is rounding;
  * astar_cost_to_go and astar_extract_path, both dtypes, at the sweep's
    1024 maps (11 x 40) and the demo9 (61 x 41) and demo10 (11 x 100)
    grids: the field and the relaxation counts equal bit for bit, the
    path and valid mask equal (the same additions and exact minima).

Bounds: the least time the card could take for a kernel's work, the
larger of bytes / 3.35 TB/s (each input read once, each output written
once) and the operations counted from the kernel's loops (dominant terms)
over the card's peak outside the tensor cores (67 TFLOP/s float32, 34
TFLOP/s float64; NVIDIA's H100 SXM data sheet, at a 700 W power limit).
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch"
JAX_PKG = "vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu"
REPLACES = {
    "obca_kkt_provider": f"{JAX_PKG}/models/obca_struct.py:292",
    "spd_inv": f"{JAX_PKG}/solver/ipm.py:317",
    "newton_assemble": f"{JAX_PKG}/solver/ipm.py:882",
    "newton_schur": f"{JAX_PKG}/solver/ipm.py:937",
    "newton_al_solve": f"{JAX_PKG}/solver/ipm.py:957",
    "step_linesearch": f"{JAX_PKG}/solver/ipm.py:1126",
    "kkt_qr": f"{JAX_PKG}/solver/ipm.py:1341",
    "astar_cost_to_go": f"{JAX_PKG}/ops/astar.py:45",
    "astar_extract_path": f"{JAX_PKG}/ops/astar.py:92",
}
ASTAR = ("astar_cost_to_go", "astar_extract_path")
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
# Width, in units of m * eps ||A||, of the band around a zero smallest
# eigenvalue where the direct Cholesky and the block-Schur recursion may
# disagree on whether an (m, m) matrix is SPD. Set from the readings of
# phase 3: the 22 of 2560 float32 m = 33 matrices where they disagree lie
# within 0.30 m eps ||A|| (PERF.md, PR 3). Higham's sufficient condition
# for Cholesky to succeed, lambda_min > 20 m^1.5 u ||A||_2 (u = eps / 2),
# is wider.
SPD_BORDER = 1.0
FUSED = ("obca_kkt_provider", "spd_inv", "newton_assemble", "newton_schur",
         "newton_al_solve", "step_linesearch")


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def no_jax(where):
    check("jax" not in sys.modules, f"jax was imported ({where})")


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps=20, warm=3):
    """Mean milliseconds per call, CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def max_err(k, p):
    """(max abs error, max-normalised error) over finite entries; NaN
    patterns must agree."""
    import torch

    fk, fp = torch.isfinite(k), torch.isfinite(p)
    check(bool((fk == fp).all()), "non-finite entries differ from the plain version")
    if not bool(fp.any()):
        return 0.0, 0.0
    d = (k - p)[fp].abs().max().item()
    scale = p[fp].abs().max().item()
    return d, d / max(scale, 1e-300)


def inv_backward_error(A, X):
    """Per-matrix ||A X - I||_inf / (||A||_inf ||X||_inf), worst finite."""
    import torch

    A64, X64 = A.double(), X.double()
    m = A.shape[-1]
    eye = torch.eye(m, dtype=torch.float64, device=A.device)
    R = A64 @ X64 - eye
    nrm = lambda M: M.abs().sum(-1).amax(-1)
    eta = nrm(R) / (nrm(A64) * nrm(X64))
    fin = torch.isfinite(X64).all(-1).all(-1)
    return eta[fin].max().item() if bool(fin.any()) else 0.0


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_moved, flops, dtype):
    """(bound_ms, bound_by) of work moving ``bytes_moved`` and doing
    ``flops`` operations in ``dtype`` on an H100 SXM."""
    t_b = bytes_moved / HBM_BYTES_PER_S
    t_f = flops / PEAK_FLOPS[str(dtype).replace("torch.", "")]
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


# ------------------------------------------------------------------ phases

def phase_card():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    line = (smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else
            f"nvidia-smi unavailable: {smi.stderr.strip()}")
    log(line)
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log(f"[card] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return line


def phase_build():
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.kernels import build

    t0 = time.time()
    info = build.build_all()
    log(f"[build] {time.time() - t0:.1f} s wall (nvcc in parallel)")
    for name in build.SOURCES:
        log(f"[build] {name}: {info[name]['path']}")
        for line in info[name]["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    for name in build.SOURCES:
        build.load(name)


def _rollout_problem(source, variant, dtype, dev, B=1024):
    """(spec, data, opt, candidates) of a rollout rung at the shapes the
    main path gives it, under the rollout's options: ``source`` "sweep" is
    step 0 of the sweep (B worlds x the 2 free-time candidates; N = 6, nO
    = 4); "demo8" (N = 15, K = 60, np = 79) the replans at the 30
    closed-loop states of goldens/demo8.npz, its dynamic obstacles moved
    by the recorded step durations and sensed, with the rung's candidates
    per state (2 free, 5 fix)."""
    import numpy as np
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        sweep_inputs)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
        OBCASpec, build_obca_data)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime import (
        astar_host)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime.multistart import (
        candidate_inits_traced, dodge_boxes)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime.reference import (
        reinterpolate_openloop, window_reference)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime.scan_loop import (
        N_CAND_FREE, SCAN_OPTIONS)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
        build_scenario, get_demo)

    if source == "sweep":
        scn, shape, p, ref, ref_len = sweep_inputs(B, seed=0, dtype=dtype, device=dev)
        x0 = scn.start
        u0 = torch.zeros((B, 2), dtype=dtype, device=dev)
        Ts = torch.full((B,), p.Ts, dtype=dtype, device=dev)
    else:
        demo = get_demo(source)
        p = demo.params
        scn, shape = build_scenario(demo, dtype=dtype, device=dev)
        check(bool((scn.d_start_time == 0).all()), f"{source}: obstacles start late")
        g = np.load(os.path.join(HERE, "goldens", f"{source}.npz"))
        path = astar_host.reference_path_for(scn.grid.cpu().numpy(), demo.start, demo.goal)
        ref = torch.as_tensor(path, device=dev).to(dtype)
        ref_len = path.shape[1]
        t = lambda a: torch.as_tensor(a, device=dev).to(dtype)
        # the state, input and step duration before each recorded step
        x0 = torch.cat([scn.start[None], t(g["x"][:-1])])
        u0 = torch.cat([torch.zeros((1, 2), dtype=dtype, device=dev), t(g["u"][:-1])])
        Ts = torch.cat([t([p.Ts]), t(g["ts"][:-1])])
        moved = torch.cat([t([0.0]), t(np.cumsum(g["ts"])[:-1])])
        B = x0.shape[0]
    N = p.N_free
    spec = OBCASpec(N=N, n_obs=shape.n_obs, e_max=shape.e_max, variant=variant)
    weights = dict(v_max=p.v_max, w_max=p.w_max, a_max=p.a_max,
                   alpha_max=p.alpha_max, ego=p.ego, dmin=p.dmin)
    xref = window_reference(ref, ref_len, x0, N)
    if variant == "free":
        data = build_obca_data(spec, scn, x0=x0, u0=u0, xref=xref, Ts=Ts, q=p.q_free,
                               r1=p.r1_free, r2=p.r2_free, time_c1=p.time_c1,
                               time_c2=p.time_c2, **weights)
        return spec, data, SCAN_OPTIONS, candidate_inits_traced(xref, x0)[:, :N_CAND_FREE]
    xref, _ = reinterpolate_openloop(xref, N, N)
    ts_idx = torch.where(scn.ts_rel < 0, 3, scn.ts_rel).long().reshape(4)
    x0_ext = torch.cat([x0, torch.zeros((B, 1), dtype=dtype, device=dev)], 1)
    delta = moved[:, None, None] * scn.d_vel
    sensed = torch.ones((B, scn.d_vel.shape[0]), dtype=torch.bool, device=dev)
    data = build_obca_data(
        spec, scn, x0=x0, u0=u0, xref=xref, Ts=Ts, dyn_active=sensed.to(dtype),
        dyn_delta=delta, Ts_pred=Ts,
        terminal_set=scn.ts_base + x0_ext[:, ts_idx].reshape(B, 2, 2),
        q=p.q_fix, r1=p.r1_fix, r2=p.r2_fix, **weights)
    boxes = dodge_boxes(scn.dyn_info, scn.dyn_info[:, :2] + delta, scn.d_vel, Ts, sensed, N)
    y_bounds = (scn.x_lo[1].expand(B), scn.x_hi[1].expand(B))
    return spec, data, SCAN_OPTIONS, candidate_inits_traced(xref, x0, dyn_boxes=boxes,
                                                            y_bounds=y_bounds)


def _stage_inputs(kind, dtype, dev, R):
    """Every kernel's inputs at a realistic interior iterate, after 3 plain
    iterations: ``kind`` "free" is the demo9 B = 256 batch; "fix_terminal"
    and "fix_free_end" are the fixture's 256 rows x 5 candidates; "sweep
    free" and "demo8 <variant>" are the rollout's (``_rollout_problem``)."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        BENCH_FREE_OPTIONS, FIX6_OPTIONS, FIX8_OPTIONS, demo9_window_batch,
        fix_fixture_batch)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
        init_vars, obca)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        make_obca_solver)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.newton import (
        newton_al_solve_plain, newton_assemble_plain, newton_schur_plain)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.ipm import (
        _spd_inv)

    cands = None
    if kind == "free":
        spec, data, _, _ = demo9_window_batch(256, dtype=dtype, device=dev)
        opt = BENCH_FREE_OPTIONS
    elif kind in ("fix_terminal", "fix_free_end"):
        spec6, spec8, data, cands = fix_fixture_batch(256, dtype=dtype, device=dev)
        spec, opt = (spec6, FIX6_OPTIONS) if kind == "fix_terminal" else (spec8, FIX8_OPTIONS)
    else:
        spec, data, opt, cands = _rollout_problem(*kind.split(), dtype, dev)
    z0 = None
    if cands is not None:
        nC = cands.shape[1]
        data = type(data)(*[f.repeat_interleave(nC, dim=0) for f in data])
        z0 = init_vars(spec, data, x_init=cands.reshape((-1,) + cands.shape[2:]))
    solve = make_obca_solver(spec, opt, impl="plain")
    st = solve.iterate(solve.init(data, z0), data, 3)
    L = solve.layout
    ops = L.ops(dev, dtype)
    sgn_raw, id_off = obca.ineq_identity_sgn_off(spec, data)
    sgn_eff = sgn_raw * ops.ds[ops.id_idx]
    m_id = L.m_id
    w_d = st.w[:, m_id:].contiguous()
    bnd = solve.provider.plain(st.zv, data, st.sf, st.scE, st.scD, st.y, w_d)
    cI = torch.cat([sgn_eff * st.zv[:, ops.id_idx] + id_off, bnd.cD], 1)
    jeTp, jeTq = ops.f_jeT(bnd, st.y)
    jiTp, jiTq = ops.f_jiT(bnd, st.w, sgn_eff)
    r_d = bnd.g - ops.f_flat(jeTp + jiTp, jeTq + jiTq)
    sigma = st.w / st.s
    up, uq = ops.f_jiT(bnd, (st.w * cI - st.mu_b[:, None]) / st.s, sgn_eff)
    rhs1 = (-r_d - ops.f_flat(up, uq)).contiguous()
    rhs2 = (-bnd.cE).contiguous()
    base = torch.clamp(st.delta, min=opt.delta0)
    ladder = (base[:, None] * (opt.delta_step ** torch.arange(
        R, dtype=dtype, device=dev))).contiguous()
    dd = opt.delta_d_al
    c = lambda ts: tuple(t.contiguous() for t in ts)
    asm = c(newton_assemble_plain(ops, bnd, sigma, sgn_eff, ladder, dd))
    Qinv = _spd_inv(asm[5]).contiguous()
    Yq, Smat = c(newton_schur_plain(ops, Qinv, asm[4], asm[3], ladder))
    Sinv = _spd_inv(Smat).contiguous()
    sols, goods = c(newton_al_solve_plain(ops, bnd, *asm[:3], asm[4], Qinv, Yq,
                                          Sinv, rhs1, rhs2, ladder, dd,
                                          opt.delta_d, opt.n_refine))
    return dict(kind=kind, spec=spec, data=data,
                data_flat=kernels.pack_obca_data(data), opt=opt, solve=solve,
                st=st, L=L, ops=ops, sgn_eff=sgn_eff, id_off=id_off, w_d=w_d,
                bnd=bnd, cI=cI, sigma=sigma, rhs1=rhs1, rhs2=rhs2,
                ladder=ladder, dd=dd, asm=asm, Qinv=Qinv, Yq=Yq, Smat=Smat,
                Sinv=Sinv, sols=sols, goods=goods)


def _saddle_residual(x, sol, delta):
    """(B,) ||K sol - rhs||_inf / ||rhs||_inf of every lane for the
    delta_d-regularized saddle system of one rung."""
    import torch

    ops, bnd, opt = x["ops"], x["bnd"], x["opt"]
    Wpp, Wpq, Wqq = x["asm"][:3]
    n = x["L"].n
    dz, v = sol[:, :n], sol[:, n:]
    dp, dq = ops.split(dz)
    op = (torch.einsum("bpc,bc->bp", Wpp, dp)
          + ops.slot_add(ops.red(torch.einsum("bksc,bkc->bks", Wpq, dq))))
    oq = (torch.einsum("bksc,bsk->bkc", Wpq, ops.slots_of(dp))
          + torch.einsum("bkcd,bkd->bkc", Wqq, dq))
    vp, vq = ops.f_jeT(bnd, v)
    r1 = ops.f_flat(op + delta[:, None] * dp + vp,
                    oq + delta[:, None, None] * dq + vq) - x["rhs1"]
    r2 = ops.f_jev(bnd, dp, dq) - opt.delta_d * v - x["rhs2"]
    res = torch.maximum(r1.abs().amax(1), r2.abs().amax(1))
    scale = torch.maximum(x["rhs1"].abs().amax(1), x["rhs2"].abs().amax(1))
    return res / scale


def _float64(x):
    """The saddle systems of ``x`` upcast to float64: the same numbers,
    for residuals free of float32 evaluation rounding."""
    import torch

    d = torch.float64
    y = dict(x, ops=x["L"].ops(x["rhs1"].device, d),
             bnd=type(x["bnd"])(*[t.to(d) for t in x["bnd"]]),
             asm=tuple(t.to(d) for t in x["asm"]))
    for k in ("rhs1", "rhs2", "ladder", "Qinv", "Yq", "Sinv"):
        y[k] = x[k].to(d)
    return y


def check_saddle_solve(name, tag, x64, ksol, kgood, psol, pgood, exact=None):
    """newton_al_solve and kkt_qr against their plain versions (see the
    tolerances above); ``exact`` is the same algorithm run in float64 on
    the same inputs, where its own residual is not zero (the AL solve's
    fixed number of refinement steps). Returns the row of the report."""
    import torch

    dtype = ksol.dtype
    eps = torch.finfo(dtype).eps
    check(bool((kgood == pgood).all()),
          f"{name} {tag}: good differs on {int((kgood != pgood).sum())} rungs")
    a, r = max_err(ksol, psol)
    if dtype == torch.float64:
        check(r <= 1e-9, f"{name} {tag}: rel {r:.3e} > 1e-09")
    res = []
    for j in range(kgood.shape[1]):
        g = kgood[:, j]
        if not bool(g.any()):
            res.append({"good": 0})
            continue
        dl = x64["ladder"][:, j]
        rk = _saddle_residual(x64, ksol[:, j].double(), dl)[g]
        rp = _saddle_residual(x64, psol[:, j].double(), dl)[g]
        ref = rp
        row = {"good": int(g.sum()), "max": rk.max().item(), "max_plain": rp.max().item()}
        if exact is not None:
            re = _saddle_residual(x64, exact[:, j], dl)[g]
            ref = torch.maximum(rp, re)
            row["max_float64"] = re.max().item()
            # lanes the float64 run's residual lets through
            row["above_3x_plain"] = int((rk > 3.0 * rp + 1e3 * eps).sum())
        lim = 3.0 * ref + 1e3 * eps
        row["ratio_to_limit"] = (rk / lim).max().item()
        if dtype == torch.float32:
            bad = rk > lim
            i = int(torch.argmax(rk / lim))
            check(not bool(bad.any()),
                  f"{name} {tag} rung {j}: residual above its limit on {int(bad.sum())} "
                  f"of {int(g.sum())} accepted lanes (worst: {rk[i].item():.3e}, plain "
                  f"{rp[i].item():.3e}, limit {lim[i].item():.3e})")
        res.append(row)
    return {"abs": a, "rel": r, "residual": res, "good": int(kgood.sum())}


def _flops(name, L, B, R, opt, m=None, count=None):
    """Operations of one call, counted from the kernel's loops (dominant
    terms; multiply and add count as two)."""
    np_, K, bq, S, n, mE = L.np_, L.K, L.bq, L.S, L.n, L.mE
    mE_sp, mD_sp, mI = L.mE_sp, L.mD_sp, L.mI
    if name == "obca_kkt_provider":
        out = (n + mE + L.mD + mE_sp * np_ + L.mD_sp * np_ + np_ * np_
               + K * (2 + 4 * bq + 2 * S + S * bq + bq * bq))
        return B * (4 * out + 30 * (n + mE + L.mD))
    if name == "spd_inv":
        return count * m ** 3
    if name == "newton_assemble":
        return B * (2 * np_ * np_ * (mD_sp + mE_sp) + 8 * K * bq * bq
                    + 8 * K * S * bq + R * K * bq * bq)
    if name == "newton_schur":
        return B * R * (2 * K * bq * S * (bq + S) + np_ * np_)
    if name == "newton_al_solve":
        G = 2 * (K * bq * bq + 2 * K * S * bq + np_ * np_)
        jv = 2 * (mE_sp * np_ + 2 * K * (1 + bq))
        wmv = 2 * (np_ * np_ + 2 * K * S * bq + K * bq * bq)
        nr = opt.n_refine
        return B * R * (jv + G + jv + nr * (wmv + 4 * jv + G) + wmv)
    if name == "step_linesearch":
        return B * (opt.n_backtracks * (10 * (mE + mI) + 4 * n)
                    + 2 * mD_sp * np_ + 8 * mI)
    if name == "kkt_qr":
        M = n + mE
        return B * R * (4 * M ** 3 // 3 + 8 * M * M + 2 * n * n)
    raise KeyError(name)


def check_kernels(x, tag, timing):
    """Each kernel against its plain version on the inputs ``x``; returns
    per-kernel errors and, with ``timing``, times and bounds."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import qr
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.ipm import (
        _spd_inv)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.linesearch import (
        step_linesearch_plain)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.newton import (
        newton_al_solve_plain, newton_assemble_plain, newton_schur_plain)

    st, bnd, L, ops, opt = x["st"], x["bnd"], x["L"], x["ops"], x["opt"]
    dtype = st.zv.dtype
    eps = torch.finfo(dtype).eps
    tol = 1e-9 if dtype == torch.float64 else 1e-3
    B, R = x["ladder"].shape
    rows = {}

    def timed(name, kfn, pfn, in_out, plain_reps=5, lib=None, flops=None):
        if not timing:
            return
        r = rows[name]
        r["ms"] = time_ms(kfn)
        r["plain_ms"] = time_ms(pfn, reps=plain_reps, warm=1)
        r["library_ms"] = None if lib is None else time_ms(lib, reps=plain_reps, warm=1)
        r["bound_ms"], r["bound_by"] = bound(nbytes(*in_out), flops, dtype)

    # ---- provider
    args = (x["spec"], L.lay, ops.ds, st.zv, x["data_flat"], st.sf, st.scE,
            st.scD, st.y, x["w_d"])
    kb = kernels.obca_kkt_provider(*args)
    worst = (0.0, 0.0, "")
    for f in bnd._fields:
        a, r = max_err(getattr(kb, f), getattr(bnd, f))
        if r > worst[1]:
            worst = (a, r, f)
        check(r <= tol, f"obca_kkt_provider {tag}: field {f} rel {r:.3e} > {tol:g}")
    rows["obca_kkt_provider"] = {"abs": worst[0], "rel": worst[1], "worst": worst[2]}
    plain = x["solve"].provider.plain
    timed("obca_kkt_provider", lambda: kernels.obca_kkt_provider(*args),
          lambda: plain(st.zv, x["data"], st.sf, st.scE, st.scD, st.y, x["w_d"]),
          [st.zv, x["data_flat"], st.sf, st.scE, st.scD, st.y, x["w_d"], *kb],
          flops=_flops("obca_kkt_provider", L, B, R, opt))

    # ---- newton_assemble
    a_args = (L, bnd, x["sigma"], x["sgn_eff"], x["ladder"], x["dd"])
    ka = kernels.newton_assemble(*a_args)
    rel, ab = 0.0, 0.0
    for name, k_, p_ in zip(("Wpp", "Wpq", "Wqq", "Gpp0", "Gpq0", "Gqq"), ka, x["asm"]):
        a, r = max_err(k_, p_)
        check(r <= tol, f"newton_assemble {tag}: {name} rel {r:.3e} > {tol:g}")
        rel, ab = max(rel, r), max(ab, a)
    rows["newton_assemble"] = {"abs": ab, "rel": rel}
    timed("newton_assemble", lambda: kernels.newton_assemble(*a_args),
          lambda: newton_assemble_plain(ops, bnd, x["sigma"], x["sgn_eff"],
                                        x["ladder"], x["dd"]),
          [bnd.Hpp, bnd.Hpq_c, bnd.Hqq, bnd.JE_sp, bnd.JEb_th, bnd.JEb_q,
           bnd.JD_sp, bnd.JDb_p, bnd.JDb_q, x["sigma"], x["sgn_eff"], x["ladder"], *ka],
          flops=_flops("newton_assemble", L, B, R, opt))

    # ---- spd_inv, m = bq and m = np, with planted non-SPD matrices
    spd = {"abs": 0.0, "rel": 0.0}
    for label, A in (("m=bq", x["asm"][5]), ("m=np", x["Smat"])):
        A = A.clone()
        m = A.shape[-1]
        flat = A.reshape(-1, m, m)
        nm = flat.shape[0]
        planted = torch.unique(torch.tensor([0, 7, nm // 2, nm - 1],
                                            device=A.device).clamp(max=nm - 1))
        big = flat.diagonal(dim1=-2, dim2=-1).abs().amax(-1)
        flat[planted, 1, 1] = -10.0 * big[planted]
        Xk = kernels.spd_inv(A)
        Xp = _spd_inv(A)
        nan_k = ~torch.isfinite(Xk).reshape(nm, -1).all(1)
        nan_p = ~torch.isfinite(Xp).reshape(nm, -1).all(1)
        # the two factorizations may only disagree on a matrix whose
        # smallest eigenvalue lies within rounding of zero
        differ = nan_k != nan_p
        lmin = 0.0     # worst |lambda_min| / ||A||_2 there, in units of m eps
        if bool(differ.any()):
            ev = torch.linalg.eigvalsh(flat[differ].double())
            band = ev[:, 0].abs() / ev.abs().amax(-1) / (m * eps)
            lmin = band.max().item()
            check(lmin <= SPD_BORDER,
                  f"spd_inv {tag} {label}: NaN lanes differ on "
                  f"{int((band > SPD_BORDER).sum())} matrices whose |lambda_min| / "
                  f"||A|| exceeds {SPD_BORDER} m eps (worst {lmin:.3f} m eps)")
        check(bool(nan_k[planted].all()), f"spd_inv {tag} {label}: planted non-SPD not NaN")
        eta = inv_backward_error(A, Xk)
        eta_p = inv_backward_error(A, Xp)
        check(eta <= 1e3 * eps, f"spd_inv {tag} {label}: backward error {eta:.3e}")
        keep = ~differ
        a, r = max_err(Xk.reshape(nm, m, m)[keep], Xp.reshape(nm, m, m)[keep])
        spd[label] = {"m": m, "count": nm, "abs": a, "rel": r, "eta": eta,
                      "eta_plain": eta_p, "nan": int(nan_k.sum()),
                      "nan_differ_at_boundary": int(differ.sum()),
                      "differ_lmin_m_eps": lmin}
        spd["abs"], spd["rel"] = max(spd["abs"], a), max(spd["rel"], r)
        if timing:
            spd[label]["ms"] = time_ms(lambda: kernels.spd_inv(A))
            spd[label]["plain_ms"] = time_ms(lambda: _spd_inv(A), reps=5, warm=1)
            spd[label]["library_ms"] = time_ms(
                lambda: torch.cholesky_inverse(torch.linalg.cholesky_ex(A)[0]),
                reps=5, warm=1)
            spd[label]["bound_ms"], spd[label]["bound_by"] = bound(
                2 * nbytes(A), _flops("spd_inv", L, B, R, opt, m=m, count=nm), dtype)
    if timing:
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            spd[key] = spd["m=bq"][key] + spd["m=np"][key]
        spd["bound_by"] = spd["m=np"]["bound_by"]
    rows["spd_inv"] = spd

    # ---- newton_schur
    s_args = (L, x["Qinv"], x["asm"][4], x["asm"][3], x["ladder"])
    kY, kS = kernels.newton_schur(*s_args)
    aY, rY = max_err(kY, x["Yq"])
    aS, rS = max_err(kS, x["Smat"])
    check(max(rY, rS) <= tol, f"newton_schur {tag}: rel {max(rY, rS):.3e}")
    rows["newton_schur"] = {"abs": max(aY, aS), "rel": max(rY, rS)}
    timed("newton_schur", lambda: kernels.newton_schur(*s_args),
          lambda: newton_schur_plain(ops, *s_args[1:]),
          [x["Qinv"], x["asm"][4], x["asm"][3], x["ladder"], kY, kS],
          flops=_flops("newton_schur", L, B, R, opt))

    # ---- newton_al_solve
    n_args = (L, bnd, *x["asm"][:3], x["asm"][4], x["Qinv"], x["Yq"],
              x["Sinv"], x["rhs1"], x["rhs2"], x["ladder"], x["dd"],
              opt.delta_d, opt.n_refine)
    ksol, kgood = kernels.newton_al_solve(*n_args)
    x64 = _float64(x)
    exact = newton_al_solve_plain(
        x64["ops"], x64["bnd"], *x64["asm"][:3], x64["asm"][4], x64["Qinv"], x64["Yq"],
        x64["Sinv"], x64["rhs1"], x64["rhs2"], x64["ladder"], x["dd"], opt.delta_d,
        opt.n_refine)[0]
    rows["newton_al_solve"] = check_saddle_solve(
        "newton_al_solve", tag, x64, ksol, kgood, x["sols"], x["goods"], exact)
    del exact
    timed("newton_al_solve", lambda: kernels.newton_al_solve(*n_args),
          lambda: newton_al_solve_plain(ops, *n_args[1:]),
          [bnd.JE_sp, bnd.JEb_th, bnd.JEb_q, *x["asm"][:3], x["asm"][4], x["Qinv"],
           x["Yq"], x["Sinv"], x["rhs1"], x["rhs2"], x["ladder"], ksol, kgood],
          flops=_flops("newton_al_solve", L, B, R, opt))

    # ---- step_linesearch
    l_args = (ops, opt, x["sols"], x["goods"], x["ladder"], st.zv, st.s, st.y,
              st.w, st.mu_b, st.delta, x["cI"], bnd.cE, bnd.f, bnd, x["sgn_eff"],
              x["id_off"])
    kl = kernels.step_linesearch(*l_args, x["data_flat"], st.sf, st.scE, st.scD)
    pl = step_linesearch_plain(*l_args, x["data"], st.sf, st.scE, st.scD)
    rel, ab = 0.0, 0.0
    for name, k_, p_ in zip(("zv", "s", "y", "w", "delta"), kl, pl):
        a, r = max_err(k_, p_)
        check(r <= tol, f"step_linesearch {tag}: {name} rel {r:.3e} > {tol:g}")
        rel, ab = max(rel, r), max(ab, a)
    rows["step_linesearch"] = {"abs": ab, "rel": rel}
    timed("step_linesearch",
          lambda: kernels.step_linesearch(*l_args, x["data_flat"], st.sf, st.scE, st.scD),
          lambda: step_linesearch_plain(*l_args, x["data"], st.sf, st.scE, st.scD),
          [x["sols"], x["goods"], x["ladder"], st.zv, st.s, st.y, st.w, st.mu_b,
           st.delta, x["cI"], bnd.cE, bnd.f, bnd.JD_sp, bnd.JDb_p, bnd.JDb_q,
           x["sgn_eff"], x["id_off"], x["data_flat"], st.sf, st.scE, st.scD, *kl],
          flops=_flops("step_linesearch", L, B, R, opt))

    # ---- kkt_qr (the QR rescue rungs run the fix-time variants)
    if x["spec"].variant != "free":
        q_args = (ops, bnd, *x["asm"][:3], x["rhs1"], x["rhs2"], x["ladder"], opt.delta_d)
        qsol, qgood = qr.kkt_qr_plain(*q_args)
        ksol, kgood = kernels.kkt_qr(*q_args)
        rows["kkt_qr"] = check_saddle_solve("kkt_qr", tag, x64, ksol, kgood, qsol, qgood)
        # a NaN planted in W rejects the rungs of its lanes on both sides
        Wbad = x["asm"][0].clone()
        bad = torch.arange(0, B, max(B // 4, 1), device=Wbad.device)
        Wbad[bad, 1, 1] = float("nan")
        bargs = (ops, bnd, Wbad, *x["asm"][1:3], x["rhs1"], x["rhs2"], x["ladder"],
                 opt.delta_d)
        kg_bad = kernels.kkt_qr(*bargs)[1]
        pg_bad = qr.kkt_qr_plain(*bargs)[1]
        check(bool((kg_bad == pg_bad).all()) and not bool(kg_bad[bad].any()),
              f"kkt_qr {tag}: planted NaN not rejected like the plain version")
        if timing:
            K_, _ = qr.saddle_matrix(ops, bnd, *x["asm"][:3], x["ladder"], opt.delta_d)
            rhs = torch.cat([x["rhs1"], x["rhs2"]], 1)[:, None, :, None].expand(
                K_.shape[:3] + (1,))

            def library():
                Q, Rm = torch.linalg.qr(K_)
                return torch.linalg.solve_triangular(Rm, Q.transpose(-1, -2) @ rhs,
                                                     upper=True)

            timed("kkt_qr", lambda: kernels.kkt_qr(*q_args),
                  lambda: qr.kkt_qr_plain(*q_args),
                  [bnd.JE_sp, bnd.JEb_th, bnd.JEb_q, *x["asm"][:3], x["rhs1"],
                   x["rhs2"], x["ladder"], ksol, kgood],
                  plain_reps=2, lib=library, flops=_flops("kkt_qr", L, B, R, opt))
    torch.cuda.synchronize()
    return rows


def phase_kernels(dev):
    """Phase 3; returns the timed rows at the fix_terminal float32 shapes
    (the main path's) and logs every configuration."""
    import torch

    report = {}
    configs = [("free", torch.float64, 1, False), ("free", torch.float64, 2, False),
               ("free", torch.float32, 1, True),
               ("fix_terminal", torch.float64, 2, False),
               ("fix_terminal", torch.float32, 2, True),
               ("fix_free_end", torch.float64, 2, False),
               ("fix_free_end", torch.float32, 2, False)]
    # the rollout's own shapes: the sweep's free rung and the N = 15 demo
    configs += [(kind, dtype, 2, False)
                for kind in ("sweep free", "demo8 free", "demo8 fix_terminal",
                             "demo8 fix_free_end")
                for dtype in (torch.float64, torch.float32)]
    for kind, dtype, R, timing in configs:
        tag = f"{kind} {'f64' if dtype == torch.float64 else 'f32'} R={R}"
        t0 = time.time()
        x = _stage_inputs(kind, dtype, dev, R)
        rows = check_kernels(x, tag, timing)
        log(f"[kernels] {tag} lanes={x['st'].zv.shape[0]} ({time.time() - t0:.1f} s): "
            + json.dumps(rows, default=float))
        if kind == "fix_terminal" and timing:
            report = rows
        del x
        torch.cuda.empty_cache()
    report.update(check_astar(dev))
    return report


def _astar_grids(dtype, dev):
    """(label, grid, start_yx, goal_yx): the sweep's 1024 maps and the
    demo9 and demo10 grids."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
        build_scenario, get_demo, random_scenarios)

    cell = lambda pose: pose[:, [1, 0]].to(torch.int32)
    scn, _ = random_scenarios(0, 1024, dtype=dtype, device=dev)
    out = [("sweep 1024x11x40", scn.grid, cell(scn.start), cell(scn.goal))]
    for name in ("demo9", "demo10"):
        s, _ = build_scenario(get_demo(name), dtype=dtype, device=dev)
        out.append((f"{name} {tuple(s.grid.shape)}", s.grid[None], cell(s.start[None]),
                    cell(s.goal[None])))
    return out


def check_astar(dev):
    """astar_cost_to_go and astar_extract_path against their plain
    versions, bit for bit; times and bounds at the sweep's float32 shape
    (the main path's). Returns the two report rows."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        SWEEP_PATH_LEN)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.ops import astar

    rows = {}
    L = SWEEP_PATH_LEN
    for dtype in (torch.float64, torch.float32):
        for label, grid, start, goal in _astar_grids(dtype, dev):
            tag = f"{label} {'f64' if dtype == torch.float64 else 'f32'}"
            it = astar.default_max_iters(grid)
            d, relax = kernels.astar_cost_to_go(grid, goal, it)
            dp, relax_p = astar.cost_to_go_plain(grid, goal, it)
            path, valid = kernels.astar_extract_path(dp, start, L)
            pp, vp = astar.extract_path_plain(dp, start, L)
            torch.cuda.synchronize()
            check(torch.equal(d, dp), f"astar_cost_to_go {tag}: field differs from plain "
                  f"({int((d != dp).sum())} cells)")
            check(torch.equal(relax, relax_p), f"astar_cost_to_go {tag}: relaxations differ")
            check(torch.equal(path, pp) and torch.equal(valid, vp),
                  f"astar_extract_path {tag}: path differs from plain")
            log(f"[kernels] astar {tag}: field, path and valid equal to plain; relaxations "
                f"median {float(relax.float().median()):.0f} max {int(relax.max())} (cap "
                f"{it + 1}); valid length median {float(valid.sum(1).float().median()):.0f}")
            if not (label.startswith("sweep") and dtype == torch.float32):
                continue
            B, R, C = grid.shape
            n_relax = int(relax.sum())
            rows["astar_cost_to_go"] = {
                "abs": 0.0, "rel": 0.0, "relaxations": n_relax,
                "ms": time_ms(lambda: kernels.astar_cost_to_go(grid, goal, it)),
                "plain_ms": time_ms(lambda: astar.cost_to_go_plain(grid, goal, it),
                                    reps=5, warm=1),
                "library_ms": None}
            # per relaxation every cell takes 8 neighbour adds and 8 minima
            rows["astar_cost_to_go"]["bound_ms"], rows["astar_cost_to_go"]["bound_by"] = bound(
                nbytes(grid, goal, d, relax), n_relax * R * C * 8 * 2, dtype)
            rows["astar_extract_path"] = {
                "abs": 0.0, "rel": 0.0,
                "ms": time_ms(lambda: kernels.astar_extract_path(dp, start, L)),
                "plain_ms": time_ms(lambda: astar.extract_path_plain(dp, start, L),
                                    reps=5, warm=1),
                "library_ms": None}
            # the field read once at most; 8 comparisons per move
            rows["astar_extract_path"]["bound_ms"], rows["astar_extract_path"]["bound_by"] = \
                bound(nbytes(dp, start, path, valid), B * L * 8, dtype)
            log(f"[kernels] astar {tag} timing: " + json.dumps(
                {k: rows[k] for k in ASTAR}))
    return rows


def phase_entry(dev):
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        ENTRY_OPTIONS, demo1_problem)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        make_obca_solver)

    spec, data, _, _ = demo1_problem(torch.float64, "cpu")
    r_cpu = make_obca_solver(spec, ENTRY_OPTIONS)(data)
    out = {}
    for dtype in (torch.float64, torch.float32):
        spec, data, _, _ = demo1_problem(dtype, dev)
        solve = make_obca_solver(spec, ENTRY_OPTIONS)
        kernels.reset_launch_counts()
        r = solve(data)
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        check(all(counts[k] > 0 for k in FUSED), f"entry {dtype}: launch counts {counts}")
        log(f"[entry] {dtype}: iters {int(r.iters[0])} feas {bool(r.feas[0])} "
            f"kkt_err {float(r.kkt_err[0]):.4e} viol {float(r.viol[0]):.4e} "
            f"T {float(r.z['T'][0]):.6f} launches {counts}")
        out[str(dtype)] = r
    r64 = out[str(torch.float64)]
    dz = max((r64.z[k].cpu() - r_cpu.z[k]).abs().max().item() for k in r_cpu.z)
    log(f"[entry] CPU plain float64: iters {int(r_cpu.iters[0])} feas "
        f"{bool(r_cpu.feas[0])}; card float64 vs CPU: max |dz| {dz:.3e}")
    check(int(r64.iters[0]) == int(r_cpu.iters[0]), "entry: float64 iters differ from CPU")
    check(dz <= 1e-6, f"entry: float64 z differs from CPU by {dz:.3e}")
    check(bool(r64.feas[0]), "entry: float64 solve not feasible")


def _iter_stats(it):
    it = sorted(it)
    if not it:
        return {"n": 0}
    return {"n": len(it), "median": float(statistics.median(it)),
            "p90": float(it[int(0.9 * (len(it) - 1))]), "max": int(it[-1])}


def _batch_stats(r, B):
    it = r.iters.cpu().numpy()
    return {"feasible_fraction": float(r.feas.float().mean()),
            "iters_median": float(statistics.median(it.tolist())),
            "iters_p90": float(sorted(it.tolist())[int(0.9 * (B - 1))]),
            "iters_max": int(it.max()),
            "dispatched_lane_iters": int(it.max()) * B,
            "useful_lane_iters": int(it.sum())}


def _timed_runs(fn, reps):
    import torch

    times = []
    out = None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, out


def phase_batch(dev, reps=3):
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        BENCH_FREE_OPTIONS, demo9_window_batch)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        make_obca_solver)

    B = 256
    spec, data, _, _ = demo9_window_batch(B, dtype=torch.float32, device=dev)
    results = {}
    for label, impl in (("kernels", None), ("plain", "plain")):
        solve = make_obca_solver(spec, BENCH_FREE_OPTIONS, impl=impl)
        kernels.reset_launch_counts()
        r = solve(data)                       # warm-up, and the counted run
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        stats = _batch_stats(r, B)
        times, r2 = _timed_runs(lambda: solve(data), reps)
        t = statistics.median(times)
        rerun = max((r2.z[k] - r.z[k]).abs().max().item() for k in r.z)
        stats.update(solves_per_s=B / t, seconds=times, rerun_max_abs_dz=rerun)
        log(f"[batch] {label}: " + json.dumps(stats) + f" launches {counts}")
        results[label] = (stats, counts, r2)
    stats_k, counts_k, rk = results["kernels"]
    check(stats_k["feasible_fraction"] >= 0.99,
          f"batch: kernel feasible fraction {stats_k['feasible_fraction']:.4f} < 0.99")
    check(all(counts_k[k] > 0 for k in FUSED), f"batch: launch counts {counts_k}")
    check(all(v == 0 for v in results["plain"][1].values()),
          "batch: the plain run launched a kernel")
    rp = results["plain"][2]
    same = float((rk.iters == rp.iters).float().mean())
    dz = max((rk.z[k] - rp.z[k]).abs().max().item() for k in rk.z)
    log(f"[batch] kernels vs plain (float32): same iters on {same:.4f} of lanes, "
        f"max |dz| {dz:.3e}")
    return counts_k


RUNG_NAMES = ("mpc6", "mpc8", "qr6", "qr8")


def _fix_stats(res, rungs):
    B = res.feas.shape[0]
    seen = None
    per = {}
    for name, r in zip(RUNG_NAMES, rungs):
        it = r.iters.cpu().tolist()
        ran = [i for i in it if i > 0]
        newly = r.feas if seen is None else (r.feas & ~seen)
        seen = r.feas.clone() if seen is None else (seen | r.feas)
        per[name] = {"rows_run": len(ran), "made_feasible": int(newly.sum()),
                     "iters": _iter_stats(ran)}
    return {"rows": B, "feasible_fraction": float(res.feas.float().mean()),
            "iters_total": _iter_stats(res.iters.cpu().tolist()), "rungs": per}


def phase_fixstep(dev, reps=5):
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        fix_fixture_batch, make_fix_step)

    spec6, spec8, data, cands = fix_fixture_batch(256, dtype=torch.float32, device=dev)
    B = data.x0.shape[0]
    results = {}
    for label, impl, n in (("kernels", None, reps), ("plain", "plain", 0)):
        step = make_fix_step(spec6, spec8, qr_rescue=True, impl=impl)
        kernels.reset_launch_counts()
        times, (res, rungs) = _timed_runs(lambda: step(data, cands), 1)   # counted
        counts = dict(kernels.launches)
        stats = _fix_stats(res, rungs)
        if n:
            more, (res2, _) = _timed_runs(lambda: step(data, cands), n)
            stats["rerun_max_abs_dz"] = max((res2.z[k] - res.z[k]).abs().max().item()
                                            for k in res.z)
            times = more
        stats.update(steps_per_s=B / statistics.median(times), seconds=times)
        log(f"[fixstep] {label}: " + json.dumps(stats) + f" launches {counts}")
        results[label] = (stats, counts, res)
    stats_k, counts_k, rk = results["kernels"]
    check(stats_k["feasible_fraction"] >= 0.99,
          f"fixstep: ladder feasible fraction {stats_k['feasible_fraction']:.4f} < 0.99")
    check(all(counts_k[k] > 0 for k in FUSED), f"fixstep: launch counts {counts_k}")
    check(all(v == 0 for v in results["plain"][1].values()),
          "fixstep: the plain run launched a kernel")
    rp = results["plain"][2]
    same = float((rk.iters == rp.iters).float().mean())
    log(f"[fixstep] kernels vs plain (float32): same total iters on {same:.4f} of rows, "
        f"plain feasible {results['plain'][0]['feasible_fraction']:.4f}")
    return counts_k


def phase_qr(dev):
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        FIX8_OPTIONS, N_CAND_FIX, fix_fixture_batch)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
        init_vars)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime.multistart import (
        make_multistart_solver)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        make_obca_solver)

    opt = dataclasses.replace(FIX8_OPTIONS, kkt="qr")

    def msolve(dtype, device, rows):
        spec6, _, data, cands = fix_fixture_batch(dtype=dtype, device=device, rows=rows)
        ms = make_multistart_solver(spec6, make_obca_solver(spec6, opt), init_vars,
                                    N_CAND_FIX)
        return lambda: ms(data, cands)

    run = msolve(torch.float32, dev, list(range(32)))
    kernels.reset_launch_counts()
    times, (r, best) = _timed_runs(run, 1)
    counts = dict(kernels.launches)
    stats = {"rows": 32, "lanes": 32 * N_CAND_FIX,
             "feasible_fraction": float(r.feas.float().mean()),
             "iters": _iter_stats(r.iters.cpu().tolist()), "seconds": times}
    log(f"[qr] float32 kkt='qr' fix_terminal multistart: " + json.dumps(stats)
        + f" launches {counts}")
    check(counts["kkt_qr"] > 0, f"qr: kkt_qr never launched {counts}")
    check(all(counts[k] > 0 for k in ("obca_kkt_provider", "newton_assemble",
                                       "step_linesearch")), f"qr: launch counts {counts}")

    r64, b64 = msolve(torch.float64, dev, [0, 1])()
    rcpu, bcpu = msolve(torch.float64, "cpu", [0, 1])()
    dz = max((r64.z[k].cpu() - rcpu.z[k]).abs().max().item() for k in rcpu.z)
    log(f"[qr] float64 rows 0, 1: card iters {r64.iters.tolist()} best {b64.tolist()} "
        f"feas {r64.feas.tolist()}; CPU plain iters {rcpu.iters.tolist()} best "
        f"{bcpu.tolist()} feas {rcpu.feas.tolist()}; max |dz| {dz:.3e}")
    check(r64.iters.tolist() == rcpu.iters.tolist(), "qr: float64 iters differ from CPU")
    check(dz <= 1e-6, f"qr: float64 z differs from CPU by {dz:.3e}")
    return counts


def _rung_profile(profile):
    """Per rung: steps it ran on, world-steps, the host-loop iterations of
    the steps it ran (median, max, sum) and its seconds over all steps
    (host clock, skipped steps' init and finalize included)."""
    out = {}
    for rung in profile[0]:
        ran = [st[rung] for st in profile if st[rung][0]]
        its = [i for _, i, _ in ran]
        out[rung] = {"steps": len(ran), "world_steps": sum(r for r, _, _ in ran),
                     "iters_median": float(statistics.median(its)) if its else 0.0,
                     "iters_max": max(its) if its else 0,
                     "iters_sum": sum(its),
                     "seconds": sum(st[rung][2] for st in profile)}
    return out


def phase_sweep(dev, B=1024, steps=30):
    """Phase 8: the random sweep at full width through the kernels, then a
    64-world, 3-step slice through the kernels and the plain versions."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        sweep_inputs, sweep_stats)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime import (
        make_scan_rollout)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
        Scenario)

    dtype = torch.float32
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scn, shape, p, ref, ref_len = sweep_inputs(B, seed=0, dtype=dtype, device=dev)
    torch.cuda.synchronize()
    t_inputs = time.perf_counter() - t0
    roll = make_scan_rollout(shape, p, max_steps=steps, dtype=dtype, qr_rescue=True,
                             device=dev)
    profile = []
    t0 = time.perf_counter()
    final, traj = roll(scn, ref, ref_len, profile=profile)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    stats = sweep_stats(scn, final, traj)
    stats.update(wall_s=wall, sweep_replans_per_s=stats["replans"] / wall,
                 fixtime_share=stats["fixtime_replans"] / max(stats["replans"], 1),
                 inputs_s=t_inputs, ref_len_median=float(ref_len.float().median()),
                 host_iters_per_step=sum(r["iters_sum"] for r in _rung_profile(profile).values())
                 / steps)
    log(f"[sweep] B={B} steps={steps} float32: " + json.dumps(stats))
    log(f"[sweep] rungs: " + json.dumps(_rung_profile(profile)))
    log(f"[sweep] launches {counts}")
    check(bool(torch.isfinite(traj["x"]).all()), "sweep: non-finite state")
    check(stats["failed_frac"] <= 0.03, f"sweep: failed_frac {stats['failed_frac']:.4f} > 0.03")
    check(stats["mean_progress_frac"] >= 0.17,
          f"sweep: mean_progress_frac {stats['mean_progress_frac']:.4f} < 0.17")
    check(all(counts[k] > 0 for k in FUSED + ASTAR), f"sweep: launch counts {counts}")

    sub = Scenario(*[f[:64] for f in scn])
    times = {}
    for label, impl in (("kernels", None), ("plain", "plain")):
        r3 = make_scan_rollout(shape, p, max_steps=3, dtype=dtype, device=dev, impl=impl)
        before = dict(kernels.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fin3, traj3 = r3(sub, ref[:64], ref_len[:64])
        torch.cuda.synchronize()
        times[label] = time.perf_counter() - t0
        st3 = sweep_stats(sub, fin3, traj3)
        log(f"[sweep] 64 worlds x 3 steps, {label}: {times[label]:.3f} s " + json.dumps(st3))
        check(bool(traj3["feas"].all()), f"sweep: 64x3 {label} infeasible on some step")
        if impl == "plain":
            check(dict(kernels.launches) == before, "sweep: the plain run launched a kernel")
    return counts


def phase_demos(dev, steps=30):
    """Phase 9: the 11 demos in float32 through the kernels; demo1 and
    demo3 in float64 against their goldens."""
    import numpy as np
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        demo_rollout_inputs)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime import (
        make_scan_rollout)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
        demo_names)

    kernels.reset_launch_counts()
    runs = [(n, torch.float32) for n in demo_names()] + [("demo1", torch.float64),
                                                         ("demo3", torch.float64)]
    for name, dtype in runs:
        g = np.load(os.path.join(HERE, "goldens", f"{name}.npz"))
        scn, shape, p, ref, ref_len = demo_rollout_inputs(name, dtype, dev)
        roll = make_scan_rollout(shape, p, max_steps=steps, dtype=dtype, device=dev)
        profile = []
        t0 = time.perf_counter()
        final, traj = roll(scn, ref, ref_len, profile=profile)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        goal = scn.goal[0, :2].double().cpu().numpy()
        d0 = float(np.linalg.norm(scn.start[0, :2].double().cpu().numpy() - goal))
        d_end = float(np.linalg.norm(final.x0[0, :2].double().cpu().numpy() - goal))
        d_gold = float(np.linalg.norm(g["x"][-1, :2] - goal))
        modes = traj["fixtime"][0].cpu().numpy()
        dx = float(np.abs(traj["x"][0].double().cpu().numpy() - g["x"][:steps]).max())
        its = sum(r["iters_sum"] for r in _rung_profile(profile).values())
        log(f"[demos] {name} {str(dtype)[6:]}: N={p.N_free} {wall:.2f} s, host iterations "
            f"{its}, fix-time steps {int(modes.sum())} (golden {int(g['fixtime'].sum())}), "
            f"d_end {d_end:.4f} golden {d_gold:.4f} d0 {d0:.2f}, max |x - golden| {dx:.3e}, "
            f"failed {bool(final.failed[0])}")
        check(not bool(final.failed[0]), f"demos: {name} {dtype} aborted")
        check(d_end <= d_gold + 0.2 * d0, f"demos: {name} {dtype} end {d_end:.3f} > golden "
              f"{d_gold:.3f} + 0.2 d0")
        if dtype == torch.float64:
            check(bool((modes == g["fixtime"][:steps]).all()),
                  f"demos: {name} float64 mode flags differ from the golden")
            check(dx <= 1e-6, f"demos: {name} float64 states differ from the golden by {dx:.3e}")
    counts = dict(kernels.launches)
    log(f"[demos] launches {counts}")
    check(all(counts[k] > 0 for k in FUSED), f"demos: launch counts {counts}")
    return counts


def main(argv):
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        __import__(PKG)
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e}); run from the "
              "repository root", file=sys.stderr)
        return 2
    no_jax("import")
    phases = {3, 4, 5, 6, 7, 8, 9}
    if "--phases" in argv:
        phases = {int(p) for p in argv[argv.index("--phases") + 1].split(",")}
    dev = torch.device("cuda:0")

    smi = phase_card()
    phase_build()
    no_jax("build")
    report, counts = {}, {}
    if 3 in phases:
        report = phase_kernels(dev)
        no_jax("phase 3")
    if 4 in phases:
        phase_entry(dev)
        no_jax("phase 4")
    if 5 in phases:
        phase_batch(dev)
        no_jax("phase 5")
    if 6 in phases:
        counts[6] = phase_fixstep(dev)
        no_jax("phase 6")
    if 7 in phases:
        counts[7] = phase_qr(dev)
        no_jax("phase 7")
    if 8 in phases:
        counts[8] = phase_sweep(dev)
        no_jax("phase 8")
    if 9 in phases:
        counts[9] = phase_demos(dev)
        no_jax("phase 9")

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.kernels import (
        SOURCE_OF)

    if report and 8 in counts:
        rows = []
        for name in REPLACES:
            r = report[name]
            rows.append({"name": name, "route": "cuda",
                         "source": f"{PKG}/kernels/csrc/{SOURCE_OF[name]}.cu",
                         "replaces": REPLACES[name], "launches": counts[8][name],
                         "launches_by_phase": {str(ph): c[name] for ph, c in counts.items()},
                         "max_abs_err": r["abs"], "ms": r["ms"],
                         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                         "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
