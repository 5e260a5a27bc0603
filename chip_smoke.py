"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py             # all phases, one card
    python3 chip_smoke.py --kernels   # phases 1-3 only (build + kernel checks)

Phases, each of which raises (exit code != 0) when it fails:
  1. the card: nvidia-smi name and power limit, TF32 switched off;
  2. the kernel build (one nvcc per CUDA source, in parallel);
  3. every kernel against its plain PyTorch version on the card, at the
     demo9 N = 10, B = 256 shapes of bench.py's headline batch, in float64
     and float32, with times (CUDA events) for both;
  4. the entry problem (demo1, N = 6, IPMOptions(max_iters=60)) through
     the kernels in float64 and float32; float64 must match the plain
     version run on the CPU (same iters, z within 1e-6);
  5. the slice at full size: demo9_window_batch(256) with
     BENCH_FREE_OPTIONS in float32, through the kernels and through the
     plain versions on the card: feasible fraction, iterations,
     lane-iterations, solves/s (median of 5 timed reps after a warm-up)
     and how far the last rep's z lies from the first run's;
  6. the launch counts of the main path's run, one JSON line per kernel
     set, then the device line.

Tolerances (phase 3), max-normalised errors |k - p|_max / |p|_max:
  * float64: <= 1e-9 on every value (only the summation order differs);
  * float32: <= 1e-3 on the provider, the Newton assembly and Schur
    stages and the line search;
  * spd_inv and newton_al_solve in both dtypes: a backward-error bound
    instead, because the direct Cholesky of the kernel and the JAX
    package's block-Schur recursion round differently on ill-conditioned
    Schur blocks: ||A X - I|| / (||A|| ||X||) <= 1e3 eps for the inverse,
    and the saddle-system residual ||K sol - rhs|| / ||rhs|| of the
    kernel's step at most 3x the plain version's (+1e3 eps): with one
    refinement pass that residual is set by the conditioning of the Schur
    blocks, and the two inverses round it differently (measured on an
    H100 in float32: 2.7e-4 kernel vs 1.7e-4 plain; float64 equal to 10
    digits). NaN (non-SPD) must appear exactly where the plain version
    has it, and the rung flags `good` must agree.
"""

from __future__ import annotations

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
}


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


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


# ------------------------------------------------------------------ phases

def phase_card():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else
        f"nvidia-smi unavailable: {smi.stderr.strip()}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log(f"[card] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi.stdout.strip()


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


def _stage_inputs(dtype, dev, R):
    """Every kernel's inputs at a realistic interior iterate: the demo9
    B = 256 batch after 3 plain iterations."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        BENCH_FREE_OPTIONS, demo9_window_batch)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import obca
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        make_obca_solver)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.newton import (
        newton_al_solve_plain, newton_assemble_plain, newton_schur_plain)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.ipm import (
        _spd_inv)

    spec, data, _, _ = demo9_window_batch(256, dtype=dtype, device=dev)
    opt = BENCH_FREE_OPTIONS
    solve = make_obca_solver(spec, opt, impl="plain")
    st = solve.iterate(solve.init(data), data, 3)
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
    return dict(spec=spec, data=data, data_flat=kernels.pack_obca_data(data),
                opt=opt, solve=solve, st=st, L=L, ops=ops, sgn_eff=sgn_eff,
                id_off=id_off, w_d=w_d, bnd=bnd, cI=cI, sigma=sigma,
                rhs1=rhs1, rhs2=rhs2, ladder=ladder, dd=dd, asm=asm,
                Qinv=Qinv, Yq=Yq, Smat=Smat, Sinv=Sinv, sols=sols,
                goods=goods)


def _saddle_residual(x, sol, delta):
    """max over lanes of ||K sol - rhs||_inf / ||rhs||_inf for the
    delta_d-regularized saddle system of each rung."""
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
    rel = res / scale
    fin = torch.isfinite(rel)
    return rel[fin].max().item() if bool(fin.any()) else 0.0


def phase_kernels(dev):
    """Each kernel against its plain version; returns per-kernel float32
    errors and times."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.ipm import (
        _spd_inv)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.linesearch import (
        step_linesearch_plain)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.newton import (
        newton_al_solve_plain, newton_assemble_plain, newton_schur_plain)

    report = {}
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        eps = torch.finfo(dtype).eps
        tol = 1e-9 if dtype == torch.float64 else 1e-3
        timing = dtype == torch.float32
        for R in ((1, 2) if dtype == torch.float64 else (1,)):
            x = _stage_inputs(dtype, dev, R)
            st, bnd, L, ops = x["st"], x["bnd"], x["L"], x["ops"]
            rows = {}

            # ---- provider
            args = (x["spec"], L.lay, ops.ds, st.zv, x["data_flat"], st.sf,
                    st.scE, st.scD, st.y, x["w_d"])
            kb = kernels.obca_kkt_provider(*args)
            worst = (0.0, 0.0, "")
            for f in bnd._fields:
                a, r = max_err(getattr(kb, f), getattr(bnd, f))
                if r > worst[1]:
                    worst = (a, r, f)
                check(r <= tol, f"obca_kkt_provider {tag}: field {f} rel {r:.3e} > {tol:g}")
            rows["obca_kkt_provider"] = {"abs": worst[0], "rel": worst[1], "worst": worst[2]}
            if timing:
                plain = x["solve"].provider.plain
                rows["obca_kkt_provider"]["ms"] = time_ms(lambda: kernels.obca_kkt_provider(*args))
                rows["obca_kkt_provider"]["plain_ms"] = time_ms(
                    lambda: plain(st.zv, x["data"], st.sf, st.scE, st.scD, st.y, x["w_d"]))

            # ---- newton_assemble
            a_args = (L, bnd, x["sigma"], x["sgn_eff"], x["ladder"], x["dd"])
            ka = kernels.newton_assemble(*a_args)
            rel = 0.0
            for name, k_, p_ in zip(("Wpp", "Wpq", "Wqq", "Gpp0", "Gpq0", "Gqq"), ka, x["asm"]):
                a, r = max_err(k_, p_)
                check(r <= tol, f"newton_assemble {tag}: {name} rel {r:.3e} > {tol:g}")
                rel = max(rel, r)
            rows["newton_assemble"] = {"abs": max(max_err(k_, p_)[0] for k_, p_ in zip(ka, x["asm"])),
                                       "rel": rel}

            # ---- spd_inv, m = bq and m = np, with planted non-SPD matrices
            spd_rows = {}
            for label, A in (("m=8", x["asm"][5]), (f"m={L.np_}", x["Smat"])):
                A = A.clone()
                flat = A.reshape(-1, A.shape[-1], A.shape[-1])
                nm = flat.shape[0]
                planted = torch.unique(torch.tensor([0, 7, nm // 2, nm - 1],
                                                    device=dev).clamp(max=nm - 1))
                big = flat.diagonal(dim1=-2, dim2=-1).abs().amax(-1)
                flat[planted, 1, 1] = -10.0 * big[planted]
                Xk = kernels.spd_inv(A)
                Xp = _spd_inv(A)
                nan_k = ~torch.isfinite(Xk).reshape(flat.shape[0], -1).all(1)
                nan_p = ~torch.isfinite(Xp).reshape(flat.shape[0], -1).all(1)
                check(bool((nan_k == nan_p).all()), f"spd_inv {tag} {label}: NaN lanes differ")
                check(bool(nan_k[planted].all()), f"spd_inv {tag} {label}: planted non-SPD not NaN")
                eta = inv_backward_error(A, Xk)
                eta_p = inv_backward_error(A, Xp)
                check(eta <= 1e3 * eps, f"spd_inv {tag} {label}: backward error {eta:.3e}")
                a, r = max_err(Xk, Xp)
                spd_rows[label] = {"abs": a, "rel": r, "eta": eta, "eta_plain": eta_p,
                                   "nan": int(nan_k.sum())}
                if timing:
                    spd_rows[label]["ms"] = time_ms(lambda: kernels.spd_inv(A))
                    spd_rows[label]["plain_ms"] = time_ms(lambda: _spd_inv(A), reps=5)
            rows["spd_inv"] = spd_rows

            # ---- newton_schur
            s_args = (L, x["Qinv"], x["asm"][4], x["asm"][3], x["ladder"])
            kY, kS = kernels.newton_schur(*s_args)
            aY, rY = max_err(kY, x["Yq"])
            aS, rS = max_err(kS, x["Smat"])
            check(max(rY, rS) <= tol, f"newton_schur {tag}: rel {max(rY, rS):.3e}")
            rows["newton_schur"] = {"abs": max(aY, aS), "rel": max(rY, rS)}

            # ---- newton_al_solve
            n_args = (L, bnd, *x["asm"][:3], x["asm"][4], x["Qinv"], x["Yq"],
                      x["Sinv"], x["rhs1"], x["rhs2"], x["ladder"], x["dd"],
                      x["opt"].delta_d, x["opt"].n_refine)
            ksol, kgood = kernels.newton_al_solve(*n_args)
            check(bool((kgood == x["goods"]).all()),
                  f"newton_al_solve {tag}: good differs on "
                  f"{int((kgood != x['goods']).sum())} rungs")
            res = []
            for j in range(R):
                rk = _saddle_residual(x, ksol[:, j], x["ladder"][:, j])
                rp = _saddle_residual(x, x["sols"][:, j], x["ladder"][:, j])
                check(rk <= 3.0 * rp + 1e3 * eps,
                      f"newton_al_solve {tag} rung {j}: residual {rk:.3e} vs plain {rp:.3e}")
                res.append((rk, rp))
            a, r = max_err(ksol, x["sols"])
            rows["newton_al_solve"] = {"abs": a, "rel": r, "residual": res,
                                       "good": int(kgood.sum())}

            # ---- step_linesearch
            l_args = (ops, x["opt"], x["sols"], x["goods"], x["ladder"], st.zv,
                      st.s, st.y, st.w, st.mu_b, st.delta, x["cI"], bnd.cE,
                      bnd.f, bnd, x["sgn_eff"], x["id_off"])
            kl = kernels.step_linesearch(*l_args, x["data_flat"], st.sf, st.scE, st.scD)
            pl = step_linesearch_plain(*l_args, x["data"], st.sf, st.scE, st.scD)
            rel, ab = 0.0, 0.0
            for name, k_, p_ in zip(("zv", "s", "y", "w", "delta"), kl, pl):
                a, r = max_err(k_, p_)
                check(r <= tol, f"step_linesearch {tag}: {name} rel {r:.3e} > {tol:g}")
                rel, ab = max(rel, r), max(ab, a)
            rows["step_linesearch"] = {"abs": ab, "rel": rel}

            if timing:
                rows["newton_assemble"]["ms"] = time_ms(lambda: kernels.newton_assemble(*a_args))
                rows["newton_assemble"]["plain_ms"] = time_ms(
                    lambda: newton_assemble_plain(ops, bnd, x["sigma"], x["sgn_eff"],
                                                  x["ladder"], x["dd"]))
                rows["newton_schur"]["ms"] = time_ms(lambda: kernels.newton_schur(*s_args))
                rows["newton_schur"]["plain_ms"] = time_ms(
                    lambda: newton_schur_plain(ops, *s_args[1:]))
                rows["newton_al_solve"]["ms"] = time_ms(lambda: kernels.newton_al_solve(*n_args))
                rows["newton_al_solve"]["plain_ms"] = time_ms(
                    lambda: newton_al_solve_plain(ops, *n_args[1:]), reps=5)
                rows["step_linesearch"]["ms"] = time_ms(
                    lambda: kernels.step_linesearch(*l_args, x["data_flat"], st.sf,
                                                    st.scE, st.scD))
                rows["step_linesearch"]["plain_ms"] = time_ms(
                    lambda: step_linesearch_plain(*l_args, x["data"], st.sf, st.scE,
                                                  st.scD), reps=5)
            torch.cuda.synchronize()
            log(f"[kernels] {tag} R={R}: " + json.dumps(rows, default=float))
            if timing:
                report = rows
    return report


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
        check(all(v > 0 for v in counts.values()), f"entry {dtype}: launch counts {counts}")
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


def _batch_stats(r, B):
    it = r.iters.cpu().numpy()
    return {"feasible_fraction": float(r.feas.float().mean()),
            "iters_median": float(statistics.median(it.tolist())),
            "iters_p90": float(sorted(it.tolist())[int(0.9 * (B - 1))]),
            "iters_max": int(it.max()),
            "dispatched_lane_iters": int(it.max()) * B,
            "useful_lane_iters": int(it.sum())}


def phase_batch(dev, reps=5):
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
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r2 = solve(data)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        t = statistics.median(times)
        rerun = max((r2.z[k] - r.z[k]).abs().max().item() for k in r.z)
        stats.update(solves_per_s=B / t, seconds=times, rerun_max_abs_dz=rerun)
        log(f"[batch] {label}: " + json.dumps(stats) + f" launches {counts}")
        results[label] = (stats, counts, r2)
    stats_k, counts_k, rk = results["kernels"]
    check(stats_k["feasible_fraction"] >= 0.99,
          f"batch: kernel feasible fraction {stats_k['feasible_fraction']:.4f} < 0.99")
    check(all(v > 0 for v in counts_k.values()), f"batch: launch counts {counts_k}")
    check(all(v == 0 for v in results["plain"][1].values()),
          "batch: the plain run launched a kernel")
    rp = results["plain"][2]
    same = float((rk.iters == rp.iters).float().mean())
    dz = max((rk.z[k] - rp.z[k]).abs().max().item() for k in rk.z)
    log(f"[batch] kernels vs plain (float32): same iters on {same:.4f} of lanes, "
        f"max |dz| {dz:.3e}")
    return counts_k


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
    check("jax" not in sys.modules, "the port imported jax")
    dev = torch.device("cuda:0")

    phase_card()
    phase_build()
    k_report = phase_kernels(dev)
    if "--kernels" in argv:
        log("[smoke] --kernels: stopping after phase 3")
        return 0
    phase_entry(dev)
    counts = phase_batch(dev)
    check("jax" not in sys.modules, "the port imported jax")

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.kernels import (
        SOURCE_OF)

    rows = []
    for name in REPLACES:
        src = SOURCE_OF[name]
        r = k_report[name]
        if name == "spd_inv":
            ms = sum(v["ms"] for v in r.values())
            plain_ms = sum(v["plain_ms"] for v in r.values())
            err = max(v["abs"] for v in r.values())
        else:
            ms, plain_ms, err = r["ms"], r["plain_ms"], r["abs"]
        rows.append({"name": name, "route": "cuda",
                     "source": f"{PKG}/kernels/csrc/{src}.cu",
                     "replaces": REPLACES[name], "launches": counts[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "status": "ok"})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
