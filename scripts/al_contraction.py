"""Per-pass contraction of three augmented-Lagrangian refinements at the
same float64 iterates, on the CPU.

At the stages of tests/test_torch_al_solve.py (fixture rows 0 and 30 after
3 plain float64 iterations: fix_terminal and fix_eq_band x 5 candidates,
coupled motion x 2 candidates; 4 demo9 windows free time) every accepted
(lane, rung)'s AL solution after k = 0..K refinement passes is held to the
dense solve of the delta_d-regularised saddle system it refines towards
(torch.linalg.solve of solver/qr.py's saddle matrix), as
e_k = |sol_k - x|_max / |x|_max, for

* the JAX package's fused AL solve (its solver/ipm.py:957-973, one traced
  Newton body per k, its solutions read through jnp.concatenate as
  tests/test_torch_al_residual.py reads them);
* the port's newton_al_solve_plain (solver/newton.py), on the stage's own
  pieces;
* the port's AD arrow refinement (solver/ad.py arrow_al_solve, the JAX
  package's :1091-1106), on the pieces the AD body builds at the same
  state (HVP Hessian, jacrev Jacobians).

Prints one JSON line a stage: each method's worst e_k over the accepted
(lane, rung)s and the contraction factors e_{k+1} / e_k (median and max
over the (lane, rung)s, passes with e_k above 1e-9).

    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/al_contraction.py [--passes 4]
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

import jax
import jax.numpy as jnp

jax.config.update("jax_enable_x64", True)

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))

import vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.solver.ipm as jipm  # noqa: E402
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.models import (  # noqa: E402
    obca as jobca,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.solver import (  # noqa: E402
    IPMOptions as JOptions,
    make_obca_solver as jmake_solver,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (  # noqa: E402
    BENCH_FREE_OPTIONS, FIX6_OPTIONS, coupled_fixture_batch, demo9_window_batch,
    eq_band_fixture_batch, fix_fixture_batch,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (  # noqa: E402
    init_vars, obca,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime.scan_loop import (  # noqa: E402
    SCAN_OPTIONS,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (  # noqa: E402
    ad, make_obca_solver, qr,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.ipm import (  # noqa: E402
    _spd_inv,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.newton import (  # noqa: E402
    newton_al_solve_plain, newton_assemble_plain, newton_schur_plain,
)
from test_torch_al_residual import _JnpRecorder  # noqa: E402

F64 = torch.float64


def stage(kind):
    """(spec, data, opt, state after 3 plain iterations), the stages of
    tests/test_torch_al_solve.py _stage."""
    if kind == "free":
        spec, data, _, _ = demo9_window_batch(4, dtype=F64, device="cpu")
        opt, z0 = BENCH_FREE_OPTIONS, init_vars(spec, data)
    else:
        if kind == "fix_terminal":
            spec, _, data, cands = fix_fixture_batch(dtype=F64, device="cpu", rows=[0, 30])
        else:
            build = eq_band_fixture_batch if kind == "fix_eq_band" else coupled_fixture_batch
            spec, data, cands = build(dtype=F64, device="cpu", rows=[0, 30])
        nC = cands.shape[1]
        data = type(data)(*[f.repeat_interleave(nC, dim=0) for f in data])
        opt = SCAN_OPTIONS if spec.coupled_motion else FIX6_OPTIONS
        z0 = init_vars(spec, data, x_init=cands.reshape(-1, 3, spec.N + 1))
    opt = dataclasses.replace(opt, n_deltas=2)
    solve = make_obca_solver(spec, opt, impl="plain")
    st = solve.iterate(solve.init(data, z0), data, 3)
    return spec, data, opt, solve, st


def fused_args(spec, data, opt, solve, st):
    """newton_al_solve_plain's arguments at ``st`` (as _stage makes them)."""
    ops = solve.layout.ops("cpu", F64)
    sgn_raw, id_off = obca.ineq_identity_sgn_off(spec, data)
    sgn_eff = sgn_raw * ops.ds[ops.id_idx]
    bnd = solve.provider.plain(st.zv, data, st.sf, st.scE, st.scD, st.y,
                               st.w[:, ops.L.m_id:].contiguous())
    cI = torch.cat([sgn_eff * st.zv[:, ops.id_idx] + id_off, bnd.cD], 1)
    jeTp, jeTq = ops.f_jeT(bnd, st.y)
    jiTp, jiTq = ops.f_jiT(bnd, st.w, sgn_eff)
    r_d = bnd.g - ops.f_flat(jeTp + jiTp, jeTq + jiTq)
    up, uq = ops.f_jiT(bnd, (st.w * cI - st.mu_b[:, None]) / st.s, sgn_eff)
    rhs1, rhs2 = -r_d - ops.f_flat(up, uq), -bnd.cE
    ladder = (torch.clamp(st.delta, min=opt.delta0)[:, None]
              * torch.tensor([1.0, opt.delta_step], dtype=F64))
    dd = opt.delta_d_al
    asm = newton_assemble_plain(ops, bnd, st.w / st.s, sgn_eff, ladder, dd)
    Qinv = _spd_inv(asm[5])
    Yq, Smat = newton_schur_plain(ops, Qinv, asm[4], asm[3], ladder)
    return ops, (bnd, *asm[:3], asm[4], Qinv, Yq, _spd_inv(Smat), rhs1, rhs2, ladder, dd,
                 opt.delta_d)


def errors(sol, xs):
    """(B, R) e = |sol - x|_max / |x|_max."""
    return (sol - xs).abs().amax(-1) / xs.abs().amax(-1)


def measure(kind, passes):
    t0 = time.perf_counter()
    log = lambda what: print(f"[al_contraction] {kind} {what} {time.perf_counter() - t0:.1f} s",
                             file=sys.stderr, flush=True)
    spec, data, opt, solve, st = stage(kind)
    ops, args = fused_args(spec, data, opt, solve, st)
    K, _ = qr.saddle_matrix(ops, args[0], *args[1:4], args[10], args[12])
    rhs = torch.cat([args[8], args[9]], 1)[:, None, :, None].expand(K.shape[:3] + (1,))
    xs = torch.linalg.solve(K, rhs)[..., 0]
    n = ops.L.n
    active = ~st.done
    out = {"port_fused": [], "ad_arrow": [], "jax_fused": []}
    goods = None
    for k in range(passes + 1):
        sol, good = newton_al_solve_plain(ops, *args, k)
        goods = good if goods is None else goods & good
        out["port_fused"].append(errors(sol, xs))

    log("port")
    # the AD arrow body's pieces at the same state
    got = {}
    real = ad.arrow_al_solve

    def grab(*a):
        got["args"] = a
        return real(*a)

    asolve = make_obca_solver(spec, dataclasses.replace(opt, kkt="arrow"), impl="plain")
    ad.arrow_al_solve = grab
    try:
        asolve.step(st, data)
    finally:
        ad.arrow_al_solve = real
    p_idx = torch.as_tensor(obca.hessian_spine_probes(spec)["p_idx"])
    q_idx = torch.as_tensor(obca.arrow_layout(spec))
    inv = torch.empty(n, dtype=torch.int64)
    inv[torch.cat([p_idx, q_idx.reshape(-1)])] = torch.arange(n)
    for k in range(passes + 1):
        dp, dq, v, good = real(*got["args"][:-1], k)
        B, R = good.shape
        dz = torch.cat([dp, dq.reshape(B, R, -1)], -1)[..., inv]
        out["ad_arrow"].append(errors(torch.cat([dz, v], -1), xs))
        goods = goods & good

    log("ad arrow")
    # the JAX package's fused body, one traced solver a pass count
    jspec = jobca.OBCASpec(**dataclasses.asdict(spec))
    names = [f.name for f in dataclasses.fields(JOptions)]
    rec = _JnpRecorder(n + ops.L.mE)
    saved = jipm.jnp
    jipm.jnp = rec
    try:
        for k in range(passes + 1):
            jo = JOptions(**{f: getattr(opt, f) for f in names if hasattr(opt, f)} | {
                "n_refine": k, "kkt": "fused"})
            it = jax.jit(jmake_solver(jspec, jo).iterate)
            e = torch.full_like(out["port_fused"][0], float("nan"))
            for lane in range(st.zv.shape[0]):
                if not bool(active[lane]):
                    continue
                params = jobca.OBCAData(**{f: jnp.asarray(getattr(data, f)[lane].numpy())
                                           for f in data._fields})
                jst = jipm.IPMState(*[jnp.asarray(f[lane].numpy()) for f in st])
                rec.seen.clear()
                jax.block_until_ready(it(jst, params, int(st.it[lane]) + 1))
                assert len(rec.seen) == opt.n_deltas, len(rec.seen)
                for j in range(opt.n_deltas):
                    jsol = torch.as_tensor(np.array(rec.seen[j]))
                    e[lane, j] = errors(jsol[None, None], xs[lane:lane + 1, j:j + 1])[0, 0]
            out["jax_fused"].append(e)
            log(f"jax n_refine={k}")
    finally:
        jipm.jnp = saved

    sel = goods & active[:, None]
    row = {"stage": kind, "accepted": int(sel.sum())}
    for name, es in out.items():
        E = torch.stack(es, -1)[sel]                       # (accepted, passes + 1)
        factors = [(E[i, j + 1] / E[i, j]).item() for i in range(E.shape[0])
                   for j in range(passes) if E[i, j] > 1e-9]
        row[name] = {"worst_e": [float(E[:, j].max()) for j in range(passes + 1)],
                     "factor_median": statistics.median(factors) if factors else None,
                     "factor_max": max(factors) if factors else None}
    return row


def main(argv):
    passes = int(argv[argv.index("--passes") + 1]) if "--passes" in argv else 4
    for kind in ("fix_terminal", "fix_eq_band", "coupled"):
        print(json.dumps(measure(kind, passes)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
