"""CPU checks of what ``newton_al_solve`` keeps and of its launch arithmetic.

The kernel (``kernels/csrc/newton.cu``) runs one CTA a lane, its R rungs in
rung groups, on one of two routes that its C host code picks from the
layout and the dtype (``al_route``) and ``kernels.al_solve_route``
mirrors: ``staged`` (the lane's operands copied into shared memory) where
they fit in 227 KB, else ``global`` (the operands read from device memory,
a CTA a rung). It runs only on the card; here:

* the route mirror: ``kernels.al_solve_route`` picks the staged route at
  the fix and free shapes in float32 and the global route at N = 74 in
  both dtypes, with a byte count equal to the .cu file's formula written
  out below (``_cu_route``) at the fix, free, sweep, demo8 and open-loop
  shapes and at the fix step's width in fix_eq_band and coupled motion
  (S = 4 slots a block: Wpq, Gpq0, Yq and a group's Gpq wq grow by a
  quarter), and refuses a lane whose vectors outgrow shared memory;
* what the kernel must keep, on ``newton_al_solve_plain`` in float64 at
  the fix and free shapes: its solution is the AL iteration's on the
  delta_d-regularised saddle system K = [[W + delta I, JE^T], [JE,
  -delta_d I]] assembled densely (``solver/qr.py saddle_matrix``): the
  error against a dense ``torch.linalg.solve`` shrinks with every
  refinement, to 1e-6 after 8, and agrees with the AL solution's own
  residual (sol - x* = K^-1 (K sol - rhs)); ``good`` is the curvature test
  dz^T W dz + delta |dz|^2 > 0 on the dense W; a NaN in one rung's Sinv or
  one lane's Qinv rejects that (lane, rung) and no other (these two also
  in fix_eq_band and coupled motion).

Inputs: fixture rows and demo9 windows after 3 plain iterations, made
from the repository's seeded fixtures; the convergence test also on
right-hand sides drawn from a numpy seed.
"""

import numpy as np
import pytest
import torch

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
    BENCH_FREE_OPTIONS, FIX6_OPTIONS, coupled_fixture_batch, demo9_window_batch,
    eq_band_fixture_batch, fix_fixture_batch, horizon_inputs,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime.scan_loop import (
    SCAN_OPTIONS,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
    OBCASpec, init_vars, obca,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models.obca_struct import (
    make_layout,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
    make_obca_solver, qr,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.ipm import (
    _spd_inv,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.newton import (
    newton_al_solve_plain, newton_assemble_plain, newton_schur_plain,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

F32, F64 = torch.float32, torch.float64


# ------------------------------------------------------------ the route

def _cu_route(lay, R, elem):
    """csrc/newton.cu al_route, written out: (route, ctas, groups,
    threads, smem); None where it does not fit (VMP_TOO_LARGE)."""
    r8 = lambda count: (count * elem + 7) // 8 * 8
    np_, K, bq, mE, n, mE_sp, S = lay.np_, lay.K, lay.bq, lay.mE, lay.n, lay.mE_sp, lay.S
    ld = 8 if np_ <= 8 else 8 + (np_ - 8 + 15) // 16 * 16      # al_ld
    ldB = bq | 1
    tables = (np_ * 4 + 7) // 8 * 8 + (K * 4 + 7) // 8 * 8           # al_table_bytes
    lane = tables + (r8(mE_sp * ld) + r8(2 * K) + r8(2 * K * bq) + r8(np_ * ld)
                     + r8(S * K * bq) + r8(K * bq * ldB) + r8(S * K * bq) + r8(n)
                     + r8(mE))                                          # al_lane_bytes
    rung = r8(K * bq * ldB) + r8(S * K * bq) + r8(np_ * ld)           # al_rung_bytes
    r64 = lambda count: (count * 8 + 7) // 8 * 8
    vec = (5 * r64(np_) + 2 * r64(K * bq) + r64(S * K) + 2 * r64(mE)   # al_vec_bytes:
           + 3 * 32 * 8)                                              # float64 vectors
    budget = 227 * 1024 - 1024                                          # AL_SMEM_BUDGET
    G = min(R, 2)                                                       # AL_MAX_G
    for g in ([G, 1] if G > 1 else [1]):
        if lane + g * (rung + vec) <= budget:
            return ("staged", 1, g, 256, lane + g * (rung + vec))       # AL_TG
    if tables + vec <= budget:
        return ("global", R, 1, 1024, tables + vec)                     # AL_TG_GLOBAL
    return None


def _spec(name):
    if name in ("fix", "fix8"):
        spec6, spec8, _, _ = fix_fixture_batch(dtype=F64, device="cpu", rows=[0])
        return spec6 if name == "fix" else spec8
    if name == "free":
        return demo9_window_batch(2, dtype=F64, device="cpu")[0]
    if name == "band":
        return eq_band_fixture_batch(dtype=F64, device="cpu", rows=[0])[0]
    if name == "coupled":
        return coupled_fixture_batch(dtype=F64, device="cpu", rows=[0])[0]
    if name == "sweep":      # the sweep's worlds: demo1's family, ShapeSpec(3, 1, 4)
        return OBCASpec(N=6, n_obs=4, e_max=4, variant="free")
    if name == "demo8":
        return OBCASpec(N=15, n_obs=4, e_max=4, variant="fix_terminal")
    return horizon_inputs(int(name[1:]), F64, "cpu")[0]


ROUTES = {   # (shape, R, dtype): (route, CTAs a lane, rung groups a CTA)
    ("fix", 2, F32): ("staged", 1, 2), ("fix", 2, F64): ("staged", 1, 2),
    ("fix8", 2, F32): ("staged", 1, 2), ("free", 1, F32): ("staged", 1, 1),
    ("free", 2, F32): ("staged", 1, 2), ("free", 2, F64): ("staged", 1, 1),
    ("sweep", 2, F32): ("staged", 1, 2), ("demo8", 2, F64): ("global", 2, 1),
    ("N74", 2, F32): ("global", 2, 1), ("N74", 2, F64): ("global", 2, 1),
    ("N74", 1, F64): ("global", 1, 1), ("N150", 2, F64): ("global", 2, 1),
    ("band", 2, F32): ("staged", 1, 2), ("band", 2, F64): ("staged", 1, 2),
    ("coupled", 2, F32): ("staged", 1, 2), ("coupled", 2, F64): ("staged", 1, 2),
}


@pytest.mark.parametrize("shape,R,dtype", list(ROUTES))
def test_route_mirrors_the_cu_formula(shape, R, dtype):
    lay = make_layout(_spec(shape))
    route = kernels.al_solve_route(lay, R, dtype)
    elem = torch.empty((), dtype=dtype).element_size()
    assert tuple(route) == _cu_route(lay, R, elem)
    assert (route.route, route.ctas, route.groups) == ROUTES[(shape, R, dtype)]
    assert route.groups * route.threads <= 1024
    assert route.smem <= kernels.SMEM_MAX - 1024


def test_route_refuses_what_shared_memory_cannot_hold():
    """Above N ~ 170 in float64 even the global route's vectors outgrow a
    CTA's shared memory: the wrapper raises (the .cu host code returns
    VMP_TOO_LARGE); newton_schur's limit lies lower still."""
    lay = make_layout(OBCASpec(N=180, n_obs=6, e_max=4, variant="free"))
    assert _cu_route(lay, 2, 8) is None
    with pytest.raises(ValueError, match="shared memory"):
        kernels.al_solve_route(lay, 2, F64)


# ------------------------------------------------------ what it keeps

def _stage(kind):
    """newton_al_solve_plain's arguments after 3 plain float64 iterations:
    fixture rows 0 and 30 x 5 candidates (fix_terminal and fix_eq_band, R
    = 2), x 2 candidates (coupled motion) or 4 demo9 windows (free, R =
    2)."""
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
    solve = make_obca_solver(spec, opt, impl="plain")
    st = solve.iterate(solve.init(data, z0), data, 3)
    ops = solve.layout.ops("cpu", F64)
    sgn_raw, id_off = obca.ineq_identity_sgn_off(spec, data)
    sgn_eff = sgn_raw * ops.ds[ops.id_idx]
    w_d = st.w[:, ops.L.m_id:].contiguous()
    bnd = solve.provider.plain(st.zv, data, st.sf, st.scE, st.scD, st.y, w_d)
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


@pytest.fixture(scope="module", params=["fix_terminal", "free"])
def stage(request):
    return request.param, _stage(request.param)


@pytest.fixture(scope="module", params=["fix_terminal", "free", "fix_eq_band", "coupled"])
def any_stage(request):
    """``stage`` and the variants' (whose AL passes contract by ~0.5-0.8
    each at these iterates: the convergence test's halving does not apply)."""
    return request.param, _stage(request.param)


def _dense(ops, args):
    bnd, Wpp, Wpq, Wqq, _, _, _, _, rhs1, rhs2, ladder, _, delta_d = args
    K, W = qr.saddle_matrix(ops, bnd, Wpp, Wpq, Wqq, ladder, delta_d)
    rhs = torch.cat([rhs1, rhs2], 1)[:, None, :, None].expand(K.shape[:3] + (1,))
    return K, W, rhs


@pytest.mark.parametrize("rhs", ["iterate", "seeded"])
def test_al_solve_converges_to_the_dense_saddle_solve(stage, rhs):
    """On the iterate's right-hand sides and on random ones (a numpy
    seed)."""
    kind, (ops, args) = stage
    if rhs == "seeded":
        rng = np.random.RandomState(7)
        r1, r2 = (torch.as_tensor(rng.standard_normal(tuple(a.shape))) for a in args[8:10])
        args = args[:8] + (r1, r2) + args[10:]
    K, _, rhs = _dense(ops, args)
    xs = torch.linalg.solve(K, rhs)[..., 0]
    errs = []
    for n_refine in range(9):
        sol, good = newton_al_solve_plain(ops, *args, n_refine)
        fin = torch.isfinite(sol).all(-1)
        assert fin.sum() >= fin.numel() // 2, kind
        errs.append(((sol - xs).abs().amax(-1) / xs.abs().amax(-1))[fin].max().item())
        # the error is what the AL solution's own residual says it is
        res = K @ torch.nan_to_num(sol)[..., None] - rhs
        dx = torch.linalg.solve(K, res)[..., 0]
        assert ((sol - xs) - dx)[fin].abs().max() <= 1e-8 * xs[fin].abs().max()
    # every refinement contracts the error until rounding takes over
    for a, b in zip(errs, errs[1:]):
        assert b <= 0.5 * a or b <= 1e-10, (kind, errs)
    assert errs[-1] <= 1e-6, (kind, errs)


def test_good_is_the_curvature_test(any_stage):
    kind, (ops, args) = any_stage
    _, W, _ = _dense(ops, args)
    ladder = args[10]
    for n_refine in (1, 2):
        sol, good = newton_al_solve_plain(ops, *args, n_refine)
        dz = sol[..., :ops.L.n]
        curv = (torch.einsum("brn,bnm,brm->br", dz, W, dz)
                + ladder * (dz * dz).sum(-1))
        assert torch.equal(good, torch.isfinite(sol).all(-1) & (curv > 0)), kind


def test_a_planted_nan_rejects_its_rung_alone(any_stage):
    kind, (ops, args) = any_stage
    sol, good = newton_al_solve_plain(ops, *args, 1)
    B, R = good.shape
    Qinv, Sinv = args[5].clone(), args[7].clone()
    Sinv[0, 0, 1, 2] = float("nan")            # one (lane, rung)'s Schur inverse
    Qinv[B - 1, R - 1, 0, 3, 3] = float("nan")   # another lane's dual block
    bad = args[:5] + (Qinv, args[6], Sinv) + args[8:]
    sol_b, good_b = newton_al_solve_plain(ops, *bad, 1)
    planted = torch.zeros_like(good)
    planted[0, 0] = planted[B - 1, R - 1] = True
    assert not good_b[planted].any(), kind
    assert torch.isnan(sol_b[planted]).all(), kind
    assert torch.equal(good_b[~planted], good[~planted]), kind
    assert torch.allclose(sol_b[~planted], sol[~planted], rtol=0, atol=0, equal_nan=True), kind
