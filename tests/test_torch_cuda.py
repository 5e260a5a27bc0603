"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: these tests need an NVIDIA GPU with ``nvcc`` and skip
elsewhere (the check is made inside the fixture, never at import). Run on
the card with ``python -m pytest --noconftest tests/test_torch_cuda.py -q``
(``tests/conftest.py`` imports jax, which that machine lacks). Small
problems (demo1, N = 6, three lanes; three rows of the fix-time fixture x
5 candidates; a 2-step demo1 rollout) in float64, tolerance 1e-9
(max-normalised); ``spd_inv`` at m = 1-120 (both routes) in both dtypes
with non-SPD matrices planted in the first and the last column, and its
CUDA graph replay at m = 8 and 33 bit for bit against an eager call;
the wavefront A* on 64 and 256 random maps (its CTA and warp routes) and
the walk of a field too large to stage, bit for bit;
the long-horizon kernels (``spd_inv_blocked`` at m = 124, 204, 254 and
374 with non-SPD matrices planted in its first and last panels, and its
CUDA graph replay bit for bit against an eager call; the AL solve (its
global route) and the line search (its spread route) at demo9 N = 74 in
float64), within 1e-9; ``step_linesearch`` on both of its routes
(``kernels.ls_route``, equal to the library's) at the fix step's, the free
batch's, the sweep's and the open loops' shapes in both dtypes, with
planted lanes and a CUDA graph replay (``chip_smoke.py``'s
``check_linesearch``), at n_backtracks 1-32, and with its arena in device
memory at N = 100 in float64; ``newton_al_solve`` at the main paths'
shapes (fix_terminal, fix_free_end, the free batch, the sweep, demo8) in
both dtypes by ``chip_smoke.py``'s rules (float64 within 1e-9, float32
by the saddle residual), with NaNs planted in one rung's Sinv and one
lane's Qinv, and its CUDA graph replay on both routes; ``newton_assemble`` at
N = 74 (its spine tile grid), full and W-only, and ``kkt_qr`` at a sweep
rung's 32 matrices and at demo8's order 726, in both dtypes (float64
within 1e-9, float32 by the saddle residual as ``chip_smoke.py`` holds
it) with a planted NaN; ``ipm_freeze`` against its plain version bit for
bit at 1-300 lanes, at the main paths' shapes (the library's copy plan
pinned to tests/test_torch_freeze.py's, inactive lanes untouched, a graph
replay) and at 65792 lanes; ``newton_schur`` at the main paths' shapes
(the library's launch plan pinned to tests/test_torch_schur.py's, against
its plain version, the entries outside the clique bit for bit, a planted
NaN, a graph replay; also at the fix_eq_band and coupled-motion
widths); the fix_eq_band and coupled-motion variants at the fix step's
width (every kernel of the fused body and ``kkt_qr`` by phase 3's rules,
with their graph replays) and a B = 8 multistart of each through the
graphed loop against the plain host loop, every kernel launched; the
graphed Newton loop against the host loop, for ``kkt="qr"`` too, bit for
bit, also with a collection due inside its capture, and for the AD
solver's structured ``arrow`` family (``solver/ad.py``); the device loop
(``kernels/csrc/device_loop.cu``: each solve one graph whose iterations
run under a conditional WHILE node) bit-equal to ``loop="host"`` in both
dtypes on the free batch, the fix step, a QR rung, the N = 74 open loop
and every AD family, with no host synchronisation between its launch and
its results (``torch.cuda.set_sync_debug_mode("error")``), its graph
reused with new data, and the coupled-motion free solve's bits the same
on two runs;
``kkt_qr_dense`` (the QR solve of assembled saddle matrices) against its
plain version on a sweep rung's 32 matrices in both dtypes, bit-equal to
``kkt_qr``'s assembled route on the same matrices or within its limit;
the compacted solve
(``solver/compact.py``) on 64 of the free batch's windows in both dtypes,
its buckets of 64 and 16 lanes on the line search's two routes, bit-equal
to the monolithic solve, and a batch capped by the solver's own
``max_iters``; ``chip_smoke.py`` checks the full-size shapes.
"""

import dataclasses
import gc
import os
import sys

import numpy as np
import pytest
import torch

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
    ENTRY_OPTIONS, FIX6_OPTIONS, FIX8_OPTIONS, demo1_problem, demo_rollout_inputs,
    fix_fixture_batch, make_fix_step, openloop_n74_inputs,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
    OBCASpec, build_obca_data, init_vars, obca,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models.obca_struct import (
    KKTBundle,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.ops import astar
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime import (
    make_scan_rollout,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime.multistart import (
    make_multistart_solver,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
    random_scenarios,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
    build_solver, loop, make_obca_solver, qr,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.ipm import (
    _spd_inv,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.linesearch import (
    step_linesearch_plain,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.newton import (
    newton_al_solve_plain, newton_assemble_plain, newton_schur_plain,
)

pytestmark = pytest.mark.cuda

# the kernels of every fused Newton iteration
SOLVER_FUSED = ("obca_kkt_provider", "spd_inv", "newton_assemble", "newton_schur",
                "newton_al_solve", "step_linesearch")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _three_lanes(dev):
    spec, data, scn, _ = demo1_problem(torch.float64, dev)
    x0 = torch.stack([scn.start, scn.start + torch.tensor([0.3, 0.1, 0.05], device=dev,
                                                          dtype=torch.float64),
                      scn.start + torch.tensor([-0.2, 0.2, -0.1], device=dev,
                                               dtype=torch.float64)])
    data = build_obca_data(spec, scn, x0=x0, u0=torch.zeros(2), Ts=0.1,
                           xref=data.xref.expand(3, -1, -1))
    return spec, data


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-300)).item()


def _spd_small_inputs(m, count, dev):
    """``count`` SPD matrices of order m (float64, seeded), matrix 2
    non-SPD from its first pivot and matrix ``count - 1`` from its last."""
    rng = np.random.RandomState(m)
    M = torch.as_tensor(rng.randn(count, m, m), device=dev)
    A = M @ M.transpose(1, 2) / m + torch.eye(m, device=dev, dtype=torch.float64)
    A[2, 0, 0] = -5.0
    Lc = torch.linalg.cholesky(A[-1])
    A[-1, m - 1, m - 1] -= Lc[m - 1, m - 1] ** 2 + 1.0   # the last pivot becomes -1
    return A


@pytest.mark.parametrize("m", [1, 8, 16, 17, 33, 54, 79, 120])
def test_spd_inv_matches_plain_and_flags_non_spd(dev, m):
    """spd_inv at both routes' orders (a thread a matrix up to 16, a warp
    above), both dtypes: the planted non-SPD matrices, and only they, whole
    NaN; the rest within 1e-9 (float64) or 1e-3 (float32) of plain."""
    A64 = _spd_small_inputs(m, 70, dev)   # more than a CTA of either route
    for dtype in (torch.float64, torch.float32):
        A = A64.to(dtype).contiguous()
        n0 = kernels.launches["spd_inv"]
        Xk, Xp = kernels.spd_inv(A), _spd_inv(A)
        assert kernels.launches["spd_inv"] == n0 + 1
        bad = [2, 69]
        assert torch.isnan(Xk[bad]).all()
        assert not torch.isfinite(Xp[bad]).flatten(1).all(1).any()
        keep = torch.ones(70, dtype=torch.bool, device=dev)
        keep[bad] = False
        assert torch.isfinite(Xk[keep]).all()
        tol = 1e-9 if dtype == torch.float64 else 1e-3
        assert _rel(Xk[keep], Xp[keep]) <= tol


def test_spd_inv_graph_replay_is_bit_equal(dev):
    """kernels.spd_inv at m = 8 (a thread a matrix) and m = 33 (a warp a
    matrix) captured in a CUDA graph: a replay equals an eager call bit for
    bit, also after new data with non-SPD matrices and back."""
    for m, count in ((8, 300), (33, 70)):
        A64 = _spd_small_inputs(m, count, dev)
        for dtype in (torch.float64, torch.float32):
            mixed = A64.to(dtype).contiguous()
            good = mixed[[0, 1, 3] * (count // 3) + [0] * (count % 3)].contiguous()
            A = good.clone()
            s = torch.cuda.Stream()
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                kernels.spd_inv(A)
            torch.cuda.current_stream().wait_stream(s)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                out = kernels.spd_inv(A)
            for data in (good, mixed, good):
                A.copy_(data)
                g.replay()
                eager = kernels.spd_inv(data)
                torch.cuda.synchronize()
                assert torch.equal(out.isnan(), eager.isnan())
                assert torch.equal(out.nan_to_num(0.0), eager.nan_to_num(0.0))
                if data is mixed:
                    assert torch.isnan(out[[2, count - 1]]).all()
            assert torch.isfinite(out).all()


def test_solve_through_kernels_matches_plain(dev):
    spec, data = _three_lanes(dev)
    kernels.reset_launch_counts()
    rk = make_obca_solver(spec, ENTRY_OPTIONS)(data)
    counts = dict(kernels.launches)
    rp = make_obca_solver(spec, ENTRY_OPTIONS, impl="plain")(data)
    # every kernel of the fused path (kkt_qr serves kkt="qr" only, the
    # A* kernels the sweep's reference paths)
    assert all(counts[k] > 0 for k in SOLVER_FUSED), counts
    assert rk.iters.tolist() == rp.iters.tolist()
    assert rk.feas.tolist() == rp.feas.tolist()
    for k in rk.z:
        assert (rk.z[k] - rp.z[k]).abs().max().item() <= 1e-6, k


# kind -> the provider's launch plan there: values threads, rows a spine
# tile, spine and block CTAs a lane, values a lane, one launch
PROVIDER_PLANS = {"demo1": (384, 41, 2, 3, 263, 0), "fix_terminal": (96, 81, 0, 0, 202, 1),
                  "open74 free": (512, 10, 90, 56, 3187, 0)}


@pytest.mark.parametrize("kind", ["demo1", "fix_terminal", "open74 free"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_provider_matches_plain(dev, kind, dtype):
    """The provider against the plain version at three launch plans
    (demo1's 3 lanes, the fix step's 1280 in one launch, the N = 74 open
    loop's 5 with its spine tiles halved), float64 within 1e-9 and float32
    within 1e-3; the library's plan is the one tests/test_torch_provider.py
    pins for the .cu formula written out, and a CUDA graph replay equals
    the eager call."""
    if kind == "demo1":
        spec, data = _three_lanes(dev)
        data = type(data)(*[f.to(dtype) if f.is_floating_point() else f for f in data])
        solve = make_obca_solver(spec, ENTRY_OPTIONS, impl="plain")
        st = solve.init(data)
        w_d = st.w[:, solve.layout.m_id:].contiguous()
        y = torch.randn(st.y.shape, dtype=dtype, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
        st = st._replace(y=y)
        x = dict(spec=spec, data=data, st=st, L=solve.layout, w_d=w_d,
                 ops=solve.layout.ops(dev, dtype), data_flat=kernels.pack_obca_data(data),
                 bnd=solve.provider.plain(st.zv, data, st.sf, st.scE, st.scD, y, w_d))
    else:
        x = _smoke()._stage_inputs(kind, dtype, dev, 1)
    cs = _smoke()
    args = cs._provider_args(x)
    kb = kernels.obca_kkt_provider(*args)
    for f in kb._fields:
        assert _rel(getattr(kb, f), getattr(x["bnd"], f)) <= (
            1e-9 if dtype == torch.float64 else 1e-3), f
    plan = cs._provider_plan(x, args[3].shape[0])
    assert (plan.values_threads, plan.rows_per_tile, plan.spine_ctas, plan.block_ctas,
            plan.n_values, plan.lane) == PROVIDER_PLANS[kind]
    for g_, k_ in zip(cs._graph_once(lambda: kernels.obca_kkt_provider(*args)), kb):
        assert _bit_equal(g_, k_)


@pytest.mark.parametrize("kind", ["band fix_eq_band", "coupled free"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_variant_kernels_match_plain(dev, kind, dtype):
    """fix_eq_band and coupled motion at the fix step's width (chip_smoke's
    stages: 1280 and 512 lanes, R = 2): every kernel of the fused body and
    kkt_qr against its plain version by phase 3's rules (float64 within
    1e-9; float32 within 1e-3, the saddle solves by their residual), each
    checked graph replay bit-equal to the eager call."""
    cs = _smoke()
    x = cs._stage_inputs(kind, dtype, dev, 2)
    n0 = dict(kernels.launches)
    rows = cs.check_kernels(x, kind, False)
    assert {"obca_kkt_provider", "newton_assemble", "newton_schur", "newton_al_solve",
            "step_linesearch", "kkt_qr"} <= set(rows)
    assert all(kernels.launches[k] > n0[k] for k in SOLVER_FUSED + ("kkt_qr",))


@pytest.mark.parametrize("name", ["band", "coupled"])
def test_variant_multistart_through_kernels(dev, name):
    """One multistart solve of each variant batch at 8 fixture rows through
    make_obca_solver (the graphed loop and the kernels, float64): every
    kernel of the fused body launched, and the plain host loop's result
    (feasibility and iterations equal, z within 1e-6)."""
    cs = _smoke()
    spec, data, cands, opt, nC = cs._variant_batch(name, torch.float64, dev, B=8)
    out = {}
    for impl, loop in ((None, "graph"), ("plain", "host")):
        ms = make_multistart_solver(spec, make_obca_solver(spec, opt, impl=impl, loop=loop),
                                    init_vars, nC)
        kernels.reset_launch_counts()
        out[impl] = ms(data, cands)[0], dict(kernels.launches)
    (rk, ck), (rp, cp) = out[None], out["plain"]
    assert all(ck[k] > 0 for k in SOLVER_FUSED + ("ipm_freeze",)), ck
    assert not any(cp.values()), cp
    assert rk.feas.tolist() == rp.feas.tolist()
    assert rk.iters.tolist() == rp.iters.tolist()
    for k in rk.z:
        assert (rk.z[k] - rp.z[k]).abs().max().item() <= 1e-6, k


def test_provider_beyond_65535_lanes(dev):
    """The dense launch at more lanes than a grid's y dimension holds: the
    free batch's 256 lanes (float32, spine tiles and block tiles) tiled to
    65792 give on their last 256 lanes the bits of their first 256, within
    1e-3 of the plain version."""
    cs = _smoke()
    x = cs._stage_inputs("free", torch.float32, dev, 1)
    args = cs._provider_args(x)
    big = (*args[:3], *[t.repeat(257, *[1] * (t.dim() - 1)) for t in args[3:]])
    assert cs._provider_plan(x, 65792).lane == 0
    kbig = kernels.obca_kkt_provider(*big)
    for f, k_ in zip(kbig._fields, kbig):
        assert _bit_equal(k_[-256:], k_[:256]), f
        assert _rel(k_[-256:], getattr(x["bnd"], f)) <= 1e-3, f


def _stage(spec, opt, data, z0, dtype=torch.float64):
    """Every Newton kernel's inputs after 3 plain iterations of ``data``
    from ``z0`` (init_vars) in ``dtype``, R = 2."""
    dev = data.x0.device
    data = type(data)(*[f.to(dtype) if f.is_floating_point() else f for f in data])
    solve = make_obca_solver(spec, opt, impl="plain")
    z0 = {k: v.to(dtype) for k, v in z0.items()}
    st = solve.iterate(solve.init(data, z0), data, 3)
    L = solve.layout
    ops = L.ops(dev, dtype)
    sgn_raw, id_off = obca.ineq_identity_sgn_off(spec, data)
    sgn_eff = sgn_raw * ops.ds[ops.id_idx]
    w_d = st.w[:, L.m_id:].contiguous()
    bnd = solve.provider.plain(st.zv, data, st.sf, st.scE, st.scD, st.y, w_d)
    cI = torch.cat([sgn_eff * st.zv[:, ops.id_idx] + id_off, bnd.cD], 1)
    jeTp, jeTq = ops.f_jeT(bnd, st.y)
    jiTp, jiTq = ops.f_jiT(bnd, st.w, sgn_eff)
    r_d = bnd.g - ops.f_flat(jeTp + jiTp, jeTq + jiTq)
    up, uq = ops.f_jiT(bnd, (st.w * cI - st.mu_b[:, None]) / st.s, sgn_eff)
    rhs1 = (-r_d - ops.f_flat(up, uq)).contiguous()
    rhs2 = (-bnd.cE).contiguous()
    ladder = (torch.clamp(st.delta, min=opt.delta0)[:, None]
              * torch.tensor([1.0, opt.delta_step], dtype=dtype, device=dev))
    return dict(spec=spec, opt=opt, data=data, solve=solve, st=st, L=L, ops=ops,
                sgn_eff=sgn_eff, id_off=id_off, w_d=w_d, bnd=bnd, cI=cI,
                sigma=st.w / st.s, rhs1=rhs1, rhs2=rhs2, ladder=ladder.contiguous())


def _fix_stage(dev, variant, dtype=torch.float64, rows=(0, 30, 60)):
    """Every fix-time kernel's inputs after 3 plain iterations: fixture
    rows ``rows`` x 5 candidates, R = 2."""
    spec6, spec8, data, cands = fix_fixture_batch(dtype=torch.float64, device=dev,
                                                  rows=list(rows))
    spec, opt = (spec6, FIX6_OPTIONS) if variant == "fix_terminal" else (spec8, FIX8_OPTIONS)
    data = type(data)(*[f.repeat_interleave(5, dim=0) for f in data])
    z0 = init_vars(spec, data, x_init=cands.reshape(-1, 3, spec.N + 1))
    return _stage(spec, opt, data, z0, dtype)


@pytest.mark.parametrize("variant", ["fix_terminal", "fix_free_end"])
def test_fix_variant_kernels_match_plain(dev, variant):
    x = _fix_stage(dev, variant)
    st, bnd, L, ops, opt = x["st"], x["bnd"], x["L"], x["ops"], x["opt"]
    kb = x["solve"].provider(st.zv, x["data"], st.sf, st.scE, st.scD, st.y, x["w_d"])
    for f in bnd._fields:
        assert _rel(getattr(kb, f), getattr(bnd, f)) <= 1e-9, f
    dd = opt.delta_d_al
    asm = [a.contiguous() for a in newton_assemble_plain(
        ops, bnd, x["sigma"], x["sgn_eff"], x["ladder"], dd)]
    ka = kernels.newton_assemble(L, bnd, x["sigma"], x["sgn_eff"], x["ladder"], dd)
    for k_, p_ in zip(ka, asm):
        assert _rel(k_, p_) <= 1e-9
    Qinv = _spd_inv(asm[5]).contiguous()
    Yq, Sm = [t.contiguous() for t in newton_schur_plain(ops, Qinv, asm[4], asm[3],
                                                          x["ladder"])]
    kY, kS = kernels.newton_schur(L, Qinv, asm[4], asm[3], x["ladder"])
    assert _rel(kY, Yq) <= 1e-9 and _rel(kS, Sm) <= 1e-9
    Sinv = _spd_inv(Sm).contiguous()
    args = (bnd, *asm[:3], asm[4], Qinv, Yq, Sinv, x["rhs1"], x["rhs2"], x["ladder"],
            dd, opt.delta_d, opt.n_refine)
    sols, goods = newton_al_solve_plain(ops, *args)
    ksol, kgood = kernels.newton_al_solve(L, *args)
    assert kgood.tolist() == goods.tolist()
    fin = torch.isfinite(sols).all(-1)
    assert _rel(ksol[fin], sols[fin]) <= 1e-9
    la = (ops, opt, sols.contiguous(), goods.contiguous(), x["ladder"], st.zv, st.s,
          st.y, st.w, st.mu_b, st.delta, x["cI"], bnd.cE, bnd.f, bnd, x["sgn_eff"],
          x["id_off"])
    kl = kernels.step_linesearch(*la, kernels.pack_obca_data(x["data"]), st.sf,
                                 st.scE, st.scD)
    pl = step_linesearch_plain(*la, x["data"], st.sf, st.scE, st.scD)
    for k_, p_ in zip(kl, pl):
        assert _rel(k_, p_) <= 1e-9
    # the QR saddle solve, and a planted non-finite entry rejects its lanes
    qargs = (ops, bnd, *asm[:3], x["rhs1"], x["rhs2"], x["ladder"], opt.delta_d)
    qs, qg = qr.kkt_qr_plain(*qargs)
    ks, kg = kernels.kkt_qr(*qargs)
    assert kg.tolist() == qg.tolist() and bool(qg.any())
    assert _rel(ks, qs) <= 1e-9
    planted = [2, 7, 11]
    Wbad = asm[0].clone()
    Wbad[planted[:2], 3, 3] = float("inf")
    Wbad[planted[2], 0, 5] = float("nan")
    bargs = (ops, bnd, Wbad, *asm[1:3], x["rhs1"], x["rhs2"], x["ladder"], opt.delta_d)
    kg_bad, pg_bad = kernels.kkt_qr(*bargs)[1], qr.kkt_qr_plain(*bargs)[1]
    assert kg_bad.tolist() == pg_bad.tolist()
    others = [i for i in range(kg.shape[0]) if i not in planted]
    assert not kg_bad[planted].any() and kg_bad[others].tolist() == kg[others].tolist()


def test_fix_step_through_kernels_matches_plain(dev):
    spec6, spec8, data, cands = fix_fixture_batch(dtype=torch.float64, device=dev,
                                                  rows=[0, 1, 30])
    kernels.reset_launch_counts()
    rk, rungs_k = make_fix_step(spec6, spec8, qr_rescue=True)(data, cands)
    counts = dict(kernels.launches)
    rp, rungs_p = make_fix_step(spec6, spec8, qr_rescue=True, impl="plain")(data, cands)
    assert all(counts[k] > 0 for k in SOLVER_FUSED), counts
    for a, b in zip(rungs_k, rungs_p):
        assert a.iters.tolist() == b.iters.tolist()
        assert a.feas.tolist() == b.feas.tolist()
    assert rk.feas.all()
    for k in rk.z:
        assert (rk.z[k] - rp.z[k]).abs().max().item() <= 1e-6, k


@pytest.mark.parametrize("B", [64, 256])   # a CTA a map; a warp a map
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_astar_kernels_match_plain(dev, dtype, B):
    scn, _ = random_scenarios(3, B, dtype=dtype, device=dev)
    cell = lambda pose: pose[:, [1, 0]].to(torch.int32)
    goal, start = cell(scn.goal), cell(scn.start)
    _, R, C = scn.grid.shape
    route = kernels.astar_route(B, R, C, dtype)
    assert route.route == ("cta" if B < kernels.ASTAR_WARP_MIN_MAPS else "warp")
    assert kernels.astar_route_of_library(B, R, C, dtype) == (
        route, kernels.astar_walk(B, R, C, dtype))
    n0 = dict(kernels.launches)
    d, relax = kernels.astar_cost_to_go(scn.grid.contiguous(), goal, 102)
    dp, relax_p = astar.cost_to_go_plain(scn.grid, goal, 102)
    torch.cuda.synchronize()
    assert torch.equal(d, dp) and torch.equal(relax, relax_p)
    path, valid = astar.extract_path(d, start, 64)
    pp, vp = astar.extract_path_plain(dp, start, 64)
    assert torch.equal(path, pp) and torch.equal(valid, vp)
    assert kernels.launches["astar_cost_to_go"] == n0["astar_cost_to_go"] + 1
    assert kernels.launches["astar_extract_path"] == n0["astar_extract_path"] + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_astar_walk_in_device_memory(dev, dtype):
    """A field too large to stage in shared memory, NaN cells planted:
    the walk reads device memory (chip_smoke.py's _astar_large_walk)."""
    field, start = _smoke()._astar_large_walk(dtype, dev)
    assert kernels.astar_walk(*field.shape, dtype).smem == 0
    path, valid = kernels.astar_extract_path(field, start, 64)
    pp, vp = astar.extract_path_plain(field, start, 64)
    assert torch.equal(path, pp) and torch.equal(valid, vp)


def test_rollout_through_kernels_matches_plain(dev):
    scn, shape, p, ref, ref_len = demo_rollout_inputs("demo1", torch.float64, dev)
    out = {}
    for impl in (None, "plain"):
        roll = make_scan_rollout(shape, p, max_steps=2, dtype=torch.float64, device=dev,
                                 impl=impl)
        out[impl] = roll(scn, ref, ref_len)
    (fk, tk), (fp, tp) = out[None], out["plain"]
    assert torch.equal(tk["fixtime"], tp["fixtime"]) and bool(tk["feas"].all())
    for key in ("x", "u", "plan"):
        assert _rel(tk[key], tp[key]) <= 1e-9, key


def _spd_blocked_inputs(m, count, dev):
    """``count`` SPD matrices of order m (float64, seeded), matrix 1
    non-SPD from its pivot 3 and matrix ``count - 1`` from pivot m - 3,
    in the last, partial panel of spd_inv_blocked."""
    rng = np.random.RandomState(m)
    M = torch.as_tensor(rng.randn(count, m, m), device=dev)
    A = M @ M.transpose(1, 2) / m + torch.eye(m, device=dev, dtype=torch.float64)
    A[1, 3, 3] = -5.0
    i = m - 3
    assert i // kernels.SPDB_NB == -(-m // kernels.SPDB_NB) - 1 and m % kernels.SPDB_NB
    Lc = torch.linalg.cholesky(A[-1, :i + 1, :i + 1])
    A[-1, i, i] -= Lc[i, i] ** 2 + 1.0      # pivot i becomes -1
    return A


@pytest.mark.parametrize("m", [124, 204, 254, 374])
def test_spd_inv_blocked_matches_plain(dev, m):
    A64 = _spd_blocked_inputs(m, 5, dev)
    for dtype in (torch.float64, torch.float32):
        A = A64.to(dtype).contiguous()
        n0 = kernels.launches["spd_inv_blocked"]
        Xk, Xp = kernels.spd_inv(A), _spd_inv(A)
        assert kernels.launches["spd_inv_blocked"] == n0 + 1
        for bad in (1, 4):
            assert torch.isnan(Xk[bad]).all() and not torch.isfinite(Xp[bad]).all()
        keep = [0, 2, 3]
        assert torch.isfinite(Xk[keep]).all()
        tol = 1e-9 if dtype == torch.float64 else 1e-3
        assert _rel(Xk[keep], Xp[keep]) <= tol


def test_spd_inv_blocked_graph_replay_is_bit_equal(dev):
    """kernels.spd_inv at m = 374 captured in a CUDA graph: a replay equals
    an eager call bit for bit, also after new data (a non-SPD matrix, then
    SPD again: the flag is reset inside the graph)."""
    A64 = _spd_blocked_inputs(374, 5, dev)
    for dtype in (torch.float64, torch.float32):
        good = A64[[0, 2, 3, 0, 2]].to(dtype).contiguous()
        mixed = A64.to(dtype).contiguous()
        A = good.clone()
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            kernels.spd_inv(A)
        torch.cuda.current_stream().wait_stream(s)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = kernels.spd_inv(A)
        for data in (good, mixed, good):
            A.copy_(data)
            g.replay()
            eager = kernels.spd_inv(data)
            torch.cuda.synchronize()
            assert torch.equal(out.isnan(), eager.isnan())
            assert torch.equal(out.nan_to_num(0.0), eager.nan_to_num(0.0))
            if data is mixed:
                assert torch.isnan(out[[1, 4]]).all()
        assert torch.isfinite(out).all()


def _n74_stage(dev, dtype):
    """demo9 N = 74 free time, its 5 candidate lanes after 3 plain
    iterations, R = 2."""
    spec, data, cands, opt = openloop_n74_inputs(torch.float64, dev)
    data = type(data)(*[f.repeat_interleave(5, dim=0) for f in data])
    return _stage(spec, opt, data, init_vars(spec, data, x_init=cands[0]), dtype)


def test_long_horizon_al_solve_and_linesearch_match_plain(dev):
    """demo9 N = 74 free time, float64: the AL solve reads its operands
    from device memory (its global route), the line search runs a CTA per
    (lane, trial) (its spread route)."""
    x = _n74_stage(dev, torch.float64)
    st, bnd, L, ops, opt = x["st"], x["bnd"], x["L"], x["ops"], x["opt"]
    ladder, rhs1, rhs2, sgn_eff = x["ladder"], x["rhs1"], x["rhs2"], x["sgn_eff"]
    assert kernels.al_solve_route(L.lay, 2, torch.float64).route == "global"
    dd = opt.delta_d_al
    asm = [a.contiguous() for a in newton_assemble_plain(ops, bnd, x["sigma"], sgn_eff,
                                                          ladder, dd)]
    Qinv = _spd_inv(asm[5]).contiguous()
    Yq, Sm = [t.contiguous() for t in newton_schur_plain(ops, Qinv, asm[4], asm[3], ladder)]
    Sinv = _spd_inv(Sm).contiguous()
    args = (bnd, *asm[:3], asm[4], Qinv, Yq, Sinv, rhs1, rhs2, ladder, dd, opt.delta_d,
            opt.n_refine)
    sols, goods = newton_al_solve_plain(ops, *args)
    ksol, kgood = kernels.newton_al_solve(L, *args)
    assert kgood.tolist() == goods.tolist() and bool(goods.any())
    fin = torch.isfinite(sols).all(-1)
    assert _rel(ksol[fin], sols[fin]) <= 1e-9
    la = (ops, opt, sols.contiguous(), goods.contiguous(), ladder, st.zv, st.s, st.y, st.w,
          st.mu_b, st.delta, x["cI"], bnd.cE, bnd.f, bnd, sgn_eff, x["id_off"])
    data_flat = kernels.pack_obca_data(x["data"])
    assert kernels.ls_route(L.lay, data_flat.shape[1], 5, opt.n_backtracks,
                            torch.float64).route == "spread"
    kl = kernels.step_linesearch(*la, data_flat, st.sf, st.scE, st.scD)
    pl = step_linesearch_plain(*la, x["data"], st.sf, st.scE, st.scD)
    for k_, p_ in zip(kl, pl):
        assert _rel(k_, p_) <= 1e-9


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """chip_smoke.py's phase 3 machinery: the main paths' stages and the
    saddle-residual rule (check_saddle_solve); phase 13's bucket recorder."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke


def _al_stage(dev, kind, dtype, R):
    """chip_smoke's stage of ``kind`` (after 3 plain iterations, with the
    plain versions' outputs); "sweep" is 64 of the sweep's worlds x its 2
    free-time candidates."""
    cs = _smoke()
    if kind != "sweep":
        return cs._stage_inputs(kind, dtype, dev, R)
    spec, data, opt, cands = cs._rollout_problem("sweep", "free", dtype, dev, B=64)
    nC = cands.shape[1]
    data = type(data)(*[f.repeat_interleave(nC, dim=0) for f in data])
    z0 = init_vars(spec, data, x_init=cands.reshape((-1,) + cands.shape[2:]))
    solve = make_obca_solver(spec, opt, impl="plain")
    st = solve.iterate(solve.init(data, z0), data, 3)
    return cs._stage_from("sweep free", spec, data, opt, solve, st, R)


def _al_args(x):
    return (x["L"], x["bnd"], *x["asm"][:3], x["asm"][4], x["Qinv"], x["Yq"], x["Sinv"],
            x["rhs1"], x["rhs2"], x["ladder"], x["dd"], x["opt"].delta_d, x["opt"].n_refine)


def _bit_equal(a, b):
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))


@pytest.mark.parametrize("kind,R", [("fix_terminal", 2), ("fix_free_end", 2), ("free", 1),
                                    ("sweep", 2), ("demo8 fix_terminal", 2)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_al_solve_matches_plain(dev, kind, R, dtype):
    """newton_al_solve against newton_al_solve_plain at the main paths'
    shapes (the fix step's 1280 lanes, the free batch's 256, 128 sweep
    lanes, demo8's 150 replans; the staged route, and the global one at
    demo8 in float64): float64 within 1e-9 and float32 by phase 3's
    saddle-residual rule, good equal."""
    cs = _smoke()
    x = _al_stage(dev, kind, dtype, R)
    lay = x["L"].lay
    assert kernels.al_solve_route(lay, R, dtype) == kernels.al_solve_route_of_library(
        x["spec"], lay, R, dtype)
    n0 = kernels.launches["newton_al_solve"]
    ksol, kgood = kernels.newton_al_solve(*_al_args(x))
    torch.cuda.synchronize()
    assert kernels.launches["newton_al_solve"] == n0 + 1
    x64 = cs._float64(x)
    exact = None
    if dtype == torch.float32:
        exact = newton_al_solve_plain(
            x64["ops"], x64["bnd"], *x64["asm"][:3], x64["asm"][4], x64["Qinv"], x64["Yq"],
            x64["Sinv"], x64["rhs1"], x64["rhs2"], x64["ladder"], x["dd"], x["opt"].delta_d,
            x["opt"].n_refine)[0]
    cs.check_saddle_solve("newton_al_solve", kind, x64, ksol, kgood, x["sols"], x["goods"],
                          exact)
    assert bool(kgood.any())


@pytest.mark.parametrize("kind,dtype", [("fix_terminal", torch.float32),
                                        ("fix_terminal", torch.float64),
                                        ("demo8 fix_terminal", torch.float64)])
def test_al_solve_planted_nan_rejects_its_rung_alone(dev, kind, dtype):
    """A NaN in one (lane, rung)'s Sinv and another in one lane's Qinv give
    good = False on those rungs and nowhere else, as the plain version."""
    x = _al_stage(dev, kind, dtype, 2)
    args = _al_args(x)
    ksol, kgood = kernels.newton_al_solve(*args)
    B, R = kgood.shape
    Qinv, Sinv = x["Qinv"].clone(), x["Sinv"].clone()
    Sinv[3, 0, 1, 2] = float("nan")
    Qinv[B // 2, R - 1, 5, 2, 2] = float("nan")
    bad = args[:6] + (Qinv, args[7], Sinv) + args[9:]
    bsol, bgood = kernels.newton_al_solve(*bad)
    pgood = newton_al_solve_plain(x["ops"], *bad[1:])[1]
    planted = torch.zeros_like(kgood)
    planted[3, 0] = planted[B // 2, R - 1] = True
    assert not bool(bgood[planted].any())
    assert torch.equal(bgood, pgood)
    assert torch.equal(bgood[~planted], kgood[~planted])
    assert _bit_equal(bsol[~planted], ksol[~planted])


def test_al_solve_graph_replay_is_bit_equal(dev):
    """The AL solve captured in a CUDA graph (both routes: the fix step's
    staged one in float32, demo8's global one in float64) replays bit for
    bit what an eager call gives, also after new data lands in its
    inputs."""
    for kind, dtype in (("fix_terminal", torch.float32), ("demo8 fix_terminal", torch.float64)):
        x = _al_stage(dev, kind, dtype, 2)
        args = _al_args(x)
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            kernels.newton_al_solve(*args)
        torch.cuda.current_stream().wait_stream(s)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            gsol, ggood = kernels.newton_al_solve(*args)
        for scale in (1.0, 0.5):
            x["rhs1"].mul_(scale)
            g.replay()
            esol, egood = kernels.newton_al_solve(*args)
            torch.cuda.synchronize()
            assert torch.equal(ggood, egood) and _bit_equal(gsol, esol), (kind, scale)


@pytest.mark.parametrize("kind", ["fix_terminal", "free", "sweep", "open74 free",
                                  "open50 fix_terminal"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_linesearch_routes_match_plain(dev, kind, dtype):
    """step_linesearch on both routes at a main path's widths against
    step_linesearch_plain (float64 within 1e-9, float32 within 1e-3):
    the batch's own route on every lane, clean and with planted lanes (a
    NaN in the picked rung, no good rung, every trial rejected, a_s = 0),
    the other route on a slice or a tiling of the lanes; the route equal
    to the library's; a graph replay bit-equal to the eager call."""
    cs = _smoke()
    x = _al_stage(dev, kind, dtype, 2)
    row = cs.check_linesearch(x, kind)
    B, nb = x["ladder"].shape[0], x["opt"].n_backtracks
    assert row["route"]["route"] == ("spread" if B * nb <= kernels.LS_SPREAD_CTAS else "group")
    assert row["other planted"]["route"] != row["route"]["route"]


@pytest.mark.parametrize("nb", [1, 3, 16, 32])
def test_linesearch_any_n_backtracks(dev, nb):
    """n_backtracks from 1 to 32 on both routes (the fix step's stage in
    float64)."""
    x = _al_stage(dev, "fix_terminal", torch.float64, 2)
    x["opt"] = dataclasses.replace(x["opt"], n_backtracks=nb)
    _smoke().check_linesearch(x, f"nb={nb}")


def test_linesearch_arena_in_device_memory(dev):
    """demo9's free-time horizon N = 100 in float64: both routes' arenas
    outgrow shared memory and run over a device workspace."""
    cs = _smoke()
    x = cs._stage_inputs("open100 free", torch.float64, dev, 2)
    lay, nb = x["L"].lay, x["opt"].n_backtracks
    for B in (5, kernels.LS_SPREAD_CTAS // nb + 1):
        assert kernels.arena_in_device_memory(
            kernels.ls_route(lay, x["data_flat"].shape[1], B, nb, torch.float64).arena)
    cs.check_linesearch(x, "N100")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_long_horizon_assemble_matches_plain(dev, dtype):
    """newton_assemble at np = 374 (21 spine tiles a lane), full and
    W-only, against the plain version."""
    x = _n74_stage(dev, dtype)
    L, ops, bnd = x["L"], x["ops"], x["bnd"]
    args = (bnd, x["sigma"], x["sgn_eff"], x["ladder"], x["opt"].delta_d_al)
    n0 = kernels.launches["newton_assemble"]
    for w_only in (False, True):
        ka = kernels.newton_assemble(L, *args, w_only=w_only)
        pa = newton_assemble_plain(ops, *args, w_only=w_only)
        assert len(ka) == len(pa) == (3 if w_only else 6)
        for k_, p_ in zip(ka, pa):
            assert _rel(k_, p_) <= (1e-9 if dtype == torch.float64 else 1e-3)
    assert kernels.launches["newton_assemble"] == n0 + 2


def _qr_check(ops, bnd, W, rhs1, rhs2, ladder, delta_d, planted):
    """kkt_qr against the plain version, then with a NaN planted in W at
    the lanes ``planted``: those rungs rejected, the others unchanged."""
    args = (ops, bnd, *W, rhs1, rhs2, ladder, delta_d)
    n0 = kernels.launches["kkt_qr"]
    ks, kg = kernels.kkt_qr(*args)
    ps, pg = qr.kkt_qr_plain(*args)
    assert kernels.launches["kkt_qr"] == n0 + 1
    assert kg.tolist() == pg.tolist() and bool(pg.any())
    fin = torch.isfinite(ps).all(-1)
    if ks.dtype == torch.float64:
        assert _rel(ks[fin], ps[fin]) <= 1e-9
    else:   # another factorization: held by its saddle residual, as in chip_smoke.py
        K = qr.saddle_matrix(ops, bnd, *W, ladder, delta_d)[0].double()
        rhs = torch.cat([rhs1, rhs2], 1)[:, None].double()
        res = lambda sol: ((K @ sol.double()[..., None])[..., 0] - rhs).abs().amax(-1) / (
            rhs.abs().amax(-1))
        eps = torch.finfo(ks.dtype).eps
        assert bool((res(ks) <= 3.0 * res(ps) + 1e3 * eps)[pg].all())
    Wbad = W[0].clone()
    Wbad[planted, 1, 1] = float("nan")
    kg_bad = kernels.kkt_qr(ops, bnd, Wbad, *W[1:], rhs1, rhs2, ladder, delta_d)[1]
    pg_bad = qr.kkt_qr_plain(ops, bnd, Wbad, *W[1:], rhs1, rhs2, ladder, delta_d)[1]
    assert kg_bad.tolist() == pg_bad.tolist() and not bool(kg_bad[planted].any())
    others = [i for i in range(kg.shape[0]) if i not in planted]
    assert kg_bad[others].tolist() == kg[others].tolist()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kkt_qr_sweep_batch_matches_plain(dev, dtype):
    """A sweep rescue rung's batch: 16 fixture lanes x R = 2 = 32 matrices
    of order 294."""
    x = _fix_stage(dev, "fix_free_end", dtype, rows=(0, 30, 60, 90))
    sl = lambda t: t[:16].contiguous()
    bnd = type(x["bnd"])(*[sl(t) for t in x["bnd"]])
    W = [sl(t).contiguous() for t in newton_assemble_plain(
        x["ops"], bnd, sl(x["sigma"]), sl(x["sgn_eff"]), sl(x["ladder"]),
        x["opt"].delta_d_al, w_only=True)]
    assert x["L"].n + x["L"].mE == 294
    _qr_check(x["ops"], bnd, W, sl(x["rhs1"]), sl(x["rhs2"]), sl(x["ladder"]),
              x["opt"].delta_d, [1, 9])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kkt_qr_demo8_order_matches_plain(dev, dtype):
    """demo8's N = 15 layout (M = 726, 23 panels: the matrix beyond any
    CTA's shared memory), 3 lanes x R = 2 on a seeded, well-conditioned
    saddle system."""
    spec = OBCASpec(N=15, n_obs=4, e_max=4, variant="fix_free_end")
    L = make_obca_solver(spec, FIX8_OPTIONS).layout
    assert L.n + L.mE == 726
    ops = L.ops(dev, dtype)
    rng = np.random.RandomState(8)
    t = lambda *shape: torch.as_tensor(rng.randn(*shape), device=dev).to(dtype)
    B = 3
    Wpp, Wqq = t(B, L.np_, L.np_), t(B, L.K, L.bq, L.bq)
    Wpp = Wpp + Wpp.transpose(1, 2) + 40.0 * torch.eye(L.np_, device=dev, dtype=dtype)
    Wqq = Wqq + Wqq.transpose(2, 3) + 40.0 * torch.eye(L.bq, device=dev, dtype=dtype)
    W = [Wpp.contiguous(), t(B, L.K, L.S, L.bq), Wqq.contiguous()]
    e = lambda *shape: torch.zeros(shape, device=dev, dtype=dtype)
    bnd = KKTBundle(f=e(B), g=e(B, L.n), cE=e(B, L.mE), cD=e(B, L.mD),
                    JE_sp=t(B, L.mE_sp, L.np_), JEb_th=t(B, L.K, 2),
                    JEb_q=t(B, L.K, 2, L.bq), JD_sp=e(B, L.mD_sp, L.np_),
                    JDb_p=e(B, L.K, 2, L.S), JDb_q=e(B, L.K, 2, L.bq),
                    Hpp=e(B, L.np_, L.np_), Hpq_c=e(B, L.K, L.S, L.bq),
                    Hqq=e(B, L.K, L.bq, L.bq))
    ladder = torch.tensor([[1e-6, 1e-4]] * B, device=dev, dtype=dtype)
    _qr_check(ops, bnd, W, t(B, L.n), t(B, L.mE), ladder, 1e-6, [2])


def _random_state(dev, dtype, B, seed):
    """An IPMState of the entry problem's shapes, every field random."""
    spec, data = _three_lanes(dev)
    st = make_obca_solver(spec, ENTRY_OPTIONS).init(data)
    g = torch.Generator(dev).manual_seed(seed)
    out = []
    for f in st:
        shape = (B,) + tuple(f.shape[1:])
        if f.dtype == torch.bool:
            out.append(torch.rand(shape, device=dev, generator=g) < 0.3)
        elif f.dtype == torch.int32:
            out.append(torch.randint(0, 12, shape, device=dev, generator=g,
                                     dtype=torch.int32))
        else:
            out.append(torch.randn(shape, device=dev, generator=g).to(dtype))
    return type(st)(*out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ipm_freeze_matches_plain(dev, dtype):
    for B in (1, 2, 5, 300):
        old = _random_state(dev, dtype, B, 0)
        new = _random_state(dev, dtype, B, 1)
        new = new._replace(sf=old.sf)   # a field the body passes through
        active = torch.rand(B, device=dev) < 0.6
        cap = torch.tensor([7], dtype=torch.int32, device=dev)
        pst, pnext, pflag = loop.freeze_plain(new, old, active, cap)
        kst = type(old)(*[f.clone() for f in old])
        knew = new._replace(sf=kst.sf)
        kact, flag = active.clone(), torch.full((1,), 5, dtype=torch.int32, device=dev)
        n0 = kernels.launches["ipm_freeze"]
        kernels.ipm_freeze(knew, kst, kact, cap, flag)
        torch.cuda.synchronize()
        assert kernels.launches["ipm_freeze"] == n0 + 1
        for name, a, b in zip(old._fields, kst, pst):
            assert torch.equal(a, b), name
        assert torch.equal(kact, pnext) and torch.equal(flag, pflag)
    # no lane active: the state stays bit-identical, and the flags are
    # the loop test of that state
    off = torch.zeros(B, dtype=torch.bool, device=dev)
    kst2 = type(old)(*[f.clone() for f in old])
    kernels.ipm_freeze(new, kst2, off, cap, flag)
    assert all(torch.equal(a, b) for a, b in zip(kst2, old))
    assert torch.equal(off, (old.it < cap) & ~old.done)
    assert int(flag) == int(off.any())


def _bits(t):
    """The raw bits of a tensor, to compare bit for bit (NaN and -0 included)."""
    return t.contiguous().view(-1).view(torch.uint8)


def _freeze_case(dev, kind, B, dtype, alias):
    """tests/test_torch_freeze.py's random state at a main path's widths,
    on the card; the pass-through fields aliased as the loop passes them."""
    from test_torch_freeze import PASS_THROUGH, _inputs

    new, old, active, cap = _inputs(kind, B, dtype, alias, seed=B)
    old = type(old)(*[f.to(dev) for f in old])
    new = type(new)(*[f.to(dev) for f in new])
    if alias:
        new = new._replace(**{f: getattr(old, f) for f in PASS_THROUGH})
    return new, old, active.to(dev), cap.to(dev)


@pytest.mark.parametrize("key", [
    ("fix", 1280, "float32", True), ("fix", 1280, "float32", False),
    ("fix", 1280, "float64", True), ("free", 256, "float32", True),
    ("sweep", 2048, "float32", True), ("N74", 5, "float32", True),
    ("N74", 5, "float64", True), ("host6", 2, "float32", True),
    ("host6", 5, "float32", True), ("host15", 2, "float32", True),
    ("host15", 5, "float32", True)])
def test_ipm_freeze_plan_bits_and_graph(dev, key):
    """ipm_freeze at the main paths' shapes: the library's copy plan is the
    one tests/test_torch_freeze.py pins for the .cu formula written out;
    state, next flags and loop flag bit-equal to freeze_plain, inactive
    lanes' rows untouched bit for bit, the pass-through fields never
    written, and a CUDA graph replay bit-equal to the eager call."""
    from test_torch_freeze import FREEZE_PLANS, PASS_THROUGH

    kind, B, dt, alias = key
    new, old, active, cap = _freeze_case(dev, kind, B, getattr(torch, dt), alias)
    pst, pnext, pflag = loop.freeze_plain(new, old, active, cap)
    runs = []
    for graphed in (False, True):
        kst = type(old)(*[f.clone() for f in old])
        knew = new._replace(**{f: getattr(kst, f) for f in PASS_THROUGH}) if alias else new
        kact, flag = active.clone(), torch.full((1,), 7, dtype=torch.int32, device=dev)
        fn = lambda: kernels.ipm_freeze(knew, kst, kact, cap, flag)
        fn()
        if graphed:   # captured after the eager call, replayed on the inputs reset
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                fn()
            for k_, o_ in zip(kst, old):
                k_.copy_(o_)
            kact.copy_(active)
            flag.fill_(7)
            g.replay()
        torch.cuda.synchronize()
        for name, a, b in zip(old._fields, kst, pst):
            assert torch.equal(_bits(a), _bits(b)), name
        assert torch.equal(kact, pnext) and torch.equal(flag, pflag)
        runs.append([_bits(t) for t in (*kst, kact, flag)])
        off = ~active
        for name, a, o in zip(old._fields, kst, old):
            assert torch.equal(_bits(a[off]), _bits(o[off])), name
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    ints = kernels._freeze_ints(kernels._DTYPE_CODE[getattr(torch, dt)], B, old,
                                [kernels.freeze_field_mode(n, o) for n, o in zip(new, old)])
    plan = kernels.freeze_launch_plan(ints)
    assert (plan.slots, plan.per_thread, plan.ctas) == FREEZE_PLANS[key]
    assert plan.items == B * plan.slots and plan.threads == 128


def test_ipm_freeze_beyond_65535_lanes(dev):
    """65792 lanes of the host driver's N = 6 widths (float32, the
    pass-through fields aliased): the grid holds its items on x, and the
    last CTA writes every lane's flag; bit-equal to freeze_plain."""
    from test_torch_freeze import PASS_THROUGH

    new, old, active, cap = _freeze_case(dev, "host6", 65792, torch.float32, True)
    pst, pnext, pflag = loop.freeze_plain(new, old, active, cap)
    knew = new._replace(**{f: getattr(old, f) for f in PASS_THROUGH})
    kact, flag = active.clone(), torch.zeros(1, dtype=torch.int32, device=dev)
    kernels.ipm_freeze(knew, old, kact, cap, flag)
    torch.cuda.synchronize()
    for name, a, b in zip(old._fields, old, pst):
        assert torch.equal(_bits(a), _bits(b)), name
    assert torch.equal(kact, pnext) and torch.equal(flag, pflag)


def _schur_case(dev, kind, B, R, dtype):
    """tests/test_torch_schur.py's layout and random inputs of a main
    path's shape, on the card."""
    from test_torch_schur import _inputs, _kind, _layout

    L = _layout(_kind(kind))
    return L, [t.to(dev) for t in _inputs(L, B, R, dtype, seed=B)]


@pytest.mark.parametrize("key", [
    ("fix", 1280, 2, 4), ("fix", 1280, 2, 8), ("free", 256, 1, 4), ("free", 256, 2, 4),
    ("free", 256, 2, 8), ("sweep", 2048, 2, 4), ("N74", 5, 2, 4), ("N74", 5, 2, 8),
    ("N50", 2, 2, 4), ("host6", 2, 2, 4), ("host6", 5, 2, 4), ("host15", 2, 2, 4),
    ("host15", 5, 2, 4), ("band", 1280, 2, 4), ("band", 1280, 2, 8), ("coupled", 512, 2, 4),
    ("coupled", 512, 2, 8), ("coupled", 8, 2, 4), ("coupled", 8, 2, 8)])
def test_newton_schur_plan_and_plain(dev, key):
    """newton_schur at the main paths' shapes: the library's launch plan is
    the one tests/test_torch_schur.py pins; Yq and S against
    newton_schur_plain (float64 within 1e-12, float32 within 1e-5), the
    entries outside the diagonal and the clique blocks Gpp0's own bits and
    the diagonal outside them Gpp0 + delta bit for bit; a NaN planted in
    the last lane's Qinv (rung R - 1) reaches that (lane, rung)'s Yq and S
    alone; a CUDA graph replay bit-equal to the eager call."""
    from test_torch_schur import SCHUR_PLANS

    kind, B, R, e = key
    dtype = torch.float32 if e == 4 else torch.float64
    L, (Qinv, Gpq0, Gpp0, ladder) = _schur_case(dev, kind, B, R, dtype)
    plan = kernels.schur_launch_plan(L.spec, L.lay, R, B, dtype)
    assert (plan.tiles, plan.rows, plan.threads, plan.smem) == SCHUR_PLANS[key]
    ops = L.ops(dev, dtype)
    kY, kS = kernels.newton_schur(L, Qinv, Gpq0, Gpp0, ladder)
    pY, pS = newton_schur_plain(ops, Qinv, Gpq0, Gpp0, ladder)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert _rel(kY, pY) <= tol and _rel(kS, pS) <= tol
    touched = ops.clique(torch.ones(1, L.K, L.S, L.S, dtype=dtype, device=dev))[0] != 0
    eye = torch.eye(L.np_, dtype=torch.bool, device=dev)
    plain = ~touched & ~eye
    assert torch.equal(_bits(kS[:, :, plain]), _bits(Gpp0[:, None].expand_as(kS)[:, :, plain]))
    diag = eye & ~touched
    assert torch.equal(_bits(kS[:, :, diag]),
                       _bits(Gpp0[:, None][:, :, diag] + ladder[..., None]))
    g = _smoke()._graph_once(lambda: kernels.newton_schur(L, Qinv, Gpq0, Gpp0, ladder))
    assert torch.equal(_bits(g[0]), _bits(kY)) and torch.equal(_bits(g[1]), _bits(kS))
    Qbad = Qinv.clone()
    Qbad[-1, R - 1, L.K // 2, 3, 1] = float("nan")
    bY, bS = kernels.newton_schur(L, Qbad, Gpq0, Gpp0, ladder)
    nan_S = bS.isnan().flatten(2).any(-1)
    nan_Y = bY.isnan().flatten(2).any(-1)
    expect = torch.zeros((B, R), dtype=torch.bool, device=dev)
    expect[-1, R - 1] = True
    assert torch.equal(nan_S, expect) and torch.equal(nan_Y, expect)
    ok = ~expect
    assert torch.equal(_bits(bS[ok]), _bits(kS[ok])) and torch.equal(_bits(bY[ok]), _bits(kY[ok]))


def test_qr_solve_graphed_loop_matches_host_loop(dev):
    """kkt="qr" (the W-only assembly and the blocked kkt_qr, several
    kernels a call) through the captured loop: bit-equal to the host loop,
    with the same launches."""
    spec6, spec8, data, cands = fix_fixture_batch(dtype=torch.float64, device=dev,
                                                  rows=[0, 30])
    data = type(data)(*[f.repeat_interleave(5, dim=0) for f in data])
    z0 = init_vars(spec8, data, x_init=cands.reshape(-1, 3, spec8.N + 1))
    opt = dataclasses.replace(FIX8_OPTIONS, kkt="qr")
    out = {}
    for mode in ("host", "graph"):
        solve = make_obca_solver(spec8, opt, loop=mode)
        kernels.reset_launch_counts()
        loop.reset_stats()
        st = solve.iterate(solve.init(data, z0), data, 12)
        torch.cuda.synchronize()
        out[mode] = (st, dict(kernels.launches), dict(loop.stats), dict(loop.warmup_launches))
    (sh, ch, _, _), (sg, cg, stats, warm) = out["host"], out["graph"]
    for name, a, b in zip(sh._fields, sh, sg):
        assert torch.equal(a, b), name
    assert ch["kkt_qr"] > 0 and ch["newton_schur"] == 0
    # the graph's launches, counted from its iterations, + the eager run
    # before the capture (one iteration) are the host loop's + that run's
    assert {k: cg[k] - warm.get(k, 0) for k in ("kkt_qr", "newton_assemble")} == {
        k: ch[k] for k in ("kkt_qr", "newton_assemble")}
    assert stats["captures"] == 1 and stats["replays"] > 0


def _solve_chunks(solve, data, caps):
    st = solve.init(data)
    for c in caps:
        st = solve.iterate(st, data, c)
    return st


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_graphed_loop_matches_host_loop(dev, dtype):
    """The captured body + ipm_freeze under the device loop's WHILE node
    runs the host loop's iterations bit for bit, with the same launches of
    every fused kernel (after the eager run before the capture); lanes
    finish at different iterations and the cap moves between calls, one
    graph launch a call."""
    spec, data = _three_lanes(dev)
    data = type(data)(*[f.to(dtype) if f.is_floating_point() else f for f in data])
    out = {}
    for mode in ("host", "graph"):
        solve = make_obca_solver(spec, ENTRY_OPTIONS, loop=mode)
        kernels.reset_launch_counts()
        loop.reset_stats()
        st = _solve_chunks(solve, data, (1, 4, 9, 100))
        torch.cuda.synchronize()
        out[mode] = (st, dict(kernels.launches), dict(loop.stats), dict(loop.warmup_launches))
    (sh, ch, _, _), (sg, cg, stats, warm) = out["host"], out["graph"]
    assert len(set(sh.it.tolist())) > 1, sh.it
    for name, a, b in zip(sh._fields, sh, sg):
        assert torch.equal(a, b), name
    assert cg["ipm_freeze"] > 0 and ch["ipm_freeze"] == 0
    assert cg["device_loop"] == 4 and ch["device_loop"] == 0
    assert {k: cg[k] - warm.get(k, 0) for k in SOLVER_FUSED} == {k: ch[k] for k in SOLVER_FUSED}
    assert stats["captures"] == 1 and stats["replays"] > 0


def test_graph_reused_across_calls_with_new_data(dev):
    spec, data = _three_lanes(dev)
    other = data._replace(x0=data.x0 + torch.tensor([0.1, -0.1, 0.02], device=dev,
                                                    dtype=torch.float64))
    graphed = make_obca_solver(spec, ENTRY_OPTIONS)
    host = make_obca_solver(spec, ENTRY_OPTIONS, loop="host")
    loop.reset_stats()
    for d in (data, other, data):
        rg, rh = graphed(d), host(d)
        assert rg.iters.tolist() == rh.iters.tolist()
        for k in rg.z:
            assert torch.equal(rg.z[k], rh.z[k]), k
    assert loop.stats["captures"] == 1


def test_graph_capture_pauses_garbage_collection(dev, monkeypatch):
    """An unreachable captured graph that a collection would destroy in the
    middle of the Newton loop's capture (which CUDA forbids): the loop
    pauses the collector while it captures, and the solve still equals the
    host loop's bit for bit."""
    spec, data = _three_lanes(dev)
    x = torch.zeros(4, device=dev)
    old = torch.cuda.CUDAGraph()
    with torch.cuda.graph(old):
        y = x + 1
    box = [old, y]
    box.append(box)           # a cycle: only the collector frees it
    holder = [box]
    del old, y, box
    seen = []
    orig = loop.freeze

    def freeze(*args):
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())
            if gc.isenabled():   # what an automatic collection here would do
                holder.clear()
                gc.collect()
        return orig(*args)

    monkeypatch.setattr(loop, "freeze", freeze)
    st = _solve_chunks(make_obca_solver(spec, ENTRY_OPTIONS, loop="graph"), data, (100,))
    torch.cuda.synchronize()
    assert seen == [False] and gc.isenabled()
    holder.clear()
    gc.collect()
    sh = _solve_chunks(make_obca_solver(spec, ENTRY_OPTIONS, loop="host"), data, (100,))
    for name, a, b in zip(sh._fields, sh, st):
        assert torch.equal(a, b), name


def _compact_batch(dev, dtype):
    """Every 4th of the free batch's 256 windows (slow and fast lanes)."""
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        BENCH_FREE_OPTIONS, demo9_starts, demo9_window_batch,
    )
    starts, _ = demo9_starts(256)
    spec, data, _, _ = demo9_window_batch(64, dtype=dtype, device=dev, starts=starts[::4])
    return spec, data, BENCH_FREE_OPTIONS


def _assert_results_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        if isinstance(x, dict):
            for k in x:
                assert torch.equal(_bits(x[k]), _bits(y[k])), f"z[{k}]"
        else:
            assert torch.equal(_bits(x), _bits(y)), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_compacted_solve_matches_monolithic_on_both_linesearch_routes(dev, dtype):
    """solve_compacted on the card: buckets of 64 lanes (the line search's
    group route), then, once at most 16 lanes are left at a chunk's end
    (chunks of 2 iterations), 16 (its spread route), each bucket one graph
    capture through the kernels (each chunk one launch of it), every lane's
    result bit-equal to the monolithic solve's."""
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        solve_compacted,
    )
    spec, data, opt = _compact_batch(dev, dtype)
    solve = make_obca_solver(spec, opt)
    width = kernels.pack_obca_data(data).shape[1]
    lay = solve.layout.lay
    assert kernels.ls_route(lay, width, 64, opt.n_backtracks, dtype).route == "group"
    assert kernels.ls_route(lay, width, 16, opt.n_backtracks, dtype).route == "spread"
    loop.reset_stats()
    mono = solve(data)
    assert loop.stats["captures"] == 1
    kernels.reset_launch_counts()
    rec = _smoke()._Buckets(solve)   # the buckets it ran
    comp, stats = solve_compacted(rec, data, chunk=2, min_bucket=16, shrink=4)
    torch.cuda.synchronize()
    sizes = {b for b, _ in rec.calls}
    assert {64, 16} <= sizes, rec.calls
    _assert_results_equal(comp, mono)
    counts = dict(kernels.launches)
    assert all(counts[k] > 0 for k in SOLVER_FUSED + ("ipm_freeze",)), counts
    # the monolithic solve's graph (init, the loop, finalize) and one loop
    # graph a bucket: a graph holds its program, so they are not shared
    assert loop.stats["captures"] == 1 + len(sizes)
    assert stats["lane_iters"] == int(mono.iters.sum())
    assert stats["dispatched_lane_iters"] <= 64 * int(mono.iters.max()) + 64 * 2


def test_compacted_capped_batch_ends(dev):
    """Most lanes stop at the solver's own cap without being done:
    solve_compacted ends, with the monolithic result."""
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        solve_compacted,
    )
    spec, data, opt = _compact_batch(dev, torch.float64)
    solve = make_obca_solver(spec, dataclasses.replace(opt, max_iters=6))
    mono = solve(data)
    assert int((mono.iters == 6).sum()) >= 48
    comp, stats = solve_compacted(solve, data, chunk=2, min_bucket=4, shrink=4)
    _assert_results_equal(comp, mono)
    assert stats["calls"] <= 3


def _flat_tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _flat_tensors(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _flat_tensors(v)]
    return []


def _record_body_stages(monkeypatch, records):
    """Wrap the Newton body's kernel stages so that each call's flattened
    inputs and outputs land in ``records`` as (stage, inputs, outputs)."""
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import solver
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        ipm,
    )

    def wrap(name, fn):
        def w(*a, **k):
            out = fn(*a, **k)
            records.append((name, _flat_tensors(a) + _flat_tensors(k), _flat_tensors(out)))
            return out
        return w

    monkeypatch.setattr(ipm, "spd_inv", wrap("spd_inv", ipm.spd_inv))
    for name in ("newton_assemble", "newton_schur", "newton_al_solve"):
        monkeypatch.setattr(ipm._newton, name, wrap(name, getattr(ipm._newton, name)))
    monkeypatch.setattr(ipm._ls, "step_linesearch",
                        wrap("step_linesearch", ipm._ls.step_linesearch))
    make_provider = solver._struct.make_provider

    def provider(spec, ds):
        lay, prov = make_provider(spec, ds)
        return lay, wrap("obca_kkt_provider", prov)
    monkeypatch.setattr(solver._struct, "make_provider", provider)


@pytest.mark.parametrize("lanes", [1, 4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_body_step_bits_do_not_depend_on_the_batch(dev, monkeypatch, dtype, lanes):
    """One Newton iteration of the free batch (demo9, N = 10, 256 lanes,
    after 3 iterations) against the same step on ``lanes`` of its lanes
    gathered into a smaller batch, as a compacted solve's buckets run them:
    at every stage of the body (the provider, the SPD inverses, the
    assembly, the Schur step, the AL solve, the line search, on its spread
    route up to 33 lanes and its group route above) the subset's inputs
    and outputs equal the whole call's on those lanes bit for bit, and so
    does the next state."""
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        BENCH_FREE_OPTIONS, demo9_window_batch,
    )
    records = []
    _record_body_stages(monkeypatch, records)
    B, opt = 256, BENCH_FREE_OPTIONS
    spec, data, _, _ = demo9_window_batch(B, dtype=dtype, device=dev)
    solve = make_obca_solver(spec, opt)
    width = kernels.pack_obca_data(data).shape[1]
    route = kernels.ls_route(solve.layout.lay, width, lanes, opt.n_backtracks, dtype).route
    assert route == ("spread" if lanes * opt.n_backtracks <= kernels.LS_SPREAD_CTAS else "group")
    st = solve.iterate(solve.init(data), data, 3)
    records.clear()
    whole = solve.step(st, data)
    full = list(records)
    idx = torch.arange(lanes, device=dev) * (B // lanes) + (B // lanes) // 2
    records.clear()
    part = solve.step(type(st)(*[t[idx] for t in st]), type(data)(*[t[idx] for t in data]))
    torch.cuda.synchronize()
    assert [r[0] for r in records] == [r[0] for r in full]
    for (name, fin, fout), (_, pin, pout) in zip(full, records):
        for k, (a, b) in enumerate(zip(fin + fout, pin + pout)):
            if a.dim() and a.shape[0] == B:
                where = "input" if k < len(fin) else "output"
                assert torch.equal(_bits(a[idx]), _bits(b)), f"{name} {where} {k}"
    for name, a, b in zip(st._fields, whole, part):
        assert torch.equal(_bits(a[idx]), _bits(b)), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kkt_qr_dense_matches_plain_and_assembled(dev, dtype):
    """kkt_qr_dense on a sweep rescue rung's 32 saddle matrices (order 294,
    qr.saddle_matrix of the rung's pieces): the rung flags equal the plain
    version's, float64 within 1e-9 (float32 by the saddle residual), the
    solution equal to kkt_qr's assembled route (chip_smoke.check_qr_dense)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs

    x = _fix_stage(dev, "fix_free_end", dtype, rows=(0, 30, 60, 90))
    sl = lambda t: t[:16].contiguous()
    bnd = type(x["bnd"])(*[sl(t) for t in x["bnd"]])
    W = [sl(t).contiguous() for t in newton_assemble_plain(
        x["ops"], bnd, sl(x["sigma"]), sl(x["sgn_eff"]), sl(x["ladder"]),
        x["opt"].delta_d_al, w_only=True)]
    args = (x["ops"], bnd, *W, sl(x["rhs1"]), sl(x["rhs2"]), sl(x["ladder"]), x["opt"].delta_d)
    asol, agood = kernels.kkt_qr(*args)
    K = qr.saddle_matrix(*args[:5], args[7], args[8])[0].contiguous()
    rhs = torch.cat([args[5], args[6]], 1)
    n0 = kernels.launches["kkt_qr_dense"]
    row = cs.check_qr_dense(K, rhs, x["L"].n, "test", False, assembled=(asol, agood))
    assert kernels.launches["kkt_qr_dense"] == n0 + 1
    assert row["good"] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ad_arrow_graphed_loop_matches_host_loop(dev, dtype):
    """The AD solver's structured arrow family (HVP probes, spd_inv) through
    the captured loop: bit-equal to the host loop with the kernels, every
    state field, spd_inv launched by both and ipm_freeze by the graph."""
    spec, data = _three_lanes(dev)
    data = type(data)(*[f.to(dtype) if f.is_floating_point() else f for f in data])
    opt = dataclasses.replace(ENTRY_OPTIONS, kkt="arrow")
    out = {}
    for mode in ("host", "graph"):
        solve = make_obca_solver(spec, opt, loop=mode)
        kernels.reset_launch_counts()
        loop.reset_stats()
        st = _solve_chunks(solve, data, (1, 4, 100))
        torch.cuda.synchronize()
        out[mode] = (st, dict(kernels.launches), dict(loop.stats), dict(loop.warmup_launches))
    (sh, ch, _, _), (sg, cg, stats, warm) = out["host"], out["graph"]
    for name, a, b in zip(sh._fields, sh, sg):
        assert torch.equal(a, b), name
    assert cg["ipm_freeze"] > 0 and ch["ipm_freeze"] == 0
    # (the eager run before the capture launches one iteration's worth more)
    assert cg["spd_inv"] - warm.get("spd_inv", 0) == ch["spd_inv"] > 0
    assert stats["captures"] == 1 and stats["replays"] > 0


@pytest.mark.parametrize("kkt,coloring", [("al_chol", True), ("chol", True), ("arrow", False)])
def test_ad_dense_families_graphed_loop_match_host_loop(dev, kkt, coloring):
    """The AD solver's dense families (al_chol, chol, and arrow gathered
    from a dense Hessian), whose Cholesky solves are triangular solves,
    through the captured loop in float64: bit-equal to the host loop with
    the kernels, every state field, one capture."""
    spec, data = _three_lanes(dev)
    opt = dataclasses.replace(ENTRY_OPTIONS, kkt=kkt, hessian_coloring=coloring, max_iters=25)
    out = {}
    for mode in ("host", "graph"):
        solve = make_obca_solver(spec, opt, loop=mode)
        kernels.reset_launch_counts()
        loop.reset_stats()
        st = _solve_chunks(solve, data, (1, 4, 100))
        torch.cuda.synchronize()
        out[mode] = (st, dict(kernels.launches), dict(loop.stats))
    (sh, ch, _), (sg, cg, stats) = out["host"], out["graph"]
    for name, a, b in zip(sh._fields, sh, sg):
        assert torch.equal(a, b), name
    assert cg["ipm_freeze"] > 0 and ch["ipm_freeze"] == 0
    assert stats["captures"] == 1 and stats["replays"] > 0


def test_ad_graph_loop_keys_on_static_params(dev):
    """A Python scalar in ``params`` is baked into a captured graph: the
    tiny NLP solved for target x = 2 and then x = 3 through the graph loop
    captures twice and gives each value its own answer, bit-equal to the
    host loop's."""
    z0 = {"x": np.zeros(()), "y": np.zeros(())}
    fns = (lambda z, p: (z["x"] - p["x"]) ** 2 + (z["y"] - 1.0) ** 2,
           lambda z, p: torch.stack([z["x"] + z["y"] - p["x"]]),
           lambda z, p: torch.stack([z["x"] - 0.5, z["y"] - z["x"] ** 2 + 1.0]))
    graph, host = build_solver(*fns, z0), build_solver(*fns, z0, loop="host")
    zb = {k: torch.zeros(1, dtype=torch.float64, device=dev) for k in z0}
    loop.reset_stats()
    xs = []
    for x in (2.0, 3.0):
        rg, rh = graph(zb, {"x": x}), host(zb, {"x": x})
        assert graph.loop_of(zb["x"]) == "graph"
        assert bool(rg.converged[0]) and torch.equal(rg.iters, rh.iters)
        for k in z0:
            assert torch.equal(rg.z[k], rh.z[k]), k
        xs.append(rg.z["x"].item())
    assert abs(xs[1] - xs[0]) > 0.1
    assert loop.stats["captures"] == 2


# ------------------------------------------------------------ device loop

def _tree_bits_equal(a, b, what):
    la, lb = torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, i)
        assert torch.equal(_bits(x), _bits(y)), (what, i)


def _device_loop_case(case, dtype, dev, loop_mode):
    """One solve of ``case`` through ``loop_mode`` ("host" or None: the
    device loop), its whole output."""
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        BENCH_FREE_OPTIONS, demo9_window_batch, make_openloop_solve)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        IPMOptions, build_obca_ad_solver)

    if case == "free":
        spec, data, _, _ = demo9_window_batch(16, dtype=dtype, device=dev)
        return make_obca_solver(spec, BENCH_FREE_OPTIONS, loop=loop_mode)(data)
    if case in ("fix", "qr"):
        spec6, spec8, data, cands = fix_fixture_batch(dtype=dtype, device=dev, rows=[0, 1, 30])
        if case == "fix":
            return make_fix_step(spec6, spec8, loop=loop_mode)(data, cands)
        opt = dataclasses.replace(FIX8_OPTIONS, kkt="qr")
        ms = make_multistart_solver(spec8, make_obca_solver(spec8, opt, loop=loop_mode),
                                    init_vars, 5)
        return ms(data, cands, skip=torch.tensor([False, True, False], device=dev))
    if case == "n74":
        spec, data, cands, opt = openloop_n74_inputs(dtype, dev)
        return make_openloop_solve(spec, opt, loop=loop_mode)(data, cands)
    spec, data = _three_lanes(dev)
    data = type(data)(*[f.to(dtype) if f.is_floating_point() else f for f in data])
    if case == "ad_qr":
        solve = build_obca_ad_solver(spec, IPMOptions(kkt="qr", max_iters=40), loop=loop_mode)
        return solve(init_vars(spec, data), data)
    kkt = case[3:]
    return make_obca_solver(spec, IPMOptions(kkt=kkt, max_iters=40), loop=loop_mode)(data)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["free", "fix", "qr", "n74", "ad_arrow", "ad_al_chol",
                                  "ad_chol", "ad_qr"])
def test_device_loop_bits_match_host_loop(dev, case, dtype):
    """Each solve as one graph launch (its init, the Newton loop under the
    WHILE node, finalize, the multistart's pick) against loop="host", bit
    for bit; one graph launch a solve, and its kernels launched inside."""
    kernels.reset_launch_counts()
    loop.reset_stats()
    got = _device_loop_case(case, dtype, dev, None)
    torch.cuda.synchronize()
    stats, counts = dict(loop.stats), dict(kernels.launches)
    want = _device_loop_case(case, dtype, dev, "host")
    _tree_bits_equal(got, want, case)
    assert stats["launches"] == counts["device_loop"] > 0 and stats["replays"] > 0
    assert counts["ipm_freeze"] >= stats["replays"]


def test_device_loop_has_no_host_sync_and_reuses_its_graph(dev):
    """Between a graphed multistart's launch and the read of its iteration
    count no host synchronisation happens (set_sync_debug_mode("error")
    raises on one); the graph built at the first call serves calls with
    new data, which equal the host loop's."""
    spec6, spec8, data, cands = fix_fixture_batch(dtype=torch.float64, device=dev,
                                                  rows=[0, 23, 48])
    ms = make_multistart_solver(spec6, make_obca_solver(spec6, FIX6_OPTIONS), init_vars, 5)
    host = make_multistart_solver(spec6, make_obca_solver(spec6, FIX6_OPTIONS, loop="host"),
                                  init_vars, 5)
    ms(data, cands)
    torch.cuda.synchronize()
    launch, read = kernels.device_loop_launch, loop._iterations
    armed = []

    def launch_then_arm(*a):
        launch(*a)
        torch.cuda.set_sync_debug_mode("error")
        armed.append(True)

    def disarm_then_read(p):
        torch.cuda.set_sync_debug_mode("default")
        return read(p)

    loop.reset_stats()
    try:
        kernels.device_loop_launch = launch_then_arm
        loop._iterations = disarm_then_read
        for shift in (0.05, -0.05):
            other = data._replace(x0=data.x0 + shift)
            got = ms(other, cands)
            _tree_bits_equal(got, host(other, cands), f"shift {shift}")
    finally:
        kernels.device_loop_launch, loop._iterations = launch, read
        torch.cuda.set_sync_debug_mode("default")
    assert armed == [True, True]
    assert loop.stats["captures"] == 0 and loop.stats["launches"] == 2


def test_coupled_free_solve_reproduces_run_to_run(dev):
    """The coupled-motion free batch (S = 4: every step's T slot is spine
    position 0) solved twice on the graphed loop and the plain host loop:
    the same bits each time (the slot and clique sums take a fixed order,
    solver/fused.py sum_plan)."""
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        coupled_fixture_batch)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime.scan_loop import (
        SCAN_OPTIONS)

    spec, data, cands = coupled_fixture_batch(B=8, dtype=torch.float64, device=dev)
    for impl, mode in ((None, None), ("plain", "host")):
        runs = []
        for _ in range(2):
            ms = make_multistart_solver(
                spec, make_obca_solver(spec, SCAN_OPTIONS, impl=impl, loop=mode),
                init_vars, cands.shape[1])
            runs.append(ms(data, cands))
            torch.cuda.synchronize()
        _tree_bits_equal(runs[0], runs[1], f"coupled {impl}")
