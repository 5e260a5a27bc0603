"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: these tests need an NVIDIA GPU with ``nvcc`` and skip
elsewhere (the check is made inside the fixture, never at import). Run on
the card with ``python -m pytest --noconftest tests/test_torch_cuda.py -q``
(``tests/conftest.py`` imports jax, which that machine lacks). Small
problems (demo1, N = 6, three lanes; three rows of the fix-time fixture x
5 candidates; a 2-step demo1 rollout) in float64, tolerance 1e-9
(max-normalised); the wavefront A* on 64 random maps, bit for bit;
``chip_smoke.py`` checks the full-size shapes.
"""

import numpy as np
import pytest
import torch

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
    ENTRY_OPTIONS, FIX6_OPTIONS, FIX8_OPTIONS, demo1_problem, demo_rollout_inputs,
    fix_fixture_batch, make_fix_step,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
    build_obca_data, init_vars, obca,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.ops import astar
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime import (
    make_scan_rollout,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
    random_scenarios,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
    make_obca_solver, qr,
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


def test_spd_inv_matches_plain_and_flags_non_spd(dev):
    rng = np.random.RandomState(0)
    for m in (8, 34):
        M = torch.as_tensor(rng.randn(6, m, m), device=dev)
        A = M @ M.transpose(1, 2) + torch.eye(m, device=dev, dtype=torch.float64)
        A[2, 1, 1] = -5.0
        Xk, Xp = kernels.spd_inv(A), _spd_inv(A)
        bad_k = ~torch.isfinite(Xk).flatten(1).all(1)
        bad_p = ~torch.isfinite(Xp).flatten(1).all(1)
        assert bad_k.tolist() == bad_p.tolist() and bad_k[2]
        assert _rel(Xk[~bad_k], Xp[~bad_p]) <= 1e-9


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


def test_provider_matches_plain(dev):
    spec, data = _three_lanes(dev)
    solve = make_obca_solver(spec, ENTRY_OPTIONS)
    st = make_obca_solver(spec, ENTRY_OPTIONS, impl="plain").init(data)
    L = solve.layout
    w_d = st.w[:, L.m_id:].contiguous()
    y = torch.randn(st.y.shape, dtype=torch.float64, device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    kb = solve.provider(st.zv, data, st.sf, st.scE, st.scD, y, w_d)
    pb = solve.provider.plain(st.zv, data, st.sf, st.scE, st.scD, y, w_d)
    for f in kb._fields:
        assert _rel(getattr(kb, f), getattr(pb, f)) <= 1e-9, f


def _fix_stage(dev, variant):
    """Every fix-time kernel's inputs after 3 plain iterations: fixture
    rows 0, 30 and 60 x 5 candidates, float64, R = 2."""
    spec6, spec8, data, cands = fix_fixture_batch(dtype=torch.float64, device=dev,
                                                  rows=[0, 30, 60])
    spec, opt = (spec6, FIX6_OPTIONS) if variant == "fix_terminal" else (spec8, FIX8_OPTIONS)
    data = type(data)(*[f.repeat_interleave(5, dim=0) for f in data])
    z0 = init_vars(spec, data, x_init=cands.reshape(-1, 3, spec.N + 1))
    solve = make_obca_solver(spec, opt, impl="plain")
    st = solve.iterate(solve.init(data, z0), data, 3)
    L = solve.layout
    ops = L.ops(dev, torch.float64)
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
              * torch.tensor([1.0, opt.delta_step], dtype=torch.float64, device=dev))
    return dict(spec=spec, opt=opt, data=data, solve=solve, st=st, L=L, ops=ops,
                sgn_eff=sgn_eff, id_off=id_off, w_d=w_d, bnd=bnd, cI=cI,
                sigma=st.w / st.s, rhs1=rhs1, rhs2=rhs2, ladder=ladder.contiguous())


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_astar_kernels_match_plain(dev, dtype):
    scn, _ = random_scenarios(3, 64, dtype=dtype, device=dev)
    cell = lambda pose: pose[:, [1, 0]].to(torch.int32)
    goal, start = cell(scn.goal), cell(scn.start)
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
