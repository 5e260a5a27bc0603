"""The port's AD solver families held to each other on the CPU at float64
(the JAX package's tests/test_solver.py:140-260, port only).

demo1's window (N = 6, free time; its data serves fix_terminal and
fix_free_end too, and coupled motion with every obstacle moving at 0.05),
default options (the window is not feasible in the fix variants and with
coupled motion: there the solves stop at 30 iterations and the iterates
are compared):

* Hessian coloring on/off and spine coloring on/off (the structured arrow
  path with per-column or grouped spine probes, and the dense Hessian
  gathered into arrow form): same iterations, z within 1e-9, for free,
  fix_terminal and coupled motion;
* arrow against al_chol (the same KKT systems, factored by blocks or
  densely): same iterations, z within 1e-6;
* fused (the analytic provider) against arrow: |diterations| <= 1, z
  within 1e-6, in free, fix_terminal and fix_free_end;
* the dense QR solve's plain version (solver/qr.py kkt_qr_dense_plain)
  against kkt_qr_plain on one saddle matrix: within 1e-10;
* the Cholesky NaN rule: a matrix that is not SPD gives a NaN factor
  (cholesky_ex's info, never read on the host) and NaN solutions, while
  the other rung stays finite; in the al_chol solver a first rung planted
  non-SPD is rejected and the step takes the second.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
    demo1_problem,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
    IPMOptions, make_obca_solver, qr,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
    ad,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

F64 = torch.float64


@functools.lru_cache(maxsize=None)
def _problem(variant):
    spec, data, _, _ = demo1_problem(F64, "cpu")
    if variant == "coupled":
        spec = dataclasses.replace(spec, coupled_motion=True)
        data = data._replace(obs_vel=torch.full_like(data.obs_vel, 0.05))
    elif variant != "free":
        spec = dataclasses.replace(spec, variant=variant)
    return spec, data


@functools.lru_cache(maxsize=None)
def _solve(variant, kkt, hessian_coloring=True, spine_coloring=True):
    spec, data = _problem(variant)
    opt = IPMOptions(kkt=kkt, hessian_coloring=hessian_coloring, spine_coloring=spine_coloring,
                     max_iters=100 if variant == "free" else 30)
    solve = make_obca_solver(spec, opt)
    return solve.family, solve(data)


def _zgap(a, b):
    return max((a.z[k] - b.z[k]).abs().max().item() for k in a.z)


@pytest.mark.parametrize("variant", ["free", "fix_terminal", "coupled"])
@pytest.mark.parametrize("coloring", ["per_column", "dense"])
def test_coloring_matches_grouped_probes(variant, coloring):
    fam_g, rg = _solve(variant, "arrow")
    kw = (dict(spine_coloring=False) if coloring == "per_column"
          else dict(hessian_coloring=False))
    fam_c, rc = _solve(variant, "arrow", **kw)
    assert fam_g == "arrow" and fam_c == ("arrow" if coloring == "per_column" else "arrow_dense")
    assert torch.equal(rg.iters, rc.iters)
    assert _zgap(rg, rc) <= 1e-9
    assert abs(rg.kkt_err.item() - rc.kkt_err.item()) <= 1e-6 * abs(rc.kkt_err.item()) + 1e-12


def test_arrow_matches_al_chol():
    _, ra = _solve("free", "arrow")
    fam, rd = _solve("free", "al_chol")
    assert fam == "al_chol" and bool(ra.feas[0]) and bool(rd.feas[0])
    assert torch.equal(ra.iters, rd.iters)
    assert _zgap(ra, rd) <= 1e-6


@pytest.mark.parametrize("variant", ["free", "fix_terminal", "fix_free_end"])
def test_fused_matches_arrow(variant):
    _, ra = _solve(variant, "arrow")
    _, rf = _solve(variant, "fused")
    assert bool(rf.feas[0]) == bool(ra.feas[0])
    assert abs(int(rf.iters[0]) - int(ra.iters[0])) <= 1
    assert (rf.z["x"] - ra.z["x"]).abs().max().item() <= 1e-6


def _saddle_case(seed=3, n=12, mE=4, R=2):
    rng = np.random.RandomState(seed)
    t = lambda *s: torch.as_tensor(rng.randn(*s), dtype=F64)
    W = t(1, n, n)
    W = W + W.transpose(1, 2) + 30.0 * torch.eye(n, dtype=F64)
    JE = t(1, mE, n)
    ladder = torch.tensor([[1e-8, 1e-6]], dtype=F64)
    eye_m = torch.eye(mE, dtype=F64)
    K = torch.cat([torch.cat([W[:, None] + ladder[..., None, None] * torch.eye(n, dtype=F64),
                              JE.transpose(1, 2)[:, None].expand(1, R, n, mE)], -1),
                   torch.cat([JE[:, None].expand(1, R, mE, n),
                              (-1e-8 * eye_m).expand(1, R, mE, mE)], -1)], -2)
    return K.contiguous(), n


def test_dense_qr_plain_matches_kkt_qr_plain_on_one_saddle_matrix():
    """The dense entry's plain version against the assembled route's on the
    saddle matrix of demo1's third iterate (the fused solver's pieces)."""
    spec, data = _problem("free")
    solve = make_obca_solver(spec, IPMOptions(kkt="qr"))
    st = solve.iterate(solve.init(data), data, 3)
    L = solve.layout
    ops = L.ops("cpu", F64)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        newton)

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import obca
    sgn, _ = obca.ineq_identity_sgn_off(spec, data)
    sgn_eff = sgn * ops.ds[ops.id_idx]
    bnd = solve.provider(st.zv, data, st.sf, st.scE, st.scD, st.y, st.w[:, L.m_id:].contiguous())
    sigma = st.w / st.s
    ladder = st.delta[:, None] * torch.tensor([1.0, 100.0], dtype=F64)
    W = newton.newton_assemble(ops, bnd, sigma, sgn_eff, ladder, 1e-3, w_only=True)
    rhs1 = torch.randn(1, L.n, dtype=F64, generator=torch.Generator().manual_seed(0))
    rhs2 = torch.randn(1, L.mE, dtype=F64, generator=torch.Generator().manual_seed(1))
    ps, pg = qr.kkt_qr_plain(ops, bnd, *W, rhs1, rhs2, ladder, 1e-8)
    K, _ = qr.saddle_matrix(ops, bnd, *W, ladder, 1e-8)
    ds, dg = qr.kkt_qr_dense_plain(K, torch.cat([rhs1, rhs2], 1), L.n)
    assert torch.equal(pg, dg)
    scale = ps.abs().max().item()
    assert (ds - ps).abs().max().item() <= 1e-10 * scale
    # the dispatcher takes the plain version on a CPU tensor
    assert torch.equal(qr.kkt_qr_dense(K, torch.cat([rhs1, rhs2], 1), L.n)[0], ds)


def test_cholesky_nan_rule_rejects_a_planted_rung(monkeypatch):
    K, n = _saddle_case()
    A = K[:, :, :n, :n].clone()
    A[0, 1, 2, 2] = -50.0                      # rung 1 is not SPD
    L = ad._chol(A)
    assert torch.isfinite(L[0, 0]).all() and torch.isnan(L[0, 1]).all()
    x = ad._cho_solve(L, torch.ones(1, 2, n, dtype=F64))
    assert torch.isfinite(x[0, 0]).all() and torch.isnan(x[0, 1]).all()
    # in the solver: al_chol's first rung made non-SPD is rejected, the step
    # takes the second rung (delta = 100 delta0, remembered as delta / 30)
    spec, data = _problem("free")
    solve = make_obca_solver(spec, IPMOptions(kkt="al_chol"))
    st0 = solve.init(data)
    clean = solve.step(st0, data)
    assert clean.delta.item() == IPMOptions().delta0
    real = ad._chol

    def planted(A):
        A = A.clone()
        A[:, 0, 3, 3] = -1e6
        return real(A)

    monkeypatch.setattr(ad, "_chol", planted)
    st = solve.step(st0, data)
    assert st.delta.item() == pytest.approx(100 * IPMOptions().delta0 / 30, rel=1e-12)
    assert torch.isfinite(st.zv).all() and not torch.equal(st.zv, st0.zv)
