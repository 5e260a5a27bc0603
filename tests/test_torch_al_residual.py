"""Where the large AL-solve saddle residuals of ``chip_smoke.py`` phase 3
come from (CPU, float64).

Phase 3 holds the float32 ``newton_al_solve`` to 3x the larger of the plain
version's residual and "the same algorithm run in float64 on the same
inputs": the float32 stage's pieces (the provider's bundle, W, G and the
inverses Qinv, Sinv formed in float32) upcast to float64, on the rungs
the float32 solve accepts. That reference's residual ||K sol - rhs|| /
||rhs|| reaches 1.1e3 on fixture row 50 (candidate 2, rung 1) here
(``fix_free_end``, after 3 float32 iterations on the CPU). On rows 26
(candidate 1) and 53 (candidate 2, rung 1) the float32 spine inverse
Sinv is NaN (``spd_inv``'s failed-factorisation signal), so the float32
solve, and the reference built from its pieces, are NaN there and the
rung is rejected; phase 3 does not hold a rejected rung.

This file takes those lanes' float32 state, upcasts it, and runs one
Newton iteration of the port's body and of the JAX package's fused body
(``solver/ipm.py:937-980``) from it, capturing each body's AL solutions
(the JAX package's ``sol`` through an ordered ``jax.debug.callback`` on its
module's ``jnp.concatenate``, the port's by wrapping ``newton_al_solve``).
Both agree within 1e-12 and their residuals are ~1e-10: the fused solve is
accurate when its pieces are formed in one precision, in both packages.
The large residual belongs to the reference's mix of float32 pieces and
float64 arithmetic (G and its inverses disagree with W and J at the
float32 rounding level, and the AL split divides by dd = 1e-3), not to
the port. ``PYTHONPATH=. python tests/test_torch_al_residual.py`` prints the
numbers.
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.solver.ipm as jipm
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.solver import (
    make_obca_solver as jmake_solver,
)
import vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.ipm as tipm
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
    FIX8_OPTIONS, fix_fixture_batch,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
    init_vars,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
    make_obca_solver,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.newton import (
    newton_al_solve_plain,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_fixstep import _jax_rows, _jopt  # noqa: E402

ROWS = [26, 50, 53]
LANES = [1, 7, 12]      # row 26 candidate 1, row 50 candidate 2, row 53 candidate 2


def _residual(ops, bnd, W, rhs1, rhs2, sol, delta, delta_d):
    """(B,) ||K sol - rhs||_inf / ||rhs||_inf of the delta_d-regularized
    saddle system [[W + delta I, JE^T], [JE, -delta_d I]], evaluated in
    float64 (chip_smoke.py's ``_saddle_residual``)."""
    d = torch.float64
    ops = ops.L.ops(rhs1.device, d)
    bnd = type(bnd)(*[t.to(d) for t in bnd])
    Wpp, Wpq, Wqq = (t.to(d) for t in W)
    rhs1, rhs2, sol, delta = rhs1.to(d), rhs2.to(d), sol.to(d), delta.to(d)
    n = ops.L.n
    dp, dq = ops.split(sol[:, :n])
    v = sol[:, n:]
    op = (torch.einsum("bpc,bc->bp", Wpp, dp)
          + ops.slot_add(ops.red(torch.einsum("bksc,bkc->bks", Wpq, dq))))
    oq = (torch.einsum("bksc,bsk->bkc", Wpq, ops.slots_of(dp))
          + torch.einsum("bkcd,bkd->bkc", Wqq, dq))
    vp, vq = ops.f_jeT(bnd, v)
    r1 = ops.f_flat(op + delta[:, None] * dp + vp,
                    oq + delta[:, None, None] * dq + vq) - rhs1
    r2 = ops.f_jev(bnd, dp, dq) - delta_d * v - rhs2
    res = torch.maximum(r1.abs().amax(1), r2.abs().amax(1))
    return res / torch.maximum(rhs1.abs().amax(1), rhs2.abs().amax(1))


def _capture_port(solve, st, data):
    """One port body iteration; the arguments and result of its AL solve."""
    orig = tipm._newton.newton_al_solve
    got = {}

    def wrap(ops, bnd, Wpp, Wpq, Wqq, Gpq0, Qinv, Yq, Sinv, rhs1, rhs2, ladder, *a, **kw):
        out = orig(ops, bnd, Wpp, Wpq, Wqq, Gpq0, Qinv, Yq, Sinv, rhs1, rhs2, ladder, *a, **kw)
        got.update(ops=ops, bnd=bnd, W=(Wpp, Wpq, Wqq), Gpq0=Gpq0, Qinv=Qinv, Yq=Yq,
                   Sinv=Sinv, rhs1=rhs1, rhs2=rhs2, ladder=ladder, sols=out[0],
                   goods=out[1])
        return out

    tipm._newton.newton_al_solve = wrap
    try:
        new = solve.step(st, data)
    finally:
        tipm._newton.newton_al_solve = orig
    return new, got


class _JnpRecorder:
    """The JAX solver module's ``jnp`` with ``concatenate`` recording every
    1-D result of length ``n`` (the fused solve's [dz, v])."""

    def __init__(self, n):
        self.n, self.seen = n, []

    def __getattr__(self, k):
        return getattr(jnp, k)

    def concatenate(self, arrs, *a, **kw):
        out = jnp.concatenate(arrs, *a, **kw)
        if len(arrs) == 2 and out.ndim == 1 and out.shape[0] == self.n:
            jax.debug.callback(lambda v: self.seen.append(np.asarray(v)), out, ordered=True)
        return out


def measure():
    spec6, spec8, d32, c32 = fix_fixture_batch(dtype=torch.float32, device="cpu", rows=ROWS)
    d32 = type(d32)(*[f.repeat_interleave(5, dim=0) for f in d32])
    s32 = make_obca_solver(spec8, FIX8_OPTIONS)
    st32 = s32.iterate(s32.init(d32, init_vars(spec8, d32, x_init=c32.reshape(
        (-1,) + c32.shape[2:]))), d32, 3)
    _, got32 = _capture_port(s32, st32, d32)
    # phase 3's float64 reference: the float64 algorithm on the float32 pieces
    up = lambda t: t.double()
    ex = newton_al_solve_plain(
        got32["ops"].L.ops("cpu", torch.float64), type(got32["bnd"])(*map(up, got32["bnd"])),
        *map(up, got32["W"]), up(got32["Gpq0"]), up(got32["Qinv"]), up(got32["Yq"]),
        up(got32["Sinv"]), up(got32["rhs1"]), up(got32["rhs2"]), up(got32["ladder"]),
        FIX8_OPTIONS.delta_d_al, FIX8_OPTIONS.delta_d, FIX8_OPTIONS.n_refine)[0]

    _, _, d64, _ = fix_fixture_batch(dtype=torch.float64, device="cpu", rows=ROWS)
    d64 = type(d64)(*[f.repeat_interleave(5, dim=0) for f in d64])
    s64 = make_obca_solver(spec8, FIX8_OPTIONS)
    st64 = type(st32)(*[f.double() if f.is_floating_point() else f for f in st32])
    pnew, got = _capture_port(s64, st64, d64)

    jspec6, jspec8, jdata, _, _, _ = _jax_rows(ROWS)
    rec = _JnpRecorder(s64.layout.n + s64.layout.mE)
    saved = jipm.jnp
    jipm.jnp = rec
    try:
        jsolve = jmake_solver(jspec8, _jopt(FIX8_OPTIONS))
        it = jax.jit(jsolve.iterate)
        rows = []
        for lane in LANES:
            params = jax.tree.map(lambda a: a[lane // 5], jdata)
            jst = jipm.IPMState(*[jnp.asarray(f[lane].numpy()) for f in st64])
            rec.seen.clear()
            jnew = jax.block_until_ready(it(jst, params, int(st64.it[lane]) + 1))
            for j in range(FIX8_OPTIONS.n_deltas):
                sl = slice(lane, lane + 1)
                args = (got["ops"], type(got["bnd"])(*[t[sl] for t in got["bnd"]]),
                        tuple(t[sl] for t in got["W"]), got["rhs1"][sl], got["rhs2"][sl])
                delta = got["ladder"][sl, j]
                jsol = torch.as_tensor(np.array(rec.seen[j]))[None]
                psol = got["sols"][sl, j]
                args32 = (got32["ops"], type(got32["bnd"])(*[t[sl] for t in got32["bnd"]]),
                          tuple(t[sl] for t in got32["W"]), got32["rhs1"][sl],
                          got32["rhs2"][sl])
                rows.append({
                    "lane": lane, "row": ROWS[lane // 5], "rung": j,
                    "jax_residual": _residual(*args, jsol, delta, FIX8_OPTIONS.delta_d).item(),
                    "port_residual": _residual(*args, psol, delta, FIX8_OPTIONS.delta_d).item(),
                    "sol_rel_diff": ((jsol - psol).abs().max() / psol.abs().max()).item(),
                    "next_zv_rel_diff": ((torch.as_tensor(np.array(jnew.zv)) - pnew.zv[lane])
                                         .abs().max() / pnew.zv[lane].abs().max()).item(),
                    "float32_accepted": bool(got32["goods"][lane, j]),
                    "float32_pieces_residual": _residual(
                        *args32, ex[sl, j], got32["ladder"][sl, j],
                        FIX8_OPTIONS.delta_d).item(),
                })
    finally:
        jipm.jnp = saved
    return rows


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fused_solve_residual_matches_jax_package():
    rows = measure()
    assert len(rows) == len(LANES) * FIX8_OPTIONS.n_deltas
    for r in rows:
        assert r["sol_rel_diff"] <= 1e-12, r
        assert r["next_zv_rel_diff"] <= 1e-12, r
        assert r["port_residual"] <= 1e-8 and r["jax_residual"] <= 1e-8, r
        assert abs(r["jax_residual"] - r["port_residual"]) <= 1e-3 * r["port_residual"], r
    # the reference of phase 3 (float64 arithmetic on float32 pieces), on
    # the rungs the float32 solve accepts, is where the large numbers live
    ref = [r["float32_pieces_residual"] for r in rows if r["float32_accepted"]]
    assert all(math.isfinite(v) for v in ref), ref
    assert max(ref) > 1e3, ref


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    for r in measure():
        print(r)
