"""CPU parity of the port's QR rescue solve (``kkt="qr"``) against the JAX
package at float64, on row 0 of goldens/bench_fix_fixture.npz (a real
demo1 fix-time replan) for both fix-time variants, and of the plain QR
saddle solve against a dense ``numpy.linalg.solve``.

The JAX package's ``qr`` body takes its derivatives by AD and solves the
dense saddle system; the port's takes them from the analytic provider
(the same matrices up to rounding) and scatters its arrow pieces into
that dense system. Tolerances: 1e-9 on the iteration state after 1 and 3
iterations, 1e-6 on the solution z with equal iteration counts, 1e-9 on
the saddle solve (one refinement pass against a well-conditioned
system).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.models import (
    OBCASpec as JSpec,
    build_obca_data as jbuild_data,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.scenarios import (
    build_scenario as jbuild_scenario,
    get_demo as jget_demo,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.solver import (
    IPMOptions as JOptions,
    make_obca_solver as jmake_solver,
)

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
    FIX_FIXTURE, fix_fixture_batch,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.interop import (
    from_numpy, to_numpy,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
    IPMOptions, make_obca_solver,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
    qr as tqr,
)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these batches are small, and the suite runs
    several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JOPT = JOptions(max_iters=100, acceptable_tol=5e-3, feas_tol=1e-4, kkt="qr")
OPT = IPMOptions(max_iters=100, acceptable_tol=5e-3, feas_tol=1e-4, kkt="qr")
VARIANTS = ["fix_terminal", "fix_free_end"]


def _jax_row0(variant):
    """Fixture row 0 as bench.py's fix stage builds it (one problem)."""
    fx = np.load(FIX_FIXTURE)
    name = str(fx["demo"][0])
    scn, shape = jbuild_scenario(jget_demo(name), dtype=jnp.float64)
    spec = JSpec(N=fx["xref"].shape[-1] - 1, n_obs=shape.n_obs,
                 e_max=shape.e_max, variant=variant)
    p = jget_demo(name).params
    data = jbuild_data(
        spec, scn, x0=jnp.asarray(fx["x0"][0]), u0=jnp.asarray(fx["u0"][0]),
        xref=jnp.asarray(fx["xref"][0]), Ts=float(fx["Ts"][0]),
        dyn_active=jnp.asarray(fx["sensed"][0]),
        dyn_delta=jnp.asarray(fx["dyn_delta"][0]), Ts_pred=float(fx["Ts"][0]),
        terminal_set=jnp.asarray(fx["terminal_set"][0]), q=p.q_fix,
        r1=p.r1_fix, r2=p.r2_fix, v_max=p.v_max, w_max=p.w_max, a_max=p.a_max,
        alpha_max=p.alpha_max, ego=p.ego, dmin=p.dmin)
    return spec, data


@pytest.fixture(scope="module", params=VARIANTS)
def qr_pair(request):
    variant = request.param
    jspec, jdata = _jax_row0(variant)
    jsolve = jmake_solver(jspec, JOPT)
    jiter = jax.jit(jsolve.iterate)
    jst0 = jax.jit(jsolve.init)(jdata)
    spec6, spec8, data, _ = fix_fixture_batch(dtype=torch.float64,
                                              device="cpu", rows=[0])
    spec = spec6 if variant == "fix_terminal" else spec8
    np.testing.assert_allclose(to_numpy(data.x0)[0], np.asarray(jdata.x0))
    return dict(variant=variant, jdata=jdata, jst0=jst0, jiter=jiter,
                jfin=jax.jit(jsolve.finalize), data=data,
                solve=make_obca_solver(spec, OPT))


def _np_tree(nt):
    return type(nt)(*[np.asarray(v) for v in nt])


@pytest.mark.parametrize("n_iter", [1, 3])
def test_qr_iterate_state(qr_pair, n_iter):
    e = qr_pair
    jst = e["jiter"](e["jst0"], e["jdata"], n_iter)
    st = e["solve"].iterate(e["solve"].init(e["data"]), e["data"], n_iter)
    want = from_numpy(_np_tree(jst), "cpu")
    for f in st._fields:
        a, b = to_numpy(getattr(st, f)), to_numpy(getattr(want, f))
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9, err_msg=f)


def test_qr_solve(qr_pair):
    e = qr_pair
    jres = e["jfin"](e["jiter"](e["jst0"], e["jdata"], 100), e["jdata"])
    assert bool(jres.feas)
    if e["variant"] == "fix_terminal":
        assert int(jres.iters) == 34
    res = e["solve"](e["data"])
    assert res.iters.tolist() == [int(jres.iters)]
    assert res.feas.tolist() == [True]
    for k in jres.z:
        np.testing.assert_allclose(to_numpy(res.z[k])[0], np.asarray(jres.z[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_kkt_qr_plain_matches_dense_solve():
    spec6, _, data, _ = fix_fixture_batch(dtype=torch.float64, device="cpu",
                                          rows=[0, 23, 48])
    solve = make_obca_solver(spec6, OPT)
    st = solve.iterate(solve.init(data), data, 2)
    ops = solve.layout.ops("cpu", torch.float64)
    L = solve.layout
    rng = np.random.RandomState(1)
    bnd = solve.provider(st.zv, data, st.sf, st.scE, st.scD, st.y,
                         st.w[:, L.m_id:].contiguous())
    pieces = [torch.as_tensor(rng.randn(*s)) for s in (
        (3, L.np_, L.np_), (3, L.K, L.S, L.bq), (3, L.K, L.bq, L.bq))]
    Wpp = pieces[0] + pieces[0].transpose(1, 2) + 40.0 * torch.eye(L.np_)
    Wqq = (pieces[2] + pieces[2].transpose(2, 3)
           + 40.0 * torch.eye(L.bq))
    Wpq = pieces[1]
    rhs1 = torch.as_tensor(rng.randn(3, L.n))
    rhs2 = torch.as_tensor(rng.randn(3, L.mE))
    ladder = torch.tensor([[1e-8, 1e-6], [1e-4, 1e-2], [1.0, 100.0]],
                          dtype=torch.float64)
    dd = 1e-8
    sol, good = tqr.kkt_qr_plain(ops, bnd, Wpp, Wpq, Wqq, rhs1, rhs2, ladder, dd)
    assert good.all()
    W = to_numpy(tqr.dense_w(ops, Wpp, Wpq, Wqq))
    JE = to_numpy(tqr.dense_je(ops, bnd))
    # the dense pieces hold every arrow entry once, and nothing else
    assert np.count_nonzero(W) == sum(int((t != 0).sum()) for t in (Wpp, Wqq)) + 2 * int((Wpq != 0).sum())
    n, mE = L.n, L.mE
    for b in range(3):
        for r in range(2):
            d = float(ladder[b, r])
            K = np.block([[W[b] + d * np.eye(n), JE[b].T],
                          [JE[b], -dd * np.eye(mE)]])
            want = np.linalg.solve(K, np.concatenate([to_numpy(rhs1)[b],
                                                      to_numpy(rhs2)[b]]))
            np.testing.assert_allclose(to_numpy(sol)[b, r], want,
                                       rtol=0, atol=1e-9 * np.abs(want).max())
    # a non-finite entry rejects the rung
    Wbad = Wpp.clone()
    Wbad[1, 2, 2] = float("nan")
    _, good_bad = tqr.kkt_qr_plain(ops, bnd, Wbad, Wpq, Wqq, rhs1, rhs2, ladder, dd)
    assert good_bad.tolist() == [[True, True], [False, False], [True, True]]

