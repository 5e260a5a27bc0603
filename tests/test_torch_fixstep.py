"""CPU parity of the port's fix-time step against the JAX package at
float64: ``init_vars``' multistart arguments, the batched
``candidate_inits_traced``, the multistart mechanisms of
tests/test_multistart.py on the port, and the production mpc6 -> mpc8
step (bench.py:341-428) on recorded rows of goldens/bench_fix_fixture.npz.

The JAX side builds the rows exactly as bench.py's fix stage does and
vmaps its jitted multistart solvers over them; the port runs the same
rows as one batch. Tolerances: 1e-12 on the built inputs and initial
variables (same formulas in float64), 1e-6 on z with equal per-rung
iteration counts and feasibility.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.models import (
    OBCASpec as JSpec,
    build_obca_data as jbuild_data,
    init_vars as jinit_vars,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.runtime.multistart import (
    candidate_inits as jcand_np,
    candidate_inits_traced as jcands,
    make_multistart_solver as jmake_ms,
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
    FIX6_OPTIONS, FIX8_OPTIONS, FIX_FIXTURE, fix_fixture_batch, make_fix_step,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.interop import (
    to_numpy,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
    init_vars,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime.multistart import (
    candidate_inits, make_multistart_solver,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
    IPMOptions, make_obca_solver,
)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these batches are small, and the suite runs
    several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the first row of demos 1, 2, 3 and 5, and row 1 (demo1), whose mpc6
# solve is infeasible so that mpc8 runs
STEP_ROWS = [0, 1, 23, 48, 75]
# with rows whose sensed obstacle bends the dodge candidates
INPUT_ROWS = STEP_ROWS + [30, 60, 97]


def _jopt(o):
    return JOptions(**{f: getattr(o, f) for f in (
        "max_iters", "tol", "acceptable_tol", "feas_tol", "n_deltas",
        "stall_iters", "stall_viol_gate", "acceptable_iter", "n_backtracks",
        "n_refine")})


def _jax_rows(rows):
    """bench.py:316-371 for the fixture rows ``rows``, float64."""
    dtype = jnp.float64
    fx = np.load(FIX_FIXTURE)
    Nf = fx["xref"].shape[-1] - 1
    names = sorted(set(fx["demo"].tolist()))
    scns, shape = {}, None
    for nm in names:
        scns[nm], shape = jbuild_scenario(jget_demo(nm), shape, dtype=dtype)
    scn_rows = jax.tree.map(lambda *xs: jnp.stack(xs),
                            *[scns[nm] for nm in fx["demo"][rows].tolist()])
    p = jget_demo(names[0]).params
    spec6 = JSpec(N=Nf, n_obs=shape.n_obs, e_max=shape.e_max,
                  variant="fix_terminal")
    spec8 = JSpec(N=Nf, n_obs=shape.n_obs, e_max=shape.e_max,
                  variant="fix_free_end")
    take = lambda a: jnp.asarray(np.asarray(a)[rows], dtype)

    def build(scn, x0, u0, xref, Ts, tset, delta, sensed):
        data = jbuild_data(
            spec6, scn, x0=x0, u0=u0, xref=xref, Ts=Ts, dyn_active=sensed,
            dyn_delta=delta, Ts_pred=Ts, terminal_set=tset, q=p.q_fix,
            r1=p.r1_fix, r2=p.r2_fix, v_max=p.v_max, w_max=p.w_max,
            a_max=p.a_max, alpha_max=p.alpha_max, ego=p.ego, dmin=p.dmin)
        th_o = scn.dyn_info[:, 2]
        ex = (jnp.abs(scn.dyn_info[:, 3] / 2 * jnp.cos(th_o))
              + jnp.abs(scn.dyn_info[:, 4] / 2 * jnp.sin(th_o)))
        ey = (jnp.abs(scn.dyn_info[:, 3] / 2 * jnp.sin(th_o))
              + jnp.abs(scn.dyn_info[:, 4] / 2 * jnp.cos(th_o)))
        ks = jnp.arange(Nf + 1, dtype=dtype)
        centers = (scn.dyn_info[None, :, :2] + delta[None]
                   + ks[:, None, None] * Ts * scn.d_vel[None])
        sm = sensed[None, :] > 0
        inf = jnp.asarray(jnp.inf, dtype)
        boxes = jnp.stack([
            jnp.min(jnp.where(sm, centers[..., 0] - ex[None], inf), axis=1),
            jnp.min(jnp.where(sm, centers[..., 1] - ey[None], inf), axis=1),
            jnp.max(jnp.where(sm, centers[..., 0] + ex[None], -inf), axis=1),
            jnp.max(jnp.where(sm, centers[..., 1] + ey[None], -inf), axis=1),
        ], axis=-1)
        cands = jcands(xref, x0, dyn_boxes=boxes,
                       y_bounds=(scn.x_lo[1], scn.x_hi[1]))
        return data, cands, boxes

    data, cands, boxes = jax.jit(jax.vmap(build))(
        scn_rows, take(fx["x0"]), take(fx["u0"]), take(fx["xref"]),
        take(fx["Ts"]), take(fx["terminal_set"]), take(fx["dyn_delta"]),
        take(fx["sensed"]))
    return spec6, spec8, data, cands, boxes, scn_rows


@pytest.fixture(scope="module")
def inputs():
    jspec6, jspec8, jdata, jc, jboxes, jscn = _jax_rows(INPUT_ROWS)
    spec6, spec8, data, cands = fix_fixture_batch(
        dtype=torch.float64, device="cpu", rows=INPUT_ROWS)
    return dict(jspec6=jspec6, jspec8=jspec8, jdata=jdata, jc=jc,
                jboxes=jboxes, jscn=jscn, spec6=spec6, spec8=spec8,
                data=data, cands=cands)


def _row(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def test_fixture_batch_and_candidates(inputs):
    e = inputs
    for f in e["data"]._fields:
        np.testing.assert_allclose(to_numpy(getattr(e["data"], f)),
                                   np.asarray(getattr(e["jdata"], f)),
                                   rtol=0, atol=1e-12, err_msg=f)
    np.testing.assert_allclose(to_numpy(e["cands"]), np.asarray(e["jc"]),
                               rtol=0, atol=1e-12)
    # the host list version gives the traced version's candidates
    # (minus the shifted plan, which it adds only with a previous plan)
    for i in range(len(INPUT_ROWS)):
        d = _row(e["jdata"], i)
        lo, hi = e["jscn"].x_lo[i, 1], e["jscn"].x_hi[i, 1]
        boxes = np.asarray(e["jboxes"][i])
        want = jcand_np(np.asarray(d.xref), np.asarray(d.x0), boxes,
                        (float(lo), float(hi)))
        got = candidate_inits(np.asarray(d.xref), np.asarray(d.x0), boxes,
                              (float(lo), float(hi)))
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", ["x_init", "lam_mu_init", "cold_duals"])
def test_init_vars(inputs, mode):
    e = inputs
    jspec, spec = e["jspec6"], e["spec6"]
    jd = _row(e["jdata"], 0)
    rng = np.random.RandomState(0)
    x_init = np.array(e["jc"][0, 4])
    kw_j, kw_t = {"x_init": jnp.asarray(x_init)}, {"x_init": torch.as_tensor(x_init[None])}
    if mode == "lam_mu_init":
        lam = rng.rand(jspec.n_k, jspec.n_obs, jspec.e_max)
        mu = rng.rand(jspec.n_k, jspec.n_obs, 4)
        kw_j.update(lam_init=jnp.asarray(lam), mu_init=jnp.asarray(mu))
        kw_t.update(lam_init=torch.as_tensor(lam[None]),
                    mu_init=torch.as_tensor(mu[None]))
    elif mode == "cold_duals":
        kw_j["warm_duals"] = kw_t["warm_duals"] = False
    want = jinit_vars(jspec, jd, **kw_j)
    data0 = type(e["data"])(*[f[:1] for f in e["data"]])
    got = init_vars(spec, data0, **kw_t)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(to_numpy(got[k])[0], np.asarray(want[k]),
                                   rtol=0, atol=1e-12, err_msg=k)


@pytest.fixture(scope="module")
def row0_ms(inputs):
    """Row 0 as a one-problem batch and two-candidate port multistarts
    with the options of tests/test_multistart.py."""
    e = inputs
    opt = IPMOptions(max_iters=100, acceptable_tol=5e-3, feas_tol=1e-4)
    data = type(e["data"])(*[f[:1] for f in e["data"]])
    base = e["cands"][:1, :1]
    cands = torch.cat([base, base], dim=1)
    ms6 = make_multistart_solver(e["spec6"], make_obca_solver(e["spec6"], opt),
                                 init_vars, 2)
    ms8 = make_multistart_solver(e["spec8"], make_obca_solver(e["spec8"], opt),
                                 init_vars, 2)
    return data, cands, ms6, ms8


def test_skip_burns_zero_iterations(row0_ms):
    data, cands, ms6, _ = row0_ms
    r_run, _ = ms6(data, cands, skip=torch.tensor([False]))
    r_skip, _ = ms6(data, cands, skip=torch.tensor([True]))
    assert bool(r_run.feas[0]) and int(r_run.iters[0]) > 0
    assert not bool(r_skip.feas[0])
    assert int(r_skip.iters[0]) == 0


def test_z_override_polish_start_converges_faster(row0_ms):
    data, cands, ms6, ms8 = row0_ms
    r6, _ = ms6(data, cands)
    assert bool(r6.feas[0])
    cold, _ = ms8(data, cands)
    warm, _ = ms8(data, cands, z_override=r6.z)
    assert bool(cold.feas[0]) and bool(warm.feas[0])
    assert int(warm.iters[0]) <= int(cold.iters[0])
    assert float(warm.f[0]) <= float(cold.f[0]) + 0.1 * (1 + abs(float(cold.f[0])))


def test_warm_duals_gated_out_is_a_no_op(row0_ms, inputs):
    data, cands, ms6, _ = row0_ms
    spec = inputs["spec6"]
    lam0 = torch.full((1, spec.n_k, spec.n_obs, spec.e_max), 0.25, dtype=torch.float64)
    mu0 = torch.full((1, spec.n_k, spec.n_obs, 4), 0.125, dtype=torch.float64)
    z0 = init_vars(spec, data, x_init=cands[:, 0], lam_init=lam0, mu_init=mu0)
    lam_mask = to_numpy(data.edge_mask * data.obs_mask[..., None])[0]
    np.testing.assert_array_equal(to_numpy(z0["lam"])[0],
                                  np.broadcast_to(0.25 * lam_mask, z0["lam"].shape[1:]))
    assert (to_numpy(z0["mu"])[0][:, to_numpy(data.obs_mask)[0] > 0] == 0.125).all()
    base, _ = ms6(data, cands)
    r0, _ = ms6(data, cands, warm=(lam0, mu0, torch.tensor([False])))
    np.testing.assert_array_equal(to_numpy(r0.z["x"]), to_numpy(base.z["x"]))
    assert r0.iters.tolist() == base.iters.tolist()


@pytest.fixture(scope="module")
def step_pair(inputs):
    e = inputs
    sel = [INPUT_ROWS.index(r) for r in STEP_ROWS]
    jd = jax.tree.map(lambda a: a[np.asarray(sel)], e["jdata"])
    jc = e["jc"][np.asarray(sel)]
    ms6 = jmake_ms(e["jspec6"], jmake_solver(e["jspec6"], _jopt(FIX6_OPTIONS)),
                   jinit_vars, 5)
    ms8 = jmake_ms(e["jspec8"], jmake_solver(e["jspec8"], _jopt(FIX8_OPTIONS)),
                   jinit_vars, 5)

    def sol_fix(d, c):
        r6, b6 = ms6(d, c)
        r8, b8 = ms8(d, c, r6.feas, None, dict(r6.z))
        return r6, b6, r8, b8

    jout = jax.jit(jax.vmap(sol_fix))(jd, jc)
    data = type(e["data"])(*[f[sel] for f in e["data"]])
    cands = e["cands"][sel]
    step = make_fix_step(e["spec6"], e["spec8"])
    res, rungs = step(data, cands)
    # the picked candidate of each rung, from the port's multistarts
    bests = []
    for spec, opt, skip, zo in ((e["spec6"], FIX6_OPTIONS, None, None),
                                (e["spec8"], FIX8_OPTIONS, rungs[0].feas, rungs[0].z)):
        ms = make_multistart_solver(spec, make_obca_solver(spec, opt), init_vars, 5)
        bests.append(ms(data, cands, skip=skip, z_override=zo)[1])
    return jout, res, rungs, bests, cands


def test_fix_step_matches_jax(step_pair):
    (j6, jb6, j8, jb8), res, rungs, bests, cands = step_pair
    assert np.asarray(j6.feas).tolist() == [True, False, True, True, True]
    for jr, jb, r, b in ((j6, jb6, rungs[0], bests[0]), (j8, jb8, rungs[1], bests[1])):
        assert r.iters.tolist() == np.asarray(jr.iters).tolist()
        assert r.feas.tolist() == np.asarray(jr.feas).tolist()
        # the same pick, or a pick among candidates that start from the
        # very same trajectory (the JAX package's vmapped batch rounds
        # identical lanes apart; the port gives them equal objectives)
        for i, (bt, bj) in enumerate(zip(b.tolist(), np.asarray(jb).tolist())):
            assert bt == bj or torch.equal(cands[i, bt], cands[i, bj]), (i, bt, bj)
        for k in jr.z:
            np.testing.assert_allclose(to_numpy(r.z[k]), np.asarray(jr.z[k]),
                                       rtol=0, atol=1e-6, err_msg=k)
    use8 = ~np.asarray(j6.feas) & np.asarray(j8.feas)
    assert res.feas.tolist() == (np.asarray(j6.feas) | np.asarray(j8.feas)).tolist()
    assert res.iters.tolist() == (np.asarray(j6.iters) + np.asarray(j8.iters)).tolist()
    for k in j6.z:
        want = np.where(use8.reshape((-1,) + (1,) * (j6.z[k].ndim - 1)),
                        np.asarray(j8.z[k]), np.asarray(j6.z[k]))
        np.testing.assert_allclose(to_numpy(res.z[k]), want, rtol=0, atol=1e-6,
                                   err_msg=k)
