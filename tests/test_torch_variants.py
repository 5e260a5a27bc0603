"""CPU parity of the port's two remaining OBCA variants against the JAX
package at float64: ``fix_eq_band`` (terminal position equality and a
heading band |theta_N - thetaref_N| <= theta_band) and free time with
``coupled_motion`` (the obstacles' offsets move with the optimised time
scale T, a fourth spine slot of every block), and the dims block that
carries both to the CUDA kernels.

* The JAX package's own variant problems through ``make_obca_solver``:
  tests/test_variants.py's demo1 band problem (N = 5, Ts = 2, its
  IPMOptions) and tests/test_solver.py's demo1 window with every
  obstacle moving at 0.05 (N = 6, default IPMOptions), built by the JAX
  package and carried across with ``interop.from_numpy``.
* The fix step's width in both variants (``entry.eq_band_fixture_batch``
  and ``entry.coupled_fixture_batch``) on 4 fixture rows, one of each
  recorded demo: the port's batches equal the JAX package's builders on
  the same rows (1e-12), and the port's multistart (plain versions) gives
  the JAX package's vmapped multistart.
* ``kernels._dims`` against csrc/common.cuh ``dims_from`` written out, in
  the five configurations (free, free with coupled motion, fix_terminal,
  fix_free_end, fix_eq_band): the variant the kernels read from the row
  counts, S and theta_band, and the sizes they derive; and the row counts
  of no variant refused.

Tolerances: the JAX tests' own, feasibility equal, iterations within 1
and x within rtol 1e-6, atol 1e-7.
"""

import dataclasses
import struct

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
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.runtime import (
    astar_host as jastar,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.runtime.multistart import (
    candidate_inits_traced as jcands,
    make_multistart_solver as jmake_ms,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.runtime.reference import (
    window_reference as jwindow,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.scenarios import (
    build_scenario as jbuild_scenario,
    get_demo as jget_demo,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.solver import (
    IPMOptions as JOptions,
    make_obca_solver as jmake_solver,
)

from test_torch_fixstep import _jax_rows
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
    FIX6_OPTIONS, FIX_FIXTURE, coupled_fixture_batch, eq_band_fixture_batch,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.interop import (
    from_numpy, to_numpy,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
    OBCASpec, init_vars,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models.obca_struct import (
    make_layout,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime.multistart import (
    make_multistart_solver,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime.scan_loop import (
    N_CAND_FREE, SCAN_OPTIONS,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
    IPMOptions, make_obca_solver,
)

F64 = torch.float64
TOL = dict(rtol=1e-6, atol=1e-7)
ROWS = [0, 23, 48, 75]   # the first fixture row of demos 1, 2, 3 and 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these batches are small, and the suite runs
    several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jopt(o):
    return JOptions(**{f.name: getattr(o, f.name) for f in dataclasses.fields(o)})


def _assert_results(res, jres, picks=None):
    """feas equal, iterations within 1, x within TOL (lane by lane)."""
    feas, iters = res.feas.tolist(), res.iters.tolist()
    assert feas == np.atleast_1d(np.asarray(jres.feas)).tolist()
    for a, b in zip(iters, np.atleast_1d(np.asarray(jres.iters)).tolist()):
        assert abs(a - b) <= 1, (iters, np.asarray(jres.iters))
    x = to_numpy(res.z["x"])
    np.testing.assert_allclose(x, np.asarray(jres.z["x"]).reshape(x.shape), **TOL)


# ------------------------------------------------ the JAX package's problems

def _demo1(N, x0_col):
    demo = jget_demo("demo1")
    scn, shape = jbuild_scenario(demo, dtype=jnp.float64)
    ref = jastar.reference_path_for(np.asarray(scn.grid), demo.start, demo.goal)
    x0 = scn.start if x0_col is None else jnp.asarray(ref[:, x0_col])
    return scn, shape, x0, jwindow(jnp.asarray(ref), ref.shape[1], x0, N)


def test_fix_eq_band_solve_matches_jax():
    """tests/test_variants.py's band problem: demo1 from a path-interior
    pose, N = 5, Ts = 2."""
    N = 5
    scn, shape, x0, xref = _demo1(N, 2)
    kw = dict(N=N, n_obs=shape.n_obs, e_max=shape.e_max, variant="fix_eq_band")
    jspec = JSpec(**kw)
    jdata = jbuild_data(jspec, scn, x0=x0, u0=jnp.zeros(2), xref=xref, Ts=2.0)
    opt = dict(max_iters=150, acceptable_tol=5e-3, feas_tol=1e-4)
    jres = jax.jit(jmake_solver(jspec, JOptions(**opt)))(jdata, jinit_vars(jspec, jdata))
    assert bool(jres.feas)
    res = make_obca_solver(OBCASpec(**kw), IPMOptions(**opt))(from_numpy(jdata, "cpu"))
    _assert_results(res, jres)
    x = to_numpy(res.z["x"])[0]
    assert abs(x[2, N] - np.asarray(xref)[2, N]) <= OBCASpec(**kw).theta_band + 1e-6


def test_coupled_motion_solve_matches_jax():
    """tests/test_solver.py's demo1 window (N = 6, from the start pose) with
    every obstacle moving at 0.05 in x and y, default options."""
    N = 6
    scn, shape, x0, xref = _demo1(N, None)
    kw = dict(N=N, n_obs=shape.n_obs, e_max=shape.e_max, variant="free",
              coupled_motion=True)
    jspec = JSpec(**kw)
    jdata = jbuild_data(jspec, scn, x0=scn.start, u0=jnp.zeros(2), xref=xref, Ts=0.1)
    jdata = jdata._replace(obs_vel=jnp.ones_like(jdata.obs_vel) * 0.05)
    jres = jax.jit(jmake_solver(jspec, JOptions(kkt="fused")))(jdata, jinit_vars(jspec, jdata))
    res = make_obca_solver(OBCASpec(**kw), IPMOptions())(from_numpy(jdata, "cpu"))
    _assert_results(res, jres)
    np.testing.assert_allclose(res.z["T"].item(), float(jres.z["T"]), **TOL)


# --------------------------------------------------- the fix step's width

def _jax_coupled_rows(rows):
    """coupled_fixture_batch's rows built by the JAX package: each fixture
    row's world with its sensed obstacle at its recorded displacement,
    free-time weights, obs_vel carrying the motion (no Ts_pred), and the
    free rung's candidates."""
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
    spec = JSpec(N=Nf, n_obs=shape.n_obs, e_max=shape.e_max, variant="free",
                 coupled_motion=True)
    take = lambda a: jnp.asarray(np.asarray(a)[rows], dtype)

    def build(scn, x0, u0, xref, Ts, delta, sensed):
        data = jbuild_data(
            spec, scn, x0=x0, u0=u0, xref=xref, Ts=Ts, dyn_active=sensed,
            dyn_delta=delta, q=p.q_free, r1=p.r1_free, r2=p.r2_free,
            time_c1=p.time_c1, time_c2=p.time_c2, v_max=p.v_max, w_max=p.w_max,
            a_max=p.a_max, alpha_max=p.alpha_max, ego=p.ego, dmin=p.dmin)
        return data, jcands(xref, x0)[:N_CAND_FREE]

    data, cands = jax.jit(jax.vmap(build))(
        scn_rows, take(fx["x0"]), take(fx["u0"]), take(fx["xref"]), take(fx["Ts"]),
        take(fx["dyn_delta"]), take(fx["sensed"]))
    return spec, data, cands


def _batch(kind):
    """(JAX spec, JAX data, JAX candidates, port spec, port data, port
    candidates, options) of ROWS in the variant ``kind``."""
    if kind == "band":
        jspec6, _, jdata, jc, _, _ = _jax_rows(ROWS)
        jspec = dataclasses.replace(jspec6, variant="fix_eq_band")
        spec, data, cands = eq_band_fixture_batch(dtype=F64, device="cpu", rows=ROWS)
        return jspec, jdata, jc, spec, data, cands, FIX6_OPTIONS
    jspec, jdata, jc = _jax_coupled_rows(ROWS)
    spec, data, cands = coupled_fixture_batch(dtype=F64, device="cpu", rows=ROWS)
    return jspec, jdata, jc, spec, data, cands, SCAN_OPTIONS


@pytest.mark.parametrize("kind", ["band", "coupled"])
def test_fixture_multistart_matches_jax(kind):
    jspec, jdata, jc, spec, data, cands, opt = _batch(kind)
    assert dataclasses.asdict(jspec) == dataclasses.asdict(spec)
    for f in data._fields:
        np.testing.assert_allclose(to_numpy(getattr(data, f)), np.asarray(getattr(jdata, f)),
                                   rtol=0, atol=1e-12, err_msg=f)
    np.testing.assert_allclose(to_numpy(cands), np.asarray(jc), rtol=0, atol=1e-12)
    if kind == "coupled":   # every row's sensed obstacle moves
        assert bool((data.obs_vel.abs().sum((1, 2)) > 0).all())
    nC = cands.shape[1]
    jms = jmake_ms(jspec, jmake_solver(jspec, _jopt(opt)), jinit_vars, nC)
    jres, _ = jax.jit(jax.vmap(lambda d, c: jms(d, c)))(jdata, jc)
    ms = make_multistart_solver(spec, make_obca_solver(spec, opt), init_vars, nC)
    res, _ = ms(data, cands)
    _assert_results(res, jres)


# ------------------------------------------------------------ the dims

def _cu_dims(ints):
    """csrc/common.cuh dims_from, written out, on ints[2..11]: the Dims it
    derives, or None where it returns false."""
    N, nO, E, k_lo, off_u, mE_sp, mD_sp, m_id, S, bits = ints
    tE, tD = mE_sp - 3 * N - 3, mD_sp - 4 * N
    if off_u == 1:
        ok = tE == 3 and tD == 0
    else:
        ok = off_u == 0 and ((tE == 0 and tD in (0, 3)) or (tE == 2 and tD == 2))
    if not ok or not (S == 3 or (S == 4 and off_u == 1)):
        return None
    K = (N + 1 - k_lo) * nO
    bq = E + 4
    return dict(free=off_u == 1, band=tD == 2, S=S,
                theta_band=struct.unpack("<d", struct.pack("<q", bits))[0],
                K=K, bq=bq, n=off_u + K * bq + 2 * N + 3 * (N + 1),
                np_=off_u + 2 * N + 3 * (N + 1), mE=mE_sp + 2 * K, mD=mD_sp + 2 * K,
                mI=m_id + mD_sp + 2 * K)


CONFIGS = {"free": ("free", False), "coupled": ("free", True),
           "fix_terminal": ("fix_terminal", False), "fix_free_end": ("fix_free_end", False),
           "fix_eq_band": ("fix_eq_band", False)}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_dims_block_mirrors_the_cu_formula(config):
    variant, coupled = CONFIGS[config]
    spec = OBCASpec(N=6, n_obs=4, e_max=4, variant=variant, coupled_motion=coupled,
                    theta_band=0.6)
    lay = make_layout(spec)
    ints = kernels._dims(spec, lay)
    assert len(ints) == 10 and all(isinstance(i, int) for i in ints)
    d = _cu_dims(ints)
    assert d == dict(free=variant == "free", band=variant == "fix_eq_band",
                     S=4 if coupled else 3, theta_band=0.6, K=lay.K, bq=lay.bq, n=lay.n,
                     np_=lay.np_, mE=lay.mE, mD=lay.mD, mI=lay.m_id + lay.mD)
    assert ints[8] == lay.S
    # the terminal rows the kernels evaluate: equalities, dense inequalities
    assert (lay.mE_sp - 3 * spec.N - 3, lay.mD_sp - 4 * spec.N) == {
        "free": (3, 0), "fix_terminal": (0, 3), "fix_free_end": (0, 0),
        "fix_eq_band": (2, 2)}[variant]
    # what names no variant is refused: S = 4 without free time, and
    # another variant's terminal rows
    assert _cu_dims(ints[:8] + [4 if ints[4] == 0 else 5, ints[9]]) is None
    assert _cu_dims(ints[:6] + [ints[6] + 1] + ints[7:]) is None
