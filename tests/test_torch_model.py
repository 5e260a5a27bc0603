"""CPU parity of the port's OBCA model and its plain KKT provider against
the JAX package, at float64 on the grid of tests/test_struct_derivs.py
(variant x coupled motion x obca_k0, demo1, N = 5).

The same numpy inputs go through both packages; tolerance 1e-10
(relative and absolute): both sides evaluate the same formulas in
float64 and differ only in summation order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.models import (
    obca as jobca,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.models.builder import (
    build_obca_data as jbuild,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.models.obca_struct import (
    make_provider as jmake_provider,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.runtime import (
    astar_host as jastar,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.runtime.reference import (
    window_reference as jwindow,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.scenarios import (
    build_scenario as jbuild_scenario,
    get_demo,
)

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.interop import (
    from_numpy, to_numpy,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
    obca as tobca,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models.obca_struct import (
    make_provider as tmake_provider,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-10, atol=1e-10)

CONFIGS = [
    ("free", False, False),
    ("free", False, True),
    ("free", True, False),
    ("fix_terminal", False, False),
    ("fix_free_end", False, False),
    ("fix_eq_band", False, False),
]


def _setup(variant, coupled, k0, N=5):
    dtype = jnp.float64
    demo = get_demo("demo1")
    scn, shape = jbuild_scenario(demo, dtype=dtype)
    kw_spec = dict(N=N, n_obs=shape.n_obs, e_max=shape.e_max,
                   variant=variant, coupled_motion=coupled, obca_k0=k0)
    jspec = jobca.OBCASpec(**kw_spec)
    tspec = tobca.OBCASpec(**kw_spec)
    ref = jastar.reference_path_for(np.asarray(scn.grid), demo.start,
                                    demo.goal)
    x0 = jnp.asarray(ref[:, 4], dtype)
    xref = jwindow(jnp.asarray(ref, dtype), ref.shape[1], x0, N)
    p1 = demo.params
    kw = dict(q=p1.q_fix, r1=p1.r1_fix, r2=p1.r2_fix, v_max=p1.v_max,
              w_max=p1.w_max, a_max=p1.a_max, alpha_max=p1.alpha_max,
              ego=p1.ego, dmin=p1.dmin)
    if variant.startswith("fix"):
        kw["terminal_set"] = jnp.asarray(
            [[x0[0] - 50.0, 99.0], [1.0, 9.0]], dtype)
        kw["Ts_pred"] = 0.1
        kw["dyn_active"] = jnp.ones((1,), dtype)
    data = jbuild(jspec, scn, x0=x0, u0=jnp.asarray([0.1, 0.02], dtype),
                  xref=xref, Ts=0.1, **kw)
    if coupled:
        data = data._replace(obs_vel=jnp.asarray(
            np.random.RandomState(3).randn(jspec.n_obs, 2) * 0.1, dtype))
    return jspec, tspec, data, from_numpy(data, "cpu")


def _zscale(z):
    zs = jax.tree.map(jnp.ones_like, z)
    zs["x"] = zs["x"] * jnp.asarray([[10.0], [10.0], [3.0]])
    if "T" in zs:
        zs["T"] = zs["T"] * 30.0
    return ravel_pytree(zs)[0]


@pytest.mark.parametrize("variant,coupled,k0", CONFIGS)
def test_model_functions(variant, coupled, k0):
    jspec, tspec, jdata, tdata = _setup(variant, coupled, k0)
    jz0 = jobca.init_vars(jspec, jdata)
    tz0 = tobca.init_vars(tspec, tdata)
    for k in jz0:
        np.testing.assert_allclose(to_numpy(tz0[k])[0], np.asarray(jz0[k]),
                                   **TOL, err_msg=k)
    zv0, unravel = ravel_pytree(jz0)
    np.testing.assert_allclose(to_numpy(tobca.ravel_z(tspec, tz0))[0],
                               np.asarray(zv0), **TOL)
    rng = np.random.RandomState(1)
    zr = np.asarray(zv0) + rng.randn(zv0.shape[0]) * 0.1
    jz = unravel(jnp.asarray(zr))
    tz = tobca.unravel_z(tspec, torch.as_tensor(zr)[None])
    for name in ("objective", "eq_constraints", "ineq_constraints",
                 "ineq_constraints_dense"):
        want = np.asarray(getattr(jobca, name)(jspec, jdata, jz))
        got = to_numpy(getattr(tobca, name)(tspec, tdata, tz))[0]
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)


@pytest.mark.parametrize("variant,coupled,k0", CONFIGS)
def test_plain_provider_bundle(variant, coupled, k0):
    jspec, tspec, jdata, tdata = _setup(variant, coupled, k0)
    jz0 = jobca.init_vars(jspec, jdata)
    zv0, _ = ravel_pytree(jz0)
    ds = np.asarray(_zscale(jz0))
    jlay, jprov = jmake_provider(jspec, ds)
    tlay, tprov = tmake_provider(tspec, ds)
    for f in ("p_idx", "q_idx", "pq_pos", "id_p_pos"):
        np.testing.assert_array_equal(getattr(tlay, f), getattr(jlay, f))

    rng = np.random.RandomState(0)
    zv = np.asarray(zv0) / ds + rng.randn(zv0.shape[0]) * 0.05
    sf = 0.7
    scE = np.abs(rng.randn(jlay.mE)) + 0.3
    scD = np.abs(rng.randn(jlay.mD)) + 0.3
    y = rng.randn(jlay.mE)
    w_d = np.abs(rng.randn(jlay.mD)) + 0.1
    jb = jprov(*[jnp.asarray(a) for a in (zv,)], jdata, jnp.asarray(sf),
               jnp.asarray(scE), jnp.asarray(scD), jnp.asarray(y),
               jnp.asarray(w_d))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64))[None]
    tb = tprov(t(zv), tdata, t(sf), t(scE), t(scD), t(y), t(w_d))
    for name in jb._fields:
        np.testing.assert_allclose(to_numpy(getattr(tb, name))[0],
                                   np.asarray(getattr(jb, name)), **TOL,
                                   err_msg=name)
