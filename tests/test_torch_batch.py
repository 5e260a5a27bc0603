"""CPU parity of the port's batched free-time solve with bench.py's
headline workload: demo9, N = 10, the tuned free-time options, on the 8
windows ``starts[::32]`` of bench's B = 256 batch, float64.

The JAX package solves the 8 problems vmapped; the port solves them as one
batch (B = 8) with per-lane freezing. Per-lane iteration counts and
feasibility must be equal and z within 1e-6.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.models import (
    OBCASpec, build_obca_data,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.runtime import (
    astar_host as jastar,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.runtime.reference import (
    window_reference as jwindow,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.scenarios import (
    build_scenario, get_demo,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.solver import (
    IPMOptions as JOptions, make_obca_solver as jmake_solver,
)

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
    BENCH_FREE_OPTIONS, demo9_starts, demo9_window_batch,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.interop import (
    from_numpy, to_numpy,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
    make_obca_solver,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

N = 10


def _jax_batch(starts):
    dtype = jnp.float64
    demo = get_demo("demo9")
    scn, shape = build_scenario(demo, dtype=dtype)
    spec = OBCASpec(N=N, n_obs=shape.n_obs, e_max=shape.e_max, variant="free")
    ref = jastar.reference_path_for(np.asarray(scn.grid), demo.start, demo.goal)
    refj = jnp.asarray(ref, dtype)
    x0s = jnp.asarray(ref[:, starts], dtype).T

    def build_one(x0):
        xref = jwindow(refj, ref.shape[1], x0, N)
        return build_obca_data(spec, scn, x0=x0, u0=jnp.zeros(2, dtype),
                               xref=xref, Ts=0.1)

    data = jax.vmap(build_one)(x0s)
    o = BENCH_FREE_OPTIONS
    opt = JOptions(max_iters=o.max_iters, tol=o.tol,
                   acceptable_tol=o.acceptable_tol, feas_tol=o.feas_tol,
                   n_deltas=o.n_deltas, n_refine=o.n_refine,
                   n_backtracks=o.n_backtracks, acceptable_iter=o.acceptable_iter)
    res = jax.jit(jax.vmap(jmake_solver(spec, opt)))(data)
    return data, res


def test_demo9_window_batch_matches_jax():
    starts256, _ = demo9_starts(256)
    starts = starts256[::32]
    jdata, jres = _jax_batch(starts)
    assert np.asarray(jres.iters).tolist() == [14, 10, 9, 12, 11, 13, 11, 14]
    assert np.asarray(jres.feas).all()

    spec, data, _, _ = demo9_window_batch(8, N=N, dtype=torch.float64,
                                          device="cpu", starts=starts)
    # the port builds the same problems as the JAX package
    want = from_numpy(type(jdata)(*[np.asarray(v) for v in jdata]), "cpu")
    for f in data._fields:
        np.testing.assert_allclose(to_numpy(getattr(data, f)),
                                   to_numpy(getattr(want, f)),
                                   rtol=0, atol=1e-12, err_msg=f)

    res = make_obca_solver(spec, BENCH_FREE_OPTIONS)(data)
    assert res.iters.tolist() == np.asarray(jres.iters).tolist()
    assert res.feas.tolist() == np.asarray(jres.feas).tolist()
    for k in jres.z:
        np.testing.assert_allclose(to_numpy(res.z[k]), np.asarray(jres.z[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
