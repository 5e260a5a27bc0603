"""CPU parity of the port's scipy oracle (solver/oracle.py
solve_with_scipy) against the JAX package's at float64: the same
trust-constr run over the same OBCA problem (demo1's window, N = 6, from
the same warm start), 15 iterations: the same iteration count, z within
1e-6 and the objective within 1e-10 relative.

Fifteen, not more: the two packages' derivatives differ in their last
bits, and trust-constr amplifies that while it is still far from the
solution. From this warm start the runs agree within 2.2e-10 at 15
iterations and split after (1.6e-2 at 20, 6.9e-2 at 25; at 150 they
still differ by up to 8.5e-2 in z while their
objectives agree within 1.2e-9 relative)."""

import numpy as np
import torch

import jax.numpy as jnp

import __graft_entry__ as jentry
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.solver.oracle import (
    solve_with_scipy as jsolve_with_scipy,
)

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
    demo1_problem,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.oracle import (
    solve_with_scipy,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_oracle_matches_jax():
    jspec, jdata, _, _ = jentry._demo1_problem(jnp.float64)
    spec, data, _, _ = demo1_problem(torch.float64, "cpu")
    x_init = np.asarray(data.xref[0])
    jz, jres = jsolve_with_scipy(jspec, jdata, x_init, maxiter=15)
    z, res = solve_with_scipy(spec, data, x_init, maxiter=15)
    assert res.nit == jres.nit
    assert sorted(z) == sorted(jz)
    for k in jz:
        assert z[k].shape == np.asarray(jz[k]).shape
        np.testing.assert_allclose(z[k], np.asarray(jz[k]), rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(res.fun, jres.fun, rtol=1e-10)
    np.testing.assert_allclose(res.constr_violation, jres.constr_violation, rtol=1e-6,
                               atol=1e-10)
