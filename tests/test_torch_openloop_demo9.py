"""CPU parity of the port's open-loop pipeline with the JAX package on
demo9: ``run_open_loop("demo9", N=10)`` in float64 through both packages
(the port's kernels run their plain PyTorch versions on CPU tensors), both
phases: the same feasibility, per-phase iterations and fallback, Ts_opt
within 1e-6 relative, the plans x and u within 1e-6. A file of its own:
most of its time is the JAX package's compiles, and the suite's workers
take files whole."""

import numpy as np
import torch

import jax.numpy as jnp

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.runtime import (
    open_loop as jopen_loop,
)

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime import (
    run_open_loop,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

F64 = torch.float64


def test_open_loop_demo9_matches_jax():
    jr = jopen_loop.run_open_loop("demo9", N=10, dtype=jnp.float64)
    tr = run_open_loop("demo9", N=10, dtype=F64, device="cpu")
    assert tr.feas == jr.feas and tr.feas
    for phase in ("free", "fix"):
        a, b = getattr(tr, phase), getattr(jr, phase)
        assert (a["feas"], a["iters"]) == (b["feas"], b["iters"]), phase
        assert abs(a["Ts_opt"] - b["Ts_opt"]) <= 1e-6 * abs(b["Ts_opt"]), phase
        for k in ("x", "u"):
            np.testing.assert_allclose(a[k], np.asarray(b[k]), rtol=0, atol=1e-6,
                                       err_msg=f"{phase} {k}")
    assert tr.fix["fallback"] == jr.fix["fallback"]
    assert abs(tr.Ts_opt - jr.Ts_opt) <= 1e-6 * abs(jr.Ts_opt)
    np.testing.assert_allclose(tr.x, np.asarray(jr.x), rtol=0, atol=1e-6)
