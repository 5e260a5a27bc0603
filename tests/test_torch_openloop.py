"""CPU parity of the port's open-loop pipeline with the JAX package.

The same demos and seeded numpy inputs go through the JAX package and
the port in float64 on the CPU (the port's kernels run their plain
PyTorch versions on CPU tensors); ``run_open_loop("demo9", N=10)`` itself
is tests/test_torch_openloop_demo9.py:

  * the spine SPD inverse ``_spd_inv`` in the orders the long horizons
    give it (m = 124 to 374: the block-Schur recursion and the Cholesky
    regime) within 1e-9 relative, and NaN over the whole matrix for a
    non-SPD one on both sides;
  * disk dilation and erosion of the demo1 and demo9 grids, equal;
  * the open loop's A* starting trajectories for demo9 at N = 74, every
    dilation with and without the aligned start, within 1e-12;
  * the host-side choice of a shared-memory or device-memory arena for
    the AL solve and line-search kernels at the open loop's sizes;
  * the unicycle step and the A* reference path of ``Simulation``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.ops import (
    dynamics as jdynamics,
    rasterize as jrasterize,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.runtime import (
    open_loop as jopen_loop,
    simulation as jsimulation,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.scenarios import (
    build_scenario as jbuild_scenario,
    get_demo as jget_demo,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.solver import (
    ipm as jipm,
)

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
    horizon_inputs, openloop_n74_inputs,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models.obca_struct import (
    make_layout,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.ops import (
    dilate_grid, erode_grid, unicycle_step,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime import (
    Simulation,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime.open_loop import (
    _resampled_astar_init,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
    build_scenario, get_demo,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.ipm import (
    _spd_inv,
)

from test_torch_native_astar import private_jax_native  # noqa: F401  (a fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

F64 = torch.float64


@pytest.mark.parametrize("m", [124, 164, 254, 374])
def test_spd_inv_long_spines_match_jax(m):
    rng = np.random.RandomState(m)
    M = rng.randn(3, m, m)
    A = M @ np.swapaxes(M, 1, 2) / m + np.eye(m)
    A[2, 5, 5] = -1.0                       # not SPD
    X = _spd_inv(torch.as_tensor(A)).numpy()
    Xj = np.asarray(jipm._spd_inv(jnp.asarray(A)))
    assert np.isnan(X[2]).all() and np.isnan(Xj[2]).all()
    assert np.isfinite(X[:2]).all() and np.isfinite(Xj[:2]).all()
    err = np.abs(X[:2] - Xj[:2]).max() / np.abs(Xj[:2]).max()
    assert err <= 1e-9, err
    np.testing.assert_allclose(A[:2] @ X[:2], np.broadcast_to(np.eye(m), (2, m, m)),
                               atol=1e-9)


@pytest.mark.parametrize("demo", ["demo1", "demo9"])
@pytest.mark.parametrize("radius", [1, 2])
def test_dilate_erode_match_jax(demo, radius):
    scn, _ = build_scenario(get_demo(demo), dtype=F64, device="cpu")
    grid = scn.grid
    for fn, jfn in ((dilate_grid, jrasterize.dilate_grid),
                    (erode_grid, jrasterize.erode_grid)):
        got = fn(grid, radius).numpy()
        want = np.asarray(jfn(grid.numpy(), radius))
        assert np.array_equal(got, want), fn.__name__
    assert dilate_grid(grid, radius).sum() > grid.sum() > erode_grid(grid, radius).sum()


@pytest.mark.parametrize("dilation,align", [(0, False), (0, True), (1, False), (1, True),
                                            (2, False), (2, True)])
def test_resampled_astar_init_n74_matches_jax(dilation, align):
    demo, jdemo = get_demo("demo9"), jget_demo("demo9")
    scn, _ = build_scenario(demo, dtype=F64, device="cpu")
    jscn, _ = jbuild_scenario(jdemo, dtype=jnp.float64)
    got = _resampled_astar_init(scn, demo, 74, F64, dilation=dilation, align_start=align)
    want = np.asarray(jopen_loop._resampled_astar_init(jscn, jdemo, 74, jnp.float64,
                                                       dilation=dilation,
                                                       align_start=align))
    assert got.shape == (3, 75)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_n74_candidates_are_the_open_loop_five():
    spec, data, cands, opt = openloop_n74_inputs(F64, "cpu")
    demo = get_demo("demo9")
    scn, _ = build_scenario(demo, dtype=F64, device="cpu")
    assert (spec.N, spec.variant, cands.shape, opt.max_iters) == (74, "free", (1, 5, 3, 75), 200)
    assert torch.equal(cands[0, 3], _resampled_astar_init(scn, demo, 74, F64, 2, True))
    assert torch.equal(data.xref[0, :, -1], scn.goal)
    assert horizon_inputs(74, F64, "cpu")[3].max_iters == 296


# (N, dtype) -> the line-search arena in device memory; the AL solve takes
# its global route (a CTA a rung, its float64 vectors in shared memory) at
# all these horizons. Byte counts the kernels' formulas give demo9 at free
# time: the AL solve's vectors (kernels.al_solve_route) and the line
# search's arena a CTA on the open loop's route (kernels.ls_route, 5
# candidate lanes: a CTA per (lane, trial))
ARENA_CASES = {
    (40, torch.float32): False, (40, torch.float64): False,
    (50, torch.float32): False, (50, torch.float64): False,
    (74, torch.float32): False, (74, torch.float64): False,
    (100, torch.float64): True,
}
ARENA_KB = {(40, torch.float64): (56, 112.6), (50, torch.float64): (69, 136.2),
            (74, torch.float32): (102, 96.3), (74, torch.float64): (102, 192.6)}


@pytest.mark.parametrize("N,dtype", list(ARENA_CASES))
def test_arena_placement_at_open_loop_sizes(N, dtype):
    spec, data, _, opt = horizon_inputs(N, dtype, "cpu")
    lay = make_layout(spec)
    al = kernels.al_solve_route(lay, opt.n_deltas, dtype)
    width = kernels.pack_obca_data(data).shape[1]
    route = kernels.ls_route(lay, width, 5, opt.n_backtracks, dtype)
    ls = route.arena
    assert al.route == "global" and route.route == "spread"
    assert ls == kernels.ls_arena_bytes(lay, width, opt.n_backtracks, dtype, "spread")
    assert kernels.arena_in_device_memory(ls) == ARENA_CASES[(N, dtype)]
    if (N, dtype) in ARENA_KB:
        kb_al, kb_ls = ARENA_KB[(N, dtype)]
        assert abs(al.smem / 1024 - kb_al) < 1 and abs(ls / 1024 - kb_ls) < 1
    assert not kernels.arena_in_device_memory(kernels.SMEM_MAX)
    assert kernels.arena_in_device_memory(kernels.SMEM_MAX + 8)


def test_unicycle_step_matches_jax():
    rng = np.random.RandomState(3)
    x, u = rng.randn(7, 3), rng.randn(7, 2)
    got = unicycle_step(torch.as_tensor(x), torch.as_tensor(u), 0.37).numpy()
    want = np.asarray(jdynamics.unicycle_step(jnp.asarray(x), jnp.asarray(u), 0.37))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


@pytest.mark.usefixtures("private_jax_native")
@pytest.mark.parametrize("demo", ["demo1", "demo9"])
def test_simulation_run_astar_matches_jax(demo):
    got = Simulation(device="cpu").run_astar(demo)
    want = jsimulation.Simulation(dtype=jnp.float64).run_astar(demo)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        Simulation(device="cpu").run_astar(demo, native=True),
        jsimulation.Simulation(dtype=jnp.float64).run_astar(demo, native=True))


def test_cli_astar_and_scan_on_cpu(capsys):
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.__main__ import main

    ref = Simulation(device="cpu").run_astar("demo9")
    assert main(["--demo", "demo9", "--mode", "astar", "-q", "--device", "cpu"]) == 0
    assert main(["--demo", "demo1", "--mode", "scan", "--max-steps", "1", "--device",
                 "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"demo9: A* path with {ref.shape[1]} points" in out
    assert "demo1: reached=False failed=False steps=1" in out
