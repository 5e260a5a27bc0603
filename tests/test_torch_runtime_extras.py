"""The port's small runtime modules on the CPU at float64:

* ops.dynamics.unicycle_rollout against the JAX package's (a seeded
  control sequence, batched and single), 1e-12;
* ops.geometry.grid_obstacle_vertices against the JAX package's (its own
  tests/test_geometry.py:133 case and seeded rows), exact;
* utils.profiling: wall_timer's sink; device_trace around annotate on the
  CPU writes a Chrome trace that holds the annotation's name;
* parallel.mesh: the scenario split over two CPU "devices" against one
  call of the same solver (demo9 windows, N = 6): same iterations and
  feasibility, z within 1e-12; shard_along's chunks; init_distributed a
  no-op for one process.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.ops.dynamics import (
    unicycle_rollout as j_rollout,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.ops.geometry import (
    grid_obstacle_vertices as j_grid_vertices,
)

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
    BENCH_FREE_OPTIONS, demo9_window_batch,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.ops import (
    grid_obstacle_vertices, unicycle_rollout,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.parallel import (
    init_distributed, make_mesh, shard_along, sharded_batch_solver,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
    make_obca_solver,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.utils import (
    annotate, device_trace, wall_timer,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_unicycle_rollout_matches_jax():
    rng = np.random.RandomState(5)
    x0 = rng.randn(3)
    us = rng.randn(12, 2) * 0.5
    want = np.asarray(j_rollout(jnp.asarray(x0), jnp.asarray(us), 0.1))
    got = unicycle_rollout(torch.as_tensor(x0), torch.as_tensor(us), 0.1)
    assert got.shape == (13, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    # with lanes: each lane its own rollout
    xb, ub = rng.randn(4, 3), rng.randn(4, 12, 2)
    gb = unicycle_rollout(torch.as_tensor(xb), torch.as_tensor(ub), 0.2)
    for i in range(4):
        np.testing.assert_allclose(
            gb[i].numpy(), np.asarray(j_rollout(jnp.asarray(xb[i]), jnp.asarray(ub[i]), 0.2)),
            rtol=0, atol=1e-12)


def test_grid_obstacle_vertices_matches_jax():
    case = np.array([[2.0, 3.0, 4.0, 5.0]])
    verts = grid_obstacle_vertices(case).numpy()
    assert verts.shape == (1, 5, 2)
    np.testing.assert_array_equal(verts, np.asarray(j_grid_vertices(case)))
    np.testing.assert_allclose(verts[0, 0], [2.5, 1.5])
    np.testing.assert_allclose(verts[0, 2], [6.5, 6.5])
    rows = np.random.RandomState(2).randint(0, 30, size=(7, 4)).astype(np.float64)
    np.testing.assert_array_equal(grid_obstacle_vertices(torch.as_tensor(rows)).numpy(),
                                  np.asarray(j_grid_vertices(rows)))


def test_wall_timer_sink():
    seen = []
    with wall_timer("block", sink=lambda label, dt: seen.append((label, dt))):
        sum(range(1000))
    assert len(seen) == 1 and seen[0][0] == "block" and 0.0 <= seen[0][1] < 60.0


def test_device_trace_holds_the_annotation(tmp_path):
    with device_trace(str(tmp_path / "trace")) as prof:
        with annotate("vmp_test_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.exists(prof.trace_path)
    with open(prof.trace_path) as fh:
        names = [e.get("name") for e in json.load(fh)["traceEvents"]]
    assert "vmp_test_span" in names


def test_sharded_batch_solver_matches_one_call():
    spec, data, _, _ = demo9_window_batch(5, N=6, dtype=torch.float64, device="cpu")
    solve = make_obca_solver(spec, BENCH_FREE_OPTIONS)
    one = solve(data)
    mesh = make_mesh(2, "cpu")
    assert mesh == [torch.device("cpu")] * 2
    parts = shard_along(data, mesh)
    assert [p.x0.shape[0] for p in parts] == [3, 2]
    split = sharded_batch_solver(solve, mesh)(data)
    assert torch.equal(split.iters, one.iters) and torch.equal(split.feas, one.feas)
    for k in one.z:
        assert split.z[k].shape == one.z[k].shape
        assert (split.z[k] - one.z[k]).abs().max().item() <= 1e-12, k
    init_distributed(world_size=1)     # one process: nothing to join


def test_make_mesh_takes_the_cards_and_raises_without_one(monkeypatch):
    """The card by default, like every entry point: no card raises, and the
    CPU mesh comes only when asked for."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)
    assert make_mesh(3, "cpu") == [torch.device("cpu")] * 3
