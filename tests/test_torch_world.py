"""CPU parity of the port's world inputs against the JAX package, plus the
port's import hygiene.

The same numpy inputs go through both packages at float64: every Scenario
field of all 11 demos (exact for masks and the grid, <= 1e-12 for floats),
the host A* paths, reference windows and helpers, and H-rep edge cases.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.ops import (
    geometry as jgeom,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.runtime import (
    astar_host as jastar,
    reference as jreference,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.runtime.reference import (
    window_reference as jwindow,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.scenarios import (
    build as jbuild,
    demos as jdemos,
)

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.interop import (
    to_numpy,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.ops import (
    geometry as tgeom,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime import (
    astar_host as tastar,
    reference as treference,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime.reference import (
    window_reference as twindow,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
    build as tbuild,
    demos as tdemos,
)

PORT = "vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch"
PORT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), PORT)
EXACT = {"s_edge_mask", "s_mask", "d_edge_mask", "d_mask", "grid", "ts_rel"}


def test_demo_tables_equal():
    assert tdemos.demo_names() == jdemos.demo_names()
    for name in jdemos.demo_names():
        assert (dataclasses.asdict(tdemos.get_demo(name))
                == dataclasses.asdict(jdemos.get_demo(name))), name


@pytest.mark.parametrize("name", jdemos.demo_names())
def test_scenario_fields(name):
    jscn, jshape = jbuild.build_scenario(jdemos.get_demo(name), dtype=jnp.float64)
    tscn, tshape = tbuild.build_scenario(tdemos.get_demo(name), dtype=torch.float64,
                                         device="cpu")
    assert dataclasses.asdict(tshape) == dataclasses.asdict(jshape)
    for f in jscn._fields:
        want, got = np.asarray(getattr(jscn, f)), to_numpy(getattr(tscn, f))
        assert got.shape == want.shape, f
        if f in EXACT:
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12, err_msg=f)


@pytest.mark.parametrize("name", ["demo1", "demo9"])
def test_astar_paths_and_windows(name):
    demo = tdemos.get_demo(name)
    jscn, _ = jbuild.build_scenario(jdemos.get_demo(name), dtype=jnp.float64)
    tscn, _ = tbuild.build_scenario(demo, dtype=torch.float64, device="cpu")
    jref = jastar.reference_path_for(np.asarray(jscn.grid), demo.start, demo.goal)
    tref = tastar.reference_path_for(tscn.grid.numpy(), demo.start, demo.goal)
    np.testing.assert_array_equal(tref, jref)
    L = jref.shape[1]
    rng = np.random.RandomState(5)
    # poses on, between and off the path, including exact ties in distance
    x0s = np.concatenate([jref[:, rng.randint(0, L, 6)].T,
                          jref[:, :2].T + [[0.5, 0.0, 0.0], [0.0, 0.5, 0.0]],
                          rng.uniform(0, 40, (4, 3))])
    for N in (5, 10):
        got = to_numpy(twindow(torch.as_tensor(tref), L, torch.as_tensor(x0s), N))
        for i, x0 in enumerate(x0s):
            want = np.asarray(jwindow(jnp.asarray(jref), L, jnp.asarray(x0), N))
            np.testing.assert_array_equal(got[i], want)


def test_reference_helpers():
    x0, xF = np.array([2.0, 3.0, 0.1]), np.array([30.0, 7.5, -0.4])
    for fn in ("start_goal_reference", "start_goal_smooth_reference"):
        want = np.asarray(getattr(jreference, fn)(jnp.asarray(x0), jnp.asarray(xF), 6))
        got = to_numpy(getattr(treference, fn)(torch.as_tensor(x0), torch.as_tensor(xF), 6))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12, err_msg=fn)
    for pose in ([29.8, 7.6, 0.0], [29.0, 7.5, 0.0]):
        assert bool(treference.goal_reached(torch.as_tensor(pose), xF)) == bool(
            jreference.goal_reached(jnp.asarray(pose), xF))
    path = [[0, 0], [0, 3], [2, 3], [2, 1], [5, 4], [1, 4]]
    np.testing.assert_allclose(tastar.interpolate_path(path, 0.5),
                               jastar.interpolate_path(path, 0.5), rtol=0, atol=1e-12)
    for name in jdemos.demo_names():
        tp, jp = (tdemos.get_demo(name).terminal_policy,
                  jdemos.get_demo(name).terminal_policy)
        np.testing.assert_array_equal(tp.resolve(x0), jp.resolve(x0))


def test_native_astar_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tastar.reference_path_for(np.zeros((3, 3)), (0, 0, 0), (2, 2, 0), native=True)


def test_rect_vertices_batched_matches_jax():
    rows = np.array([r[:5] for name in jdemos.demo_names()
                     for r in jdemos.get_demo(name).dyn_obs_info], np.float64)
    rows = np.concatenate([rows, [[1.0, -2.0, 0.7, 3.0, 1.5]]])
    got = tgeom.rect_vertices(*torch.as_tensor(rows).unbind(-1))
    assert got.shape == (rows.shape[0], 5, 2) and got.dtype == torch.float64
    for i, r in enumerate(rows):
        want = np.asarray(jgeom.rect_vertices(*r))
        np.testing.assert_allclose(got[i].numpy(), want, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(tgeom.rect_vertices(*r).numpy(), want)


def test_polygon_hrep_edge_cases():
    rng = np.random.RandomState(0)
    # vertical, horizontal and general edges in both directions, padding
    verts = np.stack([
        [[0, 0], [0, 5], [3, 5], [3, 0], [0, 0], [0, 0]],
        [[4, 4], [1, 1], [1, 7], [6, 2], [6, 2], [6, 2]],
        np.round(rng.uniform(-5, 5, (6, 2)), 1),
    ]).astype(np.float64)
    mask = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.float64)
    jA, jb = jgeom.batched_hrep(jnp.asarray(verts), jnp.asarray(mask))
    tA, tb = tgeom.batched_hrep(torch.as_tensor(verts), torch.as_tensor(mask))
    np.testing.assert_allclose(tA.numpy(), np.asarray(jA), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-12)
    vel = rng.randn(3, 2)
    jAt, jbt = jgeom.replicate_hrep_over_horizon(jA, jb, jnp.asarray(vel), 4, 0.1)
    tAt, tbt = tgeom.replicate_hrep_over_horizon(tA, tb, torch.as_tensor(vel), 4, 0.1)
    np.testing.assert_allclose(tAt.numpy(), np.asarray(jAt), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tbt.numpy(), np.asarray(jbt), rtol=0, atol=1e-12)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        f"import {PORT} as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if 'jax' in k)\n"
        "print('ok')\n")
    root = os.path.dirname(PORT_DIR)
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_never_import_jax():
    offenders = []
    for dirpath, _, files in os.walk(PORT_DIR):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                for i, line in enumerate(open(path), 1):
                    s = line.strip()
                    if s.startswith(("import jax", "from jax")) or (
                            "vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu."
                            in s and s.startswith(("import", "from"))):
                        offenders.append(f"{path}:{i}: {s}")
    assert not offenders, offenders
