"""CPU parity of the port's wavefront A* and random scenario generator
with the JAX package.

The same grids, starts and goals go through the JAX package's
``ops/astar.py`` (vmapped, as ``bench_sweep.py`` runs it) and the port's
plain versions, in float32 and float64: the 16 worlds of
``random_scenarios(seed=7)`` (the population of ``test_scan_loop.py``),
the demo1, demo9, demo10 and demo11 grids, and a map with an enclosed
free cell. The cost field, the path and its ``valid`` mask must be equal
(both sides do the same float additions and exact minima); the reference
with headings agrees within 1e-12 in float64 and 1e-6 in float32 (the two
libraries' ``atan2`` differ in the last bit in float32).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.ops import (
    astar as jastar,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.scenarios import (
    build_scenario as jbuild_scenario,
    get_demo as jget_demo,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.scenarios.random_gen import (
    random_scenarios as jrandom_scenarios,
)

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
    SWEEP_PATH_LEN, sweep_inputs,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.ops import astar
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
    Scenario, random_scenarios,
)

MAXL = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cells(poses):
    """(B, 2) int32 [row, col] = (int(y), int(x)) of (B, 3) poses."""
    p = np.asarray(poses)
    return np.stack([p[:, 1], p[:, 0]], axis=1).astype(np.int32)


def _enclosed(grid):
    """``grid`` with one free cell walled in on all eight sides."""
    g = np.array(grid)
    g[3:8, 18:23] = 1.0
    g[5, 20] = 0.0
    return g


def _case(name):
    """(grids (B, R, C), starts (B, 2), goals (B, 2)) as numpy."""
    if name == "random16":
        scn, _ = jrandom_scenarios(seed=7, batch=16, dtype=jnp.float64)
        return np.array(scn.grid), _cells(scn.start), _cells(scn.goal)
    if name == "enclosed":
        demo = jget_demo("demo1")
        scn, _ = jbuild_scenario(demo, dtype=jnp.float64)
        return (_enclosed(scn.grid)[None], np.asarray([[5, 20]], np.int32),
                _cells([demo.goal]))
    demo = jget_demo(name)
    scn, _ = jbuild_scenario(demo, dtype=jnp.float64)
    return np.array(scn.grid)[None], _cells([demo.start]), _cells([demo.goal])


def _jax_plan(grids, starts, goals, dtype):
    def one(g, s, t):
        d = jastar.cost_to_go(g, t)
        path, valid = jastar.extract_path(d, s, MAXL)
        ref = jastar.path_to_reference(path[:, ::-1].astype(dtype), valid)
        return d, path, valid, ref

    out = jax.jit(jax.vmap(one))(jnp.asarray(grids, dtype), jnp.asarray(starts),
                                 jnp.asarray(goals))
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", ["random16", "demo1", "demo9", "demo10", "demo11",
                                  "enclosed"])
def test_astar_matches_jax(case, dtype):
    grids, starts, goals = _case(case)
    jd, jpath, jvalid, jref = _jax_plan(grids, starts, goals, dtype)

    tdt = getattr(torch, dtype)
    d, relax = astar.cost_to_go_plain(torch.as_tensor(grids).to(tdt), torch.as_tensor(goals))
    assert d.dtype == tdt
    np.testing.assert_array_equal(d.numpy(), jd)
    assert (relax.numpy() >= 1).all()
    assert (relax.numpy() <= astar.default_max_iters(d) + 1).all()
    path, valid = astar.extract_path_plain(d, torch.as_tensor(starts), MAXL)
    np.testing.assert_array_equal(path.numpy(), jpath)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    xy = path.flip(-1).to(tdt)
    ref = astar.path_to_reference(xy, valid)
    np.testing.assert_allclose(ref.numpy(), jref, rtol=0,
                               atol=1e-12 if dtype == "float64" else 1e-6)
    # the dispatchers take the plain versions for CPU tensors
    p2, v2 = astar.plan_grid_path(torch.as_tensor(grids).to(tdt), torch.as_tensor(starts),
                                  torch.as_tensor(goals), MAXL)
    assert torch.equal(p2, path) and torch.equal(v2, valid)
    if case == "enclosed":
        # the walled-in cell keeps its 1e9: a cell's own value is in its
        # minimum, so an unreachable cell never grows, in either dtype
        assert d[0, 5, 20].item() == 1e9
        assert bool((path[0] == torch.tensor([5, 20], dtype=torch.int32)).all())


def test_random_scenarios_match_jax():
    jscn, jshape = jrandom_scenarios(seed=7, batch=16, dtype=jnp.float64)
    scn, shape = random_scenarios(7, 16, dtype=torch.float64, device="cpu")
    assert (shape.n_static, shape.n_dyn, shape.e_max, shape.rows, shape.cols) == (
        jshape.n_static, jshape.n_dyn, jshape.e_max, jshape.rows, jshape.cols)
    assert scn.start.shape[0] == 16
    for f in Scenario._fields:
        np.testing.assert_array_equal(getattr(scn, f).numpy(), np.asarray(getattr(jscn, f)),
                                      err_msg=f)


def test_sweep_inputs_match_jax():
    """``entry.sweep_inputs`` against the JAX package's sweep front-end
    (bench_sweep.py:187-213: per-world start and goal cells, batched A*,
    (x, y) paths, headings, valid lengths), float64."""
    scn, _, p, ref, ref_len = sweep_inputs(16, seed=7, dtype=torch.float64, device="cpu")
    assert p.N_free == p.N_fix == 6
    jscn, _ = jrandom_scenarios(seed=7, batch=16, dtype=jnp.float64)
    _, _, jvalid, jref = _jax_plan(np.asarray(jscn.grid), _cells(jscn.start),
                                   _cells(jscn.goal), "float64")
    assert ref.shape == (16, 3, SWEEP_PATH_LEN)
    np.testing.assert_allclose(ref.numpy(), np.swapaxes(jref, 1, 2), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(ref_len.numpy(), jvalid.sum(1))
    assert (ref_len.numpy() > 1).all()
