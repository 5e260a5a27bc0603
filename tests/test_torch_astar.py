"""CPU parity of the port's wavefront A* and random scenario generator
with the JAX package.

The same grids, starts and goals go through the JAX package's
``ops/astar.py`` (vmapped, as ``bench_sweep.py`` runs it) and the port's
plain versions, in float32 and float64: the 16 worlds of
``random_scenarios(seed=7)`` (the population of ``test_scan_loop.py``),
the demo1, demo9, demo10 and demo11 grids, a map with an enclosed free
cell, an all-free 11 x 40 grid with starts spread over it ("open") and a
21 x 21 serpentine maze whose corridor is longer than the default cap
("serpentine"), and the random and demo10 grids at explicit caps of 0, 1
and 7 relaxations. The cost field, the path and its ``valid`` mask must
be equal (both sides do the same float additions and exact minima); the
reference with headings agrees within 1e-12 in float64 and 1e-6 in
float32 (the two libraries' ``atan2`` differ in the last bit in float32).
``kernels.astar_route`` / ``astar_walk``, the kernels' launch plans, are
held to the shapes the sweep and the demos give them.
"""

import functools
import os
import sys

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

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
    SWEEP_PATH_LEN, sweep_inputs,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.ops import astar
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
    Scenario, random_scenarios,
)

MAXL = 64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402  (phase 3's serpentine maze)


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


# starts spread over the all-free 11 x 40 grid, the goal cell among them
_OPEN_STARTS = [[10, 39], [0, 39], [10, 0], [5, 20], [3, 7], [8, 33], [10, 20], [0, 0]]


@functools.lru_cache(maxsize=None)
def _case(name):
    """(grids (B, R, C), starts (B, 2), goals (B, 2)) as numpy; cached, so
    read-only."""
    if name == "open":
        B = len(_OPEN_STARTS)
        return (np.zeros((B, 11, 40)), np.asarray(_OPEN_STARTS, np.int32),
                np.zeros((B, 2), np.int32))
    if name == "serpentine":
        starts = np.asarray([[20, 0], [20, 20], [10, 10], [0, 20]], np.int32)
        return (np.repeat(np.asarray(cs.serpentine_grid())[None], len(starts), 0), starts,
                np.zeros((len(starts), 2), np.int32))
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


def _capped(g, s, t, cap):
    d = jastar.cost_to_go(g, t, max_iters=cap)
    return (d, *jastar.extract_path(d, s, MAXL))


# one trace per grid shape and dtype, the cap a traced argument
_jax_capped = jax.jit(jax.vmap(_capped, in_axes=(0, 0, 0, None)))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", ["random16", "demo1", "demo9", "demo10", "demo11",
                                  "enclosed", "open", "serpentine"])
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
    if case == "serpentine":
        # the cap binds on every map: the far end of the corridor is still
        # unreached (1e9) though free and connected
        assert (relax.numpy() == astar.default_max_iters(d) + 1).all()
        assert d[0, 20, 0].item() == 1e9 and grids[0, 20, 0] == 0.0
    if case == "open":
        assert (relax.numpy() < astar.default_max_iters(d) + 1).all()
        assert bool(valid[-1, 0]) and not bool(valid[-1, 1:].any())   # start == goal


@pytest.mark.parametrize("cap", [0, 1, 7])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", ["random16", "demo10"])
def test_astar_caps_match_jax(case, dtype, cap):
    """An explicit cap of max_iters further relaxations: the field, the walk
    through it and the relaxation counts (cap + 1 wherever the field has not
    converged)."""
    grids, starts, goals = _case(case)
    jd, jpath, jvalid = [np.asarray(o) for o in _jax_capped(
        jnp.asarray(grids, dtype), jnp.asarray(starts), jnp.asarray(goals), cap)]
    d, relax = astar.cost_to_go_plain(torch.as_tensor(grids).to(getattr(torch, dtype)),
                                      torch.as_tensor(goals), cap)
    np.testing.assert_array_equal(d.numpy(), jd)
    assert (relax.numpy() == cap + 1).all()   # none of these grids converges in 8
    path, valid = astar.extract_path_plain(d, torch.as_tensor(starts), MAXL)
    np.testing.assert_array_equal(path.numpy(), jpath)
    np.testing.assert_array_equal(valid.numpy(), jvalid)


def _cta_max_cells(dtype):
    """The most cells the CTA route holds: two buffers and a byte mask in
    the shared memory a block may use."""
    return kernels.SMEM_MAX // (2 * torch.empty((), dtype=dtype).element_size() + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_astar_route(dtype):
    """The launch plans of kernels/csrc/astar_wavefront.cu as the wrappers
    mirror them: the sweep's 1024 maps of 11 x 40 take the warp route in one
    wave of CTAs; the demo9 and demo10 single maps and the sweep's first 2
    maps a CTA a map; every plan within the shared memory a block may use;
    every grid the CTA route holds accepted."""
    e = torch.empty((), dtype=dtype).element_size()
    sweep = kernels.astar_route(1024, 11, 40, dtype)
    # two buffers of 3 x 4 + 2 rows (the border, one row below the map) x
    # 40 + 3 columns
    assert sweep == kernels.AstarRoute("warp", kernels.ASTAR_MAX_WARPS,
                                       32 * kernels.ASTAR_MAX_WARPS,
                                       kernels.ASTAR_MAX_WARPS * 2 * 14 * 43 * e, 4)
    assert -(-1024 // sweep.per_cta) <= kernels.ASTAR_SMS   # one wave
    walk = kernels.astar_walk(1024, 11, 40, dtype)
    assert walk == kernels.AstarWalk(8, 256, 8 * 11 * 40 * e)
    assert kernels.astar_route(2, 11, 40, dtype).route == "cta"
    for name in ("demo9", "demo10"):
        _, R, C = _case(name)[0].shape
        r = kernels.astar_route(1, R, C, dtype)
        assert r == kernels.AstarRoute("cta", 1, 1024, 2 * R * C * e + R * C, 0), name
        assert kernels.astar_walk(1, R, C, dtype).per_cta == 1
    # demo9's grid tiled over the sweep's 1024 maps stays on the warp route
    assert kernels.astar_route(1024, 61, 41, dtype).route == "warp"
    # seg_h minimises rounds of 32 column segments x (h + 2) rows loaded,
    # at most ASTAR_MAX_ROUNDS rounds (a lane's segments); none above
    # 32 x ASTAR_MAX_ROUNDS columns, where the CTA route runs
    for R, C in ((11, 40), (61, 41), (21, 21), (1, 5), (40, 3), (8, 250), (3, 300)):
        h = kernels.astar_seg_height(R, C)
        rounds = lambda h: -(-(C * -(-R // h)) // 32)
        ok = [k for k in range(1, R + 1) if rounds(k) <= kernels.ASTAR_MAX_ROUNDS]
        cost = lambda h: rounds(h) * (h + 2)
        if not ok:
            assert h == 0 and kernels.astar_route(1024, R, C, dtype).route == "cta"
            continue
        assert h in ok and kernels.astar_seg_rounds(R, C, h) == rounds(h), (R, C)
        assert all(cost(h) < cost(k) for k in ok if k < h), (R, C)
        assert all(cost(h) <= cost(k) for k in ok if k > h), (R, C)
    n = _cta_max_cells(dtype)
    side = int(n ** 0.5)
    shapes = [(11, 40), (61, 41), (11, 100), (21, 21), (1, n), (n, 1), (side, n // side),
              (85, 85), (1, 1)]
    for B in (1, 2, 131, 132, 1024, 100000):
        for R, C in shapes:
            r, w = kernels.astar_route(B, R, C, dtype), kernels.astar_walk(B, R, C, dtype)
            assert r.smem <= kernels.SMEM_MAX and w.smem <= kernels.SMEM_MAX, (B, R, C)
            h = kernels.astar_seg_height(R, C)
            rows = -(-R // h) * h + 2 if h else 0
            assert r.route == ("warp" if B >= kernels.ASTAR_WARP_MIN_MAPS
                               and C <= 32 * kernels.ASTAR_MAX_ROUNDS
                               and 2 * rows * (C + 3) * e <= kernels.ASTAR_WARP_SMEM
                               else "cta"), (B, R, C)
            assert 1 <= r.per_cta <= kernels.ASTAR_MAX_WARPS and r.threads <= 1024
            assert 1 <= w.per_cta <= kernels.ASTAR_MAX_WARPS and w.threads == 32 * w.per_cta
    with pytest.raises(ValueError):   # neither route holds this grid
        kernels.astar_route(1, 1, n + 1, dtype)


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
