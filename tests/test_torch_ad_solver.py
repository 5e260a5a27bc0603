"""CPU parity of the port's AD solver (solver/ad.py build_solver) against the
JAX package's build_solver, at float64.

* the tiny NLP of the JAX package's tests/test_solver.py:32 through both
  packages' build_solver and scipy's SLSQP: same iterations, z within
  1e-10 of the JAX package's and 1e-5 of SLSQP's;
* demo1's window (N = 6, IPMOptions(max_iters=60)) through kkt="arrow"
  (the structured path, grouped spine probes) and "al_chol", one traced
  JAX solver a family shared by the cases: same iterations and
  feasibility, z within 1e-8;
* models.obca.hessian_spine_probes for the five variants at N = 5 and
  10: every array equal; signed_clearance within 1e-12;
* solver.solve_compacted over the port's arrow solver: every lane's
  iterations and result equal to its monolithic solve.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as jentry
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.models import (
    obca as jobca,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.solver import (
    IPMOptions as JOptions,
    build_solver as jbuild_solver,
    make_obca_solver as jmake_solver,
)

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
    BENCH_FREE_OPTIONS, demo1_problem, demo9_window_batch,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.interop import (
    from_numpy, to_numpy,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
    OBCASpec, hessian_spine_probes, init_vars, signed_clearance,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
    IPMOptions, build_solver, make_obca_solver, solve_compacted,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

F64 = torch.float64


def test_tiny_nlp_matches_jax_and_slsqp():
    from scipy.optimize import minimize

    jres = jbuild_solver(
        lambda z, p: (z["x"] - 2.0) ** 2 + (z["y"] - 1.0) ** 2,
        lambda z, p: jnp.stack([z["x"] + z["y"] - 2.0]),
        lambda z, p: jnp.stack([z["x"] - 0.5, z["y"] - z["x"] ** 2 + 1.0]),
        {"x": jnp.asarray(0.0), "y": jnp.asarray(0.0)},
    )({"x": jnp.asarray(0.0), "y": jnp.asarray(0.0)}, None)
    z0 = {"x": np.zeros(()), "y": np.zeros(())}
    solve = build_solver(
        lambda z, p: (z["x"] - 2.0) ** 2 + (z["y"] - 1.0) ** 2,
        lambda z, p: torch.stack([z["x"] + z["y"] - 2.0]),
        lambda z, p: torch.stack([z["x"] - 0.5, z["y"] - z["x"] ** 2 + 1.0]),
        z0)
    assert solve.family == "al_chol"     # no arrow declared: the dense fallback
    res = solve(from_numpy(z0, "cpu", F64, batch=True), None)
    assert bool(res.converged[0]) and int(res.iters[0]) == int(jres.iters)
    for k in ("x", "y"):
        assert abs(res.z[k].item() - float(jres.z[k])) <= 1e-10
    ref = minimize(lambda v: (v[0] - 2) ** 2 + (v[1] - 1) ** 2, [0, 0], method="SLSQP",
                   constraints=[{"type": "eq", "fun": lambda v: v[0] + v[1] - 2},
                                {"type": "ineq",
                                 "fun": lambda v: np.array([v[0] - 0.5, v[1] - v[0] ** 2 + 1])}])
    np.testing.assert_allclose([res.z["x"].item(), res.z["y"].item()], ref.x, atol=1e-5)


def test_graph_loop_static_params():
    """A Python scalar in ``params`` (the tiny NLP's target x) through the
    graph loop's control code on the CPU: two values give two answers,
    each bit-equal to the host loop's; a leaf that is neither a tensor nor
    hashable is refused on the graph loop."""
    z0 = {"x": np.zeros(()), "y": np.zeros(())}
    fns = (lambda z, p: (z["x"] - p["x"]) ** 2 + (z["y"] - 1.0) ** 2,
           lambda z, p: torch.stack([z["x"] + z["y"] - p["x"]]),
           lambda z, p: torch.stack([z["x"] - 0.5, z["y"] - z["x"] ** 2 + 1.0]))
    graph = build_solver(*fns, z0, loop="graph")
    host = build_solver(*fns, z0, loop="host")
    zb = from_numpy(z0, "cpu", F64, batch=True)
    out = []
    for x in (2.0, 3.0):
        rg, rh = graph(zb, {"x": x}), host(zb, {"x": x})
        assert bool(rg.converged[0]) and torch.equal(rg.iters, rh.iters)
        for k in z0:
            assert torch.equal(rg.z[k], rh.z[k])
        out.append(rg.z["x"].item())
    assert abs(out[1] - out[0]) > 0.1
    with pytest.raises(TypeError, match="hashable"):
        graph(zb, {"x": 2.0, "w": np.ones(1)})


@pytest.fixture(scope="module")
def demo1():
    jspec, jdata, _, _ = jentry._demo1_problem(jnp.float64)
    spec, data, _, _ = demo1_problem(F64, "cpu")
    return jspec, jdata, spec, data


@pytest.mark.parametrize("kkt", ["arrow", "al_chol"])
def test_demo1_window_matches_jax(demo1, kkt):
    jspec, jdata, spec, data = demo1
    jres = jax.jit(jmake_solver(jspec, JOptions(max_iters=60, kkt=kkt)))(jdata)
    solve = make_obca_solver(spec, IPMOptions(max_iters=60, kkt=kkt))
    assert solve.family == kkt and solve.loop_of(data.x0) == "host"
    res = solve(data)
    assert int(res.iters[0]) == int(jres.iters)
    assert bool(res.feas[0]) == bool(jres.feas) is True
    for k, v in res.z.items():
        np.testing.assert_allclose(v[0].numpy(), np.asarray(jres.z[k]), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.f[0].item(), float(jres.f), rtol=1e-10)


@pytest.mark.parametrize("N", [5, 10])
@pytest.mark.parametrize("variant", ["free", "fix_terminal", "fix_free_end", "fix_eq_band",
                                     "coupled"])
def test_hessian_spine_probes_equal_jax(N, variant):
    kw = dict(N=N, n_obs=3, e_max=4, variant="free" if variant == "coupled" else variant,
              coupled_motion=variant == "coupled")
    want = jobca.hessian_spine_probes(jobca.OBCASpec(**kw))
    got = hessian_spine_probes(OBCASpec(**kw))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_signed_clearance_matches_jax(demo1):
    jspec, jdata, spec, data = demo1
    jz = jobca.init_vars(jspec, jdata)
    z = from_numpy({k: np.asarray(v) for k, v in jz.items()}, "cpu")
    want = np.asarray(jobca.signed_clearance(jspec, jdata, jz))
    got = signed_clearance(spec, data, z)
    assert got.shape == (1,) + want.shape
    np.testing.assert_allclose(to_numpy(got)[0], want, rtol=0, atol=1e-12)


def test_compacted_arrow_solve_matches_monolithic():
    spec, data, _, _ = demo9_window_batch(8, N=5, dtype=F64, device="cpu")
    solve = make_obca_solver(spec, dataclasses.replace(BENCH_FREE_OPTIONS, kkt="arrow"))
    mono = solve(data)
    res, stats = solve_compacted(solve, data, chunk=3, min_bucket=2, shrink=2)
    assert stats["calls"] > 1
    assert torch.equal(res.iters, mono.iters) and torch.equal(res.feas, mono.feas)
    for k in mono.z:
        assert torch.equal(res.z[k], mono.z[k]), k
    assert torch.equal(res.kkt_err, mono.kkt_err)
    z0 = init_vars(spec, data)
    assert torch.equal(solve(data, z0).z["x"], mono.z["x"])
