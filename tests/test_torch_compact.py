"""The port's chunked solve with lane compaction (solver/compact.py) on the
CPU, float64: tests/test_compact.py's demo9 batch (B = 8, N = 5) solved
by the JAX package's ``jax.vmap`` of one solve (one trace, shared) and by
the port's ``solve_compacted`` gives the same iterations and feasibility,
the primal variables (T, x, u) within 1e-9 and the multipliers (lam,
mu) within the solver's tolerance, 1e-8, and every field of the port's
compacted result equals its monolithic batch solve bit for bit, at
several chunk / bucket settings; a chunk boundary changes nothing; a batch
whose lanes mostly stop at the solver's iteration cap ends (the JAX
package's default cap of 1e9 never counts such a lane done); a bucket is
sized by its distinct active lanes, not their padded copies (a scripted
stand-in solver). The on-card versions are in tests/test_torch_cuda.py."""

from types import SimpleNamespace
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.models import (
    OBCASpec as JSpec, build_obca_data as jbuild, init_vars as jinit,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.runtime import (
    astar_host as jastar,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.runtime.reference import (
    window_reference as jwindow,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.scenarios import (
    build_scenario as jscenario, get_demo as jdemo,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.solver import (
    IPMOptions as JOptions, make_obca_solver as jmake_solver,
)

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.interop import (
    from_numpy,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import OBCASpec
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
    IPMOptions, IPMState, make_obca_solver, solve_compacted,
)

B, N = 8, 5
OPT = dict(max_iters=60, tol=1e-8, acceptable_tol=1e-6, feas_tol=1e-6, n_deltas=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batch():
    """tests/test_compact.py's ``_batch(B=8)`` in both packages, the JAX
    package's vmapped monolithic solve of it (numpy) and the port's."""
    dtype = jnp.float64
    demo = jdemo("demo9")
    scn, shape = jscenario(demo, dtype=dtype)
    jspec = JSpec(N=N, n_obs=shape.n_obs, e_max=shape.e_max, variant="free")
    ref = jastar.reference_path_for(np.asarray(scn.grid), demo.start, demo.goal)
    L = ref.shape[1]
    refj = jnp.asarray(ref, dtype)
    starts = np.sort(np.random.RandomState(3).randint(0, L - 2, size=B))
    x0s = jnp.asarray(ref[:, starts], dtype).T

    def build_one(x0):
        data = jbuild(jspec, scn, x0=x0, u0=jnp.zeros(2, dtype),
                      xref=jwindow(refj, L, x0, N), Ts=0.1)
        return data, jinit(jspec, data)

    jdata, jz0 = jax.jit(jax.vmap(build_one))(x0s)
    jres = jax.jit(jax.vmap(jmake_solver(jspec, JOptions(**OPT))))(jdata, jz0)
    jax_out = {"iters": np.asarray(jres.iters), "feas": np.asarray(jres.feas),
               "z": {k: np.asarray(v) for k, v in jres.z.items()}}
    data = from_numpy(type(jdata)(*[np.asarray(v) for v in jdata]), "cpu")
    z0 = from_numpy({k: np.asarray(v) for k, v in jz0.items()}, "cpu")
    spec = OBCASpec(N=N, n_obs=shape.n_obs, e_max=shape.e_max, variant="free")
    solve = make_obca_solver(spec, IPMOptions(**OPT))
    return spec, data, z0, solve, solve(data, z0), jax_out


def _assert_results_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        if isinstance(x, dict):
            for k in x:
                assert torch.equal(x[k], y[k]), f"z[{k}]"
        else:
            assert torch.equal(x, y), name


@pytest.mark.parametrize("chunk,min_bucket,shrink", [(5, 2, 2), (16, 16, 4), (3, 4, 2)])
def test_compacted_matches_jax_and_monolithic(batch, chunk, min_bucket, shrink):
    _, data, z0, solve, mono, jax_out = batch
    comp, stats = solve_compacted(solve, data, z0, chunk=chunk, min_bucket=min_bucket,
                                  shrink=shrink)
    assert len(set(mono.iters.tolist())) > 1          # lanes finish apart
    _assert_results_equal(comp, mono)
    np.testing.assert_array_equal(comp.iters.numpy(), jax_out["iters"])
    np.testing.assert_array_equal(comp.feas.numpy(), jax_out["feas"])
    zp = np.concatenate([comp.z[k].reshape(B, -1).numpy() for k in sorted(comp.z)], 1)
    zj = np.stack([ravel_pytree({k: v[i] for k, v in jax_out["z"].items()})[0]
                   for i in range(B)])
    primal = np.concatenate([np.full(comp.z[k][0].numel(), k in ("T", "u", "x"))
                             for k in sorted(comp.z)])
    np.testing.assert_allclose(zp[:, primal], zj[:, primal], rtol=1e-9, atol=1e-9)
    # the OBCA multipliers are fixed only to the solver's tolerance: the
    # port's monolithic solve and the JAX package's differ there by up to
    # 2.8e-9 (the compacted solve adds nothing: it equals the port's bits)
    np.testing.assert_allclose(zp[:, ~primal], zj[:, ~primal], rtol=0, atol=OPT["tol"])
    it = mono.iters.numpy()
    assert stats["lane_iters"] == int(it.sum())
    assert stats["dispatched_lane_iters"] <= B * int(it.max()) + B * chunk
    if min_bucket < B:
        assert stats["calls"] > 1
        assert stats["dispatched_lane_iters"] < B * int(it.max())


def test_chunk_boundary_is_invisible(batch):
    """A loop split at any it_cap and resumed lands on the uninterrupted
    run's state bit for bit (tests/test_compact.py:83-103's caps)."""
    spec, data, z0, _, _, _ = batch
    two = type(data)(*[f[:2] for f in data])
    z2 = {k: v[:2] for k, v in z0.items()}
    solve = make_obca_solver(spec, IPMOptions(max_iters=30, tol=1e-10, acceptable_tol=1e-8,
                                              n_deltas=1))
    st = solve.init(two, z2)
    one = solve.iterate(st, two, 30)
    split = st
    for cap in (7, 19, 30):
        split = solve.iterate(split, two, cap)
    for name, a, b in zip(one._fields, one, split):
        assert torch.equal(a, b), name
    assert bool((one.it > 7).all())
    r1, r2 = solve.finalize(one, two), solve.finalize(split, two)
    assert r1.feas.tolist() == r2.feas.tolist()


class _Counted:
    """A solver whose ``iterate`` calls are counted and bounded: a compaction
    that never ends fails here instead of hanging."""

    def __init__(self, solve, limit):
        self.solve, self.limit, self.calls = solve, limit, 0
        self.init, self.finalize, self.options = solve.init, solve.finalize, solve.options

    def iterate(self, st, data, cap):
        self.calls += 1
        assert self.calls <= self.limit, "solve_compacted does not end"
        return self.solve.iterate(st, data, cap)


@pytest.mark.parametrize("max_iters", [None, 10 ** 9])
def test_capped_batch_ends(batch, max_iters):
    """Most lanes stop at the solver's own cap (8 iterations, tolerances
    out of reach) without being done: solve_compacted counts them done at that
    cap and ends, with the monolithic result."""
    spec, data, z0, _, _, _ = batch
    opt = IPMOptions(max_iters=8, tol=1e-14, acceptable_tol=1e-13, feas_tol=1e-6, n_deltas=1)
    solve = make_obca_solver(spec, opt)
    mono = solve(data, z0)
    assert int((mono.iters == 8).sum()) >= 6
    counted = _Counted(solve, limit=20)
    comp, stats = solve_compacted(counted, data, z0, chunk=3, min_bucket=2, shrink=2,
                                  max_iters=max_iters)
    _assert_results_equal(comp, mono)
    assert stats["calls"] == counted.calls <= 4
    assert stats["lane_iters"] == int(mono.iters.sum())


class _Finish(NamedTuple):
    at: torch.Tensor     # (B,) the iteration at which each lane is done


class _Scripted:
    """A stand-in solver whose lanes are done at scripted iterations, to
    follow solve_compacted's bucket sizes alone."""

    options = IPMOptions(max_iters=50)

    def __init__(self):
        self.calls = []

    def init(self, data, z0=None):
        B = data.at.shape[0]
        z = torch.zeros(B)
        return IPMState(*([z] * 6), torch.zeros(B, dtype=torch.int32),
                        torch.zeros(B, dtype=torch.bool), *([z] * 11))

    def iterate(self, st, data, cap):
        self.calls.append((st.it.shape[0], cap))
        it = torch.minimum(torch.maximum(st.it, torch.clamp(data.at, max=cap)),
                           torch.full_like(st.it, cap)).to(torch.int32)
        return st._replace(it=it, done=it >= data.at)

    def finalize(self, st, data):
        return SimpleNamespace(iters=st.it)


def test_bucket_counts_each_active_lane_once():
    """Lanes 0-2 are done at 9-11 iterations, 3-5 at 5, the other ten at 2.
    After 2 iterations the 6 active lanes fill a bucket of 8 with copies of
    lanes 0 and 1; after 5, lanes 0-2 are left (5 entries with the copies)
    and the next bucket holds 4, not 8 as counting the copies would keep."""
    solve = _Scripted()
    at = torch.tensor([9, 10, 11, 5, 5, 5] + [2] * 10, dtype=torch.int32)
    res, stats = solve_compacted(solve, _Finish(at), chunk=1, min_bucket=1, shrink=2)
    assert res.iters.tolist() == at.tolist()
    assert solve.calls[:6] == [(16, 1), (16, 2), (8, 3), (8, 4), (8, 5), (4, 6)]
    assert [b for b, _ in solve.calls][-1] == 1
    assert stats["lane_iters"] == int(at.sum())
