"""CPU parity of the port's interior-point solver against the JAX package
at float64: the plain SPD inverses, the iteration state after 1 and 3
iterations, and the entry problem (demo1, N = 6,
IPMOptions(max_iters=60)) solved to the end.

Tolerances: 1e-10 on the inverses (same algorithm, summation order
differs), 1e-9 on the iteration state, 1e-6 on the solution z with equal
iteration counts.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as jentry
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.solver import (
    IPMOptions as JOptions,
    ipm as jipm,
    make_obca_solver as jmake_solver,
)

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
    ENTRY_OPTIONS, demo1_problem,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.interop import (
    from_numpy, to_numpy,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
    IPMOptions, ipm as tipm, make_obca_solver, spd_inv,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _spd_batch(m, count, seed):
    """SPD matrices with a spread of conditioning, plus planted non-SPD."""
    rng = np.random.RandomState(seed)
    M = rng.randn(count, m, m)
    A = M @ M.transpose(0, 2, 1) + np.logspace(-3, 1, count)[:, None, None] * np.eye(m)
    bad = [1, count // 2, count - 2]
    A[bad, m // 3, m // 3] -= 1e3
    return A, bad


@pytest.mark.parametrize("m", [8, 34, 54])
def test_plain_spd_inverse(m):
    A, bad = _spd_batch(m, 12, seed=m)
    jf = jipm._chol_inv_small if m == 8 else jipm._spd_inv
    tf = tipm._chol_inv_small if m == 8 else tipm._spd_inv
    want = np.asarray(jf(jnp.asarray(A)))
    got = tf(torch.as_tensor(A)).numpy()
    nan_w = ~np.isfinite(want).all(axis=(1, 2))
    nan_g = ~np.isfinite(got).all(axis=(1, 2))
    np.testing.assert_array_equal(nan_g, nan_w)
    assert nan_g[bad].all()
    ok = ~nan_w
    scale = np.abs(want[ok]).max()
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=1e-10 * scale)
    # the dispatcher takes the plain version on a CPU tensor
    np.testing.assert_array_equal(spd_inv(torch.as_tensor(A)).numpy(), got)


def test_kernel_wrappers_reject_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA kernel"):
        kernels.spd_inv(torch.eye(8, dtype=torch.float64)[None])


@pytest.mark.parametrize("kkt", ["chol", "al_chol", "arrow"])
def test_other_kkt_families_not_ported(kkt):
    """The AD families, once not ported, build through the AD solver
    (solver/ad.py); build_fused_solver refuses them."""
    spec, _, _, _ = demo1_problem(torch.float64, "cpu")
    solve = make_obca_solver(spec, IPMOptions(kkt=kkt))
    assert solve.family == kkt and solve.layout is None
    with pytest.raises(ValueError, match="build_solver"):
        tipm.build_fused_solver(spec, None, None, None, IPMOptions(kkt=kkt))


@pytest.fixture(scope="module")
def entry_pair():
    jspec, jdata, _, _ = jentry._demo1_problem(jnp.float64)
    jsolve = jmake_solver(jspec, JOptions(max_iters=60))
    jinit = jax.jit(jsolve.init)
    jiter = jax.jit(jsolve.iterate)
    jfin = jax.jit(jsolve.finalize)
    jst0 = jinit(jdata)
    spec, data, _, _ = demo1_problem(torch.float64, "cpu")
    solve = make_obca_solver(spec, ENTRY_OPTIONS)
    return dict(jdata=jdata, jst0=jst0, jiter=jiter, jfin=jfin, data=data,
                solve=solve)


def _np_tree(nt):
    return type(nt)(*[np.asarray(v) for v in nt])


@pytest.mark.parametrize("n_iter", [1, 3])
def test_iterate_state(entry_pair, n_iter):
    e = entry_pair
    jst = e["jiter"](e["jst0"], e["jdata"], n_iter)
    st = e["solve"].iterate(e["solve"].init(e["data"]), e["data"], n_iter)
    want = from_numpy(_np_tree(jst), "cpu")
    for f in st._fields:
        a, b = to_numpy(getattr(st, f)), to_numpy(getattr(want, f))
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9, err_msg=f)


def test_entry_problem(entry_pair):
    e = entry_pair
    jres = e["jfin"](e["jiter"](e["jst0"], e["jdata"], 60), e["jdata"])
    assert int(jres.iters) == 17 and bool(jres.feas)
    res = e["solve"](e["data"])
    assert res.iters.tolist() == [int(jres.iters)]
    assert res.feas.tolist() == [bool(jres.feas)]
    for k in jres.z:
        np.testing.assert_allclose(to_numpy(res.z[k])[0], np.asarray(jres.z[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(res.kkt_err.item(), float(jres.kkt_err), rtol=1e-6)
    np.testing.assert_allclose(res.viol.item(), float(jres.viol), rtol=1e-3,
                               atol=1e-12)
