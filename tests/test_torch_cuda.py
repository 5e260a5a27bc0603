"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: these tests need an NVIDIA GPU with ``nvcc`` and skip
elsewhere (the check is made inside the fixture, never at import). Run on
the card with ``python -m pytest --noconftest tests/test_torch_cuda.py -q``
(``tests/conftest.py`` imports jax, which that machine lacks). Small
problems (demo1, N = 6, three lanes) in float64, tolerance 1e-9
(max-normalised); ``chip_smoke.py`` checks the full-size shapes.
"""

import numpy as np
import pytest
import torch

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
    ENTRY_OPTIONS, demo1_problem,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
    build_obca_data,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
    make_obca_solver,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.ipm import (
    _spd_inv,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _three_lanes(dev):
    spec, data, scn, _ = demo1_problem(torch.float64, dev)
    x0 = torch.stack([scn.start, scn.start + torch.tensor([0.3, 0.1, 0.05], device=dev,
                                                          dtype=torch.float64),
                      scn.start + torch.tensor([-0.2, 0.2, -0.1], device=dev,
                                               dtype=torch.float64)])
    data = build_obca_data(spec, scn, x0=x0, u0=torch.zeros(2), Ts=0.1,
                           xref=data.xref.expand(3, -1, -1))
    return spec, data


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-300)).item()


def test_spd_inv_matches_plain_and_flags_non_spd(dev):
    rng = np.random.RandomState(0)
    for m in (8, 34):
        M = torch.as_tensor(rng.randn(6, m, m), device=dev)
        A = M @ M.transpose(1, 2) + torch.eye(m, device=dev, dtype=torch.float64)
        A[2, 1, 1] = -5.0
        Xk, Xp = kernels.spd_inv(A), _spd_inv(A)
        bad_k = ~torch.isfinite(Xk).flatten(1).all(1)
        bad_p = ~torch.isfinite(Xp).flatten(1).all(1)
        assert bad_k.tolist() == bad_p.tolist() and bad_k[2]
        assert _rel(Xk[~bad_k], Xp[~bad_p]) <= 1e-9


def test_solve_through_kernels_matches_plain(dev):
    spec, data = _three_lanes(dev)
    kernels.reset_launch_counts()
    rk = make_obca_solver(spec, ENTRY_OPTIONS)(data)
    counts = dict(kernels.launches)
    rp = make_obca_solver(spec, ENTRY_OPTIONS, impl="plain")(data)
    assert all(v > 0 for v in counts.values()), counts
    assert rk.iters.tolist() == rp.iters.tolist()
    assert rk.feas.tolist() == rp.feas.tolist()
    for k in rk.z:
        assert (rk.z[k] - rp.z[k]).abs().max().item() <= 1e-6, k


def test_provider_matches_plain(dev):
    spec, data = _three_lanes(dev)
    solve = make_obca_solver(spec, ENTRY_OPTIONS)
    st = make_obca_solver(spec, ENTRY_OPTIONS, impl="plain").init(data)
    L = solve.layout
    w_d = st.w[:, L.m_id:].contiguous()
    y = torch.randn(st.y.shape, dtype=torch.float64, device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    kb = solve.provider(st.zv, data, st.sf, st.scE, st.scD, y, w_d)
    pb = solve.provider.plain(st.zv, data, st.sf, st.scE, st.scD, y, w_d)
    for f in kb._fields:
        assert _rel(getattr(kb, f), getattr(pb, f)) <= 1e-9, f
