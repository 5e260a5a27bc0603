"""CPU checks of the blocked design behind ``spd_inv_blocked``.

The kernel (``kernels/csrc/spd_inv_blocked.cu``) inverts SPD matrices of
order m > 120 as a fixed sequence of launches over a device workspace: per
panel of SPDB_NB = 32 columns a factor of the diagonal block with its
inverse and the panel rows below it, then an update of the trailing lower
triangle by 64 x 64 tiles; then X = L^-1 by column blocks and X^T X by
64 x 64 tiles. It runs only on the card; here ``blocked_spd_inv`` below, a
plain PyTorch twin that takes the same steps over the same workspace
(started as NaN, so that a read of an entry no step wrote shows), is held:

* in float64 against the port's plain ``_spd_inv`` and the JAX package's
  ``_spd_inv`` (max-normalised error <= 1e-10: only the order of the
  sums differs) at the runtime's orders m = 124, 204, 254, 374 (m = 5N + 4,
  never a multiple of 32, so the last panel is partial) and at m = 128;
* on the non-SPD signal: the whole matrix NaN for a non-positive pivot in
  panel 0, a middle panel and the last, partial panel, and for a NaN entry,
  where the plain version is non-finite too;
* in float32 on ``chip_smoke.py``'s ``check_spd_alone`` matrices
  (eigenvalues 1e-2..1, one near 1e-6, one late negative): the backward
  error ||A X - I|| / (||A|| ||X||) <= 1e3 eps that the chip run gates on;
* on the launch arithmetic: ``kernels.spdb_launch_plan`` (the .cu file's
  host loop) and ``kernels.spdb_workspace_elems`` against the twin's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.solver import ipm as jipm

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.ipm import (
    _spd_inv,
)

NB, TILE = kernels.SPDB_NB, kernels.SPDB_TILE


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cdiv(a, b):
    return -(-a // b)


def _tiles(n):
    """(I, J) of the lower-triangular tiles of an n x n tile grid, in the
    kernels' order."""
    return [(i, j) for i in range(n) for j in range(i + 1)]


# ------------------------------------------------- the kernel's algorithm

def _factor_block(D):
    """Lower Cholesky of each (P, NB, NB) block as spdb_panel's warp
    takes it, a lane a row: column j's pivot, the column divided by its
    root, then every later column updated; bad (P,) where a pivot is not
    > 0 (or NaN)."""
    a = D.clone()
    bad = torch.zeros(a.shape[0], dtype=torch.bool)
    for j in range(NB):
        d = a[:, j, j].clone()
        bad |= ~(d > 0)
        piv = torch.sqrt(d)
        col = a[:, :, j] / piv[:, None]
        col[:, :j] = 0
        col[:, j] = piv
        a[:, :, j] = col
        a[:, :, j + 1:] -= col[:, :, None] * col[:, None, j + 1:]
    return torch.tril(a), bad


def _invert_block(Lkk):
    """inv(L_kk) as the same warp forms it, a lane per column: forward
    substitution of the unit vector."""
    X = torch.zeros_like(Lkk)
    eye = torch.eye(NB, dtype=Lkk.dtype)
    for r in range(NB):
        acc = eye[r] - torch.einsum("pl,plc->pc", Lkk[:, r, :r], X[:, :r, :])
        X[:, r, :] = acc / Lkk[:, r, r, None]
    return X


def blocked_spd_inv(A):
    """(inverse, launch plan, workspace elements per matrix) of every SPD
    matrix of A (P, m, m) by the kernel's four steps at its panel width
    (kernels.SPDB_NB, the one constant of both sides); NaN (the whole
    matrix) where a pivot is not > 0."""
    P, m, _ = A.shape
    nan = float("nan")
    npan = _cdiv(m, NB)
    L = torch.full_like(A, nan)                        # the workspace
    X = torch.full_like(A, nan)
    Dinv = torch.full((P, npan, NB, NB), nan, dtype=A.dtype)
    flag = torch.zeros(P, dtype=torch.bool)
    plan = []
    src = A                                            # L from the first update on
    for p in range(npan):
        # spdb_panel: every chunk factors the diagonal block; chunk 0 keeps
        # inv(L_kk) and the flag; each chunk forms its panel rows
        k0 = p * NB
        kb = min(NB, m - k0)
        D = torch.eye(NB, dtype=A.dtype).repeat(P, 1, 1)
        D[:, :kb, :kb] = torch.tril(src[:, k0:k0 + kb, k0:k0 + kb])
        Lkk, bad = _factor_block(D)
        Di = _invert_block(Lkk)
        flag = bad if p == 0 else flag | bad
        Dinv[:, p] = Di                                # L_kk itself is not kept
        L[:, k0 + kb:, k0:k0 + kb] = src[:, k0 + kb:, k0:k0 + kb] @ Di[:, :kb, :kb].mT
        plan.append(("spdb_panel", _cdiv(m - k0, TILE)))
        # spdb_syrk: L[I, J] = src[I, J] - P_I P_J^T on the lower triangle
        r0 = k0 + NB
        if r0 >= m:
            continue
        nt = _cdiv(m - r0, TILE)
        new = L.clone()
        for I, J in _tiles(nt):
            i0, j0 = r0 + I * TILE, r0 + J * TILE
            i1, j1 = min(i0 + TILE, m), min(j0 + TILE, m)
            upd = src[:, i0:i1, j0:j1] - L[:, i0:i1, k0:r0] @ L[:, j0:j1, k0:r0].mT
            low = torch.arange(i0, i1)[:, None] >= torch.arange(j0, j1)[None, :]
            keep = low[None] & ~flag[:, None, None]
            new[:, i0:i1, j0:j1] = torch.where(keep, upd, L[:, i0:i1, j0:j1])
        L = new
        src = L
        plan.append(("spdb_syrk", len(_tiles(nt))))
    # spdb_trtri: X[r, cb] = inv(L_rr) (delta_{r,cb} I - sum_t L[r, t] X[t, cb])
    for cb in range(npan):
        c0 = cb * NB
        cw = min(NB, m - c0)
        X[:, c0:c0 + cw, c0:c0 + cw] = Dinv[:, cb, :cw, :cw]
        for r in range(cb + 1, npan):
            q0 = r * NB
            rw = min(NB, m - q0)
            acc = torch.zeros(P, rw, cw, dtype=A.dtype)
            for t in range(cb, r):
                t0 = t * NB
                acc += L[:, q0:q0 + rw, t0:t0 + NB] @ X[:, t0:t0 + NB, c0:c0 + cw]
            X[:, q0:q0 + rw, c0:c0 + cw] = Dinv[:, r, :rw, :rw] @ -acc
    plan.append(("spdb_trtri", npan))
    # spdb_lauum: out[I, J] = sum_{k >= I's first row} X[k, I]^T X[k, J],
    # X's upper triangle read as 0; NaN where the flag is set
    out = torch.full_like(A, nan)
    nt = _cdiv(m, TILE)
    rows = torch.arange(m)
    for I, J in _tiles(nt):
        i0, j0 = I * TILE, J * TILE
        i1, j1 = min(i0 + TILE, m), min(j0 + TILE, m)
        Xk = X[:, i0:, :]
        low = rows[i0:, None] >= rows[None, :]
        Xi = torch.where(low[:, i0:i1], Xk[:, :, i0:i1], 0.0)
        Xj = torch.where(low[:, j0:j1], Xk[:, :, j0:j1], 0.0)
        acc = Xi.mT @ Xj
        acc = torch.where(flag[:, None, None], nan, acc)
        out[:, i0:i1, j0:j1] = acc
        out[:, j0:j1, i0:i1] = acc.mT
    plan.append(("spdb_lauum", len(_tiles(nt))))
    elems = L[0].numel() + X[0].numel() + Dinv[0].numel() + 1   # + the flag
    return out, plan, elems


# ---------------------------------------------------------------- inputs

def _spd(m, count, seed, dtype=np.float64):
    """``count`` SPD matrices of order m, eigenvalues 1e-2..1 in a random
    basis (chip_smoke.py check_spd_alone's)."""
    rng = np.random.RandomState(seed)
    Q, _ = np.linalg.qr(rng.randn(count, m, m))
    lam = 10.0 ** rng.uniform(-2, 0, (count, m))
    return np.einsum("bij,bj,bkj->bik", Q, lam, Q).astype(dtype)


def _plant_pivot(A, i):
    """A copy of A (m, m) whose Cholesky pivot i is -1 (pivots < i keep)."""
    Lc = np.linalg.cholesky(A[:i + 1, :i + 1])
    B = A.copy()
    B[i, i] -= Lc[i, i] ** 2 + 1.0
    return B


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


# ------------------------------------------------------------------ tests

ORDERS = [124, 128, 204, 254, 374]


@pytest.mark.parametrize("m", ORDERS)
def test_twin_matches_plain_and_jax(m):
    A = _spd(m, 3, seed=m)
    X, plan, elems = blocked_spd_inv(torch.as_tensor(A))
    X = X.numpy()
    Xp = _spd_inv(torch.as_tensor(A)).numpy()
    Xj = np.asarray(jipm._spd_inv(jnp.asarray(A)))
    assert np.isfinite(X).all()
    assert _rel(X, Xp) <= 1e-10
    assert _rel(X, Xj) <= 1e-10
    np.testing.assert_allclose(A @ X, np.broadcast_to(np.eye(m), A.shape), atol=1e-10)
    assert plan == kernels.spdb_launch_plan(m)
    assert elems == kernels.spdb_workspace_elems(m)


@pytest.mark.parametrize("m", [204, 374])
@pytest.mark.parametrize("where", ["panel 0", "middle panel", "last panel", "nan entry"])
def test_twin_nans_the_whole_non_spd_matrix(m, where):
    A = _spd(m, 3, seed=m + 1)
    npan = _cdiv(m, NB)
    if where == "nan entry":
        i, j = m - 7, 40
        A[1, i, j] = A[1, j, i] = np.nan
    else:
        i = {"panel 0": 5, "middle panel": (npan // 2) * NB + 9, "last panel": m - 3}[where]
        A[1] = _plant_pivot(A[1], i)
        if where == "last panel":
            assert i // NB == npan - 1 and m % NB != 0
    X = blocked_spd_inv(torch.as_tensor(A))[0].numpy()
    Xp = _spd_inv(torch.as_tensor(A)).numpy()
    assert np.isnan(X[1]).all()
    assert not np.isfinite(Xp[1]).all()
    assert np.isfinite(X[[0, 2]]).all()
    assert _rel(X[[0, 2]], Xp[[0, 2]]) <= 1e-10


@pytest.mark.parametrize("m", [124, 204, 254, 374])
def test_twin_float32_backward_error(m):
    """chip_smoke.py's gate on the kernel, ||A X - I|| / (||A|| ||X||) <=
    1e3 eps, held by the twin in float32 on check_spd_alone's matrices."""
    rng = np.random.RandomState(m)
    Q, _ = np.linalg.qr(rng.randn(10, m, m))
    lam = 10.0 ** rng.uniform(-2, 0, (10, m))
    lam[3, 0], lam[8, 0] = 1e-6, -1e-3
    A = np.einsum("bij,bj,bkj->bik", Q, lam, Q)
    A[5, 0, 0] = -1.0
    A32 = torch.as_tensor(A).float()
    X = blocked_spd_inv(A32)[0].double()
    nan = ~torch.isfinite(X).flatten(1).all(1)
    assert nan[5] and nan[8]
    assert bool((torch.isfinite(X).flatten(1).any(1) == ~nan).all())   # all or nothing
    good = ~nan
    R = A32.double()[good] @ X[good] - torch.eye(m, dtype=torch.float64)
    nrm = lambda M: M.abs().sum(-1).amax(-1)
    eta = nrm(R) / (nrm(A32.double()[good]) * nrm(X[good]))
    assert eta.max().item() <= 1e3 * torch.finfo(torch.float32).eps


@pytest.mark.parametrize("m", [121, 124, 204, 254, 374, 1000])
def test_launch_plan_arithmetic(m):
    plan = kernels.spdb_launch_plan(m)
    npan = _cdiv(m, NB)
    names = [k for k, _ in plan]
    # a panel launch each, an update after every panel but the last (no
    # trailing matrix there), the inverse and the product: 2 npan + 1
    assert len(plan) == 2 * npan + 1
    assert names.count("spdb_panel") == npan and names.count("spdb_syrk") == npan - 1
    assert names[-2:] == ["spdb_trtri", "spdb_lauum"] and plan[-2][1] == npan
    nt = _cdiv(m, TILE)
    assert plan[-1][1] == nt * (nt + 1) // 2
    assert plan[0] == ("spdb_panel", nt)
    assert kernels.spdb_workspace_elems(m) == 2 * m * m + npan * NB * NB + 1
    if m == 374:   # the open loop's 5 candidates x R = 2: 10 matrices
        assert npan == 12 and len(plan) == 25
        assert plan[1] == ("spdb_syrk", 21) and 10 * plan[1][1] >= 100
        assert plan[-1] == ("spdb_lauum", 21)
        assert kernels.spdb_workspace_elems(374) * 8 == 2_336_328   # float64, in L2
