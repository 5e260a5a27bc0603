"""CPU checks of the design behind ``spd_inv`` (orders m <= 120).

The kernel (``kernels/csrc/spd_inv.cu``) inverts SPD matrices in place by
LAPACK potri's order: a Cholesky by columns (Crout), X = L^-1 by rows, then
B = X^T X, NaN over the whole matrix where a pivot is not > 0 or not
finite. It takes one of two routes (``kernels.spd_inv_route``): up to
m = 16 a thread a matrix in registers, one column or row a step; above, a
warp a matrix in shared memory, kernels.SPD_NB columns or rows a step, X
kept transposed in the upper triangle, rows of L zeroed once used so that
every dot product runs over an aligned range, and B written with its
mirror. It runs only on the card; here ``twin_spd_inv`` below, a plain
PyTorch twin that takes the same steps in one (m, m) array a matrix
(whose upper triangle starts as NaN, so that a read of an entry no step
wrote shows), is held:

* in float64 against the port's plain ``_spd_inv`` and the JAX package's
  ``_chol_inv_small`` (m <= 16) or ``_spd_inv`` (max-normalised error <=
  1e-10: only the order of the sums differs) at m = 1, 2, 8, 16, 17, 33,
  54, 79 (m = 120 against the port's alone);
* on the non-SPD signal: the whole matrix NaN for a non-positive pivot in
  the first, a middle and the last column and for a NaN entry, at m = 8
  and m = 54, where the plain version is non-finite too;
* in float32 on ``chip_smoke.py``'s ``check_spd_alone`` matrices: the
  backward error ||A X - I|| / (||A|| ||X||) <= 1e3 eps the chip run
  gates on;
* on the launch arithmetic: ``kernels.spd_inv_route`` at m = 1-120 in
  both dtypes (the .cu file's host code in Python).
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

SMEM_MAX = 227 * 1024


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------- the kernel's algorithm

def _bad_pivot(d):
    return ~(d > 0) | torch.isinf(d)


def twin_spd_inv(A):
    """Inverse of every SPD matrix of A (P, m, m) by the kernel's steps at
    its route's step width (1 up to kernels.SPD_SMALL_M, else
    kernels.SPD_NB); NaN (the whole matrix) where a pivot is bad."""
    P, m, _ = A.shape
    nb = 1 if kernels.spd_inv_route(m, A.dtype).route == "thread" else kernels.SPD_NB
    low = torch.ones(m, m, dtype=torch.bool).tril()
    S = torch.where(low, A, torch.full_like(A, float("nan")))
    bad = torch.zeros(P, dtype=torch.bool)
    # Cholesky by columns: the sums over k < j0 in one pass, then the
    # step's columns one at a time
    for j0 in range(0, m, nb):
        j1 = min(j0 + nb, m)
        v = S[:, j0:, j0:j1] - S[:, j0:, :j0] @ S[:, j0:j1, :j0].mT   # rows >= j0
        for c in range(j1 - j0):
            j = j0 + c
            d = v[:, c, c].clone()
            bad |= _bad_pivot(d)
            p = torch.sqrt(d)
            col = v[:, :, c] / p[:, None]
            col[:, c] = p
            S[:, j:, j] = col[:, c:]
            if c + 1 < j1 - j0:
                v[:, :, c + 1:] -= col[:, :, None] * col[:, None, c + 1:j1 - j0]
    # X = L^-1 by rows, transposed into the upper triangle; rows of L
    # zeroed once their step is done
    for i0 in range(0, m, nb):
        i1 = min(i0 + nb, m)
        acc = S[:, i0:i1, :i0] @ S[:, :i1, :i0].mT   # (P, rows i, lanes k)
        acc[:, :, i0:] = 0.0                          # rows k >= i0: x_lk = 0, l < i0
        r = 1.0 / torch.diagonal(S[:, i0:i1, i0:i1], dim1=1, dim2=2)
        x = torch.zeros(P, i1 - i0, i1, dtype=A.dtype)
        for c in range(i1 - i0):
            i = i0 + c
            t = acc[:, c, :i] + torch.einsum("pc,pck->pk", S[:, i, i0:i], x[:, :c, :i])
            x[:, c, :i] = -t * r[:, c, None]
            x[:, c, i] = r[:, c]
        for c in range(i1 - i0):
            i = i0 + c
            S[:, :i + 1, i] = x[:, c, :i + 1]
            S[:, i, :i] = 0.0
    # B = X^T X from column i0 on, written with its mirror
    for i0 in range(0, m, nb):
        i1 = min(i0 + nb, m)
        acc = S[:, i0:i1, i0:] @ S[:, :i1, i0:].mT   # (P, rows i, lanes j)
        for c in range(i1 - i0):
            i = i0 + c
            S[:, i, :i + 1] = acc[:, c, :i + 1]
            S[:, :i + 1, i] = acc[:, c, :i + 1]
    return torch.where(bad[:, None, None], torch.full_like(S, float("nan")), S)


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
    B = A.copy()
    if i == 0:
        B[0, 0] = -1.0
        return B
    Lc = np.linalg.cholesky(A[:i + 1, :i + 1])
    B[i, i] -= Lc[i, i] ** 2 + 1.0
    return B


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _jax_inv(A):
    fn = jipm._chol_inv_small if A.shape[-1] <= kernels.SPD_SMALL_M else jipm._spd_inv
    return np.asarray(fn(jnp.asarray(A)))


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("m", [1, 2, 8, 16, 17, 33, 54, 79, 120])
def test_twin_matches_plain_and_jax(m):
    A = _spd(m, 4, seed=m)
    X = twin_spd_inv(torch.as_tensor(A)).numpy()
    Xp = _spd_inv(torch.as_tensor(A)).numpy()
    assert np.isfinite(X).all()
    assert _rel(X, Xp) <= 1e-10
    if m < 120:   # the JAX recursion at m = 120 only costs compile time
        assert _rel(X, _jax_inv(A)) <= 1e-10
    np.testing.assert_allclose(A @ X, np.broadcast_to(np.eye(m), A.shape), atol=1e-10)


@pytest.mark.parametrize("m", [8, 54])
@pytest.mark.parametrize("where", ["first column", "middle column", "last column", "nan entry"])
def test_twin_nans_the_whole_non_spd_matrix(m, where):
    A = _spd(m, 3, seed=m + 1)
    if where == "nan entry":
        A[1, m - 2, 1] = A[1, 1, m - 2] = np.nan
    else:
        A[1] = _plant_pivot(A[1], {"first column": 0, "middle column": m // 2,
                                   "last column": m - 1}[where])
    X = twin_spd_inv(torch.as_tensor(A)).numpy()
    Xp = _spd_inv(torch.as_tensor(A)).numpy()
    assert np.isnan(X[1]).all()
    assert not np.isfinite(Xp[1]).all()
    assert np.isfinite(X[[0, 2]]).all()
    assert _rel(X[[0, 2]], Xp[[0, 2]]) <= 1e-10


@pytest.mark.parametrize("m", [8, 16, 33, 79])
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
    X = twin_spd_inv(A32).double()
    nan = ~torch.isfinite(X).flatten(1).all(1)
    assert nan[5] and nan[8]
    assert bool((torch.isfinite(X).flatten(1).any(1) == ~nan).all())   # all or nothing
    good = ~nan
    R = A32.double()[good] @ X[good] - torch.eye(m, dtype=torch.float64)
    nrm = lambda M: M.abs().sum(-1).amax(-1)
    eta = nrm(R) / (nrm(A32.double()[good]) * nrm(X[good]))
    assert eta.max().item() <= 1e3 * torch.finfo(torch.float32).eps


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_route_arithmetic(dtype):
    e = torch.empty((), dtype=dtype).element_size()
    routes = {m: kernels.spd_inv_route(m, dtype) for m in range(1, kernels.SPD_INV_MAX_M + 1)}
    for m, r in routes.items():
        assert r.route == ("thread" if m <= kernels.SPD_SMALL_M else "warp")
        assert 0 < r.smem <= SMEM_MAX
        if r.route == "thread":   # a thread a matrix over an entry-major stage
            assert r.threads == r.per_cta and r.per_cta & (r.per_cta - 1) == 0
            assert r.smem == m * m * (r.per_cta + 1) * e <= kernels.SPD_SMALL_STAGE
            assert (r.per_cta == kernels.SPD_SMALL_MAX_P
                    or m * m * (2 * r.per_cta + 1) * e > kernels.SPD_SMALL_STAGE)
        else:                     # a warp a matrix, rows of an odd number of vectors
            ld = kernels.spd_warp_stride(m, dtype)
            assert ld >= m and (ld * e) % 16 == 0 and (ld * e // 16) % 2 == 1
            assert r.threads == 32 * r.per_cta and r.smem == r.per_cta * m * ld * e
            assert 1 <= r.per_cta <= kernels.SPD_WARP_MAX_W
    assert routes[16].route == "thread" and routes[17].route == "warp"
    # the runtime's orders: the dual blocks and the fix fixture's spine
    assert routes[8] == (("thread", 128, 128, 33024) if e == 4 else ("thread", 64, 64, 33280))
    assert routes[33] == ("warp", 2, 64, 2 * 33 * (36 if e == 4 else 34) * e)
    assert routes[120].per_cta == 1
    with pytest.raises(ValueError):
        kernels.spd_inv_route(kernels.SPD_INV_MAX_M + 1, dtype)
