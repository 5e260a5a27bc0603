"""CPU checks of the blocked designs behind two CUDA kernels.

``kkt_qr`` factors each saddle matrix by blocked Householder QR with a
compact-WY trailing update (``kernels/csrc/kkt_qr.cu``), and
``newton_assemble`` forms only the W pieces on the QR rung (``w_only``).
The kernels run only on the card; here:

* ``blocked_kkt_qr`` below, a plain PyTorch twin of the kernel's
  algorithm (panel by panel: the LAPACK-sign reflectors, the panel's T from
  V^T V, the trailing update C -= V T^T V^T C, Q^T applied from the kept
  V and T, back-substitution by blocks, one refinement pass, the
  curvature test), held in float64 against ``kkt_qr_plain`` (1e-9,
  max-normalised: only the order of the Householder arithmetic differs)
  and, through one ``kkt="qr"`` iterate, against the JAX package's (1e-9,
  as ``test_torch_qr.py``), on a real demo1 fix-time replan (order 294),
  for panel widths 8 and 32 (neither divides 294) and with a planted NaN;
* ``newton_assemble_plain(..., w_only=True)`` bit for bit against the W
  pieces of the full call, and one QR iterate through it bit for bit
  against the same iterate through the full assembly;
* the host-side launch arithmetic of both kernels (the assembly's CTAs
  by the spine's order, the QR workspace bytes) at the shapes
  ``chip_smoke.py``'s phase 3 runs.
"""

import numpy as np
import pytest
import torch

from test_torch_qr import JOPT, OPT, _jax_row0

import jax

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.solver import (
    make_obca_solver as jmake_solver,
)

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
    fix_fixture_batch,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.interop import (
    from_numpy, to_numpy,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
    OBCASpec, obca,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
    IPMOptions, make_obca_solver,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
    newton as tnewton,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
    qr as tqr,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------- the kernel's algorithm

def _householder_panel(A, rdiag, k0, w):
    """Factor columns k0 .. k0+w-1 of every A (P, M, M) in place, one
    column at a time; returns the panel's beta (P, w)."""
    beta = A.new_empty(A.shape[0], w)
    for j in range(w):
        k = k0 + j
        col = A[:, k:, k]
        sigma = torch.sqrt((col * col).sum(1))
        alpha = col[:, 0]
        r = torch.where(alpha >= 0, -sigma, sigma)
        zero = sigma == 0
        b = torch.where(zero, torch.zeros_like(sigma), 1.0 / (sigma * (sigma + alpha.abs())))
        v = col.clone()
        v[:, 0] = alpha - r
        A[:, k:, k] = v
        beta[:, j] = b
        rdiag[:, k] = torch.where(zero, alpha, r)
        rest = A[:, k:, k + 1:k0 + w]
        s = b[:, None] * torch.einsum("pi,pic->pc", v, rest)
        A[:, k:, k + 1:k0 + w] = rest - v[:, :, None] * s[:, None, :]
    return beta


def blocked_qr_factor(K, nb):
    """(A, rdiag, Ts) of the kernel's factorization of K (P, M, M): A holds
    R above the diagonal and the reflectors V on and below it, rdiag R's
    diagonal, Ts each panel's (w, w) T with Q = prod (I - V T V^T)."""
    A = K.clone()
    rdiag = A.new_empty(A.shape[:2])
    Ts = []
    for k0 in range(0, A.shape[1], nb):
        w = min(nb, A.shape[1] - k0)
        beta = _householder_panel(A, rdiag, k0, w)
        V = torch.tril(A[:, k0:, k0:k0 + w])
        G = V.transpose(1, 2) @ V
        T = A.new_zeros(A.shape[0], w, w)
        for i in range(w):
            T[:, :i, i] = -beta[:, i, None] * torch.einsum("pab,pb->pa", T[:, :i, :i],
                                                           G[:, :i, i])
            T[:, i, i] = beta[:, i]
        Ts.append(T)
        C = A[:, k0:, k0 + w:]
        A[:, k0:, k0 + w:] = C - V @ (T.transpose(1, 2) @ (V.transpose(1, 2) @ C))
    return A, rdiag, Ts


def _apply_qt(A, Ts, c, nb):
    c = c.clone()
    for p, T in enumerate(Ts):
        k0, w = p * nb, T.shape[-1]
        V = torch.tril(A[:, k0:, k0:k0 + w])
        y = torch.einsum("pij,pi->pj", V, c[:, k0:])
        z = torch.einsum("pab,pa->pb", T, y)
        c[:, k0:] -= torch.einsum("pij,pj->pi", V, z)
    return c


def _back_sub(A, rdiag, c, nb):
    c = c.clone()
    x = torch.zeros_like(c)
    M = A.shape[1]
    for k0 in reversed(range(0, M, nb)):
        w = min(nb, M - k0)
        for k in reversed(range(k0, k0 + w)):
            x[:, k] = c[:, k] / rdiag[:, k]
            c[:, k0:k] -= x[:, k, None] * A[:, k0:k, k]
        c[:, :k0] -= torch.einsum("pij,pj->pi", A[:, :k0, k0:k0 + w], x[:, k0:k0 + w])
    return x


def blocked_kkt_qr(ops, bnd, Wpp, Wpq, Wqq, rhs1, rhs2, ladder, delta_d, nb=None):
    """``kkt_qr_plain``'s function by the kernel's blocked algorithm:
    sol (B, R, n+mE) and good (B, R); ``nb`` defaults to the kernel's
    panel width."""
    B, R = ladder.shape
    n = ops.L.n
    K, W = tqr.saddle_matrix(ops, bnd, Wpp, Wpq, Wqq, ladder, delta_d)
    M = K.shape[-1]
    nb = nb or kernels.QR_NB
    Kf = K.reshape(B * R, M, M)
    A, rdiag, Ts = blocked_qr_factor(Kf, nb)
    rhs = torch.cat([rhs1, rhs2], 1).repeat_interleave(R, 0)
    solve = lambda b: _back_sub(A, rdiag, _apply_qt(A, Ts, b, nb), nb)
    x = solve(rhs)
    x = x - solve(torch.einsum("pij,pj->pi", Kf, x) - rhs)
    sol = x.reshape(B, R, M)
    dz = sol[..., :n]
    curv = torch.einsum("bri,bij,brj->br", dz, W, dz) + ladder * (dz * dz).sum(-1)
    return sol, torch.isfinite(sol).all(-1) & (curv > 0)


# ---------------------------------------------------------------- inputs

def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def _qr_inputs(dtype=torch.float64, rows=(0, 23, 48), n_iter=2):
    """Every input of the QR rung's assembly and solve at the iterate
    after ``n_iter`` QR iterations of fixture rows ``rows`` (fix_terminal,
    order 294), R = 2."""
    spec6, _, data, _ = fix_fixture_batch(dtype=dtype, device="cpu", rows=list(rows))
    solve = make_obca_solver(spec6, OPT)
    st = solve.iterate(solve.init(data), data, n_iter)
    L = solve.layout
    ops = L.ops("cpu", dtype)
    sgn_raw, id_off = obca.ineq_identity_sgn_off(spec6, data)
    sgn_eff = sgn_raw * ops.ds[ops.id_idx]
    bnd = solve.provider(st.zv, data, st.sf, st.scE, st.scD, st.y,
                         st.w[:, L.m_id:].contiguous())
    cI = torch.cat([sgn_eff * st.zv[:, ops.id_idx] + id_off, bnd.cD], 1)
    jeTp, jeTq = ops.f_jeT(bnd, st.y)
    jiTp, jiTq = ops.f_jiT(bnd, st.w, sgn_eff)
    r_d = bnd.g - ops.f_flat(jeTp + jiTp, jeTq + jiTq)
    up, uq = ops.f_jiT(bnd, (st.w * cI - st.mu_b[:, None]) / st.s, sgn_eff)
    ladder = torch.clamp(st.delta, min=OPT.delta0)[:, None] * torch.tensor(
        [1.0, OPT.delta_step], dtype=dtype)
    asm = (ops, bnd, st.w / st.s, sgn_eff, ladder, OPT.delta_d_al)
    return dict(L=L, ops=ops, bnd=bnd, asm=asm, rhs1=-r_d - ops.f_flat(up, uq),
                rhs2=-bnd.cE, ladder=ladder)


@pytest.fixture(scope="module")
def qr_in():
    x = _qr_inputs()
    W = tnewton.newton_assemble_plain(*x["asm"], w_only=True)
    x["args"] = (x["ops"], x["bnd"], *W, x["rhs1"], x["rhs2"], x["ladder"], OPT.delta_d)
    assert x["L"].n + x["L"].mE == 294
    return x


@pytest.fixture(scope="module")
def jax_iterate():
    """The JAX package's state after one kkt="qr" iteration of fixture row
    0 (fix_terminal), and the port's data of the same row."""
    jspec, jdata = _jax_row0("fix_terminal")
    jsolve = jmake_solver(jspec, JOPT)
    jst = jax.jit(jsolve.iterate)(jax.jit(jsolve.init)(jdata), jdata, 1)
    spec6, _, data, _ = fix_fixture_batch(dtype=torch.float64, device="cpu", rows=[0])
    return spec6, data, type(jst)(*[np.asarray(v) for v in jst])


def _port_iterate(spec, data, n_iter=1):
    solve = make_obca_solver(spec, OPT)
    return solve.iterate(solve.init(data), data, n_iter)


def _assert_state_close(st, jst):
    want = from_numpy(jst, "cpu")
    for f in st._fields:
        a, b = to_numpy(getattr(st, f)), to_numpy(getattr(want, f))
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9, err_msg=f)


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("nb", [8, 32])
def test_blocked_qr_twin_matches_plain(qr_in, nb):
    assert 294 % nb != 0
    ks, kg = blocked_kkt_qr(*qr_in["args"], nb=nb)
    ps, pg = tqr.kkt_qr_plain(*qr_in["args"])
    assert kg.tolist() == pg.tolist() and bool(pg.all())
    assert _rel(ks, ps) <= 1e-9


def test_blocked_qr_twin_factors_k(qr_in):
    """Q R = K, with Q from the kept V and T: the factorization itself."""
    K, _ = tqr.saddle_matrix(qr_in["ops"], qr_in["bnd"], *qr_in["args"][2:5],
                             qr_in["ladder"], OPT.delta_d)
    Kf = K.reshape((-1,) + K.shape[2:])
    A, rdiag, Ts = blocked_qr_factor(Kf, 32)
    Rm = torch.triu(A, 1) + torch.diag_embed(rdiag)
    QtK = torch.stack([_apply_qt(A, Ts, Kf[:, :, j], 32) for j in range(Kf.shape[-1])], -1)
    assert _rel(QtK, Rm) <= 1e-12


def test_blocked_qr_twin_rejects_planted_nan(qr_in):
    args = list(qr_in["args"])
    Wbad = args[2].clone()
    Wbad[1, 2, 2] = float("nan")
    args[2] = Wbad
    ks, kg = blocked_kkt_qr(*args, nb=32)
    pg = tqr.kkt_qr_plain(*args)[1]
    assert kg.tolist() == pg.tolist() == [[True, True], [False, False], [True, True]]
    assert not bool(torch.isfinite(ks[1]).any())


def test_blocked_qr_twin_iterate_matches_jax(jax_iterate, monkeypatch):
    """One kkt="qr" iteration with the QR solve done by the twin against
    the JAX package's iteration (its dense QR through jnp.linalg)."""
    spec, data, jst = jax_iterate
    calls = []

    def twin(*args, impl=None):
        calls.append(1)
        return blocked_kkt_qr(*args)

    monkeypatch.setattr(tqr, "kkt_qr", twin)
    _assert_state_close(_port_iterate(spec, data), jst)
    assert calls == [1]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_w_only_assembly_is_the_full_calls_w(dtype):
    x = _qr_inputs(dtype, rows=(0, 30, 60), n_iter=1)
    full = tnewton.newton_assemble_plain(*x["asm"])
    w = tnewton.newton_assemble_plain(*x["asm"], w_only=True)
    assert len(full) == 6 and len(w) == 3
    for a, b in zip(w, full[:3]):
        assert torch.equal(a, b)


def test_qr_iterate_w_only_matches_full_assembly_and_jax(jax_iterate, monkeypatch):
    """The QR rung's iterate through the W-only assembly: bit-equal to the
    same iterate through the full assembly, and within 1e-9 of the JAX
    package's."""
    spec, data, jst = jax_iterate
    modes = []
    orig = tnewton.newton_assemble

    def spy(*args, w_only=False, **kw):
        modes.append(w_only)
        return orig(*args, w_only=w_only, **kw)

    monkeypatch.setattr(tnewton, "newton_assemble", spy)
    st_w = _port_iterate(spec, data, 2)
    assert modes == [True, True]
    monkeypatch.setattr(tnewton, "newton_assemble",
                        lambda *a, w_only=False, **kw: orig(*a, **kw)[:3] if w_only
                        else orig(*a, **kw))
    st_full = _port_iterate(spec, data, 2)
    for name, a, b in zip(st_w._fields, st_w, st_full):
        assert torch.equal(a, b), name
    _assert_state_close(_port_iterate(spec, data, 1), jst)


# (N, variant, spine order np, spine tiles per lane): the fix step and
# the sweep (N = 6), demo8 (15), the open loop's horizon table (40), its
# fix phase (50) and its N = 74 solve
ASSEMBLE_SHAPES = [(6, "fix_terminal", 33, 1), (15, "fix_free_end", 78, 3),
                   (15, "free", 79, 3), (40, "free", 204, 10),
                   (50, "fix_terminal", 253, 10), (74, "free", 374, 21)]


@pytest.mark.parametrize("N,variant,np_,tiles", ASSEMBLE_SHAPES)
def test_assemble_grid(N, variant, np_, tiles):
    L = make_obca_solver(OBCASpec(N=N, n_obs=4, e_max=4, variant=variant),
                         IPMOptions()).layout
    assert L.np_ == np_ and L.K == 4 * N
    small = -(-L.K // kernels.ASM_SMALL_KB)    # CTAs of the (K, bq, bq) pieces
    assert kernels.assemble_ctas_per_lane(L.np_, L.K) == tiles + small
    if N == 74:   # the open loop's 5 lanes: 105 spine tiles, not 5 CTAs
        assert 5 * tiles == 105 and small == 19


@pytest.mark.parametrize("dtype,itemsize", [(torch.float32, 4), (torch.float64, 8)])
@pytest.mark.parametrize("N,variant,M", [(6, "fix_terminal", 294), (15, "fix_free_end", 726),
                                         (15, "free", 730)])
def test_qr_dispatch(N, variant, M, dtype, itemsize):
    L = make_obca_solver(OBCASpec(N=N, n_obs=4, e_max=4, variant=variant),
                         IPMOptions()).layout
    assert L.n + L.mE == M
    nb = kernels.QR_NB
    # the panel kernel's (M x 32) panel and its small arrays fit shared memory
    assert M * nb * itemsize + 20_000 <= kernels.SMEM_MAX
    npan = -(-M // nb)
    elems = kernels.qr_workspace_elems(M)
    assert elems == M * M + npan * nb * nb + M
    if M == 294:   # a sweep rung's 32 matrices and the fix step's 2560
        assert (npan, elems) == (10, 96970)
        assert 32 * elems * itemsize == {4: 12_412_160, 8: 24_824_320}[itemsize]
        assert 2560 * elems * itemsize == {4: 992_972_800, 8: 1_985_945_600}[itemsize]
