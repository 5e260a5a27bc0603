"""The QR rescue solve of the full saddle system (``kkt="qr"``).

Counterpart of the JAX package's ``solver/ipm.py:1341-1360``
``kkt_solve_qr``: for every regularization rung delta, a Householder QR
of the (n+mE)^2 saddle matrix

    K = [[W + delta*I, JE^T], [JE, -delta_d*I]]     (flat z order)

then ``sol = R^-1 Q^T rhs``, one refinement ``sol -= R^-1 Q^T (K sol -
rhs)`` and the directional-curvature test ``dz^T W dz + delta dz^T dz >
0``. It handles an indefinite W, where the fused path's Cholesky rungs
all fail. W comes from :func:`.newton.newton_assemble` in arrow form (the
Lagrangian Hessian has no cross-block terms, so it is the JAX package's
dense ``H + JD^T Sigma JD + diag``), JE from the provider's pieces.

The plain PyTorch version sits beside a dispatcher that launches
``kernels/csrc/kkt_qr.cu`` on CUDA tensors. :func:`kkt_qr_dense` is the
same solve of a saddle matrix assembled by the caller (the AD solver's
``kkt="qr"``, the JAX package's ``kkt_solve_qr`` as written); its kernel
is the second entry point of the same source.
"""

from __future__ import annotations

import torch

from .. import kernels
from .fused import FusedOps


def dense_w(ops: FusedOps, Wpp, Wpq, Wqq):
    """Arrow pieces of W -> dense (B, n, n) in flat z order."""
    n = ops.L.n
    B = Wpp.shape[0]
    W = Wpp.new_zeros((B, n * n))
    W[:, ops.w_pp] = Wpp.reshape(B, -1)
    W[:, ops.w_pq] = Wpq.reshape(B, -1)
    W[:, ops.w_qp] = Wpq.reshape(B, -1)
    W[:, ops.w_qq] = Wqq.reshape(B, -1)
    return W.reshape(B, n, n)


def dense_je(ops: FusedOps, bnd):
    """The provider's JE pieces -> dense (B, mE, n)."""
    L = ops.L
    B = bnd.JE_sp.shape[0]
    J = bnd.JE_sp.new_zeros((B, L.mE * L.n))
    J[:, ops.je_sp] = bnd.JE_sp.reshape(B, -1)
    J[:, ops.je_th] = bnd.JEb_th.reshape(B, -1)
    J[:, ops.je_q] = bnd.JEb_q.reshape(B, -1)
    return J.reshape(B, L.mE, L.n)


def saddle_matrix(ops: FusedOps, bnd, Wpp, Wpq, Wqq, ladder, delta_d):
    """(K (B, R, n+mE, n+mE), W (B, n, n)) for every rung."""
    L = ops.L
    n, mE = L.n, L.mE
    B, R = ladder.shape
    W = dense_w(ops, Wpp, Wpq, Wqq)
    JE = dense_je(ops, bnd)
    eye_n = torch.eye(n, dtype=W.dtype, device=W.device)
    eye_m = torch.eye(mE, dtype=W.dtype, device=W.device)
    top = torch.cat([W[:, None] + ladder[..., None, None] * eye_n,
                     JE.transpose(1, 2)[:, None].expand(B, R, n, mE)], dim=3)
    bot = torch.cat([JE[:, None].expand(B, R, mE, n),
                     (-delta_d * eye_m).expand(B, R, mE, mE)], dim=3)
    return torch.cat([top, bot], dim=2), W


def kkt_qr_plain(ops: FusedOps, bnd, Wpp, Wpq, Wqq, rhs1, rhs2, ladder,
                 delta_d):
    """Returns ``sol (B, R, n+mE)`` ([dz in flat order, v]) and
    ``good (B, R)`` = all-finite(sol) & curvature > 0."""
    n = ops.L.n
    K, W = saddle_matrix(ops, bnd, Wpp, Wpq, Wqq, ladder, delta_d)
    Q, Rm = torch.linalg.qr(K)
    rhs = torch.cat([rhs1, rhs2], dim=1)[:, None, :, None].expand(
        K.shape[:3] + (1,))

    def ksolve(b):
        return torch.linalg.solve_triangular(Rm, Q.transpose(-1, -2) @ b,
                                             upper=True)

    sol = ksolve(rhs)
    sol = sol - ksolve(K @ sol - rhs)
    sol = sol[..., 0]
    dz = sol[..., :n]
    curv = (torch.einsum("bri,bij,brj->br", dz, W, dz)
            + ladder * torch.sum(dz * dz, dim=-1))
    return sol, torch.isfinite(sol).all(-1) & (curv > 0)


def kkt_qr(ops, bnd, Wpp, Wpq, Wqq, rhs1, rhs2, ladder, delta_d, *,
           impl=None):
    if kernels.runs_plain(rhs1, impl):
        return kkt_qr_plain(ops, bnd, Wpp, Wpq, Wqq, rhs1, rhs2, ladder,
                            delta_d)
    return kernels.kkt_qr(ops, bnd, Wpp, Wpq, Wqq, rhs1, rhs2, ladder,
                          delta_d)


def kkt_qr_dense_plain(K, rhs, n):
    """``sol (B, R, M)`` and ``good (B, R)`` of the QR solve of every
    assembled saddle matrix ``K (B, R, M, M)`` with the lane's right-hand
    side ``rhs (B, M)``: ``linalg.qr`` and ``solve_triangular``, one
    refinement pass, and the curvature test on the leading (n, n) block,
    W + delta*I: ``dz^T (W + delta I) dz > 0``."""
    Q, Rm = torch.linalg.qr(K)
    b = rhs[:, None, :, None].expand(K.shape[:3] + (1,))

    def ksolve(v):
        return torch.linalg.solve_triangular(Rm, Q.transpose(-1, -2) @ v, upper=True)

    sol = ksolve(b)
    sol = (sol - ksolve(K @ sol - b))[..., 0]
    dz = sol[..., :n]
    curv = (dz * (K[..., :n, :n] @ dz[..., None])[..., 0]).sum(-1)
    return sol, torch.isfinite(sol).all(-1) & (curv > 0)


def kkt_qr_dense(K, rhs, n, *, impl=None):
    if kernels.runs_plain(rhs, impl):
        return kkt_qr_dense_plain(K, rhs, n)
    return kernels.kkt_qr_dense(K, rhs, n)
