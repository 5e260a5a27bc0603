"""Batched primal-dual interior-point solver for the OBCA NLP.

PyTorch counterpart of the JAX package's ``solver/ipm.py`` with
``kkt='fused'``: the analytic KKT provider, the block-arrow Newton solve
over a parallel regularization ladder, a vectorized filter line search,
Ipopt-style gradient scaling, watchdog and two-level acceptance; and with
``kkt='qr'``, the same body whose Newton solve is a Householder QR of the
full saddle system (:mod:`.qr`). Problem form (bounds folded into c_I):

    min f(z)   s.t.  c_E(z) = 0,   c_I(z) - s = 0,  s >= 0

Batching: every state field has a leading lane dimension B. ``vmap`` of a
``while_loop`` runs the body for all lanes while any lane is active and
freezes finished lanes, so per-lane iteration counts match the JAX
package (:mod:`.loop`): on CUDA tensors the whole solve (its ``init``, the
loop of the body and the ``ipm_freeze`` kernel under a conditional WHILE
node, ``finalize``) is one CUDA graph launch with the loop test on the
device (``solve.program``); on CPU tensors (or ``impl="plain"``, or
``loop="host"``) a host loop that synchronizes once per iteration.

Hot loops run as hand-written CUDA kernels on CUDA tensors (provider,
SPD inverses, Newton stages, QR saddle solve, line search); on CPU tensors
the same functions run their plain PyTorch versions. The AD ``kkt``
families over user callables (``arrow``, ``al_chol``, ``chol`` and the
dense ``qr``) are :func:`.ad.build_solver`; they share this module's
options, state, result and SPD inverse.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.utils._pytree as pytree

from .. import kernels
from ..models import obca as _obca
from ..models.obca import OBCAData
from . import linesearch as _ls
from . import loop as _loop
from . import newton as _newton
from . import qr as _qr
from .fused import FusedLayout


@dataclasses.dataclass(frozen=True)
class IPMOptions:
    """Solver knobs, with the JAX package's names and defaults
    (see its ``solver/ipm.py:55-205`` for the reasoning behind each).
    ``hessian_coloring`` and ``spine_coloring`` steer the AD families'
    Hessian (:func:`.ad.build_solver`). The JAX package's
    ``matmul_precision``, ``kkt_matmul_precision`` and ``debug`` have no
    counterpart: TF32 stays off, so float32 products run in full float32."""

    max_iters: int = 100
    tol: float = 1e-6
    acceptable_tol: float = 1e-4
    acceptable_iter: int = 5
    feas_tol: float = 1e-6
    acceptable_viol_tol: float = 1e-2
    mu0: float = 0.1
    kappa_mu: float = 0.2
    theta_mu: float = 1.5
    kappa_eps: float = 10.0
    kappa_sigma: float = 1e10
    tau_min: float = 0.99
    s_init: float = 1e-2
    delta0: float = 1e-8
    delta_max: float = 1e8
    delta_d: float = 1e-8
    n_deltas: int = 2
    delta_step: float = 100.0
    n_backtracks: int = 16
    n_refine: int = 2
    g_max: float = 100.0
    kkt: str = "fused"
    delta_d_al: float = 1e-3
    stall_iters: int = 0
    stall_rel: float = 1e-3
    stall_viol_gate: bool = True
    hessian_coloring: bool = True
    spine_coloring: bool = True


class IPMResult(NamedTuple):
    z: dict                 # solution variables, (B, ...) each
    s: torch.Tensor         # (B, mI) slacks
    y: torch.Tensor         # (B, mE) equality multipliers
    w: torch.Tensor         # (B, mI) inequality multipliers
    f: torch.Tensor         # (B,) objective (unscaled)
    kkt_err: torch.Tensor   # (B,) final scaled KKT error
    viol: torch.Tensor      # (B,) final unscaled max constraint violation
    iters: torch.Tensor     # (B,) int32
    converged: torch.Tensor  # (B,) bool
    feas: torch.Tensor      # (B,) bool: acceptance at either level


class IPMState(NamedTuple):
    """Full iteration state, one row per lane."""

    zv: torch.Tensor
    s: torch.Tensor
    y: torch.Tensor
    w: torch.Tensor
    mu_b: torch.Tensor
    delta: torch.Tensor     # last successful regularization
    it: torch.Tensor        # int32
    done: torch.Tensor      # bool
    acc_it: torch.Tensor    # consecutive iterations at acceptable level
    stall_it: torch.Tensor  # consecutive iterations w/o watchdog progress
    best_zv: torch.Tensor   # watchdog: best iterate by mu=0 KKT error
    best_s: torch.Tensor
    best_y: torch.Tensor
    best_w: torch.Tensor
    best_err: torch.Tensor
    best_viol: torch.Tensor
    sf: torch.Tensor        # (B,) objective scale
    scE: torch.Tensor       # (B, mE) equality row scales
    scD: torch.Tensor       # (B, mD) dense-inequality row scales


# ------------------------------------------- the iteration's shared pieces

def gradient_scale(opt, rowmax):
    """Ipopt-style scale of a gradient or of each constraint row from its
    largest entry: ``min(1, g_max / max(rowmax, 1e-12))``."""
    return torch.clamp(opt.g_max / torch.clamp(rowmax, min=1e-12), max=1.0)


def initial_state(opt, zv0, cI0, sf, scE, scD) -> IPMState:
    """The state at z0: slacks from the scaled inequalities ``cI0``,
    duals from the initial barrier, no iterate yet best."""
    B, dtype, dev = zv0.shape[0], zv0.dtype, zv0.device
    s0 = torch.clamp(cI0, min=opt.s_init)
    mu_b0 = torch.full((B,), opt.mu0, dtype=dtype, device=dev)
    w0 = torch.clamp(mu_b0[:, None] / s0, min=1e-8, max=1.0)
    y0 = torch.zeros((B, scE.shape[1]), dtype=dtype, device=dev)
    izero = torch.zeros((B,), dtype=torch.int32, device=dev)
    inf = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    return IPMState(zv0, s0, y0, w0, mu_b0,
                    torch.full((B,), opt.delta0, dtype=dtype, device=dev),
                    izero, torch.zeros((B,), dtype=torch.bool, device=dev),
                    izero, izero, zv0, s0, y0, w0, inf, inf, sf, scE, scD)


def kkt_error(opt, r_d, cE, cI, s, y, w, mu):
    """The scaled KKT error at barrier ``mu`` (B,), Ipopt's s_d / s_c."""
    mE, mI = cE.shape[1], cI.shape[1]
    r_sw = s * w - mu[:, None]
    r_I = cI - s
    sd = torch.clamp((y.abs().sum(1) + w.abs().sum(1)) / max(mE + mI, 1),
                     min=opt.g_max) / opt.g_max
    sc = torch.clamp(w.abs().sum(1) / max(mI, 1), min=opt.g_max) / opt.g_max
    return torch.maximum(
        r_d.abs().amax(1) / sd,
        torch.maximum(torch.maximum(cE.abs().amax(1), r_I.abs().amax(1)),
                      r_sw.abs().amax(1) / sc))


def _max0(t, zero):
    """max(0, max over the last dim); 0 over an empty row set."""
    if t.shape[-1] == 0:
        return zero
    return torch.maximum(t.amax(-1), zero)


def iteration_start(opt, st: IPMState, r_d, cE, cI, m_id):
    """What every Newton body does first, from the iterate's dual residual
    ``r_d``, scaled equalities ``cE`` and inequalities ``cI`` (identity
    rows first, ``m_id`` of them): the unscaled violation, the watchdog
    (prefer acceptable feasibility, then the lowest mu = 0 KKT error), the
    two-level acceptance and stall tests, and the monotone
    Fiacco-McCormick barrier update. Returns ``(mu_b, done, acc_it,
    stall_it, best)``, ``best`` the six watchdog fields in IPMState order."""
    scE, scD = st.scE, st.scD
    err_0 = kkt_error(opt, r_d, cE, cI, st.s, st.y, st.w, torch.zeros_like(st.mu_b))
    err_mu = kkt_error(opt, r_d, cE, cI, st.s, st.y, st.w, st.mu_b)

    # unscaled violation of this iterate: the feasibility axis
    zero = torch.zeros_like(err_0)
    viol_u = torch.maximum(
        _max0(cE.abs() / torch.clamp(scE, min=1e-12), zero),
        torch.maximum(_max0(-cI[:, :m_id], zero),
                      _max0(-cI[:, m_id:] / torch.clamp(scD, min=1e-12), zero)))
    ok_u = viol_u <= opt.acceptable_viol_tol

    # watchdog: prefer acceptable feasibility, then lowest mu=0 error
    best_ok = st.best_viol <= opt.acceptable_viol_tol
    better = (ok_u & ~best_ok) | ((ok_u == best_ok) & (err_0 < st.best_err))
    b1 = better[:, None]
    best = (torch.where(b1, st.zv, st.best_zv), torch.where(b1, st.s, st.best_s),
            torch.where(b1, st.y, st.best_y), torch.where(b1, st.w, st.best_w),
            torch.where(better, err_0, st.best_err),
            torch.where(better, viol_u, st.best_viol))
    best_viol = best[5]

    izero = torch.zeros_like(st.acc_it)
    acc_it = torch.where((err_0 <= opt.acceptable_tol) & ok_u,
                         st.acc_it + 1, izero)
    done = (err_0 <= opt.tol) | (acc_it >= opt.acceptable_iter)
    progress = (ok_u & ~best_ok) | (
        (ok_u == best_ok) & (err_0 < st.best_err * (1.0 - opt.stall_rel)))
    stall_it = torch.where(progress, izero, st.stall_it + 1)
    if opt.stall_iters > 0:
        cut = stall_it >= opt.stall_iters
        if opt.stall_viol_gate:
            cut = cut & (best_viol > opt.acceptable_viol_tol)
        done = done | cut

    # monotone Fiacco-McCormick barrier update at iteration start
    shrink = err_mu <= opt.kappa_eps * st.mu_b
    mu_b = torch.where(
        shrink,
        torch.clamp(torch.minimum(opt.kappa_mu * st.mu_b,
                                  st.mu_b ** opt.theta_mu), min=opt.tol / 10.0),
        st.mu_b)
    return mu_b, done, acc_it, stall_it, best


def final_status(opt, err, cE_u, cI_u):
    """``(viol, converged, feas)`` of the reported iterate: its unscaled
    violation and Ipopt's acceptance at either level."""
    viol = torch.maximum(cE_u.abs().amax(1), torch.clamp(-cI_u.amin(1), min=0.0))
    converged = err <= opt.tol
    acceptable = err <= opt.acceptable_tol
    feas = ((converged & (viol <= opt.feas_tol))
            | (acceptable & (viol <= opt.acceptable_viol_tol)))
    return viol, converged, feas


# ---------------------------------------------------------------- SPD inverse

def _chol_inv_small(A):
    """Inverse of batched small SPD blocks (..., m, m): Cholesky by
    columns, L^-1 by forward substitution, then L^-T L^-1 — the JAX
    package's unrolled leaf, in the same operation order. A non-SPD block
    gives sqrt(negative) = NaN, which propagates through the inverse."""
    m = A.shape[-1]
    lead = A.shape[:-2]
    X = A.reshape((-1, m, m))
    rows_ge = torch.arange(m, device=A.device)
    cols = []                      # cols[j] = L[:, j] as (Bf, m)
    for j in range(m):
        v = X[:, :, j]
        for k in range(j):
            v = v - cols[k] * cols[k][:, j:j + 1]
        scaled = v / torch.sqrt(v[:, j:j + 1])
        cols.append(torch.where(rows_ge >= j, scaled, torch.zeros_like(scaled)))
    rows = []                      # rows[i] = L^-1[i, :] as (Bf, m)
    for i in range(m):
        acc = (rows_ge == i).to(A.dtype).expand(X.shape[0], m)
        for k in range(i):
            acc = acc - cols[k][:, i:i + 1] * rows[k]
        rows.append(acc / cols[i][:, i:i + 1])
    Linv = torch.stack(rows, dim=1)                 # (Bf, m_row, m_col)
    inv = torch.einsum("bki,bkj->bij", Linv, Linv)
    return inv.reshape(lead + (m, m))


_UNROLL_LIMIT = 16
_BLOCK_INV_LIMIT = 160


def _spd_inv(A):
    """Inverse of batched SPD matrices, the JAX package's recursion:
    the unrolled leaf for m <= 16, a 2x2 block-Schur recursion for
    m <= 160 (SPD(A) <=> SPD(A11) and SPD(Schur), so NaN-on-non-SPD is
    preserved), Cholesky + triangular inverse above."""
    m = A.shape[-1]
    if m <= _UNROLL_LIMIT:
        return _chol_inv_small(A)
    if m <= _BLOCK_INV_LIMIT:
        h = (m + 1) // 2
        A11, A12, A22 = A[..., :h, :h], A[..., :h, h:], A[..., h:, h:]
        I11 = _spd_inv(A11)
        W = I11 @ A12
        Q = A22 - torch.einsum("...ki,...kj->...ij", A12, W)
        Qi = _spd_inv(Q)
        B12 = -W @ Qi
        B11 = I11 - torch.einsum("...ik,...jk->...ij", B12, W)
        top = torch.cat([B11, B12], dim=-1)
        bot = torch.cat([B12.transpose(-1, -2), Qi], dim=-1)
        return torch.cat([top, bot], dim=-2)
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where((info > 0)[..., None, None], torch.full_like(L, float("nan")), L)
    eye = torch.eye(m, dtype=A.dtype, device=A.device).expand(A.shape)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.einsum("...ki,...kj->...ij", Linv, Linv)


def spd_inv(A, *, impl=None):
    """Batched SPD inverse (..., m, m), NaN where a matrix is not SPD.

    CPU tensors (or ``impl="plain"``) take :func:`_spd_inv`; CUDA tensors
    launch the kernel of ``kernels/csrc/spd_inv.cu`` (a Cholesky, L^-1
    and L^-T L^-1 in place, a thread a matrix up to m = 16, a warp a
    matrix up to 120) or of ``kernels/csrc/spd_inv_blocked.cu`` (a blocked
    Cholesky in a device workspace, any larger m) or raise.
    """
    if kernels.runs_plain(A, impl):
        return _spd_inv(A)
    return kernels.spd_inv(A)


# ------------------------------------------------------------------- solver

def build_fused_solver(spec, lay, provider, d_scale,
                       options: IPMOptions = IPMOptions(), impl=None, loop=None):
    """Solver for one OBCA problem family, ``kkt`` "fused" or "qr".

    ``impl`` picks the hot loops' implementation: None (default) runs the
    CUDA kernels on CUDA tensors and the plain PyTorch versions on CPU
    tensors; ``"plain"`` forces the plain versions on any device (for
    kernel-vs-plain comparisons on the card). ``loop`` picks the Newton
    loop (:mod:`.loop`): None (default) is ``"graph"`` on CUDA tensors
    with the kernels and ``"host"`` otherwise; ``"host"`` forces the host
    loop (for comparisons on the card); ``"graph"`` on a CPU tensor runs
    the graph loop's control code with eager iterations.

    Returns ``solve(z0 (dict of (B, ...)), data) -> IPMResult`` with the
    chunked API ``solve.init(z0, data)``, ``solve.iterate(st, data,
    it_cap)`` and ``solve.finalize(st, data)``; ``solve.step(st, data)``
    is one unfrozen Newton iteration; ``solve.program(pre, post, inputs,
    it_cap, static)`` runs a caller's solve around the loop (one graph
    launch on the graphed loop: the multistart's).
    """
    opt = options
    if opt.kkt not in ("fused", "qr"):
        raise ValueError(f"kkt={opt.kkt!r}: the analytic solver runs 'fused' and 'qr'; "
                         "the AD families are solver.ad.build_solver")
    if loop not in (None, "host", "graph"):
        raise ValueError(f"loop must be None, 'host' or 'graph', got {loop!r}")
    if loop == "graph" and impl == "plain":
        raise ValueError("loop='graph' runs the kernels; impl='plain' needs the host loop")
    FL = FusedLayout(spec, lay, d_scale)
    mE, mD, m_id = FL.mE, FL.mD, FL.m_id

    def _prep(data, zv):
        ops = FL.ops(zv.device, zv.dtype)
        sgn_raw, id_off = _obca.ineq_identity_sgn_off(spec, data)
        sgn_eff = sgn_raw * ops.ds[ops.id_idx]
        data_flat = (None if kernels.runs_plain(zv, impl)
                     else kernels.pack_obca_data(data))
        return ops, sgn_eff, id_off, data_flat

    def init_fn(z0, data: OBCAData) -> IPMState:
        """Initial state; Ipopt-style gradient scaling fixed at z0."""
        dsd = FL.ops(data.x0.device, data.x0.dtype).ds
        zv0 = _obca.ravel_z(spec, z0) / dsd
        ops, sgn_eff, id_off, data_flat = _prep(data, zv0)
        B, dtype, dev = zv0.shape[0], zv0.dtype, zv0.device
        ones = lambda *s: torch.ones((B,) + s, dtype=dtype, device=dev)
        zeros = lambda *s: torch.zeros((B,) + s, dtype=dtype, device=dev)
        b0 = provider(zv0, data, ones(), ones(mE), ones(mD), zeros(mE),
                      zeros(mD), data_flat=data_flat, impl=impl)
        rmE_b = torch.maximum(b0.JEb_th.abs(), b0.JEb_q.abs().amax(3))
        rowmax_E = torch.cat([b0.JE_sp.abs().amax(2), rmE_b[..., 0],
                              rmE_b[..., 1]], dim=1)
        rmD_b = torch.maximum(b0.JDb_p.abs().amax(3), b0.JDb_q.abs().amax(3))
        rowmax_D = torch.cat([b0.JD_sp.abs().amax(2), rmD_b[..., 0],
                              rmD_b[..., 1]], dim=1)
        scE, scD = gradient_scale(opt, rowmax_E), gradient_scale(opt, rowmax_D)
        sf = gradient_scale(opt, b0.g.abs().amax(1))
        cI0 = torch.cat([sgn_eff * zv0[:, ops.id_idx] + id_off, scD * b0.cD], 1)
        return initial_state(opt, zv0, cI0, sf, scE, scD)

    def body(st: IPMState, data, sgn_eff, id_off, data_flat) -> IPMState:
        zv, s, y, w = st.zv, st.s, st.y, st.w
        sf, scE, scD = st.sf, st.scE, st.scD
        dtype = zv.dtype
        ops = FL.ops(zv.device, dtype)
        bnd = provider(zv, data, sf, scE, scD, y, w[:, m_id:].contiguous(),
                       data_flat=data_flat, impl=impl)
        cE = bnd.cE
        cI = torch.cat([sgn_eff * zv[:, ops.id_idx] + id_off, bnd.cD], 1)
        jeTp, jeTq = ops.f_jeT(bnd, y)
        jiTp, jiTq = ops.f_jiT(bnd, w, sgn_eff)
        r_d = bnd.g - ops.f_flat(jeTp + jiTp, jeTq + jiTq)
        mu_b, done, acc_it, stall_it, best = iteration_start(opt, st, r_d, cE, cI, m_id)

        sigma = w / s
        up, uq = ops.f_jiT(bnd, (w * cI - mu_b[:, None]) / s, sgn_eff)
        rhs1 = -r_d - ops.f_flat(up, uq)
        rhs2 = -cE

        # parallel regularization ladder (inertia correction)
        base = torch.clamp(st.delta, min=opt.delta0)
        ladder = base[:, None] * (opt.delta_step ** torch.arange(
            opt.n_deltas, dtype=dtype, device=zv.device))
        dd = opt.delta_d_al
        if opt.kkt == "qr":   # the QR solve reads W alone
            Wpp, Wpq, Wqq = _newton.newton_assemble(
                ops, bnd, sigma, sgn_eff, ladder, dd, w_only=True, impl=impl)
            sols, goods = _qr.kkt_qr(ops, bnd, Wpp, Wpq, Wqq, rhs1, rhs2,
                                     ladder, opt.delta_d, impl=impl)
        else:
            Wpp, Wpq, Wqq, Gpp0, Gpq0, Gqq = _newton.newton_assemble(
                ops, bnd, sigma, sgn_eff, ladder, dd, impl=impl)
            Qinv = spd_inv(Gqq, impl=impl)
            Yq, Smat = _newton.newton_schur(ops, Qinv, Gpq0, Gpp0, ladder,
                                            impl=impl)
            Sinv = spd_inv(Smat, impl=impl)
            sols, goods = _newton.newton_al_solve(
                ops, bnd, Wpp, Wpq, Wqq, Gpq0, Qinv, Yq, Sinv, rhs1, rhs2,
                ladder, dd, opt.delta_d, opt.n_refine, impl=impl)

        zv_n, s_n, y_n, w_n, delta_n = _ls.step_linesearch(
            ops, opt, sols, goods, ladder, zv, s, y, w, mu_b, st.delta, cI,
            cE, bnd.f, bnd, sgn_eff, id_off, data, sf, scE, scD,
            data_flat=data_flat, impl=impl)
        return IPMState(zv_n, s_n, y_n, w_n, mu_b, delta_n, st.it + 1, done,
                        acc_it, stall_it, *best, sf, scE, scD)

    graph_loop = _loop.GraphLoop(body)

    def program(pre, post, inputs, it_cap, static=None):
        """One solve: ``pre(*inputs) -> (st, data, carry)``, the Newton
        loop until every lane is done or at ``min(it_cap, max_iters)``
        (finished lanes stay frozen), ``post(st, carry) -> outputs``.
        Returns ``(outputs, iterations)``. On the graphed loop the whole
        program is one CUDA graph launch (:class:`.loop.GraphLoop`, keyed
        on the inputs' shapes and ``static``), else it runs eagerly around
        the host loop."""
        def with_extra(*args):   # (no lane to iterate: the body never runs)
            st, data, carry = pre(*args)
            return st, data, _prep(data, st.zv)[1:] if len(st.zv) else (), carry

        t = next(x for x in pytree.tree_leaves(inputs) if isinstance(x, torch.Tensor))
        graphed = loop == "graph" or (loop is None and not kernels.runs_plain(t, impl))
        run = graph_loop.run if graphed else graph_loop.run_host
        return run(with_extra, post, inputs, min(int(it_cap), opt.max_iters), static)

    def iterate_fn(st: IPMState, data: OBCAData, it_cap) -> IPMState:
        """Newton iterations until every lane is done or at
        ``min(it_cap, max_iters)``; finished lanes stay frozen."""
        return program(lambda s, d: (s, d, None), lambda s, _: s, (st, data), it_cap,
                       "iterate")[0]

    def finalize_fn(st: IPMState, data: OBCAData) -> IPMResult:
        """Report the watchdog's best iterate, Ipopt acceptable-level
        rules, re-evaluating the unscaled model constraints there."""
        ops = FL.ops(st.zv.device, st.zv.dtype)
        err = st.best_err
        z = _obca.unravel_z(spec, st.best_zv * ops.ds)
        cE_u = _obca.eq_constraints(spec, data, z)
        cI_u = _obca.ineq_constraints(spec, data, z)
        viol, converged, feas = final_status(opt, err, cE_u, cI_u)
        return IPMResult(z={k: v.clone() for k, v in z.items()},
                         s=st.best_s, y=st.best_y, w=st.best_w,
                         f=_obca.objective(spec, data, z), kkt_err=err,
                         viol=viol, iters=st.it, converged=converged,
                         feas=feas)

    def step_fn(st: IPMState, data: OBCAData) -> IPMState:
        """One Newton iteration of every lane, finished or not (the loop's
        body, without the freeze)."""
        return body(st, data, *_prep(data, st.zv)[1:])

    def solve(z0, data):
        return program(lambda z, d: (init_fn(z, d), d, d), finalize_fn, (z0, data),
                       opt.max_iters, "solve")[0]

    solve.init = init_fn
    solve.iterate = iterate_fn
    solve.step = step_fn
    solve.finalize = finalize_fn
    solve.program = program
    solve.layout = FL
    return solve
