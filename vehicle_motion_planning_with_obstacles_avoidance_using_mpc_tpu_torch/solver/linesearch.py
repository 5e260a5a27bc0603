"""Step recovery and the vectorized filter line search.

Counterpart of the JAX package's ``solver/ipm.py:1126-1196``: pick the
first good rung (else the last), recover ``ds = JI dz + (cI - s)`` and
``dw``, take the fraction-to-boundary step bounds, evaluate the barrier
objective and the constraint violation theta of the *model* functions at
``n_backtracks`` step lengths, accept by the filter rule, apply the
masked update (``torch.where``, never a multiply: a rejected step may
carry NaN), clamp the inequality duals to the kappa_Sigma neighbourhood
and update the regularization memory.

:func:`filter_step` is that step for any model, its trials a callable
(the AD solver's body calls it too); the OBCA model's plain version sits
beside a dispatcher that launches ``kernels/csrc/step_linesearch.cu`` on
CUDA tensors.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..models import obca as _obca
from .fused import FusedOps

_G_TH = 1e-5   # filter margin (ipm.py:1156)


def filter_step(opt, sols, goods, ladder, n, zv, s, y, w, mu_b, delta, cI, cE, f0, ji,
                trials):
    """The step of every body after its Newton solve: pick the rung,
    recover ``ds``/``dw``, take the fraction-to-boundary bounds, accept the
    longest step length the filter takes and apply the update. ``sols``
    (B, R, n + mE) and ``goods`` (B, R) per rung, ``f0`` the scaled
    objective at ``zv``, ``ji(dz)`` = JI dz (B, mI), and ``trials(alphas,
    dz, ds)`` the barrier objective and theta at ``zv + alpha dz``, ``s +
    alpha ds`` for each of the (B, n_backtracks) step lengths, each
    (B, n_backtracks). Returns ``(zv, s, y, w, delta)`` after the step."""
    R = ladder.shape[1]
    B = zv.shape[0]
    lanes = torch.arange(B, device=zv.device)
    first = torch.argmax(goods.to(torch.int32), dim=1)     # first True, else 0
    any_good = goods.any(1)
    pick = torch.where(any_good, first, torch.full_like(first, R - 1))
    sol = sols[lanes, pick]
    delta_used = ladder[lanes, pick]
    bad = ~(any_good & torch.isfinite(sol).all(1))

    dz = sol[:, :n]
    dy = -sol[:, n:]
    ds = ji(dz) + (cI - s)
    mu = mu_b[:, None]
    dw = -(s * w - mu + w * ds) / s

    # fraction-to-boundary: divide only behind the where (no inf/NaN)
    tau = torch.clamp(1.0 - mu, min=opt.tau_min)
    one = torch.ones_like(s)
    neg_s, neg_w = ds < 0, dw < 0
    a_s = torch.where(neg_s, -tau * s / torch.where(neg_s, ds, -one), one).amin(1)
    a_w = torch.where(neg_w, -tau * w / torch.where(neg_w, dw, -one), one).amin(1)
    a_s = torch.clamp(a_s, max=1.0)
    a_w = torch.clamp(a_w, max=1.0)

    phi0 = f0 - mu_b * torch.sum(torch.log(s), 1)
    th0 = torch.sum(torch.abs(cE), 1) + torch.sum(torch.abs(cI - s), 1)
    nb = opt.n_backtracks
    alphas = a_s[:, None] * (0.5 ** torch.arange(nb, dtype=zv.dtype,
                                                 device=zv.device))
    phis, ths = trials(alphas, dz, ds)
    ok = torch.isfinite(phis) & ((ths <= (1.0 - _G_TH) * th0[:, None])
                                 | (phis <= (phi0 - _G_TH * th0)[:, None]))
    any_ok = ok.any(1)
    zero = torch.zeros_like(a_s)
    alpha = torch.where(any_ok, torch.where(ok, alphas, 0.0).amax(1), zero)

    step_ok = ~bad & any_ok
    alpha = torch.where(step_ok, alpha, zero)
    a_wd = torch.where(step_ok, a_w, zero)
    ok_ = step_ok[:, None]
    zv_n = torch.where(ok_, zv + alpha[:, None] * dz, zv)
    s_n = torch.where(ok_, s + alpha[:, None] * ds, s)
    y_n = torch.where(ok_, y + alpha[:, None] * dy, y)
    w_n = torch.where(ok_, w + a_wd[:, None] * dw, w)
    ks = opt.kappa_sigma
    w_n = torch.minimum(torch.maximum(w_n, mu / (ks * s_n)), ks * mu / s_n)
    delta_n = torch.where(
        step_ok, torch.clamp(delta_used / 30.0, min=opt.delta0),
        torch.clamp(torch.clamp(delta * 100.0, min=1e-4), max=opt.delta_max))
    return zv_n, s_n, y_n, w_n, delta_n


def step_linesearch_plain(ops: FusedOps, opt, sols, goods, ladder, zv, s, y,
                          w, mu_b, delta, cI, cE, f0, bnd, sgn_eff, id_off,
                          data, sf, scE, scD):
    """Returns ``(zv, s, y, w, delta)`` after the step: :func:`filter_step`
    with the OBCA model's trials."""
    L = ops.L
    spec = L.spec

    def trials(alphas, dz, ds):
        phis, ths = [], []
        for j in range(alphas.shape[1]):
            a = alphas[:, j:j + 1]
            zt = zv + a * dz
            st = s + a * ds
            z = _obca.unravel_z(spec, zt * ops.ds)
            cEs = scE * _obca.eq_constraints(spec, data, z)
            cIs = torch.cat([sgn_eff * zt[:, ops.id_idx] + id_off,
                             scD * _obca.ineq_constraints_dense(spec, data, z)], 1)
            phis.append(sf * _obca.objective(spec, data, z)
                        - mu_b * torch.sum(torch.log(st), 1))
            ths.append(torch.sum(torch.abs(cEs), 1)
                       + torch.sum(torch.abs(cIs - st), 1))
        return torch.stack(phis, 1), torch.stack(ths, 1)

    return filter_step(opt, sols, goods, ladder, L.n, zv, s, y, w, mu_b, delta, cI, cE, f0,
                       lambda dz: ops.f_ji(bnd, dz, sgn_eff), trials)


def step_linesearch(ops, opt, sols, goods, ladder, zv, s, y, w, mu_b, delta,
                    cI, cE, f0, bnd, sgn_eff, id_off, data, sf, scE, scD, *,
                    data_flat=None, impl=None):
    if kernels.runs_plain(zv, impl):
        return step_linesearch_plain(ops, opt, sols, goods, ladder, zv, s, y,
                                     w, mu_b, delta, cI, cE, f0, bnd, sgn_eff,
                                     id_off, data, sf, scE, scD)
    if data_flat is None:
        data_flat = kernels.pack_obca_data(data)
    return kernels.step_linesearch(ops, opt, sols, goods, ladder, zv, s, y, w,
                                   mu_b, delta, cI, cE, f0, bnd, sgn_eff,
                                   id_off, data_flat, sf, scE, scD)
