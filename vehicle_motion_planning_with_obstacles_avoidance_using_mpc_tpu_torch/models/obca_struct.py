"""Hand-derived structured KKT derivatives of the OBCA NLP.

PyTorch counterpart of the JAX package's ``models/obca_struct.py``: every
gradient, constraint Jacobian and Lagrangian-Hessian block of the OBCA
problem written out analytically in the KKT system's block-arrow
coordinates, so the interior-point iteration never materializes a dense
(m, n) Jacobian or (n, n) Hessian.

Variable flat order (sorted keys, :func:`.obca.ravel_z`):

    [T] lam(n_k, nO, E) mu(n_k, nO, 4) u(2, N) x(3, N+1)

Spine order (positions into the np-vector):

    [T] u[0, 0..N-1] u[1, 0..N-1] x[0, 0..N] x[1, 0..N] x[2, 0..N]

Equality rows:  dyn r1(N) r2(N) r3(N) | init(3) | terminal(3/2/0) | g1(K) | g2(K)
Dense inequality rows:  accel(4N) | terminal(3/2/0) | norm(K) | dist(K)

All pieces are returned SCALED: rows by the solver's per-lane row scales
(scE/scD), the objective by sf, variables by the solver's d_scale.

:func:`make_provider` returns the provider as a dispatcher: on a CPU
tensor it runs the plain PyTorch version below; on a CUDA tensor it
launches the hand-written kernel ``kernels/csrc/obca_kkt_provider.cu``,
which writes the dense spine blocks through :func:`spine_row_plan`, the
nonzero pattern of :func:`spine_maps` (the maps the plain version gathers
with).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from . import obca as _obca
from .obca import OBCAData, OBCASpec


class KKTBundle(NamedTuple):
    """All first/second-order pieces at one iterate, scaled, arrow form."""

    f: torch.Tensor        # (B,)          sf * objective value
    g: torch.Tensor        # (B, n)        gradient of sf*f wrt zv
    cE: torch.Tensor       # (B, mE)       scaled equality residuals
    cD: torch.Tensor       # (B, mD)       scaled dense-inequality residuals
    JE_sp: torch.Tensor    # (B, mE_sp, np) spine eq rows vs spine vars
    JEb_th: torch.Tensor   # (B, K, 2)     d(g1, g2)/d theta_k
    JEb_q: torch.Tensor    # (B, K, 2, bq) d(g1, g2)/d (lam, mu)_ki
    JD_sp: torch.Tensor    # (B, mD_sp, np)
    JDb_p: torch.Tensor    # (B, K, 2, S)  d(norm, dist)/d spine-slot vars
    JDb_q: torch.Tensor    # (B, K, 2, bq)
    Hpp: torch.Tensor      # (B, np, np)   Lagrangian Hessian, spine block
    Hpq_c: torch.Tensor    # (B, K, S, bq) compressed spine-block coupling
    Hqq: torch.Tensor      # (B, K, bq, bq)


@dataclasses.dataclass(frozen=True)
class StructLayout:
    """Static index maps shared by the provider and the fused IPM body."""

    n: int
    np_: int
    K: int
    bq: int
    n_k: int          # horizon steps carrying blocks (K = n_k * nO)
    nO: int
    S: int            # spine slots coupled to a block: x, y, th[, T]
    off_u: int        # 1 when T leads z and the spine (free time), else 0
    mE_sp: int
    mD_sp: int
    mE: int
    mD: int
    m_id: int         # identity (bound) inequality rows, before the dense ones
    pq_pos: np.ndarray    # (S, K) spine positions of each block's slots
    th_pos: np.ndarray    # (K,)   = pq_pos[2]
    p_idx: np.ndarray     # (np,) flat-z indices of the spine
    q_idx: np.ndarray     # (K, bq) flat-z indices of the blocks
    id_p_pos: np.ndarray  # spine positions of the x/u/T bound rows, in
    #                       row order after the K*E lam + K*4 mu rows


def make_layout(spec: OBCASpec) -> StructLayout:
    N, nO, E = spec.N, spec.n_obs, spec.e_max
    free = spec.free_time
    K = spec.n_k * nO
    bq = E + 4
    off_u = 1 if free else 0
    np_ = off_u + 2 * N + 3 * (N + 1)

    def xpos(i, t):
        return off_u + 2 * N + i * (N + 1) + t

    ks = spec.k_lo + np.arange(K) // nO
    S = 4 if (free and spec.coupled_motion) else 3
    pq = [xpos(0, ks), xpos(1, ks), xpos(2, ks)]
    if S == 4:
        pq.append(np.zeros(K, np.int64))
    pq_pos = np.stack(pq).astype(np.int64)

    n_term_E = {"free": 3, "fix_eq_band": 2}.get(spec.variant, 0)
    n_term_D = {"fix_terminal": 3, "fix_eq_band": 2}.get(spec.variant, 0)
    mE_sp = 3 * N + 3 + n_term_E
    mD_sp = 4 * N + n_term_D

    p_idx = np.array(([0] if free else [])
                     + list(range(off_u + K * bq, off_u + K * bq + np_ - off_u)),
                     dtype=np.int64)
    q_idx = np.asarray(_obca.arrow_layout(spec), dtype=np.int64)
    n = off_u + K * bq + 2 * N + 3 * (N + 1)

    id_idx = _obca.ineq_identity_layout(spec)
    pos_of = np.full(n, -1, np.int64)
    pos_of[p_idx] = np.arange(np_)
    id_p_pos = pos_of[id_idx[K * bq:]]
    assert (id_p_pos >= 0).all()

    return StructLayout(
        n=n, np_=np_, K=K, bq=bq, n_k=spec.n_k, nO=nO, S=S, off_u=off_u,
        mE_sp=mE_sp, mD_sp=mD_sp, mE=mE_sp + 2 * K, mD=mD_sp + 2 * K,
        m_id=id_idx.shape[0],
        pq_pos=pq_pos, th_pos=pq_pos[2], p_idx=p_idx, q_idx=q_idx,
        id_p_pos=id_p_pos,
    )


def _build_map(shape, entries):
    """MAP[r, c] = 1 + position of that entry's value in the concatenated
    value vector (0 = structural zero), the entries numbered in the order
    ``entries`` registers them: (rows, cols) pairs, broadcast together."""
    MAP = np.zeros(shape, np.int64)
    j = 1
    for rows, cols in entries:
        rows, cols = np.broadcast_arrays(np.asarray(rows, np.int64).ravel(),
                                         np.asarray(cols, np.int64).ravel())
        for r, c in zip(rows, cols):
            assert MAP[r, c] == 0, (r, c)
            MAP[r, c] = j
            j += 1
    return MAP


@functools.lru_cache(maxsize=None)
def spine_maps(spec: OBCASpec):
    """(JE_MAP, JD_MAP, HPP_MAP): the nonzero pattern of the dense spine
    blocks JE_sp (mE_sp, np), JD_sp (mD_sp, np) and Hpp (np, np), each a
    :func:`_build_map` of its block structure. The plain provider
    concatenates JE_sp's and JD_sp's values in exactly this registration
    order. HPP_MAP registers Hpp's upper triangle: [the T row: T, u(0, .),
    u(1, .), theta(0..N-1)], the u-u diagonals of the pairs (0,0) (0,1)
    (1,1), the u-u bands (u0(t), u0(t+1)) (u0(t), u1(t+1)) (u1(t), u1(t+1))
    (u0(t+1), u1(t)), the (u0(t), theta(t)) entries, then the x-x
    diagonals of the pairs (0,0) (0,1) (0,2) (1,1) (1,2) (2,2); a lower
    entry takes its mirror's index. Cached per spec: do not modify the
    arrays."""
    lay = make_layout(spec)
    N, free, off_u = spec.N, spec.free_time, lay.off_u
    ar_N = np.arange(N)
    upos = lambda i, t: off_u + i * N + t
    xpos = lambda i, t: off_u + 2 * N + i * (N + 1) + t
    r1, r2, r3 = ar_N, N + ar_N, 2 * N + ar_N
    X = [xpos(i, np.arange(N + 1)) for i in range(3)]
    X0t, X1t, X2t = X
    U0, U1 = upos(0, ar_N), upos(1, ar_N)
    T0 = 0 * ar_N

    n_term = {"free": 3, "fix_eq_band": 2}.get(spec.variant, 0)
    je_entries = [
        (r1, X0t[1:]), (r1, X0t[:N]), (r1, X2t[:N]), (r1, U0),
        (r2, X1t[1:]), (r2, X1t[:N]), (r2, X2t[:N]), (r2, U0),
        (r3, X2t[1:]), (r3, X2t[:N]), (r3, U1),
    ]
    if free:
        je_entries += [(r1, T0), (r2, T0), (r3, T0)]
    je_entries.append((3 * N + np.arange(3), [xpos(i, 0) for i in range(3)]))
    if n_term:
        je_entries.append((3 * N + 3 + np.arange(n_term),
                           [xpos(i, N) for i in range(n_term)]))
    JE_MAP = _build_map((lay.mE_sp, lay.np_), je_entries)

    aR = [ar_N, N + ar_N, 2 * N + ar_N, 3 * N + ar_N]
    jd_entries = []
    for fam, usl in enumerate([U0, U1]):
        hi, lo = aR[2 * fam], aR[2 * fam + 1]
        jd_entries += [(hi, usl), (hi[1:], usl[:-1]),
                       (lo, usl), (lo[1:], usl[:-1])]
        if free:
            jd_entries += [(hi, 0 * hi), (lo, 0 * lo)]
    dterm_rows = 4 * N + np.arange(lay.mD_sp - 4 * N)
    if spec.variant == "fix_terminal":
        jd_entries.append((dterm_rows, [xpos(0, N), xpos(1, N), xpos(1, N)]))
    elif spec.variant == "fix_eq_band":
        jd_entries.append((dterm_rows, [xpos(2, N), xpos(2, N)]))
    JD_MAP = _build_map((lay.mD_sp, lay.np_), jd_entries)

    hpp_entries = [([0], [0]), (T0, U0), (T0, U1), (T0, X2t[:N])] if free else []
    hpp_entries += [(U0, U0), (U0, U1), (U1, U1),
                    (U0[:-1], U0[1:]), (U0[:-1], U1[1:]), (U1[:-1], U1[1:]),
                    (U0[1:], U1[:-1]), (U0, X2t[:N])]
    hpp_entries += [(X[i], X[j]) for i in range(3) for j in range(i, 3)]
    upper = _build_map((lay.np_, lay.np_), hpp_entries)
    assert not np.tril(upper, -1).any()
    HPP_MAP = upper + np.triu(upper, 1).T
    return JE_MAP, JD_MAP, HPP_MAP


class RowPlan(NamedTuple):
    """The dense spine blocks' row plan (:func:`spine_row_plan`)."""

    table: np.ndarray   # int32: row_ptr (rows + 1) | nz_row | nz_col | nz_val
    rows: int           # stacked rows: mE_sp + mD_sp + np
    nnz: int            # nonzeros of the three blocks
    n_values: int       # a lane's compact values: JE's, JD's, Hpp's upper triangle's


@functools.lru_cache(maxsize=None)
def spine_row_plan(spec: OBCASpec) -> RowPlan:
    """JE_sp, JD_sp and Hpp stacked as rows, from :func:`spine_maps`: each
    row's nonzeros (``row_ptr``, CSR), each nonzero's stacked row and its
    column, and the index of its value in a lane's compact value
    vector [JE values | JD values | Hpp upper-triangle values], each block
    in its map's registration order. ``kernels/csrc/obca_kkt_provider.cu``
    computes that vector and writes the dense rows from it."""
    row_ptr, nz_row, nz_col, nz_val = [np.zeros(1, np.int64)], [], [], []
    base = first = 0
    for M in spine_maps(spec):
        r, c = np.nonzero(M)
        row_ptr.append(row_ptr[-1][-1] + np.cumsum(np.bincount(r, minlength=M.shape[0])))
        nz_row.append(first + r)
        nz_col.append(c)
        nz_val.append(base + M[r, c] - 1)
        base += int(M.max())
        first += M.shape[0]
    parts = [np.concatenate(p) for p in (row_ptr, nz_row, nz_col, nz_val)]
    return RowPlan(np.concatenate(parts).astype(np.int32), len(parts[0]) - 1,
                   len(parts[1]), base)


class _Consts:
    """numpy statics moved to a (device, dtype) once and kept."""

    def __init__(self, **arrays):
        self._np = arrays
        self._cache = {}

    def on(self, device, dtype):
        key = (str(device), dtype)
        if key not in self._cache:
            self._cache[key] = {
                k: torch.as_tensor(np.array(v), device=device,
                                   dtype=(torch.int64 if v.dtype.kind in "iu"
                                          else dtype))
                for k, v in self._np.items()}
        return self._cache[key]


def make_provider(spec: OBCASpec, d_scale_flat):
    """Build the analytic-KKT provider for one problem family.

    Args:
      d_scale_flat: the solver's flat variable scaling (n,). lam/mu
        entries must be 1 (block columns unscaled).

    Returns ``(layout, provider)`` with
    ``provider(zv, data, sf, scE, scD, y, w_d, *, data_flat=None,
    impl=None) -> KKTBundle``. ``provider.plain`` is the PyTorch version;
    ``impl="plain"`` forces it on any device (for kernel comparisons).
    """
    lay = make_layout(spec)
    N, nO, E = spec.N, spec.n_obs, spec.e_max
    free = spec.free_time
    K, bq, S = lay.K, lay.bq, lay.S
    off_u = 1 if free else 0
    kl = spec.k_lo

    ds = np.asarray(d_scale_flat, np.float64)
    if not np.allclose(ds[off_u:off_u + K * bq], 1.0):
        raise ValueError("block (lam, mu) columns must be unscaled")
    ds_p = ds[lay.p_idx]
    ds_slots = ds_p[lay.pq_pos[:, 0]]

    base_u = off_u + K * bq
    base_x = base_u + 2 * N

    ks_K = kl + np.arange(K) // nO
    i_K = np.arange(K) % nO
    kblk = np.arange(K) // nO

    n_term = {"free": 3, "fix_eq_band": 2}.get(spec.variant, 0)
    n_dterm = {"fix_terminal": 3, "fix_eq_band": 2}.get(spec.variant, 0)
    dterm_sgn = {"fix_terminal": np.array([1.0, 1.0, -1.0]),
                 "fix_eq_band": np.array([-1.0, 1.0])}.get(spec.variant, np.zeros(0))

    gmu_pat = np.zeros((2, 4))
    gmu_pat[0, 0], gmu_pat[0, 2] = 1.0, -1.0
    gmu_pat[1, 1], gmu_pat[1, 3] = 1.0, -1.0

    # the provider concatenates its JE / JD value pieces in the maps'
    # registration order
    JE_MAP, JD_MAP, _ = spine_maps(spec)

    consts = _Consts(
        ds=ds, ds_p=ds_p, ds_pp=np.outer(ds_p, ds_p), ds_slots=ds_slots,
        JE_MAP=JE_MAP, JD_MAP=JD_MAP, i_K=i_K, kblk=kblk,
        ks_K=ks_K.astype(np.float64), gmu_pat=gmu_pat,
        dterm_sgn=dterm_sgn, eyeN1=np.eye(N + 1), eyeN=np.eye(N),
        bandN=np.eye(N, k=1) + np.eye(N, k=-1), rectNT=np.eye(N + 1, N).T,
        e3=np.array([0.0, 0.0, 1.0]),
        cnt=np.concatenate([2.0 * np.ones(N - 1), np.ones(1)]),
    )

    def plain(zv, data: OBCAData, sf, scE, scD, y, w_d) -> KKTBundle:
        """The provider in plain PyTorch, batched over lanes."""
        dtype, dev = zv.dtype, zv.device
        c = consts.on(dev, dtype)
        B = zv.shape[0]
        i_Kt, kblkt = c["i_K"], c["kblk"]
        z = zv * c["ds"]
        T = z[:, 0] if free else None
        lam = z[:, off_u:off_u + K * E].reshape(B, K, E)
        mu = z[:, off_u + K * E:off_u + K * bq].reshape(B, K, 4)
        u = z[:, base_u:base_x].reshape(B, 2, N)
        x = z[:, base_x:].reshape(B, 3, N + 1)

        Ts = data.Ts[:, None]
        dt = (T * data.Ts if free else data.Ts)[:, None]       # (B, 1)
        v, w_in = u[:, 0], u[:, 1]
        th = x[:, 2, :N]
        cth, sth = torch.cos(th), torch.sin(th)

        A = data.A[:, kl:].reshape(B, K, E, 2)
        b0 = data.b[:, kl:].reshape(B, K, E)
        lam_mask = (data.edge_mask * data.obs_mask[..., None])[:, i_Kt]
        m = data.obs_mask[:, i_Kt]                               # (B, K)
        thk = x[:, 2, kl:]
        ck = torch.cos(thk)[:, kblkt]
        sk = torch.sin(thk)[:, kblkt]
        q1 = torch.einsum("bked,bke->bkd", A, lam)
        if spec.coupled_motion:
            ksT = c["ks_K"] * Ts * T[:, None]                    # (B, K)
            vel = data.obs_vel[:, i_Kt]                          # (B, K, 2)
            b = b0 + torch.einsum("bked,bkd->bke", A, ksT[..., None] * vel)
        else:
            b = b0
        off = data.ego_offset[:, None]
        xk = x[:, 0, kl:][:, kblkt]
        yk = x[:, 1, kl:][:, kblkt]
        tx = xk + ck * off
        ty = yk + sk * off
        blam = torch.einsum("bke,bke->bk", b, lam)
        q1x, q1y = q1[..., 0], q1[..., 1]

        # ---------- constraint values (natural), then scaled -----------
        parts_E = [x[:, 0, 1:] - x[:, 0, :N] - dt * v * cth,
                   x[:, 1, 1:] - x[:, 1, :N] - dt * v * sth,
                   x[:, 2, 1:] - x[:, 2, :N] - dt * w_in,
                   x[:, :, 0] - data.x0]
        if spec.variant == "free":
            parts_E.append(x[:, :, N] - data.xref[:, :, N])
        elif spec.variant == "fix_eq_band":
            parts_E.append(x[:, :2, N] - data.xref[:, :2, N])
        g1 = (mu[..., 0] - mu[..., 2]) + m * (ck * q1x + sk * q1y)
        g2 = (mu[..., 1] - mu[..., 3]) + m * (-sk * q1x + ck * q1y)
        cE_nat = torch.cat(parts_E + [g1, g2], dim=1)

        du_i = torch.cat([data.u0[:, :, None] - u[:, :, :1],
                          u[:, :, :-1] - u[:, :, 1:]], dim=-1)
        a_dt = data.a_max[:, None] * dt
        al_dt = data.alpha_max[:, None] * dt
        parts_D = [a_dt - du_i[:, 0], du_i[:, 0] + a_dt,
                   al_dt - du_i[:, 1], du_i[:, 1] + al_dt]
        if spec.variant == "fix_terminal":
            ts = data.terminal_set
            parts_D.append(torch.stack([x[:, 0, N] - ts[:, 0, 0],
                                        x[:, 1, N] - ts[:, 1, 0],
                                        ts[:, 1, 1] - x[:, 1, N]], dim=1))
        elif spec.variant == "fix_eq_band":
            dth = x[:, 2, N] - data.xref[:, 2, N]
            parts_D.append(torch.stack([spec.theta_band - dth,
                                        dth + spec.theta_band], dim=1))
        one = torch.ones((), dtype=dtype, device=dev)
        norm_row = torch.where(m > 0, 1.0 - torch.sum(q1 * q1, dim=-1), one)
        gmu = torch.einsum("bkj,bj->bk", mu, data.ego_g)
        dist = -gmu + tx * q1x + ty * q1y - blam
        dist_row = torch.where(m > 0, dist - data.dmin[:, None], one)
        cD_nat = torch.cat(parts_D + [norm_row, dist_row], dim=1)

        # ---------- objective gradient (natural) -----------------------
        tr = lambda M: M.transpose(-1, -2)
        Q2, P2 = data.Q + tr(data.Q), data.P + tr(data.P)
        R12, R22 = data.R1 + tr(data.R1), data.R2 + tr(data.R2)
        dx = x[:, :, :N] - data.xref[:, :, :N]
        dN = x[:, :, N] - data.xref[:, :, N]
        gx = torch.cat([Q2 @ dx, P2 @ dN[..., None]], dim=2)    # (B, 3, N+1)
        du_c = torch.cat([u[:, :, :1] - data.u0[:, :, None],
                          torch.diff(u, dim=-1)], dim=-1)       # (B, 2, N)
        dt2 = (dt ** 2)[..., None]                              # (B, 1, 1)
        acc_t = (R22 @ du_c) / dt2
        g_acc = acc_t - torch.nn.functional.pad(acc_t[:, :, 1:], (0, 1))
        gu = R12 @ u + g_acc
        lm, om = lam_mask, m
        coef_l = _obca._PIN_RHO * (1.0 - lm) ** 2 + spec.dual_reg * lm ** 2
        coef_m = (_obca._PIN_RHO * (1.0 - om) ** 2
                  + spec.dual_reg * om ** 2)[..., None]
        cost_acc = 0.5 * torch.sum(du_c * (R22 @ du_c), dim=(1, 2)) / dt[:, 0] ** 2
        g_parts = []
        if free:
            gT = (-2.0 * cost_acc / T
                  + (N + 1) * (data.time_c1 + 2.0 * data.time_c2 * T))
            g_parts.append(gT[:, None])
        g_parts += [(coef_l * lam).reshape(B, -1), (coef_m * mu).reshape(B, -1),
                    gu.reshape(B, -1), gx.reshape(B, -1)]
        g_nat = torch.cat(g_parts, dim=1)

        # ---------- objective value ------------------------------------
        f_nat = (torch.sum(dx * (data.Q @ dx), dim=(1, 2))
                 + torch.sum(u * (data.R1 @ u), dim=(1, 2))
                 + torch.sum(du_c * (data.R2 @ du_c), dim=(1, 2)) / dt[:, 0] ** 2
                 + torch.einsum("bi,bij,bj->b", dN, data.P, dN)
                 + 0.5 * _obca._PIN_RHO
                 * (torch.sum(((1.0 - lm) * lam) ** 2, dim=(1, 2))
                    + torch.sum(((1.0 - om)[..., None] * mu) ** 2, dim=(1, 2)))
                 + 0.5 * spec.dual_reg
                 * (torch.sum((lm * lam) ** 2, dim=(1, 2))
                    + torch.sum((om[..., None] * mu) ** 2, dim=(1, 2))))
        if free:
            f_nat = f_nat + (N + 1) * (data.time_c1 * T + data.time_c2 * T ** 2)

        # ---------- scaled values ---------------------------------------
        mEs, mDs = lay.mE_sp, lay.mD_sp
        scE_sp = scE[:, :mEs]
        scE_g = torch.stack([scE[:, mEs:mEs + K], scE[:, mEs + K:]], dim=2)
        scD_sp = scD[:, :mDs]
        scD_blk = torch.stack([scD[:, mDs:mDs + K], scD[:, mDs + K:]], dim=2)
        sfb = sf[:, None]
        yh_sp = scE_sp * y[:, :mEs]
        yh_g = scE_g * torch.stack([y[:, mEs:mEs + K], y[:, mEs + K:]], dim=2)
        wh_n = scD_blk[..., 0] * w_d[:, mDs:mDs + K]
        wh_dd = scD_blk[..., 1] * w_d[:, mDs + K:]
        y1, y2, y3 = yh_sp[:, :N], yh_sp[:, N:2 * N], yh_sp[:, 2 * N:3 * N]

        # ---------- JE_sp: one gather through the static JE_MAP ----------
        onesN = torch.ones((B, N), dtype=dtype, device=dev)
        je_vals = [onesN, -onesN, dt * v * sth, -dt * cth,
                   onesN, -onesN, -dt * v * cth, -dt * sth,
                   onesN, -onesN, -dt * onesN]
        if free:
            je_vals += [-Ts * v * cth, -Ts * v * sth, -Ts * w_in]
        je_vals.append(onesN.new_ones((B, 3)))
        if n_term:
            je_vals.append(onesN.new_ones((B, n_term)))
        vp = torch.cat([onesN.new_zeros((B, 1))] + je_vals, dim=1)
        JE_sp = scE_sp[..., None] * vp[:, c["JE_MAP"]] * c["ds_p"]

        # ---------- stationarity block Jacobian -------------------------
        A0, A1 = A[..., 0], A[..., 1]
        jth = torch.stack([m * (-sk * q1x + ck * q1y),
                           -m * (ck * q1x + sk * q1y)], dim=2)
        mE_ = m[..., None]
        ckE, skE = ck[..., None], sk[..., None]
        jlam = torch.stack([mE_ * (ckE * A0 + skE * A1),
                            mE_ * (-skE * A0 + ckE * A1)], dim=2)   # (B,K,2,E)
        jmu = c["gmu_pat"].expand(B, K, 2, 4)
        JEb_th = scE_g * jth * ds_slots[2]
        JEb_q = scE_g[..., None] * torch.cat([jlam, jmu], dim=3)

        # ---------- JD_sp: one gather through the static JD_MAP ----------
        jd_vals = []
        for lim in (data.a_max, data.alpha_max):
            jd_vals += [onesN, -onesN[:, 1:], -onesN, onesN[:, 1:]]
            if free:
                tcol = (lim[:, None] * Ts) * onesN
                jd_vals += [tcol, tcol]
        if n_dterm:
            jd_vals.append(c["dterm_sgn"].expand(B, n_dterm))
        vpD = torch.cat([onesN.new_zeros((B, 1))] + jd_vals, dim=1)
        JD_sp = scD_sp[..., None] * vpD[:, c["JD_MAP"]] * c["ds_p"]

        # ---------- norm/dist block Jacobians ---------------------------
        zK = torch.zeros_like(m)
        slots_dist = [m * q1x, m * q1y, m * off * (-sk * q1x + ck * q1y)]
        slots_norm = [zK, zK, zK]
        if S == 4:
            slots_dist.append(-m * Ts * c["ks_K"] * torch.einsum(
                "bkd,bkd->bk", q1, vel))
            slots_norm.append(zK)
        JDb_p_nat = torch.stack([torch.stack(slots_norm, dim=2),
                                 torch.stack(slots_dist, dim=2)], dim=2)
        d_norm_lam = -2.0 * mE_ * torch.einsum("bkd,bked->bke", q1, A)
        d_dist_lam = mE_ * (tx[..., None] * A0 + ty[..., None] * A1 - b)
        d_dist_mu = -mE_ * data.ego_g[:, None, :]
        z4 = torch.zeros((B, K, 4), dtype=dtype, device=dev)
        JDb_q_nat = torch.stack([torch.cat([d_norm_lam, z4], dim=2),
                                 torch.cat([d_dist_lam, d_dist_mu], dim=2)],
                                dim=2)
        JDb_p = scD_blk[..., None] * JDb_p_nat * c["ds_slots"]
        JDb_q = scD_blk[..., None] * JDb_q_nat

        # ---------- Lagrangian Hessian (spine block) --------------------
        h_thth = -(y1 * dt * v * cth + y2 * dt * v * sth)
        h_thv = -(y1 * dt * sth - y2 * dt * cth)
        hb_thth = -(yh_g[..., 0] * m * (-ck * q1x - sk * q1y)
                    + yh_g[..., 1] * m * (sk * q1x - ck * q1y)
                    + wh_dd * m * off * (-ck * q1x - sk * q1y))
        thth_all = (torch.cat([h_thth, onesN.new_zeros((B, 1))], dim=1)
                    + torch.cat([onesN.new_zeros((B, kl)),
                                 hb_thth.reshape(B, -1, nO).sum(2)], dim=1))

        eyeN1 = c["eyeN1"]
        Qcols = sf[:, None, None, None] * torch.cat(
            [Q2[..., None].expand(B, 3, 3, N), P2[..., None]], dim=3)
        e3 = c["e3"]
        Hxx4 = (Qcols.permute(0, 1, 3, 2)[..., None]
                * eyeN1[None, None, :, None, :]
                + (e3[:, None, None, None] * e3[None, None, :, None])[None]
                * (eyeN1 * thth_all[:, :, None])[:, None, :, None, :])
        Hxx = Hxx4.reshape(B, 3 * (N + 1), 3 * (N + 1))

        diagv = sf[:, None, None, None] * (R12[..., None]
                                           + R22[..., None] * c["cnt"] / dt2[..., None])
        bandv = sf[:, None, None] * (-R22 / dt2)
        Huu4 = (diagv.permute(0, 1, 3, 2)[..., None] * c["eyeN"][None, None, :, None, :]
                + bandv[:, :, None, :, None] * c["bandN"][None, None, :, None, :])
        Huu = Huu4.reshape(B, 2 * N, 2 * N)

        Mvth = c["rectNT"] * h_thv[:, :, None]                   # (B, N, N+1)
        zN1 = onesN.new_zeros((B, N, N + 1))
        Hux = torch.cat([torch.cat([zN1, zN1, Mvth], dim=2),
                         onesN.new_zeros((B, N, 3 * (N + 1)))], dim=1)

        if free:
            h_thT = -(y1 * Ts * v * sth - y2 * Ts * v * cth)
            h_vT = -(-y1 * Ts * cth - y2 * Ts * sth)
            h_wT = y3 * Ts
            g_accT = -2.0 * g_acc / T[:, None, None]
            HTu = torch.cat([sfb * g_accT[:, 0] + h_vT,
                             sfb * g_accT[:, 1] + h_wT], dim=1)[:, None, :]
            HTx = torch.cat([onesN.new_zeros((B, 2 * (N + 1))), h_thT,
                             onesN.new_zeros((B, 1))], dim=1)[:, None, :]
            HTT = (sf * (6.0 * cost_acc / T ** 2
                         + 2.0 * data.time_c2 * (N + 1)))[:, None, None]
            Hpp = torch.cat([
                torch.cat([HTT, HTu, HTx], dim=2),
                torch.cat([tr(HTu), Huu, Hux], dim=2),
                torch.cat([tr(HTx), tr(Hux), Hxx], dim=2)], dim=1)
        else:
            Hpp = torch.cat([torch.cat([Huu, Hux], dim=2),
                             torch.cat([tr(Hux), Hxx], dim=2)], dim=1)
        Hpp = Hpp * c["ds_pp"]

        # coupling Hpq_c (K, S, bq): rows x, y, th[, T]; lam columns only
        whE = wh_dd[..., None]
        dth_lam = mE_ * (-skE * A0 + ckE * A1)
        dth_lam2 = mE_ * (-ckE * A0 - skE * A1)
        rows_c = [-whE * mE_ * A0, -whE * mE_ * A1,
                  -(yh_g[..., 0, None] * dth_lam + yh_g[..., 1, None] * dth_lam2
                    + whE * off[..., None] * dth_lam)]
        if S == 4:
            rows_c.append(whE * mE_ * Ts[..., None] * c["ks_K"][:, None]
                          * torch.einsum("bked,bkd->bke", A, vel))
        Hpq_c = torch.cat([torch.stack(rows_c, dim=2),
                           onesN.new_zeros((B, K, S, 4))], dim=3)
        Hpq_c = Hpq_c * c["ds_slots"][:, None]

        # block diagonal Hqq: norm-row curvature + pin/prox diagonals
        AAT = torch.einsum("bked,bkfd->bkef", A, A)
        eyeE = torch.eye(E, dtype=dtype, device=dev)
        H_ll = (2.0 * wh_n[..., None, None] * m[..., None, None] * AAT
                + eyeE * (sf[:, None, None] * coef_l)[:, :, None, :])
        H_mm = (torch.eye(4, dtype=dtype, device=dev)
                * (sf[:, None] * coef_m[..., 0])[..., None, None])
        zE4 = onesN.new_zeros((B, K, E, 4))
        Hqq = torch.cat([torch.cat([H_ll, zE4], dim=3),
                         torch.cat([zE4.transpose(-1, -2), H_mm], dim=3)], dim=2)

        return KKTBundle(f=sf * f_nat, g=sfb * g_nat * c["ds"],
                         cE=cE_nat * scE, cD=cD_nat * scD, JE_sp=JE_sp,
                         JEb_th=JEb_th, JEb_q=JEb_q, JD_sp=JD_sp,
                         JDb_p=JDb_p, JDb_q=JDb_q, Hpp=Hpp, Hpq_c=Hpq_c,
                         Hqq=Hqq)

    def provider(zv, data, sf, scE, scD, y, w_d, *, data_flat=None,
                 impl=None) -> KKTBundle:
        if kernels.runs_plain(zv, impl):
            return plain(zv, data, sf, scE, scD, y, w_d)
        return kernels.obca_kkt_provider(
            spec, lay, consts.on(zv.device, zv.dtype)["ds"], zv,
            kernels.pack_obca_data(data) if data_flat is None else data_flat,
            sf, scE, scD, y, w_d)

    provider.plain = plain
    return lay, provider
