"""Static layout and the structured products of the fused Newton body.

The JAX package's fused path (``solver/ipm.py:647-732``) applies JE, JI
and their transposes in compressed arrow coordinates: a spine vector
``p (B, np)`` and a block tensor ``q (B, K, bq)`` that together partition
flat z. It lands block->spine accumulations through constant one-hot
dots, a TPU layout device; here they are gathers, ``index_add`` where
no target repeats, and static gather-sum tables where one does (the time
scale's spine slot, shared by every step under coupled motion), the same
sums in a fixed order.

:class:`FusedLayout` holds the numpy index maps, built once per
:class:`OBCASpec`, and moves them to a device once
(:meth:`FusedLayout.ops`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import obca as _obca
from ..models.obca_struct import StructLayout


def sum_plan(idx, n_out):
    """Static plan of ``zeros(n_out).index_add(0, idx, vals)`` in a fixed
    order: ``(table (rep, U), land (n_out,))``. Column u of ``table``
    lists the sources of the u-th distinct target in source order, padded
    with ``len(idx)`` (a zero appended to the values); ``land`` maps an
    output position to 0 (nothing lands there) or 1 + its target's
    column. Where no target repeats (rep = 1) the sums are index_add's
    bits: 0 + v."""
    idx = np.asarray(idx, np.int64).reshape(-1)
    tgt = np.unique(idx)
    rows = [np.nonzero(idx == t)[0] for t in tgt]
    table = np.full((max((len(r) for r in rows), default=0), len(tgt)), idx.shape[0], np.int64)
    for c, r in enumerate(rows):
        table[:len(r), c] = r
    land = np.zeros(n_out, np.int64)
    land[tgt] = 1 + np.arange(len(tgt))
    return table, land


def fixed_sum(vals, table, land):
    """(B, len(idx)) values summed per target by a :func:`sum_plan`, in
    source order, as (B, n_out): no atomics, so the same bits on every run
    and at every batch size."""
    B = vals.shape[0]
    z = torch.cat([vals, vals.new_zeros((B, 1))], dim=1)
    acc = vals.new_zeros((B, table.shape[1]))
    for j in range(table.shape[0]):
        acc = acc + z[:, table[j]]
    return torch.cat([vals.new_zeros((B, 1)), acc], dim=1)[:, land]


class FusedLayout:
    """Index maps of one problem family (numpy, built once)."""

    def __init__(self, spec: _obca.OBCASpec, lay: StructLayout, d_scale):
        self.spec, self.lay = spec, lay
        self.ds = np.asarray(d_scale, np.float64)
        self.n, self.np_, self.K, self.bq = lay.n, lay.np_, lay.K, lay.bq
        self.E = lay.bq - 4
        self.S, self.n_k, self.nO = lay.S, lay.n_k, lay.nO
        self.mE_sp, self.mD_sp, self.mE, self.mD = (lay.mE_sp, lay.mD_sp,
                                                    lay.mE, lay.mD)
        self.id_idx = _obca.ineq_identity_layout(spec)
        self.m_id = lay.m_id
        self.mI = self.m_id + lay.mD
        perm = np.concatenate([lay.p_idx, lay.q_idx.reshape(-1)])
        inv_perm = np.empty(lay.n, np.int64)
        inv_perm[perm] = np.arange(lay.n)
        nO = lay.nO
        slot_pos = lay.pq_pos[:, ::nO]                        # (S, n_k)
        cl = (slot_pos.T[:, :, None] * lay.np_
              + slot_pos.T[:, None, :])                       # (n_k, S, S)
        # x/u/T bound rows -> spine positions; lower and upper bound rows
        # share a position, so the sum is a product with a 0/1 matrix
        # (deterministic on CUDA, unlike index_add with repeated indices)
        E_id = np.zeros((lay.id_p_pos.shape[0], lay.np_))
        E_id[np.arange(lay.id_p_pos.shape[0]), lay.id_p_pos] = 1.0
        # flat (row * n + col) positions of the arrow pieces in the dense
        # W (n, n) and JE (mE, n), for the QR path's dense saddle matrix
        n, p_idx, q_idx = lay.n, lay.p_idx, lay.q_idx
        slot_flat = p_idx[lay.pq_pos.T]                       # (K, S)
        q_pq = np.broadcast_to(q_idx[:, None, :], (lay.K, lay.S, lay.bq))
        s_pq = np.broadcast_to(slot_flat[:, :, None], q_pq.shape)
        rows_b = np.arange(2)[None, :] * lay.K + np.arange(lay.K)[:, None]
        # under coupled motion (S = 4) every step's T slot is spine position
        # 0: the slot and clique sums repeat targets, and index_add's
        # atomics would add them in another order on every run
        slot_tab, slot_land = sum_plan(slot_pos, lay.np_)
        clique_tab, clique_land = sum_plan(cl, lay.np_ * lay.np_)
        self._np = dict(
            ds=self.ds, p_idx=lay.p_idx, q_flat=lay.q_idx.reshape(-1),
            inv_perm=inv_perm, pq_pos=lay.pq_pos, th_pos=lay.th_pos,
            slot_pos=slot_pos.reshape(-1), th_step=slot_pos[2],
            id_idx=self.id_idx, id_p_pos=lay.id_p_pos, E_id=E_id,
            clique_idx=cl.reshape(-1), clique_tab=clique_tab, clique_land=clique_land,
            slot_tab=slot_tab, slot_land=slot_land,
            w_pp=(p_idx[:, None] * n + p_idx[None, :]).reshape(-1),
            w_pq=(s_pq * n + q_pq).reshape(-1),
            w_qp=(q_pq * n + s_pq).reshape(-1),
            w_qq=(q_idx[:, :, None] * n + q_idx[:, None, :]).reshape(-1),
            je_sp=(np.arange(lay.mE_sp)[:, None] * n + p_idx[None, :]).reshape(-1),
            je_th=((lay.mE_sp + rows_b) * n + slot_flat[:, 2:3]).reshape(-1),
            je_q=((lay.mE_sp + rows_b)[:, :, None] * n
                  + q_idx[:, None, :]).reshape(-1),
        )
        self._ops = {}

    def ops(self, device, dtype):
        key = (str(device), dtype)
        if key not in self._ops:
            t = {k: torch.as_tensor(np.array(v), device=device,
                                    dtype=(torch.int64 if v.dtype.kind in "iu"
                                           else dtype))
                 for k, v in self._np.items()}
            self._ops[key] = FusedOps(self, t)
        return self._ops[key]


class FusedOps:
    """The structured products on one device; every method is batched
    over the leading lane dimension."""

    def __init__(self, L: FusedLayout, t):
        self.L = L
        for k, v in t.items():
            setattr(self, k, v)

    def red(self, vK):
        """(B, K, ...) block-major -> (B, n_k, ...) summed over the nO
        obstacles of each step."""
        B = vK.shape[0]
        return vK.reshape((B, self.L.n_k, self.L.nO) + vK.shape[2:]).sum(2)

    def slot_add(self, red):
        """(B, n_k, S) per-(step, slot) values -> (B, np) added at the
        slot's spine position (E_slot @ red^T)."""
        B = red.shape[0]
        return fixed_sum(red.transpose(1, 2).reshape(B, -1), self.slot_tab, self.slot_land)

    def slots_of(self, dp):
        """(B, np) -> (B, S, K) spine slot values of each block."""
        return dp[:, self.pq_pos]

    def f_flat(self, p, q):
        """(p, q) -> flat (B, n)."""
        return torch.cat([p, q.reshape(q.shape[0], -1)], dim=1)[:, self.inv_perm]

    def split(self, v):
        """flat (B, n) -> (p (B, np), q (B, K, bq))."""
        L = self.L
        return v[:, self.p_idx], v[:, self.q_flat].reshape(-1, L.K, L.bq)

    def _pairs(self, v, m_sp):
        K = self.L.K
        return torch.stack([v[:, m_sp:m_sp + K], v[:, m_sp + K:]], dim=2)

    # JE^T and JD^T run in every Newton iteration on the card. Their sums
    # are products then a sum over the rows, not einsums: a batched
    # matmul's kernel, and so a lane's bits, change with the batch size,
    # which a compacted solve changes (solver/compact.py). torch's
    # reduction kept one order for a lane at every batch size that
    # tests/test_torch_cuda.py checks on the card (1 to 256 lanes of the
    # free batch); that is a property of its launch heuristics at these
    # widths, checked there, not a guarantee.
    def f_jeT(self, bnd, yv):
        """JE^T yv -> (p, q). (th_step, a step's heading position, never
        repeats: its index_add has no two adds to one target.)"""
        yg = self._pairs(yv, self.L.mE_sp)                     # (B, K, 2)
        p = (bnd.JE_sp * yv[:, :self.L.mE_sp, None]).sum(1)
        p = p.index_add(1, self.th_step,
                        self.red(torch.sum(yg * bnd.JEb_th, dim=2)))
        q = (yg[..., None] * bnd.JEb_q).sum(2)
        return p, q

    def f_jdT(self, bnd, wv):
        """JD^T wv (dense inequality rows only) -> (p, q)."""
        wg = self._pairs(wv, self.L.mD_sp)
        contrib = self.red((wg[..., None] * bnd.JDb_p).sum(2))
        p = ((bnd.JD_sp * wv[:, :self.L.mD_sp, None]).sum(1)
             + self.slot_add(contrib))
        q = (wg[..., None] * bnd.JDb_q).sum(2)
        return p, q

    def box_add(self, p_vals):
        """(B, n_box) bound-row values -> (B, np) summed per spine
        position."""
        return p_vals @ self.E_id

    def id_split(self, sv):
        """Identity-row values -> (block adds (B, K, bq), spine-row
        values (B, n_box))."""
        L = self.L
        B, nE = sv.shape[0], L.K * L.E
        q_add = torch.cat([sv[:, :nE].reshape(B, L.K, L.E),
                           sv[:, nE:L.K * L.bq].reshape(B, L.K, 4)], dim=2)
        return q_add, sv[:, L.K * L.bq:]

    def f_jiT(self, bnd, wv, sgn_eff):
        """JI^T wv (identity + dense rows) -> (p, q)."""
        m_id = self.L.m_id
        p, q = self.f_jdT(bnd, wv[:, m_id:])
        q_add, p_vals = self.id_split(sgn_eff * wv[:, :m_id])
        return p + self.box_add(p_vals), q + q_add

    def clique(self, cliq):
        """(B, K, S, S) per-block spine cliques -> dense (B, np, np),
        reduced over the obstacles of each step."""
        B, np_ = cliq.shape[0], self.L.np_
        out = fixed_sum(self.red(cliq).reshape(B, -1), self.clique_tab, self.clique_land)
        return out.reshape(B, np_, np_)

    def f_ji(self, bnd, dz, sgn_eff):
        """JI dz -> (B, mI) in row order [identity; dense]."""
        dzp, dzq = self.split(dz)
        idr = sgn_eff * dz[:, self.id_idx]
        sp = torch.einsum("brc,bc->br", bnd.JD_sp, dzp)
        blk = (torch.einsum("bkrs,bsk->bkr", bnd.JDb_p, self.slots_of(dzp))
               + torch.einsum("bkrc,bkc->bkr", bnd.JDb_q, dzq))
        return torch.cat([idr, sp, blk[..., 0], blk[..., 1]], dim=1)

    def f_jev(self, bnd, dp, dq):
        """JE (dp, dq) -> (B, mE)."""
        sp = torch.einsum("brc,bc->br", bnd.JE_sp, dp)
        gv = (bnd.JEb_th * dp[:, self.th_pos][..., None]
              + torch.einsum("bkrc,bkc->bkr", bnd.JEb_q, dq))
        return torch.cat([sp, gv[..., 0], gv[..., 1]], dim=1)
