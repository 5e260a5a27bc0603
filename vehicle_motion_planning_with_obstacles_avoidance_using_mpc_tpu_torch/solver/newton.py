"""The fused arrow-KKT Newton solve: assembly, Schur complement, AL solve.

Counterpart of the JAX package's fused Newton step (``solver/ipm.py``:
G assembly ``:882-927``, ``kkt_solve_fused`` ``:937-980``, rungs
``:982-994``). For each regularization rung delta it solves the
augmented-Lagrangian kernel

    G = W + delta*I + JE^T JE / dd,   W = H + JI^T (W/S) JI

by its block-arrow structure: invert every (bq x bq) dual block
Gqq + delta*I (:func:`.ipm.spd_inv`), form the spine Schur complement
S = Gpp + delta*I - clique(Gpq Gqq^-1 Gqp), invert it, then run the AL
solve with ``n_refine`` refinement passes against the delta_d-regularized
saddle system and the curvature test. A non-SPD block or Schur
complement gives NaN, which rejects the rung.

The rungs are a batch dimension R. Three stages, each a plain PyTorch
version beside a dispatcher that launches the CUDA kernel of
``kernels/csrc/newton.cu`` on CUDA tensors:

    newton_assemble -> spd_inv(m=bq) -> newton_schur -> spd_inv(np)
    -> newton_al_solve
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from .fused import FusedOps


def newton_assemble_plain(ops: FusedOps, bnd, sigma, sgn_eff, ladder, dd,
                          w_only=False):
    """W and G = W + JE^T JE/dd pieces; Gqq carries each rung's delta.

    Returns ``Wpp (B,np,np), Wpq (B,K,S,bq), Wqq (B,K,bq,bq),
    Gpp0 (B,np,np), Gpq0 (B,K,S,bq), Gqq (B,R,K,bq,bq)``; with ``w_only``
    (the QR rung, which reads W alone) only the first three.
    """
    L = ops.L
    m_id, mD_sp, K = L.m_id, L.mD_sp, L.K
    B = sigma.shape[0]
    diag_q, diag_p_vals = ops.id_split(sgn_eff * sgn_eff * sigma[:, :m_id])
    diag_p = ops.box_add(diag_p_vals)
    sig_sp = sigma[:, m_id:m_id + mD_sp]
    sig_blk = torch.stack([sigma[:, m_id + mD_sp:m_id + mD_sp + K],
                           sigma[:, m_id + mD_sp + K:]], dim=2)   # (B, K, 2)

    JDs_sp = bnd.JD_sp * sig_sp[..., None]
    cliq = torch.einsum("bkr,bkrs,bkrt->bkst", sig_blk, bnd.JDb_p, bnd.JDb_p)
    Wpp = (bnd.Hpp + JDs_sp.transpose(1, 2) @ bnd.JD_sp
           + torch.diag_embed(diag_p) + ops.clique(cliq))
    Wpq = bnd.Hpq_c + torch.einsum("bkr,bkrs,bkrc->bksc", sig_blk,
                                   bnd.JDb_p, bnd.JDb_q)
    Wqq = (bnd.Hqq + torch.einsum("bkr,bkrc,bkrd->bkcd", sig_blk,
                                  bnd.JDb_q, bnd.JDb_q)
           + torch.diag_embed(diag_q))
    if w_only:
        return Wpp, Wpq, Wqq

    th2 = ops.red(torch.sum(bnd.JEb_th ** 2, dim=2)) / dd          # (B, n_k)
    Gpp0 = Wpp + (bnd.JE_sp.transpose(1, 2) @ bnd.JE_sp) / dd
    Gpp0 = Gpp0 + torch.diag_embed(
        sigma.new_zeros((B, L.np_)).index_add(1, ops.th_step, th2))
    e_th = sigma.new_zeros((L.S,))
    e_th[2] = 1.0
    Gpq0 = Wpq + (e_th[None, None, :, None]
                  * torch.einsum("bkr,bkrc->bkc", bnd.JEb_th,
                                 bnd.JEb_q)[:, :, None, :] / dd)
    Gqq0 = Wqq + torch.einsum("bkrc,bkrd->bkcd", bnd.JEb_q, bnd.JEb_q) / dd
    eye_b = torch.eye(L.bq, dtype=sigma.dtype, device=sigma.device)
    Gqq = Gqq0[:, None] + ladder[:, :, None, None, None] * eye_b
    return Wpp, Wpq, Wqq, Gpp0, Gpq0, Gqq


def newton_schur_plain(ops: FusedOps, Qinv, Gpq0, Gpp0, ladder):
    """Yq = Gqq^-1 Gqp (B,R,K,bq,S) and the spine Schur complement
    S = Gpp0 + delta*I - clique(Gpq Yq) (B,R,np,np)."""
    L = ops.L
    B, R = ladder.shape
    Yq = torch.einsum("brkcd,bksd->brkcs", Qinv, Gpq0)
    SS = torch.einsum("bksc,brkct->brkst", Gpq0, Yq)
    eye_p = torch.eye(L.np_, dtype=Gpp0.dtype, device=Gpp0.device)
    Gpp = Gpp0[:, None] + ladder[..., None, None] * eye_p
    S = Gpp - ops.clique(SS.reshape((B * R,) + SS.shape[2:])).reshape(
        B, R, L.np_, L.np_)
    return Yq, S


class SchurTilePlan(NamedTuple):
    """Which steps and clique rows each row tile of the spine holds
    (``kernels/csrc/newton.cu``'s Schur section reads ``table``)."""
    table: np.ndarray   # int32: the two CSR offsets, the tiles' step ranges,
    #                     the step entries, the clique rows
    tiles: int          # tiles a lane
    rows: int           # rows a tile (the last may hold fewer)
    steps: int          # step entries over all tiles
    crows: int          # clique rows over all tiles
    max_steps: int      # step entries of a tile, at most
    max_crows: int      # clique rows of a tile, at most


def schur_tile_plan(L, rows) -> SchurTilePlan:
    """The static clique plan of the Schur complement for row tiles of
    ``rows`` spine rows: a clique row is the spine position of slot s of
    step j (``L.lay.pq_pos``, one per block's step), whose S x S block of
    entries ``clique`` touches; under coupled motion (S = 4) slot 3 is T,
    position 0, a clique row of every step, so its tile holds every step.
    Per tile, its steps in order, each as (j, owner, the positions of its
    S slots), owner 1 in the tile of the step's lowest state row (which
    writes the step's Yq), then its clique rows in row order, each as (row
    in the tile, s, the step's index in the tile). Each tile's steps are
    also given as two ranges of consecutive steps (j_a, n_a, j_b, n_b),
    beside the offsets."""
    lay, nO, n_k, np_ = L.lay, L.nO, L.n_k, L.np_
    slot_pos = np.asarray(lay.pq_pos)[:, ::nO]          # (S, n_k)
    where = {}
    for s in range(L.S):
        for j in range(n_k):
            where.setdefault(int(slot_pos[s, j]), []).append((s, j))
    owner = slot_pos[:3].min(0) // rows                 # (n_k,)
    tiles = -(-np_ // rows)
    step_ptr, row_ptr, ranges, step_ents, row_ents = [0], [0], [], [], []
    max_steps = max_crows = 0
    for t in range(tiles):
        cl = [(r - t * rows, s, j) for r in range(t * rows, min(np_, (t + 1) * rows))
              for s, j in where.get(r, [])]
        js = sorted({j for _, _, j in cl})
        runs = [[j, 1] for j in js[:1]]
        for j in js[1:]:
            if j == runs[-1][0] + runs[-1][1]:
                runs[-1][1] += 1
            else:
                runs.append([j, 1])
        if len(runs) > 2:
            raise ValueError(f"schur_tile_plan: tile {t} holds {len(runs)} ranges of steps")
        ranges += (runs + [[0, 0]] * 2)[:2]
        step_ents += [[j, int(owner[j] == t), *slot_pos[:, j]] for j in js]
        row_ents += [[r, s, js.index(j)] for r, s, j in cl]
        step_ptr.append(len(step_ents))
        row_ptr.append(len(row_ents))
        max_steps, max_crows = max(max_steps, len(js)), max(max_crows, len(cl))
    table = np.concatenate([np.asarray(step_ptr), np.asarray(row_ptr),
                            np.asarray(ranges, np.int64).reshape(-1),
                            np.asarray(step_ents, np.int64).reshape(-1),
                            np.asarray(row_ents, np.int64).reshape(-1)]).astype(np.int32)
    return SchurTilePlan(table, tiles, rows, len(step_ents), len(row_ents), max_steps,
                         max_crows)


def newton_al_solve_plain(ops: FusedOps, bnd, Wpp, Wpq, Wqq, Gpq0, Qinv, Yq,
                          Sinv, rhs1, rhs2, ladder, dd, delta_d, n_refine):
    """AL solve + refinement + curvature test for every rung.

    Returns ``sol (B, R, n+mE)`` ([dz in flat order, v]) and
    ``good (B, R)`` = all-finite(sol) & curvature > 0.
    """
    R = ladder.shape[1]
    r1p, r1q = ops.split(rhs1)
    jt2p, jt2q = ops.f_jeT(bnd, rhs2)
    jt2p, jt2q = jt2p / dd, jt2q / dd

    def wmv(dp, dq):
        op = (torch.einsum("bpc,bc->bp", Wpp, dp)
              + ops.slot_add(ops.red(torch.einsum("bksc,bkc->bks", Wpq, dq))))
        oq = (torch.einsum("bksc,bsk->bkc", Wpq, ops.slots_of(dp))
              + torch.einsum("bkcd,bkd->bkc", Wqq, dq))
        return op, oq

    sols, goods = [], []
    for j in range(R):
        delta = ladder[:, j]
        Qi, Yj, Si = Qinv[:, j], Yq[:, j], Sinv[:, j]

        def gsolve(bp, bq_):
            wq = torch.einsum("bkcd,bkd->bkc", Qi, bq_)
            rp = bp - ops.slot_add(ops.red(
                torch.einsum("bksc,bkc->bks", Gpq0, wq)))
            dp = torch.einsum("bpc,bc->bp", Si, rp)
            dq = wq - torch.einsum("bkcs,bsk->bkc", Yj, ops.slots_of(dp))
            return dp, dq

        def al_solve(bp, bq_, r2, jtp, jtq):
            dp, dq = gsolve(bp + jtp, bq_ + jtq)
            return dp, dq, (ops.f_jev(bnd, dp, dq) - r2) / dd

        dp, dq, v = al_solve(r1p, r1q, rhs2, jt2p, jt2q)
        dl = delta[:, None]
        for _ in range(n_refine):
            wp_, wq_ = wmv(dp, dq)
            vp, vq = ops.f_jeT(bnd, v)
            res1p = wp_ + dl * dp + vp - r1p
            res1q = wq_ + dl[..., None] * dq + vq - r1q
            res2 = ops.f_jev(bnd, dp, dq) - delta_d * v - rhs2
            cp2, cq2 = ops.f_jeT(bnd, res2)
            cp, cq, cv = al_solve(res1p, res1q, res2, cp2 / dd, cq2 / dd)
            dp, dq, v = dp - cp, dq - cq, v - cv
        sol = torch.cat([ops.f_flat(dp, dq), v], dim=1)
        wp_, wq_ = wmv(dp, dq)
        curv = (torch.sum(dp * wp_, 1) + torch.sum(dq * wq_, dim=(1, 2))
                + delta * (torch.sum(dp * dp, 1) + torch.sum(dq * dq, dim=(1, 2))))
        sols.append(sol)
        goods.append(torch.isfinite(sol).all(1) & (curv > 0))
    return torch.stack(sols, dim=1), torch.stack(goods, dim=1)


def newton_assemble(ops, bnd, sigma, sgn_eff, ladder, dd, *, w_only=False,
                    impl=None):
    if kernels.runs_plain(sigma, impl):
        return newton_assemble_plain(ops, bnd, sigma, sgn_eff, ladder, dd,
                                     w_only)
    return kernels.newton_assemble(ops.L, bnd, sigma, sgn_eff, ladder, dd,
                                   w_only)


def newton_schur(ops, Qinv, Gpq0, Gpp0, ladder, *, impl=None):
    if kernels.runs_plain(Gpp0, impl):
        return newton_schur_plain(ops, Qinv, Gpq0, Gpp0, ladder)
    return kernels.newton_schur(ops.L, Qinv, Gpq0, Gpp0, ladder)


def newton_al_solve(ops, bnd, Wpp, Wpq, Wqq, Gpq0, Qinv, Yq, Sinv, rhs1,
                    rhs2, ladder, dd, delta_d, n_refine, *, impl=None):
    if kernels.runs_plain(rhs1, impl):
        return newton_al_solve_plain(ops, bnd, Wpp, Wpq, Wqq, Gpq0, Qinv, Yq,
                                     Sinv, rhs1, rhs2, ladder, dd, delta_d,
                                     n_refine)
    return kernels.newton_al_solve(ops.L, bnd, Wpp, Wpq, Wqq, Gpq0, Qinv, Yq,
                                   Sinv, rhs1, rhs2, ladder, dd, delta_d,
                                   n_refine)
