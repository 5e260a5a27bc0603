"""The interior-point solver over user callables, its derivatives by AD.

PyTorch counterpart of the JAX package's ``solver/ipm.py:359``
``build_solver`` for every ``kkt`` family that needs no analytic provider:

* ``arrow`` with ``hessian_coloring`` and a declared ``arrow`` layout (the
  structured path, ``ipm.py:995-1125``): the Lagrangian Hessian from HVP
  probes (one per spine column plus one per block slot, or the model's
  grouped spine probes with ``spine_coloring``), W and the AL kernel
  G = W + delta*I + JE^T JE / dd built in arrow form (App, Apq, Aqq), the
  K dual blocks and the spine Schur complement inverted by
  :func:`.ipm.spd_inv` (the ``spd_inv`` kernels on the card);
* ``arrow`` without coloring (``ipm.py:1289-1339``): a dense Hessian,
  the arrow gathered from the dense G, ``spd_inv`` for the blocks and a
  Cholesky of the spine;
* ``al_chol`` (``ipm.py:1263-1287``) and ``chol`` (``ipm.py:1224-1258``):
  dense Cholesky factorizations;
* ``qr`` (``ipm.py:1341-1360``): a Householder QR of the assembled
  (n+mE)^2 saddle matrix, the ``kkt_qr_dense`` kernel on the card.

Without a declared ``arrow`` layout ``arrow`` falls back to ``al_chol``, and
``fused`` (which needs an analytic provider, :func:`.ipm.build_fused_solver`)
to ``arrow``, as in the JAX package.

The callables are per problem, ``f_fn(z, params) -> ()``, ``cE_fn -> (mE,)``,
``cI_fn -> (mI,)``. The solver batches them over a leading lane dimension
with ``torch.func.vmap`` and differentiates them with ``torch.func.grad``,
``jacrev``, ``jvp`` (the HVPs) and ``hessian``. The variables are a pytree
of dicts (flattened in sorted-key order, as ``ravel_pytree``), lists and
tensors; ``params`` any pytree whose tensors carry the lane dimension.

The state is :class:`.ipm.IPMState` and the Newton loop is :mod:`.loop`'s,
for every family: on CUDA tensors a captured CUDA graph of the body and the
``ipm_freeze`` kernel, on CPU tensors the host loop. The body shares the
fused solver's iteration start (:func:`.ipm.iteration_start`) and its step
and filter line search (:func:`.linesearch.filter_step`); only the Newton
solve and the trials' model differ. A Cholesky solve is two
``solve_triangular`` calls (the JAX package's ``cho_solve``), which a CUDA
graph captures, where ``torch.cholesky_solve`` (MAGMA on CUDA) cannot be.

The identity inequality rows' scatter-adds (``.at[idx].add`` with repeated
indices) are gathers over a static table of each target's rows, summed in
row order, and every dense assembly from probe outputs is one gather: no
``index_add``, whose order on CUDA is not reproducible.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import grad, hessian, jacrev, jvp, vmap
from torch.utils import _pytree as pytree

from .. import kernels
from . import loop as _loop
from . import qr as _qr
from .ipm import (IPMOptions, IPMResult, IPMState, final_status, gradient_scale, initial_state,
                  iteration_start, spd_inv)
from .linesearch import filter_step


# ------------------------------------------------------------ pytree ravel

def _leaves(tree):
    """Leaves in ``ravel_pytree`` order: dict keys sorted, sequences in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        vals = [_rebuild(v, it) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)
    return next(it)


class Flat:
    """The flat layout of a variable pytree (``z_example``'s structure,
    one problem): :meth:`ravel` of a batch, :meth:`unravel` of one lane's
    (n,) vector or, with ``batched``, of a (B, n) batch."""

    def __init__(self, example):
        self.example = example
        self.shapes = [tuple(np.shape(leaf)) for leaf in _leaves(example)]
        self.sizes = [int(np.prod(s)) if s else 1 for s in self.shapes]
        self.n = sum(self.sizes)

    def ravel(self, zb):
        leaves = list(_leaves(zb))
        B = leaves[0].shape[0]
        return torch.cat([leaf.reshape(B, -1) for leaf in leaves], dim=1)

    def unravel(self, zv, batched=False):
        lead = zv.shape[:1] if batched else ()
        pieces, off = [], 0
        for shape, cnt in zip(self.shapes, self.sizes):
            pieces.append(zv[..., off:off + cnt].reshape(lead + shape))
            off += cnt
        return _rebuild(self.example, iter(pieces))


class _NoData(NamedTuple):
    """The graph loop's ``data`` for the AD solver: its parameters' tensors
    travel in the loop's ``extra`` (any pytree, not a NamedTuple)."""


def _in_dims(params):
    """vmap's in_dims for ``params``: 0 on tensors, None elsewhere."""
    return pytree.tree_map(lambda t: 0 if isinstance(t, torch.Tensor) else None, params)


# ------------------------------------------------------ deterministic adds

class _RowAdd:
    """``base.at[idx].add(vals)`` over a lane dimension, deterministic: each
    target index gathers its rows from a static table and adds them in row
    order (the order of the JAX package's sequential scatter on the CPU),
    then lands by a gather through the inverse map (no scatter)."""

    def __init__(self, idx, n):
        idx = np.asarray(idx, np.int64)
        m = idx.shape[0]
        self.tgt = np.unique(idx)
        rows = [np.nonzero(idx == t)[0] for t in self.tgt]
        rep = max((len(r) for r in rows), default=0)
        self.table = np.full((rep, len(self.tgt)), m, np.int64)   # m: a zero column
        for c, r in enumerate(rows):
            self.table[:len(r), c] = r
        # flat position -> its slot in [base; summed targets]
        self.land = np.arange(n, dtype=np.int64)
        self.land[self.tgt] = n + np.arange(len(self.tgt))
        self._dev = {}

    def _consts(self, device):
        if device not in self._dev:
            as_t = lambda a: torch.as_tensor(a, device=device)
            self._dev[device] = (as_t(self.tgt), as_t(self.table), as_t(self.land))
        return self._dev[device]

    def __call__(self, base, vals):
        tgt, table, land = self._consts(base.device)
        if tgt.numel() == 0:
            return base
        v = torch.cat([vals, vals.new_zeros(vals.shape[0], 1)], dim=1)
        acc = base[:, tgt]
        for j in range(table.shape[0]):
            acc = acc + v[:, table[j]]
        return torch.cat([base, acc], dim=1)[:, land]


def _gather_map(n_out, dest, src):
    """Static gather table: output position ``dest[i]`` takes source
    ``src[i]`` (the first one listed where a position repeats); the rest
    take the zero appended at the end of the source."""
    out = np.full(n_out, -1, np.int64)
    for d, s in zip(np.asarray(dest).reshape(-1), np.asarray(src).reshape(-1)):
        if out[d] < 0:
            out[d] = s
    return out


def _gather(src_flat, table):
    """``src_flat`` (B, m) through a :func:`_gather_map` table (-1: zero)."""
    z = torch.cat([src_flat, src_flat.new_zeros(src_flat.shape[0], 1)], dim=1)
    return z[:, table]


def _chol(A):
    """Cholesky factor, NaN over a matrix that is not SPD (the JAX
    package's ``jnp.linalg.cholesky`` signal that rejects a ladder rung);
    ``info`` stays on the device."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None], torch.full_like(L, float("nan")), L)


def _cho_solve_mat(L, b):
    """``cho_solve`` of (..., n, k) right-hand sides: L^-T (L^-1 b)."""
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def _cho_solve(L, b):
    """``cho_solve`` of (..., n) vectors ``b``."""
    return _cho_solve_mat(L, b[..., None])[..., 0]


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def arrow_al_solve(Wpp, Wpq, Wqq, Gpq0, Qinv, Yq, Sinv, JE_p, JE_q, r1p, r1q, rhs2, jt2p, jt2q,
                   ladder, dd, delta_d, n_refine):
    """The structured arrow family's augmented-Lagrangian solve of every
    rung (the JAX package's ``solver/ipm.py:1084-1115``): block
    elimination through the blocks' inverses ``Qinv (B,R,K,bq,bq)`` and
    the spine Schur inverse ``Sinv (B,R,np,np)``, then ``n_refine`` passes
    against the delta_d-regularised saddle system. W (Wpp (B,np,np), Wpq
    (B,np,K,bq), Wqq (B,K,bq,bq)), ``Gpq0`` (B,np,K,bq), ``Yq``
    (B,R,K,bq,np) and JE's spine and block columns (``JE_p`` (B,mE,np),
    ``JE_q`` (B,mE,K,bq)); right-hand sides per lane, ``jt2p``/``jt2q``
    = JE^T rhs2 / dd. Returns ``dp (B,R,np)``, ``dq (B,R,K,bq)``, ``v
    (B,R,mE)`` and ``good (B,R)``: curvature > 0 (finiteness is the
    caller's, on the assembled solution)."""
    B, R = ladder.shape

    def wmv(dp, dq):
        op = (torch.einsum("bpq,brq->brp", Wpp, dp)
              + torch.einsum("bpkc,brkc->brp", Wpq, dq))
        oq = (torch.einsum("bpkc,brp->brkc", Wpq, dp)
              + torch.einsum("bkcd,brkd->brkc", Wqq, dq))
        return op, oq

    def jev(dp, dq):
        return (torch.einsum("bmp,brp->brm", JE_p, dp)
                + torch.einsum("bmkc,brkc->brm", JE_q, dq))

    def jeT(v):
        return (torch.einsum("bmp,brm->brp", JE_p, v),
                torch.einsum("brm,bmkc->brkc", v, JE_q))

    def gsolve(bp, bq_):
        wq = torch.einsum("brkcd,brkd->brkc", Qinv, bq_)
        rp = bp - torch.einsum("bpkc,brkc->brp", Gpq0, wq)
        dp = torch.einsum("brpq,brq->brp", Sinv, rp)
        dq = wq - torch.einsum("brkcp,brp->brkc", Yq, dp)
        return dp, dq

    def al_solve(bp, bq_, r2, jtp, jtq):
        dp, dq = gsolve(bp + jtp, bq_ + jtq)
        return dp, dq, (jev(dp, dq) - r2) / dd

    up = lambda t: t[:, None].expand((B, R) + t.shape[1:])
    r1p_, r1q_, rhs2_ = up(r1p), up(r1q), up(rhs2)
    dp, dq, v = al_solve(r1p_, r1q_, rhs2_, up(jt2p), up(jt2q))
    dl, dl2 = ladder[..., None], ladder[..., None, None]
    for _ in range(n_refine):
        wp_, wq_ = wmv(dp, dq)
        vp, vq = jeT(v)
        res1p = wp_ + dl * dp + vp - r1p_
        res1q = wq_ + dl2 * dq + vq - r1q_
        res2 = jev(dp, dq) - delta_d * v - rhs2_
        cp2, cq2 = jeT(res2)
        cp, cq, cv = al_solve(res1p, res1q, res2, cp2 / dd, cq2 / dd)
        dp, dq, v = dp - cp, dq - cq, v - cv
    wp_, wq_ = wmv(dp, dq)
    curv = ((dp * wp_).sum(-1) + (dq * wq_).sum((-2, -1))
            + ladder * ((dp * dp).sum(-1) + (dq * dq).sum((-2, -1))))
    return dp, dq, v, curv > 0


# ------------------------------------------------------------------ solver

def build_solver(f_fn, cE_fn, cI_fn, z_example, options: IPMOptions = IPMOptions(),
                 z_scale=None, ineq_id=None, arrow=None, spine=None, impl=None, loop=None):
    """Solver for one problem family over user callables.

    ``f_fn``/``cE_fn``/``cI_fn``: ``(z, params) -> () / (mE,) / (mI,)`` for
    one problem; ``z_example`` fixes the variable pytree (one problem, no
    lane dimension); ``z_scale`` an optional pytree of typical magnitudes
    of the same structure. ``arrow``: optional (K, bq) flat-z indices of K
    mutually uncoupled variable blocks. ``spine``: optional grouped spine
    probes (:func:`..models.obca.hessian_spine_probes`). ``ineq_id``:
    optional ``(idx, sgn_off_fn, cI_dense_fn)`` declaring the identity
    inequality rows ``sgn * z_flat[idx] + off`` (``sgn_off_fn(params) ->
    (sgn, off)`` per problem); ``cI_fn`` must equal their concatenation
    with ``cI_dense_fn``'s rows.

    ``impl="plain"`` runs the plain versions of the kernels on any device;
    ``loop`` picks the Newton loop (None: the graph on CUDA tensors with the
    kernels, else the host loop).

    Returns ``solve(z0, params) -> IPMResult`` over a batch (``z0``'s
    leaves and ``params``' tensors carry a leading lane dimension), with
    the chunked API ``solve.init(z0, params)``, ``solve.iterate(st,
    params, it_cap)``, ``solve.step(st, params)`` (one Newton iteration,
    nothing frozen) and ``solve.finalize(st, params)``; ``solve.family``
    is the Newton step that runs and ``solve.loop_of(t)`` the loop it takes
    for tensors like ``t``.
    """
    opt = options
    if loop not in (None, "host", "graph"):
        raise ValueError(f"loop must be None, 'host' or 'graph', got {loop!r}")
    if loop == "graph" and impl == "plain":
        raise ValueError("loop='graph' runs the kernels; impl='plain' needs the host loop")
    fl = Flat(z_example)
    n = fl.n
    ds_np = (np.ones(n) if z_scale is None else
             np.concatenate([np.asarray(leaf, np.float64).reshape(-1)
                             for leaf in _leaves(z_scale)]))

    if ineq_id is None:
        id_idx = np.zeros((0,), np.int64)
        sgn_off_fn, cI_dense_fn = None, cI_fn
    else:
        id_idx, sgn_off_fn, cI_dense_fn = ineq_id
        id_idx = np.asarray(id_idx, np.int64)
    m_id = id_idx.shape[0]
    row_add = _RowAdd(id_idx, n)

    kkt_mode = opt.kkt
    if kkt_mode == "fused":
        kkt_mode = "arrow"        # no analytic provider here
    if kkt_mode not in ("arrow", "al_chol", "chol", "qr"):
        raise ValueError(f"unknown kkt family {opt.kkt!r}")
    if arrow is not None and np.asarray(arrow).size > 0:
        q_idx = np.asarray(arrow, np.int64)                  # (K, bq)
        pmask = np.ones(n, bool)
        pmask[q_idx.reshape(-1)] = False
        p_idx = np.nonzero(pmask)[0]                         # (np,)
        K_, bq = q_idx.shape
        n_p = p_idx.shape[0]
        inv_perm = np.empty(n, np.int64)
        inv_perm[np.concatenate([p_idx, q_idx.reshape(-1)])] = np.arange(n)
    else:
        q_idx = p_idx = None
        if kkt_mode == "arrow":
            kkt_mode = "al_chol"  # no structure declared: dense fallback
    arrow_structured = kkt_mode == "arrow" and opt.hessian_coloring and q_idx is not None
    family = "arrow_dense" if kkt_mode == "arrow" and not arrow_structured else kkt_mode

    # Hessian probes (IPMOptions.hessian_coloring): a unit probe per spine
    # variable, then one summed probe per block slot
    if q_idx is not None and opt.hessian_coloring:
        probes_np = np.zeros((n_p + bq, n))
        probes_np[np.arange(n_p), p_idx] = 1.0
        for j in range(bq):
            probes_np[n_p + j, q_idx[:, j]] = 1.0
    else:
        probes_np = None
    use_spine = spine is not None and arrow_structured and opt.spine_coloring
    tables = {}
    if use_spine:
        if not np.array_equal(np.asarray(spine["p_idx"]), p_idx):
            raise ValueError("spine pattern layout disagrees with the arrow complement")
        C_s = spine["probes"].shape[0]
        sp_probes = np.zeros((C_s + bq, n))
        sp_probes[:C_s] = spine["probes"]
        for j in range(bq):
            sp_probes[C_s + j, q_idx[:, j]] = 1.0
        probes_np = sp_probes
        scat = np.asarray(spine["scatter"], np.int64)
        tables["Hpp"] = _gather_map(n_p * n_p, scat[:, 0] * n_p + scat[:, 1],
                                    scat[:, 2] * n + scat[:, 3])
        pq_pos = np.asarray(spine["pq_pos"], np.int64)
        pq_group = np.asarray(spine["pq_group"], np.int64)
        dest = (pq_pos[:, :, None] * K_ + np.arange(K_)[None, :, None]) * bq + np.arange(bq)
        src = pq_group[:, None, None] * n + q_idx[None]
        tables["Hpq"] = _gather_map(n_p * K_ * bq, dest, src)
    elif probes_np is not None:
        tables["Hpp"] = (np.arange(n_p)[:, None] * n + p_idx[None, :]).reshape(-1)
        tables["Hpq"] = (np.arange(n_p)[:, None, None] * n + q_idx[None]).reshape(-1)
    if probes_np is not None:
        C0 = probes_np.shape[0] - bq       # the block-slot probes start here
        tables["Hqq"] = ((C0 + np.arange(bq))[None, None, :] * n
                         + q_idx[:, :, None]).reshape(-1)         # (K, b, j)
        if not arrow_structured:
            # dense H: H[:, p_j] = HV[j] (rows), then H[p_i, :] = HV[i]
            # over it, H[q_kb, q_kj] = HV[n_p + j][q_kb]
            H = np.full((n, n), -1, np.int64)
            H[:, p_idx] = (np.arange(n_p)[None, :] * n + np.arange(n)[:, None])
            H[p_idx, :] = np.arange(n_p)[:, None] * n + np.arange(n)[None, :]
            H[q_idx[:, :, None], q_idx[:, None, :]] = tables["Hqq"].reshape(K_, bq, bq)
            tables["H"] = H.reshape(-1)

    consts = {}

    def C(device, dtype):
        """Per-device constants."""
        key = (device, dtype)
        if key not in consts:
            t = lambda a, dt=dtype: torch.as_tensor(a, dtype=dt, device=device)
            c = {"ds": t(ds_np), "id_idx": t(id_idx, torch.int64)}
            if probes_np is not None:
                c["probes"] = t(probes_np)
            for k, v in tables.items():
                c[k] = t(v, torch.int64)
            if q_idx is not None:
                c.update(p_idx=t(p_idx, torch.int64), q_idx=t(q_idx, torch.int64),
                         inv_perm=t(inv_perm, torch.int64))
            consts[key] = c
        return consts[key]

    # ---- per-problem functions (one lane; the solver vmaps them)
    def make_fns(ds):
        def f_flat(zv, p):
            return f_fn(fl.unravel(zv * ds), p)

        def cE_flat(zv, p):
            return cE_fn(fl.unravel(zv * ds), p)

        def cI_flat(zv, p):
            return cI_fn(fl.unravel(zv * ds), p)

        def cI_dense_flat(zv, p):
            return cI_dense_fn(fl.unravel(zv * ds), p)

        def fs(zv, p, sf):
            return sf * f_flat(zv, p)

        def cEs(zv, p, scE):
            return scE * cE_flat(zv, p)

        def cDs(zv, p, scD):
            return scD * cI_dense_flat(zv, p)

        def lag(zv, p, sf, scE, scD, y, w_d):
            # identity rows are linear in z: zero curvature, left out
            return fs(zv, p, sf) - y @ cEs(zv, p, scE) - w_d @ cDs(zv, p, scD)

        return dict(f_flat=f_flat, cE_flat=cE_flat, cI_flat=cI_flat,
                    cI_dense_flat=cI_dense_flat, fs=fs, cEs=cEs, cDs=cDs, lag=lag)

    def ident(params, pd, c, dtype, B, device):
        """(sgn_eff, id_off), each (B, m_id); empty without ``ineq_id``."""
        if sgn_off_fn is None:
            z = torch.zeros((B, 0), dtype=dtype, device=device)
            return z, z
        sgn_raw, id_off = vmap(sgn_off_fn, in_dims=(pd,))(params)
        return sgn_raw.to(dtype) * c["ds"][c["id_idx"]], id_off

    def row_scales(J):
        return gradient_scale(opt, J.abs().amax(-1) if J.shape[-1] else J.new_zeros(J.shape[:-1]))

    def init_fn(z0_tree, params) -> IPMState:
        """Initial state; Ipopt-style gradient scaling fixed at z0."""
        zr = fl.ravel(z0_tree)
        dtype, dev, B = zr.dtype, zr.device, zr.shape[0]
        c = C(dev, dtype)
        z0 = zr / c["ds"]
        pd = _in_dims(params)
        F = make_fns(c["ds"])
        sgn_eff, id_off = ident(params, pd, c, dtype, B, dev)
        g0 = vmap(grad(F["f_flat"]), in_dims=(0, pd))(z0, params)
        JE0 = vmap(jacrev(F["cE_flat"]), in_dims=(0, pd))(z0, params)
        JD0 = vmap(jacrev(F["cI_dense_flat"]), in_dims=(0, pd))(z0, params)
        scE, scD = row_scales(JE0), row_scales(JD0)
        cD0 = scD * vmap(F["cI_dense_flat"], in_dims=(0, pd))(z0, params)
        sf = gradient_scale(opt, g0.abs().amax(1))
        cI0 = torch.cat([sgn_eff * z0[:, c["id_idx"]] + id_off, cD0], 1)
        return initial_state(opt, z0, cI0, sf, scE, scD)

    def body(st: IPMState, params, pd, sgn_eff, id_off) -> IPMState:
        zv, s, y, w = st.zv, st.s, st.y, st.w
        sf, scE, scD = st.sf, st.scE, st.scD
        dtype, dev, B = zv.dtype, zv.device, zv.shape[0]
        c = C(dev, dtype)
        F = make_fns(c["ds"])
        id_t = c["id_idx"]
        mE = scE.shape[1]
        lanes = lambda fn, *more: vmap(fn, in_dims=(0, pd) + more)

        def cI_of(zt):
            return torch.cat([sgn_eff * zt[:, id_t] + id_off,
                              scD * lanes(F["cI_dense_flat"])(zt, params)], 1)

        def jiT_apply(JD, u):
            dense = (JD.transpose(1, 2) @ u[:, m_id:, None])[..., 0]
            return row_add(dense, sgn_eff * u[:, :m_id])

        def ji_apply(JD, dz):
            return torch.cat([sgn_eff * dz[:, id_t], _mv(JD, dz)], 1)

        # ---- one evaluation set per iterate
        g = lanes(grad(F["fs"]), 0)(zv, params, sf)
        JE = lanes(jacrev(F["cEs"]), 0)(zv, params, scE)
        JD = lanes(jacrev(F["cDs"]), 0)(zv, params, scD)
        cE = scE * lanes(F["cE_flat"])(zv, params)
        cI = cI_of(zv)
        r_d = g - (JE.transpose(1, 2) @ y[..., None])[..., 0] - jiT_apply(JD, w)
        mu_b, done, acc_it, stall_it, best = iteration_start(opt, st, r_d, cE, cI, m_id)

        sigma = w / s
        rhs1 = -r_d - jiT_apply(JD, (w * cI - mu_b[:, None]) / s)
        rhs2 = -cE
        base = torch.clamp(st.delta, min=opt.delta0)
        ladder = base[:, None] * (opt.delta_step ** torch.arange(
            opt.n_deltas, dtype=dtype, device=dev))                   # (B, R)
        R = opt.n_deltas
        dd = opt.delta_d_al
        w_d = w[:, m_id:]
        lag_args = (zv, params, sf, scE, scD, y, w_d)

        def hv(probes):
            def one(z, p, sf_, scE_, scD_, y_, wd_):
                g_ = lambda z_: grad(F["lag"])(z_, p, sf_, scE_, scD_, y_, wd_)
                return vmap(lambda v: jvp(g_, (z,), (v,))[1])(probes)
            return lanes(one, 0, 0, 0, 0, 0)(*lag_args).reshape(B, -1)  # (B, C*n)

        eye_n = torch.eye(n, dtype=dtype, device=dev)
        lad = ladder[..., None, None]                                  # (B, R, 1, 1)

        def finish(dz, v, Wmat):
            sol = torch.cat([dz, v], -1)
            curv = (dz * _mv(Wmat[:, None], dz)).sum(-1) + ladder * (dz * dz).sum(-1)
            return sol, torch.isfinite(sol).all(-1) & (curv > 0)

        if arrow_structured:
            HV = hv(c["probes"])
            Hpp = _gather(HV, c["Hpp"]).reshape(B, n_p, n_p)
            Hpq = _gather(HV, c["Hpq"]).reshape(B, n_p, K_, bq)
            Hqq = HV[:, c["Hqq"]].reshape(B, K_, bq, bq)
            p_t, q_t = c["p_idx"], c["q_idx"]
            diag_n = row_add(zv.new_zeros(B, n), sgn_eff * sgn_eff * sigma[:, :m_id])
            sig_d = sigma[:, m_id:]
            JD_p, JD_q = JD[:, :, p_t], JD[:, :, q_t]                   # (B,mD,np), (B,mD,K,bq)
            JE_p, JE_q = JE[:, :, p_t], JE[:, :, q_t]
            JDs = JD_p * sig_d[..., None]
            Wpp = Hpp + JDs.transpose(1, 2) @ JD_p + torch.diag_embed(diag_n[:, p_t])
            Wpq = Hpq + torch.einsum("bma,bmkc->bakc", JDs, JD_q)
            Wqq = (Hqq + torch.einsum("bmkc,bmkd->bkcd", JD_q * sig_d[..., None, None], JD_q)
                   + torch.diag_embed(diag_n[:, q_t]))
            Gpp0 = Wpp + (JE_p.transpose(1, 2) @ JE_p) / dd
            Gpq0 = Wpq + torch.einsum("bma,bmkc->bakc", JE_p, JE_q) / dd
            Gqq0 = Wqq + torch.einsum("bmkc,bmkd->bkcd", JE_q, JE_q) / dd
            eye_p = torch.eye(n_p, dtype=dtype, device=dev)
            eye_b = torch.eye(bq, dtype=dtype, device=dev)

            r1p, r1q = rhs1[:, p_t], rhs1[:, q_t]
            jt2p = (JE_p.transpose(1, 2) @ rhs2[..., None])[..., 0] / dd
            jt2q = torch.einsum("bm,bmkc->bkc", rhs2, JE_q) / dd

            # every rung at once: (B, R, ...)
            Gqq = (Gqq0[:, None] + lad[..., None] * eye_b).contiguous()
            Qinv = spd_inv(Gqq, impl=impl)                              # (B,R,K,bq,bq)
            Yq = torch.einsum("brkcd,bpkd->brkcp", Qinv, Gpq0)          # (B,R,K,bq,np)
            Smat = (Gpp0[:, None] + lad * eye_p
                    - torch.einsum("bpkc,brkcq->brpq", Gpq0, Yq)).contiguous()
            Sinv = spd_inv(Smat, impl=impl)                             # (B,R,np,np)

            dp, dq, v, goods = arrow_al_solve(
                Wpp, Wpq, Wqq, Gpq0, Qinv, Yq, Sinv, JE_p, JE_q, r1p, r1q, rhs2, jt2p, jt2q,
                ladder, dd, opt.delta_d, opt.n_refine)
            dz = torch.cat([dp, dq.reshape(B, R, -1)], -1)[..., c["inv_perm"]]
            sols = torch.cat([dz, v], -1)
            goods = goods & torch.isfinite(sols).all(-1)
        else:
            if probes_np is None:
                H = lanes(hessian(F["lag"]), 0, 0, 0, 0, 0)(*lag_args)
            else:
                H = _gather(hv(c["probes"]), c["H"]).reshape(B, n, n)
            diag = row_add(zv.new_zeros(B, n), sgn_eff * sgn_eff * sigma[:, :m_id])
            W = (H + JD.transpose(1, 2) @ (sigma[:, m_id:, None] * JD)
                 + torch.diag_embed(diag))
            JEt = JE.transpose(1, 2)
            Wd = W[:, None] + lad * eye_n                                # (B, R, n, n)
            up = lambda t: t[:, None].expand((B, R) + t.shape[1:])
            r1, r2 = up(rhs1), up(rhs2)
            JE_r, JEt_r = up(JE), up(JEt)
            if kkt_mode == "chol":
                Lw = _chol(Wd)
                eye_m = torch.eye(mE, dtype=dtype, device=dev)
                WiJt = _cho_solve_mat(Lw, JEt_r)                         # (B,R,n,mE)
                Ls = _chol(JE_r @ WiJt + opt.delta_d * eye_m)

                def full_solve(a1, a2):
                    Wir1 = _cho_solve(Lw, a1)
                    vv = _cho_solve(Ls, _mv(JE_r, Wir1) - a2)
                    return Wir1 - _mv(WiJt, vv), vv

                dz, v = full_solve(r1, r2)
                res1 = _mv(Wd, dz) + _mv(JEt_r, v) - r1
                res2 = _mv(JE_r, dz) - opt.delta_d * v - r2
                dzc, vc = full_solve(res1, res2)
                dz, v = dz - dzc, v - vc
                sols, goods = finish(dz, v, W)
            elif kkt_mode == "qr":
                eye_m = torch.eye(mE, dtype=dtype, device=dev)
                Kmat = torch.cat([
                    torch.cat([Wd, JEt_r], -1),
                    torch.cat([JE_r, (-opt.delta_d * eye_m).expand(B, R, mE, mE)], -1)],
                    -2).contiguous()
                rhs = torch.cat([rhs1, rhs2], 1).contiguous()
                sols, goods = _qr.kkt_qr_dense(Kmat, rhs, n, impl=impl)
            else:
                JtJ_dd = (JEt @ JE) / dd
                Jt_rhs2_dd = _mv(JEt, rhs2) / dd
                G = Wd + JtJ_dd[:, None]
                if kkt_mode == "al_chol":
                    Lg = _chol(G)

                    def gsolve(b):
                        return _cho_solve(Lg, b)
                else:    # arrow gathered from the dense G
                    p_t, q_t = c["p_idx"], c["q_idx"]
                    Gqq = G[:, :, q_t[:, :, None], q_t[:, None, :]].contiguous()
                    Gpq = G[:, :, p_t[:, None, None], q_t[None, :, :]]   # (B,R,np,K,bq)
                    Gpp = G[:, :, p_t[:, None], p_t[None, :]]
                    Qinv = spd_inv(Gqq, impl=impl)
                    Yq = torch.einsum("brkcd,brpkd->brkcp", Qinv, Gpq)
                    Ls = _chol(Gpp - torch.einsum("brpkc,brkcq->brpq", Gpq, Yq))

                    def gsolve(b):
                        wq = torch.einsum("brkcd,brkd->brkc", Qinv, b[..., q_t])
                        rp = b[..., p_t] - torch.einsum("brpkc,brkc->brp", Gpq, wq)
                        dp = _cho_solve(Ls, rp)
                        dq = wq - torch.einsum("brkcp,brp->brkc", Yq, dp)
                        return torch.cat([dp, dq.reshape(B, R, -1)], -1)[..., c["inv_perm"]]

                def al_solve(a1, a2, jt):
                    dz_ = gsolve(a1 + jt)
                    return dz_, (_mv(JE_r, dz_) - a2) / dd

                dz, v = al_solve(r1, r2, up(Jt_rhs2_dd))
                for _ in range(opt.n_refine):
                    res1 = _mv(Wd, dz) + _mv(JEt_r, v) - r1
                    res2 = _mv(JE_r, dz) - opt.delta_d * v - r2
                    dzc, vc = al_solve(res1, res2, _mv(JEt_r, res2) / dd)
                    dz, v = dz - dzc, v - vc
                sols, goods = finish(dz, v, W)

        def trials(alphas, dz, ds):
            def lane(z, p, sf_, scE_, scD_, sg, off, dz_, s_, ds_, mu_, al):
                def trial(a):
                    zt = z + a * dz_
                    st_ = s_ + a * ds_
                    phi = F["fs"](zt, p, sf_) - mu_ * torch.log(st_).sum()
                    cIt = torch.cat([sg * zt[id_t] + off, F["cDs"](zt, p, scD_)])
                    th = F["cEs"](zt, p, scE_).abs().sum() + (cIt - st_).abs().sum()
                    return phi, th
                return vmap(trial)(al)
            return lanes(lane, *(0,) * 10)(zv, params, sf, scE, scD, sgn_eff, id_off,
                                            dz, s, ds, mu_b, alphas)

        zv_n, s_n, y_n, w_n, delta_n = filter_step(
            opt, sols, goods, ladder, n, zv, s, y, w, mu_b, st.delta, cI, cE,
            sf * lanes(F["f_flat"])(zv, params), lambda dz: ji_apply(JD, dz), trials)
        return IPMState(zv_n, s_n, y_n, w_n, mu_b, delta_n, st.it + 1, done, acc_it,
                        stall_it, *best, sf, scE, scD)

    def split_params(params):
        """``params``' tensors and how to rebuild it from them; the graph
        loop keys its graphs on the rest (the tree and the other leaves),
        which a captured graph bakes in."""
        leaves, spec = pytree.tree_flatten(params)
        is_t = [isinstance(x, torch.Tensor) for x in leaves]
        return [x for x, t in zip(leaves, is_t) if t], (spec, is_t, leaves)

    def join_params(tensors, how):
        spec, is_t, leaves = how
        it = iter(tensors)
        return pytree.tree_unflatten([next(it) if t else x for x, t in zip(leaves, is_t)], spec)

    how = {}    # the parameters' structure of the call in flight (set by its pre)

    def graph_body(st, _data, sgn_eff, id_off, *ptensors):
        params = join_params(ptensors, how["params"])
        return body(st, params, _in_dims(params), sgn_eff, id_off)

    graph_loop = _loop.GraphLoop(graph_body)

    def loop_of(t):
        """The Newton loop for tensors like ``t``: "graph" or "host"."""
        if loop is not None:
            return loop
        return "host" if kernels.runs_plain(t, impl) else "graph"

    def _prep(st, params):
        c = C(st.zv.device, st.zv.dtype)
        pd = _in_dims(params)
        return pd, ident(params, pd, c, st.zv.dtype, st.zv.shape[0], st.zv.device)

    def program(pre, post, inputs, it_cap, static=None):
        """One solve: ``pre(*inputs) -> (st, params, carry)``, the Newton
        loop until every lane is done or at ``min(it_cap, max_iters)``,
        ``post(st, carry) -> outputs``; ``(outputs, iterations)``. On the
        graphed loop one CUDA graph launch (:class:`.loop.GraphLoop`),
        else eagerly around the host loop."""
        def with_extra(*args):   # (no lane to iterate: the body never runs)
            st, params, carry = pre(*args)
            if not len(st.zv):
                return st, _NoData(), (), carry
            _, (sgn_eff, id_off) = _prep(st, params)
            tensors, how["params"] = split_params(params)
            return st, _NoData(), (sgn_eff, id_off, *tensors), carry

        t = next(x for x in pytree.tree_leaves(inputs) if isinstance(x, torch.Tensor))
        run = graph_loop.run if loop_of(t) == "graph" else graph_loop.run_host
        return run(with_extra, post, inputs, min(int(it_cap), opt.max_iters), static)

    def iterate_fn(st: IPMState, params, it_cap) -> IPMState:
        """Newton iterations until every lane is done or at
        ``min(it_cap, max_iters)``; finished lanes stay frozen."""
        return program(lambda s_, p: (s_, p, None), lambda s_, _: s_, (st, params), it_cap,
                       "iterate")[0]

    def step_fn(st: IPMState, params) -> IPMState:
        """One Newton iteration of every lane, finished or not."""
        pd, (sgn_eff, id_off) = _prep(st, params)
        return body(st, params, pd, sgn_eff, id_off)

    def finalize_fn(st: IPMState, params) -> IPMResult:
        """Report the watchdog's best iterate, Ipopt acceptable-level rules."""
        c = C(st.zv.device, st.zv.dtype)
        F = make_fns(c["ds"])
        pd = _in_dims(params)
        zv, err = st.best_zv, st.best_err
        cE_u = vmap(F["cE_flat"], in_dims=(0, pd))(zv, params)
        cI_u = vmap(F["cI_flat"], in_dims=(0, pd))(zv, params)
        viol, converged, feas = final_status(opt, err, cE_u, cI_u)
        z = fl.unravel((zv * c["ds"]).clone(), batched=True)
        return IPMResult(z=z, s=st.best_s, y=st.best_y, w=st.best_w,
                         f=vmap(F["f_flat"], in_dims=(0, pd))(zv, params), kkt_err=err,
                         viol=viol, iters=st.it, converged=converged, feas=feas)

    def solve(z0, params):
        return program(lambda z, p: (init_fn(z, p), p, p), finalize_fn, (z0, params),
                       opt.max_iters, "solve")[0]

    solve.init = init_fn
    solve.iterate = iterate_fn
    solve.step = step_fn
    solve.finalize = finalize_fn
    solve.program = program
    solve.family = family
    solve.loop_of = loop_of
    return solve


__all__ = ["Flat", "arrow_al_solve", "build_solver"]
