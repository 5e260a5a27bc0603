"""Hand-written CUDA kernels of the planner's hot loops (Hopper).

Six sources under ``csrc/``, built on first use by :mod:`.build` and
called through ``ctypes``:

=====================  ==========================================  =====================
entry point            replaces (JAX package)                      plain PyTorch version
=====================  ==========================================  =====================
obca_kkt_provider      models/obca_struct.py make_provider         models/obca_struct.py
spd_inv                solver/ipm.py _chol_inv_small, _spd_inv     solver/ipm.py
newton_assemble,       solver/ipm.py fused Newton step             solver/newton.py
newton_schur,
newton_al_solve
step_linesearch        solver/ipm.py step + filter line search     solver/linesearch.py
kkt_qr                 solver/ipm.py kkt_solve_qr (QR rescue)      solver/qr.py
astar_cost_to_go,      ops/astar.py cost_to_go, extract_path       ops/astar.py
astar_extract_path     (the sweep's wavefront A*)
=====================  ==========================================  =====================

The OBCA kernels cover the variants ``free``, ``fix_terminal`` and
``fix_free_end`` without coupled motion (every runtime path); the wrappers
raise for ``fix_eq_band`` and ``coupled_motion``.

The wrappers below check device, dtype (float32 or float64), shape and
contiguity, allocate outputs with ``torch.empty``, launch on the current
CUDA stream and raise when the C function reports an error. Each adds one
to ``launches[name]`` where it launches its kernel and nowhere else. The
dispatchers beside the plain versions decide with :func:`runs_plain`; a
CUDA tensor never falls back to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

KERNEL_NAMES = ("obca_kkt_provider", "spd_inv", "newton_assemble",
                "newton_schur", "newton_al_solve", "step_linesearch", "kkt_qr",
                "astar_cost_to_go", "astar_extract_path")
SOURCE_OF = {"obca_kkt_provider": "obca_kkt_provider", "spd_inv": "spd_inv",
             "newton_assemble": "newton", "newton_schur": "newton",
             "newton_al_solve": "newton", "step_linesearch": "step_linesearch",
             "kkt_qr": "kkt_qr", "astar_cost_to_go": "astar_wavefront",
             "astar_extract_path": "astar_wavefront"}
SPD_INV_MAX_M = 120   # csrc/spd_inv.cu SPD_MAX_M

launches = {k: 0 for k in KERNEL_NAMES}


def reset_launch_counts():
    for k in launches:
        launches[k] = 0


def runs_plain(t, impl=None):
    """Whether a hot loop runs its plain PyTorch version for tensor ``t``:
    on a CPU tensor, or where ``impl="plain"`` forces it on the card (for
    kernel-vs-plain comparisons). Any other tensor launches the kernel."""
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    return impl == "plain" or t.device.type == "cpu"


_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


def _check(fn, what, t, shape, dtype, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{fn}: {what} must be a tensor")
    if t.device != device:
        raise ValueError(f"{fn}: {what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{fn}: {what} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {what} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {what} must be contiguous")


def _head(fn, t):
    """Device and dtype code of the leading tensor of a call."""
    if t.device.type != "cuda":
        raise ValueError(f"{fn}: CUDA kernel called with a {t.device} tensor")
    if t.dtype not in _DTYPE_CODE:
        raise ValueError(f"{fn}: dtype {t.dtype} unsupported (float32/float64)")
    return t.device, t.dtype, _DTYPE_CODE[t.dtype]


def _launch(fn, device, tensors, ints, reals):
    lib = build.load(SOURCE_OF[fn])
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    iv = (ctypes.c_longlong * max(len(ints), 1))(*ints)
    rv = (ctypes.c_double * max(len(reals), 1))(*reals)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(ptrs, len(tensors), iv, len(ints), rv,
                              len(reals), ctypes.c_void_p(stream))
    if rc != 0:
        msg = lib.vmp_error_string(rc).decode()
        raise RuntimeError(f"{fn}: kernel launch failed: {msg} (code {rc})")
    launches[fn] += 1


KERNEL_VARIANTS = ("free", "fix_terminal", "fix_free_end")


def _check_variant(fn, spec):
    """Raise for what the kernels do not cover (no runtime path uses it,
    see ROADMAP.md queue 2)."""
    if spec.variant not in KERNEL_VARIANTS or spec.coupled_motion:
        raise NotImplementedError(
            f"{fn}: the CUDA kernel covers the variants free, fix_terminal "
            "and fix_free_end without coupled motion, not "
            f"{spec.variant!r} (coupled_motion={spec.coupled_motion}); "
            "see ROADMAP.md queue 2")


def pack_obca_data(data) -> torch.Tensor:
    """(B, D) per-lane packing of :class:`OBCAData`: every field flattened,
    in declaration order (the layout of csrc/common.cuh ``DataOff``)."""
    B = data.x0.shape[0]
    return torch.cat([f.reshape(B, -1) for f in data], dim=1).contiguous()


def _dims(fn, spec, lay):
    """ints[2..9] of the OBCA kernels (csrc/common.cuh dims_from): the
    problem's sizes and the layout's row counts."""
    _check_variant(fn, spec)
    return [spec.N, spec.n_obs, spec.e_max, spec.k_lo, lay.off_u, lay.mE_sp,
            lay.mD_sp, lay.m_id]


def obca_kkt_provider(spec, lay, ds, zv, data_flat, sf, scE, scD, y, w_d):
    """The KKTBundle of every lane (see models/obca_struct.py)."""
    from ..models.obca_struct import KKTBundle

    fn = "obca_kkt_provider"
    dims = _dims(fn, spec, lay)
    dev, dt, code = _head(fn, zv)
    B, n, K, bq, S, np_ = zv.shape[0], lay.n, lay.K, lay.bq, lay.S, lay.np_
    for what, t, shape in (("zv", zv, (B, n)), ("data", data_flat, (B, data_flat.shape[1])),
                           ("sf", sf, (B,)), ("scE", scE, (B, lay.mE)),
                           ("scD", scD, (B, lay.mD)), ("y", y, (B, lay.mE)),
                           ("w_d", w_d, (B, lay.mD)), ("ds", ds, (n,))):
        _check(fn, what, t, shape, dt, dev)
    e = lambda *s: torch.empty(s, dtype=dt, device=dev)
    out = KKTBundle(f=e(B), g=e(B, n), cE=e(B, lay.mE), cD=e(B, lay.mD),
                    JE_sp=e(B, lay.mE_sp, np_), JEb_th=e(B, K, 2),
                    JEb_q=e(B, K, 2, bq), JD_sp=e(B, lay.mD_sp, np_),
                    JDb_p=e(B, K, 2, S), JDb_q=e(B, K, 2, bq),
                    Hpp=e(B, np_, np_), Hpq_c=e(B, K, S, bq), Hqq=e(B, K, bq, bq))
    _launch(fn, dev, [zv, data_flat, sf, scE, scD, y, w_d, ds, *out],
            [code, B, *dims, data_flat.shape[1]], [spec.dual_reg])
    return out


def spd_inv(A):
    """Inverse of every SPD matrix of A (..., m, m); NaN where one is not
    SPD. Supports m <= SPD_INV_MAX_M."""
    fn = "spd_inv"
    dev, dt, code = _head(fn, A)
    m = A.shape[-1]
    if A.dim() < 2 or A.shape[-2] != m:
        raise ValueError(f"{fn}: expected (..., m, m), got {tuple(A.shape)}")
    if m > SPD_INV_MAX_M:
        raise ValueError(f"{fn}: m = {m} above the kernel's limit {SPD_INV_MAX_M}")
    _check(fn, "A", A, A.shape, dt, dev)
    out = torch.empty_like(A)
    _launch(fn, dev, [A, out], [code, A.numel() // (m * m), m], [])
    return out


def newton_assemble(L, bnd, sigma, sgn_eff, ladder, dd):
    """W and G pieces; Gqq per rung (see solver/newton.py)."""
    fn = "newton_assemble"
    dims = _dims(fn, L.spec, L.lay)
    dev, dt, code = _head(fn, sigma)
    B, R = ladder.shape
    np_, K, bq, S = L.np_, L.K, L.bq, L.S
    ops = L.ops(dev, dt)
    for what, t, shape in (
            ("Hpp", bnd.Hpp, (B, np_, np_)), ("Hpq_c", bnd.Hpq_c, (B, K, S, bq)),
            ("Hqq", bnd.Hqq, (B, K, bq, bq)), ("JE_sp", bnd.JE_sp, (B, L.mE_sp, np_)),
            ("JEb_th", bnd.JEb_th, (B, K, 2)), ("JEb_q", bnd.JEb_q, (B, K, 2, bq)),
            ("JD_sp", bnd.JD_sp, (B, L.mD_sp, np_)), ("JDb_p", bnd.JDb_p, (B, K, 2, S)),
            ("JDb_q", bnd.JDb_q, (B, K, 2, bq)), ("sigma", sigma, (B, L.mI)),
            ("sgn_eff", sgn_eff, (B, L.m_id)), ("ladder", ladder, (B, R))):
        _check(fn, what, t, shape, dt, dev)
    e = lambda *s: torch.empty(s, dtype=dt, device=dev)
    out = (e(B, np_, np_), e(B, K, S, bq), e(B, K, bq, bq), e(B, np_, np_),
           e(B, K, S, bq), e(B, R, K, bq, bq))
    _launch(fn, dev, [bnd.Hpp, bnd.Hpq_c, bnd.Hqq, bnd.JE_sp, bnd.JEb_th,
                      bnd.JEb_q, bnd.JD_sp, bnd.JDb_p, bnd.JDb_q, sigma,
                      sgn_eff, ladder, ops.id_p_pos, *out],
            [code, B, *dims, R], [float(dd)])
    return out


def newton_schur(L, Qinv, Gpq0, Gpp0, ladder):
    """Yq (B,R,K,bq,S) and the Schur complements S (B,R,np,np)."""
    fn = "newton_schur"
    dims = _dims(fn, L.spec, L.lay)
    dev, dt, code = _head(fn, Gpp0)
    B, R = ladder.shape
    np_, K, bq, S = L.np_, L.K, L.bq, L.S
    for what, t, shape in (("Qinv", Qinv, (B, R, K, bq, bq)),
                           ("Gpq0", Gpq0, (B, K, S, bq)),
                           ("Gpp0", Gpp0, (B, np_, np_)), ("ladder", ladder, (B, R))):
        _check(fn, what, t, shape, dt, dev)
    Yq = torch.empty((B, R, K, bq, S), dtype=dt, device=dev)
    Sm = torch.empty((B, R, np_, np_), dtype=dt, device=dev)
    _launch(fn, dev, [Qinv, Gpq0, Gpp0, ladder, Yq, Sm],
            [code, B, *dims, R], [])
    return Yq, Sm


def newton_al_solve(L, bnd, Wpp, Wpq, Wqq, Gpq0, Qinv, Yq, Sinv, rhs1, rhs2,
                    ladder, dd, delta_d, n_refine):
    """sol (B,R,n+mE) and good (B,R) for every rung."""
    fn = "newton_al_solve"
    dims = _dims(fn, L.spec, L.lay)
    dev, dt, code = _head(fn, rhs1)
    B, R = ladder.shape
    np_, K, bq, S = L.np_, L.K, L.bq, L.S
    for what, t, shape in (
            ("JE_sp", bnd.JE_sp, (B, L.mE_sp, np_)), ("JEb_th", bnd.JEb_th, (B, K, 2)),
            ("JEb_q", bnd.JEb_q, (B, K, 2, bq)), ("Wpp", Wpp, (B, np_, np_)),
            ("Wpq", Wpq, (B, K, S, bq)), ("Wqq", Wqq, (B, K, bq, bq)),
            ("Gpq0", Gpq0, (B, K, S, bq)), ("Qinv", Qinv, (B, R, K, bq, bq)),
            ("Yq", Yq, (B, R, K, bq, S)), ("Sinv", Sinv, (B, R, np_, np_)),
            ("rhs1", rhs1, (B, L.n)), ("rhs2", rhs2, (B, L.mE)),
            ("ladder", ladder, (B, R))):
        _check(fn, what, t, shape, dt, dev)
    sol = torch.empty((B, R, L.n + L.mE), dtype=dt, device=dev)
    good = torch.empty((B, R), dtype=torch.bool, device=dev)
    _launch(fn, dev, [bnd.JE_sp, bnd.JEb_th, bnd.JEb_q, Wpp, Wpq, Wqq, Gpq0,
                      Qinv, Yq, Sinv, rhs1, rhs2, ladder, sol, good],
            [code, B, *dims, R, int(n_refine)],
            [float(dd), float(delta_d)])
    return sol, good


def step_linesearch(ops, opt, sols, goods, ladder, zv, s, y, w, mu_b, delta,
                    cI, cE, f0, bnd, sgn_eff, id_off, data_flat, sf, scE, scD):
    """(zv, s, y, w, delta) after the step (see solver/linesearch.py)."""
    fn = "step_linesearch"
    L = ops.L
    dims = _dims(fn, L.spec, L.lay)
    dev, dt, code = _head(fn, zv)
    B, R = ladder.shape
    n, mE, mI, m_id, K, bq, S = L.n, L.mE, L.mI, L.m_id, L.K, L.bq, L.S
    for what, t, shape in (
            ("sols", sols, (B, R, n + mE)), ("ladder", ladder, (B, R)),
            ("zv", zv, (B, n)), ("s", s, (B, mI)), ("y", y, (B, mE)),
            ("w", w, (B, mI)), ("mu_b", mu_b, (B,)), ("delta", delta, (B,)),
            ("cI", cI, (B, mI)), ("cE", cE, (B, mE)), ("f0", f0, (B,)),
            ("JD_sp", bnd.JD_sp, (B, L.mD_sp, L.np_)), ("JDb_p", bnd.JDb_p, (B, K, 2, S)),
            ("JDb_q", bnd.JDb_q, (B, K, 2, bq)), ("sgn_eff", sgn_eff, (B, m_id)),
            ("id_off", id_off, (B, m_id)),
            ("data", data_flat, (B, data_flat.shape[1])), ("sf", sf, (B,)),
            ("scE", scE, (B, mE)), ("scD", scD, (B, L.mD)), ("ds", ops.ds, (n,))):
        _check(fn, what, t, shape, dt, dev)
    _check(fn, "goods", goods, (B, R), torch.bool, dev)
    e = lambda *sh: torch.empty(sh, dtype=dt, device=dev)
    out = (e(B, n), e(B, mI), e(B, mE), e(B, mI), e(B))
    _launch(fn, dev, [sols, goods, ladder, zv, s, y, w, mu_b, delta, cI, cE, f0,
                      bnd.JD_sp, bnd.JDb_p, bnd.JDb_q, sgn_eff, id_off,
                      data_flat, sf, scE, scD, ops.ds, ops.id_idx, *out],
            [code, B, *dims, R, opt.n_backtracks, data_flat.shape[1]],
            [opt.tau_min, opt.kappa_sigma, opt.delta0, opt.delta_max,
             L.spec.dual_reg])
    return out


def kkt_qr(ops, bnd, Wpp, Wpq, Wqq, rhs1, rhs2, ladder, delta_d):
    """sol (B,R,n+mE) and good (B,R) of the QR saddle solve of every rung
    (see solver/qr.py); the kernel factors each (lane, rung)'s matrix in
    a (B*R, n+mE, n+mE) device workspace allocated here."""
    fn = "kkt_qr"
    L = ops.L
    dims = _dims(fn, L.spec, L.lay)
    dev, dt, code = _head(fn, rhs1)
    B, R = ladder.shape
    np_, K, bq, S, n, mE = L.np_, L.K, L.bq, L.S, L.n, L.mE
    for what, t, shape in (
            ("JE_sp", bnd.JE_sp, (B, L.mE_sp, np_)), ("JEb_th", bnd.JEb_th, (B, K, 2)),
            ("JEb_q", bnd.JEb_q, (B, K, 2, bq)), ("Wpp", Wpp, (B, np_, np_)),
            ("Wpq", Wpq, (B, K, S, bq)), ("Wqq", Wqq, (B, K, bq, bq)),
            ("rhs1", rhs1, (B, n)), ("rhs2", rhs2, (B, mE)), ("ladder", ladder, (B, R))):
        _check(fn, what, t, shape, dt, dev)
    M = n + mE
    work = torch.empty((B * R, M, M), dtype=dt, device=dev)
    sol = torch.empty((B, R, M), dtype=dt, device=dev)
    good = torch.empty((B, R), dtype=torch.bool, device=dev)
    _launch(fn, dev, [bnd.JE_sp, bnd.JEb_th, bnd.JEb_q, Wpp, Wpq, Wqq, rhs1,
                      rhs2, ladder, ops.inv_perm, work, sol, good],
            [code, B, *dims, R], [float(delta_d)])
    return sol, good


def _grid_dims(fn, t, what):
    if t.dim() != 3:
        raise ValueError(f"{fn}: {what} must be (B, rows, cols), got {tuple(t.shape)}")
    return t.shape


def astar_cost_to_go(grid, goal_yx, max_iters):
    """(field (B, rows, cols), relaxations (B,) int32) of the wavefront
    A* (see ops/astar.py); ``grid`` in the field's dtype, ``goal_yx``
    (B, 2) int32 [row, col]."""
    fn = "astar_cost_to_go"
    dev, dt, code = _head(fn, grid)
    B, R, C = _grid_dims(fn, grid, "grid")
    _check(fn, "grid", grid, (B, R, C), dt, dev)
    _check(fn, "goal_yx", goal_yx, (B, 2), torch.int32, dev)
    field = torch.empty_like(grid)
    relaxations = torch.empty((B,), dtype=torch.int32, device=dev)
    _launch(fn, dev, [grid, goal_yx, field, relaxations], [code, B, R, C, int(max_iters)], [])
    return field, relaxations


def astar_extract_path(field, start_yx, max_len):
    """(path (B, max_len, 2) int32, valid (B, max_len) bool): the greedy
    descent through every field (see ops/astar.py)."""
    fn = "astar_extract_path"
    dev, dt, code = _head(fn, field)
    B, R, C = _grid_dims(fn, field, "field")
    _check(fn, "field", field, (B, R, C), dt, dev)
    _check(fn, "start_yx", start_yx, (B, 2), torch.int32, dev)
    path = torch.empty((B, max_len, 2), dtype=torch.int32, device=dev)
    valid = torch.empty((B, max_len), dtype=torch.bool, device=dev)
    _launch(fn, dev, [field, start_yx, path, valid], [code, B, R, C, int(max_len)], [])
    return path, valid
