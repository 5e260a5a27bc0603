"""Hand-written CUDA kernels of the planner's hot loops (Hopper).

Nine sources under ``csrc/``, built on first use by :mod:`.build` and
called through ``ctypes``:

=====================  ==========================================  =====================
entry point            replaces (JAX package)                      plain PyTorch version
=====================  ==========================================  =====================
obca_kkt_provider      models/obca_struct.py make_provider         models/obca_struct.py
spd_inv                solver/ipm.py _chol_inv_small, _spd_inv     solver/ipm.py
                       (m <= 120)
spd_inv_blocked        solver/ipm.py _spd_inv (m > 120: blocked    solver/ipm.py
                       Cholesky, L^-1, L^-T L^-1)
newton_assemble,       solver/ipm.py fused Newton step             solver/newton.py
newton_schur,
newton_al_solve
step_linesearch        solver/ipm.py step + filter line search     solver/linesearch.py
kkt_qr                 solver/ipm.py kkt_solve_qr (QR rescue)      solver/qr.py
kkt_qr_dense           solver/ipm.py kkt_solve_qr as written (an   solver/qr.py
                       assembled saddle matrix; the AD kkt="qr")
astar_cost_to_go,      ops/astar.py cost_to_go, extract_path       ops/astar.py
astar_extract_path     (the sweep's wavefront A*)
ipm_freeze             solver/ipm.py iterate_fn while_loop: the     solver/loop.py
                       freeze of finished lanes and the loop test
device_loop            solver/ipm.py iterate_fn while_loop: the     solver/loop.py
                       loop itself, a conditional WHILE node in     (host_loop)
                       one graph with the solve around it
=====================  ==========================================  =====================

The OBCA kernels cover every variant: ``free``, ``fix_terminal``,
``fix_free_end`` and ``fix_eq_band``, and free time with
``coupled_motion`` (S = 4 spine slots a block, the fourth T); the variant
reaches them through the layout's row counts and the two values at the
end of :func:`_dims`.

The wrappers below check device, dtype (float32 or float64), shape and
contiguity, allocate outputs with ``torch.empty``, launch on the current
CUDA stream and raise when the C function reports an error. Each adds one
to ``launches[name]`` where it launches its kernel and nowhere else. The
dispatchers beside the plain versions decide with :func:`runs_plain`; a
CUDA tensor never falls back to the plain version.

``obca_kkt_provider`` computes a compact vector of the dense spine blocks'
nonzeros and writes the blocks from it through a row plan made once on
the host (:func:`provider_row_plan`): for many lanes one launch, a CTA a
lane; for few, a CTA a lane for the values and a grid over (lane, tile)
for the spine rows and the blocks' pieces, the two counted as one launch
(:func:`provider_launch_plan`).

``step_linesearch`` runs a CTA a lane with its trials in parallel groups
and stops at the first accepted trial, or, for a few lanes, a CTA per
(lane, trial) and a second launch for the filter (:func:`ls_route`). Its
per-CTA arrays live in shared memory; where they outgrow the 227 KB a
block may use the wrapper allocates a device workspace and the same
kernel runs over it (:func:`arena_in_device_memory`). ``newton_al_solve``
stages a lane's operands in shared memory where they fit and otherwise
reads them from device memory (:func:`al_solve_route`).

``astar_cost_to_go`` runs a warp a map, several a CTA, over a padded
field in shared memory for many maps, and a CTA a map for few maps or
large grids (:func:`astar_route`); ``astar_extract_path`` a warp a map
over the field staged in shared memory (:func:`astar_walk`).

``newton_schur`` runs a CTA per (lane, tile of spine rows)
(:func:`schur_launch_plan`), each writing its rows to every rung's S and
the Yq of the steps it owns, from a static tile plan uploaded once
(:func:`schur_plan_table`). ``ipm_freeze`` copies the fields the body
does not pass through by a static plan of 16-byte and element slots over
as many CTAs as fill the card (:func:`freeze_launch_plan`); the last CTA
writes the next active flags and the loop flag. ``device_loop`` builds one
graph from a solve's three captured pieces (before the loop, the body, after
it) with the body under a conditional WHILE node whose condition two
one-thread kernels set from that flag (:func:`device_loop_build`).
"""

from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple

import torch

from . import build

KERNEL_NAMES = ("obca_kkt_provider", "spd_inv", "spd_inv_blocked", "newton_assemble",
                "newton_schur", "newton_al_solve", "step_linesearch", "kkt_qr",
                "astar_cost_to_go", "astar_extract_path", "ipm_freeze", "kkt_qr_dense",
                "device_loop")
SOURCE_OF = {"obca_kkt_provider": "obca_kkt_provider", "spd_inv": "spd_inv",
             "spd_inv_blocked": "spd_inv_blocked",
             "newton_assemble": "newton", "newton_schur": "newton",
             "newton_al_solve": "newton", "step_linesearch": "step_linesearch",
             "kkt_qr": "kkt_qr", "kkt_qr_dense": "kkt_qr",
             "astar_cost_to_go": "astar_wavefront",
             "astar_extract_path": "astar_wavefront", "ipm_freeze": "ipm_freeze",
             "device_loop": "device_loop"}
SPD_INV_MAX_M = 120   # csrc/spd_inv.cu SPD_MAX_M; above it, spd_inv_blocked.cu
SMEM_MAX = 227 * 1024  # csrc/common.cuh VMP_SMEM_MAX

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


def pack_obca_data(data) -> torch.Tensor:
    """(B, D) per-lane packing of :class:`OBCAData`: every field flattened,
    in declaration order (the layout of csrc/common.cuh ``DataOff``)."""
    B = data.x0.shape[0]
    return torch.cat([f.reshape(B, -1) for f in data], dim=1).contiguous()


def _dims(spec, lay):
    """ints[2..11] of the OBCA kernels (csrc/common.cuh dims_from): the
    problem's sizes, the layout's row counts (the variant's terminal
    rows), its spine slots a block S (4 under coupled motion) and the bits
    of ``spec.theta_band`` (fix_eq_band's heading band) as an int64."""
    band_bits = struct.unpack("<q", struct.pack("<d", float(spec.theta_band)))[0]
    return [spec.N, spec.n_obs, spec.e_max, spec.k_lo, lay.off_u, lay.mE_sp,
            lay.mD_sp, lay.m_id, lay.S, band_bits]


class ProvLaunch(NamedTuple):
    """The launch plan of one ``obca_kkt_provider`` call
    (csrc/obca_kkt_provider.cu ProvLaunch)."""
    values_threads: int   # threads a CTA of the values launch (a CTA a lane)
    values_smem: int      # its shared bytes
    rows_per_tile: int    # stacked spine rows (JE_sp, JD_sp, Hpp) a spine tile
    spine_ctas: int       # spine tiles a lane
    block_ctas: int       # block tiles a lane
    dense_smem: int       # shared bytes a dense CTA
    n_values: int         # compact values a lane
    work_elems: int       # workspace elements a lane: the values, 17 arrays of K
    lane: int             # 1: one launch, the values CTA writes the whole bundle


_LAUNCH_PLANS = {}   # (spec, data width, B, dtype) -> ProvLaunch


def provider_launch_plan(spec, lay, data_width, B, dtype):
    """The launch plan of ``obca_kkt_provider`` for B lanes of ``spec``
    (layout ``lay``, packed data ``data_width`` wide) in ``dtype``, as the
    built library makes it (csrc/obca_kkt_provider.cu prov_launch, read
    through obca_kkt_provider_plan_info), kept per (spec, width, B, dtype).
    The values launch is a CTA a lane; where its lanes fill the card and a
    lane's stacked spine rows fit one tile it is the only launch
    (``lane``), else a dense launch over (lane, tile) follows with
    ``spine_ctas`` spine tiles of ``rows_per_tile`` stacked rows and
    ``block_ctas`` block tiles a lane. The wrapper allocates a workspace
    of ``work_elems`` a lane."""
    key = (spec, int(data_width), int(B), dtype)
    if key not in _LAUNCH_PLANS:
        lib = build.load("obca_kkt_provider")
        lib.obca_kkt_provider_plan_info.argtypes = [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
        ints = [_DTYPE_CODE[dtype], int(B), *_dims(spec, lay), int(data_width)]
        iv = (ctypes.c_longlong * len(ints))(*ints)
        out = (ctypes.c_longlong * len(ProvLaunch._fields))()
        rc = lib.obca_kkt_provider_plan_info(iv, len(ints), out)
        if rc != 0:
            raise RuntimeError(f"obca_kkt_provider_plan_info: {lib.vmp_error_string(rc).decode()}")
        _LAUNCH_PLANS[key] = ProvLaunch(*out)
    return _LAUNCH_PLANS[key]


_ROW_PLANS = {}   # (spec, device) -> the row plan's table on that device


def provider_row_plan(spec, device):
    """The row plan of ``spec`` (models/obca_struct.py spine_row_plan: the
    dense spine blocks' nonzeros and their values' places) as an int32
    tensor on ``device``, uploaded at the first call and kept. The first
    call must not fall inside a CUDA graph capture (the Newton loop runs
    its first iteration eagerly)."""
    key = (spec, str(device))
    if key not in _ROW_PLANS:
        if torch.device(device).type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("obca_kkt_provider: the row plan is not on the card yet; "
                               "call the provider once before capturing a CUDA graph")
        from ..models.obca_struct import spine_row_plan

        _ROW_PLANS[key] = torch.as_tensor(spine_row_plan(spec).table, device=device)
    return _ROW_PLANS[key]


def obca_kkt_provider(spec, lay, ds, zv, data_flat, sf, scE, scD, y, w_d):
    """The KKTBundle of every lane (see models/obca_struct.py): the values
    launch, then, where :func:`provider_launch_plan` has one, the dense
    launch over the row plan, counted as one launch. The library refuses a
    row plan whose value count differs from its own."""
    from ..models.obca_struct import KKTBundle, spine_row_plan

    fn = "obca_kkt_provider"
    dims = _dims(spec, lay)
    dev, dt, code = _head(fn, zv)
    B, n, K, bq, S, np_ = zv.shape[0], lay.n, lay.K, lay.bq, lay.S, lay.np_
    for what, t, shape in (("zv", zv, (B, n)), ("data", data_flat, (B, data_flat.shape[1])),
                           ("sf", sf, (B,)), ("scE", scE, (B, lay.mE)),
                           ("scD", scD, (B, lay.mD)), ("y", y, (B, lay.mE)),
                           ("w_d", w_d, (B, lay.mD)), ("ds", ds, (n,))):
        _check(fn, what, t, shape, dt, dev)
    plan, rows = provider_row_plan(spec, dev), spine_row_plan(spec)
    P = provider_launch_plan(spec, lay, data_flat.shape[1], B, dt)
    e = lambda *s: torch.empty(s, dtype=dt, device=dev)
    out = KKTBundle(f=e(B), g=e(B, n), cE=e(B, lay.mE), cD=e(B, lay.mD),
                    JE_sp=e(B, lay.mE_sp, np_), JEb_th=e(B, K, 2),
                    JEb_q=e(B, K, 2, bq), JD_sp=e(B, lay.mD_sp, np_),
                    JDb_p=e(B, K, 2, S), JDb_q=e(B, K, 2, bq),
                    Hpp=e(B, np_, np_), Hpq_c=e(B, K, S, bq), Hqq=e(B, K, bq, bq))
    _launch(fn, dev, [zv, data_flat, sf, scE, scD, y, w_d, ds, *out, plan, e(B, P.work_elems)],
            [code, B, *dims, data_flat.shape[1], rows.nnz, rows.n_values,
             P.work_elems, P.rows_per_tile], [spec.dual_reg])
    return out


SPD_SMALL_M = 16              # csrc/spd_inv.cu SPD_SMALL_M: a thread a matrix up to here
SPD_SMALL_MAX_P = 128         # SPD_SMALL_MAX_P: matrices (threads) a CTA, thread route
SPD_SMALL_STAGE = 48 * 1024   # SPD_SMALL_STAGE: the thread route's stage, at most
SPD_WARP_MAX_W = 2            # SPD_WARP_MAX_W: matrices (warps) a CTA, warp route
SPD_WARP_BUDGET = 100 * 1024  # SPD_WARP_BUDGET: the warp route's matrices, at most
SPD_NB = 4                    # SPD_NB: columns (rows) a step of the warp route


class SpdRoute(NamedTuple):
    """The launch shape of one ``spd_inv`` call (csrc/spd_inv.cu SpdRoute)."""
    route: str     # "thread" (a thread a matrix) or "warp" (a warp a matrix)
    per_cta: int   # matrices a CTA
    threads: int
    smem: int      # dynamic shared bytes a CTA


def spd_warp_stride(m, dtype):
    """Row stride (elements) of a matrix in the warp route (csrc/spd_inv.cu
    spd_ld): a multiple of a 16-byte vector, an odd number of vectors, at
    least m."""
    w = 16 // torch.empty((), dtype=dtype).element_size()
    return w * (-(-m // w) | 1)


def spd_inv_route(m, dtype):
    """The route of ``spd_inv`` at order m in ``dtype``, as the .cu host
    code (spd_route) picks it: up to SPD_SMALL_M a thread a matrix, P of
    them a CTA over an entry-major stage of m^2 (P + 1) elements within
    SPD_SMALL_STAGE (P a power of two, at most SPD_SMALL_MAX_P); above, a
    warp a matrix in m x :func:`spd_warp_stride` elements of shared
    memory, as many a CTA as fit in SPD_WARP_BUDGET (1 to
    SPD_WARP_MAX_W)."""
    if not 1 <= m <= SPD_INV_MAX_M:
        raise ValueError(f"spd_inv_route: m = {m} outside 1..{SPD_INV_MAX_M}")
    e = torch.empty((), dtype=dtype).element_size()
    if m <= SPD_SMALL_M:
        P = SPD_SMALL_MAX_P
        while P > 1 and m * m * (P + 1) * e > SPD_SMALL_STAGE:
            P //= 2
        return SpdRoute("thread", P, P, m * m * (P + 1) * e)
    per = m * spd_warp_stride(m, dtype) * e
    W = max(1, min(SPD_WARP_MAX_W, SPD_WARP_BUDGET // per))
    return SpdRoute("warp", W, 32 * W, W * per)


def spd_inv_route_of_library(m, dtype):
    """The route the built library picks (csrc/spd_inv.cu
    spd_inv_route_info), to hold :func:`spd_inv_route` against on the
    card."""
    lib = build.load("spd_inv")
    lib.spd_inv_route_info.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_longlong)]
    out = (ctypes.c_longlong * 4)()
    rc = lib.spd_inv_route_info(int(m), _DTYPE_CODE[dtype], out)
    if rc != 0:
        raise RuntimeError(f"spd_inv_route_info: {lib.vmp_error_string(rc).decode()}")
    return SpdRoute(("thread", "warp")[out[0]], out[1], out[2], out[3])


def spd_inv(A):
    """Inverse of every SPD matrix of A (..., m, m); NaN (the whole
    matrix) where one is not SPD. Orders m <= SPD_INV_MAX_M launch
    ``spd_inv`` (a thread or a warp a matrix, :func:`spd_inv_route`), larger ones
    ``spd_inv_blocked`` (a blocked Cholesky, triangular inverse and
    product: the launches of :func:`spdb_launch_plan` over a device
    workspace allocated here, counted as one launch), each counted under
    its own name."""
    fn = "spd_inv"
    dev, dt, code = _head(fn, A)
    m = A.shape[-1]
    if A.dim() < 2 or A.shape[-2] != m:
        raise ValueError(f"{fn}: expected (..., m, m), got {tuple(A.shape)}")
    _check(fn, "A", A, A.shape, dt, dev)
    out = torch.empty_like(A)
    count = A.numel() // (m * m)
    if m <= SPD_INV_MAX_M:
        _launch(fn, dev, [A, out], [code, count, m], [])
    else:
        work = torch.empty((count, spdb_workspace_elems(m)), dtype=dt, device=dev)
        _launch("spd_inv_blocked", dev, [A, work, out], [code, count, m], [])
    return out


SPDB_NB = 32     # spd_inv_blocked's panel width, csrc/spd_inv_blocked.cu SPDB_NB
SPDB_TILE = 64   # its row chunks and output tiles, csrc/spd_inv_blocked.cu SPDB_TILE


def spdb_workspace_elems(m):
    """Workspace elements per matrix of spd_inv_blocked
    (csrc/spd_inv_blocked.cu SpdbWork): L and X = L^-1 (m, m) each, every
    panel's (SPDB_NB, SPDB_NB) inverse diagonal block, one int flag."""
    return 2 * m * m + -(-m // SPDB_NB) * SPDB_NB * SPDB_NB + 1


def spdb_launch_plan(m):
    """(kernel, CTAs per matrix) of every launch of one spd_inv_blocked
    call, in order (csrc/spd_inv_blocked.cu launch_spd_inv_blocked): per
    panel a factor of its row chunks and, where rows remain below it, the
    update of the trailing lower-triangular tiles; then the triangular
    inverse by column blocks and the product by lower-triangular tiles."""
    tri = lambda n: n * (n + 1) // 2
    plan = []
    for k0 in range(0, m, SPDB_NB):
        plan.append(("spdb_panel", -(-(m - k0) // SPDB_TILE)))
        rest = m - k0 - SPDB_NB
        if rest > 0:
            plan.append(("spdb_syrk", tri(-(-rest // SPDB_TILE))))
    return plan + [("spdb_trtri", -(-m // SPDB_NB)), ("spdb_lauum", tri(-(-m // SPDB_TILE)))]


def _r8(count, itemsize):
    """Bytes of ``count`` items rounded up to 8 (csrc/common.cuh SmemArena)."""
    return (count * itemsize + 7) // 8 * 8


AL_TG = 256          # threads a rung group, staged route: csrc/newton.cu AL_TG
AL_TG_GLOBAL = 1024  # threads a CTA (one rung), global route: AL_TG_GLOBAL
AL_MAX_G = 2         # rung groups a CTA: AL_MAX_G


class AlRoute(NamedTuple):
    """The launch shape of one ``newton_al_solve`` call (csrc/newton.cu
    AlRoute): ``ctas`` CTAs a lane, each ``groups`` rung groups of
    ``threads``."""
    route: str     # "staged" (operands in shared memory) or "global"
    ctas: int      # CTAs a lane: 1 staged, R global (a CTA a rung)
    groups: int    # rung groups a CTA; group g runs rungs g, g + groups, ...
    threads: int   # threads a group
    smem: int      # dynamic shared bytes a CTA


def al_solve_route(lay, R, dtype):
    """The route of ``newton_al_solve`` for layout ``lay``, R rungs and
    ``dtype``, as the .cu host code (al_route) picks it: the lane's
    operands and right-hand sides (Wpp and JE_sp at a row stride of 8 mod
    16, the (bq, bq) blocks at an odd one) plus, per rung group, its
    rung operands and vectors staged in shared memory, with
    min(R, AL_MAX_G) groups of AL_TG threads if they fit in SMEM_MAX, else
    one, in one CTA a lane; where neither fits, the operands stay in device
    memory, a CTA of AL_TG_GLOBAL threads a rung, and only its vectors
    (float64 on both routes) take shared memory. Raises ValueError where even they do not fit (N
    above ~170 in float64, beyond newton_schur's limit). ``lay.S`` slots a
    block size Wpq, Gpq0, Yq and each group's Gpq wq."""
    e = torch.empty((), dtype=dtype).element_size()
    r8 = lambda count: _r8(count, e)
    np_, K, bq, mE, S = lay.np_, lay.K, lay.bq, lay.mE, lay.S
    ld, ldB = 8 + -(-max(np_ - 8, 0) // 16) * 16, bq | 1   # csrc/newton.cu al_ld
    tables = _r8(np_, 4) + _r8(K, 4)   # al_table_bytes: int32 index tables
    lane = tables + (r8(lay.mE_sp * ld) + r8(2 * K) + r8(2 * K * bq) + r8(np_ * ld)
                     + r8(S * K * bq) + r8(K * bq * ldB) + r8(S * K * bq) + r8(lay.n) + r8(mE))
    # a group's vectors, float64 on both routes (al_vec_bytes)
    vec = (5 * _r8(np_, 8) + 2 * _r8(K * bq, 8) + _r8(S * K, 8) + 2 * _r8(mE, 8) + 3 * 32 * 8)
    per = r8(K * bq * ldB) + r8(S * K * bq) + r8(np_ * ld) + vec
    G = min(R, AL_MAX_G)
    budget = SMEM_MAX - 1024   # AL_SMEM_BUDGET: the groups' views take the rest
    for g in sorted({G, 1}, reverse=True):
        if lane + g * per <= budget:
            return AlRoute("staged", 1, g, AL_TG, lane + g * per)
    if tables + vec <= budget:
        return AlRoute("global", R, 1, AL_TG_GLOBAL, tables + vec)
    raise ValueError(f"newton_al_solve: {tables + vec} bytes a CTA at np = {np_}, "
                     f"above the {budget} a CTA's shared memory holds")


def al_solve_route_of_library(spec, lay, R, dtype):
    """The route the built library picks (csrc/newton.cu
    newton_al_route_info), to hold :func:`al_solve_route` against on the
    card."""
    lib = build.load("newton")
    lib.newton_al_route_info.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_longlong)]
    ints = [_DTYPE_CODE[dtype], 0, *_dims(spec, lay), int(R)]
    iv = (ctypes.c_longlong * len(ints))(*ints)
    out = (ctypes.c_longlong * 5)()
    rc = lib.newton_al_route_info(iv, len(ints), out)
    if rc != 0:
        raise RuntimeError(f"newton_al_route_info: {lib.vmp_error_string(rc).decode()}")
    return AlRoute(("global", "staged")[out[0]], *out[1:5])


# csrc/step_linesearch.cu's constants of the same names
LS_MAX_G = 4             # trial groups a CTA, group route
LS_NARROW_ROWS = 512     # mE + mI up to which a group is one warp
LS_WIDE_ROWS = 2048      # ... two warps; above, four
LS_SPREAD_CTAS = 264     # B x n_backtracks up to which the spread route runs (2 x 132 SMs)
LS_SPREAD_THREADS = 512  # threads a CTA, spread route
LS_MAX_NB = 32           # n_backtracks, at most
LS_SC, LS_RED, LS_WS = 16, 4 * 32, 8   # shared scalars, reduction scratch, workspace scalars
LS_STAGE = 1024          # trial terms a chunk, spread route


class LsRoute(NamedTuple):
    """The launch shape of one ``step_linesearch`` call
    (csrc/step_linesearch.cu LsRoute)."""
    route: str        # "group" (a CTA a lane) or "spread" (a CTA per (lane, trial))
    ctas: int         # CTAs a lane: 1, or n_backtracks (spread, before its filter launch)
    groups: int       # trial groups a CTA (spread: 1, the whole CTA)
    group_warps: int  # warps a group
    threads: int      # threads a CTA
    arena: int        # arena bytes a CTA (shared memory, else a device workspace)


def ls_arena_bytes(lay, data_width, n_backtracks, dtype, route="group", groups=1,
                   group_warps=1):
    """Arena bytes a CTA of step_linesearch (csrc/step_linesearch.cu
    ls_arena; ``data_width`` is the packed data's, pack_obca_data): the
    lane's packed data, dz, ds, the reduction scratch and the scalars; for
    ``route`` "spread" the trial point, its block terms and two chunks of
    LS_STAGE staged terms; for "group"
    dw, phi and theta of every trial and, per group, its trial point,
    block terms and reduction slots."""
    e = torch.empty((), dtype=dtype).element_size()
    r8 = lambda count: _r8(count, e)
    mI = lay.m_id + lay.mD
    lane = r8(data_width) + r8(lay.n) + r8(mI) + r8(LS_RED) + r8(LS_SC)
    if route == "spread":
        return lane + r8(lay.n) + 8 * r8(lay.K) + 2 * r8(LS_STAGE)
    return (lane + r8(mI) + 2 * r8(n_backtracks)
            + groups * (r8(lay.n) + 8 * r8(lay.K) + r8(3 * group_warps)))


def ls_work_elems(lay, n_backtracks):
    """Elements a lane of the spread route's workspace: phi and theta of
    every trial, LS_WS scalars, ds and dw (csrc/step_linesearch.cu
    ls_work_elems)."""
    return 2 * n_backtracks + LS_WS + 2 * (lay.m_id + lay.mD)


def ls_route(lay, data_width, B, n_backtracks, dtype):
    """The route of ``step_linesearch`` for B lanes of layout ``lay`` and
    packed data ``data_width`` wide, as the .cu host code (ls_route) picks
    it: "spread" where B x n_backtracks <= LS_SPREAD_CTAS (a CTA per
    (lane, trial) of LS_SPREAD_THREADS, then a CTA a lane for the filter
    and the update); else "group", a CTA a lane of min(n_backtracks,
    LS_MAX_G) trial groups (fewer where the arena would outgrow SMEM_MAX)
    of 1, 2 or 4 warps as mE + mI is at most LS_NARROW_ROWS, LS_WIDE_ROWS
    or above."""
    nb = int(n_backtracks)
    if not 1 <= nb <= LS_MAX_NB:
        raise ValueError(f"step_linesearch: n_backtracks = {nb} outside 1..{LS_MAX_NB}")
    if B * nb <= LS_SPREAD_CTAS:
        return LsRoute("spread", nb, 1, LS_SPREAD_THREADS // 32, LS_SPREAD_THREADS,
                       ls_arena_bytes(lay, data_width, nb, dtype, "spread"))
    rows = lay.mE + lay.m_id + lay.mD
    gw = 1 if rows <= LS_NARROW_ROWS else (2 if rows <= LS_WIDE_ROWS else 4)
    G = min(nb, LS_MAX_G)
    arena = lambda G: ls_arena_bytes(lay, data_width, nb, dtype, "group", G, gw)
    while G > 1 and arena(G) > SMEM_MAX:
        G -= 1
    return LsRoute("group", 1, G, gw, 32 * G * gw, arena(G))


def ls_route_of_library(spec, lay, B, n_backtracks, dtype):
    """(the route, workspace elements a lane) the built library picks
    (csrc/step_linesearch.cu step_linesearch_route_info), to hold
    :func:`ls_route` and :func:`ls_work_elems` against on the card."""
    lib = build.load("step_linesearch")
    lib.step_linesearch_route_info.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                                               ctypes.POINTER(ctypes.c_longlong)]
    ints = [_DTYPE_CODE[dtype], int(B), *_dims(spec, lay), 1,
            int(n_backtracks)]
    iv = (ctypes.c_longlong * len(ints))(*ints)
    out = (ctypes.c_longlong * 7)()
    rc = lib.step_linesearch_route_info(iv, len(ints), out)
    if rc != 0:
        raise RuntimeError(f"step_linesearch_route_info: {lib.vmp_error_string(rc).decode()}")
    return LsRoute(("group", "spread")[out[0]], *out[1:6]), out[6]


def arena_in_device_memory(nbytes):
    """Whether a kernel's per-block arena of ``nbytes`` goes to a device
    workspace (above the shared memory a block may use) rather than to
    shared memory. Decided on the host; the kernel checks the same count."""
    return nbytes > SMEM_MAX


def _arena(nbytes, blocks, dev):
    """(ints, workspace) of a kernel's arena: the two ints of
    csrc/common.cuh ``arena_from`` and the workspace (empty when shared)."""
    if not arena_in_device_memory(nbytes):
        return [0, nbytes], torch.empty((0,), dtype=torch.uint8, device=dev)
    return [1, nbytes], torch.empty((blocks * nbytes,), dtype=torch.uint8, device=dev)


ASM_TILE = 64       # csrc/newton.cu ASM_TILE
ASM_SMALL_KB = 16   # csrc/newton.cu ASM_SMALL_KB


def assemble_ctas_per_lane(np_, K):
    """CTAs per lane of ``newton_assemble``: the upper-triangular
    ASM_TILE tiles of the (np_, np_) spine plus one CTA for every
    ASM_SMALL_KB of the K (3, bq) and (bq, bq) blocks."""
    nT = -(-np_ // ASM_TILE)
    return nT * (nT + 1) // 2 + -(-K // ASM_SMALL_KB)


def newton_assemble(L, bnd, sigma, sgn_eff, ladder, dd, w_only=False):
    """W and G pieces; Gqq per rung (see solver/newton.py). With
    ``w_only`` only (Wpp, Wpq, Wqq): JE^T JE and the G pieces are not
    formed."""
    fn = "newton_assemble"
    dims = _dims(L.spec, L.lay)
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
    w_out = (e(B, np_, np_), e(B, K, S, bq), e(B, K, bq, bq))
    g_out = (e(0), e(0), e(0)) if w_only else (e(B, np_, np_), e(B, K, S, bq),
                                               e(B, R, K, bq, bq))
    _launch(fn, dev, [bnd.Hpp, bnd.Hpq_c, bnd.Hqq, bnd.JE_sp, bnd.JEb_th,
                      bnd.JEb_q, bnd.JD_sp, bnd.JDb_p, bnd.JDb_q, sigma,
                      sgn_eff, ladder, ops.id_p_pos, *w_out, *g_out],
            [code, B, *dims, R, int(bool(w_only))],
            [float(dd)])
    return w_out if w_only else w_out + g_out


class SchurLaunch(NamedTuple):
    """The launch plan of one ``newton_schur`` call (csrc/newton.cu
    schur_plan, read through newton_schur_plan_info)."""
    tiles: int       # row tiles a lane (grid y)
    rows: int        # spine rows a tile
    threads: int
    smem: int        # shared bytes a CTA
    max_steps: int   # step entries of a tile, at most
    max_crows: int   # clique rows of a tile, at most
    steps: int       # step entries over all tiles (solver/newton.py schur_tile_plan)
    crows: int       # clique rows over all tiles
    table: int       # ints of the plan table


_SCHUR_PLANS = {}    # (spec, R, B, dtype) -> SchurLaunch
_SCHUR_TABLES = {}   # (spec, rows, device) -> the tile plan's table on that device


def schur_launch_plan(spec, lay, R, B, dtype):
    """The launch plan of ``newton_schur`` for B lanes and R rungs of
    ``spec`` (layout ``lay``) in ``dtype``, as the built library makes it,
    kept per (spec, R, B, dtype): a CTA per (lane, tile of ``rows`` spine
    rows), one tile a lane where the lanes fill the card."""
    key = (spec, int(R), int(B), dtype)
    if key not in _SCHUR_PLANS:
        lib = build.load("newton")
        lib.newton_schur_plan_info.argtypes = [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
        ints = [_DTYPE_CODE[dtype], int(B), *_dims(spec, lay), int(R)]
        iv = (ctypes.c_longlong * len(ints))(*ints)
        out = (ctypes.c_longlong * len(SchurLaunch._fields))()
        rc = lib.newton_schur_plan_info(iv, len(ints), out)
        if rc != 0:
            raise RuntimeError(f"newton_schur_plan_info: {lib.vmp_error_string(rc).decode()}")
        _SCHUR_PLANS[key] = SchurLaunch(*out)
    return _SCHUR_PLANS[key]


def schur_plan_table(L, rows, device):
    """The tile plan of ``L`` for tiles of ``rows`` rows
    (solver/newton.py schur_tile_plan) as an int32 tensor on ``device``,
    uploaded at the first call and kept; the first call must not fall
    inside a CUDA graph capture (the Newton loop runs its first iteration
    eagerly)."""
    key = (L.spec, int(rows), str(device))
    if key not in _SCHUR_TABLES:
        if torch.device(device).type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("newton_schur: the tile plan is not on the card yet; "
                               "call the Schur kernel once before capturing a CUDA graph")
        from ..solver.newton import schur_tile_plan

        _SCHUR_TABLES[key] = torch.as_tensor(schur_tile_plan(L, rows).table, device=device)
    return _SCHUR_TABLES[key]


def newton_schur(L, Qinv, Gpq0, Gpp0, ladder):
    """Yq (B,R,K,bq,S) and the Schur complements S (B,R,np,np): a CTA per
    (lane, row tile) of :func:`schur_launch_plan` over the tile plan of
    :func:`schur_plan_table` (the library refuses a plan of another row
    count or size)."""
    fn = "newton_schur"
    dims = _dims(L.spec, L.lay)
    dev, dt, code = _head(fn, Gpp0)
    B, R = ladder.shape
    np_, K, bq, S = L.np_, L.K, L.bq, L.S
    for what, t, shape in (("Qinv", Qinv, (B, R, K, bq, bq)),
                           ("Gpq0", Gpq0, (B, K, S, bq)),
                           ("Gpp0", Gpp0, (B, np_, np_)), ("ladder", ladder, (B, R))):
        _check(fn, what, t, shape, dt, dev)
    P = schur_launch_plan(L.spec, L.lay, R, B, dt)
    table = schur_plan_table(L, P.rows, dev)
    Yq = torch.empty((B, R, K, bq, S), dtype=dt, device=dev)
    Sm = torch.empty((B, R, np_, np_), dtype=dt, device=dev)
    _launch(fn, dev, [Qinv, Gpq0, Gpp0, ladder, Yq, Sm, table],
            [code, B, *dims, R, P.rows, table.numel()], [])
    return Yq, Sm


def newton_al_solve(L, bnd, Wpp, Wpq, Wqq, Gpq0, Qinv, Yq, Sinv, rhs1, rhs2,
                    ladder, dd, delta_d, n_refine):
    """sol (B,R,n+mE) and good (B,R) for every rung, on the route of
    :func:`al_solve_route` (the C host code picks it again and refuses a
    lane whose vectors outgrow shared memory)."""
    fn = "newton_al_solve"
    dims = _dims(L.spec, L.lay)
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
    """(zv, s, y, w, delta) after the step (see solver/linesearch.py), on
    the route of :func:`ls_route` (the C host code picks it again and
    refuses a call that disagrees); the spread route's two launches count
    as one."""
    fn = "step_linesearch"
    L = ops.L
    dims = _dims(L.spec, L.lay)
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
    nb = opt.n_backtracks
    rt = ls_route(L.lay, data_flat.shape[1], B, nb, dt)
    e = lambda *sh: torch.empty(sh, dtype=dt, device=dev)
    out = (e(B, n), e(B, mI), e(B, mE), e(B, mI), e(B))
    a_ints, arena = _arena(rt.arena, B * rt.ctas, dev)
    work = e(B, ls_work_elems(L.lay, nb)) if rt.route == "spread" else e(0)
    _launch(fn, dev, [sols, goods, ladder, zv, s, y, w, mu_b, delta, cI, cE, f0,
                      bnd.JD_sp, bnd.JDb_p, bnd.JDb_q, sgn_eff, id_off,
                      data_flat, sf, scE, scD, ops.ds, ops.id_idx, *out, arena, work],
            [code, B, *dims, R, nb, data_flat.shape[1], int(rt.route == "spread"),
             rt.groups, rt.group_warps, rt.threads, *a_ints],
            [opt.tau_min, opt.kappa_sigma, opt.delta0, opt.delta_max,
             L.spec.dual_reg])
    return out


QR_NB = 32   # kkt_qr's panel width, csrc/kkt_qr.cu QR_NB


def qr_workspace_elems(M):
    """Workspace elements per matrix of kkt_qr (csrc/kkt_qr.cu qr_work):
    the (M, M) matrix, each panel's (QR_NB, QR_NB) T and R's diagonal."""
    return M * M + -(-M // QR_NB) * QR_NB * QR_NB + M


def kkt_qr(ops, bnd, Wpp, Wpq, Wqq, rhs1, rhs2, ladder, delta_d):
    """sol (B,R,n+mE) and good (B,R) of the QR saddle solve of every rung
    (see solver/qr.py); the kernels factor each (lane, rung)'s matrix in
    a device workspace allocated here (:func:`qr_workspace_elems`). One
    call enqueues several kernels (the assembly, each panel's
    factorization and trailing update, the solve) and counts as one
    launch."""
    fn = "kkt_qr"
    L = ops.L
    dims = _dims(L.spec, L.lay)
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
    work = torch.empty((B * R, qr_workspace_elems(M)), dtype=dt, device=dev)
    sol = torch.empty((B, R, M), dtype=dt, device=dev)
    good = torch.empty((B, R), dtype=torch.bool, device=dev)
    _launch(fn, dev, [bnd.JE_sp, bnd.JEb_th, bnd.JEb_q, Wpp, Wpq, Wqq, rhs1,
                      rhs2, ladder, ops.inv_perm, work, sol, good],
            [code, B, *dims, R], [float(delta_d)])
    return sol, good


def kkt_qr_dense(K, rhs, n):
    """sol (B,R,M) and good (B,R) of the QR solve of every assembled saddle
    matrix K (B, R, M, M) with its lane's right-hand side rhs (B, M), the
    curvature test on K's leading (n, n) block (see solver/qr.py
    kkt_qr_dense_plain): the panel, trailing-update and solve kernels of
    :func:`kkt_qr` over K copied into a device workspace allocated here.
    One call enqueues several kernels and counts as one launch."""
    fn = "kkt_qr_dense"
    dev, dt, code = _head(fn, rhs)
    if K.dim() != 4 or K.shape[-1] != K.shape[-2]:
        raise ValueError(f"{fn}: K must be (B, R, M, M), got {tuple(K.shape)}")
    B, R, M = K.shape[0], K.shape[1], K.shape[-1]
    if not 0 <= n <= M:
        raise ValueError(f"{fn}: n = {n} outside 0..{M}")
    _check(fn, "K", K, (B, R, M, M), dt, dev)
    _check(fn, "rhs", rhs, (B, M), dt, dev)
    work = torch.empty((B * R, qr_workspace_elems(M)), dtype=dt, device=dev)
    sol = torch.empty((B, R, M), dtype=dt, device=dev)
    good = torch.empty((B, R), dtype=torch.bool, device=dev)
    _launch(fn, dev, [K, rhs, work, sol, good], [code, B, R, M, int(n)], [])
    return sol, good


ASTAR_WARP_MIN_MAPS = 132       # csrc/astar_wavefront.cu: fewer maps, a CTA a map
ASTAR_MAX_WARPS = 8             # ASTAR_MAX_WARPS: maps (warps) a CTA, warp routes
ASTAR_SMS = 132                 # ASTAR_SMS: the card's SMs, to spread the maps over
ASTAR_WARP_SMEM = SMEM_MAX // 4  # ASTAR_WARP_SMEM: a warp's share of shared memory
ASTAR_MAX_ROUNDS = 8            # ASTAR_MAX_ROUNDS: a lane's column segments, warp route


class AstarRoute(NamedTuple):
    """The launch shape of one ``astar_cost_to_go`` call
    (csrc/astar_wavefront.cu AstarRoute)."""
    route: str     # "warp" (a warp a map) or "cta" (a CTA a map)
    per_cta: int   # maps a CTA
    threads: int
    smem: int      # dynamic shared bytes a CTA
    seg_h: int     # rows of a lane's column segment (warp route; 0 on the CTA route)


class AstarWalk(NamedTuple):
    """The launch shape of one ``astar_extract_path`` call, a warp a map
    (csrc/astar_wavefront.cu AstarWalk)."""
    per_cta: int   # maps (warps) a CTA
    threads: int
    smem: int      # dynamic shared bytes a CTA; 0: the walk reads device memory


def _round16(nbytes):
    return (nbytes + 15) // 16 * 16


def _astar_warps(B, per_map):
    """Maps a CTA on a warp route: enough CTAs to spread B maps over the
    SMs, at most ASTAR_MAX_WARPS and as many as fit ``per_map`` bytes each."""
    W = min(ASTAR_MAX_WARPS, max(1, -(-B // ASTAR_SMS)))
    return min(W, SMEM_MAX // per_map) if per_map else W


def astar_seg_rounds(R, C, h):
    """Rounds of 32 column segments of h rows that cover R x C: the
    segments a lane owns on the warp route (csrc/astar_wavefront.cu
    seg_rounds)."""
    return -(-(C * -(-R // h)) // 32)


def astar_seg_height(R, C):
    """The warp route's segment height h (1..R): the least rounds times the
    h + 2 rows a segment loads, among those of at most ASTAR_MAX_ROUNDS
    rounds, ties to the smaller h; 0 where none is (csrc/astar_wavefront.cu
    seg_height)."""
    hs = [h for h in range(1, R + 1) if astar_seg_rounds(R, C, h) <= ASTAR_MAX_ROUNDS]
    return min(hs, key=lambda h: (astar_seg_rounds(R, C, h) * (h + 2), h), default=0)


def astar_warp_bytes(R, C, seg_h, dtype):
    """Shared bytes of a map's two buffers on the warp route: ceil(R /
    seg_h) seg_h + 2 rows (the border and the rows of the last segment
    below R) of C + 3 columns (the border and a column for a lane without a
    segment), all +inf but the map (csrc/astar_wavefront.cu
    warp_buffer_bytes)."""
    rows = -(-R // seg_h) * seg_h + 2
    return _round16(2 * rows * (C + 3) * torch.empty((), dtype=dtype).element_size())


def astar_route(B, R, C, dtype):
    """The route of ``astar_cost_to_go`` for B maps of R x C in ``dtype``,
    as the .cu host code (astar_route) picks it: "warp" where B >=
    ASTAR_WARP_MIN_MAPS, a segment height exists (:func:`astar_seg_height`)
    and a map's two buffers (:func:`astar_warp_bytes`) fit ASTAR_WARP_SMEM,
    else "cta", a CTA a map over two R x C buffers and a byte mask. Raises
    where the CTA route's bytes exceed SMEM_MAX (the kernel refuses the
    grid)."""
    e = torch.empty((), dtype=dtype).element_size()
    h = astar_seg_height(R, C)
    per_warp = astar_warp_bytes(R, C, h, dtype) if h else 0
    if B >= ASTAR_WARP_MIN_MAPS and h and per_warp <= ASTAR_WARP_SMEM:
        W = _astar_warps(B, per_warp)
        return AstarRoute("warp", W, 32 * W, W * per_warp, h)
    n = R * C
    smem = 2 * n * e + n
    if R < 1 or C < 1 or smem > SMEM_MAX:
        raise ValueError(f"astar_cost_to_go: a {R} x {C} grid needs {smem} bytes of shared "
                         f"memory, above {SMEM_MAX}")
    return AstarRoute("cta", 1, 1024 if n >= 1024 else -(-n // 32) * 32, smem, 0)


def astar_walk(B, R, C, dtype):
    """The launch shape of ``astar_extract_path`` (the .cu's astar_walk):
    a warp a map, the field staged in shared memory where a map's fits
    SMEM_MAX, else walked in device memory."""
    per_map = _round16(R * C * torch.empty((), dtype=dtype).element_size())
    staged = per_map <= SMEM_MAX
    W = _astar_warps(B, per_map if staged else 0)
    return AstarWalk(W, 32 * W, W * per_map if staged else 0)


def astar_route_of_library(B, R, C, dtype):
    """(:class:`AstarRoute`, :class:`AstarWalk`) the built library picks
    (csrc/astar_wavefront.cu astar_route_info), to hold
    :func:`astar_route` and :func:`astar_walk` against on the card."""
    lib = build.load("astar_wavefront")
    lib.astar_route_info.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    out = (ctypes.c_longlong * 8)()
    rc = lib.astar_route_info(int(B), int(R), int(C), _DTYPE_CODE[dtype], out)
    if rc != 0:
        raise RuntimeError(f"astar_route_info: {lib.vmp_error_string(rc).decode()}")
    return (AstarRoute(("cta", "warp")[out[0]], *out[1:5]), AstarWalk(*out[5:8]))


def _grid_dims(fn, t, what):
    if t.dim() != 3:
        raise ValueError(f"{fn}: {what} must be (B, rows, cols), got {tuple(t.shape)}")
    return t.shape


def astar_cost_to_go(grid, goal_yx, max_iters):
    """(field (B, rows, cols), relaxations (B,) int32) of the wavefront
    A* (see ops/astar.py); ``grid`` in the field's dtype, ``goal_yx``
    (B, 2) int32 [row, col]. A warp or a CTA a map (:func:`astar_route`)."""
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
    descent through every field (see ops/astar.py), a warp a map
    (:func:`astar_walk`)."""
    fn = "astar_extract_path"
    dev, dt, code = _head(fn, field)
    B, R, C = _grid_dims(fn, field, "field")
    _check(fn, "field", field, (B, R, C), dt, dev)
    _check(fn, "start_yx", start_yx, (B, 2), torch.int32, dev)
    path = torch.empty((B, max_len, 2), dtype=torch.int32, device=dev)
    valid = torch.empty((B, max_len), dtype=torch.bool, device=dev)
    _launch(fn, dev, [field, start_yx, path, valid], [code, B, R, C, int(max_len)], [])
    return path, valid


FREEZE_SKIP, FREEZE_ELEM, FREEZE_VEC = 0, 1, 2   # csrc/ipm_freeze.cu field modes
FREEZE_WS_HEAD = 16                              # csrc/ipm_freeze.cu FREEZE_WS_HEAD


class FreezeLaunch(NamedTuple):
    """The copy plan of one ``ipm_freeze`` call (csrc/ipm_freeze.cu
    freeze_plan, read through ipm_freeze_plan_info)."""
    slots: int        # items a lane: its flag item and every copied field's slots
    items: int        # lanes x slots
    per_thread: int   # items a thread: 1, 2 or 4
    ctas: int
    threads: int


def freeze_field_mode(n, o):
    """How ``ipm_freeze`` copies one field from ``n`` (the body's) into
    ``o`` (the loop's): skipped where they are the same memory (a field
    the body passes through), by 16-byte vectors where both are 16-byte
    aligned and a lane's row holds at least 16 bytes, else by elements."""
    if n.data_ptr() == o.data_ptr():
        return FREEZE_SKIP
    row = o.element_size() * (o.numel() // max(o.shape[0], 1))
    if row >= 16 and (n.data_ptr() | o.data_ptr()) % 16 == 0:
        return FREEZE_VEC
    return FREEZE_ELEM


_FREEZE_WORK = {}   # (device, the call's ints) -> the workspace: a ticket, then B flags


def _freeze_ints(code, B, old, modes):
    fields = old._fields
    ints = [code, B, len(fields), fields.index("it"), fields.index("done"),
            FREEZE_WS_HEAD + B]
    for o, m in zip(old, modes):
        ints += [o.element_size(), o.numel() // B if B else 0, m]
    return ints


def freeze_launch_plan(ints):
    """The copy plan the built library makes for ``ipm_freeze``'s ints
    (csrc/ipm_freeze.cu freeze_plan, made by its host code at each call
    from the fields' sizes and modes, so the same for every call of a
    layout), for tests and measurements to read."""
    lib = build.load("ipm_freeze")
    lib.ipm_freeze_plan_info.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_longlong)]
    iv = (ctypes.c_longlong * len(ints))(*ints)
    out = (ctypes.c_longlong * len(FreezeLaunch._fields))()
    rc = lib.ipm_freeze_plan_info(iv, len(ints), out)
    if rc != 0:
        raise RuntimeError(f"ipm_freeze_plan_info: {lib.vmp_error_string(rc).decode()}")
    return FreezeLaunch(*out)


def _check_disjoint(fn, new, old):
    """Refuse a call whose written buffers (old's fields) overlap each
    other or another field's source: the kernel copies every field at
    once, in no order."""
    spans = []
    for name, n, o in zip(old._fields, new, old):
        nb = o.numel() * o.element_size()
        spans.append((o.data_ptr(), o.data_ptr() + nb, name, "old"))
        if n.data_ptr() != o.data_ptr():
            spans.append((n.data_ptr(), n.data_ptr() + nb, name, "new"))
    spans.sort()
    end_any = end_old = (0, None)   # the furthest end so far, of any span and of old's
    for s0, s1, name, kind in spans:
        hit = end_any if kind == "old" else end_old
        if s1 > s0 and s0 < hit[0]:
            raise ValueError(f"{fn}: {kind}.{name} overlaps {hit[1]}")
        end_any = max(end_any, (s1, f"{kind}.{name}"))
        if kind == "old":
            end_old = max(end_old, (s1, f"old.{name}"))


def ipm_freeze(new, old, active, cap, flag):
    """The Newton loop's step after a body (see solver/loop.py), in place:
    every field of ``old`` (an IPMState of the loop's buffers) takes
    ``new``'s rows where ``active`` (B,) bool holds; then ``active``
    becomes ``(old.it < cap) & ~old.done`` and ``flag`` (1,) int32 is 1
    where any lane stays active, else 0. ``cap`` is a (1,) int32 device
    tensor. A field of ``new`` may be ``old``'s own buffer (it is then
    left out of the copy); no other buffers may overlap. The device
    workspace of the copy plan (:func:`freeze_launch_plan`) is kept per
    (device, layout, lanes, field modes), made at the first call of each,
    which must not fall inside a CUDA graph capture (the Newton loop runs
    its first iteration eagerly). Calls that share a workspace must not
    run concurrently."""
    fn = "ipm_freeze"
    dev, _, code = _head(fn, old.zv)
    B = old.zv.shape[0]
    _check(fn, "active", active, (B,), torch.bool, dev)
    _check(fn, "cap", cap, (1,), torch.int32, dev)
    _check(fn, "flag", flag, (1,), torch.int32, dev)
    for name, n, o in zip(old._fields, new, old):
        _check(fn, f"old.{name}", o, o.shape, o.dtype, dev)
        _check(fn, f"new.{name}", n, o.shape, o.dtype, dev)
        if o.dim() == 0 or o.shape[0] != B:
            raise ValueError(f"{fn}: field {name} has shape {tuple(o.shape)}, no lane dimension")
    if old.it.dtype != torch.int32 or old.done.dtype != torch.bool:
        raise ValueError(f"{fn}: it must be int32 and done bool")
    _check_disjoint(fn, new, old)
    ints = _freeze_ints(code, B, old, [freeze_field_mode(n, o) for n, o in zip(new, old)])
    key = (str(dev), tuple(ints))
    if key not in _FREEZE_WORK:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("ipm_freeze: no workspace for this state yet; call it once "
                               "before capturing a CUDA graph")
        _FREEZE_WORK[key] = torch.zeros(FREEZE_WS_HEAD + -(-B // 16) * 16, dtype=torch.uint8,
                                        device=dev)
    _launch(fn, dev, [*new, *old, active, cap, flag, _FREEZE_WORK[key]], ints, [])


# ---------------------------------------------------------------- device loop

# cudaGraphNodeType names (driver_types.h), for the census of a captured piece
GRAPH_NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty", "wait_event",
                    "event_record", "ext_semaphore_signal", "ext_semaphore_wait",
                    "mem_alloc", "mem_free", "batch_mem_op", "conditional")


def _device_loop_lib():
    lib = build.load("device_loop")
    if not getattr(lib, "vmp_typed", False):
        vp, ll = ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)
        for fn, args in (("device_loop_versions", [ll]),
                         ("device_loop_census", [vp, ll, ctypes.c_int]),
                         ("device_loop_build", [vp, vp, vp, vp, vp, ctypes.POINTER(vp)]),
                         ("device_loop_launch", [vp, vp]),
                         ("device_loop_destroy", [vp])):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        lib.vmp_typed = True
    return lib


def _dl_check(lib, fn, rc, what=""):
    if rc != 0:
        raise RuntimeError(f"{fn}: {lib.vmp_error_string(rc).decode()} (code {rc}){what}")


def device_loop_versions():
    """``{"runtime", "driver", "built"}``: the CUDA runtime's and driver's
    versions (e.g. 12040) and the toolkit the library was built with."""
    lib = _device_loop_lib()
    out = (ctypes.c_longlong * 3)()
    _dl_check(lib, "device_loop_versions", lib.device_loop_versions(out))
    return {"runtime": out[0], "driver": out[1], "built": out[2]}


def graph_node_types(raw_graph):
    """``{type name: count}`` of a captured ``cudaGraph_t`` (an int, as
    ``torch.cuda.CUDAGraph.raw_cuda_graph()`` gives it), child graphs'
    nodes counted in."""
    lib = _device_loop_lib()
    out = (ctypes.c_longlong * len(GRAPH_NODE_TYPES))()
    _dl_check(lib, "device_loop_census", lib.device_loop_census(
        ctypes.c_void_p(raw_graph), out, len(GRAPH_NODE_TYPES)))
    return {n: out[i] for i, n in enumerate(GRAPH_NODE_TYPES) if out[i]}


def device_loop_build(pre, body, post, flag, count):
    """The exec (an int) of one graph ``pre -> WHILE{body} -> post`` from
    captured ``cudaGraph_t``s (ints; ``pre`` / ``post`` None for no node,
    ``body`` None for no loop). ``flag`` is the (1,) int32 any-active flag
    that ``pre`` and the body write, ``count`` a (1,) int32 the loop's
    iterations land in (csrc/device_loop.cu). The graphs that own the
    pieces' memory must outlive the exec. A runtime or driver without
    conditional nodes, or a body the WHILE node refuses, raises with the
    versions and the body's node types; nothing falls back."""
    fn = "device_loop_build"
    dev = flag.device
    _check(fn, "flag", flag, (1,), torch.int32, dev)
    _check(fn, "count", count, (1,), torch.int32, dev)
    lib = _device_loop_lib()
    out = (ctypes.c_void_p * 1)()
    vp = lambda g: ctypes.c_void_p(g) if g else None
    with torch.cuda.device(dev):
        rc = lib.device_loop_build(vp(pre), vp(body), vp(post), ctypes.c_void_p(flag.data_ptr()),
                                   ctypes.c_void_p(count.data_ptr()), out)
    if rc != 0:
        v = device_loop_versions()
        types = graph_node_types(body) if body else {}
        _dl_check(lib, fn, rc, f"; conditional WHILE nodes need CUDA 12.4 (runtime "
                               f"{v['runtime']}, driver {v['driver']}, built with "
                               f"{v['built']}); the loop body's node types: {types}")
    return out[0]


def device_loop_launch(exec_, device):
    """Launch a :func:`device_loop_build` exec on the current stream."""
    lib = _device_loop_lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _dl_check(lib, "device_loop_launch",
                  lib.device_loop_launch(ctypes.c_void_p(exec_), ctypes.c_void_p(stream)))
    launches["device_loop"] += 1


def device_loop_destroy(exec_):
    lib = _device_loop_lib()
    _dl_check(lib, "device_loop_destroy", lib.device_loop_destroy(ctypes.c_void_p(exec_)))
