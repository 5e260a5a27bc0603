"""CPU checks of the design behind ``obca_kkt_provider`` and of its launch
arithmetic.

The kernel (``kernels/csrc/obca_kkt_provider.cu``) runs only on the card.
Its values launch computes a lane's compact vector of the dense spine
blocks' nonzeros, in the registration order of
``models/obca_struct.py`` ``spine_maps``; its dense launch writes JE_sp,
JD_sp and Hpp from that vector through ``spine_row_plan``, a tile of rows
a CTA. Here, in float64 on the demo1 problem of
``tests/test_torch_model.py``:

* (a) a plain twin of both launches (``values_twin``, ``dense_twin``
  below: the kernel's value expressions in its order, then the row plan
  walked tile by tile as the launch plan cuts it) gives the plain
  provider's JE_sp, JD_sp and Hpp, and the JAX package's
  ``make_provider``'s on the same numpy inputs, within 1e-12 relative
  (max-normalised; the two sides differ only in where the column and row
  scales are multiplied), for the variants free, fix_terminal,
  fix_free_end, fix_eq_band (its heading band's -1, +1 on theta_N) and
  free with coupled motion at N = 6 and 10;
* (b) every entry the row plan leaves out is exactly 0 in the plain
  bundle at three random iterates (a missing nonzero would show here);
* (c) the .cu file's launch plan, written out below (``_cu_plan``:
  threads and shared bytes of the values launch, rows a tile, CTAs a lane
  and shared bytes of the dense launch, values a lane = the workspace),
  pinned at the fix step's, the free batch's, the sweep's, the N = 74
  open loop's (float32 and float64), the host driver's and the fix step's
  width in fix_eq_band and coupled motion (whose blocks also stage T's
  column scale and the obstacle's velocity), all within the 227 KB a CTA
  may use; its value count (the .cu's ``val_off`` formula) is the row
  plan's. The wrapper reads the built library's plan
  (``kernels.provider_launch_plan``); tests/test_torch_cuda.py pins it on
  the card to the same numbers.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_model import _setup
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.models.obca_struct import (
    make_provider as jmake_provider,
)

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.interop import (
    to_numpy,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
    OBCASpec, obca,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models.obca_struct import (
    make_layout, make_provider, spine_maps, spine_row_plan,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

F32, F64 = torch.float32, torch.float64
# the variant ("coupled": free time with coupled motion)
VARIANTS = ("free", "fix_terminal", "fix_free_end", "fix_eq_band", "coupled")


@functools.lru_cache(maxsize=None)
def _problem(variant, N):
    """(JAX spec, torch spec, JAX data, torch data, zv0, ds): demo1 at
    horizon N (tests/test_torch_model.py), its init_vars flattened and
    that file's variable scaling (x, y by 10, theta by 3, T by 30)."""
    coupled = variant == "coupled"
    jspec, tspec, jdata, tdata = _setup("free" if coupled else variant, coupled, False, N)
    zv0 = to_numpy(obca.ravel_z(tspec, obca.init_vars(tspec, tdata)))[0]
    lay = make_layout(tspec)
    ds = np.ones(lay.n)
    ds[lay.n - 3 * (N + 1):] = np.repeat([10.0, 10.0, 3.0], N + 1)
    if tspec.free_time:
        ds[0] = 30.0
    return jspec, tspec, jdata, tdata, zv0, ds


def _inputs(variant, N, seed):
    """_problem's plus (zv, sf, scE, scD, y, w_d) as numpy: an iterate near
    init_vars and random scales and multipliers from ``seed``."""
    jspec, tspec, jdata, tdata, zv0, ds = _problem(variant, N)
    lay = make_layout(tspec)
    rng = np.random.RandomState(seed)
    zv = zv0 / ds + rng.randn(zv0.shape[0]) * 0.05
    sf = 0.7
    scE = np.abs(rng.randn(lay.mE)) + 0.3
    scD = np.abs(rng.randn(lay.mD)) + 0.3
    y = rng.randn(lay.mE)
    w_d = np.abs(rng.randn(lay.mD)) + 0.1
    return jspec, tspec, jdata, tdata, ds, zv, sf, scE, scD, y, w_d


# ------------------------------------------------------ the launches' twin

def values_twin(spec, data, zv, ds, sf, scE, y, scD, w_d):
    """The values launch's compact vector of one lane (tensors of (1, .)):
    JE_sp's, JD_sp's and Hpp's upper triangle's nonzeros, each block in
    spine_maps' registration order, by the kernel's expressions."""
    lay = make_layout(spec)
    N, nO, E, K, kl = spec.N, spec.n_obs, spec.e_max, lay.K, spec.k_lo
    free, mEs, mDs = spec.free_time, lay.mE_sp, lay.mD_sp
    one = torch.ones(N, dtype=F64)
    z = (zv * ds)[0]
    base_u = lay.off_u + K * lay.bq
    u = z[base_u:base_u + 2 * N].reshape(2, N)
    x = z[base_u + 2 * N:].reshape(3, N + 1)
    d = type(data)(*[f[0] for f in data])
    Ts = d.Ts
    Tt = z[0] if free else torch.ones((), dtype=F64)
    dt = Tt * Ts if free else Ts
    dt2 = dt * dt
    scE, y, scD, w_d, sf = scE[0], y[0], scD[0], w_d[0], sf[0]
    v, w = u[0], u[1]
    c, s = torch.cos(x[2, :N]), torch.sin(x[2, :N])
    y1, y2, y3 = (scE[i * N:(i + 1) * N] * y[i * N:(i + 1) * N] for i in range(3))
    R12, R22 = d.R1 + d.R1.T, d.R2 + d.R2.T
    Q2, P2 = d.Q + d.Q.T, d.P + d.P.T

    je = [one, -one, dt * v * s, -dt * c, one, -one, -dt * v * c, -dt * s, one, -one, -dt * one]
    if free:
        je += [-Ts * v * c, -Ts * v * s, -Ts * w]
    je.append(torch.ones(mEs - 3 * N, dtype=F64))     # init, terminal rows
    jd = []
    for lim in (d.a_max, d.alpha_max):
        jd += [one, -one[1:], -one, one[1:]]
        if free:
            jd += [lim * Ts * one, lim * Ts * one]
    band = spec.variant == "fix_eq_band"      # -theta_N, theta_N; else x_N, y_N, -y_N
    jd.append(torch.tensor([-1.0, 1.0] if band else [1.0, 1.0, -1.0], dtype=F64)[:mDs - 4 * N])

    du = torch.cat([u[:, :1] - d.u0[:, None], u[:, 1:] - u[:, :-1]], 1)   # (2, N)
    acc = R22 @ du
    gacc = acc / dt2 - torch.cat([acc[:, 1:] / dt2, torch.zeros((2, 1), dtype=F64)], 1)
    cost_acc = 0.5 * torch.sum(du * acc) / dt2
    # theta curvature: the dynamics' and the blocks' at each step
    lam = z[lay.off_u:lay.off_u + K * E].reshape(K, E)
    ks = kl + torch.arange(K) // nO
    A = d.A[ks, torch.arange(K) % nO]                  # (K, E, 2)
    q1 = torch.einsum("ked,ke->kd", A, lam)
    m = d.obs_mask[torch.arange(K) % nO]
    ck, sk = torch.cos(x[2, ks]), torch.sin(x[2, ks])
    yg0, yg1 = scE[mEs:mEs + K] * y[mEs:mEs + K], scE[mEs + K:] * y[mEs + K:]
    wdd = scD[mDs + K:] * w_d[mDs + K:]
    qx, qy = q1[:, 0], q1[:, 1]
    hb = -(yg0 * m * (-ck * qx - sk * qy) + yg1 * m * (sk * qx - ck * qy)
           + wdd * m * d.ego_offset * (-ck * qx - sk * qy))
    thth = torch.cat([-(y1 * dt * v * c + y2 * dt * v * s), torch.zeros(1, dtype=F64)])
    thth[kl:] = thth[kl:] + hb.reshape(-1, nO).sum(1)

    hp = []
    if free:
        hp += [(sf * (6.0 * cost_acc / (Tt * Tt) + 2.0 * d.time_c2 * (N + 1)))[None],
               sf * (-2.0 * gacc[0] / Tt) + -(-y1 * Ts * c - y2 * Ts * s),
               sf * (-2.0 * gacc[1] / Tt) + y3 * Ts,
               -(y1 * Ts * v * s - y2 * Ts * v * c)]
    cnt = torch.cat([2.0 * one[1:], one[:1]])
    hp += [sf * (R12[i, j] + R22[i, j] * cnt / dt2) for i, j in ((0, 0), (0, 1), (1, 1))]
    hp += [sf * (-R22[i, j] / dt2) * one[1:] for i, j in ((0, 0), (0, 1), (1, 1), (0, 1))]
    hp.append(-(y1 * dt * s - y2 * dt * c))
    for i in range(3):
        for j in range(i, 3):
            xx = sf * torch.cat([Q2[i, j] * one, P2[i, j][None]])
            hp.append(xx + thth if i == j == 2 else xx)
    return torch.cat(je + jd + hp)


def dense_twin(spec, vals, ds, scE, scD, rows_per_tile):
    """The dense launch's spine tiles for one lane: JE_sp, JD_sp and Hpp
    from the compact values ``vals`` through the row plan, a tile of
    stacked rows at a time."""
    lay = make_layout(spec)
    plan = spine_row_plan(spec)
    tab = torch.as_tensor(plan.table.astype(np.int64))
    row_ptr = tab[:plan.rows + 1]
    nz_row, nz_col, nz_val = tab[plan.rows + 1:].reshape(3, plan.nnz)
    ds_p = ds[0, lay.p_idx]
    stacked = torch.zeros((plan.rows, lay.np_), dtype=F64)
    rscale = torch.cat([scE[0, :lay.mE_sp], scD[0, :lay.mD_sp], ds_p])
    for g0 in range(0, plan.rows, rows_per_tile):
        g1 = min(g0 + rows_per_tile, plan.rows)
        k = slice(int(row_ptr[g0]), int(row_ptr[g1]))
        r, c = nz_row[k], nz_col[k]
        assert bool(((r >= g0) & (r < g1)).all())
        stacked[r, c] = vals[nz_val[k]] * rscale[r] * ds_p[c]
    return stacked.split([lay.mE_sp, lay.mD_sp, lay.np_])


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("N", [6, 10])
@pytest.mark.parametrize("variant", VARIANTS)
def test_twin_gives_the_plain_and_jax_spine_blocks(variant, N):
    jspec, spec, jdata, data, ds, zv, sf, scE, scD, y, w_d = _inputs(variant, N, 0)
    t = lambda a: torch.as_tensor(np.array(a, np.float64))[None]
    _, prov = make_provider(spec, ds)
    pb = prov.plain(t(zv), data, t(sf), t(scE), t(scD), t(y), t(w_d))
    vals = values_twin(spec, data, t(zv), t(ds), t(sf), t(scE), t(y), t(scD), t(w_d))
    assert vals.shape[0] == spine_row_plan(spec).n_values
    rt = _cu_plan(spec, pack_width(spec), 1, 8).rows_per_tile
    twin = dense_twin(spec, vals, t(ds), t(scE), t(scD), rt)
    _, jprov = jmake_provider(jspec, ds)
    jb = jax.jit(lambda zv, *a: jprov(zv, jdata, *a))(
        *[jnp.asarray(a) for a in (zv, sf, scE, scD, y, w_d)])
    for name, got in zip(("JE_sp", "JD_sp", "Hpp"), twin):
        assert _rel(got, getattr(pb, name)[0]) <= 1e-12, name
        assert _rel(got, torch.as_tensor(np.asarray(getattr(jb, name)))) <= 1e-12, name


@pytest.mark.parametrize("variant", VARIANTS)
def test_entries_outside_the_plan_are_zero(variant):
    maps = spine_maps(_problem(variant, 6)[1])
    for seed in range(3):
        _, spec, _, data, ds, zv, sf, scE, scD, y, w_d = _inputs(variant, 6, seed)
        rng = np.random.RandomState(100 + seed)
        zv = zv + rng.randn(zv.shape[0])      # far from init
        t = lambda a: torch.as_tensor(np.array(a, np.float64))[None]
        pb = make_provider(spec, ds)[1].plain(t(zv), data, t(sf), t(scE), t(scD), t(y), t(w_d))
        for name, M in zip(("JE_sp", "JD_sp", "Hpp"), maps):
            dense = getattr(pb, name)[0]
            assert bool((dense[torch.as_tensor(M == 0)] == 0).all()), (name, seed)
            assert bool((dense[torch.as_tensor(M != 0)] != 0).any()), (name, seed)


# ------------------------------------------------------- the launch plan

def pack_width(spec):
    """csrc/common.cuh make_data_off, written out: the packed data's width."""
    N, nO, E = spec.N, spec.n_obs, spec.e_max
    return (3 + 2 + 3 * (N + 1) + (N + 1) * nO * E * 2 + (N + 1) * nO * E + nO * E + nO
            + 2 * 4 + 9 + 4 + 4 + 9 + 1 + 1 + 4 + 1 + 4 + 1 + 1 + 1 + 1 + 1 + 1 + nO * 2)


def _cu_values(spec):
    """csrc/obca_kkt_provider.cu val_off(D).total, written out."""
    N, free = spec.N, spec.free_time
    lay = make_layout(spec)
    je = (14 * N if free else 11 * N) + lay.mE_sp - 3 * N
    jd = 2 * (4 * N - 2 + (2 * N if free else 0)) + lay.mD_sp - 4 * N
    hp = (1 + 3 * N if free else 0) + 14 * N + 2
    return je + jd + hp


def _cu_plan(spec, width, B, e):
    """csrc/obca_kkt_provider.cu prov_launch, written out, for B lanes of
    ``e``-byte reals."""
    lay = make_layout(spec)
    r8 = lambda n: (n * e + 7) // 8 * 8
    cdiv = lambda a, b: -(-a // b)
    np_, rows = lay.np_, lay.mE_sp + lay.mD_sp + lay.np_
    S = lay.S
    data = lambda blocks: blocks * (S + 4 * spec.e_max + 1 + 2 * (S == 4)) + 4   # block_data_elems
    stage = lambda r: (cdiv(r * np_, 16 // e) + 6) * 16
    threads = min(max(32 * (cdiv(spec.N + 1, 32) + cdiv(lay.K, 32)), 96), 512)  # PV_*_THREADS
    lane = B * threads // 32 >= 1056 and rows * np_ <= 4096               # PV_FILL_WARPS
    while 2 * threads <= 512 and B * (threads // 32) < 1056:
        threads *= 2
    smem = ((stage(rows) + r8(data(lay.K)) if lane else 0) + r8(width) + r8(lay.n)
            + r8(spec.N + 1) + r8(64) + 17 * r8(lay.K))                   # PV_PARTS
    nv = _cu_values(spec)
    work = (r8(nv) + 17 * r8(lay.K)) // e
    if lane:
        return kernels.ProvLaunch(threads, smem, rows, 0, 0, 0, nv, work, 1)
    rt = min(max(4096 // np_, 1), rows)                                   # PD_TILE_ELEMS
    while rt > 1 and B * cdiv(rows, rt) < 264 and (rt // 2) * np_ >= 1024:  # PD_FILL_CTAS, _MIN_
        rt //= 2
    return kernels.ProvLaunch(threads, smem, rt, cdiv(rows, rt), cdiv(lay.K, 8),  # PD_BLOCKS
                              max(stage(rt), (16 * 8 + data(8)) * e), nv, work, 0)


# (spec, lanes, dtype) -> (values threads, rows a spine tile, spine CTAs,
# block CTAs a lane: none where one launch writes the bundle)
PLAN_CASES = {
    ("fix", 1280, F32): (96, 81, 0, 0),
    ("free", 256, F32): (192, 75, 2, 8),
    ("sweep", 2048, F32): (96, 82, 0, 0),
    ("N74", 5, F32): (512, 10, 90, 56),
    ("N74", 5, F64): (512, 10, 90, 56),
    ("fix", 5, F32): (384, 40, 3, 3),
    ("demo8", 2, F32): (384, 26, 8, 8),
    ("demo8", 400, F32): (96, 52, 4, 8),
    ("band", 1280, F32): (96, 82, 0, 0),
    ("band", 1280, F64): (96, 82, 0, 0),
    ("coupled", 512, F32): (96, 82, 0, 0),
    ("coupled", 512, F64): (96, 82, 0, 0),
    ("coupled", 8, F32): (384, 41, 2, 3),
}
SPECS = {"fix": OBCASpec(N=6, n_obs=4, e_max=4, variant="fix_terminal"),
         "free": OBCASpec(N=10, n_obs=6, e_max=4, variant="free"),
         "sweep": OBCASpec(N=6, n_obs=4, e_max=4, variant="free"),
         "N74": OBCASpec(N=74, n_obs=6, e_max=4, variant="free"),
         "demo8": OBCASpec(N=15, n_obs=4, e_max=4, variant="fix_terminal"),
         "band": OBCASpec(N=6, n_obs=4, e_max=4, variant="fix_eq_band"),
         "coupled": OBCASpec(N=6, n_obs=4, e_max=4, variant="free", coupled_motion=True)}


@pytest.mark.parametrize("shape,B,dtype", list(PLAN_CASES))
def test_launch_plan_mirrors_the_cu_formula(shape, B, dtype):
    spec = SPECS[shape]
    e = torch.empty((), dtype=dtype).element_size()
    plan = _cu_plan(spec, pack_width(spec), B, e)
    assert (plan.values_threads, plan.rows_per_tile, plan.spine_ctas,
            plan.block_ctas) == PLAN_CASES[shape, B, dtype]
    assert plan.lane == (plan.spine_ctas == 0)
    assert plan.n_values == spine_row_plan(spec).n_values
    assert plan.work_elems >= plan.n_values + 17 * make_layout(spec).K   # values, 17 arrays of K
    assert max(plan.values_smem, plan.dense_smem) <= kernels.SMEM_MAX
    assert plan.lane or plan.rows_per_tile * make_layout(spec).np_ <= 4096  # PD_TILE_ELEMS
