"""CPU checks of the design behind ``step_linesearch`` and of its launch
arithmetic.

The kernel (``kernels/csrc/step_linesearch.cu``) takes one of two routes
(``kernels.ls_route``): ``group``, a CTA a lane whose trial groups
evaluate G trials a round in trial order and stop at the first round that
holds an accepted trial; ``spread``, a CTA per (lane, trial) writing phi
and theta to a workspace, then a filter launch. Both rest on one fact: the
JAX package (``solver/ipm.py:1157-1170``) takes the largest accepted alpha
among the strictly decreasing alpha_j = a_s 2^-j, which is the first
accepted one. It runs only on the card; here a plain twin of each route
(``twin_group``, ``twin_spread`` below) is held:

* against ``step_linesearch_plain`` in float64, bit for bit, at the fix
  step's (2 fixture rows x 5 candidates), the free batch's (4 demo9
  windows), a small open loop's (demo9 free time, N = 10, 5 candidates)
  and the two remaining variants' (the fixture rows in fix_eq_band, 2 x
  5, and as free-time problems with coupled motion, 3 x 2) inputs after 3
  plain iterations (``chip_smoke.py``'s ``_stage_from``), with
  n_backtracks 1, 8 and 16 and G 1, 4 and 16;
* on planted lanes (``chip_smoke.py``'s ``_ls_lanes``): a NaN in the
  picked rung, no good rung, every trial rejected, a_s = 0: bit for bit
  against the plain version, and none of them takes a step;
* on the early stop: the group route evaluates fewer trials than the
  spread route wherever a lane accepts before its last round;
* the property itself (hypothesis): for strictly decreasing alphas and any
  accepted mask, the first accepted alpha is the max over the accepted;
* against the JAX package: 1 and 3 iterations of the demo1 problem with
  the twin as the line search (as ``tests/test_torch_solver.py`` runs
  them) give the JAX state within 1e-9;
* ``kernels.ls_route``, ``ls_arena_bytes`` and ``ls_work_elems`` against
  the .cu file's formulas written out below, at the fix, free, sweep,
  demo8 and N = 50 / 74 shapes and the variants' fix-width shapes.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp

import __graft_entry__ as jentry
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.solver import (
    IPMOptions as JOptions,
    make_obca_solver as jmake_solver,
)

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
    BENCH_FREE_OPTIONS, ENTRY_OPTIONS, FIX6_OPTIONS, coupled_fixture_batch, demo1_problem,
    demo9_window_batch, eq_band_fixture_batch, fix_fixture_batch, horizon_inputs,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.interop import (
    from_numpy, to_numpy,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
    OBCASpec, init_vars, obca,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models.obca_struct import (
    make_layout,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
    linesearch, make_obca_solver,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime.scan_loop import (
    SCAN_OPTIONS,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.linesearch import (
    step_linesearch_plain,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

F32, F64 = torch.float32, torch.float64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402  (the main paths' stages and the planted lanes)


# ------------------------------------------------------ the routes' twin

def _update(opt, pre, found, alpha, ladder, zv, s, y, w, mu_b, delta):
    """The masked update, the kappa_Sigma clamp and the delta memory from
    the filter's outcome (found, alpha: the first accepted trial's)."""
    B, n = zv.shape[0], zv.shape[1]
    step_ok = ~pre["bad"] & found
    zero = torch.zeros_like(pre["a_s"])
    alpha = torch.where(step_ok, alpha, zero)
    a_wd = torch.where(step_ok, pre["a_w"], zero)
    ok_ = step_ok[:, None]
    zv_n = torch.where(ok_, zv + alpha[:, None] * pre["dz"], zv)
    s_n = torch.where(ok_, s + alpha[:, None] * pre["ds"], s)
    y_n = torch.where(ok_, y + alpha[:, None] * -pre["sol"][:, n:], y)
    w_n = torch.where(ok_, w + a_wd[:, None] * pre["dw"], w)
    mu, ks = mu_b[:, None], opt.kappa_sigma
    w_n = torch.minimum(torch.maximum(w_n, mu / (ks * s_n)), ks * mu / s_n)
    delta_used = ladder[torch.arange(B), pre["pick"]]
    delta_n = torch.where(
        step_ok, torch.clamp(delta_used / 30.0, min=opt.delta0),
        torch.clamp(torch.clamp(delta * 100.0, min=1e-4), max=opt.delta_max))
    return zv_n, s_n, y_n, w_n, delta_n


def twin_group(ops, opt, sols, goods, ladder, zv, s, y, w, mu_b, delta, cI, cE, f0, bnd,
               sgn_eff, id_off, data, sf, scE, scD, G=4):
    """The group route: trials in rounds of G in trial order, the filter
    after each round in trial order, a lane's search ending at the first
    round that holds an accepted trial; a bad lane evaluates none. Returns
    the new state and the trials each lane evaluated."""
    pre = cs._ls_prelude(ops, opt, sols, goods, ladder, zv, s, w, mu_b, cI, cE, f0, bnd, sgn_eff)
    searching = ~pre["bad"]
    found = torch.zeros_like(searching)
    alpha = torch.zeros_like(pre["a_s"])
    evaluated = torch.zeros(zv.shape[0], dtype=torch.long)
    nb = opt.n_backtracks
    for r0 in range(0, nb, G):
        if not bool(searching.any()):
            break
        trials = [cs._ls_trial(ops, pre, j, zv, s, mu_b, sgn_eff, id_off, data, sf, scE, scD)
                  for j in range(r0, min(r0 + G, nb))]
        evaluated += searching * len(trials)
        for j, (phi, th) in enumerate(trials, start=r0):
            take = searching & ~found & cs._ls_accept(phi, th, pre)
            alpha = torch.where(take, pre["a_s"] * 0.5 ** j, alpha)
            found |= take
        searching &= ~found
    return _update(opt, pre, found, alpha, ladder, zv, s, y, w, mu_b, delta), evaluated


def twin_spread(ops, opt, sols, goods, ladder, zv, s, y, w, mu_b, delta, cI, cE, f0, bnd,
                sgn_eff, id_off, data, sf, scE, scD):
    """The spread route: every (lane, trial) of a lane whose step is not
    bad writes (phi, theta) to a (B, nb) workspace; then the filter runs
    over each lane's row in trial order. Returns the new state and the
    trials each lane evaluated."""
    pre = cs._ls_prelude(ops, opt, sols, goods, ladder, zv, s, w, mu_b, cI, cE, f0, bnd, sgn_eff)
    nb = opt.n_backtracks
    ws = torch.full((zv.shape[0], 2, nb), float("nan"), dtype=zv.dtype)
    for j in range(nb):
        phi, th = cs._ls_trial(ops, pre, j, zv, s, mu_b, sgn_eff, id_off, data, sf, scE, scD)
        ws[:, 0, j] = torch.where(pre["bad"], ws[:, 0, j], phi)
        ws[:, 1, j] = torch.where(pre["bad"], ws[:, 1, j], th)
    found = torch.zeros_like(pre["bad"])
    alpha = torch.zeros_like(pre["a_s"])
    for j in range(nb):
        take = ~pre["bad"] & ~found & cs._ls_accept(ws[:, 0, j], ws[:, 1, j], pre)
        alpha = torch.where(take, pre["a_s"] * 0.5 ** j, alpha)
        found |= take
    return (_update(opt, pre, found, alpha, ladder, zv, s, y, w, mu_b, delta),
            (~pre["bad"]).long() * nb)


# ------------------------------------------------------------ the stages

def _stage(kind):
    """chip_smoke's stage (after 3 plain float64 iterations) of 2 fixture
    rows x 5 candidates (fix_terminal; "band": fix_eq_band), 3 rows x 2
    candidates as free-time problems with coupled motion ("coupled"), 4
    demo9 windows (free) or demo9's free-time open loop at N = 10 (5
    candidates)."""
    if kind in ("fix", "band", "coupled"):
        if kind == "fix":
            spec, _, data, cands = fix_fixture_batch(dtype=F64, device="cpu", rows=[0, 30])
        elif kind == "band":
            spec, data, cands = eq_band_fixture_batch(dtype=F64, device="cpu", rows=[0, 30])
        else:
            spec, data, cands = coupled_fixture_batch(dtype=F64, device="cpu", rows=[0, 30, 60])
        data = type(data)(*[f.repeat_interleave(cands.shape[1], dim=0) for f in data])
        opt = SCAN_OPTIONS if kind == "coupled" else FIX6_OPTIONS
        z0 = init_vars(spec, data, x_init=cands.reshape(-1, 3, spec.N + 1))
    elif kind == "free":
        spec, data, _, _ = demo9_window_batch(4, dtype=F64, device="cpu")
        opt, z0 = BENCH_FREE_OPTIONS, None
    else:
        spec, data, cands, opt = horizon_inputs(10, F64, "cpu")
        data = type(data)(*[f.repeat_interleave(5, dim=0) for f in data])
        z0 = init_vars(spec, data, x_init=cands[0])
    solve = make_obca_solver(spec, opt, impl="plain")
    st_ = solve.iterate(solve.init(data, z0), data, 3)
    return cs._stage_from(kind, spec, data, opt, solve, st_, 2)


_STAGES = {}


def _stage_of(kind):
    if kind not in _STAGES:
        _STAGES[kind] = _stage(kind)
    return _STAGES[kind]


def _plain_args(x, nb, plant=False):
    """step_linesearch_plain's arguments at ``nb`` trials and the planted
    lanes (chip_smoke's _ls_lanes)."""
    x = dict(x, opt=dataclasses.replace(x["opt"], n_backtracks=nb))
    _, args, planted = cs._ls_lanes(x, torch.arange(x["st"].zv.shape[0]), plant)
    return (args, planted) if plant else args


def _bit_equal(a, b):
    return all(torch.equal(p.isnan(), q.isnan()) and torch.equal(p.nan_to_num(0.0),
                                                                  q.nan_to_num(0.0))
               for p, q in zip(a, b))


ROUTES = ["group G=1", "group G=4", "group G=16", "spread"]


def _twin(route, args):
    if route == "spread":
        return twin_spread(*args)
    return twin_group(*args, G=int(route.split("=")[1]))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("nb", [1, 8, 16])
@pytest.mark.parametrize("kind", ["fix", "free", "open10", "band", "coupled"])
def test_twin_matches_plain(kind, nb, route):
    args = _plain_args(_stage_of(kind), nb)
    got, evaluated = _twin(route, args)
    want = step_linesearch_plain(*args)
    assert _bit_equal(got, want), (kind, nb, route)
    assert int(evaluated.max()) <= nb


@pytest.mark.parametrize("route", ["group G=4", "spread"])
@pytest.mark.parametrize("kind", ["fix", "free", "open10", "band", "coupled"])
def test_planted_lanes_match_plain(kind, route):
    """The first four lanes whose step is not bad, planted (chip_smoke's
    _ls_lanes): a NaN in the picked rung, no good rung, every trial
    rejected, a_s = 0."""
    args, planted = _plain_args(_stage_of(kind), 8, plant=True)
    assert len(planted) == 4
    got, evaluated = _twin(route, args)
    want = step_linesearch_plain(*args)
    assert _bit_equal(got, want), (kind, route)
    zv, s = args[5], args[6]
    assert torch.equal(got[0][planted], zv[planted]) and torch.equal(got[1][planted], s[planted])
    nan_pick, no_good, rejected, zero_as = planted
    assert evaluated[[nan_pick, no_good]].tolist() == [0, 0]   # bad: no trial
    assert evaluated[rejected] == 8 and evaluated[zero_as] == 8   # every round runs
    pre = cs._ls_prelude(*args[:7], args[8], args[9], *args[11:16])
    assert pre["bad"][[nan_pick, no_good]].all() and not pre["bad"][[rejected, zero_as]].any()
    assert torch.isnan(pre["th0"][rejected]) and pre["a_s"][zero_as] == 0.0


def test_group_route_stops_early():
    """At the fix step's inputs most lanes accept their first trial: the
    group route evaluates fewer trials than the spread route, and no lane
    more."""
    args = _plain_args(_stage_of("fix"), 16)
    _, eg = twin_group(*args, G=4)
    _, es = twin_spread(*args)
    assert bool((eg <= es).all()) and int(eg.sum()) < int(es.sum())


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 32), st.floats(1e-30, 1.0), st.integers(0, 2 ** 32 - 1))
def test_first_accepted_alpha_is_the_max(nb, a_s, mask_bits):
    """For alpha_j = a_s 2^-j (strictly decreasing) and any accepted mask,
    the first accepted alpha is the max over the accepted ones, the JAX
    package's pick (zero where none is accepted)."""
    alphas = a_s * 0.5 ** torch.arange(nb, dtype=F64)
    ok = torch.tensor([(mask_bits >> j) & 1 == 1 for j in range(nb)])
    want = torch.where(ok, alphas, 0.0).amax() if bool(ok.any()) else torch.tensor(0.0, dtype=F64)
    first = alphas[int(ok.int().argmax())] if bool(ok.any()) else torch.tensor(0.0, dtype=F64)
    assert bool((alphas[1:] < alphas[:-1]).all())
    assert first.item() == want.item()


# ----------------------------------------------------- the JAX package

@pytest.fixture(scope="module")
def entry_pair():
    jspec, jdata, _, _ = jentry._demo1_problem(jnp.float64)
    jsolve = jmake_solver(jspec, JOptions(max_iters=60))
    jst0 = jax.jit(jsolve.init)(jdata)
    spec, data, _, _ = demo1_problem(F64, "cpu")
    return dict(jdata=jdata, jst0=jst0, jiter=jax.jit(jsolve.iterate), data=data,
                solve=make_obca_solver(spec, ENTRY_OPTIONS))


@pytest.mark.parametrize("route", ["group G=4", "spread"])
@pytest.mark.parametrize("n_iter", [1, 3])
def test_twin_iterations_match_jax(entry_pair, monkeypatch, n_iter, route):
    """The port's solver with the twin as its line search, 1 and 3
    iterations of demo1, against the JAX package's state (1e-9) and the
    plain port's."""
    e = entry_pair
    plain = e["solve"].iterate(e["solve"].init(e["data"]), e["data"], n_iter)
    monkeypatch.setattr(linesearch, "step_linesearch_plain",
                        lambda *a: _twin(route, a)[0])
    got = e["solve"].iterate(e["solve"].init(e["data"]), e["data"], n_iter)
    want = from_numpy(type(e["jst0"])(*[np.asarray(v) for v in
                                        e["jiter"](e["jst0"], e["jdata"], n_iter)]), "cpu")
    for f in got._fields:
        a, b, p = (to_numpy(getattr(t, f)) for t in (got, want, plain))
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f)
            np.testing.assert_array_equal(a, p, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9, err_msg=f)
            np.testing.assert_allclose(a, p, rtol=1e-9, atol=1e-9, err_msg=f)


# ------------------------------------------------------------ the route

def _cu_data_width(N, nO, E):
    """csrc/common.cuh make_data_off, written out: the packed data's width."""
    return (3 + 2 + 3 * (N + 1) + (N + 1) * nO * E * 2 + (N + 1) * nO * E + nO * E + nO
            + 2 * 4 + 9 + 4 + 4 + 9 + 1 + 1 + 4 + 1 + 4 + 1 + 1 + 1 + 1 + 1 + 1 + nO * 2)


def _cu_arena(lay, width, nb, e, spread, G=1, GW=1):
    """csrc/step_linesearch.cu ls_arena, written out."""
    r8 = lambda count: (count * e + 7) // 8 * 8
    mI = lay.m_id + lay.mD
    lane = r8(width) + r8(lay.n) + r8(mI) + r8(4 * 32) + r8(16)   # LS_RED, LS_SC
    if spread:
        return lane + r8(lay.n) + 8 * r8(lay.K) + 2 * r8(1024)   # LS_STAGE
    return lane + r8(mI) + 2 * r8(nb) + G * (r8(lay.n) + 8 * r8(lay.K) + r8(3 * GW))


def _cu_route(lay, width, B, nb, e):
    """csrc/step_linesearch.cu ls_route, written out: (route, CTAs a lane,
    groups, warps a group, threads, arena bytes)."""
    if B * nb <= 264:                                   # LS_SPREAD_CTAS
        return ("spread", nb, 1, 16, 512, _cu_arena(lay, width, nb, e, True))
    rows = lay.mE + lay.m_id + lay.mD
    GW = 1 if rows <= 512 else (2 if rows <= 2048 else 4)   # LS_NARROW_ROWS, LS_WIDE_ROWS
    G = min(nb, 4)                                      # LS_MAX_G
    while G > 1 and _cu_arena(lay, width, nb, e, False, G, GW) > 227 * 1024:
        G -= 1
    return ("group", 1, G, GW, 32 * G * GW, _cu_arena(lay, width, nb, e, False, G, GW))


def _spec(name):
    if name in ("fix", "fix8"):
        spec6, spec8, _, _ = fix_fixture_batch(dtype=F64, device="cpu", rows=[0])
        return spec6 if name == "fix" else spec8
    if name == "free":
        return demo9_window_batch(2, dtype=F64, device="cpu")[0]
    if name == "sweep":      # the sweep's worlds: demo1's family, ShapeSpec(3, 1, 4)
        return OBCASpec(N=6, n_obs=4, e_max=4, variant="free")
    if name == "demo8":
        return OBCASpec(N=15, n_obs=4, e_max=4, variant="fix_terminal")
    if name == "N50fix":
        return OBCASpec(N=50, n_obs=6, e_max=4, variant="fix_terminal")
    if name == "band":
        return eq_band_fixture_batch(dtype=F64, device="cpu", rows=[0])[0]
    if name == "coupled":
        return coupled_fixture_batch(dtype=F64, device="cpu", rows=[0])[0]
    return horizon_inputs(int(name[1:]), F64, "cpu")[0]


# (shape, lanes, n_backtracks, dtype): (route, groups, warps a group), the
# main paths' calls and the other route at the same widths
ROUTE_CASES = {
    ("fix", 1280, 8, F32): ("group", 4, 1), ("fix", 1280, 8, F64): ("group", 4, 1),
    ("fix", 5, 8, F32): ("spread", 1, 16), ("fix8", 1280, 8, F32): ("group", 4, 1),
    ("free", 256, 8, F32): ("group", 4, 2), ("free", 256, 8, F64): ("group", 4, 2),
    ("sweep", 2048, 16, F32): ("group", 4, 1), ("sweep", 16, 16, F32): ("spread", 1, 16),
    ("demo8", 150, 16, F64): ("group", 4, 2), ("demo8", 60, 16, F32): ("group", 4, 2),
    ("N50fix", 2, 16, F64): ("spread", 1, 16), ("N50fix", 17, 16, F64): ("group", 2, 4),
    ("N74", 5, 16, F32): ("spread", 1, 16), ("N74", 5, 16, F64): ("spread", 1, 16),
    ("N74", 17, 16, F32): ("group", 4, 4), ("N74", 17, 16, F64): ("group", 1, 4),
    ("fix", 33, 8, F64): ("spread", 1, 16), ("fix", 34, 8, F64): ("group", 4, 1),
    ("fix", 300, 1, F64): ("group", 1, 1), ("fix", 100, 3, F64): ("group", 3, 1),
    ("band", 1280, 8, F32): ("group", 4, 1), ("band", 1280, 8, F64): ("group", 4, 1),
    ("coupled", 512, 16, F32): ("group", 4, 1), ("coupled", 512, 16, F64): ("group", 4, 1),
    ("coupled", 8, 16, F32): ("spread", 1, 16),
}


@pytest.mark.parametrize("shape,B,nb,dtype", list(ROUTE_CASES))
def test_route_mirrors_the_cu_formula(shape, B, nb, dtype):
    spec = _spec(shape)
    lay = make_layout(spec)
    e = torch.empty((), dtype=dtype).element_size()
    width = _cu_data_width(spec.N, spec.n_obs, spec.e_max)
    route = kernels.ls_route(lay, width, B, nb, dtype)
    assert tuple(route) == _cu_route(lay, width, B, nb, e)
    assert (route.route, route.groups, route.group_warps) == ROUTE_CASES[(shape, B, nb, dtype)]
    assert route.threads <= 512 and route.threads % 32 == 0
    assert route.arena == kernels.ls_arena_bytes(lay, width, nb, dtype, route.route,
                                                 route.groups, route.group_warps)
    assert kernels.ls_work_elems(lay, nb) == 2 * nb + 8 + 2 * (lay.m_id + lay.mD)   # LS_WS


@pytest.mark.parametrize("shape", ["fix", "free", "N74"])
@pytest.mark.parametrize("dtype", [F32, F64])
def test_arena_bytes_mirror_the_cu_formula(shape, dtype):
    """Both routes' arenas at every group count and width; the N = 74
    spread arena fits in shared memory in both dtypes, N = 100's float64
    one does not."""
    spec = _spec(shape)
    lay = make_layout(spec)
    e = torch.empty((), dtype=dtype).element_size()
    width = _cu_data_width(spec.N, spec.n_obs, spec.e_max)
    for nb in (1, 8, 16, 32):
        assert kernels.ls_arena_bytes(lay, width, nb, dtype, "spread") == _cu_arena(
            lay, width, nb, e, True)
        for G in (1, 2, 3, 4):
            for GW in (1, 2, 4):
                assert kernels.ls_arena_bytes(lay, width, nb, dtype, "group", G, GW) == _cu_arena(
                    lay, width, nb, e, False, G, GW)
    if shape == "N74":
        assert not kernels.arena_in_device_memory(
            kernels.ls_arena_bytes(lay, width, 16, dtype, "spread"))
        spec100 = _spec("N100")
        assert kernels.arena_in_device_memory(kernels.ls_arena_bytes(
            make_layout(spec100), _cu_data_width(spec100.N, spec100.n_obs, spec100.e_max), 16,
            F64, "spread"))


@pytest.mark.parametrize("shape", ["fix", "free", "N74"])
def test_cu_data_width_is_the_packed_width(shape):
    """The written-out make_data_off above is pack_obca_data's width."""
    if shape == "fix":
        spec, _, data, _ = fix_fixture_batch(dtype=F64, device="cpu", rows=[0])
    elif shape == "free":
        spec, data = demo9_window_batch(2, dtype=F64, device="cpu")[:2]
    else:
        spec, data = horizon_inputs(74, F64, "cpu")[:2]
    assert kernels.pack_obca_data(data).shape[1] == _cu_data_width(spec.N, spec.n_obs,
                                                                   spec.e_max)


def test_route_refuses_n_backtracks_outside_1_to_32():
    spec = _spec("fix")
    width = _cu_data_width(spec.N, spec.n_obs, spec.e_max)
    for nb in (0, 33):
        with pytest.raises(ValueError, match="n_backtracks"):
            kernels.ls_route(make_layout(spec), width, 8, nb, F32)
