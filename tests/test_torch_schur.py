"""CPU checks of the design behind ``newton_schur`` and of its launch plan.

The kernel (``kernels/csrc/newton.cu``, the Schur section) runs only on
the card: a CTA per (lane, tile of spine rows) stages its rows of Gpp0
once and writes them to every rung's S, patched on the rows' diagonal (+
delta) and on the clique entries, the 3 x 3 slot blocks of the steps k >=
k_lo, each less its step's SS = Gpq Yq summed over the nO obstacles; which
steps and clique rows a tile holds is a static plan made once per layout
(``solver/newton.py`` ``schur_tile_plan``), and the tile of a step's
lowest row writes its blocks' Yq. Here:

* (a) a plain twin of that launch (``schur_twin`` below: the plan walked
  tile by tile, rung by rung, Yq written by the owning tile; Yq, SS and a
  step's clique sums are the same values in every tile that needs them,
  here newton_schur_plain's) is equal to ``newton_schur_plain`` (values
  equal, NaN where it has NaN; equal values are the same bits but for the
  sign of a zero, which the plain version's ``Gpp0 + 0`` makes positive) at
  the fix step's, the free batch's, the sweep's, the N = 74 and N = 50
  open loops' and the host driver's N = 6 and N = 15 shapes, and at the
  fix step's width in the fix_eq_band and coupled-motion variants (a few
  lanes each, tiled as the launch plan tiles the main path's lane count),
  in both dtypes, with a NaN planted in one lane's Qinv reaching that
  (lane, rung)'s Yq and S alone; with the clique sums taken from 0 in
  obstacle order, as the kernel (and the one it replaces) sums them,
  within 4 ulps of torch's sum. Under coupled motion (S = 4: x, y, theta
  and T, whose spine position 0 is a clique row of every step) the
  kernel subtracts each step's (T, T) sum from S[0, 0] in turn where the
  plain version subtracts their sum: that entry within a few ulps;
* (b) the plan: every step has one owner, every clique row lies in its
  tile, once but for row 0 under S = 4 (once a step, all in its tile, so
  no other tile writes row 0), the clique entries it patches are exactly
  the ones ``FusedOps.clique`` writes, and its counts are the .cu
  formula's;
* (c) the .cu file's launch plan, written out below (``_cu_plan``: tiles
  a lane, rows a tile, shared bytes, the plan's sizes), pinned at the main
  paths' shapes, within the 227 KB a CTA may use
  (tests/test_torch_cuda.py pins the built library's plan,
  ``kernels.schur_launch_plan``, to the same numbers on the card);
* (d) ``newton_schur_plain`` against the JAX package's ``kkt_solve_fused``
  Schur step (its ``solver/ipm.py`` Yq, SS and S = Gpp - _f_clique(SS),
  with its own layout's one-hot E_slot and ``_chol_inv_small``), written
  out below since it lives inside ``build_solver``: demo1's layout at N =
  6 and 10 in the variants free, fix_terminal, fix_free_end, fix_eq_band
  and free with coupled motion, two rungs, float64, within 1e-12
  (max-normalised).

Inputs are drawn from numpy seeds.
"""

import functools

import numpy as np
import pytest
import torch

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
    BENCH_FREE_OPTIONS, FIX6_OPTIONS, coupled_fixture_batch, demo1_problem, demo9_window_batch,
    eq_band_fixture_batch, fix_fixture_batch, openloop_n74_inputs,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import OBCASpec
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
    build_scenario, get_demo,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
    make_obca_solver,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.newton import (
    newton_schur_plain, schur_tile_plan,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

F32, F64 = torch.float32, torch.float64
# csrc/newton.cu's SCH_THREADS_SMALL, SCH_THREADS, SCH_THREADS_TILED,
# SCH_SMALL_STAGE, SCH_MIN_ROWS, SCH_FILL_LANES, SCH_SPREAD_CTAS; common.cuh's
# VMP_SMEM_MAX
THREADS_SMALL, THREADS, THREADS_TILED, SMALL_STAGE = 128, 256, 512, 24 * 1024
MIN_ROWS, FILL_LANES, SPREAD_CTAS, SMEM_MAX = 8, 132, 264, 227 * 1024
# the variant ("coupled": free time with coupled motion)
VARIANTS = ("free", "fix_terminal", "fix_free_end", "fix_eq_band", "coupled")


@functools.lru_cache(maxsize=None)
def _layout(kind):
    """The FusedLayout of a main path's shape."""
    if kind == "fix":
        spec = fix_fixture_batch(1, dtype=F64, device="cpu")[0]
    elif kind == "band":    # the fix step's width in fix_eq_band
        spec = eq_band_fixture_batch(1, dtype=F64, device="cpu")[0]
    elif kind == "coupled":   # ... as free-time problems with coupled motion
        spec = coupled_fixture_batch(1, dtype=F64, device="cpu")[0]
    elif kind == "free":
        spec = demo9_window_batch(1, dtype=F64, device="cpu")[0]
    elif kind == "sweep":   # the sweep's demo1-family worlds: demo1's free-time spec
        spec = demo1_problem(F64, "cpu")[0]
    elif kind == "N74":
        spec = openloop_n74_inputs(F64, "cpu")[0]
    elif kind == "N50":     # the open loop's fix-time problem at N = 50
        spec = OBCASpec(N=50, n_obs=6, e_max=4, variant="fix_terminal")
    else:                   # host15: demo8's fix-time replans at N = 15
        demo = get_demo("demo8")
        _, shape = build_scenario(demo, dtype=F64, device="cpu")
        spec = OBCASpec(N=demo.params.N_free, n_obs=shape.n_obs, e_max=shape.e_max,
                        variant="fix_terminal")
    opt = BENCH_FREE_OPTIONS if spec.variant == "free" else FIX6_OPTIONS
    return make_obca_solver(spec, opt).layout


# ------------------------------------------------------------ the plan

def _pos_slot(L, p):
    """common.cuh pos_slot: (slot, step) of a state's spine position, else None."""
    r = p - L.lay.off_u - 2 * L.spec.N
    return None if r < 0 else (r // (L.spec.N + 1), r % (L.spec.N + 1))


def _cu_counts(L, rows):
    """csrc/newton.cu sch_counts, written out: (tiles, max steps, max
    clique rows, steps, clique rows, plan ints) for tiles of ``rows``;
    under S = 4 row 0 (T) is a clique row of every step."""
    np_, k_lo, n_k = L.np_, L.spec.k_lo, L.n_k
    tiles = -(-np_ // rows)
    per = []
    for t0 in range(0, np_, rows):
        st = [_pos_slot(L, r) for r in range(t0, min(np_, t0 + rows))]
        steps = {t for s in st if s is not None and s[1] >= k_lo for t in [s[1] - k_lo]}
        nc = sum(s is not None and s[1] >= k_lo for s in st)
        if L.S == 4 and t0 == 0:
            steps, nc = set(range(n_k)), nc + n_k
        per.append((len(steps), nc))
    ns, nc = sum(p[0] for p in per), sum(p[1] for p in per)
    return (tiles, max(p[0] for p in per), max(p[1] for p in per), ns, nc,
            2 * (tiles + 1) + 4 * tiles + (2 + L.S) * ns + 3 * nc)


def _r16(n):
    return -(-n // 16) * 16


def _cu_plan(L, R, B, e):
    """csrc/newton.cu schur_plan, written out: (tiles, rows, threads,
    shared bytes, max steps, max clique rows, plan ints)."""
    np_, nO, bq, S = L.np_, L.nO, L.bq, L.S
    lanes, tiles = max(B, 1), 1
    if lanes < FILL_LANES:
        tiles = min(-(-np_ // MIN_ROWS), -(-SPREAD_CTAS // lanes))
    rows = -(-np_ // tiles)
    while True:
        nt, ms, mc, _, _, ints = _cu_counts(L, rows)
        staged = _r16(rows * np_ * e) + _r16(ms * R * nO * bq * bq * e) + _r16(ms * nO * S * bq * e)
        smem = (staged + _r16(ms * R * nO * bq * S * e) + _r16(ms * R * nO * S * S * e)
                + _r16(R * (rows + (S - 1) * mc) * e) + _r16(R * e) + _r16(rows * 4)
                + _r16(((2 + S) * ms + 3 * mc) * 4))
        threads = (THREADS_TILED if nt > 1 else THREADS_SMALL if staged <= SMALL_STAGE
                   else THREADS)
        if smem <= SMEM_MAX:
            return nt, rows, threads, smem, ms, mc, ints
        assert rows > 1
        rows = (rows + 1) // 2


# (shape, lanes, R, element bytes) -> (tiles, rows, threads, shared bytes) of
# csrc/newton.cu; tests/test_torch_cuda.py pins the library's plan to them
SCHUR_PLANS = {
    ("fix", 1280, 2, 4): (1, 33, 128, 26352),
    ("fix", 1280, 2, 8): (1, 33, 256, 52176),
    ("free", 256, 1, 4): (1, 54, 256, 41968),
    ("free", 256, 2, 4): (1, 54, 256, 65696),
    ("free", 256, 2, 8): (1, 54, 256, 130592),
    ("sweep", 2048, 2, 4): (1, 34, 128, 26608),
    ("N74", 5, 2, 4): (47, 8, 512, 54320),
    ("N74", 5, 2, 8): (47, 8, 512, 108336),
    ("N50", 2, 2, 4): (32, 8, 512, 50448),
    ("host6", 2, 2, 4): (5, 7, 512, 22256),
    ("host6", 5, 2, 4): (5, 7, 512, 22256),
    ("host15", 2, 2, 4): (10, 8, 512, 30896),
    ("host15", 5, 2, 4): (10, 8, 512, 30896),
    ("band", 1280, 2, 4): (1, 33, 128, 26352),
    ("band", 1280, 2, 8): (1, 33, 256, 52176),
    ("coupled", 512, 2, 4): (1, 34, 128, 30640),
    ("coupled", 512, 2, 8): (1, 34, 256, 60688),
    ("coupled", 8, 2, 4): (5, 7, 512, 26016),
    ("coupled", 8, 2, 8): (5, 7, 512, 51728),
}


def _kind(kind):
    return "fix" if kind == "host6" else kind


@pytest.mark.parametrize("key", sorted(SCHUR_PLANS))
def test_cu_plan_pinned(key):
    """(c) the written-out launch plan at the main paths' shapes; its
    counts are the Python plan's."""
    kind, B, R, e = key
    L = _layout(_kind(kind))
    tiles, rows, threads, smem, ms, mc, ints = _cu_plan(L, R, B, e)
    assert (tiles, rows, threads, smem) == SCHUR_PLANS[key]
    assert smem <= SMEM_MAX and tiles * rows >= L.np_ > (tiles - 1) * rows
    p = schur_tile_plan(L, rows)
    assert (p.tiles, p.max_steps, p.max_crows, p.table.size) == (tiles, ms, mc, ints)
    assert tiles == 1 if B >= FILL_LANES else rows >= MIN_ROWS - 1


@pytest.mark.parametrize("kind", ["fix", "free", "sweep", "N74", "N50", "host15", "band",
                                  "coupled"])
def test_tile_plan_covers_the_clique(kind):
    """(b) one owner a step, each clique row once in its own tile (row 0
    under S = 4 once a step, every step in its tile, its rows in step
    order), and the entries patched are exactly those ``FusedOps.clique``
    writes."""
    L = _layout(kind)
    ops = L.ops("cpu", F64)
    touched = ops.clique(torch.ones(1, L.K, L.S, L.S, dtype=F64))[0] != 0
    for rows in sorted({1, MIN_ROWS, 7, L.np_}):
        p = schur_tile_plan(L, rows)
        steps, crows = _decode(p, L.S)
        owners = np.zeros(L.n_k, int)
        patched = torch.zeros_like(touched)
        for t in range(p.tiles):
            for j, own, *_ in steps[t]:
                owners[j] += own
            for r, s, q in crows[t]:
                j, _, *pos = steps[t][q]
                assert t * rows + r == pos[s]          # the row is the slot's own
                patched[t * rows + r, pos] = True
            rs = [r for r, _, _ in crows[t]]
            assert rs == sorted(rs)
            t_rows = [steps[t][q][0] for r, _, q in crows[t] if t * rows + r == 0]
            if L.S == 4 and t == 0:   # T: a clique row of every step, in its tile alone
                assert t_rows == list(range(L.n_k)) and len(steps[t]) == L.n_k
                rs = [r for r in rs if r != 0]
            assert len(set(rs)) == len(rs)
        assert np.all(owners == 1)
        assert torch.equal(patched, touched)
        assert sum(len(c) for c in crows) == L.S * L.n_k


# ------------------------------------------------------------ the twin

def _decode(p, S=3):
    """Per tile, its step entries (j, owner, pos0 .. pos{S-1}) and clique
    rows (row in tile, s, step index) from the plan's int32 table; the
    tiles' two step ranges must list the same steps."""
    tb, nT, si = p.table, p.tiles, 2 + S
    sp, rp = tb[:nT + 1], tb[nT + 1:2 * nT + 2]
    rg = tb[2 * nT + 2:6 * nT + 2].reshape(-1, 4)
    base = 6 * nT + 2
    st = tb[base:base + si * sp[-1]].reshape(-1, si)
    cr = tb[base + si * sp[-1]:].reshape(-1, 3)
    assert cr.shape[0] == rp[-1]
    steps = [st[sp[t]:sp[t + 1]].tolist() for t in range(nT)]
    for t in range(nT):
        ja, na, jb, nb = rg[t]
        assert [e[0] for e in steps[t]] == list(range(ja, ja + na)) + list(range(jb, jb + nb))
    return steps, [cr[rp[t]:rp[t + 1]].tolist() for t in range(nT)]


def schur_twin(L, Qinv, Gpq0, Gpp0, ladder, rows, in_order=False):
    """newton_schur by the kernel's decomposition: for every tile of
    ``rows`` rows and every rung, the tile's rows of Gpp0, the diagonal +
    delta, each clique row's S entries less its step's clique sum (a row
    with several clique rows, T under S = 4, takes them in turn); the tile
    owning a step writes its blocks' Yq. Yq, SS and a step's clique sums
    are values of the step and rung, the same in every tile that needs
    them: here newton_schur_plain's (torch's sum over the obstacles), or
    with ``in_order`` summed from 0 in obstacle order, as the kernel sums
    them."""
    B, R = ladder.shape
    np_, nO, S_ = L.np_, L.nO, L.S
    Yv = torch.einsum("brkcd,bksd->brkcs", Qinv, Gpq0)    # the blocks' values
    SS = torch.einsum("bksc,brkct->brkst", Gpq0, Yv)
    SSr = SS.reshape(B, R, L.n_k, nO, S_, S_)
    if in_order:
        cl = torch.zeros_like(SSr[:, :, :, 0])
        for i in range(nO):
            cl = cl + SSr[:, :, :, i]
    else:
        cl = L.ops("cpu", Gpp0.dtype).red(SS.reshape((B * R,) + SS.shape[2:])).reshape(
            B, R, L.n_k, S_, S_)
    Yq = torch.full_like(Yv, float("nan"))
    S = torch.full((B, R, np_, np_), float("nan"), dtype=Gpp0.dtype)
    p = schur_tile_plan(L, rows)
    steps, crows = _decode(p, S_)
    for t in range(p.tiles):
        r0 = t * rows
        nr = min(rows, np_ - r0)
        for j, own, *_ in steps[t]:
            if own:
                Yq[:, :, j * nO:(j + 1) * nO] = Yv[:, :, j * nO:(j + 1) * nO]
        tile = Gpp0[:, r0:r0 + nr]
        for rg in range(R):
            out = tile.clone()
            d = torch.arange(nr)
            out[:, d, r0 + d] = tile[:, d, r0 + d] + ladder[:, rg, None]
            for r, s, q in crows[t]:
                j, _, *pos = steps[t][q]
                for c in range(S_):
                    out[:, r, pos[c]] = out[:, r, pos[c]] - cl[:, rg, j, s, c]
            S[:, rg, r0:r0 + nr] = out
    return Yq, S


def _inputs(L, B, R, dtype, seed):
    rng = np.random.RandomState(seed)
    K, bq, np_ = L.K, L.bq, L.np_
    A = rng.randn(B, R, K, bq, bq)
    Qinv = A @ np.swapaxes(A, -1, -2) / bq + np.eye(bq)
    M = rng.randn(B, np_, np_)
    t = lambda a: torch.as_tensor(a).to(dtype).contiguous()
    return (t(Qinv), t(rng.randn(B, K, L.S, bq)), t(M + np.swapaxes(M, 1, 2)),
            t(rng.rand(B, R) + 0.1))


def _same(a, b):
    """Equal values, NaN where the other has NaN."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(0.0),
                                                             b.nan_to_num(0.0))


# (shape, lanes of the main path, lanes here)
TWIN_SHAPES = [("fix", 1280, 3), ("free", 256, 2), ("sweep", 2048, 3), ("N74", 5, 2),
               ("N50", 2, 2), ("host6", 5, 3), ("host15", 5, 2), ("band", 1280, 3),
               ("coupled", 512, 2), ("coupled", 8, 3)]


@pytest.mark.parametrize("kind,B_main,B", TWIN_SHAPES)
def test_twin_equals_newton_schur_plain(kind, B_main, B):
    """(a) at a main path's shape, both dtypes, R = 2, a NaN planted in
    the last lane's Qinv of rung 1."""
    L = _layout(_kind(kind))
    R = 2
    for dtype in (F64, F32):
        rows = _cu_plan(L, R, B_main, torch.empty((), dtype=dtype).element_size())[1]
        Qinv, Gpq0, Gpp0, ladder = _inputs(L, B, R, dtype, seed=B_main)
        Qinv[-1, 1, L.K // 2, 3, 1] = float("nan")
        tY, tS = schur_twin(L, Qinv, Gpq0, Gpp0, ladder, rows)
        pY, pS = newton_schur_plain(L.ops("cpu", dtype), Qinv, Gpq0, Gpp0, ladder)
        if L.S == 4:   # S[0, 0]: every step's (T, T) sum subtracted in turn
            t00, p00 = tS[:, :, 0, 0].clone(), pS[:, :, 0, 0].clone()
            fin = ~p00.isnan()
            assert torch.equal(t00.isnan(), p00.isnan())
            assert ((t00 - p00)[fin].abs().max() / pS[~pS.isnan()].abs().max()).item() <= (
                4 * L.n_k * torch.finfo(dtype).eps)
            tS[:, :, 0, 0], pS[:, :, 0, 0] = 0.0, 0.0
        assert _same(tY, pY) and _same(tS, pS)
        # the kernel's order of the obstacle sum: rounding alone
        oS = schur_twin(L, Qinv, Gpq0, Gpp0, ladder, rows, in_order=True)[1]
        if L.S == 4:
            oS[:, :, 0, 0] = 0.0
        fin = ~pS.isnan()
        assert torch.equal(oS.isnan(), pS.isnan())
        assert ((oS - pS)[fin].abs().max() / pS[fin].abs().max()).item() <= (
            4 * torch.finfo(dtype).eps)
        bad = tS.isnan().flatten(2).any(-1)
        assert bad.tolist() == [[False, False]] * (B - 1) + [[False, True]]
        assert not tY[:-1].isnan().any() and not tY[-1, 0].isnan().any()


# ------------------------------------------------------- the JAX package

def _jax_schur_step(jlay, Qinv, Gpq0, Gpp0, delta):
    """The JAX package's kkt_solve_fused Schur step (solver/ipm.py: Yq, SS,
    S = Gpp - _f_clique(SS)), with its _red, _f_clique and E_slot written
    out as build_solver defines them; one lane, numpy float64 in and out."""
    import jax.numpy as jnp

    S_, nk, nO, np_ = jlay.S, jlay.n_k, jlay.nO, jlay.np_
    E_slot = np.zeros((np_, S_ * nk))
    for s_ in range(S_):
        for k_ in range(nk):
            E_slot[jlay.pq_pos[s_, k_ * nO], s_ * nk + k_] = 1.0
    E_slot = jnp.asarray(E_slot)
    eye_nk = jnp.asarray(np.eye(nk))

    def _red(vK):
        return vK.reshape((nk, nO) + vK.shape[1:]).sum(1)

    def _f_clique(cliq):
        red = _red(cliq)
        C = red.transpose(1, 0, 2)[:, :, :, None] * eye_nk[None, :, None, :]
        C = C.reshape(S_ * nk, S_ * nk)
        return E_slot @ C @ E_slot.T

    Gpp = jnp.asarray(Gpp0) + delta * jnp.eye(np_)
    Gqp = jnp.transpose(jnp.asarray(Gpq0), (0, 2, 1))
    Yq = jnp.einsum("kbc,kcs->kbs", jnp.asarray(Qinv), Gqp)
    SS = jnp.einsum("ksb,kbt->kst", jnp.asarray(Gpq0), Yq)
    return np.asarray(Yq), np.asarray(Gpp - _f_clique(SS))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("N", [6, 10])
def test_plain_schur_matches_jax_package(variant, N):
    """(d) the plain Schur step against the JAX package's, float64."""
    import jax
    import jax.numpy as jnp

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.models import (
        obca as jobca,
    )
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.models.obca_struct import (
        make_layout as jmake_layout,
    )
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.solver.ipm import (
        _chol_inv_small,
    )

    assert jax.config.jax_enable_x64
    shape = demo1_problem(F64, "cpu")[0]
    coupled = variant == "coupled"
    kw = dict(N=N, n_obs=shape.n_obs, e_max=shape.e_max,
              variant="free" if coupled else variant, coupled_motion=coupled)
    jlay = jmake_layout(jobca.OBCASpec(**kw))
    opt = BENCH_FREE_OPTIONS if kw["variant"] == "free" else FIX6_OPTIONS
    L = make_obca_solver(OBCASpec(**kw), opt).layout
    assert np.array_equal(np.asarray(jlay.pq_pos), np.asarray(L.lay.pq_pos))
    B, R = 2, 2
    rng = np.random.RandomState(N)
    A = rng.randn(B, L.K, L.bq, L.bq)
    Gqq0 = A @ np.swapaxes(A, -1, -2) / L.bq + np.eye(L.bq)
    _, Gpq0, Gpp0, ladder = _inputs(L, B, R, F64, seed=N + 1)
    Qinv = np.stack([np.stack([np.asarray(_chol_inv_small(
        jnp.asarray(Gqq0[b] + float(ladder[b, r]) * np.eye(L.bq)))) for r in range(R)])
        for b in range(B)])
    pY, pS = newton_schur_plain(L.ops("cpu", F64), torch.as_tensor(Qinv), Gpq0, Gpp0, ladder)
    for b in range(B):
        for r in range(R):
            jY, jS = _jax_schur_step(jlay, Qinv[b, r], Gpq0[b].numpy(), Gpp0[b].numpy(),
                                     float(ladder[b, r]))
            for k, j in ((pY[b, r].numpy(), jY), (pS[b, r].numpy(), jS)):
                assert np.abs(k - j).max() / np.abs(j).max() <= 1e-12
