"""CPU checks of the port's closed-loop rollout (``runtime/scan_loop.py``)
and the pieces it adds, at float64.

* ``reinterpolate_openloop`` and ``splice_previous_plan`` against the JAX
  package at N = 5, 6 and 15 (a zero-length segment among the inputs),
  tolerance 1e-12 (the same formulas).
* A batched Scenario in ``build_obca_data`` equals each world built alone,
  and the per-lane ``window_reference`` equals the shared one.
* The rollout against ``goldens/demo3.npz``, the JAX package's recorded
  closed loop (the JAX scan reproduces it within 1.4e-13): 5 steps of
  demo3, 3 free-time then 2 fix-time, same mode flags, states within
  1e-6 (the multistart may pick another of identical candidates, which
  moves z by ~1e-8; ROADMAP.md queue 3).
* Worlds batched together equal their single runs, chained calls equal
  one call exactly, and N_fix != N_free raises.

No JAX rollout is run here: its compile alone takes ~75 s.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.runtime.reference import (
    reinterpolate_openloop as jreinterp,
    splice_previous_plan as jsplice,
)

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
    demo_rollout_inputs, sweep_inputs, sweep_stats,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
    OBCAData, OBCASpec, build_obca_data,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime import (
    make_scan_rollout,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime.reference import (
    reinterpolate_openloop, splice_previous_plan, window_reference,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
    build_scenario, get_demo, stack_scenarios,
)

F64 = torch.float64
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "..", "goldens")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plans(N, B=3, seed=0):
    """(B, 3, N+1) plans with a zero-length segment in lane 0."""
    rng = np.random.default_rng(seed + N)
    x = np.cumsum(rng.uniform(-1.0, 1.0, (B, 3, N + 1)), axis=-1)
    x[0, :2, 2] = x[0, :2, 1]
    return x


@pytest.mark.parametrize("N_free,N_fix", [(5, 5), (6, 6), (15, 15), (3, 6)])
def test_reinterpolate_openloop_matches_jax(N_free, N_fix):
    x = _plans(N_free)
    out, n_new = reinterpolate_openloop(torch.as_tensor(x), N_free, N_fix)
    for b in range(x.shape[0]):
        jout, jn = jreinterp(jnp.asarray(x[b]), N_free, N_fix)
        assert n_new == jn
        np.testing.assert_allclose(out[b].numpy(), np.asarray(jout), rtol=0, atol=1e-12)
    # the zero-length segment gets heading 0, as atan2(0, 0) in the JAX package
    if N_free == N_fix:
        assert out[0, 2, 1].item() == 0.0
    with pytest.raises(ValueError):
        reinterpolate_openloop(torch.as_tensor(x), N_free, N_free - 1)


@pytest.mark.parametrize("N", [5, 6, 15])
def test_splice_previous_plan_matches_jax(N):
    x, prev = _plans(N), _plans(N, seed=100)
    n_cols = max(N - 5, 0)
    out = splice_previous_plan(torch.as_tensor(x), torch.as_tensor(prev), n_cols)
    for b in range(x.shape[0]):
        jout = jsplice(jnp.asarray(x[b]), jnp.asarray(prev[b]), n_cols)
        np.testing.assert_array_equal(out[b].numpy(), np.asarray(jout))
    out2 = splice_previous_plan(torch.as_tensor(x), torch.as_tensor(prev), 3)
    np.testing.assert_array_equal(out2[..., :3].numpy(), prev[..., 1:4])
    np.testing.assert_array_equal(out2[..., 3:].numpy(), x[..., 3:])


def _world(name):
    return build_scenario(get_demo(name), dtype=F64, device="cpu")


def test_batched_scenario_build_obca_data_equals_single_worlds():
    (s1, shape), (s2, _) = _world("demo1"), _world("demo2")
    both = stack_scenarios([s1, s2])
    spec = OBCASpec(N=6, n_obs=shape.n_obs, e_max=shape.e_max, variant="fix_terminal")
    rng = np.random.default_rng(3)
    x0 = torch.as_tensor(rng.uniform(2, 8, (2, 3)))
    xref = torch.as_tensor(rng.uniform(2, 8, (2, 3, 7)))
    kw = dict(u0=torch.as_tensor(rng.uniform(-0.1, 0.1, (2, 2))), Ts=torch.tensor([0.1, 0.12]),
              dyn_active=torch.tensor([[1.0], [0.0]]),
              dyn_delta=torch.as_tensor(rng.uniform(-1, 1, (2, 1, 2))),
              Ts_pred=torch.tensor([0.1, 0.12]),
              terminal_set=torch.as_tensor(rng.uniform(0, 9, (2, 2, 2))), q=0.001)
    batched = build_obca_data(spec, both, x0=x0, xref=xref, **kw)
    for b, scn in enumerate((s1, s2)):
        one = build_obca_data(spec, scn, x0=x0[b:b + 1], xref=xref[b:b + 1],
                              **{k: v[b:b + 1] if isinstance(v, torch.Tensor) else v
                                 for k, v in kw.items()})
        for f in OBCAData._fields:
            np.testing.assert_array_equal(getattr(batched, f)[b:b + 1].numpy(),
                                          getattr(one, f).numpy(), err_msg=f)
    with pytest.raises(ValueError):
        build_obca_data(spec, both, x0=x0[:1], xref=xref[:1], u0=torch.zeros(2), Ts=0.1)


def test_per_lane_window_reference_equals_shared():
    rng = np.random.default_rng(5)
    ref = torch.as_tensor(np.cumsum(rng.uniform(0, 1, (3, 20)), axis=1))
    x0 = torch.as_tensor(rng.uniform(0, 10, (4, 3)))
    lens = torch.tensor([20, 12, 3, 1])
    per_lane = window_reference(ref.expand(4, 3, 20), lens, x0, 6)
    for b in range(4):
        one = window_reference(ref, int(lens[b]), x0[b:b + 1], 6)
        np.testing.assert_array_equal(per_lane[b:b + 1].numpy(), one.numpy())


def _roll(name, steps):
    scn, shape, p, ref, ref_len = demo_rollout_inputs(name, F64, "cpu")
    roll = make_scan_rollout(shape, p, max_steps=steps, dtype=F64, device="cpu")
    return roll, scn, ref, ref_len


def test_rollout_demo3_matches_golden():
    roll, scn, ref, ref_len = _roll("demo3", 5)
    profile = []
    final, traj = roll(scn, ref, ref_len, profile=profile)
    g = np.load(os.path.join(GOLDEN_DIR, "demo3.npz"))
    np.testing.assert_array_equal(traj["fixtime"][0].numpy(), g["fixtime"][:5])
    assert g["fixtime"][:5].tolist() == [False] * 3 + [True] * 2
    np.testing.assert_allclose(traj["x"][0].numpy(), g["x"][:5], rtol=0, atol=1e-6)
    assert traj["feas"].all() and traj["active"].all()
    assert final.k.tolist() == [5] and not final.failed.any()
    assert traj["plan"].shape == (1, 5, 3, 7) and traj["u"].shape == (1, 5, 2)
    # the free rung ran on steps 0-2, the fix rung on steps 3-4
    assert [bool(s["free"][0]) for s in profile] == [True] * 3 + [False] * 2
    assert [bool(s["fix6"][0]) for s in profile] == [False] * 3 + [True] * 2


@pytest.fixture(scope="module")
def demo12_runs():
    """demo1 and demo2, 4 steps each alone and together (one ShapeSpec)."""
    runs = {}
    for name in ("demo1", "demo2"):
        roll, scn, ref, ref_len = _roll(name, 4)
        runs[name] = (roll, scn, ref, ref_len) + roll(scn, ref, ref_len)
    return runs


def test_rollout_batched_worlds_equal_single_runs(demo12_runs):
    roll, s1, r1, l1 = demo12_runs["demo1"][:4]
    _, s2, r2, l2 = demo12_runs["demo2"][:4]
    L = max(r1.shape[-1], r2.shape[-1])
    pad = lambda r: torch.cat([r, r[..., -1:].expand(-1, -1, L - r.shape[-1])], -1)
    scn = type(s1)(*[torch.cat([a, b]) for a, b in zip(s1, s2)])
    final, traj = roll(scn, torch.cat([pad(r1), pad(r2)]), torch.cat([l1, l2]))
    modes = traj["fixtime"]
    assert modes[0].tolist() != modes[1].tolist()    # mixed modes in one batch
    for b, name in enumerate(("demo1", "demo2")):
        fin1, traj1 = demo12_runs[name][4:]
        np.testing.assert_array_equal(modes[b].numpy(), traj1["fixtime"][0].numpy())
        np.testing.assert_allclose(traj["x"][b].numpy(), traj1["x"][0].numpy(),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(final.x0[b].numpy(), fin1.x0[0].numpy(), rtol=0, atol=1e-6)


def test_chained_rollouts_equal_one_rollout(demo12_runs):
    _, scn, ref, ref_len, final4, traj4 = demo12_runs["demo1"]
    roll2 = _roll("demo1", 2)[0]
    mid, ta = roll2(scn, ref, ref_len, roll2.initial_state(scn))
    fin, tb = roll2(scn, ref, ref_len, mid)
    for key in traj4:
        assert torch.equal(torch.cat([ta[key], tb[key]], dim=1), traj4[key]), key
    for a, b in zip(fin, final4):
        assert torch.equal(a, b)


def test_rollout_requires_equal_horizons():
    _, shape = _world("demo1")
    p = dataclasses.replace(get_demo("demo1").params, N_fix=4, N_free=6)
    with pytest.raises(NotImplementedError):
        make_scan_rollout(shape, p, max_steps=2, dtype=F64, device="cpu")


def test_small_sweep_rollout():
    """Two steps of four random worlds through ``sweep_inputs``,
    ``make_scan_rollout`` and ``sweep_stats``."""
    scn, shape, p, ref, ref_len = sweep_inputs(4, seed=7, dtype=F64, device="cpu")
    roll = make_scan_rollout(shape, p, max_steps=2, dtype=F64, device="cpu")
    final, traj = roll(scn, ref, ref_len)
    stats = sweep_stats(scn, final, traj)
    assert stats["replans"] == 8 and stats["failed_frac"] == 0.0
    assert 0.0 < stats["mean_progress_frac"] < 1.0
    assert torch.isfinite(traj["plan"]).all() and traj["feas"].all()


@pytest.mark.slow
def test_sweep_rollout_matches_jax():
    """Eight random worlds, 3 steps, against the JAX package's vmapped scan
    (float64): equal mode flags and feasibility, states within 1e-6. The
    free rung fails on about half of these worlds, so its fallback rung
    (fix_free_end at Ts_cur) carries many of the steps. Slow: the JAX
    rollout compiles for ~75 s."""
    import jax

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.runtime.scan_loop import (
        make_scan_rollout as jmake_scan_rollout,
    )
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.scenarios import (
        ShapeSpec as JShapeSpec,
    )
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.scenarios.build import (
        Scenario as JScenario,
    )

    scn, shape, p, ref, ref_len = sweep_inputs(8, seed=7, dtype=F64, device="cpu")
    profile = []
    final, traj = make_scan_rollout(shape, p, max_steps=3, dtype=F64, device="cpu")(
        scn, ref, ref_len, profile=profile)
    assert sum(s["free_fb"][0] for s in profile) > 0
    jshape = JShapeSpec(**dataclasses.asdict(shape))
    jscn = JScenario(*[jnp.asarray(f.numpy()) for f in scn])
    jroll = jmake_scan_rollout(jshape, p, max_steps=3, dtype=jnp.float64)
    jfinal, jtraj = jax.jit(jax.vmap(jroll))(jscn, jnp.asarray(ref.numpy()),
                                             jnp.asarray(ref_len.numpy()))
    np.testing.assert_array_equal(traj["fixtime"].numpy(), np.asarray(jtraj["fixtime"]))
    np.testing.assert_array_equal(traj["feas"].numpy(), np.asarray(jtraj["feas"]))
    np.testing.assert_allclose(traj["x"].numpy(), np.asarray(jtraj["x"]), rtol=0, atol=1e-6)
