"""The benchmark's frozen copies and reference arithmetic against the
port and by hand, on the CPU.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

import math

import numpy as np
import pytest

from portbench.reference import astar as ref_astar  # noqa: E402
from portbench.reference import obca, worlds  # noqa: E402


def test_frozen_worlds_equal_the_ports():
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
        build_scenario, get_demo, random_scenarios)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime import (
        astar_host)

    from portbench.harness import port

    from portbench.harness import core

    base = {n: worlds.world_of(core.load_json("configs", f"{c}.json")["world"])
            for n, c in (("demo1", "corridor"), ("demo9", "demo9"))}
    scn, _ = random_scenarios(2 ** 31 + 11, 3, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(2 ** 31 + 11)
    for b in range(3):
        w = worlds.corridor_world(rng, base["demo1"])
        mine, _ = build_scenario(port.demo_spec(w, {}), dtype=torch.float64, device="cpu")
        for a, c in zip(mine, scn):
            assert torch.equal(a, c[b])
        assert np.array_equal(worlds.occupancy_grid(w), mine.grid.numpy())
    for name in ("demo1", "demo9"):
        demo, w = get_demo(name), base[name]
        for key in ("x_lo", "x_hi", "start", "goal", "dyn_obs_info", "terminal_set", "sense_dis"):
            assert np.allclose(np.asarray(getattr(demo, key), float), np.asarray(w[key], float))
        for key in ("static_lobs", "grid_rects"):
            assert len(getattr(demo, key)) == len(w[key])
            for a, c in zip(getattr(demo, key), w[key]):
                assert np.array_equal(np.asarray(a, float), np.asarray(c, float))
        s, _ = build_scenario(demo, dtype=torch.float64, device="cpu")
        o = worlds.obstacles(w, *worlds.shape_of(w))
        nS = len(w["static_lobs"])
        assert np.array_equal(o["A"][:nS], s.sA.numpy()) and np.array_equal(o["b"][:nS], s.sb.numpy())
        assert np.allclose(o["A"][nS:], s.dA.numpy()) and np.allclose(o["b"][nS:], s.db.numpy())
        grid = worlds.occupancy_grid(w)
        assert np.array_equal(grid, s.grid.numpy())
        assert np.array_equal(ref_astar.reference_path(grid, w["start"], w["goal"]),
                              astar_host.reference_path_for(grid, demo.start, demo.goal))


def test_frozen_al_counts_equal_chip_smoke_at_the_tick_shape():
    import torch

    import chip_smoke as cs
    from portbench.harness import core

    c = core.load_json("configs", "demo9.json")["al_solve_per_lane_iteration"]
    x = cs._stage_inputs("free", torch.float32, torch.device("cpu"), c["shape"]["n_deltas"])
    L, opt = x["L"], x["opt"]
    assert (opt.n_deltas, opt.n_refine, L.np_, L.K, L.bq, L.S, L.mE_sp) == (
        c["shape"]["n_deltas"], c["shape"]["n_refine"], c["shape"]["np_"], c["shape"]["K"],
        c["shape"]["bq"], c["shape"]["S"], c["shape"]["mE_sp"])
    assert cs._flops("newton_al_solve", L, 1, c["shape"]["n_deltas"], opt) == c["flops"]
    bnd = x["bnd"]
    io = [bnd.JE_sp, bnd.JEb_th, bnd.JEb_q, *x["asm"][:3], x["asm"][4], x["Qinv"], x["Yq"],
          x["Sinv"], x["rhs1"], x["rhs2"], x["ladder"], x["sols"], x["goods"]]
    assert cs.nbytes(*io) == c["bytes"] * x["st"].zv.shape[0]


def test_exact_cost_to_go_and_path_checks():
    grid = np.zeros((5, 6))
    grid[1:4, 2] = 1
    ctg = ref_astar.exact_cost_to_go(grid, (2, 5))
    # around the wall: four diagonal moves and one straight
    assert tuple(ctg[2, 0]) == (1, 4) and tuple(ctg[2, 5]) == (0, 0) and ctg[2, 2, 0] == -1
    good = [(1, 1), (0, 2), (1, 3), (2, 4), (2, 5)]
    assert ref_astar.check_path(ctg, (2, 0), np.array(good + [(2, 5)] * 3), 5) is None
    assert ref_astar.check_path(ctg, (2, 0), np.array([(2, 1), (1, 1)] + good[1:]), 6) is not None
    assert "blocked" in ref_astar.check_path(ctg, (2, 1), np.array([(2, 2)]), 1)
    assert ref_astar.check_path(ctg, (2, 0), np.array(good[:3]), 3) is None   # cut at its length
    th = ref_astar.path_headings(np.array([(0.0, 0.0), (1.0, 1.0), (1.0, 1.0)]), 2)
    assert th[0] == pytest.approx(math.pi / 4) and th[1] == th[0]


def test_violation_of_an_exact_rollout_is_its_bounds_alone():
    from portbench.harness import core

    rng = np.random.default_rng(0)
    w = worlds.world_of(core.load_json("configs", "demo9.json")["world"])
    obs = worlds.obstacles(w, *worlds.shape_of(w))
    p = {"Ts": 0.1, "v_max": 0.6, "w_max": 0.5, "a_max": 0.6, "alpha_max": 0.5,
         "ego": (1.7, 0.75, 1.7, 0.75), "dmin": 0.05, "x_lo": w["x_lo"], "x_hi": w["x_hi"]}
    B, N = 3, 8
    x0 = np.array([[2.0, 20.0, 1.5], [20.0, 52.0, 0.0], [36.0, 40.0, 1.57]])
    u = rng.uniform(-0.01, 0.01, (B, 2, N))
    T = np.full(B, 1.0)
    x = obca.rollout(x0, u, T * p["Ts"])
    d = obca.free_time_data(obs, np.repeat(x[:, :, -1:], N + 1, axis=2), p)
    d["x0"] = x0
    nO, E = obs["A"].shape[:2]
    z = {"x": x, "u": u, "T": T, "lam": np.zeros((B, N, nO, E)), "mu": np.zeros((B, N, nO, 4))}
    v = obca.violation(z, d)
    # zero duals: the distance rows read -dmin, nothing else is violated
    assert np.allclose(v, 0.05)
    assert obca.round_tf32(1.0 + 2.0 ** -12) == 1.0
    assert obca.round_tf32(1.0 + 2.0 ** -10) == 1.0 + 2.0 ** -10


def test_stationarity_of_a_kkt_point_and_of_a_slower_one():
    """A one-obstacle toy whose optimum is known: under a cost on time
    alone, the straight run at top speed to a goal ahead, the obstacle out
    of reach. Its KKT error is 0 to rounding. The same route driven at half
    the speed in twice the time, feasible too, is not a KKT point; nor is
    the fast one when time is rewarded instead."""
    from portbench.reference import kkt

    N, B = 4, 1
    obs = {"A": np.array([[[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]]]),
           "b": np.array([[51.0, 51.0, -50.0, -50.0]]), "edge_mask": np.ones((1, 4)),
           "static_mask": np.ones(1)}
    p = {"Ts": 0.1, "v_max": 0.6, "w_max": 0.5, "a_max": 100.0, "alpha_max": 100.0,
         "ego": (1.7, 0.75, 1.7, 0.75), "dmin": 0.05, "x_lo": (0.0, 0.0), "x_hi": (60.0, 60.0)}
    x0 = np.array([[5.0, 5.0, 0.0]])

    def plan(v, T):
        u = np.zeros((B, 2, N))
        u[:, 0] = v
        # the obstacle's dual on its left edge separates: g1 = mu0 - lam2 = 0
        lam = np.zeros((B, N, 1, 4))
        lam[..., 2] = 0.5
        mu = np.zeros((B, N, 1, 4))
        mu[..., 0] = 0.5
        return {"x": obca.rollout(x0, u, np.full(B, T * p["Ts"])), "u": u, "T": np.full(B, T),
                "lam": lam, "mu": mu}

    fast, slow = plan(0.6, 10.0), plan(0.3, 20.0)
    assert np.allclose(fast["x"][:, :, -1], slow["x"][:, :, -1])
    xref = np.repeat(fast["x"][:, :, -1:], N + 1, axis=2)
    xref[:, :, 0] = x0
    d = obca.free_time_data(obs, xref, p)
    d["T_max"] = np.full(B, 40.0)
    ob = {"q": 0.0, "r1": 0.0, "r2": 0.0, "p": 0.0, "time_c1": 1.0, "time_c2": 0.0,
          "pad_pin": 1.0, "dual_prox": 0.0}
    assert obca.violation(fast, d)[0] < 1e-12 and obca.violation(slow, d)[0] < 1e-12
    assert kkt.stationarity(d, fast, ob)[0] < 1e-4
    assert kkt.stationarity(d, slow, ob)[0] > 1.0
    assert kkt.stationarity(d, fast, {**ob, "time_c1": -1.0})[0] > 1.0
