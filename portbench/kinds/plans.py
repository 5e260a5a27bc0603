"""Traffic kind ``plans``: whole-route plans one at a time, closed loop.

Each plan starts from a point drawn from the seed's stream among the
first ``start_share`` of the map's reference path (a robot that replans
its whole remaining route after leaving it early in its trip) toward the
map's goal: the program builds the problem (``free_time_problem``: the
goal-only reference and its five starting trajectories, host A* searches
among them) and solves it as the open loop's multistart
(``entry.make_openloop_solve``), and the plan is read to the host.
Parameters: ``horizon`` (the configuration's block), ``start_share``,
``trace_from`` / ``trace_units``; every plan is checked.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from portbench.harness import port
from portbench.reference import astar as ref_astar
from portbench.reference import checks, worlds


def setup(run):
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        make_openloop_solve)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
        OBCASpec)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime.open_loop import (
        free_time_problem)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
        build_scenario)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import loop

    cfg, tr = run.cfg, run.traffic
    hz = cfg[tr["horizon"]]
    t = time.perf_counter()
    world = worlds.world_of(cfg["world"])
    path = ref_astar.reference_path(worlds.occupancy_grid(world), world["start"], world["goal"])
    ob = hz["objective"]    # the free-time weights the program takes from its MPC parameters
    demo = port.demo_spec(world, {**cfg["params"], "q_free": ob["q"], "r1_free": ob["r1"],
                                  "r2_free": ob["r2"], "time_c1": ob["time_c1"],
                                  "time_c2": ob["time_c2"]})
    _, shape = build_scenario(demo, dtype=port.dtype_of(cfg), device=run.device)
    port.same_shape(shape, world)
    spec = OBCASpec(N=hz["N"], n_obs=shape.n_obs, e_max=shape.e_max, variant=hz["variant"])
    opt = port.options(hz["options"])
    msolve = make_openloop_solve(spec, opt, impl=run.impl)
    run.setup_split["world_build_s"] = time.perf_counter() - t
    st = {"hz": hz, "path": path, "world": world, "demo": demo, "shape": shape, "opt": opt,
          "msolve": msolve, "N": hz["N"], "build_scenario": build_scenario,
          "free_time_problem": free_time_problem, "dtype": port.dtype_of(cfg),
          "n_starts": max(int(path.shape[1] * tr["start_share"]), 1),
          "rng": np.random.default_rng(run.seed), "plans": [], "kept": []}
    t = time.perf_counter()
    plan(run, st, record=False)        # one plan: the multistart's graph, built once
    run.setup_split["warmup_s"] = time.perf_counter() - t
    st["loop_stats0"] = dict(loop.stats)
    return st


def plan(run, st, record=True):
    t0 = time.perf_counter()
    with run.span("plan.problem"):
        j = int(st["rng"].integers(0, st["n_starts"]))
        x0 = tuple(float(v) for v in st["path"][:, j])
        demo = dataclasses.replace(st["demo"], start=x0)
        scn, _ = st["build_scenario"](demo, st["shape"], dtype=st["dtype"], device=run.device)
        _, data, cands = st["free_time_problem"](demo, scn, st["shape"], st["N"], demo.params,
                                                 st["dtype"])
    t1 = time.perf_counter()
    with run.span("plan.solve"):
        res, _ = st["msolve"](data, cands)
        host = {k: res.z[k].cpu().numpy() for k in ("x", "u", "T", "lam", "mu")}
        for k in ("feas", "viol", "f"):
            host[k] = getattr(res, k).cpu().numpy()
    t2 = time.perf_counter()
    if record:
        st["plans"].append({"ms": (t2 - t0) * 1e3, "solve_s": t2 - t1,
                            "iters": int(st["msolve"].last["iters"]),
                            "feasible": bool(host["feas"][0]), "start": j})
        st["kept"].append((x0, host))


def unit(run, st, i):
    plan(run, st)


def finish(run, st):
    plans = st["plans"]
    bad = sum(not p["feasible"] for p in plans)
    run.records.update(attempted=len(plans), failed=bad, plans=plans, replans=len(plans),
                       solves=[(p["solve_s"], p["iters"]) for p in plans],
                       info={"plans": len(plans), "infeasible_plans": bad,
                             "infeasible_starts": [p["start"] for p in plans if not p["feasible"]],
                             "starts": [p["start"] for p in plans]})
    st["infeas_share"] = bad / max(len(plans), 1)


def check(run, st):
    """Every plan of the window held to the NLP (``reference/checks``),
    toward the goal-only reference: the start, then the goal N times."""
    x0 = np.array([k[0] for k in st["kept"]])
    plan_ = {k: np.concatenate([h[k] for _, h in st["kept"]]) for k in st["kept"][0][1]}
    goal = np.asarray(st["world"]["goal"], np.float64)
    xref = np.repeat(goal[None, :, None], st["N"] + 1, axis=2).repeat(len(x0), axis=0)
    xref[:, :, 0] = x0
    run.records["info"]["checked_plans"] = len(x0)
    return checks.plan_checks(run.cfg, st["hz"], st["world"], xref, plan_,
                              st["opt"].acceptable_viol_tol, st["infeas_share"],
                              run.traffic["limits"], run.control, device=run.device)
