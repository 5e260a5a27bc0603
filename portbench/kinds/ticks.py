"""Traffic kind ``ticks``: a fleet's controller replanning every robot's
window each tick, closed loop (the next tick starts when the last one's
plans are on the host).

A tick draws the robots' starts from the seed's stream among the points
of the map's reference path (as bench.py draws its batch), builds their
window references and NLP data, solves them in one batched free-time
solve (``make_obca_solver``, no multistart) and reads the plans to the
host. Parameters (``traffic/<name>.json``): ``robots``, ``horizon`` (the
configuration's block that gives N, the variant and the options),
``check_every`` (the stride of ticks whose plans the reference checks,
offset drawn from the seed), ``stat_checks`` (how many of those plans,
drawn from the seed, it holds to optimality), ``trace_from`` /
``trace_units``.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.harness import port
from portbench.reference import astar as ref_astar
from portbench.reference import checks, worlds


def setup(run):
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
        OBCASpec, build_obca_data)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime.reference import (
        window_reference)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
        build_scenario)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        make_obca_solver)

    cfg, tr = run.cfg, run.traffic
    hz = cfg[tr["horizon"]]
    dtype, dev = port.dtype_of(cfg), run.device
    t = time.perf_counter()
    world = worlds.world_of(cfg["world"])
    path = ref_astar.reference_path(worlds.occupancy_grid(world), world["start"], world["goal"])
    scn, shape = build_scenario(port.demo_spec(world, cfg["params"]), dtype=dtype, device=dev)
    port.same_shape(shape, world)
    spec = OBCASpec(N=hz["N"], n_obs=shape.n_obs, e_max=shape.e_max, variant=hz["variant"])
    opt = port.options(hz["options"])
    solve = make_obca_solver(spec, opt, impl=run.impl)
    run.setup_split["world_build_s"] = time.perf_counter() - t
    m, ob = cfg["model"], hz["objective"]
    st = {"hz": hz, "path": path, "scn": scn,
          "path_t": torch.as_tensor(path, dtype=dtype, device=dev),
          "spec": spec, "opt": opt, "solve": solve, "world": world, "shape": shape,
          "B": tr["robots"], "N": hz["N"], "rng": np.random.default_rng(run.seed),
          "u0": torch.zeros(2, dtype=dtype, device=dev),
          "build": lambda x0s, xref: build_obca_data(
              spec, scn, x0=x0s, u0=st["u0"], xref=xref, Ts=m["Ts"], v_max=m["v_max"],
              w_max=m["w_max"], a_max=m["a_max"], alpha_max=m["alpha_max"],
              ego=tuple(m["ego"]), dmin=m["dmin"], q=ob["q"], r1=ob["r1"], r2=ob["r2"],
              p=ob["p"], time_c1=ob["time_c1"], time_c2=ob["time_c2"]),
          "window_reference": window_reference, "ticks": [], "kept": {},
          "stride": tr["check_every"],
          "offset": int(np.random.default_rng([run.seed, 1]).integers(tr["check_every"]))}
    t = time.perf_counter()
    tick(run, st, record=False)          # one tick: the solve's graph, built once
    run.setup_split["warmup_s"] = time.perf_counter() - t
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import loop

    st["loop_stats0"] = dict(loop.stats)
    return st


def draw(st):
    """The next tick's start indices along the path (the seed's stream)."""
    return st["rng"].integers(0, st["path"].shape[1] - 2, size=st["B"])


def tick(run, st, record=True, i=0):
    import torch

    t0 = time.perf_counter()
    with run.span("tick.inputs"):
        idx = draw(st)
        idx_t = torch.as_tensor(idx, device=run.device)
        x0s = st["path_t"][:, idx_t].T.contiguous()
        xref = st["window_reference"](st["path_t"], st["path"].shape[1], x0s, st["N"])
        data = st["build"](x0s, xref)
    t1 = time.perf_counter()
    with run.span("tick.solve"):
        res = st["solve"](data)
        host = {k: res.z[k].cpu().numpy() for k in ("x", "u", "T")}
        for k in ("feas", "iters", "viol", "f"):
            host[k] = getattr(res, k).cpu().numpy()
    t2 = time.perf_counter()
    if not record:
        return
    st["ticks"].append({"ms": (t2 - t0) * 1e3, "solve_s": t2 - t1,
                        "iters_max": int(host["iters"].max()),
                        "iters_sum": int(host["iters"].sum()),
                        "infeasible": int((~host["feas"]).sum())})
    if i % st["stride"] == st["offset"]:
        host["lam"], host["mu"] = res.z["lam"], res.z["mu"]   # read after the window
        st["kept"][i] = (idx, host)


def unit(run, st, i):
    tick(run, st, True, i)
    tr = run.tracer
    if tr.on and tr.first <= i < tr.first + tr.count:
        run.records["traced_lane_iters"] = (run.records.get("traced_lane_iters", 0)
                                            + st["ticks"][-1]["iters_sum"])


def finish(run, st):
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import loop

    ticks = st["ticks"]
    lanes = len(ticks) * st["B"]
    bad = sum(t["infeasible"] for t in ticks)
    run.records.update(
        attempted=lanes, failed=bad, ticks=ticks, replans=lanes,
        solves=[(t["solve_s"], t["iters_max"]) for t in ticks],
        graph_build_ms=loop.stats["build_ms"] - st["loop_stats0"]["build_ms"],
        info={"ticks": len(ticks), "infeasible_lanes": bad,
              "graphs_built_in_window": loop.stats["captures"] - st["loop_stats0"]["captures"]})
    st["infeas_share"] = bad / max(lanes, 1)


def check(run, st):
    """The sampled ticks' plans held to the NLP (``reference/checks``):
    every plan of every ``check_every``-th tick, and ``stat_checks`` of
    them drawn from the seed for their optimality."""
    idxs, plans = [], []
    for i, (idx, host) in sorted(st["kept"].items()):
        idxs.append(idx)
        plans.append({**host, "lam": host["lam"].cpu().numpy(), "mu": host["mu"].cpu().numpy()})
    idx = np.concatenate(idxs)
    plan = {k: np.concatenate([p[k] for p in plans]) for k in plans[0]}
    path, N = st["path"], st["N"]
    # the window of a start on the path: its nearest point is itself
    xref = path[:, np.minimum(idx[:, None] + np.arange(N + 1), path.shape[1] - 1)].transpose(1, 0, 2)
    pick = np.random.default_rng([run.seed, 3])
    sample = pick.choice(idx.size, size=min(run.traffic["stat_checks"], idx.size), replace=False)
    run.records["info"].update(checked_plans=int(idx.size), optimality_checked=int(sample.size))
    return checks.plan_checks(run.cfg, st["hz"], st["world"], xref, plan,
                              st["opt"].acceptable_viol_tol, st["infeas_share"],
                              run.traffic["limits"], run.control, sample, run.device)
