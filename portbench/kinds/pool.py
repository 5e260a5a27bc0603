"""Traffic kind ``pool``: a steady population of worlds in flight through
the closed-loop rollout, one step a call.

``worlds`` lanes each hold a world of the configuration's randomized
family. The worlds come from a catalog of ``catalog`` worlds drawn once
from ``catalog_seed`` (``random_gen.py``'s draws), pass after pass, each
pass in catalog order shuffled by the run's seed within blocks of
``shuffle_block``: every seed drives the same worlds in the same stretch
of the window, so the seed changes the order of the work and not the
work (a whole-catalog shuffle let a seed move the rate by 10%). Each step is one
call of the port's ``make_scan_rollout`` rollout of one step, chained by
``st0=``. A world leaves when it has reached its goal, failed, or had
``max_replans`` replans; the stream's next world takes its lane for the
next step, its reference path planned by the batched wavefront A*
(``ops/astar.plan_grid_path``) inside the window. The first trips' step
budgets are staggered over 1 .. ``max_replans`` so that departures spread
over the window: catalog world i's first trip has 1 + i mod
``max_replans``, the same for every seed. ``warmup_steps`` steps run before the window (set-up).
Checks: every world-step's bookkeeping, a sample of ``plan_checks``
applied plans and of ``astar_checks`` arrivals' paths, drawn from the
seed.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.harness import port
from portbench.reference import astar as ref_astar
from portbench.reference import obca, rollout as ref_rollout, worlds

OUT = ("x", "u", "Ts_opt", "fixtime", "feas", "plan")


def setup(run):
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.ops import astar
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime.scan_loop import (
        make_scan_rollout)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
        build_scenario, stack_scenarios)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import loop

    cfg, tr = run.cfg, run.traffic
    dtype, dev = port.dtype_of(cfg), run.device
    ro = cfg["rollout"]
    base = worlds.world_of(cfg["world"])
    t = time.perf_counter()
    cat = np.random.default_rng(tr["catalog_seed"])
    st = {"rng": np.random.default_rng(run.seed), "B": tr["worlds"], "queue": [],
          "shuffle_block": tr["shuffle_block"],
          "worlds": [worlds.corridor_world(cat, base) for _ in range(tr["catalog"])],
          "max_replans": tr["max_replans"], "dtype": dtype, "astar": astar,
          "build_scenario": build_scenario, "stack": stack_scenarios, "base": base,
          "params": cfg["params"], "path_len": ro["path_len"], "steps": [], "trips": [],
          "arrivals": [], "record": False}
    _, shape = build_scenario(port.demo_spec(base, cfg["params"]), dtype=dtype, device="cpu")
    port.same_shape(shape, base)
    st["shape"] = shape
    ids = [_draw(st) for _ in range(st["B"])]
    scn = _scenarios(st, ids, dev)
    ref, ref_len = _routes(run, st, ids, scn)
    st["scn"], st["ref"], st["ref_len"] = scn, ref, ref_len
    st["lane_world"] = np.asarray(ids)
    st["budget"] = 1 + st["lane_world"] % st["max_replans"]
    run.setup_split["world_build_s"] = time.perf_counter() - t
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios.demos import (
        MPCParams)

    m = cfg["model"]
    p = MPCParams(**{**cfg["params"], "N_free": m["N"], "N_fix": m["N"]})
    st["rollout"] = make_scan_rollout(shape, p, max_steps=1, options=port.options(ro["options"]),
                                      dtype=dtype, qr_rescue=ro["qr_rescue"], device=dev,
                                      impl=run.impl)
    st["state"] = st["rollout"].initial_state(scn)
    t = time.perf_counter()
    for i in range(tr["warmup_steps"]):
        step(run, st, i)
    run.setup_split["warmup_s"] = time.perf_counter() - t
    st["record"] = True
    st["loop_stats0"] = dict(loop.stats)
    run.spans.clear()
    return st


def _draw(st):
    """The id of the next world of the seed's stream: the catalog's worlds
    pass after pass, each pass in catalog order with every block of
    ``shuffle_block`` consecutive worlds in an order drawn from the seed
    (every seed sends the same worlds in the same stretch of the window)."""
    if not st["queue"]:
        n, k = len(st["worlds"]), st["shuffle_block"]
        order = np.concatenate([lo + st["rng"].permutation(min(k, n - lo))
                                for lo in range(0, n, k)])
        st["queue"] = list(order[::-1])
    return int(st["queue"].pop())


def _scenarios(st, ids, dev):
    built = [st["build_scenario"](port.demo_spec(st["worlds"][i], st["params"]), st["shape"],
                                  dtype=st["dtype"], device="cpu")[0] for i in ids]
    return st["stack"](built, dev)


def _routes(run, st, ids, scn):
    """Reference paths (B, 3, L) and their real lengths (B,) of the worlds
    ``ids`` (their scenarios ``scn``) by the batched wavefront A* (start
    and goal cells (int(y), int(x)), as bench_sweep.py; every world of the
    family has a path: the block leaves a free row beside it)."""
    import torch

    astar = st["astar"]
    cell = lambda pose: pose[:, [1, 0]].to(torch.int32)
    with run.span("pool.arrivals.astar", sync=True):
        path, valid = astar.plan_grid_path(scn.grid, cell(scn.start), cell(scn.goal),
                                           st["path_len"], impl=run.impl)
        xy = path.flip(-1).to(st["dtype"])
        ref = astar.path_to_reference(xy, valid).transpose(1, 2).contiguous()
        ref_len = valid.sum(1).to(torch.int32)
    if st["record"]:
        st["arrivals"].append((list(ids), path.cpu().numpy(), valid.cpu().numpy(),
                               ref.cpu().numpy()))
    return ref, ref_len


def step(run, st, i):
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime.scan_loop import (
        LoopState)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios.build import (
        Scenario)

    before = st["state"]
    prof = []
    with run.span("pool.step"):
        final, traj = st["rollout"](st["scn"], st["ref"], st["ref_len"], st0=before,
                                    profile=prof)
    with run.span("pool.read"):
        flags = torch.stack([final.active, final.reached, final.failed,
                             traj["active"][:, 0]]).cpu().numpy()
        k = final.k.cpu().numpy()
    active, reached, failed, was = flags
    lw = st["lane_world"]
    leave = np.nonzero(~active | (k >= st["budget"]))[0]
    if st["record"]:
        st["steps"].append({"lane_world": lw.copy(), "before": before, "after": final,
                            "out": {key: traj[key][:, 0] for key in OUT}, "profile": prof[0],
                            "replans": int(was.sum())})
        st["trips"] += [(int(k[j]), bool(reached[j]), bool(failed[j])) for j in leave]
    if leave.size == 0:
        st["state"] = final
        return
    with run.span("pool.arrivals"):
        ids = [_draw(st) for _ in leave]
        with run.span("pool.arrivals.build"):
            fresh = _scenarios(st, ids, run.device)
        ref, ref_len = _routes(run, st, ids, fresh)
        sel = torch.as_tensor(leave, device=run.device)
        st["scn"] = Scenario(*[f.index_copy(0, sel, g) for f, g in zip(st["scn"], fresh)])
        L = st["ref"].shape[2]
        st["ref"] = st["ref"].index_copy(0, sel, ref[:, :, :L])
        st["ref_len"] = st["ref_len"].index_copy(0, sel, ref_len)
        init = st["rollout"].initial_state(fresh)
        st["state"] = LoopState(*[f.index_copy(0, sel, g) for f, g in zip(final, init)])
        lw = lw.copy()
        lw[leave] = ids
        st["lane_world"] = lw
        budget = st["budget"].copy()
        budget[leave] = st["max_replans"]
        st["budget"] = budget


def unit(run, st, i):
    step(run, st, i)


def finish(run, st):
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import loop

    steps = st["steps"]
    replans = sum(s["replans"] for s in steps)
    trips = st["trips"]
    failed = sum(f for _, _, f in trips)
    n_arr = sum(len(a[0]) for a in st["arrivals"])
    hist = np.bincount([t for t, _, _ in trips], minlength=st["max_replans"] + 1)
    run.records.update(
        replans=replans, attempted=replans,
        failed=sum(int((~s["out"]["feas"].cpu().numpy()).sum()) for s in steps),
        rung_profile=[s["profile"] for s in steps], arrivals=n_arr,
        graph_build_ms=loop.stats["build_ms"] - st["loop_stats0"]["build_ms"],
        info={"steps": len(steps), "trips": len(trips), "trips_reached": sum(r for _, r, _ in trips),
              "fixtime_replans": sum(int(s["out"]["fixtime"].sum()) for s in steps),
              "trips_failed": failed, "arrivals": n_arr,
              "trip_steps_histogram": hist.tolist(),
              "graphs_built_in_window": loop.stats["captures"] - st["loop_stats0"]["captures"]})
    st["failed_share"] = run.records["failed"] / max(replans, 1)


def _host(t):
    return {k: v.cpu().numpy() for k, v in t.items()}


def check(run, st):
    """Every world-step's bookkeeping, a sample of applied plans and of the
    arrivals' paths, held to ``reference/rollout`` and ``reference/astar``."""
    cfg, lim = run.cfg, run.traffic["limits"]
    steps = st["steps"]
    wid = np.concatenate([s["lane_world"] for s in steps])
    cat = lambda parts: {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    before = cat([_host(s["before"]._asdict()) for s in steps])
    after = cat([_host(s["after"]._asdict()) for s in steps])
    out = cat([_host(s["out"]) for s in steps])
    used = np.unique(wid)
    table = ref_rollout.WorldTable([st["worlds"][i] for i in used], *worlds.shape_of(st["base"]))
    rows = np.searchsorted(used, wid)
    p = {**cfg["model"]}
    N = p["N"]
    pick = np.random.default_rng([run.seed, 2])
    sample = pick.choice(len(wid), size=min(run.traffic["plan_checks"], len(wid)), replace=False)
    rnd = obca.round_tf32 if run.control == "tf32" else None
    tol = run.cfg["rollout"]["options"]["acceptable_viol_tol"]
    err, flags, pv = ref_rollout.check_steps(table, rows, before, out, after, p, N, tol,
                                             rnd=rnd, plan_rows=sample)
    bad, head = _astar_checks(run, st, pick, rnd)
    run.records["info"].update(checked_world_steps=int(len(wid)),
                               checked_plans=int(min(len(sample), len(wid))))
    return [("state_err", err, lim["state_err"]),
            ("state_flags", flags, lim["state_flags"]),
            ("plan_viol", pv, tol * (1.0 + lim["plan_viol_tol_margin"])),
            ("astar_bad", bad, lim["astar_bad"]),
            ("heading_err", head, lim["heading_err"]),
            ("failed_share", st["failed_share"], lim["max_failed_share"])]


def _astar_checks(run, st, pick, rnd):
    """(paths that are no optimal path's beginning, largest heading error)
    over a sample of the window's arrivals."""
    rows = [(wid, path[j], valid[j], ref[j]) for ids, path, valid, ref in st["arrivals"]
            for j, wid in enumerate(ids)]
    if not rows:
        return 0, 0.0
    take = pick.choice(len(rows), size=min(run.traffic["astar_checks"], len(rows)), replace=False)
    bad, head = 0, 0.0
    for t in take:
        wid, cells, valid, ref = rows[t]
        w = st["worlds"][wid]
        grid = worlds.occupancy_grid(w)
        start = (int(w["start"][1]), int(w["start"][0]))
        goal = (int(w["goal"][1]), int(w["goal"][0]))
        n = int(valid.sum())
        if rnd is not None:   # the control: the reference's search in TF32 in the program's place
            cells, n = _tf32_walk(grid, start, goal, len(cells))
        if ref_astar.check_path(ref_astar.exact_cost_to_go(grid, goal), start, cells, n):
            bad += 1
        th = ref_astar.path_headings(cells[:, ::-1].astype(np.float64), n)
        got = ref[2] if rnd is None else rnd(th)
        d = np.abs((got - th + np.pi) % (2 * np.pi) - np.pi)
        head = max(head, float(d[:max(n, 1)].max()))
    return bad, head


def _tf32_walk(grid, start, goal, L):
    """The greedy descent of ``ops/astar.extract_path`` over the exact
    cost-to-go rounded to TF32: (L, 2) cells and the count of real ones."""
    ctg = ref_astar.exact_cost_to_go(grid, goal)
    d = np.where(ctg[..., 0] >= 0, ctg[..., 0] + ctg[..., 1] * ref_astar.SQRT2, 1e9)
    d = obca.round_tf32(d)
    rows, cols = grid.shape
    y, x = start
    cells, n = [], None
    for i in range(L):
        here = d[y, x]
        best, by, bx = here, y, x
        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1)):
            ny, nx = y + dy, x + dx
            c = d[ny, nx] if 0 <= ny < rows and 0 <= nx < cols else 1e9
            if c < best:
                best, by, bx = c, ny, nx
        if here > 0:
            y, x = by, bx
        cells.append((y, x))
        if n is None and d[y, x] <= 0:
            n = i + 1
    return np.asarray(cells), (n if n is not None else L)
