"""Demo runner of the port (the JAX package's ``main.py`` modes that the
port covers so far).

    python -m vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch --demo demo1
    python -m vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch --demo demo1 --mode legacy1
    python -m vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch --demo demo9 --mode astar
    python -m vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch --demo demo1 --mode scan
    python -m vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch --demo demo9 --mode open
    python -m vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch --demo demo9 --mode time
    python -m vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch --demo demo9 --mode perf --out-prefix out/demo9
    python -m vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch --demo demo1 --gif demo1.gif

The default mode, ``closed``, is the host receding-horizon loop, as in
``main.py``; the exit code is 1 when it aborted on an infeasible replan.
Runs on the card unless given ``--device cpu``. The plots (``perf``,
``--gif``) need matplotlib.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from .entry import demo_rollout_inputs
from .runtime import (ClosedLoopRunner, Simulation, astar_host, make_scan_rollout,
                      run_open_loop)
from .scenarios import build_scenario, default_params_for, get_demo


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--demo", default="demo1",
                    help="demo1..demo11 (reference src/demo_setting.py:82-341)")
    ap.add_argument("--mode", default="closed",
                    choices=["closed", "scan", "astar", "open", "perf", "time", "legacy1",
                             "legacy3"],
                    help="closed: host receding-horizon loop; scan: the scanned "
                         "closed-loop rollout; astar: front-end only; open: two-phase "
                         "open loop (simulation.run equivalent); perf: A*/open/closed "
                         "state+input comparison (show_performance equivalent); time: "
                         "wall-clock A* + open-loop timing (calc_time equivalent); "
                         "legacy1/legacy3: the reference's closed_loop_mpc / "
                         "closed_loop_mpc3 drivers")
    ap.add_argument("--out-prefix", default=None,
                    help="perf mode: write {prefix}_states/inputs/paths.png")
    ap.add_argument("--max-steps", type=int, default=30)
    ap.add_argument("--N", type=int, default=None, help="override horizon (free and fix)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--f32", action="store_true",
                    help="solve in float32 (default float64)")
    ap.add_argument("--gif", default=None,
                    help="closed, legacy and open modes: write the animation GIF here")
    ap.add_argument("--json", default=None,
                    help="dump the trajectory records to this JSON file")
    ap.add_argument("-q", "--quiet", action="store_true")
    return ap.parse_args(argv)


def main(argv=None):
    args = _parse(argv)
    dev = torch.device(args.device)
    dtype = torch.float32 if args.f32 else torch.float64
    demo = get_demo(args.demo)
    p = default_params_for(args.demo)
    if args.N is not None:
        p = dataclasses.replace(p, N_free=args.N, N_fix=args.N)

    if args.mode == "astar":
        scn, _ = build_scenario(demo, dtype=dtype, device="cpu")
        ref = astar_host.reference_path_for(scn.grid.numpy(), demo.start, demo.goal)
        print(f"{args.demo}: A* path with {ref.shape[1]} points")
        if not args.quiet:
            for i in range(ref.shape[1]):
                print(f"  {ref[0, i]:7.2f} {ref[1, i]:7.2f} {ref[2, i]:7.3f}")
        return 0

    if args.mode == "time":
        rep = Simulation(dtype=dtype, device=dev).calc_time(args.demo, N=args.N or 10)
        print(f"{args.demo}: A* {rep.astar_s * 1e3:.2f} ms "
              f"(reference {rep.extras['reference_astar_s'] * 1e3:.1f} ms); "
              f"open-loop N={rep.open_loop_N} {rep.open_loop_s:.2f} s "
              f"feas={rep.open_loop_feas} "
              f"(reference N=10: {rep.extras['reference_open_loop_N10_s']} s)")
        return 0

    if args.mode == "perf":
        prefix = args.out_prefix or f"{args.demo}_perf"
        recs = Simulation(dtype=dtype, device=dev).show_performance(
            args.demo, N_open=args.N or 50, max_steps=args.max_steps, out_prefix=prefix)
        for label, rec in recs.items():
            xs = rec.get("x")
            print(f"  {label}: {0 if xs is None else np.asarray(xs).shape[1]} states recorded")
        print(f"wrote {prefix}_states.png / _inputs.png / _paths.png")
        return 0

    if args.mode == "scan":
        scn, shape, _, ref, ref_len = demo_rollout_inputs(args.demo, dtype, dev)
        roll = make_scan_rollout(shape, p, max_steps=args.max_steps, dtype=dtype, device=dev)
        final, traj = roll(scn, ref, ref_len)
        xs = traj["x"][0].cpu().numpy()
        feas, fix, act = (traj[k][0].cpu().numpy() for k in ("feas", "fixtime", "active"))
        for k in range(xs.shape[0]):
            if not act[k]:
                break
            mode = "fix " if fix[k] else "free"
            print(f"  k={k:3d} [{mode}] feas={bool(feas[k])} "
                  f"x=({xs[k, 0]:7.3f}, {xs[k, 1]:7.3f}, {xs[k, 2]:6.3f})")
        x0 = final.x0[0].cpu().numpy()
        print(f"{args.demo}: reached={bool(final.reached[0])} "
              f"failed={bool(final.failed[0])} steps={int(final.k[0])} "
              f"final=({x0[0]:.3f}, {x0[1]:.3f})")
        _maybe_dump(args, xs[: int(final.k[0])].T, None)
        return 0 if not bool(final.failed[0]) else 1

    if args.mode == "open":
        res = run_open_loop(args.demo, N=args.N or 50, dtype=dtype, device=dev)
        print(f"{args.demo}: open-loop feas={res.feas} "
              f"Ts_opt={res.Ts_opt:.4f} xN=({res.x[0, -1]:.3f}, "
              f"{res.x[1, -1]:.3f}, {res.x[2, -1]:.3f})")
        _maybe_dump(args, res.x, res.u)
        if args.gif:
            from .viz import animate_open_loop

            animate_open_loop(demo, res, args.gif)
            print(f"wrote {args.gif}")
        return 0 if res.feas else 1

    # the host closed loop (the reference's simulation.run_closedLoop)
    runner = ClosedLoopRunner(demo, params=p, dtype=dtype, max_steps=args.max_steps,
                              device=dev)
    if args.mode in ("legacy1", "legacy3"):
        # closed_loop_mpc (src/closed_loop.py:142) / closed_loop_mpc3 (:211)
        res = runner.run_legacy(mode="mpc1" if args.mode == "legacy1" else "mpc3",
                                verbose=not args.quiet)
    else:
        res = runner.run(verbose=not args.quiet)
    final = res.steps[-1].x if res.steps else np.asarray(demo.start)
    print(f"{args.demo}: reached_goal={res.reached_goal} "
          f"aborted={res.aborted_infeasible} steps={len(res.steps)} "
          f"final=({final[0]:.3f}, {final[1]:.3f}, {final[2]:.3f})")
    if res.steps:
        _maybe_dump(args, res.x_history.T, res.u_history.T)
    if args.gif:
        from .viz import animate_closed_loop

        animate_closed_loop(demo, res, args.gif)
        print(f"wrote {args.gif}")
    return 0 if not res.aborted_infeasible else 1


def _maybe_dump(args, xs, us):
    if args.json and xs is not None:
        rec = {"demo": args.demo, "x": np.asarray(xs).tolist()}
        if us is not None:
            rec["u"] = np.asarray(us).tolist()
        with open(args.json, "w") as f:
            json.dump(rec, f)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    sys.exit(main())
