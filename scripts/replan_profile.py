"""Host-driver replans of one demo in a checkout: per-step times and a profile.

Imports the port and chip_smoke.py from the checkout ``--root`` (default:
the one holding this script), builds its kernels and drives the demo
(``--demo``, default demo5) through the host closed-loop driver
(runtime/closed_loop.py ClosedLoopRunner) on the card, float32, the
graphed Newton loop, 30 steps, ``--runs`` times in one process (the first
warms the process, as phase 11's earlier demos do for the later ones).
Each run records chip_smoke.py's ``_replan_stats`` and, for every step,
its branch, ``replan_ms``, the picked lane's Newton iterations and the
Newton loop's (the slowest candidate lane's, summed over the step's
rungs). A further run under
cProfile records the host functions with the most own time. Last, a
torch.profiler window over the demo's first fix-time replan, its winning
start as all 5 candidates, as phase 11 (e) takes demo3's
(chip_smoke.py ``_profile_replan``: wall and device busy seconds, the
idle share and the host's CUDA launches per Newton iteration, the replan
and its Newton loop alone). To compare two checkouts, run it for each on
the same card, one after the other, in turns:

    python3 scripts/replan_profile.py --root PARENT_DIR --out a.json
    python3 scripts/replan_profile.py --out b.json
"""

import argparse
import cProfile
import json
import os
import pstats
import sys
import time

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--demo", default="demo5")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    out_path = a.out and os.path.abspath(a.out)
    sys.path.insert(0, root)
    os.chdir(root)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.kernels import build
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime import (
        ClosedLoopRunner)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
        get_demo)

    assert os.path.dirname(os.path.abspath(kernels.__file__)).startswith(root), kernels.__file__
    out = {"root": root, "card": cs.phase_card(), "build_s": build.build_all()["seconds"],
           "demo": a.demo, "runs": []}
    dev = torch.device("cuda:0")

    def run(**kw):
        """One 30-step run; ``runner.rung_iters``: for every step the Newton
        loop's iterations of each rung it ran."""
        runner = ClosedLoopRunner(get_demo(a.demo), dtype=torch.float32, max_steps=30,
                                  device=dev, **kw)
        runner.rung_iters, cur = [], []
        inner_solve, inner_record = runner._msolve, runner.metrics.record

        def msolve(m, data, cands):
            out = inner_solve(m, data, cands)
            cur.append(int(m.last["iters"]))
            return out

        def record(name, value):   # a step ends where its replan_ms is recorded
            if name == "replan_ms":
                runner.rung_iters.append(list(cur))
                cur.clear()
            inner_record(name, value)

        runner._msolve, runner.metrics.record = msolve, record
        t0 = time.perf_counter()
        res = runner.run()
        torch.cuda.synchronize()
        return runner, res, time.perf_counter() - t0

    for _ in range(a.runs):
        runner, res, wall = run()
        detail = [{"fix": bool(s.fixtime), "ms": s.solve_ms, "iters": int(s.iters),
                   "loop_iters": it} for s, it in zip(res.steps, runner.rung_iters)]
        row = dict(cs._replan_stats(runner, res), seconds=wall, steps_detail=detail)
        out["runs"].append(row)
        cs.log(f"[replan_profile] {a.demo} run: " + json.dumps(
            {k: v for k, v in row.items() if k != "steps_detail"}))

    prof = cProfile.Profile()
    prof.enable()
    run()
    prof.disable()
    st = pstats.Stats(prof)
    top = sorted(st.stats.items(), key=lambda kv: kv[1][2], reverse=True)[:25]
    out["host_top_tottime_s"] = [
        {"fn": f"{os.path.relpath(f, root) if f.startswith(root) else os.path.basename(f)}"
               f":{line} {name}", "calls": v[1], "tottime_s": v[2], "cumtime_s": v[3]}
        for (f, line, name), v in top]

    rec = ClosedLoopRunner(get_demo(a.demo), dtype=torch.float32, max_steps=30, device=dev,
                           record_problems=True)
    rec.run()
    k = next(i for i, p in enumerate(rec.problems) if p["fixtime"])
    runner = ClosedLoopRunner(get_demo(a.demo), dtype=torch.float32, device=dev, loop="graph")
    out["fix_replan_step"] = k
    out["fix_replan_profile"] = cs._profile_replan(runner, rec.problems[k], 5, "graph")
    cs.log(f"[replan_profile] {a.demo} k={k} fix-time replan, graph loop: "
           + json.dumps(out["fix_replan_profile"]))
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
