"""Device time of a checkout's newton_al_solve at the main paths' shapes.

Imports the port and chip_smoke.py from the checkout ``--root`` (default:
the one holding this script) and times that checkout's
``kernels.newton_al_solve`` through its own Python wrapper, on its own
``_stage_inputs``, at phase 3's float32 shapes: the free batch (256 lanes,
R = 1), the fix step (1280 lanes, R = 2), the sweep's rollout (2048 lanes,
R = 2) and the open loop at N = 74 (5 lanes, R = 2), and at N = 74 in
float64. Times: CUDA events around eager calls (ms) and device time in a
CUDA graph of 20 calls (graph_ms), each read twice. To compare two
checkouts, run it for each in one chip call, in turns:

    python3 scripts/al_solve_times.py --root PARENT_DIR --out a.json
    python3 scripts/al_solve_times.py --out b.json
"""

import argparse
import json
import os
import sys

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SHAPES = [("free", "float32", 1), ("fix_terminal", "float32", 2), ("sweep free", "float32", 2),
          ("open74 free", "float32", 2), ("open74 free", "float64", 2)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
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

    assert os.path.dirname(os.path.abspath(kernels.__file__)).startswith(root), kernels.__file__
    out = {"root": root, "card": cs.phase_card(), "build_s": build.build_all()["seconds"]}
    dev = torch.device("cuda:0")
    for kind, dt, R in SHAPES:
        x = cs._stage_inputs(kind, getattr(torch, dt), dev, R)
        opt = x["opt"]
        # spelled out: an older checkout's chip_smoke.py has no _al_args
        args = (x["L"], x["bnd"], *x["asm"][:3], x["asm"][4], x["Qinv"], x["Yq"], x["Sinv"],
                x["rhs1"], x["rhs2"], x["ladder"], x["dd"], opt.delta_d, opt.n_refine)
        fn = lambda: kernels.newton_al_solve(*args)
        good = fn()[1]
        torch.cuda.synchronize()
        row = {"lanes": x["rhs1"].shape[0], "R": R, "good_equal_plain": bool(torch.equal(
            good, x["goods"])), "ms": [cs.time_ms(fn) for _ in range(2)],
            "graph_ms": [cs.graph_ms(fn, n=20, reps=5) for _ in range(2)]}
        out[f"{kind} {dt}"] = row
        cs.log(f"[al_solve_times] {kind} {dt}: {json.dumps(row)}")
        del x, args
        torch.cuda.empty_cache()
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    cs.log(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
