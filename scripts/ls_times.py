"""Device time of a checkout's step_linesearch at the main paths' shapes.

Imports the port and chip_smoke.py from the checkout ``--root`` (default:
the one holding this script) and times that checkout's
``kernels.step_linesearch`` through its own Python wrapper, on its own
``_stage_inputs``, at phase 3's float32 shapes: the free batch (256 lanes,
R = 1), the fix step (1280 lanes, R = 2), the sweep's rollout (2048 lanes,
R = 2) and the open loop at N = 74 (5 lanes, R = 2), and at N = 74 in
float64. Then at the host closed-loop driver's shapes (2 or 5 lanes, R =
2, n_backtracks 16, float32): the fix step's stage (N = 6) and demo8's
fix-time rollout stage (N = 15), each on its first 2 and 5 lanes, and on
those 5 lanes tiled to LS_SPREAD_CTAS // 16 + 1 = 17 lanes, the fewest
the group route takes at 16 trials (one CTA a lane, so one wave on the
card: its time is that of the 5 lanes it repeats). Times: CUDA events
around eager calls (ms) and device time in a CUDA graph of 20 calls
(graph_ms), each read twice; every call's output held against the plain
version (float32 within 1e-3, float64 within 1e-9, chip_smoke.py's
max_err). To compare two checkouts, run it for each in one chip call, in
turns:

    python3 scripts/ls_times.py --root PARENT_DIR --out a.json
    python3 scripts/ls_times.py --out b.json
"""

import argparse
import dataclasses
import json
import os
import sys

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SHAPES = [("free", "float32", 1), ("fix_terminal", "float32", 2), ("sweep free", "float32", 2),
          ("open74 free", "float32", 2), ("open74 free", "float64", 2)]
# the host driver's: (stage, lanes, tiled to) at n_backtracks 16, float32
HOST_SHAPES = [("fix_terminal", 2, None), ("fix_terminal", 5, None), ("fix_terminal", 5, 17),
               ("demo8 fix_terminal", 2, None), ("demo8 fix_terminal", 5, None),
               ("demo8 fix_terminal", 5, 17)]
HOST_NB = 16


def _lanes(x, idx, nb, kernels):
    """(kernel arguments, plain arguments) of step_linesearch on the lanes
    ``idx`` of the stage ``x`` at ``nb`` trials; spelled out, since an
    older checkout's chip_smoke.py has no helper for it."""
    st, bnd = x["st"], x["bnd"]
    sel = lambda t: t[idx].contiguous()
    b = type(bnd)(*[sel(t) for t in bnd])
    data = type(x["data"])(*[sel(t) for t in x["data"]])
    head = (x["ops"], dataclasses.replace(x["opt"], n_backtracks=nb), sel(x["sols"]),
            sel(x["goods"]), sel(x["ladder"]), sel(st.zv), sel(st.s), sel(st.y), sel(st.w),
            sel(st.mu_b), sel(st.delta), sel(x["cI"]), b.cE, b.f, b, sel(x["sgn_eff"]),
            sel(x["id_off"]))
    tail = (sel(st.sf), sel(st.scE), sel(st.scD))
    return head + (kernels.pack_obca_data(data),) + tail, head + (data,) + tail


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
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.linesearch import (
        step_linesearch_plain)

    assert os.path.dirname(os.path.abspath(kernels.__file__)).startswith(root), kernels.__file__
    out = {"root": root, "card": cs.phase_card(), "build_s": build.build_all()["seconds"]}
    dev = torch.device("cuda:0")

    def time_call(label, x, idx, nb):
        args, plain = _lanes(x, idx, nb, kernels)
        fn = lambda: kernels.step_linesearch(*args)
        got = fn()
        torch.cuda.synchronize()
        rel = max(cs.max_err(g, w)[1] for g, w in zip(got, step_linesearch_plain(*plain)))
        tol = 1e-3 if x["st"].zv.dtype == torch.float32 else 1e-9
        cs.check(rel <= tol, f"ls_times {label}: rel {rel:.3e} > {tol:g}")
        row = {"lanes": len(idx), "R": x["ladder"].shape[1], "n_backtracks": nb, "rel": rel,
               "ms": [cs.time_ms(fn) for _ in range(2)],
               "graph_ms": [cs.graph_ms(fn, n=20, reps=5) for _ in range(2)]}
        if hasattr(kernels, "ls_route"):
            row["route"] = kernels.ls_route(x["L"].lay, args[17].shape[1], len(idx), nb,
                                            x["st"].zv.dtype)._asdict()
        out[label] = row
        cs.log(f"[ls_times] {label}: {json.dumps(row)}")

    for kind, dt, R in SHAPES:
        x = cs._stage_inputs(kind, getattr(torch, dt), dev, R)
        time_call(f"{kind} {dt}", x, torch.arange(x["st"].zv.shape[0], device=dev),
                  x["opt"].n_backtracks)
        del x
        torch.cuda.empty_cache()
    stages = {}
    for kind, lanes, tiled in HOST_SHAPES:
        if kind not in stages:
            stages[kind] = cs._stage_inputs(kind, torch.float32, dev, 2)
        idx = torch.arange(tiled or lanes, device=dev) % lanes
        time_call(f"host {kind} lanes={lanes}" + (f" tiled={tiled}" if tiled else ""),
                  stages[kind], idx, HOST_NB)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    cs.log(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
