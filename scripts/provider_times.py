"""Device time of a checkout's obca_kkt_provider at the main paths' shapes.

Imports the port and chip_smoke.py from the checkout ``--root`` (default:
the one holding this script) and times that checkout's
``kernels.obca_kkt_provider`` through its own Python wrapper, on its own
``_stage_inputs``, at phase 3's shapes: the free batch (256 lanes), the
fix step (1280 lanes), the sweep's free rung (2048 lanes) and the open
loop at N = 74 (5 lanes) in float32, N = 74 also in float64; then at the
host closed-loop driver's (float32, 2 and 5 lanes): the fix step's stage
(N = 6) and demo8's fix-time stage (N = 15). Times: CUDA events around
eager calls (ms) and device time in a CUDA graph of 20 calls (graph_ms),
each read twice; every call's output held against the plain version
(float32 within 1e-3, float64 within 1e-9, chip_smoke.py's max_err).
Each field's SHA-1 is recorded so that two checkouts' outputs can be
compared bit for bit, and at N = 74 (float32 and float64) the same for
``step_linesearch`` on the spread route, whose trial evaluation shares
``obca_eval.cuh`` with the provider. ``--save PATH`` also keeps ``f``,
``g`` and ``Hpp`` of the free-time float32 shapes (torch.save), to find
where two checkouts' outputs differ. To compare two checkouts, run it
for each on the same card, one after the other, in turns:

    python3 scripts/provider_times.py --root PARENT_DIR --out a.json
    python3 scripts/provider_times.py --out b.json
"""

import argparse
import hashlib
import json
import os
import sys

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
# (stage, dtype, lanes: all where None), grouped by stage
SHAPES = [("free", "float32", None), ("fix_terminal", "float32", None),
          ("fix_terminal", "float32", 2), ("fix_terminal", "float32", 5),
          ("sweep free", "float32", None), ("open74 free", "float32", None),
          ("open74 free", "float64", None), ("demo8 fix_terminal", "float32", 2),
          ("demo8 fix_terminal", "float32", 5)]


def _sha(t):
    return hashlib.sha1(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--out", default=None)
    ap.add_argument("--save", default=None)
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    out_path = a.out and os.path.abspath(a.out)
    save_path = a.save and os.path.abspath(a.save)
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
    stages, saved = {}, {}
    for kind, dt, lanes in SHAPES:
        key = (kind, dt)
        if key not in stages:
            stages.clear()
            torch.cuda.empty_cache()
            stages[key] = cs._stage_inputs(kind, getattr(torch, dt), dev, 2)
        x = stages[key]
        st, L = x["st"], x["L"]
        idx = torch.arange(lanes or st.zv.shape[0], device=dev)
        sel = lambda t: t[idx].contiguous()
        args = (x["spec"], L.lay, x["ops"].ds, sel(st.zv), sel(x["data_flat"]), sel(st.sf),
                sel(st.scE), sel(st.scD), sel(st.y), sel(x["w_d"]))
        fn = lambda: kernels.obca_kkt_provider(*args)
        got = fn()
        torch.cuda.synchronize()
        tol = 1e-3 if dt == "float32" else 1e-9
        rel = {}
        for f, g in zip(got._fields, got):
            rel[f] = cs.max_err(g, sel(getattr(x["bnd"], f)))[1]
            cs.check(rel[f] <= tol, f"provider_times {kind} {dt}: {f} rel {rel[f]:.3e} > {tol:g}")
        label = f"{kind} {dt}" + (f" lanes={lanes}" if lanes else "")
        row = {"lanes": len(idx), "rel": max(rel.values()),
               "ms": [cs.time_ms(fn) for _ in range(2)],
               "graph_ms": [cs.graph_ms(fn, n=20, reps=5) for _ in range(2)],
               "sha1": {f: _sha(g) for f, g in zip(got._fields, got)}}
        if hasattr(kernels, "provider_launch_plan"):
            row["plan"] = kernels.provider_launch_plan(x["spec"], L.lay, x["data_flat"].shape[1],
                                                       len(idx), st.zv.dtype)._asdict()
        if kind == "open74 free":
            ls_args = cs._ls_lanes(x, torch.arange(st.zv.shape[0], device=dev))[0]
            row["linesearch_sha1"] = [_sha(t) for t in kernels.step_linesearch(*ls_args)]
        out[label] = row
        if save_path and "free" in kind and dt == "float32" and not lanes:
            saved[label] = {f: getattr(got, f).cpu() for f in ("f", "g", "Hpp")}
        cs.log(f"[provider_times] {label}: {json.dumps(row)}")
    if save_path:
        torch.save(saved, save_path)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    cs.log(json.dumps({k: {"graph_ms": v["graph_ms"]} if isinstance(v, dict) and "graph_ms" in v
                       else v for k, v in out.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
