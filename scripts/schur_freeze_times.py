"""Device time and output bits of a checkout's newton_schur and ipm_freeze.

Imports the port and chip_smoke.py from the checkout ``--root`` (default:
the one holding this script) and calls that checkout's
``kernels.newton_schur`` and ``kernels.ipm_freeze`` through its own
Python wrappers, on inputs that only the port's public entry points and
chip_smoke.py's stages make, so two checkouts see the same inputs.

newton_schur: at every shape of chip_smoke.py's phase 3 (the free batch at
R = 1 and 2, the fix step's fix_terminal and fix_free_end, the sweep's
free rung, demo8's three variants, the open loop at N = 74 and N = 50;
float64 and float32), the SHA-1 of Yq and of S, each held to the plain
version (float64 within 1e-9, float32 within 1e-3, chip_smoke.py's
max_err). Timed (graph_ms: device time in a CUDA graph of 20 calls, read
twice) at the fix, free, sweep and N = 74 float32 shapes, N = 74 also in
float64, and the host driver's 2 and 5 lanes at N = 6 (the fix step's
stage) and N = 15 (demo8's fix_terminal stage), each with its byte bound.

ipm_freeze: at the fix step's 1280 lanes, the host runner's 5 and 2 lanes
(chip_smoke.py's _freeze_inputs) and the open loop's N = 74 (5 lanes,
one plain iteration after 3), float32 and float64: the SHA-1 of every
field, the active flags and the loop flag after a call with the body's
pass-through fields (sf, scE, scD) aliased, as the Newton loop runs it,
held bit for bit to freeze_plain. Timed (float32, every lane active) both
so ("loop", its byte bound counting the fields it copies) and with no
field aliased ("all", every field copied, the inputs phase 3 timed
before).

    python3 scripts/schur_freeze_times.py --root PARENT_DIR --out a.json
    python3 scripts/schur_freeze_times.py --out b.json

The freeze also at the free batch's 256 lanes (demo9, N = 10).
``--quick`` runs only the timed shapes; ``--save PATH`` keeps the float32
S of the fix shape (torch.save) to find where two checkouts differ;
``--free-batch`` also times 10 solves of the free batch through the
graphed loop and profiles 10 of its iterations (device busy time and the
kernels' device ms).
"""

import argparse
import hashlib
import json
import os
import sys
import time

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
# phase 3's stages (kind, dtype, R); the timed ones carry a label
SCHUR_SHAPES = [("free", "float64", 1, None), ("free", "float64", 2, None),
                ("free", "float32", 1, "free"),
                ("fix_terminal", "float64", 2, None), ("fix_terminal", "float32", 2, "fix"),
                ("fix_free_end", "float64", 2, None), ("fix_free_end", "float32", 2, None),
                ("sweep free", "float64", 2, None), ("sweep free", "float32", 2, "sweep"),
                ("demo8 free", "float64", 2, None), ("demo8 free", "float32", 2, None),
                ("demo8 fix_terminal", "float64", 2, None),
                ("demo8 fix_terminal", "float32", 2, "host N=15"),
                ("demo8 fix_free_end", "float64", 2, None),
                ("demo8 fix_free_end", "float32", 2, None),
                ("open74 free", "float64", 2, "N74 f64"), ("open74 free", "float32", 2, "N74"),
                ("open50 fix_terminal", "float64", 2, None),
                ("open50 fix_terminal", "float32", 2, None)]
FREEZE_KINDS = ("fix", "runner5", "runner2", "N74", "free")


def _sha(t):
    return hashlib.sha1(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def _freeze_state(kind, dtype, dev):
    """(old, new, active) at the open loop's N = 74 problem (5 candidate
    lanes) or at the free batch's (demo9, N = 10, 256 lanes): after 3
    plain iterations, new one iteration on, every second lane inactive."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        BENCH_FREE_OPTIONS, demo9_window_batch, openloop_n74_inputs)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
        init_vars)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        make_obca_solver)

    if kind == "free":
        spec, data, _, _ = demo9_window_batch(256, dtype=dtype, device=dev)
        opt, z0 = BENCH_FREE_OPTIONS, None
    else:
        spec, data, cands, opt = openloop_n74_inputs(dtype, dev)
        nC = cands.shape[1]
        data = type(data)(*[f.repeat_interleave(nC, dim=0) for f in data])
        z0 = init_vars(spec, data, x_init=cands.reshape((-1,) + cands.shape[2:]))
    solve = make_obca_solver(spec, opt, impl="plain")
    old = solve.iterate(solve.init(data, z0), data, 3)
    new = solve.step(old, data)
    active = torch.ones(old.zv.shape[0], dtype=torch.bool, device=dev)
    active[1::2] = False
    return old, new, active


def schur_rows(cs, kernels, torch, dev, quick, save):
    out, saved = {}, {}
    for kind, dt, R, label in SCHUR_SHAPES:
        if quick and label is None:
            continue
        dtype = getattr(torch, dt)
        x = cs._stage_inputs(kind, dtype, dev, R)
        L = x["L"]
        lanes = [None] + ([2, 5] if label in ("fix", "host N=15") else [])
        for n in lanes:
            sel = (lambda t: t) if n is None else (lambda t: t[:n].contiguous())
            args = (L, sel(x["Qinv"]), sel(x["asm"][4]), sel(x["asm"][3]), sel(x["ladder"]))
            fn = lambda: kernels.newton_schur(*args)
            kY, kS = fn()
            torch.cuda.synchronize()
            tol = 1e-9 if dtype == torch.float64 else 1e-3
            rel = max(cs.max_err(kY, sel(x["Yq"]))[1], cs.max_err(kS, sel(x["Smat"]))[1])
            cs.check(rel <= tol, f"schur_freeze_times {kind} {dt}: rel {rel:.3e}")
            B = args[1].shape[0]
            name = f"schur {kind} {dt} R={R}" + (f" lanes={n}" if n else "")
            row = {"lanes": B, "rel": rel, "sha1": {"Yq": _sha(kY), "S": _sha(kS)}}
            if label is not None and (n is None or label in ("fix", "host N=15")):
                row["label"] = label if n is None else f"host N={x['spec'].N} lanes={n}"
                row["graph_ms"] = [cs.graph_ms(fn, n=20, reps=5) for _ in range(2)]
                row["bound_ms"], row["bound_by"] = cs.bound(
                    cs.nbytes(*args[1:], kY, kS),
                    cs._flops("newton_schur", L, B, R, x["opt"]), dtype)
                if hasattr(kernels, "schur_launch_plan"):
                    row["plan"] = kernels.schur_launch_plan(x["spec"], L.lay, R, B, dtype)._asdict()
            if save and label == "fix" and n is None:
                saved[name] = kS.cpu()
            out[name] = row
            cs.log(f"[schur_freeze_times] {name}: {json.dumps(row)}")
        del x
        torch.cuda.empty_cache()
    return out, saved


def freeze_rows(cs, kernels, loop, torch, dev, quick):
    out = {}
    for kind in FREEZE_KINDS:
        for dt in ("float32", "float64"):
            if quick and dt == "float64":
                continue
            dtype = getattr(torch, dt)
            if kind in ("N74", "free"):
                old, new, active = _freeze_state(kind, dtype, dev)
            else:
                old, new, active = cs._freeze_inputs(kind, dtype, dev, seed=len(f"{kind} {dt}"))
            B = active.shape[0]
            cap = torch.tensor([100], dtype=torch.int32, device=dev)
            pst, pnext, pflag = loop.freeze_plain(new, old, active, cap)
            kst = type(old)(*[f.clone() for f in old])
            knew = new._replace(sf=kst.sf, scE=kst.scE, scD=kst.scD)   # as the loop passes them
            kact = active.clone()
            flag = torch.full((1,), 7, dtype=torch.int32, device=dev)
            kernels.ipm_freeze(knew, kst, kact, cap, flag)
            torch.cuda.synchronize()
            for name, a, b in zip(old._fields, kst, pst):
                cs.check(torch.equal(a, b), f"schur_freeze_times freeze {kind} {dt}: {name} differs")
            cs.check(torch.equal(kact, pnext) and torch.equal(flag, pflag),
                     f"schur_freeze_times freeze {kind} {dt}: flags differ")
            row = {"lanes": B, "active": int(active.sum()),
                   "sha1": {**{f: _sha(t) for f, t in zip(old._fields, kst)},
                            "active": _sha(kact), "flag": _sha(flag)}}
            if dt == "float32":
                # every lane active and staying active: the same work per call
                new_t = new._replace(done=torch.zeros_like(new.done))
                act = torch.ones(B, dtype=torch.bool, device=dev)
                big = torch.tensor([10 ** 6], dtype=torch.int32, device=dev)
                for how in ("loop", "all"):
                    st = type(old)(*[f.clone() for f in old])
                    nt = new_t._replace(sf=st.sf, scE=st.scE, scD=st.scD) if how == "loop" else new_t
                    fn = lambda: kernels.ipm_freeze(nt, st, act, big, flag)
                    moved = [o for n, o in zip(nt, st) if n.data_ptr() != o.data_ptr()]
                    b_ms, b_by = cs.bound(2 * cs.nbytes(*moved) + 2 * B + 8, 0, dtype)
                    row[how] = {"graph_ms": [cs.graph_ms(fn, n=20, reps=5) for _ in range(2)],
                                "bound_ms": b_ms, "bound_by": b_by}
                if hasattr(kernels, "freeze_launch_plan"):
                    row["plan"] = kernels.freeze_launch_plan(kernels._freeze_ints(
                        kernels._DTYPE_CODE[dtype], B, old,
                        [kernels.freeze_field_mode(n, o) for n, o in zip(nt, st)]))._asdict()
            out[f"freeze {kind} {dt}"] = row
            cs.log(f"[schur_freeze_times] freeze {kind} {dt}: {json.dumps(row)}")
    return out


def free_batch(cs, torch, dev):
    """The free batch (demo9, N = 10, 256 lanes, float32) through the
    graphed Newton loop: wall seconds of 10 solves after a warm one, and a
    profiler window over 10 iterations after 3 (device busy seconds, the
    kernels' device ms)."""
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        BENCH_FREE_OPTIONS, demo9_window_batch)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        make_obca_solver)

    spec, data, _, _ = demo9_window_batch(256, dtype=torch.float32, device=dev)
    solve = make_obca_solver(spec, BENCH_FREE_OPTIONS)
    solve(data)
    torch.cuda.synchronize()
    wall = []
    for _ in range(10):
        t0 = time.perf_counter()
        r = solve(data)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    st = solve.iterate(solve.init(data), data, 3)
    torch.cuda.synchronize()
    prof = cs._profile_window(lambda: solve.iterate(st, data, 13))
    row = {"wall_s": wall, "iters_max": int(r.iters.max()), "device_busy_s": prof["device_busy_s"],
           "wall_10_iterations_s": prof["wall_s"],
           "top": [(e["name"][:50], e["device_ms"], e["count"]) for e in prof["top"]]}
    cs.log(f"[schur_freeze_times] free batch: {json.dumps(row)}")
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--out", default=None)
    ap.add_argument("--save", default=None)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--free-batch", action="store_true")
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
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import loop

    assert os.path.dirname(os.path.abspath(kernels.__file__)).startswith(root), kernels.__file__
    out = {"root": root, "card": cs.phase_card(), "build_s": build.build_all()["seconds"]}
    dev = torch.device("cuda:0")
    rows, saved = schur_rows(cs, kernels, torch, dev, a.quick, save_path)
    out.update(rows)
    out.update(freeze_rows(cs, kernels, loop, torch, dev, a.quick))
    if a.free_batch:
        out["free batch"] = free_batch(cs, torch, dev)
    if save_path:
        torch.save(saved, save_path)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    cs.log(json.dumps({k: {kk: v[kk] for kk in ("graph_ms", "loop", "all") if kk in v}
                       for k, v in out.items() if isinstance(v, dict)
                       and any(kk in v for kk in ("graph_ms", "loop", "all"))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
