"""Output bits and device times of a checkout's kernels, to hold two checkouts to each other.

Imports the port and chip_smoke.py from the checkout ``--root`` (default:
the one holding this script) and calls that checkout's kernels through
its own Python wrappers, on chip_smoke.py's phase-3 stage inputs (made by
the plain versions, so two checkouts see the same inputs).

Bits (the default): the SHA-1 of every output of ``obca_kkt_provider``,
``newton_assemble`` (full and W-only), ``newton_schur``,
``newton_al_solve``, ``step_linesearch`` (the main path's route on every
lane, clean and with chip_smoke.py's four planted lanes) and, where
phase 3 checks it, ``kkt_qr``, at every stage of phase 3 in float64 and
float32 (``--variants`` adds the fix_eq_band and coupled-motion stages,
for a checkout that has them); and of every field, the active flags and
the loop flag that ``ipm_freeze`` writes, held bit for bit to
``freeze_plain``, with the body's pass-through fields (sf, scE, scD)
aliased as the Newton loop runs it, at the fix step's 1280 lanes, the
host driver's 5 and 2 lanes (chip_smoke.py's ``_freeze_inputs``), the
open loop's N = 74 (5 lanes) and the free batch's 256 lanes (demo9,
N = 10), in both dtypes; and of the field and relaxation counts of
``astar_cost_to_go`` and the path and valid mask of ``astar_extract_path``
(walking the plain field, as phase 3 does) at every A* case of phase 3
(chip_smoke.py ``_astar_grids``, taken from this script's checkout so
that both see the same cases), in both dtypes.

    python3 scripts/kernel_turns.py --root PARENT_DIR --out a.json
    python3 scripts/kernel_turns.py --variants --out b.json --compare a.json

``--compare`` lists the outputs whose SHA-1 differs from the other file's
at the stages both hold, and exits 1 where any does.

Times (``--times``): device time in a CUDA graph of 20 calls (graph_ms),
read twice, of those kernels and of one whole Newton iteration of the
kernels' solver from the stage's state ("body": ``solve.step``, the body
and its data packing) at the main paths' float32 stages (the free batch,
the fix step, the sweep's free rung, the N = 74 open loop) and at N = 74
in float64; of the provider, ``newton_schur`` and the line search
(n_backtracks 16) on the host closed-loop driver's first 2 and 5 lanes at
N = 6 (the fix step's stage) and N = 15 (demo8's fix-time stage), the
line search also on those 5 lanes tiled to 17, the fewest its group route
takes at 16 trials (one CTA a lane: one wave, the time of the 5 lanes it
repeats), and the same at the N = 74 open loop's 5 lanes (its spread
route) and tiled to 17 (its group route); of ``ipm_freeze`` at the shapes above, float32, every lane
active and staying so, with the pass-through fields aliased ("loop") and
with every field copied ("all"); and of the two A* kernels at the
sweep's 1024 maps and the demo9 and demo10 single maps, float32
(chip_smoke.py ``ASTAR_TIMED``). Run it for each checkout in one chip
call, in turns (parent, change, change, parent):

    python3 scripts/kernel_turns.py --times --root PARENT_DIR --out a.json
    python3 scripts/kernel_turns.py --times --out b.json

The bounds these times are read against are chip_smoke.py's (phase 3).
"""

import argparse
import dataclasses
import hashlib
import importlib.util
import json
import os
import sys

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
STAGES = [("free", 1), ("free", 2), ("fix_terminal", 2), ("fix_free_end", 2),
          ("sweep free", 2), ("demo8 free", 2), ("demo8 fix_terminal", 2),
          ("demo8 fix_free_end", 2), ("open74 free", 2), ("open50 fix_terminal", 2)]
VARIANT_STAGES = [("band fix_eq_band", 2), ("coupled free", 2)]
TIMED_STAGES = [("free", "float32", 1), ("fix_terminal", "float32", 2),
                ("sweep free", "float32", 2), ("open74 free", "float32", 2),
                ("open74 free", "float64", 2)]
# the host closed-loop driver's: (stage, lanes, tiled to) at HOST_NB trials, float32
HOST_SHAPES = [("fix_terminal", 2, None), ("fix_terminal", 5, None), ("fix_terminal", 5, 17),
               ("demo8 fix_terminal", 2, None), ("demo8 fix_terminal", 5, None),
               ("demo8 fix_terminal", 5, 17), ("open74 free", 5, None),
               ("open74 free", 5, 17)]
HOST_NB = 16
FREEZE_KINDS = ("fix", "runner5", "runner2", "N74", "free")


def _sha(t):
    return hashlib.sha1(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def _twice(cs, fn):
    return [cs.graph_ms(fn, n=20, reps=5) for _ in range(2)]


def _calls(cs, kernels, torch, x):
    """{name: (call, output names)} of the five fused-body kernels (and
    kkt_qr where phase 3 runs it) at the inputs ``x``."""
    st, bnd, L = x["st"], x["bnd"], x["L"]
    lanes = torch.arange(st.zv.shape[0], device=st.zv.device)
    a_args = (L, bnd, x["sigma"], x["sgn_eff"], x["ladder"], x["dd"])
    p_args, n_args = cs._provider_args(x), cs._al_args(x)
    l_args, lp_args = cs._ls_lanes(x, lanes)[0], cs._ls_lanes(x, lanes, True)[0]
    asm = ("Wpp", "Wpq", "Wqq", "Gpp0", "Gpq0", "Gqq")
    ls = ("zv", "s", "y", "w", "delta")
    calls = {
        "provider": (lambda: kernels.obca_kkt_provider(*p_args), bnd._fields),
        "assemble": (lambda: kernels.newton_assemble(*a_args), asm),
        "assemble w_only": (lambda: kernels.newton_assemble(*a_args, w_only=True), asm),
        "schur": (lambda: kernels.newton_schur(L, x["Qinv"], x["asm"][4], x["asm"][3],
                                               x["ladder"]), ("Yq", "S")),
        "al_solve": (lambda: kernels.newton_al_solve(*n_args), ("sol", "good")),
        "linesearch": (lambda: kernels.step_linesearch(*l_args), ls),
        "linesearch planted": (lambda: kernels.step_linesearch(*lp_args), ls),
    }
    spec = x["spec"]
    if ((spec.variant != "free" or spec.coupled_motion)
            and not x["kind"].startswith("open")):
        calls["kkt_qr"] = (lambda: kernels.kkt_qr(x["ops"], bnd, *x["asm"][:3], x["rhs1"],
                                                  x["rhs2"], x["ladder"], x["opt"].delta_d),
                           ("sol", "good"))
    return calls


def _body_call(x):
    """One Newton iteration of the kernels' solver from the stage's state
    (``solve.step``: the body and its data packing)."""
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        make_obca_solver)

    solve = make_obca_solver(x["spec"], x["opt"])
    return lambda: solve.step(x["st"], x["data"])


def _host_calls(cs, kernels, torch, x, lanes, tiled):
    """{name: call} on the host driver's first ``lanes`` lanes of ``x``:
    the line search at HOST_NB trials (on those lanes tiled to ``tiled``
    where given), else also the provider and newton_schur."""
    idx = torch.arange(tiled or lanes, device=x["st"].zv.device) % lanes
    l_args = cs._ls_lanes(dict(x, opt=dataclasses.replace(x["opt"], n_backtracks=HOST_NB)),
                          idx)[0]
    calls = {"linesearch": lambda: kernels.step_linesearch(*l_args)}
    if tiled is None:
        p_args = cs._provider_args(x, lanes)
        s_args = (x["L"], *[t[:lanes].contiguous()
                            for t in (x["Qinv"], x["asm"][4], x["asm"][3], x["ladder"])])
        calls.update(provider=lambda: kernels.obca_kkt_provider(*p_args),
                     schur=lambda: kernels.newton_schur(*s_args))
    return calls


def _freeze_state(cs, kind, dt, dev):
    """(old, new, active) of ipm_freeze at ``kind``: chip_smoke.py's
    _freeze_inputs, or the open loop's N = 74 problem (5 candidate lanes)
    or the free batch's (demo9, N = 10, 256 lanes) after 3 plain
    iterations, new one iteration on, every second lane inactive."""
    import torch

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        BENCH_FREE_OPTIONS, demo9_window_batch, openloop_n74_inputs)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
        init_vars)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        make_obca_solver)

    dtype = getattr(torch, dt)
    if kind not in ("N74", "free"):
        return cs._freeze_inputs(kind, dtype, dev, seed=len(f"{kind} {dt}"))
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


def freeze_bits(cs, kernels, loop, torch, old, new, active, tag):
    """{field: SHA-1} of ipm_freeze's state, active flags and loop flag,
    each held bit for bit to freeze_plain."""
    dev = active.device
    cap = torch.tensor([100], dtype=torch.int32, device=dev)
    pst, pnext, pflag = loop.freeze_plain(new, old, active, cap)
    kst = type(old)(*[f.clone() for f in old])
    knew = new._replace(sf=kst.sf, scE=kst.scE, scD=kst.scD)   # as the loop passes them
    kact = active.clone()
    flag = torch.full((1,), 7, dtype=torch.int32, device=dev)
    kernels.ipm_freeze(knew, kst, kact, cap, flag)
    torch.cuda.synchronize()
    for name, a, b in zip(old._fields, kst, pst):
        cs.check(torch.equal(a, b), f"kernel_turns freeze {tag}: {name} differs")
    cs.check(torch.equal(kact, pnext) and torch.equal(flag, pflag),
             f"kernel_turns freeze {tag}: flags differ")
    return {**{f: _sha(t) for f, t in zip(old._fields, kst)}, "active": _sha(kact),
            "flag": _sha(flag)}


def freeze_times(cs, kernels, torch, old, new):
    """graph ms of ipm_freeze, every lane active and staying so: "loop"
    with the pass-through fields aliased, "all" with every field copied."""
    dev = old.zv.device
    new_t = new._replace(done=torch.zeros_like(new.done))
    act = torch.ones(old.zv.shape[0], dtype=torch.bool, device=dev)
    big = torch.tensor([10 ** 6], dtype=torch.int32, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    row = {}
    for how in ("loop", "all"):
        st = type(old)(*[f.clone() for f in old])
        nt = new_t._replace(sf=st.sf, scE=st.scE, scD=st.scD) if how == "loop" else new_t
        row[how] = _twice(cs, lambda: kernels.ipm_freeze(nt, st, act, big, flag))
    return row


def _astar_cases():
    """(_astar_grids, ASTAR_TIMED) of this script's chip_smoke.py: phase 3's
    A* cases, built with the --root checkout's port (already first on
    sys.path)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_astar_cases",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._astar_grids, mod.ASTAR_TIMED


def astar_calls(kernels, astar, torch, dt, dev, L):
    """(label, {name: (call, output names)}) of the two A* kernels at every
    A* case of phase 3 in ``dt``; extract_path walks the plain field."""
    grids, _ = _astar_cases()
    for label, grid, start, goal, cap in grids(getattr(torch, dt), dev):
        it = astar.default_max_iters(grid) if cap is None else cap
        dp = astar.cost_to_go_plain(grid, goal, it)[0]
        yield label, {
            "astar_cost_to_go": (lambda g=grid, t=goal, i=it: kernels.astar_cost_to_go(g, t, i),
                                 ("field", "relaxations")),
            "astar_extract_path": (lambda d=dp, s=start: kernels.astar_extract_path(d, s, L),
                                   ("path", "valid"))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--out", default=None)
    ap.add_argument("--compare", default=None)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--times", action="store_true")
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    out_path = a.out and os.path.abspath(a.out)
    cmp_path = a.compare and os.path.abspath(a.compare)
    sys.path.insert(0, root)
    os.chdir(root)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        SWEEP_PATH_LEN)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.kernels import build
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.ops import astar
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import loop

    assert os.path.dirname(os.path.abspath(kernels.__file__)).startswith(root), kernels.__file__
    out = {"root": root, "card": cs.phase_card(), "build_s": build.build_all()["seconds"]}
    dev = torch.device("cuda:0")

    def put(name, row):
        out[name] = row
        cs.log(f"[kernel_turns] {name}: {json.dumps(row) if a.times else len(row)}")

    if a.times:
        for kind, dt, R in TIMED_STAGES:
            x = cs._stage_inputs(kind, getattr(torch, dt), dev, R)
            row = {name: _twice(cs, fn) for name, (fn, _)
                   in _calls(cs, kernels, torch, x).items() if name != "linesearch planted"}
            row["body"] = _twice(cs, _body_call(x))
            put(f"{kind} {dt} R={R}", row)
            del x
            torch.cuda.empty_cache()
        for kind in dict.fromkeys(k for k, _, _ in HOST_SHAPES):
            x = cs._stage_inputs(kind, torch.float32, dev, 2)
            for _, lanes, tiled in (s for s in HOST_SHAPES if s[0] == kind):
                put(f"host {kind} lanes={lanes}" + (f" tiled={tiled}" if tiled else ""),
                    {name: _twice(cs, fn) for name, fn
                     in _host_calls(cs, kernels, torch, x, lanes, tiled).items()})
            del x
        for kind in FREEZE_KINDS:
            old, new, _ = _freeze_state(cs, kind, "float32", dev)
            put(f"freeze {kind} float32", freeze_times(cs, kernels, torch, old, new))
        timed = _astar_cases()[1]
        for label, calls in astar_calls(kernels, astar, torch, "float32", dev, SWEEP_PATH_LEN):
            if label in timed:
                put(f"astar {label} float32", {name: _twice(cs, fn)
                                               for name, (fn, _) in calls.items()})
    else:
        for kind, R in STAGES + (VARIANT_STAGES if a.variants else []):
            for dt in ("float64", "float32"):
                x = cs._stage_inputs(kind, getattr(torch, dt), dev, R)
                bits = {}
                for name, (fn, fields) in _calls(cs, kernels, torch, x).items():
                    bits.update({f"{name}.{f}": _sha(t) for f, t in zip(fields, fn())})
                put(f"{kind} {dt} R={R}", bits)
                del x
                torch.cuda.empty_cache()
        for kind in FREEZE_KINDS:
            for dt in ("float64", "float32"):
                put(f"freeze {kind} {dt}", freeze_bits(
                    cs, kernels, loop, torch, *_freeze_state(cs, kind, dt, dev), f"{kind} {dt}"))
        for dt in ("float64", "float32"):
            for label, calls in astar_calls(kernels, astar, torch, dt, dev, SWEEP_PATH_LEN):
                put(f"astar {label} {dt}", {f"{name}.{f}": _sha(t) for name, (fn, fields)
                                            in calls.items() for f, t in zip(fields, fn())})
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    if cmp_path and not a.times:
        with open(cmp_path) as f:
            other = json.load(f)
        diff, same = [], 0
        for name, bits in out.items():
            if not isinstance(bits, dict) or name not in other:
                continue
            for k, h in bits.items():
                if k in other[name]:
                    if other[name][k] == h:
                        same += 1
                    else:
                        diff.append(f"{name}: {k}")
        cs.log(json.dumps({"compared": same + len(diff), "equal": same, "differ": diff}))
        return 1 if diff else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
