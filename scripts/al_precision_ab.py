"""Precision rules of newton_al_solve (csrc/newton.cu) compared on the card.

The AL solve's vectors and sums take the type ``AlAcc`` of csrc/newton.cu;
its spine product Si rp is summed in float64 whatever that type. This
script builds the kernel under four rules, each by substituting that one
line (and, for "t", the spine sum), into the gitignored build directory:

    f64        every vector and sum in float64, on both routes
    staged64   float64 on the staged route, the tensor's type on the
               global route (long horizons)
    t_spine64  the tensor's type, Si rp alone summed in float64
    t          the tensor's type everywhere

and holds each, on the same float32 inputs, to what chip_smoke.py's phase
3 holds the built kernel to:

  1. at every float32 shape of phase 3, the saddle-system residual of
     every accepted (lane, rung) against its limit, 3 x max(plain,
     float64 algorithm) + 1e3 eps: the lanes above it and the largest
     ratio. The plain float32 version is held to the same limit with its
     spine products (Wpp dp, Si rp) summed in other orders (left to
     right, right to left, in float64): how far float32 rounding alone
     moves the residual of an ill-conditioned lane;
  2. the free-time batch (demo9, 256 lanes, phase 5's options) at
     ``--seeds`` draws of its start points (seed 0 is phase 5's batch):
     Newton iterations (median, max) and solves per second, the plain
     version's iterations beside them;
  3. device time in a CUDA graph at the fix, free, sweep and N = 74
     shapes.

Run from the root of a checkout on a machine with the card:

    python3 scripts/al_precision_ab.py [--seeds 4] [--out report.json]
"""

import argparse
import ctypes
import inspect
import json
import os
import re
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels  # noqa: E402
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.kernels import build  # noqa: E402
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import newton  # noqa: E402

RULES = {   # rule: (AlAcc's type, Si rp summed in float64)
    "f64": ("double", True),
    "staged64": ("typename std::conditional<STAGED, double, T>::type", True),
    "t_spine64": ("T", True),
    "t": ("T", False),
}
SHAPES = [("free", 1), ("fix_terminal", 2), ("fix_free_end", 2), ("sweep free", 2),
          ("demo8 free", 2), ("demo8 fix_terminal", 2), ("demo8 fix_free_end", 2),
          ("open74 free", 2), ("open50 fix_terminal", 2)]
TIMED = {"free": "free", "fix_terminal": "fix", "sweep free": "sweep", "open74 free": "N74"}
ORDERS = ("seq", "rev", "f64")


def rule_source(rule):
    src = open(os.path.join(build.SRC_DIR, "newton.cu")).read()
    acc, spine64 = RULES[rule]
    src, n = re.subn(r"using AlAcc = [^;]*;", f"using AlAcc = {acc};", src)
    assert n == 1, "csrc/newton.cu: no single AlAcc line"
    if "std::" in acc:
        src = "#include <type_traits>\n" + src
    if not spine64:
        a = src.index("void pass_spine(")
        b = src.index("double acc = 0;", a)
        src = src[:b] + "A acc = 0;" + src[b + len("double acc = 0;"):]
    return src


def build_rules(out_dir):
    """One newton library a rule, nvcc in parallel (beside build_all)."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for rule in RULES:
        src = os.path.join(out_dir, f"newton_{rule}.cu")
        with open(src, "w") as f:
            f.write(rule_source(rule))
        # the copy includes common.cuh from the source directory
        procs[rule] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", build.SRC_DIR, "-o",
             os.path.join(out_dir, f"libnewton_{rule}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    build.build_all()
    libs = {}
    for rule, p in procs.items():
        log, _ = p.communicate()
        assert p.returncode == 0, f"{rule}: build failed\n{log}"
        lib = ctypes.CDLL(os.path.join(out_dir, f"libnewton_{rule}.so"))
        for fn in build._ENTRIES["newton"]:
            getattr(lib, fn).argtypes = build._SIG
            getattr(lib, fn).restype = ctypes.c_int
        lib.vmp_error_string.argtypes = [ctypes.c_int]
        lib.vmp_error_string.restype = ctypes.c_char_p
        libs[rule] = lib
    return libs


def use(lib):
    build._libs["newton"] = lib


def plain_in_order(order):
    """newton_al_solve_plain with its (B, p, c) x (B, c) products (Wpp dp,
    Si rp) summed in ``order``."""
    real = torch.einsum

    def einsum(eq, a, b):
        if eq != "bpc,bc->bp":
            return real(eq, a, b)
        prod = a * b[:, None, :]
        if order == "f64":
            return prod.double().sum(-1).to(a.dtype)
        cols = range(prod.shape[-1])
        acc = torch.zeros_like(prod[..., 0])
        for c in (cols if order == "seq" else reversed(cols)):
            acc = acc + prod[..., c]
        return acc

    class Torch:
        pass

    tp = Torch()
    tp.__dict__.update({k: getattr(torch, k) for k in ("cat", "stack", "sum", "isfinite")})
    tp.einsum = einsum
    g = dict(newton.__dict__, torch=tp)
    exec(inspect.getsource(newton.newton_al_solve_plain), g)
    return g["newton_al_solve_plain"]


def residual_rows(x, x64, exact, sols):
    """Per rung, for each solver: accepted lanes above phase 3's limit and
    the largest ratio to it (the plain version's accepted lanes)."""
    eps = torch.finfo(torch.float32).eps
    out = []
    for j in range(x["ladder"].shape[1]):
        g = x["goods"][:, j]
        dl = x64["ladder"][:, j]
        rp = cs._saddle_residual(x64, x["sols"][:, j].double(), dl)
        re = cs._saddle_residual(x64, exact[:, j], dl)
        lim = 3.0 * torch.maximum(rp, re) + 1e3 * eps
        row = {"accepted": int(g.sum()), "max_plain": rp[g].max().item() if g.any() else 0.0,
               "max_float64": re[g].max().item() if g.any() else 0.0}
        for name, (s, good) in sols.items():
            ok = g & good[:, j]
            r = cs._saddle_residual(x64, s[:, j].double(), dl)
            q = (r / lim)[ok]
            row[name] = {"good_equal": bool(torch.equal(good[:, j], g)),
                         "above": int((q > 1).sum()),
                         "max_ratio": q.max().item() if ok.any() else 0.0}
        out.append(row)
    return out


def part_residuals(libs, dev, report):
    for kind, R in SHAPES:
        t0 = time.time()
        x = cs._stage_inputs(kind, torch.float32, dev, R)
        x64 = cs._float64(x)
        args = cs._al_args(x)
        exact = newton.newton_al_solve_plain(
            x64["ops"], x64["bnd"], *x64["asm"][:3], x64["asm"][4], x64["Qinv"], x64["Yq"],
            x64["Sinv"], x64["rhs1"], x64["rhs2"], x64["ladder"], x["dd"], x["opt"].delta_d,
            x["opt"].n_refine)[0]
        sols, times = {}, {}
        for rule, lib in libs.items():
            use(lib)
            sols[rule] = kernels.newton_al_solve(*args)
            if kind in TIMED:
                times[rule] = cs.graph_ms(lambda: kernels.newton_al_solve(*args), reps=5)
        for order in ORDERS:
            sols[f"plain_{order}"] = plain_in_order(order)(x["ops"], *args[1:])
        torch.cuda.synchronize()
        row = {"lanes": x["rhs1"].shape[0], "np": x["L"].np_,
               "rungs": residual_rows(x, x64, exact, sols)}
        if times:
            row["graph_ms"] = times
        report["shapes"][kind] = row
        cs.log(f"[residual] {kind} ({time.time() - t0:.1f} s): {json.dumps(row)}")
        del x, x64, exact, sols
        torch.cuda.empty_cache()


def part_free_batch(libs, dev, seeds, report, reps=3):
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        BENCH_FREE_OPTIONS, demo9_starts, demo9_window_batch)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        make_obca_solver)

    B = 256
    _, ref = demo9_starts(1)
    for seed in range(seeds):
        starts = np.sort(np.random.RandomState(seed).randint(0, ref.shape[1] - 2, size=B))
        spec, data, _, _ = demo9_window_batch(B, dtype=torch.float32, device=dev, starts=starts)
        row = {}
        solve = make_obca_solver(spec, BENCH_FREE_OPTIONS, impl="plain")
        st = cs._batch_stats(solve(data), B)
        row["plain"] = {k: st[k] for k in ("feasible_fraction", "iters_median", "iters_max")}
        for rule, lib in libs.items():
            use(lib)
            solve = make_obca_solver(spec, BENCH_FREE_OPTIONS)
            r = solve(data)   # warm-up and capture
            times, r = cs._timed_runs(lambda: solve(data), reps)
            st = cs._batch_stats(r, B)
            row[rule] = {k: st[k] for k in ("feasible_fraction", "iters_median", "iters_max")}
            row[rule]["solves_per_s"] = B / statistics.median(times)
            row[rule]["ms_per_iter"] = 1e3 * statistics.median(times) / st["iters_max"]
        report["free_batch"][str(seed)] = row
        cs.log(f"[free batch] seed {seed}: {json.dumps(row)}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = cs.phase_card()
    dev = torch.device("cuda:0")
    t0 = time.time()
    libs = build_rules(os.path.join(build.BUILD_DIR, "al_rules"))
    cs.log(f"built {len(libs)} rules in {time.time() - t0:.1f} s")
    report = {"card": smi, "shapes": {}, "free_batch": {}}
    part_residuals(libs, dev, report)
    part_free_batch(libs, dev, a.seeds, report)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(report, f, indent=1)
    cs.log(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
