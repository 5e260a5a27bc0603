"""The port's benchmark: one cell, one seed, one measured window.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. It loads the cell's configuration and
traffic (``portbench/configs``, ``portbench/traffic``), builds its inputs
from the seed, warms up the shapes the traffic uses (set-up), measures
for ``--seconds``, checks what the window produced against the plain
reference (``portbench/reference``) and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones,
read from a profiled slice of the window), ``device`` and, last, the
numbers compared with their limits (also the last lines on standard
error). ``--control tf32`` puts the reference, computed in TF32, in the
program's place (the comparison's control; no benchmark run uses it).

Exit codes: 2 bad arguments, 3 no card (or fewer than the cell needs),
4 a forbidden module loaded (JAX, its libraries or the JAX package).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".portbench_cache")


def _environment():
    """Fixed cache directories inside the checkout, few host threads, and
    no JAX pulled in by a library."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE, sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def power_limit():
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32",), default=None)
    args = ap.parse_args(argv)

    _environment()
    sys.path.insert(0, ROOT)
    from portbench.harness import core, guard

    guard.check("start")
    manifest = core.load_manifest()
    w, cfg, traffic = core.cell(manifest, args.workload)

    t = time.perf_counter()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        log(f"no card: cuda available {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count()} of {w['chips']} cards")
        return 3
    torch.set_num_threads(1)
    dev = torch.device("cuda")
    torch.cuda.init()
    torch.zeros(1, device=dev)
    split = {"python_and_torch_import_s": t - T_START, "cuda_init_s": time.perf_counter() - t}
    out, checks = execute(manifest, w, cfg, traffic, args.seed, args.seconds, args.trace, dev,
                          split, control=args.control)
    guard.check("result")
    for name, value, limit in checks:
        log(f"[check] {name} {value!r} limit {limit!r}")
    print(json.dumps(out), flush=True)
    return 0


def execute(manifest, w, cfg, traffic, seed, seconds, trace, dev, split, control=None,
            impl=None):
    """Set-up, window, checks and metrics of one run on ``dev``: returns
    the result line's object and the checks ``(name, value, limit)``.
    ``impl="plain"`` runs the port's plain kernels (CPU tests)."""
    import torch

    from portbench.harness import core, guard
    from portbench.harness.trace import Tracer

    cuda = dev.type == "cuda"
    kind = core.load_module("kinds", traffic["kind"])
    run = core.Run(w["name"], cfg, traffic, seed, dev, impl)
    run.control = control
    run.setup_split = split
    run.tracer = Tracer(bool(trace) and cuda, traffic["trace_from"], traffic["trace_units"])
    if cuda:   # the port's kernels: built on a checkout's first run, loaded on every run
        t = time.perf_counter()
        from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.kernels import (
            build as kbuild)

        built = kbuild.build_all()
        for name in kbuild.SOURCES:
            kbuild.load(name)
        split["kernel_build_and_load_s"] = time.perf_counter() - t
        split["nvcc_s"] = built["seconds"]
    state = kind.setup(run)
    run.tracer.warm()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START
    log(f"[setup] {setup_s:.3f} s: " + json.dumps(run.setup_split))

    core.run_window(run, kind, state, seconds)
    mem_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    guard.check("window closed")
    run.records["setup_s"] = setup_s

    t = time.perf_counter()
    checks = kind.check(run, state)
    ref_s = time.perf_counter() - t
    bad_ref = guard.reference_imports_port() + guard.reference_sources_naming(
        os.path.join(HERE, "reference"))
    if bad_ref:
        raise guard.GuardError("the reference names the port or JAX: " + ", ".join(bad_ref))

    metrics = {}
    for m in core.metrics_for(manifest, w["name"], trace):
        value = core.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": w["chips"], "memory_peak_bytes": mem_peak,
              "power_limit": power_limit() if cuda else None}
    out = {"correct": core.passed(checks), "attempted": run.records.get("attempted", 0),
           "failed": run.records.get("failed", 0), "metrics": metrics, "device": device}
    tr = run.tracer.result
    if trace and tr is not None:
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    out["info"] = {"window_s": run.window_s, "units": run.units, "reference_s": ref_s,
                   "setup_split": run.setup_split, **run.records.get("info", {})}
    out["checks"] = core.format_checks(checks)
    return out, checks


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:   # the guard's and every other failure: no result line
        if type(e).__name__ == "GuardError":
            print(str(e), file=sys.stderr, flush=True)
            sys.exit(4)
        raise
