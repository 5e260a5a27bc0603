"""The harness: finds a cell's configuration, traffic and metrics by name,
runs its set-up and measured window, checks what the window produced and
prints the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by its name in ``BENCHMARK.json``:

* ``configs/<config>.json``: the configuration (source, precision,
  ``assumed``, the solver options, the frozen work counts);
* ``traffic/<traffic>.json``: the mix's parameters, with ``kind`` naming
  the generator that reads them;
* ``kinds/<kind>.py``: one general generator and driver a traffic kind
  (``setup``, ``unit``, ``finish``, ``check``);
* ``metrics/<metric>.py``: ``read(run)`` of one metric from the run's
  records, counters and trace; None where it finds nothing to read. A
  metric with no file of its own is read by the reader of the longest
  dotted prefix of its name that has one (``device.idle_share.openloop``
  by ``device.idle_share``): the same reading in other cells.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time


BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_manifest(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(*parts):
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def load_module(folder, name, bench_dir=BENCH_DIR):
    """``<bench_dir>/<folder>/<name>.py`` as a module."""
    path = os.path.join(bench_dir, folder, f"{name}.py")
    key = f"portbench_{folder}_{name}".replace(".", "_")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(name, bench_dir=BENCH_DIR):
    """The reader module of metric ``name``: ``metrics/<name>.py``, else
    that of the longest dotted prefix of ``name`` that has a file."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        key = ".".join(parts[:n])
        if os.path.exists(os.path.join(bench_dir, "metrics", f"{key}.py")):
            return load_module("metrics", key, bench_dir)
    raise FileNotFoundError(f"no reader for metric {name!r} in {bench_dir}/metrics")


def cell(manifest, workload):
    """(workload entry, configuration, traffic) of a cell by name."""
    w = next((w for w in manifest["workloads"] if w["name"] == workload), None)
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg = load_json("configs", f"{w['config']}.json")
    traffic = load_json("traffic", f"{w['traffic']}.json")
    return w, cfg, traffic


def metrics_for(manifest, workload, trace):
    """The metric entries a run of ``workload`` reports: its end-to-end
    metrics with ``trace`` 0, its per-layer ones with 1."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in manifest[key] if workload in m.get("workloads", (workload,))]


class Run:
    """What a run records: its cell, its seed, its spans (host seconds by
    name), the kind's own records (counters among them), the set-up split
    and the traced slice."""

    def __init__(self, workload, cfg, traffic, seed, device, impl=None):
        self.workload = workload
        self.cfg = cfg
        self.traffic = traffic
        self.seed = seed
        self.device = device
        self.impl = impl
        self.spans = {}
        self.records = {}
        self.setup_split = {}
        self.tracer = None
        self.window_s = None
        self.units = 0
        self.control = None

    @contextlib.contextmanager
    def span(self, name, sync=False):
        """A named host span: its seconds add to ``spans[name]`` (ending in
        a synchronize when ``sync``), and it shows in a trace."""
        import torch

        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if sync and self.device.type == "cuda":
                    torch.cuda.synchronize()
                self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0


def run_window(run, kind, state, seconds):
    """Units back to back until ``seconds`` have passed since the first
    began; the window is the time to the end of the last one."""
    t0 = time.perf_counter()
    i = 0
    while True:
        run.tracer.begin(i)
        kind.unit(run, state, i)
        run.tracer.end(i)
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    run.window_s = time.perf_counter() - t0
    run.units = i
    kind.finish(run, state)


def format_checks(checks):
    """The compared numbers, each with its limit, as the result's last
    key holds them."""
    return {name: {"value": value, "limit": limit} for name, value, limit in checks}


def passed(checks):
    return all(value is not None and value <= limit for _, value, limit in checks)
