"""Tracing and profiling: named ranges that show up in device traces,
a profiler window that writes a Chrome trace, and wall-clock timing (the
JAX package's ``utils/profiling.py``; the reference's only
instrumentation is ttictoc wall timing, ``src/simulation.py:15,219-229``).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def annotate(name: str):
    """A named range around a block: a ``torch.profiler`` record (host
    side of a trace) and, where a card is present, an NVTX range. Costs
    little when no trace is active."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile a block and write a Chrome trace (``trace.json`` under
    ``log_dir``, readable by Perfetto or chrome://tracing)::

        with device_trace("traces/solve") as prof:
            solve(data)

    CUDA activity (the kernels' device events) is recorded where a card is
    present. Yields the profiler; the trace's path is ``prof.trace_path``
    after the block."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.trace_path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(prof.trace_path)


@contextlib.contextmanager
def wall_timer(label: str, sink=None):
    """ttictoc-equivalent wall timing (src/simulation.py:219-231); ``sink``
    is an optional callable(label, seconds), else the time is printed."""
    t0 = time.time()
    try:
        yield
    finally:
        dt = time.time() - t0
        if sink is None:
            print(f"[{label}] {dt:.3f} s")
        else:
            sink(label, dt)


__all__ = ["annotate", "device_trace", "wall_timer"]
