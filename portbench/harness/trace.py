"""A traced slice of the window: ``torch.profiler`` around a few whole
units (steps, ticks or plans), reduced to device intervals.

The device's busy time is the union of the intervals in which a kernel,
a copy or a memset ran (overlapping activities counted once), so the idle
share is ``1 - union / window``. The harness's own spans
(``record_function`` ranges) name what the host was doing in each idle
gap.
"""

from __future__ import annotations

import time
from collections import defaultdict

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def union_length(intervals) -> float:
    """Total length covered by ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo, hi):
    """The ``(start, end)`` stretches of ``[lo, hi]`` that no interval covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


LOOP_START, LOOP_NEXT = "loop_start", "loop_next"


class Trace:
    """One traced slice, times in seconds from its start: ``ops`` the
    device activities' ``(name, seconds)``, ``busy`` the intervals in which
    the device ran something, ``spans`` the host's named ranges, and
    ``window_s`` the slice's wall length.

    Built by :meth:`from_events` from the profiler's device events. A
    solve that is one CUDA graph with its Newton loop under a conditional
    WHILE node (the port's ``kernels/csrc/device_loop.cu``) shows in the
    trace with its loop body recorded for one iteration only (the first or
    the last); the others ran on the device unrecorded. The loop's whole
    span counts as busy, and each body kernel's time is its share of the
    recorded iteration (its first kernel to ``loop_next``) of that span
    (held on the card to the host loop's own kernels: the summed kernel
    time within 0.4%, the AL solve's within 2.3%)."""

    def __init__(self, ops, busy, spans, window_s, units):
        self.ops = ops
        self.busy = busy
        self.spans = spans
        self.window_s = window_s
        self.units = units

    @classmethod
    def from_events(cls, events, spans, window_s, units):
        """``events``: ``(name, start, end, ...)`` device activities of one
        stream. The activities between a ``loop_start`` and the next
        ``loop_next`` are the loop's one recorded iteration (the first or
        the last: the trace's clock says which); the loop ran from the end
        of ``loop_start`` to the start of the next activity, all of it
        busy."""
        evs = sorted(events, key=lambda e: e[1])
        ops = [(e[0], e[2] - e[1]) for e in evs]
        busy = [(e[1], e[2]) for e in evs]
        i0 = None
        for i, e in enumerate(evs):
            if LOOP_START in e[0]:
                i0 = i
            elif LOOP_NEXT in e[0] and i0 is not None:
                loop_end = evs[i + 1][1] if i + 1 < len(evs) else e[2]
                it_span = e[2] - evs[i0 + 1][1]
                if it_span > 0:
                    scale = (loop_end - evs[i0][2]) / it_span
                    for j in range(i0 + 1, i + 1):
                        ops[j] = (ops[j][0], ops[j][1] * scale)
                busy.append((evs[i0][2], loop_end))
                i0 = None
        return cls(ops, busy, spans, window_s, units)

    @property
    def busy_s(self) -> float:
        return union_length(self.busy)

    def device_time(self, match) -> float:
        """Summed device time of the activities whose name ``match`` accepts."""
        return sum(t for n, t in self.ops if match(n))

    def top_ops(self, n=10):
        by = defaultdict(float)
        for name, t in self.ops:
            by[name[:120]] += t
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n=10):
        """Idle device time summed by what the host was doing (the
        innermost harness span over a gap's middle), the largest first."""
        by = defaultdict(float)
        count = defaultdict(int)
        spans = sorted(self.spans, key=lambda t: t[2] - t[1])
        for s, e in gaps(self.busy, 0.0, self.window_s):
            mid = 0.5 * (s + e)
            name = next((nm for nm, a, b in spans if a <= mid <= b), "outside every span")
            by[name] += e - s
            count[name] += 1
        return sorted(([f"{k} ({count[k]} gaps)", v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]


class Tracer:
    """Profiles units ``first .. first + count - 1`` of the window when on;
    ``unit(i)`` wraps each unit. Without a card or when off it does
    nothing."""

    def __init__(self, on: bool, first: int, count: int):
        self.on = on
        self.first = first
        self.count = count
        self.prof = None
        self.result = None
        self._t0 = None

    def warm(self):
        """Start and stop the profiler once, so that its own set-up is paid
        before the window."""
        if not self.on:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def begin(self, i):
        if not self.on or i != self.first:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self._t0 = time.perf_counter()

    def end(self, i):
        if self.prof is None or i != self.first + self.count - 1:
            return
        import torch

        torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        self.prof.stop()
        self.result = reduce(self.prof, wall, self.count)
        self.prof = None


def reduce(prof, wall, units) -> Trace:
    """The profiler's events as a :class:`Trace`: the device activities
    and the host's user spans, on the slice's own clock (its first event
    starts at 0). Read from the Chrome trace the profiler exports (written
    under the run's temporary directory and removed)."""
    import json
    import os
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    dev, spans = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        row = (e.get("name", ""), float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
        if cat in DEVICE_ACTIVITIES:
            dev.append(row)
        elif cat == "user_annotation":
            spans.append(row)
    t0 = min([r[1] for r in spans] + [r[1] for r in dev], default=0.0)
    sec = lambda r: (r[0], (r[1] - t0) * 1e-6, (r[2] - t0) * 1e-6) + tuple(r[3:])
    return Trace.from_events([sec(r) for r in dev], [sec(r) for r in spans], wall, units)
