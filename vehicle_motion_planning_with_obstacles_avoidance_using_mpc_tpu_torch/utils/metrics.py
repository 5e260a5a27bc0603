"""Structured metrics & logging — replaces the reference's print-based
observability (src/closed_loop.py:194,282-291,402-405; src/obca.py:315,
1053) with per-step records, latency quantiles, and counters
(SURVEY.md section 5 "Metrics / logging / observability").

A copy of the JAX package's ``utils/metrics.py`` (plain Python, reachable
there only through that package's jax-importing ``__init__``); the
quantiles and counters are the same.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class MetricsLogger:
    """Accumulates named scalar series and counters; dumps JSONL.

    Usage::

        m = MetricsLogger()
        with m.timer("solve"):
            ...
        m.record("kkt_err", 1e-6)
        m.bump("replans")
        m.summary()   # {'solve': {'p50': ..., 'p99': ..., 'count': ...}}
    """

    series: dict = field(default_factory=lambda: defaultdict(list))
    counters: dict = field(default_factory=lambda: defaultdict(int))
    _t0: float = field(default_factory=time.time)

    def record(self, name: str, value: float):
        self.series[name].append(float(value))

    def bump(self, name: str, n: int = 1):
        self.counters[name] += n

    def timer(self, name: str):
        return _Timer(self, name)

    def quantiles(self, name: str, qs=(0.5, 0.9, 0.99)):
        xs = sorted(self.series.get(name, ()))
        if not xs:
            return {f"p{int(q * 100)}": None for q in qs}
        out = {}
        for q in qs:
            i = min(int(q * len(xs)), len(xs) - 1)
            out[f"p{int(q * 100)}"] = xs[i]
        return out

    def rate(self, counter: str) -> float:
        """counter / elapsed seconds since logger creation."""
        dt = time.time() - self._t0
        return self.counters.get(counter, 0) / dt if dt > 0 else 0.0

    def summary(self) -> dict:
        out = {}
        for name, xs in self.series.items():
            s = sorted(xs)
            out[name] = {
                "count": len(s),
                "mean": sum(s) / len(s),
                "min": s[0],
                "max": s[-1],
                **self.quantiles(name),
            }
        out["counters"] = dict(self.counters)
        out["elapsed_s"] = time.time() - self._t0
        return out

    def dump_jsonl(self, path: str):
        with open(path, "w") as f:
            for name, xs in self.series.items():
                for i, v in enumerate(xs):
                    f.write(json.dumps({"name": name, "i": i, "v": v}) + "\n")
            f.write(json.dumps({"summary": self.summary()}) + "\n")


class _Timer:
    def __init__(self, m: MetricsLogger, name: str):
        self.m, self.name = m, name

    def __enter__(self):
        self.t = time.time()
        return self

    def __exit__(self, *exc):
        self.m.record(self.name, (time.time() - self.t) * 1e3)  # ms
        return False
