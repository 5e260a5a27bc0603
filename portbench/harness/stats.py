"""The quantile the benchmark reports, frozen: a copy of the port's
``utils/metrics.py`` ``MetricsLogger.quantiles`` arithmetic (sorted
values, the value at index ``min(int(q n), n - 1)``), kept here so that a
change to the port cannot move the yardstick."""

from __future__ import annotations


def quantile(values, q: float):
    """The q-quantile of ``values`` (all of them; None when empty)."""
    xs = sorted(values)
    if not xs:
        return None
    return xs[min(int(q * len(xs)), len(xs) - 1)]
