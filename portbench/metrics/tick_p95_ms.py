"""End to end: the 95th percentile of every tick of the window, from the
drawing of the tick's inputs until its plans are on the host."""

from portbench.harness.stats import quantile


def read(run):
    ticks = run.records.get("ticks")
    return quantile([t["ms"] for t in ticks], 0.95) if ticks else None
