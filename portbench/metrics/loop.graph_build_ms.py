"""Solver loop: host milliseconds spent building CUDA graphs inside the
window (``solver/loop.py`` ``stats["build_ms"]``: eager run, captures,
instantiation)."""


def read(run):
    return run.records.get("graph_build_ms")
