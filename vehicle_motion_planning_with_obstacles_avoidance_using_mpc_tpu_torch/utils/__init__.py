"""Observability utilities: structured metrics with latency quantiles.
The JAX package's profiler annotations and checkpointing are not ported
yet (ROADMAP.md queue 1)."""

from .metrics import MetricsLogger

__all__ = ["MetricsLogger"]
