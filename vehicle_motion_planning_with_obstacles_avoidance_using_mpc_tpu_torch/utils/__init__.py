"""Observability and durability utilities: structured metrics with latency
quantiles, and checkpoint / resume of array trees for long sweeps. The
JAX package's profiler annotations are not ported yet (ROADMAP.md queue
1)."""

from .checkpoint import SweepCheckpointer, load_pytree, save_pytree
from .metrics import MetricsLogger

__all__ = ["MetricsLogger", "SweepCheckpointer", "load_pytree", "save_pytree"]
