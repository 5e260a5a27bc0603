"""Observability and durability utilities: structured metrics with latency
quantiles, checkpoint / resume of array trees for long sweeps, and
profiler annotations, traces and wall timing."""

from .checkpoint import SweepCheckpointer, load_pytree, save_pytree
from .metrics import MetricsLogger
from .profiling import annotate, device_trace, wall_timer

__all__ = ["MetricsLogger", "SweepCheckpointer", "annotate", "device_trace", "load_pytree",
           "save_pytree", "wall_timer"]
