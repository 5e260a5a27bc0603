"""Host A* front-end, reference windowing, multistart and the closed-loop
rollout over a batch of worlds."""

from . import astar_host, multistart, reference, scan_loop
from .scan_loop import LoopState, make_scan_rollout

__all__ = ["astar_host", "multistart", "reference", "scan_loop", "LoopState",
           "make_scan_rollout"]
