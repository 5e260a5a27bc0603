"""Host A* front-end, reference windowing, multistart, the host closed-loop
driver, the closed-loop rollout over a batch of worlds, and the open-loop
pipeline."""

from . import (astar_host, closed_loop, multistart, open_loop, reference, scan_loop,
               simulation)
from .closed_loop import ClosedLoopResult, ClosedLoopRunner, StepRecord, run_closed_loop
from .open_loop import OpenLoopResult, run_open_loop
from .scan_loop import LoopState, make_scan_rollout
from .simulation import Simulation, TimingReport

__all__ = ["astar_host", "closed_loop", "multistart", "open_loop", "reference",
           "scan_loop", "simulation", "ClosedLoopResult", "ClosedLoopRunner",
           "StepRecord", "run_closed_loop", "LoopState", "make_scan_rollout",
           "OpenLoopResult", "run_open_loop", "Simulation", "TimingReport"]
