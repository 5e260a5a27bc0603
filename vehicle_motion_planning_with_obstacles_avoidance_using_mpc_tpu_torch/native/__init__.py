"""Native (C++) host components: the grid A* of ``astar.cpp``, built with
g++ on first use (:mod:`.build`) and called through ``ctypes``. It gives
optimal paths of the same cost as the reference-exact Python search
(:mod:`..runtime.astar_host`), possibly another among equal-cost ones."""

from .astar_native import astar_solve_batch_native, astar_solve_native
from .build import load_native_astar

__all__ = ["astar_solve_batch_native", "astar_solve_native", "load_native_astar"]
