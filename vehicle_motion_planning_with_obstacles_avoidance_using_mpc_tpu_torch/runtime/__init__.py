"""Host A* front-end and reference windowing."""

from . import astar_host, reference

__all__ = ["astar_host", "reference"]
