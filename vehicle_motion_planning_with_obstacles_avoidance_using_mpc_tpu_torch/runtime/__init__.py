"""Host A* front-end, reference windowing and multistart."""

from . import astar_host, multistart, reference

__all__ = ["astar_host", "multistart", "reference"]
