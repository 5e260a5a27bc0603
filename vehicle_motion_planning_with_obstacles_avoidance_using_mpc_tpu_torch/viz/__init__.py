"""Visualization: host-side matplotlib parity with the reference's
``src/draw.py``. Optional: the solver path never imports it."""

from .plotting import (animate_closed_loop, animate_open_loop, car_outline,
                       dyn_obstacle_outline, plot_comparison, plot_states_inputs, plot_world)

__all__ = ["animate_closed_loop", "animate_open_loop", "car_outline", "dyn_obstacle_outline",
           "plot_comparison", "plot_states_inputs", "plot_world"]
