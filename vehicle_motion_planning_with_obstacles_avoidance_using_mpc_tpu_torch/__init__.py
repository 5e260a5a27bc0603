"""PyTorch port of the A* + time-optimal OBCA motion-planning engine.

The JAX package beside it
(``vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu``) is
the reference; this package mirrors its subpackages and module names
(``scenarios/``, ``ops/``, ``models/``, ``solver/``, ``runtime/``) and adds
``kernels/``: the CUDA C++ sources of the solver's hot loops, written for
Hopper (``sm_90a``), each beside a plain PyTorch version of the same
function. Every function takes a leading lane dimension B (one solve is
B = 1). This package imports torch and never jax.
"""

__version__ = "0.1.0"
