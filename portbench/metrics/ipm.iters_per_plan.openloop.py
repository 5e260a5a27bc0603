"""Newton iteration, open loop: the multistart's iterations
(``msolve.last["iters"]``), averaged over the window's plans: the ticks'
reading (``ipm.iters_per_tick``) over the plans' solves."""

from portbench.harness.core import reader

read = reader("ipm.iters_per_tick").read
