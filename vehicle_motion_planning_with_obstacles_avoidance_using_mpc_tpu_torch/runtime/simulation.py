"""Experiment driver (the reference's ``simulation`` class,
src/simulation.py): the open-loop pipeline (``run``, :20-62), the
closed-loop runtime (``run_closed_loop``, :64-112), the A* front-end alone
(``run_astar``, :114-123), the A*-vs-MPC comparison
(``show_performance``, :125-208) and the wall-clock benchmark
(``calc_time``, :210-231).

PyTorch counterpart of the JAX package's ``runtime/simulation.py``. The
plots (``gif_path``, ``out_prefix``) wait for the port of ``viz/``
(ROADMAP.md queue 1) and raise. Tensors go to the card unless ``device``
says otherwise.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import torch

from ..scenarios import build_scenario, get_demo
from . import astar_host
from .closed_loop import ClosedLoopRunner
from .open_loop import run_open_loop


@dataclass
class TimingReport:
    """``calc_time`` result (reference prints, src/simulation.py:219-231).
    ``extras`` carries the reference's published numbers on its author's
    CPU (A* 0.0240 s on demo9, the open loop at N = 10 3.69 s)."""

    demo: str
    astar_s: float
    open_loop_s: float
    open_loop_N: int
    open_loop_feas: bool
    extras: dict = field(default_factory=dict)


class Simulation:
    """Mirror of the reference's ``simulation`` driver
    (src/simulation.py:18): construct once, call any entry with a demo
    name (demo1..demo11)."""

    def __init__(self, dtype=torch.float64, device=torch.device("cuda")):
        self.dtype = dtype
        self.device = device

    def run(self, demo_name: str, N: int = 50, **kw):
        """The open-loop two-phase pipeline (:func:`.open_loop.run_open_loop`)."""
        return run_open_loop(demo_name, N=N, dtype=self.dtype, device=self.device, **kw)

    def run_closed_loop(self, demo_name: str, max_steps: int = 30, legacy=None,
                        verbose: bool = False, gif_path=None, **kw):
        """The closed loop (:class:`.closed_loop.ClosedLoopRunner`);
        ``legacy`` "mpc1" or "mpc3" runs the legacy drivers
        (src/closed_loop.py:142-321) instead of the live mpc4; ``kw`` goes
        to the runner."""
        _no_plots(gif_path)
        runner = ClosedLoopRunner(get_demo(demo_name), dtype=self.dtype,
                                  max_steps=max_steps, device=self.device, **kw)
        return (runner.run_legacy(mode=legacy, verbose=verbose) if legacy
                else runner.run(verbose=verbose))

    def show_performance(self, demo_name: str, N_open: int = 50, N_closed=None,
                         max_steps: int = 30, out_prefix=None):
        """The A* path, the open loop at ``N_open`` and the closed loop (at
        ``N_closed`` when given) of one demo, as the records the reference
        plots (src/simulation.py:125-208; its own entry is broken,
        closed_loop_mpc4's return being commented out). Returns the
        records dict; the plots (``out_prefix``) raise."""
        _no_plots(out_prefix)
        demo = get_demo(demo_name)
        ref = self.run_astar(demo_name)
        open_res = self.run(demo_name, N=N_open)
        p = demo.params
        if N_closed is not None:
            p = dataclasses.replace(p, N_free=N_closed, N_fix=N_closed)
        closed = self.run_closed_loop(demo_name, max_steps=max_steps, params=p)
        have = bool(closed.steps)
        return {
            "A*": {"x": ref},
            "open-loop": {"x": open_res.x, "u": open_res.u, "Ts": open_res.Ts_opt},
            "closed-loop": {"x": closed.x_history.T if have else None,
                            "u": closed.u_history.T if have else None,
                            "Ts": closed.ts_history if have else None},
        }

    def run_astar(self, demo_name: str, native: bool = False):
        """The A* reference path (3, L) of a demo (``native=True``
        raises: the C++ search is not ported)."""
        demo = get_demo(demo_name)
        scn, _ = build_scenario(demo, dtype=self.dtype, device="cpu")
        return astar_host.reference_path_for(scn.grid.numpy(), demo.start, demo.goal,
                                             native=native)

    def calc_time(self, demo_name: str = "demo9", N: int = 10,
                  native_astar: bool = False) -> TimingReport:
        """Wall-clock seconds of the A* front-end and of the open-loop
        pipeline at horizon N (host clock; a run on the card ends in a
        synchronize)."""
        demo = get_demo(demo_name)
        scn, _ = build_scenario(demo, dtype=self.dtype, device="cpu")
        grid = scn.grid.numpy()

        t0 = time.perf_counter()
        astar_host.reference_path_for(grid, demo.start, demo.goal, native=native_astar)
        astar_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        res = run_open_loop(demo_name, N=N, dtype=self.dtype, device=self.device)
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
        open_s = time.perf_counter() - t0

        return TimingReport(
            demo=demo_name, astar_s=astar_s, open_loop_s=open_s, open_loop_N=N,
            open_loop_feas=res.feas,
            extras={"reference_astar_s": 0.0240, "reference_open_loop_N10_s": 3.69})


def _no_plots(path):
    if path:
        raise NotImplementedError(
            "plots need the port of viz/ (ROADMAP.md queue 1, the viz item)")
