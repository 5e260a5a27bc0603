"""Experiment driver (the reference's ``simulation`` class,
src/simulation.py): the open-loop pipeline (``run``, :20-62), the
closed-loop runtime (``run_closed_loop``, :64-112), the A* front-end alone
(``run_astar``, :114-123), the A*-vs-MPC comparison
(``show_performance``, :125-208) and the wall-clock benchmark
(``calc_time``, :210-231).

PyTorch counterpart of the JAX package's ``runtime/simulation.py``.
Tensors go to the card unless ``device`` says otherwise. The plots
(``gif_path``, ``plot_path``, ``out_prefix``) come from :mod:`..viz`,
imported inside the methods that draw, so the solver path never imports
matplotlib.
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

    def run(self, demo_name: str, N: int = 50, gif_path: str | None = None, **kw):
        """The open-loop two-phase pipeline (:func:`.open_loop.run_open_loop`);
        ``gif_path`` writes its animation there."""
        res = run_open_loop(demo_name, N=N, dtype=self.dtype, device=self.device, **kw)
        if gif_path:
            from ..viz import animate_open_loop

            animate_open_loop(get_demo(demo_name), res, gif_path)
        return res

    def run_closed_loop(self, demo_name: str, max_steps: int = 30, legacy=None,
                        verbose: bool = False, gif_path=None, **kw):
        """The closed loop (:class:`.closed_loop.ClosedLoopRunner`);
        ``legacy`` "mpc1" or "mpc3" runs the legacy drivers
        (src/closed_loop.py:142-321) instead of the live mpc4; ``kw`` goes
        to the runner; ``gif_path`` writes the animation there."""
        runner = ClosedLoopRunner(get_demo(demo_name), dtype=self.dtype,
                                  max_steps=max_steps, device=self.device, **kw)
        res = (runner.run_legacy(mode=legacy, verbose=verbose) if legacy
               else runner.run(verbose=verbose))
        if gif_path:
            from ..viz import animate_closed_loop

            animate_closed_loop(get_demo(demo_name), res, gif_path)
        return res

    def show_performance(self, demo_name: str, N_open: int = 50, N_closed=None,
                         max_steps: int = 30, out_prefix=None):
        """The A* path, the open loop at ``N_open`` and the closed loop (at
        ``N_closed`` when given) of one demo, as the records the reference
        plots (src/simulation.py:125-208; its own entry is broken,
        closed_loop_mpc4's return being commented out). Returns the
        records dict; ``out_prefix`` writes ``{prefix}_states.png``,
        ``{prefix}_inputs.png`` and ``{prefix}_paths.png``."""
        demo = get_demo(demo_name)
        ref = self.run_astar(demo_name)
        open_res = self.run(demo_name, N=N_open)
        p = demo.params
        if N_closed is not None:
            p = dataclasses.replace(p, N_free=N_closed, N_fix=N_closed)
        closed = self.run_closed_loop(demo_name, max_steps=max_steps, params=p)
        have = bool(closed.steps)
        records = {
            "A*": {"x": ref},
            "open-loop": {"x": open_res.x, "u": open_res.u, "Ts": open_res.Ts_opt},
            "closed-loop": {"x": closed.x_history.T if have else None,
                            "u": closed.u_history.T if have else None,
                            "Ts": closed.ts_history if have else None},
        }
        if out_prefix:
            from ..viz import plot_comparison, plot_states_inputs

            scn, _ = build_scenario(demo, dtype=self.dtype, device="cpu")
            plot_states_inputs(records, out_prefix)
            trajs = {k: v["x"] for k, v in records.items()
                     if k != "A*" and v.get("x") is not None}
            plot_comparison(demo, ref_path=ref, trajs=trajs, grid=scn.grid.numpy(),
                            out_path=f"{out_prefix}_paths.png")
        return records

    def run_astar(self, demo_name: str, plot_path: str | None = None,
                  native: bool = False):
        """The A* reference path (3, L) of a demo; ``native=True`` runs the
        C++ search (:mod:`..native`); ``plot_path`` writes the path over the
        world there."""
        demo = get_demo(demo_name)
        scn, _ = build_scenario(demo, dtype=self.dtype, device="cpu")
        grid = scn.grid.numpy()
        ref = astar_host.reference_path_for(grid, demo.start, demo.goal, native=native)
        if plot_path:
            from ..viz import plot_comparison

            plot_comparison(demo, ref_path=ref, grid=grid, out_path=plot_path)
        return ref

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
