"""The port's plots (viz/) on the CPU: ``car_outline`` and
``dyn_obstacle_outline`` equal the JAX package's on the same inputs;
tests/test_viz.py's PNG and GIF cases with the port's ``StepRecord`` /
``ClosedLoopResult``; ``Simulation.run(gif_path=)``,
``run_closed_loop(gif_path=)``, ``run_astar(plot_path=)``,
``show_performance(out_prefix=)`` and the CLI's ``perf`` mode, ``--gif``
and ``--out-prefix`` write their files (demo2, N = 6, one closed-loop
step; the open loop is solved once and reused). Skipped where matplotlib
is absent, except two checks that hold there too: the solver path never
imports matplotlib, and ``viz`` raises an ImportError naming it."""

import importlib
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime import (
    ClosedLoopResult, Simulation, StepRecord, simulation,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
    get_demo,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch"

needs_mpl = pytest.mark.skipif(importlib.util.find_spec("matplotlib") is None,
                               reason="matplotlib is not installed")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _viz():
    return importlib.import_module(PORT + ".viz")


def _jax_viz():
    return importlib.import_module(
        "vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.viz")


def _written(path):
    assert os.path.getsize(path) > 1000, path


@needs_mpl
@pytest.mark.parametrize("x", [[0.0, 0.0, 0.0], [5.0, 5.0, np.pi / 2], [3.2, -1.5, -2.4]])
@pytest.mark.parametrize("ego", [(1.7, 0.75, 1.2, 0.75), (2.0, 1.0, 2.0, 1.0)])
def test_car_outline_matches_jax(x, ego):
    want = _jax_viz().car_outline(np.asarray(x), ego)
    np.testing.assert_array_equal(_viz().car_outline(np.asarray(x), ego), want)
    np.testing.assert_array_equal(
        _viz().car_outline(torch.tensor(x, dtype=torch.float64), ego), want)


@needs_mpl
@pytest.mark.parametrize("row", [(0.0, 0.0, 0.0, 4.0, 2.0, 0.5), (12.0, 3.0, 0.7, 4.5, 1.8, -1.0)])
@pytest.mark.parametrize("pos", [None, (10.0, 3.0)])
def test_dyn_obstacle_outline_matches_jax(row, pos):
    np.testing.assert_array_equal(_viz().dyn_obstacle_outline(row, pos),
                                  _jax_viz().dyn_obstacle_outline(row, pos))


@needs_mpl
def test_plot_comparison_writes_png(tmp_path):
    tr = torch.stack([torch.linspace(3, 38, 20), torch.full((20,), 4.0), torch.zeros(20)])
    out = str(tmp_path / "cmp.png")
    assert _viz().plot_comparison(get_demo("demo1"), ref_path=tr.numpy(), trajs={"mpc": tr},
                                  grid=torch.zeros(10, 40), out_path=out) == out
    _written(out)


@needs_mpl
def test_animate_closed_loop_writes_gif(tmp_path):
    demo = get_demo("demo1")
    plan = np.stack([np.linspace(3, 6, 7), np.full(7, 4.0), np.zeros(7)]).T
    steps = [StepRecord(k=k, fixtime=bool(k), feas=True, fallback=False,
                        x=np.array([3.0 + k, 4.0, 0.0]), u=np.array([0.5, 0.0]), Ts_opt=0.5,
                        x_open_loop=plan, iters=10, kkt_err=1e-6,
                        dyn_vertices=[(np.array([[20.0, 1.0], [21, 1], [21, 2], [20, 2]]),
                                       bool(k))])
             for k in range(2)]
    res = ClosedLoopResult(demo="demo1", reached_goal=False, aborted_infeasible=False,
                           steps=steps, x_ref=plan.T)
    out = str(tmp_path / "cl.gif")
    assert _viz().animate_closed_loop(demo, res, out, fps=2) == out
    _written(out)


@pytest.fixture(scope="module")
def open_loop(tmp_path_factory):
    """demo2's open loop at N = 6 through ``Simulation.run(gif_path=)``,
    solved once; the other tests reuse its result."""
    if importlib.util.find_spec("matplotlib") is None:
        pytest.skip("matplotlib is not installed")
    gif = str(tmp_path_factory.mktemp("open") / "open.gif")
    res = Simulation(device="cpu").run("demo2", N=6, gif_path=gif)
    return res, gif


@needs_mpl
def test_simulation_run_writes_gif(open_loop):
    res, gif = open_loop
    assert res.feas and res.x.shape == (3, 7)
    _written(gif)


@needs_mpl
def test_simulation_plots(tmp_path, open_loop, monkeypatch):
    sim = Simulation(device="cpu")
    png = str(tmp_path / "astar.png")
    ref = sim.run_astar("demo2", plot_path=png, native=True)
    assert ref.shape[0] == 3
    _written(png)
    gif = str(tmp_path / "closed.gif")
    res = sim.run_closed_loop("demo2", max_steps=1, gif_path=gif)
    assert len(res.steps) == 1
    _written(gif)
    monkeypatch.setattr(simulation, "run_open_loop", lambda *a, **k: open_loop[0])
    prefix = str(tmp_path / "perf")
    recs = sim.show_performance("demo2", N_open=6, max_steps=1, out_prefix=prefix)
    assert recs["closed-loop"]["x"].shape == (3, 1)
    for part in ("states", "inputs", "paths"):
        _written(f"{prefix}_{part}.png")


@needs_mpl
def test_cli_plots(tmp_path, open_loop, monkeypatch, capsys):
    cli = importlib.import_module(PORT + ".__main__")
    monkeypatch.setattr(simulation, "run_open_loop", lambda *a, **k: open_loop[0])
    monkeypatch.setattr(cli, "run_open_loop", lambda *a, **k: open_loop[0])
    base = ["--demo", "demo2", "--device", "cpu", "-q"]
    prefix = str(tmp_path / "cli")
    assert cli.main(base + ["--mode", "perf", "--N", "6", "--max-steps", "1",
                            "--out-prefix", prefix]) == 0
    for part in ("states", "inputs", "paths"):
        _written(f"{prefix}_{part}.png")
    gif = str(tmp_path / "cli_open.gif")
    assert cli.main(base + ["--mode", "open", "--N", "6", "--gif", gif]) == 0
    _written(gif)
    gif = str(tmp_path / "cli_closed.gif")
    assert cli.main(base + ["--max-steps", "1", "--gif", gif]) == 0
    _written(gif)
    assert "wrote " + gif in capsys.readouterr().out


def _run(code):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)


def test_solver_path_never_imports_matplotlib():
    out = _run(f"import sys\nimport {PORT}.entry, {PORT}.runtime, {PORT}.solver, "
               f"{PORT}.utils, {PORT}.native\n"
               "print(sorted(m for m in sys.modules if m.startswith('matplotlib')))")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_viz_without_matplotlib_raises_naming_it():
    out = _run("import sys\nsys.modules['matplotlib'] = None\n"
               f"from {PORT}.runtime import Simulation\n"
               "try:\n"
               f"    import {PORT}.viz\n"
               "except ImportError as e:\n"
               "    print('ImportError:', e)\n"
               "try:\n"
               "    Simulation(device='cpu').run_astar('demo1', plot_path='x.png')\n"
               "except ImportError as e:\n"
               "    print('ImportError:', e)\n")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 2 and all(l.startswith("ImportError:") and "matplotlib" in l
                                   for l in lines), lines
