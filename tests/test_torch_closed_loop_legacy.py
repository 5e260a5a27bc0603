"""The port's legacy closed-loop drivers (``run_legacy("mpc1" | "mpc3")``)
against the JAX package's runner run live on demo1 (3 steps, CPU,
float64, states within 1e-9; the cases of tests/test_closed_loop.py), and
the port's entry points for the host driver: the CLI's ``closed`` (the
default), ``legacy1`` and ``legacy3`` modes, ``Simulation.run_closed_loop``
and ``run_closed_loop``."""

import importlib.util

import numpy as np
import pytest
import torch

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.runtime import (
    ClosedLoopRunner as JaxRunner,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.scenarios import (
    get_demo as jax_demo,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.__main__ import (
    main,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime import (
    ClosedLoopRunner, Simulation, run_closed_loop,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
    get_demo,
)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the batches are a few lanes, and the suite runs
    several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def jax_runner():
    """One JAX runner for both modes, so its free-time solver compiles once."""
    return JaxRunner(jax_demo("demo1"), max_steps=3)


@pytest.mark.parametrize("mode", ["mpc1", "mpc3"])
def test_legacy_matches_jax(jax_runner, mode):
    ref = jax_runner.run_legacy(mode=mode)
    res = ClosedLoopRunner(get_demo("demo1"), max_steps=3, device="cpu").run_legacy(mode=mode)
    assert not res.aborted_infeasible and len(res.steps) == 3
    assert not any(s.fixtime for s in res.steps)
    assert res.x_history[-1][0] > res.x_history[0][0]
    np.testing.assert_allclose(res.x_history, ref.x_history, rtol=0, atol=1e-9)
    np.testing.assert_allclose(res.u_history, ref.u_history, rtol=0, atol=1e-9)
    np.testing.assert_allclose(res.ts_history, ref.ts_history, rtol=0, atol=1e-9)
    assert [s.iters for s in res.steps] == [s.iters for s in ref.steps]


@pytest.mark.parametrize("mode", ["closed", "legacy1", "legacy3"])
def test_cli_modes(mode, capsys):
    argv = ["--demo", "demo1", "--max-steps", "1", "--device", "cpu", "-q"]
    if mode != "closed":
        argv += ["--mode", mode]
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "demo1: reached_goal=False aborted=False steps=1" in out


def test_simulation_entries(tmp_path):
    sim = Simulation(dtype=torch.float64, device="cpu")
    gif = tmp_path / "out.gif"
    a = sim.run_closed_loop("demo1", max_steps=1,
                            gif_path=str(gif) if importlib.util.find_spec("matplotlib") else None)
    b = run_closed_loop("demo1", max_steps=1, device="cpu")
    assert len(a.steps) == 1 and not a.aborted_infeasible
    np.testing.assert_array_equal(a.x_history, b.x_history)
    # the plots are ported (viz/; tests/test_torch_viz.py): the GIF is written
    assert gif.exists() or not importlib.util.find_spec("matplotlib")
    with pytest.raises(ValueError):
        ClosedLoopRunner(get_demo("demo1"), device="cpu").run_legacy(mode="mpc2")
