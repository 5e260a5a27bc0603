"""The port's host closed-loop driver (runtime/closed_loop.py) on the CPU in
float64 against the goldens the JAX package's runner recorded
(scripts/run_demos.py): demo1 over 3 steps (free time), demo3 over 12
(free time, the fix-time branch from k = 3 and its first mpc8 fallback at
k = 11) and demo6 over 3 (the fix-time branch from k = 1). States and step
durations within 1e-6 (tests/test_demos_e2e.py's tolerance), mode and
fallback flags equal. Also the runner's metrics (the cases of
tests/test_closed_loop.py), ``record_problems``, and the port's
``MetricsLogger`` against the JAX package's on the same series."""

import json
import os

import numpy as np
import pytest
import torch

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.utils.metrics import (
    MetricsLogger as JaxMetricsLogger,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
    OBCAData,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime import (
    ClosedLoopRunner,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
    get_demo,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
    IPMResult,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.utils import (
    MetricsLogger,
)

STEPS = {"demo1": 3, "demo3": 12, "demo6": 3}
GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "goldens")

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the batches are a few lanes, and the suite runs
    several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def runs():
    out = {}
    for name, n in STEPS.items():
        runner = ClosedLoopRunner(get_demo(name), max_steps=n, device="cpu",
                                  record_problems=name == "demo1")
        out[name] = (runner, runner.run())
    return out


@pytest.mark.parametrize("name", list(STEPS))
def test_runner_matches_golden(runs, name):
    n = STEPS[name]
    g = np.load(os.path.join(GOLDENS, f"{name}.npz"))
    _, res = runs[name]
    assert not res.aborted_infeasible and len(res.steps) == n
    np.testing.assert_allclose(res.x_history, g["x"][:n], rtol=0, atol=1e-6)
    np.testing.assert_allclose(res.u_history, g["u"][:n], rtol=0, atol=1e-6)
    np.testing.assert_allclose(res.ts_history, g["ts"][:n], rtol=0, atol=1e-6)
    assert [s.fixtime for s in res.steps] == g["fixtime"][:n].tolist()
    assert [s.fallback for s in res.steps] == g["fallback"][:n].tolist()
    np.testing.assert_array_equal(res.x_ref, g["ref"])


def test_branches_covered(runs):
    """demo3's 12 steps reach the free branch, the fix branch and the
    fallback; demo6 switches to fix time at k = 1."""
    modes = [(s.fixtime, s.fallback) for s in runs["demo3"][1].steps]
    assert (False, False) in modes and (True, False) in modes and (True, True) in modes
    assert [s.fixtime for s in runs["demo6"][1].steps] == [True] * 3
    counters = runs["demo3"][0].metrics.counters
    assert counters["fixtime_steps"] == 9 and counters["fallbacks"] == 1


def test_runner_metrics(runs):
    """tests/test_closed_loop.py:30-36 on the port's runner."""
    runner, res = runs["demo1"]
    m = runner.metrics
    assert m.counters["replans"] == 3
    assert m.counters["freetime_steps"] == 3
    assert len(m.series["replan_ms"]) == 3
    q = m.quantiles("replan_ms")
    assert q["p50"] is not None and q["p50"] > 0
    assert m.summary()["replan_ms"]["count"] == 3
    assert m.series["iters"] == [float(s.iters) for s in res.steps]
    assert len(m.series["prep_ms"]) == 3


def test_record_problems(runs):
    runner, res = runs["demo1"]
    assert len(runner.problems) == len(res.steps) == 3
    for k, rec in enumerate(runner.problems):
        assert rec["k"] == k and not rec["fixtime"]
        assert rec["spec"].variant == "free" and rec["spec"].N == 6
        assert isinstance(rec["data"], OBCAData) and rec["data"].x0.shape == (1, 3)
        assert isinstance(rec["res"], IPMResult)
        assert rec["x_init"].shape == (3, 7)
        np.testing.assert_array_equal(rec["x_init"][:, 0], rec["data"].x0[0].numpy())
        # the recorded result is the step's plan
        np.testing.assert_array_equal(rec["res"].z["x"][0].numpy()[:, 1], res.steps[k].x)
    assert not hasattr(runner, "last_failure")


def test_metrics_logger_matches_jax(tmp_path):
    rng = np.random.RandomState(7)
    series = rng.lognormal(size=37).tolist()
    port, ref = MetricsLogger(), JaxMetricsLogger()
    for m in (port, ref):
        for v in series:
            m.record("replan_ms", v)
        m.record("iters", 12)
        m.bump("replans", 37)
        m.bump("fallbacks")
        with m.timer("block"):
            pass
    for qs in ((0.5, 0.9, 0.99), (0.0, 0.25, 1.0)):
        assert port.quantiles("replan_ms", qs) == ref.quantiles("replan_ms", qs)
    assert port.quantiles("missing") == ref.quantiles("missing")
    sp, sr = port.summary(), ref.summary()
    assert sp.keys() == sr.keys()
    for key in ("replan_ms", "iters", "counters"):
        assert sp[key] == sr[key]
    assert sp["block"].keys() == sr["block"].keys()
    path = tmp_path / "m.jsonl"
    port.dump_jsonl(str(path))
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert len(lines) == 37 + 1 + 1 + 1 and "summary" in lines[-1]
    assert port.rate("replans") > 0
