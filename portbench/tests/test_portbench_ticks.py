"""The tick cell's sound run, its TF32 control and planted faults, on the
CPU at a toy size with the port's plain kernels; a short run on the card.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

import pytest

from portbench.tests.cpu import cpu_run, failed, one_torch_thread, wrap_setup  # noqa: E402,F401

TICKS = {"robots": 6, "check_every": 1}


def test_ticks_sound_run_and_tf32_control():
    out, checks = cpu_run("demo9.tick1024", seconds=0.3, traffic=TICKS)
    assert out["correct"], out["checks"]
    assert {n for n, _, _ in checks} == {"viol_gap", "obj_gap", "feas_viol", "feas_stat",
                                         "infeas_share"}
    _, ctl = cpu_run("demo9.tick1024", seconds=0.3, traffic=TICKS, control="tf32")
    assert {"viol_gap", "obj_gap", "feas_viol"} <= set(failed(ctl))


def _ticks_fault(alter):
    def change(st):
        solve = st["solve"]

        def wrong(data):
            res = solve(data)
            return alter(res)

        st["solve"] = wrong
    return lambda kind: wrap_setup(kind, change)


def test_ticks_faults_fail():
    def half(res):   # half of the robots left out: the others' plans in their place
        B = res.z["x"].shape[0]
        h = B // 2
        z = {k: v.clone() for k, v in res.z.items()}
        for k in z:
            z[k][h:] = z[k][:B - h]
        return res._replace(z=z, viol=res.viol.clone().index_copy_(
            0, __import__("torch").arange(h, B), res.viol[:B - h]))

    def altered(res):   # an answer altered where it is produced
        z = dict(res.z)
        z["x"] = z["x"].clone()
        z["x"][0, 1, 3] += 0.05
        return res._replace(z=z)

    for fault in (half, altered):
        out, checks = cpu_run("demo9.tick1024", seconds=0.3, traffic=TICKS,
                              patch=_ticks_fault(fault))
        assert not out["correct"], (fault.__name__, out["checks"])


def unchanged(st, solve):
    """A state left unchanged: the solve returns its start (no Newton
    step), reported honestly."""
    import dataclasses

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
        make_obca_solver)

    return make_obca_solver(st["spec"], dataclasses.replace(st["opt"], max_iters=0),
                            impl="plain")


def objective_left_out(st, solve):
    """The solve optimizes no objective (its weights at 0: a feasible plan,
    not an optimal one) but reports the stated objective of its plan."""
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import obca

    def wrong(data):
        zero = {k: getattr(data, k) * 0 for k in ("Q", "R1", "R2", "P", "time_c1", "time_c2")}
        res = solve(data._replace(**zero))
        return res._replace(f=obca.objective(st["spec"], data, res.z))

    return wrong


def test_a_plan_left_at_its_start_or_not_optimized_fails():
    for fault, number in ((unchanged, "infeas_share"), (objective_left_out, "feas_stat")):
        def patch(kind):
            wrap_setup(kind, lambda st: st.update(solve=fault(st, st["solve"])))
        out, checks = cpu_run("demo9.tick1024", seconds=0.3, traffic=TICKS, patch=patch)
        assert failed(checks) == [number], (fault.__name__, out["checks"])



@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    import json
    import subprocess

    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "demo9.tick1024",
                        "--seed", "2147483659", "--seconds", "2", "--trace", "1"],
                       capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
