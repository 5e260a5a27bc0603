"""The open-loop cell's faults that a window of plans can have: a plan
left at its start, and one made feasible but not optimal; on the CPU at a
short horizon with the port's plain kernels.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from portbench.tests.cpu import cpu_run, failed, one_torch_thread, parked, wrap_setup  # noqa: E402,F401

from portbench.harness import core  # noqa: E402

# a short horizon: its plans settle within 60 iterations (the cap only stops
# the candidate that never converges sooner)
OPEN = {"openloop": {"N": 6, "options": {**core.load_json("configs", "demo9.json")["openloop"][
    "options"], "max_iters": 60}}}
# the cell is parked: its float32 solve fails one start (PERF.md, Open questions)
MANIFEST = parked("demo9.openloop_n74")


def _msolve_fault(make):
    def change(st):
        st["msolve"] = make(st, st["msolve"])
    return lambda kind: wrap_setup(kind, change)


def unchanged(st, ms):
    """A state left unchanged: the multistart returns its start."""
    import dataclasses

    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
        make_openloop_solve)
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
        OBCASpec)

    spec = OBCASpec(N=st["N"], n_obs=st["shape"].n_obs, e_max=st["shape"].e_max, variant="free")
    return make_openloop_solve(spec, dataclasses.replace(st["opt"], max_iters=0), impl="plain")


def objective_left_out(st, ms):
    """The multistart optimizes no objective but reports the stated one."""
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
        OBCASpec, obca)

    spec = OBCASpec(N=st["N"], n_obs=st["shape"].n_obs, e_max=st["shape"].e_max, variant="free")

    def wrong(data, cands):
        zero = {k: getattr(data, k) * 0 for k in ("Q", "R1", "R2", "P", "time_c1", "time_c2")}
        res, best = ms(data._replace(**zero), cands)
        return res._replace(f=obca.objective(spec, data, res.z)), best

    wrong.last = ms.last
    return wrong


def test_openloop_plan_left_at_its_start_or_not_optimized_fails():
    for fault, number in ((unchanged, "infeas_share"), (objective_left_out, "feas_stat")):
        out, checks = cpu_run("demo9.openloop_n74", seconds=0.1, config=OPEN, manifest=MANIFEST,
                              patch=_msolve_fault(fault))
        assert number in failed(checks), (fault.__name__, out["checks"])
