"""The open-loop cell's sound run, its TF32 control and a planted fault,
on the CPU at a short horizon with the port's plain kernels.

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


def test_openloop_sound_run_control_and_fault():
    seen = {}

    def capture(kind):
        check = kind.check

        def keep(run, st):
            seen.update(run=run, st=st, check=check)
            return check(run, st)

        kind.check = keep

    out, _ = cpu_run("demo9.openloop_n74", seconds=0.1, config=OPEN, manifest=MANIFEST,
                     patch=capture)
    assert out["correct"], out["checks"]
    run = seen["run"]
    run.control = "tf32"       # the control, on the same plans
    assert {"viol_gap", "obj_gap", "feas_viol"} <= set(failed(seen["check"](run, seen["st"])))

    def change(st):
        ms = st["msolve"]

        def wrong(data, cands):
            res, best = ms(data, cands)
            z = dict(res.z)
            z["u"] = z["u"].clone() + 0.01
            return res._replace(z=z), best

        wrong.last = ms.last
        st["msolve"] = wrong
    out, _ = cpu_run("demo9.openloop_n74", seconds=0.1, config=OPEN, manifest=MANIFEST,
                     patch=lambda kind: wrap_setup(kind, change))
    assert not out["correct"], out["checks"]

