"""Kernels, ticks: ``newton_al_solve``'s share of its roofline, in %.

The work is what the traced ticks' inputs need: the sum over lanes of
each lane's own iterations (``IPMResult.iters``), times the frozen
operations and bytes of one lane-iteration of the AL solve at the
configuration's shape (``configs/<name>.json``
``al_solve_per_lane_iteration``). The least time is max(bytes / peak
bandwidth, operations / peak float32 rate) (``harness/peaks.py``), over
the device time the trace gives the ``newton_al_solve`` kernels."""

from portbench.harness.peaks import bound_s


def read(run):
    tr = run.tracer.result if run.tracer else None
    traced = run.records.get("traced_lane_iters")
    if tr is None or not traced:
        return None
    t = tr.device_time(lambda n: "newton_al_solve" in n)
    if t <= 0:
        return None
    c = run.cfg["al_solve_per_lane_iteration"]
    least, _ = bound_s(traced * c["bytes"], traced * c["flops"], c["shape"]["dtype"])
    return 100.0 * least / t
