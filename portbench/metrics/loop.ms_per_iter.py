"""Solver loop: the window's solve time (each solve's span, launch to
plans read) over its Newton iterations (the slowest lane's: a tick's
``IPMResult.iters.max()``, a plan's ``msolve.last["iters"]``)."""


def read(run):
    solves = run.records.get("solves")
    if not solves:
        return None
    return 1e3 * sum(s for s, _ in solves) / max(sum(i for _, i in solves), 1)
