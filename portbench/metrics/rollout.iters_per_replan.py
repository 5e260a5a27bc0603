"""Rollout layer: the rollout's host-loop iterations (``profile=``,
summed over every rung of every step of the window) per world-step
replanned."""


def read(run):
    r = run.records
    if "rung_profile" not in r or not r.get("replans"):
        return None
    return sum(it for step in r["rung_profile"] for _, it, _ in step.values()) / r["replans"]
