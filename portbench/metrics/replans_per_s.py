"""End to end: problems replanned per second of the whole window, on the
host clock: the kind's ``replans`` (pool: world-steps replanned, every
active world of every step; ticks: robots' window problems solved)."""


def read(run):
    n = run.records.get("replans")
    return n / run.window_s if n else None
