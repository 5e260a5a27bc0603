"""End to end: the window's time over the plans it completed (each plan
built and solved, one after another)."""


def read(run):
    plans = run.records.get("plans")
    return 1e3 * run.window_s / len(plans) if plans else None
