"""A* front-end: the harness's span around the arrivals' batched
``plan_grid_path`` (ending in a synchronize), per world that arrived in
the window."""


def read(run):
    n = run.records.get("arrivals")
    if not n:
        return None
    return 1e3 * run.spans.get("pool.arrivals.astar", 0.0) / n
