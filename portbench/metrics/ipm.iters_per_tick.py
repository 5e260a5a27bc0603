"""Newton iteration, ticks: the slowest lane's iterations
(``IPMResult.iters.max()``), averaged over the window's ticks."""


def read(run):
    solves = run.records.get("solves")
    return sum(i for _, i in solves) / len(solves) if solves else None
