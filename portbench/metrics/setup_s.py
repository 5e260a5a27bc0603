"""End to end, every cell: seconds from the process's start to the
window's (imports, CUDA init, the kernels' build or load, the inputs,
the warm-up), on the host clock."""


def read(run):
    return run.records.get("setup_s")
