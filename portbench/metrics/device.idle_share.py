"""Device: 1 - (the union of the traced slice's kernel, copy and memset
intervals) / the slice's wall time, in %."""


def read(run):
    tr = run.tracer.result if run.tracer else None
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
