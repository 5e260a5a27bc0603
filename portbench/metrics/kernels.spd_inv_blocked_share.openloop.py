"""Kernels, open loop: the device time of ``spd_inv_blocked``'s kernels
(``spdb_*``) over the device's busy time in the traced plans, in %."""


def read(run):
    tr = run.tracer.result if run.tracer else None
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * tr.device_time(lambda n: "spdb_" in n) / tr.busy_s
