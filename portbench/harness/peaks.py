"""Published peaks of one NVIDIA H100 SXM (the data sheet's dense rates)
and the roofline bound, frozen from the port's ``chip_smoke.py``
(``HBM_BYTES_PER_S``, ``PEAK_FLOPS``, ``bound``)."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
# float32 outside the tensor cores (the port keeps TF32 off)
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}


def bound_s(bytes_moved: float, flops: float, dtype: str = "float32") -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time the card could
    take to move ``bytes_moved`` and do ``flops`` operations."""
    t_b = bytes_moved / HBM_BYTES_PER_S
    t_f = flops / PEAK_FLOPS[dtype]
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")
