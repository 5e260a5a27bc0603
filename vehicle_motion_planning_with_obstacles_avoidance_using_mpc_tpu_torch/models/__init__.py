"""The OBCA NLP: batched residuals, data builder and analytic KKT provider."""

from .obca import (
    OBCAData,
    OBCASpec,
    eq_constraints,
    hessian_spine_probes,
    ineq_constraints,
    ineq_constraints_dense,
    init_vars,
    objective,
    ravel_z,
    signed_clearance,
    unravel_z,
)
from .builder import build_obca_data

__all__ = [
    "OBCAData", "OBCASpec", "eq_constraints", "hessian_spine_probes",
    "ineq_constraints", "ineq_constraints_dense", "init_vars", "objective",
    "ravel_z", "signed_clearance", "unravel_z", "build_obca_data",
]
