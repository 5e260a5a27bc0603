"""Independent NLP oracle: scipy trust-constr on the exact OBCA problems
the interior-point solver solves.

PyTorch counterpart of the JAX package's ``solver/oracle.py``: scipy's
trust-region interior point (``trust-constr``) over the port's model
functions with exact derivatives from ``torch.func`` (gradient and
Jacobians by reverse mode), in float64, from the same warm start. The
functions run on the device ``data`` lives on; scipy runs on the host.
Any recorded problem (``ClosedLoopRunner(record_problems=True)``) can be
handed to it.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, jacrev

from ..models import obca as M


def solve_with_scipy(spec, data, x_init=None, maxiter=500, verbose=0):
    """Solve one OBCA NLP with scipy trust-constr.

    Args:
      spec/data: the problem as the solver sees it; ``data`` holds one
        lane (B = 1).
      x_init: optional (3, N+1) state-trajectory warm start (the candidate
        the solver's multistart used).
    Returns:
      (z dict of numpy arrays, one problem's shapes; scipy OptimizeResult).
    """
    from scipy.optimize import NonlinearConstraint, minimize

    f64 = torch.float64
    dev = data.x0.device
    data = type(data)(*[t.to(f64) for t in data])
    if data.x0.shape[0] != 1:
        raise ValueError(f"solve_with_scipy solves one problem, got {data.x0.shape[0]} lanes")
    xi = None if x_init is None else torch.as_tensor(
        np.asarray(x_init, np.float64), device=dev).reshape(1, 3, spec.N + 1)
    z0f = M.ravel_z(spec, M.init_vars(spec, data, x_init=xi))[0]

    def of(fn):
        return lambda zf: fn(spec, data, M.unravel_z(spec, zf[None]))[0]

    def np_fn(fn):
        return lambda v: fn(torch.as_tensor(v, dtype=f64, device=dev)).detach().cpu().numpy()

    f = np_fn(of(M.objective))
    g = np_fn(grad(of(M.objective)))
    cE = np_fn(of(M.eq_constraints))
    JE = np_fn(jacrev(of(M.eq_constraints)))
    cI = np_fn(of(M.ineq_constraints))
    JI = np_fn(jacrev(of(M.ineq_constraints)))

    x0 = z0f.detach().cpu().numpy()
    mE = cE(x0).shape[0]
    res = minimize(
        fun=lambda v: float(f(v)),
        x0=x0,
        jac=g,
        method="trust-constr",
        constraints=[
            NonlinearConstraint(cE, np.zeros(mE), np.zeros(mE), jac=JE),
            NonlinearConstraint(cI, 0.0, np.inf, jac=JI),
        ],
        options={"maxiter": maxiter, "gtol": 1e-9, "xtol": 1e-12, "verbose": verbose},
    )
    z = M.unravel_z(spec, torch.as_tensor(res.x, dtype=f64)[None])
    return {k: v[0].numpy() for k, v in z.items()}, res


__all__ = ["solve_with_scipy"]
