"""Moving problems between the JAX package and the port as numpy arrays.

The port carries no weights; what it shares with the JAX package is its
problems and solver states. :func:`from_numpy` turns the JAX package's
NamedTuples (converted leaf by leaf to numpy, e.g. with ``np.asarray``)
into the port's tensors, adding the lane dimension where the JAX object
is a single problem; :func:`to_numpy` goes back. The tests use the pair to
feed identical problems to both packages. Types are recognised by class
name, so this module imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.obca import OBCAData
from .scenarios.build import Scenario

_INT_FIELDS = {"it", "acc_it", "stall_it", "iters", "ts_rel"}
_BOOL_FIELDS = {"done", "converged", "feas"}


def _leaf(a, device, dtype, name="", batch=False):
    a = np.array(a)
    if name in _BOOL_FIELDS or a.dtype == np.bool_:
        t = torch.as_tensor(a, dtype=torch.bool)
    elif name in _INT_FIELDS or np.issubdtype(a.dtype, np.integer):
        t = torch.as_tensor(a.astype(np.int32))
    else:
        t = torch.as_tensor(a.astype(np.float64)).to(dtype)
    if batch:
        t = t[None]
    return t.contiguous().to(device)


def from_numpy(nt, device=torch.device("cuda"), dtype=torch.float64, batch=None):
    """JAX-package object -> port object on ``device``.

    Accepts a variable dict ``z`` (``x`` of shape (3, N+1) or
    (B, 3, N+1)), or a NamedTuple named ``Scenario``, ``OBCAData``,
    ``IPMState`` or ``IPMResult``. A single problem (no lane dimension)
    gains one; a batched one keeps it. ``Scenario`` stays unbatched.

    Any other dict (nested dicts, lists and tuples of arrays: the
    variables and parameters of :func:`.solver.build_solver`'s callables)
    converts leaf by leaf; ``batch=True`` gives every leaf the lane
    dimension (a single problem), ``False`` keeps the shapes.
    """
    if isinstance(nt, dict) and batch is None and "x" in nt and np.ndim(nt["x"]) in (2, 3):
        batch = np.asarray(nt["x"]).ndim == 2
        return {k: _leaf(v, device, dtype, k, batch) for k, v in nt.items()}
    if isinstance(nt, dict):
        return {k: from_numpy(v, device, dtype, bool(batch)) for k, v in nt.items()}
    if isinstance(nt, (list, tuple)) and not hasattr(nt, "_fields"):
        return type(nt)(from_numpy(v, device, dtype, bool(batch)) for v in nt)
    if not hasattr(nt, "_fields"):
        return _leaf(nt, device, dtype, batch=bool(batch))
    name = type(nt).__name__
    if name == "Scenario":
        return Scenario(*[_leaf(getattr(nt, f), device, dtype, f)
                          for f in Scenario._fields])
    if name == "OBCAData":
        batch = np.asarray(nt.x0).ndim == 1
        return OBCAData(*[_leaf(getattr(nt, f), device, dtype, f, batch)
                          for f in OBCAData._fields])
    if name in ("IPMState", "IPMResult"):
        from .solver.ipm import IPMResult, IPMState

        cls = IPMState if name == "IPMState" else IPMResult
        batch = np.asarray(nt.s).ndim == 1
        vals = []
        for f in cls._fields:
            v = getattr(nt, f)
            vals.append(from_numpy(v, device, dtype) if isinstance(v, dict)
                        else _leaf(v, device, dtype, f, batch))
        return cls(*vals)
    raise TypeError(f"from_numpy: unsupported type {name}")


def to_numpy(obj):
    """Port tensor / dict / NamedTuple -> the same structure of numpy."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [to_numpy(v) for v in obj]
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[to_numpy(v) for v in obj])
    return obj
