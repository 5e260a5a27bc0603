"""Interior-point NLP solver for the OBCA problem family."""

from __future__ import annotations

import numpy as np

from ..models import obca as _obca
from ..models import obca_struct as _struct
from ..models.obca import OBCAData, OBCASpec
from .compact import solve_compacted
from .ipm import IPMOptions, IPMResult, IPMState, build_fused_solver, spd_inv


def z_scale_flat(spec: OBCASpec) -> np.ndarray:
    """The solver's variable scaling in flat order: positions ~ map scale
    (x rows x[10, 10, 3]), the time scale ~ 30, duals and inputs 1."""
    N, nk, nO, E = spec.N, spec.n_k, spec.n_obs, spec.e_max
    parts = [np.full(1, 30.0)] if spec.free_time else []
    parts += [np.ones(nk * nO * E), np.ones(nk * nO * 4), np.ones(2 * N),
              np.repeat([10.0, 10.0, 3.0], N + 1)]
    return np.concatenate(parts)


def make_obca_solver(spec: OBCASpec, options: IPMOptions = IPMOptions(),
                     impl=None, loop=None):
    """Solver for one OBCA problem family.

    Returns ``solve(data: OBCAData, z0=None) -> IPMResult`` over the
    whole batch (every field of ``data`` has a leading lane dimension),
    cold-starting from :func:`.models.obca.init_vars` by default, with the
    chunked API ``solve.init(data, z0=None)``,
    ``solve.iterate(st, data, it_cap)`` and ``solve.finalize(st, data)``
    (``solve.step(st, data)``: one Newton iteration, nothing frozen) and
    its ``solve.options``; :func:`.compact.solve_compacted` drives the
    chunked API with lane compaction.
    ``impl="plain"`` forces the plain PyTorch versions of the kernels on
    any device; it exists for kernel-vs-plain comparisons on the card.
    ``loop`` picks the Newton loop (see :func:`.ipm.build_fused_solver`):
    a captured CUDA graph by default on the card, ``"host"`` the host loop.
    """
    ds = z_scale_flat(spec)
    lay, provider = _struct.make_provider(spec, ds)
    base = build_fused_solver(spec, lay, provider, ds, options, impl, loop)

    def _z0(data, z0):
        return _obca.init_vars(spec, data) if z0 is None else z0

    def solve(data: OBCAData, z0=None) -> IPMResult:
        return base(_z0(data, z0), data)

    solve.init = lambda data, z0=None: base.init(_z0(data, z0), data)
    solve.iterate = base.iterate
    solve.step = base.step
    solve.finalize = base.finalize
    solve.options = options
    solve.provider = provider
    solve.layout = base.layout
    return solve


__all__ = ["IPMOptions", "IPMResult", "IPMState", "make_obca_solver",
           "solve_compacted", "spd_inv", "z_scale_flat"]
