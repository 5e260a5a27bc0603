"""Interior-point NLP solver for the OBCA problem family."""

from __future__ import annotations

import numpy as np

from ..models import obca as _obca
from ..models import obca_struct as _struct
from ..models.obca import OBCAData, OBCASpec
from .ad import build_solver
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


def _one(tree):
    """A lane's problem as a batch of one (the model functions are batched)."""
    return type(tree)(*[t[None] for t in tree]) if hasattr(tree, "_fields") else {
        k: v[None] for k, v in tree.items()}


def obca_callables(spec: OBCASpec):
    """The OBCA problem as per-problem callables ``(z, data) -> ...`` for
    :func:`.ad.build_solver` (``f_fn``, ``cE_fn``, ``cI_fn``, ``sgn_off_fn``,
    ``cI_dense_fn``), each the batched model function on a batch of one."""
    return (lambda z, d: _obca.objective(spec, _one(d), _one(z))[0],
            lambda z, d: _obca.eq_constraints(spec, _one(d), _one(z))[0],
            lambda z, d: _obca.ineq_constraints(spec, _one(d), _one(z))[0],
            lambda d: tuple(t[0] for t in _obca.ineq_identity_sgn_off(spec, _one(d))),
            lambda z, d: _obca.ineq_constraints_dense(spec, _one(d), _one(z))[0])


def z_example(spec: OBCASpec):
    """One problem's variable dict (zeros), the AD solver's ``z_example``."""
    N, nk, nO, E = spec.N, spec.n_k, spec.n_obs, spec.e_max
    z = {"x": np.zeros((3, N + 1)), "u": np.zeros((2, N)),
         "lam": np.zeros((nk, nO, E)), "mu": np.zeros((nk, nO, 4))}
    if spec.free_time:
        z["T"] = np.zeros(())
    return z


def build_obca_ad_solver(spec: OBCASpec, options: IPMOptions = IPMOptions(), impl=None,
                         loop=None):
    """:func:`.ad.build_solver` over the OBCA callables, as the JAX
    package's ``make_obca_solver`` builds it (``solver/__init__.py:21-76``):
    the solver's variable scaling, the identity inequality rows, the arrow
    layout and the grouped spine probes. ``solve(z0, data)``."""
    f_fn, cE_fn, cI_fn, sgn_off_fn, cI_dense_fn = obca_callables(spec)
    return build_solver(
        f_fn, cE_fn, cI_fn, z_example(spec), options, z_scale=z_scale_flat(spec),
        ineq_id=(_obca.ineq_identity_layout(spec), sgn_off_fn, cI_dense_fn),
        arrow=_obca.arrow_layout(spec), spine=_obca.hessian_spine_probes(spec),
        impl=impl, loop=loop)


def make_obca_solver(spec: OBCASpec, options: IPMOptions = IPMOptions(),
                     impl=None, loop=None):
    """Solver for one OBCA problem family.

    Returns ``solve(data: OBCAData, z0=None) -> IPMResult`` over the
    whole batch (every field of ``data`` has a leading lane dimension),
    cold-starting from :func:`.models.obca.init_vars` by default, with the
    chunked API ``solve.init(data, z0=None)``,
    ``solve.iterate(st, data, it_cap)`` and ``solve.finalize(st, data)``
    (``solve.step(st, data)``: one Newton iteration, nothing frozen),
    ``solve.program(pre, post, inputs, it_cap, static)`` (a caller's
    solve around the Newton loop, one graph launch on the card) and its
    ``solve.options``; :func:`.compact.solve_compacted` drives the
    chunked API with lane compaction.
    ``impl="plain"`` forces the plain PyTorch versions of the kernels on
    any device; it exists for kernel-vs-plain comparisons on the card.
    ``loop`` picks the Newton loop (see :func:`.ipm.build_fused_solver`):
    on the card by default the whole solve as one CUDA graph whose loop is
    a conditional WHILE node, ``"host"`` the host loop.

    ``kkt`` "fused" and "qr" run the analytic provider
    (:func:`.ipm.build_fused_solver`); "arrow", "al_chol" and "chol" the AD
    solver over the OBCA callables (:func:`build_obca_ad_solver`), whose
    ``solve.family`` and ``solve.loop_of`` say which Newton step and loop
    run.
    """
    ds = z_scale_flat(spec)
    lay, provider = _struct.make_provider(spec, ds)
    if options.kkt in ("arrow", "al_chol", "chol"):
        base = build_obca_ad_solver(spec, options, impl, loop)
        base.layout = None
    elif options.kkt in ("fused", "qr"):
        base = build_fused_solver(spec, lay, provider, ds, options, impl, loop)
    else:
        raise ValueError(f"unknown kkt family {options.kkt!r}")

    def _z0(data, z0):
        return _obca.init_vars(spec, data) if z0 is None else z0

    def solve(data: OBCAData, z0=None) -> IPMResult:
        if z0 is not None:
            return base(z0, data)
        # the cold start inside the solve's program (one graph launch on the card)
        return base.program(lambda d: (base.init(_obca.init_vars(spec, d), d), d, d),
                            base.finalize, (data,), options.max_iters, "cold")[0]

    solve.init = lambda data, z0=None: base.init(_z0(data, z0), data)
    solve.iterate = base.iterate
    solve.step = base.step
    solve.finalize = base.finalize
    solve.program = base.program
    solve.options = options
    solve.provider = provider
    solve.layout = base.layout
    solve.family = getattr(base, "family", options.kkt)
    solve.loop_of = getattr(base, "loop_of", None)
    return solve


__all__ = ["IPMOptions", "IPMResult", "IPMState", "build_obca_ad_solver", "build_solver",
           "make_obca_solver", "obca_callables", "solve_compacted", "spd_inv",
           "z_example", "z_scale_flat"]
