"""The port's two normal problems: the entry replan and bench's batch.

``demo1_problem`` mirrors the JAX package's ``__graft_entry__._demo1_problem``
(one free-time replan, demo1, N = 6, reference window from the A* path).
``demo9_window_batch`` mirrors ``bench.py:128-150``: the free-time NLP on
demo9 at N = 10 for B replan problems whose x0 sit at points along the A*
path drawn by ``np.random.RandomState(0)``. ``BENCH_FREE_OPTIONS`` are
the tuned free-time options of ``bench.py:170-173``.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import OBCASpec, build_obca_data
from .runtime import astar_host
from .runtime.reference import window_reference
from .scenarios import build_scenario, get_demo
from .solver import IPMOptions

BENCH_FREE_OPTIONS = IPMOptions(
    max_iters=100, tol=1e-4, acceptable_tol=5e-3, feas_tol=1e-3,
    n_deltas=1, n_refine=1, n_backtracks=8, acceptable_iter=1,
)

ENTRY_OPTIONS = IPMOptions(max_iters=60)


def demo1_problem(dtype=torch.float32, device="cpu"):
    """One replan-step NLP (B = 1): demo1, free time, N = 6.

    Returns ``(spec, data, scn, shape)``.
    """
    demo = get_demo("demo1")
    scn, shape = build_scenario(demo, dtype=dtype, device=device)
    N = 6
    spec = OBCASpec(N=N, n_obs=shape.n_obs, e_max=shape.e_max, variant="free")
    ref = astar_host.reference_path_for(scn.grid.cpu().numpy(), demo.start,
                                        demo.goal)
    refj = torch.as_tensor(ref, dtype=dtype, device=device)
    x0 = scn.start[None]
    xref = window_reference(refj, ref.shape[1], x0, N)
    data = build_obca_data(spec, scn, x0=x0, u0=torch.zeros(2, dtype=dtype),
                           xref=xref, Ts=0.1)
    return spec, data, scn, shape


def demo9_starts(B):
    """Indices along the demo9 A* path of bench's B replan starts, and
    the path itself ((3, L) float64)."""
    demo = get_demo("demo9")
    scn, _ = build_scenario(demo, dtype=torch.float64)
    ref = astar_host.reference_path_for(scn.grid.numpy(), demo.start,
                                        demo.goal)
    rng = np.random.RandomState(0)
    starts = np.sort(rng.randint(0, ref.shape[1] - 2, size=B))
    return starts, ref


def demo9_window_batch(B, N=10, dtype=torch.float32, device="cpu",
                       starts=None):
    """bench.py's headline batch: demo9, free time, horizon N, B lanes.

    ``starts`` optionally selects a subset of the lane indices of the
    B = 256 batch's path points (e.g. ``starts[::32]``); by default the
    first ``B`` draws of ``RandomState(0)`` as bench.py makes them.
    Returns ``(spec, data, scn, shape)``.
    """
    demo = get_demo("demo9")
    scn, shape = build_scenario(demo, dtype=dtype, device=device)
    spec = OBCASpec(N=N, n_obs=shape.n_obs, e_max=shape.e_max, variant="free")
    if starts is None:
        starts, ref = demo9_starts(B)
    else:
        _, ref = demo9_starts(1)
    refj = torch.as_tensor(ref, dtype=dtype, device=device)
    x0s = refj[:, torch.as_tensor(np.asarray(starts), device=device)].T
    xref = window_reference(refj, ref.shape[1], x0s, N)
    data = build_obca_data(spec, scn, x0=x0s, u0=torch.zeros(2, dtype=dtype),
                           xref=xref, Ts=0.1)
    return spec, data, scn, shape
