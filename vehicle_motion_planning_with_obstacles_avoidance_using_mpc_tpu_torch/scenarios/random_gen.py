"""Randomized scenario generation for scenario sweeps.

A copy of the JAX package's ``scenarios/random_gen.py`` (plain numpy, but
reachable only through that package's jax-importing ``__init__``): batches
of corridor worlds in demo1's family -- a random block obstacle and a
random dynamic crossing obstacle -- as one batched :class:`Scenario`.
The draws of ``np.random.default_rng(seed)`` are the same, in the same
order, so both packages build the same worlds from one seed.
"""

from __future__ import annotations

import numpy as np
import torch

from .build import build_scenario, stack_scenarios
from .demos import DemoSpec, get_demo


def random_scenarios(seed: int, batch: int, base: str = "demo1",
                     dtype=torch.float32, device=torch.device("cuda"),
                     randomize_endpoints: bool = True):
    """Build a batch of randomized demo1-style corridors.

    Returns (Scenario with a leading axis ``batch``, ShapeSpec). The worlds
    are built on the host and the stacked batch is moved to ``device``
    once; this is set-up, not the hot path.

    ``randomize_endpoints`` randomizes start pose and goal per scenario
    (start in the approach corridor left of the block, goal to its
    right, both clear of every obstacle); ``False`` keeps the base demo's
    fixed endpoints.
    """
    rng = np.random.default_rng(seed)
    base_spec = get_demo(base)
    specs = []
    for _ in range(batch):
        bx = float(rng.uniform(8.0, 26.0))       # block left edge
        bw = float(rng.uniform(3.0, 6.0))        # block width
        by0 = float(rng.choice([1.0, 3.0]))      # bottom or floating
        bh = float(rng.uniform(3.0, 5.0))
        block = (
            (bx, by0), (bx, by0 + bh), (bx + bw, by0 + bh),
            (bx + bw, by0), (bx, by0),
        )
        xu = base_spec.x_hi
        lobs = (
            ((xu[0], xu[1] - 1), (0.0, xu[1] - 1)),
            block,
            ((0.0, 1.0), (xu[0], 1.0)),
        )
        rects = (
            ((xu[0], xu[1] - 1), (0.0, xu[1] - 1), (0.0, xu[1]), (xu[0], xu[1])),
            block,
            ((0.0, 1.0), (xu[0], 1.0), (xu[0], 0.0), (0.0, 0.0)),
        )
        # the crossing obstacle clear of the block: to its right when
        # there is room, otherwise in the approach corridor on the left
        right_lo, right_hi = bx + bw + 4.0, xu[0] - 6.0
        if right_lo < right_hi:
            dcx = float(rng.uniform(right_lo, right_hi))
        else:
            dcx = float(rng.uniform(6.0, bx - 4.0))
        dv = float(rng.uniform(0.1, 0.3))
        dyn = ((dcx, 0.0, np.pi / 2, 3.0, 3.0, dv, dcx, 9.0, np.pi / 2, 0.0, 55.0),)
        if randomize_endpoints:
            # start left of the block with ego-length clearance, goal to
            # its right; y inside the corridor walls with clearance for
            # the 1.5 m-wide ego
            start = (float(rng.uniform(1.0, max(bx - 4.0, 2.0))),
                     float(rng.uniform(3.0, xu[1] - 3.0)), 0.0)
            goal = (float(rng.uniform(min(bx + bw + 4.0, xu[0] - 2.0),
                                      xu[0] - 1.0)),
                    float(rng.uniform(3.0, xu[1] - 3.0)), 0.0)
        else:
            start, goal = base_spec.start, base_spec.goal
        specs.append(
            DemoSpec(
                name=f"rand{seed}",
                x_lo=base_spec.x_lo,
                x_hi=base_spec.x_hi,
                start=start,
                goal=goal,
                static_lobs=lobs,
                grid_rects=rects,
                dyn_obs_info=dyn,
                terminal_set=base_spec.terminal_set,
                terminal_policy=base_spec.terminal_policy,
                sense_dis=base_spec.sense_dis,
                params=base_spec.params,
            )
        )
    shape = None
    built = []
    for s in specs:
        scn, shape = build_scenario(s, shape, dtype=dtype, device="cpu")
        built.append(scn)
    return stack_scenarios(built, device), shape
