"""The pool cell's bookkeeping, sound run, TF32 control and planted
faults, on the CPU at a toy size with the port's plain kernels.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

import numpy as np

from portbench.tests.cpu import cpu_run, failed, one_torch_thread, wrap_setup  # noqa: E402,F401

POOL = {"worlds": 4, "catalog": 4, "max_replans": 2, "warmup_steps": 0, "astar_checks": 50}


def _pool_fault(alter):
    def change(st):
        ro = st["rollout"]

        def wrong(scn, ref, ref_len, st0=None, profile=None):
            final, traj = ro(scn, ref, ref_len, st0=st0, profile=profile)
            return alter(st0, final, traj)

        wrong.initial_state = ro.initial_state
        st["rollout"] = wrong
    return lambda kind: wrap_setup(kind, change)


def test_pool_bookkeeping_sound_run_and_control():
    out, checks = cpu_run("corridor.fleet1024", seconds=0.1, traffic=POOL)
    assert out["correct"], out["checks"]
    info = out["info"]
    # first-trip budgets staggered over 1..2: worlds 0 and 2 (budget 1) leave
    # after the first step; every departure is followed by an arrival
    assert info["steps"] >= 1 and info["trips"] >= 2
    assert info["arrivals"] == info["trips"]
    assert sum(info["trip_steps_histogram"]) == info["trips"]
    assert out["attempted"] == 4 * info["steps"]
    _, ctl = cpu_run("corridor.fleet1024", seconds=0.1, traffic=POOL, control="tf32")
    assert {"state_err", "heading_err"} <= set(failed(ctl))


def test_pool_step_bookkeeping_replaces_departed_lanes():
    import torch

    from portbench.harness import core

    kind = core.load_module("kinds", "pool")
    run = core.Run("corridor.fleet1024", core.load_json("configs", "corridor.json"),
                   {**core.load_json("traffic", "fleet1024.json"), **POOL}, 5,
                   torch.device("cpu"), "plain")
    run.tracer = None
    st = kind.setup(run)
    st["record"] = True
    before_ids = st["lane_world"].copy()
    kind.step(run, st, 0)
    s = st["steps"][0]
    k = st["state"].k.numpy()
    leave = np.nonzero(k == 0)[0]                        # arrivals start at step 0
    assert set(leave) >= set(np.nonzero(before_ids % 2 == 0)[0])   # budget 1
    assert (st["budget"][leave] == 2).all()
    # the catalog's worlds in the seed's order, then again in another
    assert sorted(before_ids) == [0, 1, 2, 3]
    assert (k[np.setdiff1d(np.arange(4), leave)] == 1).all()
    assert (s["after"].k.numpy() == 1).all()             # the recorded state is before the swap
    assert len(st["arrivals"]) == 1 and st["arrivals"][0][0] == list(st["lane_world"][leave])


def test_pool_faults_fail():
    import torch

    def unchanged(st0, final, traj):   # a step that returns its state unchanged
        return st0, traj

    def half(st0, final, traj):   # half of the worlds left out of the step
        h = final.x0.shape[0] // 2
        keep = torch.arange(final.x0.shape[0]) < h
        f = type(final)(*[torch.where(keep.view((-1,) + (1,) * (a.dim() - 1)), a, b)
                          for a, b in zip(final, st0)])
        return f, traj

    def altered(st0, final, traj):   # a plan altered where it is produced
        traj = dict(traj)
        traj["plan"] = traj["plan"].clone()
        traj["plan"][:, :, 1, 3] += 0.05
        return final, traj

    for fault in (unchanged, half, altered):
        out, _ = cpu_run("corridor.fleet1024", seconds=0.1, traffic=POOL,
                         patch=_pool_fault(fault))
        assert not out["correct"], (fault.__name__, out["checks"])
