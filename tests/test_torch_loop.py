"""The port's Newton loop (solver/loop.py) on the CPU, float64: the plain
freeze leaves a finished solve bit-identical, and the device loop's
control code (copy-in, the flag set before the loop and by each freeze,
chunk boundaries of ``it_cap``, lanes finishing at different iterations,
the iterations counted once a call, the bounded cache) gives the host
loop's iterations and bits. On a CPU tensor the device loop runs each
iteration as an eager body + the plain freeze; the graph with its WHILE
node and ``ipm_freeze`` run in tests/test_torch_cuda.py."""

from typing import NamedTuple

import numpy as np
import pytest
import torch

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
    ENTRY_OPTIONS, demo1_problem,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
    build_obca_data,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
    loop, make_obca_solver,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.ipm import (
    IPMState,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.loop import (
    _freeze,
)

F64 = torch.float64

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the batches are a few lanes, and the suite runs
    several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _lanes(offsets):
    """demo1's entry problem with one lane per x0 offset (seeded, numpy)."""
    spec, data, scn, _ = demo1_problem(F64, "cpu")
    x0 = scn.start + torch.as_tensor(np.asarray(offsets, float))
    data = build_obca_data(spec, scn, x0=x0, u0=torch.zeros(2), Ts=0.1,
                           xref=data.xref.expand(len(offsets), -1, -1))
    return spec, data


THREE = [[0.0, 0.0, 0.0], [0.3, 0.1, 0.05], [-0.2, 0.2, -0.1]]


def test_freeze_leaves_a_finished_solve_unchanged():
    spec, data = _lanes(THREE[:2])
    solve = make_obca_solver(spec, ENTRY_OPTIONS)
    st = solve.iterate(solve.init(data), data, 100)
    cap = ENTRY_OPTIONS.max_iters
    assert bool((st.done | (st.it >= cap)).all())
    cap_t = torch.tensor([cap], dtype=torch.int32)
    for _ in range(3):
        active = (st.it < cap) & ~st.done
        assert not bool(active.any())
        new = solve.step(st, data)
        assert not torch.equal(new.it, st.it)      # the body did move the lanes
        frozen = _freeze(new, st, active)
        for name, a, b in zip(IPMState._fields, frozen, st):
            assert torch.equal(a, b), name
        # the in-place form: the buffers, the active flags and the flag
        buf = IPMState(*[f.clone() for f in st])
        act, flag = active.clone(), torch.ones(1, dtype=torch.int32)
        loop.freeze(new, buf, act, cap_t, flag)
        for name, a, b in zip(IPMState._fields, buf, st):
            assert torch.equal(a, b), name
        assert not bool(act.any()) and int(flag) == 0
        st = frozen


@pytest.mark.parametrize("caps", [(1, 4, 9, 100), (100,), (2, 2, 3, 100)])
def test_graph_loop_control_matches_host_loop(caps):
    """Three lanes that finish at different iterations, the cap moved
    between calls (a repeated cap is a call with nothing to do)."""
    spec, data = _lanes(THREE)
    out = {}
    for mode in ("host", "graph"):
        solve = make_obca_solver(spec, ENTRY_OPTIONS, loop=mode)
        st = solve.init(data)
        for c in caps:
            st = solve.iterate(st, data, c)
            assert int(st.it.max()) <= c
        out[mode] = (st, solve.finalize(st, data))
    (sh, rh), (sg, rg) = out["host"], out["graph"]
    assert len(set(sh.it.tolist())) > 1, sh.it
    for name, a, b in zip(IPMState._fields, sh, sg):
        assert torch.equal(a, b), name
    assert rh.iters.tolist() == rg.iters.tolist()
    for k in rh.z:
        assert torch.equal(rh.z[k], rg.z[k]), k


class _Toy(NamedTuple):
    zv: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor


class _Target(NamedTuple):
    stop: torch.Tensor


def _toy_body(st, data):
    it = st.it + 1
    return _Toy(st.zv * 1.5 + it[:, None].to(st.zv.dtype), it, it >= data.stop)


def test_pipelined_loop_counts_and_cache_bound():
    """A toy body whose lanes finish at given iterations, through the
    device loop's program (its CPU rehearsal): the iterations it reports
    are those the host loop runs, with no iteration queued after the last
    lane finished (the pipelined host loop's no-op replay is gone), the
    statistics derived from them, and the cache's least-recently-used
    bound over many lane counts."""
    g = loop.GraphLoop(_toy_body, max_graphs=3)
    for B in range(1, 7):
        stop = torch.arange(B, dtype=torch.int32) + 2
        st0 = _Toy(torch.ones((B, 2), dtype=F64), torch.zeros(B, dtype=torch.int32),
                   torch.zeros(B, dtype=torch.bool))
        ref, n_ref = loop.host_loop(lambda s: _toy_body(s, _Target(stop)), st0, 5)
        loop.reset_stats()
        alone = (lambda s, d: (s, d, (), None), lambda s, _: s)   # the loop alone
        mid, _ = g.run(*alone, (st0, _Target(stop)), 3)
        got, _ = g.run(*alone, (mid, _Target(stop)), 5)
        assert got.it.tolist() == ref.it.tolist() == torch.clamp(stop, max=5).tolist()
        assert torch.equal(got.zv, ref.zv)
        assert loop.stats["replays"] == n_ref == min(B + 1, 5)
        assert loop.stats["launches"] == 2 and loop.stats["captures"] == 0
        assert len(g._progs) <= 3
