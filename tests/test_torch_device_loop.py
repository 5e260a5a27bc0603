"""The device loop's program (solver/loop.py ``GraphLoop.run``) on the CPU,
float64: a solve as ``pre`` -> the Newton loop -> ``post``, keyed per input
shape and static tag, with the iteration count read once with the results
and the counts derived from it. On a CPU tensor the program runs its
pieces eagerly and the loop as body + the plain freeze while the flag is
set (the rehearsal of the graph that tests/test_torch_cuda.py launches on
the card): it must give ``host_loop``'s bits, and the JAX package's
``iterate_fn`` iterations and iterates, on the fused demo1 problem."""

from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as jentry
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.solver import (
    IPMOptions as JOptions,
    make_obca_solver as jmake_solver,
)

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
    ENTRY_OPTIONS, FIX6_OPTIONS, demo1_problem, fix_fixture_batch,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.interop import (
    from_numpy, to_numpy,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import (
    init_vars,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime.multistart import (
    bucket_rows, make_multistart_solver,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import (
    loop, make_obca_solver,
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


def _bits(t):
    if t.is_floating_point():
        return t.view({8: torch.int64, 4: torch.int32}[t.element_size()])
    return t


def _equal(a, b):
    """Two trees of tensors bit for bit."""
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(_bits(x), _bits(y))


@pytest.fixture(scope="module")
def demo1():
    jspec, jdata, _, _ = jentry._demo1_problem(jnp.float64)
    jsolve = jmake_solver(jspec, JOptions(max_iters=60))
    jiter = jax.jit(jsolve.iterate)     # the cap traced: one compile for every chunk
    spec, data, _, _ = demo1_problem(F64, "cpu")
    return dict(jst0=jax.jit(jsolve.init)(jdata), jdata=jdata, jiter=jiter, spec=spec,
                data=data)


def test_program_rehearsal_matches_host_loop_and_jax(demo1):
    """Chunks of the loop (caps 3, 3, 9, 100: a repeated cap is a call with
    every lane done) and the cold-start solve as one program: host_loop's
    bits, the JAX package's iterations and iterates."""
    e = demo1
    spec, data = e["spec"], e["data"]
    graphed = make_obca_solver(spec, ENTRY_OPTIONS, loop="graph")
    host = make_obca_solver(spec, ENTRY_OPTIONS, loop="host")
    loop.reset_stats()
    sg, sh, jst = graphed.init(data), host.init(data), e["jst0"]
    for cap in (3, 3, 9, 100):
        sg, sh = graphed.iterate(sg, data, cap), host.iterate(sh, data, cap)
        _equal(sg, sh)
        jst = e["jiter"](jst, e["jdata"], cap)
        want = from_numpy(type(jst)(*[np.asarray(v) for v in jst]), "cpu")
        for f in sg._fields:
            a, b = to_numpy(getattr(sg, f)), to_numpy(getattr(want, f))
            if a.dtype.kind in "biu":
                np.testing.assert_array_equal(a, b, err_msg=f)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9, err_msg=f)
    assert sg.it.tolist() == [17] and bool(sg.done.all())
    # the chunks: 3 + 0 + 6 + 8 iterations, one launch each, one program
    assert loop.stats["launches"] == 4 and loop.stats["replays"] == 17
    assert loop.stats["captures"] == 0     # the CPU rehearsal captures nothing
    rg, rh = graphed(data), host(data)
    _equal(rg, rh)
    assert rg.iters.tolist() == [17] and loop.stats["replays"] == 34


class _Toy(NamedTuple):
    zv: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor


def _toy_body(st, data, scale):
    it = st.it + 1
    return _Toy(st.zv * scale + it[:, None].to(st.zv.dtype), it, it >= data)


def _toy_pre(stop, zv0, scale):
    """A solve's ``pre``: the initial state from the inputs (lanes that
    start at their stop are done)."""
    it = torch.zeros(stop.shape[0], dtype=torch.int32)
    return _Toy(zv0 * 1.0, it, stop <= 0), stop, (scale,), stop.sum()


def _toy_post(st, carry):
    return {"zv": st.zv.sum(1), "it": st.it, "total": carry * 2}


def test_program_split_keys_and_counts():
    """pre / loop / post with a carry from pre to post; graph keys on the
    shapes, the static tag and the non-tensor leaves; the least recently
    used program goes; the iterations counted once a call; a call whose
    lanes all start done runs none."""
    g = loop.GraphLoop(_toy_body, max_graphs=2)
    loop.reset_stats()

    def ref(stop, zv0, scale, cap):
        st, data, extra, carry = _toy_pre(stop, zv0, scale)
        st, n = loop.host_loop(lambda s: _toy_body(s, data, *extra), st, cap)
        return _toy_post(st, carry), n

    stop = torch.tensor([2, 5, 3], dtype=torch.int32)
    zv0 = torch.ones((3, 2), dtype=F64)
    out, n = g.run(_toy_pre, _toy_post, (stop, zv0, 1.5), 4, "a")
    want, wn = ref(stop, zv0, 1.5, 4)
    _equal(out, want)
    assert n == wn == 4 and out["it"].tolist() == [2, 4, 3]
    assert int(out["total"]) == 20
    # new data, same shapes: the same program; the outputs are copies
    out2, n2 = g.run(_toy_pre, _toy_post, (stop - 1, zv0 * 2, 1.5), 100, "a")
    _equal(out2, ref(stop - 1, zv0 * 2, 1.5, 100)[0])
    assert n2 == 4 and len(g._progs) == 1 and out["it"].tolist() == [2, 4, 3]
    assert loop.stats["launches"] == 2 and loop.stats["replays"] == 8
    # another tag, another scalar leaf, another shape: new programs, two kept
    g.run(_toy_pre, _toy_post, (stop, zv0, 1.5), 4, "b")
    g.run(_toy_pre, _toy_post, (stop, zv0, 0.5), 4, "b")
    assert len(g._progs) == 2
    g.run(_toy_pre, _toy_post, (stop[:2], zv0[:2], 0.5), 4, "b")
    assert len(g._progs) == 2
    # every lane starts done: no iteration, post sees pre's state
    done, dn = g.run(_toy_pre, _toy_post, (torch.zeros(3, dtype=torch.int32), zv0, 1.5),
                     9, "a")
    assert dn == 0 and done["it"].tolist() == [0, 0, 0]
    _equal(done["zv"], zv0.sum(1))
    # a cap of 0 runs nothing either
    assert g.run(_toy_pre, _toy_post, (stop, zv0, 1.5), 0, "a")[1] == 0
    assert loop.stats["captures"] == 0      # the CPU rehearsal captures nothing
    with pytest.raises(TypeError, match="hashable"):
        g.run(_toy_pre, _toy_post, (stop, zv0, np.ones(1)), 4, "a")


@pytest.fixture(scope="module")
def fix_rows():
    spec6, _, data, cands = fix_fixture_batch(dtype=F64, device="cpu", rows=[0, 1, 23])
    return spec6, data, cands


@pytest.mark.parametrize("skip", [None, [True, False, True], [True, True, True]])
def test_multistart_program_matches_host_loop(fix_rows, skip):
    """The fix step's mpc6 multistart (3 rows x 5 candidates) as one
    program: the candidates' starts, init, the loop over the rows that run,
    finalize and the pick, bit-equal to the host loop's; the rows and
    iterations it reports; every row skipped runs no iteration."""
    spec6, data, cands = fix_rows
    sk = None if skip is None else torch.tensor(skip)
    res = {}
    for mode in ("graph", "host"):
        ms = make_multistart_solver(spec6, make_obca_solver(spec6, FIX6_OPTIONS, loop=mode),
                                    init_vars, 5)
        res[mode] = (ms(data, cands, skip=sk), dict(ms.last))
    (rg, lg), (rh, lh) = res["graph"], res["host"]
    _equal(rg, rh)
    assert lg == lh
    rows = 3 if skip is None else 3 - sum(skip)
    assert lg["rows"] == rows and (lg["iters"] > 0) == (rows > 0)
    if rows:
        assert lg["iters"] >= int(rg[0].iters.max())
    if skip is not None:
        assert not rg[0].feas[torch.tensor(skip)].any()


def test_multistart_padded_rows_keep_their_bits():
    """A gated multistart whose 9 running rows of 12 are padded to
    ``bucket_rows``' 10 with a skipped row: every running row's result and
    pick bit-equal to a multistart of those rows alone, the skipped rows
    infeasible, the padding not counted as rows."""
    rows = list(range(0, 96, 8))
    spec6, _, data, cands = fix_fixture_batch(dtype=F64, device="cpu", rows=rows)
    ms = make_multistart_solver(spec6, make_obca_solver(spec6, FIX6_OPTIONS), init_vars, 5)
    skip = torch.zeros(len(rows), dtype=torch.bool)
    skip[[1, 4, 7]] = True
    assert bucket_rows(9, 12) == 10
    (res, best), last = ms(data, cands, skip=skip), dict(ms.last)
    keep = (~skip).nonzero().flatten()
    alone, best_alone = ms(type(data)(*[f[keep] for f in data]), cands[keep])
    assert last == ms.last == {"rows": 9, "iters": last["iters"]}
    _equal(type(res)(*[{k: v[keep] for k, v in f.items()} if isinstance(f, dict) else f[keep]
                       for f in res]), alone)
    assert torch.equal(best[keep], best_alone) and not res.feas[skip].any()
