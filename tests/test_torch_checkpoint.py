"""The port's checkpoint / resume (utils/checkpoint.py) on the CPU: round
trips of dicts, lists, tuples and the rollout's ``LoopState`` (tensors and
numpy leaves); ``SweepCheckpointer``'s keep and latest
(tests/test_utils.py's cases); files written by the JAX package's
``save_pytree`` load in the port leaf for leaf equal, and the port's in
the JAX package's; a closed-loop rollout split by a checkpoint between
its halves equals the uninterrupted one bit for bit."""

import numpy as np
import pytest
import torch

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.utils import (
    load_pytree as jload, save_pytree as jsave,
)

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
    demo_rollout_inputs,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime import (
    LoopState, make_scan_rollout,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.utils import (
    SweepCheckpointer, load_pytree, save_pytree,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _nested():
    rng = np.random.RandomState(0)
    return {"b": [rng.randn(4), np.zeros((2, 2), np.float32)],
            "a": np.arange(6).reshape(2, 3),
            "c": (np.asarray(3.5), {"z": np.arange(2), "d": rng.rand(3) > 0.5})}


def _loop_state():
    g = torch.Generator().manual_seed(0)
    B = 3
    r = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)
    return LoopState(x0=r(B, 3), u0=r(B, 2), Ts_cur=r(B), Ts_opt=r(B), dyn_pos=r(B, 2, 2),
                     prev_plan=r(B, 3, 7), k=torch.tensor([1, 2, 3], dtype=torch.int32),
                     active=torch.tensor([True, False, True]),
                     reached=torch.tensor([False, True, False]),
                     failed=torch.tensor([False, False, True]))


def _as_numpy(tree):
    """The tree as a load gives it back: numpy leaves, NamedTuples as
    dicts."""
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _as_numpy(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_numpy(x) for x in tree)
    return np.asarray(tree)


def _assert_tree_equal(got, want):
    assert type(got) is type(want), (type(got), type(want))
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_tree_equal(a, b)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


TREES = {
    "nested numpy": _nested,
    "tensors": lambda: {"x": torch.arange(5.0), "k": [torch.ones(2, dtype=torch.int32),
                                                       (torch.zeros(1, dtype=torch.bool),)]},
    "LoopState": _loop_state,
    "LoopState in a dict": lambda: {"step": np.asarray(15), "state": _loop_state()},
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_roundtrip(tmp_path, name):
    tree = TREES[name]()
    p = str(tmp_path / "ck")
    assert save_pytree(p, tree) == p
    _assert_tree_equal(load_pytree(p), _as_numpy(tree))
    _assert_tree_equal(load_pytree(p + ".npz"), _as_numpy(tree))


def test_sweep_checkpointer_keep_and_resume(tmp_path):
    ck = SweepCheckpointer(str(tmp_path / "sweep"), keep=2)
    for step in (1, 2, 3, 4):
        ck.save(step, {"step": np.asarray(step), "x": torch.full((3,), float(step))})
    assert ck.steps() == [3, 4]
    step, tree = ck.latest()
    assert step == 4
    np.testing.assert_array_equal(tree["x"], np.full(3, 4.0, np.float32))
    assert sorted(p.name for p in (tmp_path / "sweep").iterdir()) == [
        "ckpt_00000003.npz", "ckpt_00000003.treedef.json",
        "ckpt_00000004.npz", "ckpt_00000004.treedef.json"]


def test_sweep_checkpointer_empty(tmp_path):
    ck = SweepCheckpointer(str(tmp_path / "none"))
    assert ck.latest() == (None, None)
    assert ck.steps() == []


def test_jax_written_loads_in_the_port(tmp_path):
    tree = _nested()
    p = str(tmp_path / "jax")
    jsave(p, tree)
    _assert_tree_equal(load_pytree(p), _as_numpy(tree))


@pytest.mark.parametrize("name", ["nested numpy", "LoopState in a dict"])
def test_port_written_loads_in_the_jax_package(tmp_path, name):
    """The JAX package's load gives every leaf back under its own name, the
    port's LoopState (fields not in sorted order) included."""
    tree = TREES[name]()
    p = str(tmp_path / "port")
    save_pytree(p, tree)
    back = jload(p)
    want = _as_numpy(tree)

    def same(got, want):
        if isinstance(want, dict):
            assert set(got) == set(want)
            for k in want:
                same(got[k], want[k])
        elif isinstance(want, (list, tuple)):
            for a, b in zip(got, want):
                same(a, b)
        else:
            np.testing.assert_array_equal(np.asarray(got), want)
            assert np.asarray(got).dtype == want.dtype
    same(back, want)


def test_rollout_resumed_from_a_checkpoint_equals_one_run(tmp_path):
    """demo3, 4 closed-loop steps in float64: 2 steps, the LoopState saved,
    loaded back and made tensors again, then 2 more steps through
    ``rollout(..., st0=)``; every field of the final state and of the
    trajectory equals one 4-step run's bit for bit."""
    dtype = torch.float64
    scn, shape, p, ref, n = demo_rollout_inputs("demo3", dtype, "cpu")
    whole, traj = make_scan_rollout(shape, p, max_steps=4, dtype=dtype,
                                    device="cpu")(scn, ref, n)
    half = make_scan_rollout(shape, p, max_steps=2, dtype=dtype, device="cpu")
    mid, traj1 = half(scn, ref, n)
    ck = SweepCheckpointer(str(tmp_path / "ck"))
    ck.save(2, {"state": mid, "traj": traj1})
    step, saved = ck.latest()
    assert step == 2
    st0 = LoopState(**{k: torch.as_tensor(v) for k, v in saved["state"].items()})
    end, traj2 = half(scn, ref, n, st0=st0)
    assert int(end.k[0]) == 4
    for name, a, b in zip(whole._fields, whole, end):
        assert torch.equal(a, b), name
    for k in traj:
        got = torch.cat([torch.as_tensor(saved["traj"][k]), traj2[k]], dim=1)
        assert torch.equal(traj[k], got), k
