"""CPU checks of the design behind ``ipm_freeze`` and of its launch plan.

The kernel (``kernels/csrc/ipm_freeze.cu``) runs only on the card. It
copies the body's new state over the Newton loop's state for the lanes
that were active, from a static copy plan: a field the body passes
through (its new and old buffers are the same memory) is left out; each
lane of every other field is cut into slots (up to 16 / esize - 1 element
slots for a row's ragged head, a 16-byte slot for each vector and as many
element slots for its tail where both buffers are 16-byte aligned and a
row holds at least 16 bytes, else one slot an element); the items
(field, lane, slot) follow one flag item a lane, field-major, over a grid
of 128-thread CTAs, 1, 2 or 4 items a thread. A lane's flag item writes
its next active flag into a workspace; the CTA that takes the last ticket
copies those into ``active``, stores the loop flag and resets the ticket.
Here, on random states at the widths of the main paths' layouts:

* (a) a plain twin of that launch (``freeze_twin`` below: the plan of
  ``_cu_plan`` walked item by item with the kernel's slot arithmetic, then
  the last CTA's flag step in the CTA that draws the last ticket of a
  random order) is bit-equal to ``solver/loop.py`` ``freeze_plain`` (the
  state, the next active flags and the loop flag) at the fix step's 1280
  lanes, the free batch's 256, the sweep's 2048, the open loop's 5 at
  N = 74 and the host driver's 2 and 5 at N = 6 and N = 15, in both
  dtypes, with the body's pass-through fields aliased as the loop passes
  them and without, with mixed active and inactive lanes; also with every
  field misaligned (element slots) and with no lane active (the replay
  after the last lane finished writes nothing);
* (b) every byte of an active lane's copied rows is written exactly once,
  nothing else is, and every 16-byte slot is aligned in both buffers;
* (c) the .cu file's plan, written out below (``_cu_plan``), pinned at
  those shapes (tests/test_torch_cuda.py pins the built library's plan,
  ``kernels.freeze_launch_plan``, to the same numbers on the card): tens
  of CTAs at the host driver's 2-5 lanes, 4 items a thread at 1280;
* (d) the wrapper's field modes (``kernels.freeze_field_mode``) and its
  refusal of overlapping buffers (``kernels._check_disjoint``).
"""

import functools

import numpy as np
import pytest
import torch

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch import kernels
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.entry import (
    demo1_problem, demo9_window_batch, fix_fixture_batch, openloop_n74_inputs,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models import OBCASpec
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.models.obca_struct import (
    make_layout,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
    build_scenario, get_demo,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver import loop
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.solver.ipm import (
    IPMState,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

F32, F64 = torch.float32, torch.float64
THREADS, MAX_PER_THREAD, FILL_CTAS, WS_HEAD = 128, 4, 264, 16   # csrc/ipm_freeze.cu
PASS_THROUGH = ("sf", "scE", "scD")   # fields the Newton body returns unchanged


@functools.lru_cache(maxsize=None)
def _spec(kind):
    """The problem spec of a main path's shape."""
    if kind == "fix":
        return fix_fixture_batch(1, dtype=F64, device="cpu")[0]
    if kind == "free":
        return demo9_window_batch(1, dtype=F64, device="cpu")[0]
    if kind == "sweep":   # the sweep's demo1-family worlds: demo1's free-time spec
        return demo1_problem(F64, "cpu")[0]
    if kind == "host6":   # the host driver's fix-time replans at N = 6
        return fix_fixture_batch(1, dtype=F64, device="cpu")[0]
    if kind == "N74":
        return openloop_n74_inputs(F64, "cpu")[0]
    demo = get_demo("demo8")                      # host15: demo8's fix-time replans
    _, shape = build_scenario(demo, dtype=F64, device="cpu")
    return OBCASpec(N=demo.params.N_free, n_obs=shape.n_obs, e_max=shape.e_max,
                    variant="fix_terminal")


# (shape, lanes) of the main paths: the fix step, the free batch, the
# sweep's free rung, the open loop at N = 74, the host driver at N = 6 and 15
SHAPES = [("fix", 1280), ("free", 256), ("sweep", 2048), ("N74", 5), ("host6", 2),
          ("host6", 5), ("host15", 2), ("host15", 5)]


def _widths(spec):
    lay = make_layout(spec)
    mI = lay.m_id + lay.mD
    return dict(zv=lay.n, s=mI, y=lay.mE, w=mI, best_zv=lay.n, best_s=mI, best_y=lay.mE,
                best_w=mI, scE=lay.mE, scD=lay.mD)


def _state(B, widths, dtype, seed):
    """A random IPMState of B lanes (numpy seed), it in 0..11, done 30%."""
    rng = np.random.RandomState(seed)
    out = []
    for name in IPMState._fields:
        shape = (B, widths[name]) if name in widths else (B,)
        if name == "done":
            out.append(torch.as_tensor(rng.rand(*shape) < 0.3))
        elif name in ("it", "acc_it", "stall_it"):
            out.append(torch.as_tensor(rng.randint(0, 12, shape).astype(np.int32)))
        else:
            out.append(torch.as_tensor(rng.randn(*shape)).to(dtype))
    return IPMState(*out)


def _inputs(kind, B, dtype, alias, seed=0):
    """(new, old, active, cap): the loop's state, the body's, 60% of the
    lanes active (the first active, the last not), cap 7; with ``alias``
    the pass-through fields of new are old's buffers."""
    w = _widths(_spec(kind))
    old, new = _state(B, w, dtype, seed), _state(B, w, dtype, seed + 1)
    if alias:
        new = new._replace(**{f: getattr(old, f) for f in PASS_THROUGH})
    active = torch.as_tensor(np.random.RandomState(seed + 2).rand(B) < 0.6)
    active[0], active[-1] = True, B == 1
    return new, old, active, torch.tensor([7], dtype=torch.int32)


# ------------------------------------------------------------ the plan

def _cu_plan(fields, B):
    """csrc/ipm_freeze.cu freeze_plan, written out: ``fields`` are (element
    bytes, elements a lane, mode) triples; returns (slots a lane of each
    field, slots a lane with the flag item, items, items a thread, CTAs)."""
    slots = []
    for es, width, mode in fields:
        row = width * es
        slots.append(0 if mode == kernels.FREEZE_SKIP else width if mode == kernels.FREEZE_ELEM
                     else 2 * (16 // es - 1) + row // 16)
    items = B * (1 + sum(slots))
    U = MAX_PER_THREAD
    while U > 1 and -(-items // (U * THREADS)) < FILL_CTAS:
        U //= 2
    return slots, 1 + sum(slots), items, U, max(1, -(-items // (U * THREADS)))


def _fields(new, old):
    B = old.zv.shape[0]
    return [(o.element_size(), o.numel() // B, kernels.freeze_field_mode(n, o))
            for n, o in zip(new, old)]


# ------------------------------------------------------------ the twin

def _bytes(t):
    return t.view(-1).numpy().view(np.uint8)


def _field_items(k, B, S, es, row, mode):
    """(lane, offset, bytes) of every slot of field k's lanes, by the
    kernel's arithmetic (freeze_item); bytes 0 where a slot is idle."""
    j = np.arange(B * S)
    lane, slot = j // S, j % S
    off = lane.astype(np.int64) * row
    if mode == kernels.FREEZE_ELEM:
        return lane, off + slot * es, np.full(j.shape, es)
    H, V = 16 // es - 1, row // 16
    head = (16 - (off & 15)) & 15
    body = (row - head) >> 4
    pos = np.where(slot < H, slot * es,
                   np.where(slot < H + V, head + 16 * (slot - H),
                            head + 16 * body + (slot - H - V) * es))
    nb = np.where(slot < H, np.where(pos < head, es, 0),
                  np.where(slot < H + V, np.where(slot - H < body, 16, 0),
                           np.where(pos < row, es, 0)))
    return lane, off + pos, nb


def freeze_twin(new, old, active, cap, seed=0, counts=None):
    """ipm_freeze in numpy on CPU tensors, in place on ``old``, ``active``:
    returns the loop flag. Each field item copies its bytes where its lane
    is active (items of different slots never overlap: ``counts`` collects
    the times each byte of each field is written); flag items fill the
    workspace; the CTAs take tickets in a random order and the last copies
    the workspace into ``active``."""
    B = active.shape[0]
    fields = _fields(new, old)
    slots, _, items, U, ctas = _cu_plan(fields, B)
    act = active.numpy().copy()               # what every CTA reads
    ws = np.zeros(B, np.uint8)
    src = [n.view(-1).numpy() for n in new]
    dst = [o.view(-1).numpy() for o in old]
    # flag items: the state the lane leaves, the body's where active
    k_it, k_done = IPMState._fields.index("it"), IPMState._fields.index("done")
    it = np.where(act, src[k_it], dst[k_it])
    done = np.where(act, src[k_done], dst[k_done])
    ws[:] = (it < int(cap[0])) & ~done
    for k, (es, width, mode) in enumerate(fields):
        if not slots[k]:
            continue
        row = width * es
        if mode == kernels.FREEZE_VEC:
            assert new[k].data_ptr() % 16 == 0 and old[k].data_ptr() % 16 == 0
        lane, pos, nb = _field_items(k, B, slots[k], es, row, mode)
        on = act[lane] & (nb > 0)
        assert np.all(pos[nb == 16] % 16 == 0)
        idx = (pos[on, None] + np.arange(16)[None, :])[np.arange(16)[None, :] < nb[on, None]]
        sb, db = _bytes(new[k]), _bytes(old[k])
        if counts is not None:
            counts[k] = np.bincount(idx, minlength=db.size)
        loaded = sb[idx].copy()                # every load before any store
        db[idx] = loaded
    order = np.random.RandomState(seed).permutation(ctas)
    ticket = 0
    for c in order:
        ticket += 1
        if ticket == ctas:                     # the last CTA: the flags
            active.copy_(torch.as_tensor(ws != 0))
            flag = int((ws != 0).any())
    return flag


@pytest.mark.parametrize("alias", [True, False])
@pytest.mark.parametrize("kind,B", SHAPES)
def test_twin_is_bit_equal_to_freeze_plain(kind, B, alias):
    """(a) and (b) at a main path's shape, both dtypes."""
    for dtype in (F32, F64):
        new, old, active, cap = _inputs(kind, B, dtype, alias, seed=B)
        pst, pnext, pflag = loop.freeze_plain(new, old, active, cap)
        kst = IPMState(*[f.clone() for f in old])
        knew = new._replace(**{f: getattr(kst, f) for f in PASS_THROUGH}) if alias else new
        kact = active.clone()
        counts = {}
        flag = freeze_twin(knew, kst, kact, cap, seed=B, counts=counts)
        for name, a, b in zip(IPMState._fields, kst, pst):
            assert torch.equal(a, b), name
        assert torch.equal(kact, pnext) and flag == int(pflag)
        for k, c in counts.items():     # each copied byte once, only active rows
            o = old[k]
            per_lane = c.reshape(B, -1)
            assert np.all(per_lane[active.numpy()] == 1), IPMState._fields[k]
            assert np.all(per_lane[~active.numpy()] == 0), IPMState._fields[k]
        skipped = {IPMState._fields[k] for k, (_, _, m) in enumerate(_fields(knew, kst))
                   if m == kernels.FREEZE_SKIP}
        assert skipped == (set(PASS_THROUGH) if alias else set())


def test_twin_element_slots_and_no_lane_active():
    """(a): every field misaligned by one element (element slots only);
    then no lane active: nothing is written and the flags are the loop
    test of the state."""
    B = 5
    new, old, active, cap = _inputs("host6", B, F32, False)
    shifted = []
    for n in new:
        buf = torch.empty(n.numel() + 1, dtype=n.dtype)
        v = buf[1:].view(n.shape)
        v.copy_(n)
        shifted.append(v)
    new = IPMState(*shifted)
    assert all(m != kernels.FREEZE_VEC for _, _, m in _fields(new, old))
    pst, pnext, pflag = loop.freeze_plain(new, old, active, cap)
    kst, kact = IPMState(*[f.clone() for f in old]), active.clone()
    flag = freeze_twin(new, kst, kact, cap)
    assert all(torch.equal(a, b) for a, b in zip(kst, pst))
    assert torch.equal(kact, pnext) and flag == int(pflag)
    off = torch.zeros(B, dtype=torch.bool)
    st2 = IPMState(*[f.clone() for f in kst])
    flag = freeze_twin(new, st2, off, cap)
    assert all(torch.equal(a, b) for a, b in zip(st2, kst))
    expect = (kst.it < cap) & ~kst.done
    assert torch.equal(off, expect) and flag == int(expect.any())


# (shape, lanes, dtype, pass-through aliased) -> (slots a lane, items a
# thread, CTAs) of csrc/ipm_freeze.cu; tests/test_torch_cuda.py pins the
# library's plan to the same numbers
FREEZE_PLANS = {
    ("fix", 1280, "float32", True): (519, 4, 1298),
    ("fix", 1280, "float32", False): (567, 4, 1418),
    ("fix", 1280, "float64", True): (953, 4, 2383),
    ("free", 256, "float32", True): (1125, 4, 563),
    ("sweep", 2048, "float32", True): (521, 4, 2084),
    ("N74", 5, "float32", True): (7909, 1, 309),
    ("N74", 5, "float64", True): (15735, 2, 308),
    ("host6", 2, "float32", True): (519, 1, 9),
    ("host6", 5, "float32", True): (519, 1, 21),
    ("host15", 2, "float32", True): (1203, 1, 19),
    ("host15", 5, "float32", True): (1203, 1, 47),
}


@pytest.mark.parametrize("key", sorted(FREEZE_PLANS))
def test_cu_plan_pinned(key):
    """(c) the written-out plan at the main paths' shapes."""
    kind, B, dt, alias = key
    new, old, _, _ = _inputs(kind, B, getattr(torch, dt), alias)
    _, S, items, U, ctas = _cu_plan(_fields(new, old), B)
    assert (S, U, ctas) == FREEZE_PLANS[key] and items == B * S
    if B <= 5:
        assert ctas >= 9        # the host driver's few lanes still span many CTAs
    if B >= 1280:
        assert U == MAX_PER_THREAD


def test_field_modes_and_overlap_refused():
    """(d) a shared buffer is skipped, aligned rows of 16 bytes or more go
    by vectors, the rest by elements; overlapping buffers are refused."""
    a = torch.zeros(4, 8)
    assert kernels.freeze_field_mode(a, a) == kernels.FREEZE_SKIP
    assert kernels.freeze_field_mode(torch.zeros(4, 8), a) == kernels.FREEZE_VEC
    assert kernels.freeze_field_mode(torch.zeros(4, 3), torch.zeros(4, 3)) == kernels.FREEZE_ELEM
    assert kernels.freeze_field_mode(torch.zeros(33)[1:].view(4, 8), a) == kernels.FREEZE_ELEM
    new, old, _, _ = _inputs("host6", 3, F32, True)
    kernels._check_disjoint("ipm_freeze", new, old)
    with pytest.raises(ValueError, match="overlaps"):
        kernels._check_disjoint("ipm_freeze", new._replace(best_zv=old.zv), old)
    with pytest.raises(ValueError, match="overlaps"):
        big = torch.zeros(2 * old.zv.numel())
        kernels._check_disjoint("ipm_freeze", new, old._replace(
            zv=big[:old.zv.numel()].view_as(old.zv), best_zv=big[4:4 + old.zv.numel()]
            .view_as(old.zv)))
