"""The Newton iteration loop: the JAX package's ``lax.while_loop`` over the
interior-point body (``solver/ipm.py:1369-1380``), which runs until every
lane is done or at the cap and keeps a finished lane's state unchanged.

Two forms, both giving each lane the same iterations and bits:

* :func:`host_loop` (CPU tensors, ``impl="plain"``, or ``loop="host"``):
  the body runs eagerly while any lane is active and :func:`_freeze`
  keeps the finished lanes (``torch.where`` on every field). One
  ``active.any()`` synchronisation per iteration.
* :class:`GraphLoop` (the default on CUDA tensors): the body and the
  ``ipm_freeze`` kernel (``kernels/csrc/ipm_freeze.cu``) are captured once
  per input shape (and static tag) as a CUDA graph over static buffers and
  replayed.
  ``ipm_freeze`` writes the next active flags and an any-active flag on the
  device, reading the cap from device memory, so one graph serves every
  ``it_cap``. The host reads the flag one replay behind: it queues replay
  j + 1, then waits for replay j's flag in pinned memory. The replay queued
  after the last lane finished is an exact no-op (every field, ``it``
  included, is frozen on inactive lanes) and is not counted. Before the
  first capture of a shape one iteration runs eagerly on the real state
  (it fills the per-device constant caches and checks every kernel's
  launch), and the captured launches are counted in ``kernels.launches``
  once per replay that found a lane active. Python's garbage collector is
  paused during a capture. A failed capture or replay raises; nothing
  falls back to the host loop. On a CPU tensor the same
  control code runs with an eager body and the plain freeze in place of
  each replay (the rehearsal the CPU tests drive).

Graphs replay on the caller's current stream; one solver's graphs on one
device share a memory pool and capture stream, and must not run
concurrently.
"""

from __future__ import annotations

import gc
from collections import OrderedDict

import torch

from .. import kernels

MAX_GRAPHS = 8    # captured shapes kept per solver (least recently used go)

# captures and counted replays since the last reset_stats()
stats = {"captures": 0, "replays": 0}


def reset_stats():
    for k in stats:
        stats[k] = 0


def _freeze(new, old, active):
    """``active ? new : old`` on every field (B, ...) of a state."""
    return type(old)(*[torch.where(active.view((-1,) + (1,) * (o.dim() - 1)), n, o)
                       for n, o in zip(new, old)])


def freeze_plain(new, old, active, cap):
    """The plain version of ``ipm_freeze``: (the frozen state, the next
    active flags ``(it < cap) & ~done`` of it, and the (1,) int32 flag
    any(next active)); ``cap`` is a (1,) int32 tensor."""
    st = _freeze(new, old, active)
    nxt = (st.it < cap) & ~st.done
    return st, nxt, nxt.any().to(torch.int32).reshape(1)


def freeze(new, old, active, cap, flag):
    """``ipm_freeze`` in place on the loop's buffers ``old``, ``active``
    and ``flag``: the kernel on CUDA tensors, :func:`freeze_plain` on CPU
    tensors."""
    if not kernels.runs_plain(old.zv):
        kernels.ipm_freeze(new, old, active, cap, flag)
        return
    st, nxt, any_ = freeze_plain(new, old, active, cap)
    for o, f in zip(old, st):
        o.copy_(f)
    active.copy_(nxt)
    flag.copy_(any_)


def host_loop(step, st, cap):
    """``step(st) -> new state`` while any lane is active (``it < cap``
    and not done); finished lanes stay frozen."""
    while True:
        active = (st.it < cap) & ~st.done
        if not bool(active.any()):
            return st
        st = _freeze(step(st), st, active)


def run_pipelined(step):
    """Keep one iteration queued ahead of the host. ``step()`` queues one
    iteration and returns a ticket whose call waits for it and says
    whether any lane is still active after it. Called with some lane
    active; returns the number of iterations queued while a lane was
    active (the one queued after the last lane finished is a no-op)."""
    n, ticket = 1, step()
    while True:
        nxt = step()
        if not ticket():
            return n
        n, ticket = n + 1, nxt


class _Buffers:
    """The static inputs and state of one input shape, and its graph."""

    def __init__(self, st, data, extra):
        dev = st.zv.device
        own = lambda t: None if t is None else torch.empty_like(
            t, memory_format=torch.contiguous_format)
        self.st = type(st)(*[own(t) for t in st])
        self.data = type(data)(*[own(t) for t in data])
        self.extra = tuple(own(t) for t in extra)
        self.active = torch.zeros(st.zv.shape[0], dtype=torch.bool, device=dev)
        self.cap = torch.zeros(1, dtype=torch.int32, device=dev)
        self.flag = torch.zeros(1, dtype=torch.int32, device=dev)
        self.graph = None
        self.per_replay = {}
        if dev.type == "cuda":
            self.host_flag = [torch.zeros(1, dtype=torch.int32, pin_memory=True)
                              for _ in range(2)]
            self.events = [torch.cuda.Event() for _ in range(2)]
            self.slot = 0

    def load(self, st, data, extra, cap):
        """Copy one call's inputs in; True when some lane is active."""
        for groups in ((self.st, st), (self.data, data), (self.extra, extra)):
            for b, t in zip(*groups):
                if b is not None:
                    b.copy_(t)
        self.cap.fill_(cap)
        torch.logical_and(self.st.it < self.cap, ~self.st.done, out=self.active)
        return bool(self.active.any())


class GraphLoop:
    """The Newton loop of one solver as replayed CUDA graphs (see the module
    docstring). ``body(st, data, *extra) -> new state`` is the Newton
    iteration; ``extra`` are per-call tensors it reads (None entries pass
    through). A call's ``static`` is a hashable tag of whatever else the
    body reads and a graph bakes in: calls with different tags get
    different graphs."""

    def __init__(self, body, max_graphs=MAX_GRAPHS):
        self.body = body
        self.max_graphs = max_graphs
        self._bufs = OrderedDict()
        self._streams = {}   # device -> (capture stream, memory pool)

    def __call__(self, st, data, extra, cap, static=None):
        shapes = lambda ts: tuple(None if t is None else tuple(t.shape) for t in ts)
        key = (str(st.zv.device), st.zv.dtype, shapes(st), shapes(data), shapes(extra), static)
        b = self._bufs.get(key)
        if b is None:
            b = self._bufs[key] = _Buffers(st, data, extra)
            while len(self._bufs) > self.max_graphs:
                self._bufs.popitem(last=False)
        self._bufs.move_to_end(key)
        if b.load(st, data, extra, cap):
            if b.active.device.type == "cpu":
                run_pipelined(lambda: self._eager_step(b))
            elif b.graph is not None or self._first_iteration(b):
                n = run_pipelined(lambda: self._replay(b))
                stats["replays"] += n
                for k, c in b.per_replay.items():
                    kernels.launches[k] += n * c
        return type(st)(*[t.clone() for t in b.st])

    def _iteration(self, b):
        new = self.body(b.st, b.data, *b.extra)
        freeze(new, b.st, b.active, b.cap, b.flag)

    def _eager_step(self, b):
        self._iteration(b)
        flag = bool(b.flag)
        return lambda: flag

    def _replay(self, b):
        b.graph.replay()
        slot, b.slot = b.slot, 1 - b.slot
        b.host_flag[slot].copy_(b.flag, non_blocking=True)
        b.events[slot].record()

        def ticket():
            b.events[slot].synchronize()
            return bool(b.host_flag[slot])
        return ticket

    def _first_iteration(self, b):
        """One eager iteration on the real state, on the capture stream;
        when a lane stays active, capture the iteration as ``b.graph``.
        Returns whether a lane stays active."""
        dev = b.active.device
        cur = torch.cuda.current_stream(dev)
        if dev not in self._streams:
            with torch.cuda.device(dev):
                self._streams[dev] = (torch.cuda.Stream(dev), torch.cuda.graph_pool_handle())
        s, pool = self._streams[dev]
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            self._iteration(b)
        cur.wait_stream(s)
        if not bool(b.flag):
            return False
        before = dict(kernels.launches)
        g = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: a collection that frees
        # an unreachable solver's graph destroys it mid-capture, which CUDA
        # forbids, and the capture is invalidated
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(s):
                g.capture_begin(pool=pool)
                try:
                    self._iteration(b)
                finally:
                    g.capture_end()
        finally:
            if gc_on:
                gc.enable()
            b.per_replay = {k: v - before[k] for k, v in kernels.launches.items()
                            if v != before[k]}
            kernels.launches.update(before)
        cur.wait_stream(s)
        b.graph = g
        stats["captures"] += 1
        return True


__all__ = ["GraphLoop", "MAX_GRAPHS", "freeze", "freeze_plain", "host_loop",
           "reset_stats", "run_pipelined", "stats"]
