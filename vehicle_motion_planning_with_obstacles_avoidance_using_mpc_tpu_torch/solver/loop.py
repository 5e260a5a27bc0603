"""The Newton iteration loop: the JAX package's ``lax.while_loop`` over the
interior-point body (``solver/ipm.py:1369-1380``), which runs until every
lane is done or at the cap and keeps a finished lane's state unchanged.

Two forms, both giving each lane the same iterations and bits:

* :func:`host_loop` (CPU tensors, ``impl="plain"``, or ``loop="host"``):
  the body runs eagerly while any lane is active and :func:`_freeze`
  keeps the finished lanes (``torch.where`` on every field). One
  ``active.any()`` synchronisation per iteration. It is the oracle of the
  other form.
* :class:`GraphLoop` (the default on CUDA tensors): a solve is a program
  of three pieces, ``pre`` (whatever comes before the loop: the initial
  state, a multistart's candidates and gather), the body and ``post``
  (finalize, the pick), run as ONE CUDA graph per input shape and static
  tag (``kernels/csrc/device_loop.cu``)::

      pre -> loop_start -> WHILE { body + ipm_freeze -> loop_next } -> post

  ``ipm_freeze`` (``kernels/csrc/ipm_freeze.cu``) writes the next active
  flags and an any-active flag on the device, reading the cap from device
  memory, so one graph serves every ``it_cap``; the two one-thread
  kernels set the WHILE node's condition from that flag and count the
  iterations. A call copies its inputs into the graph's static buffers,
  launches the graph, and reads the iteration count once with the
  results: no host read between the launch and the results, and one per
  call whatever the iterations. The counts of ``kernels.launches`` and
  :data:`stats` are derived from that count: the captured pieces'
  launches once a call, the body's once an iteration. The pieces are
  captured with ``torch.cuda.CUDAGraph(keep_graph=True)`` on one capture
  stream and memory pool per solver and device, after one eager run of
  the program (it fills the per-device constant caches and the kernels'
  workspaces); Python's garbage collector is paused during a capture. A
  failed capture, a runtime without conditional nodes or a body the
  WHILE node refuses raises; nothing falls back to the host loop. On a
  CPU tensor the same program runs eagerly, the loop as body + the plain
  freeze while the flag is set (the rehearsal the CPU tests drive).

Graphs launch on the caller's current stream; one solver's graphs on one
device share a memory pool and capture stream, and must not run
concurrently.
"""

from __future__ import annotations

import gc
import time
import warnings
from collections import OrderedDict

import torch
import torch.utils._pytree as pytree

from .. import kernels

MAX_GRAPHS = 8    # programs kept per solver (least recently used go)

# since the last reset_stats(): programs captured and built, graph launches,
# Newton iterations run inside them (from the counts read with the results;
# "replays" keeps the old name of an iteration of the captured body) and
# the host milliseconds spent instantiating the graphs, and building them
# in all (the eager run, the captures and the instantiation)
stats = {"captures": 0, "launches": 0, "replays": 0, "instantiate_ms": 0.0, "build_ms": 0.0}
# kernel launches of the eager run that precedes each capture (pre, one
# body iteration, post, on the call's inputs; its results are discarded):
# counted in kernels.launches like any launch, and here apart
warmup_launches = {}


def reset_stats():
    for k in stats:
        stats[k] = 0.0 if k.endswith("_ms") else 0
    warmup_launches.clear()


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
    and not done); finished lanes stay frozen. Returns ``(state,
    iterations run)``."""
    n = 0
    while True:
        active = (st.it < cap) & ~st.done
        if not bool(active.any()):
            return st, n
        st = _freeze(step(st), st, active)
        n += 1


def _iterations(p):
    """The call's one host read, after its results: the iterations run."""
    return int(p.count)


def _own(t):
    return torch.empty_like(t, memory_format=torch.contiguous_format)


class _Program:
    """The static buffers, captured pieces and graph of one input shape."""

    def __init__(self, leaves, dev):
        self.inputs = [_own(t) if isinstance(t, torch.Tensor) else t for t in leaves]
        self.cap = torch.zeros(1, dtype=torch.int32, device=dev)
        self.flag = torch.zeros(1, dtype=torch.int32, device=dev)
        self.count = torch.zeros(1, dtype=torch.int32, device=dev)
        self.st = self.active = None
        self.data = self.extra = self.carry = self.out = None
        self.graphs = ()       # the PyTorch graphs that own the pieces' memory
        self.exec = None
        self.per_call = {}     # kernel launches of pre + post
        self.per_iter = {}     # kernel launches of one body iteration

    def __del__(self):
        if self.exec is not None:
            try:
                kernels.device_loop_destroy(self.exec)
            except Exception:   # the CUDA runtime may be gone at interpreter exit
                pass


class GraphLoop:
    """The Newton loop of one solver as one CUDA graph a program (see the
    module docstring). ``body(st, data, *extra) -> new state`` is the
    Newton iteration; :meth:`run` takes a whole solve. A call's ``static``
    is a hashable tag of whatever else the pieces read and a graph bakes
    in: calls with different tags get different graphs."""

    def __init__(self, body, max_graphs=MAX_GRAPHS):
        self.body = body
        self.max_graphs = max_graphs
        self._progs = OrderedDict()
        self._streams = {}   # device -> (capture stream, memory pool)

    def run(self, pre, post, inputs, cap, static=None):
        """One solve: ``pre(*inputs) -> (st, data, extra, carry)``, the loop
        on ``st`` up to ``cap`` (an int), ``post(st, carry) -> outputs``.
        ``inputs`` is a tree of tensors and other leaves (the other leaves,
        the tree and ``static`` key the graph). Returns ``(outputs, n)``,
        the outputs copied out of the graph's memory and ``n`` the
        iterations run."""
        leaves, spec = pytree.tree_flatten(inputs)
        dev = next(t.device for t in leaves if isinstance(t, torch.Tensor))
        key = (str(dev), spec, static, tuple(
            (tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor) else (type(t), t)
            for t in leaves))
        try:
            hash(key)
        except TypeError:
            raise TypeError("inputs of a graphed solve that are not tensors must be hashable "
                            "(pass arrays as tensors)") from None
        p = self._progs.get(key)
        if p is None:
            p = self._progs[key] = _Program(leaves, dev)
            while len(self._progs) > self.max_graphs:
                self._progs.popitem(last=False)
        self._progs.move_to_end(key)
        for b, t in zip(p.inputs, leaves):
            if isinstance(t, torch.Tensor):
                b.copy_(t)
        p.cap.fill_(cap)
        args = pytree.tree_unflatten(p.inputs, spec)
        if dev.type == "cpu":
            return self._rehearse(p, pre, post, args)
        if p.exec is None:
            t0 = time.perf_counter()
            self._capture(p, pre, post, args)
            stats["build_ms"] += (time.perf_counter() - t0) * 1e3
        kernels.device_loop_launch(p.exec, dev)
        out = pytree.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, p.out)
        n = _iterations(p)
        stats["launches"] += 1
        stats["replays"] += n
        for k, c in p.per_call.items():
            kernels.launches[k] += c
        for k, c in p.per_iter.items():
            kernels.launches[k] += n * c
        return out, n

    def run_host(self, pre, post, inputs, cap, static=None):
        """:meth:`run`'s program eagerly around :func:`host_loop`, the
        oracle (CPU tensors, ``impl="plain"`` or ``loop="host"``)."""
        st, data, extra, carry = pre(*inputs)
        st, n = host_loop(lambda s: self.body(s, data, *extra), st, cap)
        return post(st, carry), n

    # ------------------------------------------------------------ pieces

    def _pre(self, p, pre, args):
        st, p.data, p.extra, p.carry = pre(*args)
        if p.st is None:       # the loop's state buffers, made outside any capture
            p.st = type(st)(*[_own(t) for t in st])
            p.active = torch.zeros(st.it.shape[0], dtype=torch.bool, device=st.it.device)
        for b, t in zip(p.st, st):
            b.copy_(t)
        torch.logical_and(p.st.it < p.cap, ~p.st.done, out=p.active)
        p.flag.copy_(p.active.any().to(torch.int32).reshape(1))

    def _body(self, p):
        new = self.body(p.st, p.data, *p.extra)
        freeze(new, p.st, p.active, p.cap, p.flag)

    def _post(self, p, post):
        p.out = post(p.st, p.carry)

    def _rehearse(self, p, pre, post, args):
        """The program on CPU tensors: the pieces eagerly, the loop while
        the flag is set."""
        self._pre(p, pre, args)
        n = 0
        while bool(p.flag):
            self._body(p)
            n += 1
        self._post(p, post)
        stats["launches"] += 1
        stats["replays"] += n
        out = pytree.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, p.out)
        return out, n

    def _capture(self, p, pre, post, args):
        """One eager run of the program on the capture stream, then the
        three pieces captured and joined into one graph."""
        dev = p.cap.device
        cur = torch.cuda.current_stream(dev)
        if dev not in self._streams:
            with torch.cuda.device(dev):
                self._streams[dev] = (torch.cuda.Stream(dev), torch.cuda.graph_pool_handle())
        s, pool = self._streams[dev]
        s.wait_stream(cur)
        before = dict(kernels.launches)
        with torch.cuda.stream(s):
            self._pre(p, pre, args)
            loops = p.st.it.shape[0] > 0
            if loops:
                self._body(p)
            self._post(p, post)
        for k, v in kernels.launches.items():
            if v != before[k]:
                warmup_launches[k] = warmup_launches.get(k, 0) + v - before[k]
        pieces = [("pre", lambda: self._pre(p, pre, args)),
                  ("body", (lambda: self._body(p)) if loops else None),
                  ("post", lambda: self._post(p, post))]
        graphs, counts = {}, {}
        # no garbage collection inside a capture: a collection that frees
        # an unreachable solver's graph destroys it mid-capture, which CUDA
        # forbids, and the capture is invalidated
        gc_on = gc.isenabled()
        gc.disable()
        try:
            for name, fn in pieces:
                if fn is None:
                    continue
                before = dict(kernels.launches)
                g = torch.cuda.CUDAGraph(keep_graph=True)
                try:
                    with torch.cuda.stream(s), warnings.catch_warnings():
                        # a piece may hold no work (the loop alone's post)
                        warnings.filterwarnings("ignore", "The CUDA Graph is empty")
                        g.capture_begin(pool=pool)
                        try:
                            fn()
                        finally:
                            g.capture_end()
                finally:
                    counts[name] = {k: v - before[k] for k, v in kernels.launches.items()
                                    if v != before[k]}
                    kernels.launches.update(before)
                graphs[name] = g
        finally:
            if gc_on:
                gc.enable()
        cur.wait_stream(s)
        raw = {k: g.raw_cuda_graph() for k, g in graphs.items()}
        t0 = time.perf_counter()
        p.exec = kernels.device_loop_build(raw["pre"], raw.get("body"), raw["post"],
                                           p.flag, p.count)
        stats["instantiate_ms"] += (time.perf_counter() - t0) * 1e3
        p.graphs = tuple(graphs.values())
        p.per_iter = counts.get("body", {})
        p.per_call = {k: counts["pre"].get(k, 0) + counts["post"].get(k, 0)
                      for k in set(counts["pre"]) | set(counts["post"])}
        stats["captures"] += 1


__all__ = ["GraphLoop", "MAX_GRAPHS", "freeze", "freeze_plain", "host_loop", "reset_stats",
           "stats", "warmup_launches"]
