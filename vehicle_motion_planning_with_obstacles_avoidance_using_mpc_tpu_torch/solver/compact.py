"""Batched solve driver with iteration chunking and lane compaction.

PyTorch counterpart of the JAX package's ``solver/compact.py``. The
batched Newton loop convoys: every lane pays the batch's slowest lane's
iterations, a finished lane being frozen, not dropped. This driver runs
the solver's chunked API (``solve.init`` / ``solve.iterate`` /
``solve.finalize``) in chunks of iterations and gathers the lanes that
are still active into smaller padded buckets between chunks:

    init (B) -> iterate a chunk (B) -> gather the active lanes (B/4)
             -> iterate a chunk     -> gather (B/16) -> run to the cap
             -> scatter every bucket back -> finalize (B)

A lane's iterations and result are the monolithic solve's: a chunk
boundary only stops and restarts the loop, and a bucket runs the same
lanes at a smaller batch. On CUDA tensors each chunk is one launch of
the solver's device loop (:class:`.loop.GraphLoop`: the chunk's
iterations under a conditional WHILE node, one graph per bucket shape);
on CPU tensors the host loop. Each chunk costs, by design, one host read
of the bucket's ``(it, done)`` (it picks the next bucket); the gathers and scatters are
``index_select`` / ``index_copy_`` over the state's and the data's lane
dimension, one index tensor on the device per bucket.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.obca import OBCAData
from .ipm import IPMState


def _take(tup, idx):
    return type(tup)(*[t.index_select(0, idx) for t in tup])


def solve_compacted(solve, data_b: OBCAData, z0_b=None, *, chunk=16, min_bucket=16,
                    shrink=4, max_iters=None):
    """Solve a batch with chunked iteration and lane compaction.

    Args:
      solve: a :func:`.make_obca_solver` product (its ``init``,
        ``iterate``, ``finalize`` and ``options``).
      data_b: the batch's :class:`OBCAData` (every field (B, ...));
        ``z0_b`` its initial variables (None: the solver's cold start).
      chunk: iterations a chunk (every lane of a bucket shares the cap).
      min_bucket: once the bucket is this small, run it to the cap.
      shrink: bucket size divisor between compactions (buckets of B,
        B/shrink, B/shrink^2, ..., each one more graph capture).
      max_iters: the iteration cap, at most the solver's
        ``options.max_iters`` (its default): a lane the solver stops at its
        own cap is then counted done, and the loop ends.
    The JAX package's algorithm, with two repairs: the cap above (its
    default of 1e9 never counts such a lane done, and can loop forever),
    and the active set counted without its padded copies.
    Returns:
      ``(IPMResult batch, stats)``; ``stats`` holds ``lane_iters`` (the
      iterations the lanes executed, summed), ``dispatched_lane_iters``
      (bucket size x the bucket's iterations, summed over calls: the
      lane-iterations the device ran) and ``calls``.
    """
    cap_max = solve.options.max_iters
    max_iters = cap_max if max_iters is None else min(int(max_iters), cap_max)
    master = IPMState(*[t.clone() for t in solve.init(data_b, z0_b)])   # own, unaliased
    dev = master.it.device
    B = master.it.shape[0]
    stats = {"dispatched_lane_iters": 0, "calls": 0}
    idx = np.arange(B)                 # master lanes of the current bucket
    idx_t = torch.arange(B, device=dev)
    it_master = np.zeros(B, np.int64)  # the master state's it, on the host
    cur_st, cur_data = master, data_b
    size, cap = B, 0
    while True:
        at_tail = size <= min_bucket
        cap = max_iters if at_tail else cap + chunk
        cur_st = solve.iterate(cur_st, cur_data, cap)
        # one host read a chunk: the bucket's iteration counts and done flags
        probe = torch.stack([cur_st.it.to(torch.int64),
                             cur_st.done.to(torch.int64)]).cpu().numpy()
        it_after, done = probe[0], probe[1].astype(bool)
        stats["dispatched_lane_iters"] += size * int(np.max(it_after - it_master[idx]))
        stats["calls"] += 1
        # padded lanes duplicate real lanes bit for bit: the order in which
        # repeated indices land does not matter
        for m, c in zip(master, cur_st):
            if c is not m:             # a loop with no lane active returns its input
                m.index_copy_(0, idx_t, c)
        it_master[idx] = it_after
        done = done | (it_after >= max_iters)
        if done.all() or at_tail:
            break
        # the active lanes, each once: a padded copy is not one more lane (the
        # JAX package counts the copies, so a bucket refilled with copies of
        # a few slow lanes never shrinks)
        rem = np.unique(idx[~done])
        # the next bucket: the smallest allowed size that holds the active set
        while size > min_bucket and size // shrink >= len(rem):
            size //= shrink
        idx = np.resize(rem, size)     # cycle the active lanes as padding
        idx_t = torch.as_tensor(idx, device=dev)
        cur_st, cur_data = _take(master, idx_t), _take(data_b, idx_t)

    res = solve.finalize(master, data_b)
    stats["lane_iters"] = int(res.iters.sum())
    return res, stats


__all__ = ["solve_compacted"]
