"""The scenario axis split over devices, and process-group bring-up.

PyTorch counterpart of the JAX package's ``parallel/mesh.py``: data
parallelism over worlds. A mesh is a list of devices; the leading
(scenario) axis of every batched tensor is cut into one contiguous chunk a
device (``tensor_split``: sizes differ by at most one), each chunk runs on
its own device, and the results are gathered back in order on the first
device. Each solve stays on one device: nothing is exchanged inside a
solve, as in the JAX package, where XLA partitions the batched solves
with no cross-device collectives.

The chunks run in turn, each on its device, from one host thread: the
solver's launch counts, loop statistics and graph captures are per
process, and a capture on one device must not overlap another thread's
work.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree


def init_distributed(address=None, world_size=None, rank=None, backend=None):
    """Join a process group (``torch.distributed.init_process_group``);
    a no-op for one process. ``address`` is an init method such as
    ``tcp://localhost:29500``; the backend defaults to NCCL where a card is
    present, else gloo."""
    if world_size and world_size > 1:
        import torch.distributed as dist

        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        dist.init_process_group(backend, init_method=address, world_size=world_size,
                                rank=rank)


def make_mesh(n_devices: int | None = None, device_type: str = "cuda"):
    """The first ``n_devices`` devices (default: all) as a list of
    ``torch.device``: the cards, like every entry point, and raises where
    there is none; a CPU mesh only when asked for (``device_type="cpu"``)
    repeats the one CPU device ``n_devices`` times (the split's logic, run
    in turn)."""
    if device_type == "cpu":
        return [torch.device("cpu")] * (n_devices or 1)
    devs = [torch.device(device_type, i) for i in range(torch.cuda.device_count())]
    if not devs:
        raise RuntimeError("make_mesh: no CUDA device")
    return devs if n_devices is None else devs[:n_devices]


def shard_along(tree, mesh):
    """A batched pytree cut along its leading axis into ``len(mesh)``
    chunks, chunk i moved to ``mesh[i]``; returns the list of chunks.
    Leaves that are not tensors are shared."""
    k = len(mesh)
    leaves, spec = pytree.tree_flatten(tree)
    cut = [t.tensor_split(k) if isinstance(t, torch.Tensor) else [t] * k for t in leaves]
    return [pytree.tree_unflatten([
        c[i].to(mesh[i]) if isinstance(c[i], torch.Tensor) else c[i] for c in cut], spec)
        for i in range(k)]


def _gather(outs, device):
    """Chunks' outputs -> one output on ``device``: tensors concatenated
    along the leading axis (0-d tensors and other leaves from chunk 0)."""
    flat = [pytree.tree_flatten(o) for o in outs]
    spec = flat[0][1]
    leaves = []
    for parts in zip(*[f[0] for f in flat]):
        p0 = parts[0]
        if isinstance(p0, torch.Tensor) and p0.dim() > 0:
            leaves.append(torch.cat([p.to(device) for p in parts], 0))
        else:
            leaves.append(p0.to(device) if isinstance(p0, torch.Tensor) else p0)
    return pytree.tree_unflatten(leaves, spec)


def _run(fn, mesh, args):
    """``fn(*chunk_args)`` on each device's chunk, gathered on ``mesh[0]``."""
    chunks = shard_along(args, mesh)

    outs = []
    for dev, chunk in zip(mesh, chunks):
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                outs.append(fn(*chunk))
        else:
            outs.append(fn(*chunk))
    return _gather(outs, mesh[0])


def sharded_batch_solver(solve, mesh):
    """``run(datab, z0b=None)``: a batched ``solve(data, z0=None)`` (a
    :func:`..solver.make_obca_solver` product) on each device's chunk of
    the lanes, the results gathered in lane order."""
    def run(datab, z0b=None):
        if z0b is None:
            return _run(lambda d: solve(d), mesh, (datab,))
        return _run(lambda d, z: solve(d, z), mesh, (datab, z0b))
    return run


def sharded_rollout(rollout, mesh):
    """``run(scnb, refb, ref_lenb)``: a batched closed-loop rollout
    (:func:`..runtime.scan_loop.make_scan_rollout`) on each device's chunk
    of the worlds."""
    return lambda scnb, refb, ref_lenb: _run(rollout, mesh, (scnb, refb, ref_lenb))


def sharded_rollout_from(rollout, mesh):
    """Like :func:`sharded_rollout` but state-carrying: ``run(st, scnb,
    refb, ref_lenb)`` resumes each world from its ``LoopState`` (the
    chunked dispatch of long sweeps)."""
    return lambda stb, scnb, refb, ref_lenb: _run(
        lambda st, s, r, n: rollout(s, r, n, st0=st), mesh, (stb, scnb, refb, ref_lenb))


__all__ = ["init_distributed", "make_mesh", "shard_along", "sharded_batch_solver",
           "sharded_rollout", "sharded_rollout_from"]
