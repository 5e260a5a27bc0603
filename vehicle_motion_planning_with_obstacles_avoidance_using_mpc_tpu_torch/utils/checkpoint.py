"""Checkpoint / resume for long sweeps.

PyTorch counterpart of the JAX package's ``utils/checkpoint.py``: a tree
of arrays (dicts, lists, tuples and NamedTuples such as the rollout's
:class:`..runtime.scan_loop.LoopState`; tensors or numpy arrays at the
leaves) is saved to an ``.npz`` of ``leaf_i`` arrays beside a
``.treedef.json`` skeleton, and restored exactly. The file format is the
JAX package's, so a checkpoint written by either package loads in the
other (a NamedTuple written by the JAX package excepted, see
:func:`_leaves`). Tensors are saved from the host (``.cpu()``); a load gives numpy
arrays, NamedTuples coming back as dicts of their fields (the JAX
package's rule), which the caller turns back into its own types and
device.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _leaves(tree, out):
    """The leaves in the order a load assigns them: a dict's values by
    sorted key (the JAX package's flattening order), a NamedTuple's by
    sorted field name (it loads as a dict), a list's or tuple's in order.
    The JAX package saves a NamedTuple's leaves in field order and loads
    them by sorted name, which swaps the fields of one whose names are not
    sorted (the rollout's ``LoopState``); a file written here loads right
    in both packages."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in sorted(tree._fields):
            _leaves(getattr(tree, f), out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _leaves(x, out)
    else:
        out.append(tree)
    return out


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_pytree(path: str, tree) -> str:
    """Save an array tree to ``path`` (.npz of the leaves + a
    ``.treedef.json`` skeleton)."""
    leaves = _leaves(tree, [])
    arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
    np.savez(path if path.endswith(".npz") else path + ".npz", **arrays)
    with open(_sidecar(path), "w") as f:
        json.dump({"treedef": _treedef_to_json(tree), "n": len(leaves)}, f)
    return path


def load_pytree(path: str):
    """Restore a tree saved by :func:`save_pytree` (numpy leaves;
    NamedTuples as dicts of their fields)."""
    npz = np.load(path if path.endswith(".npz") else path + ".npz")
    with open(_sidecar(path)) as f:
        meta = json.load(f)
    leaves = [npz[f"leaf_{i}"] for i in range(meta["n"])]
    return _fill(meta["treedef"], iter(leaves))


def _sidecar(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".treedef.json"


def _treedef_to_json(tree):
    """JSON skeleton of the container structure (dicts, lists, tuples,
    NamedTuples as dicts; leaves None)."""
    if isinstance(tree, dict):
        return {"t": "dict", "k": list(tree.keys()),
                "v": [_treedef_to_json(tree[k]) for k in tree.keys()]}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # NamedTuple
        return {"t": "dict", "k": list(tree._fields),
                "v": [_treedef_to_json(getattr(tree, f)) for f in tree._fields]}
    if isinstance(tree, (list, tuple)):
        return {"t": "list" if isinstance(tree, list) else "tuple",
                "v": [_treedef_to_json(x) for x in tree]}
    return None


def _fill(node, leaves):
    """The tree of skeleton ``node`` with ``leaves`` in flattening order
    (a dict's entries take theirs by sorted key)."""
    if node is None:
        return next(leaves)
    if node["t"] == "dict":
        pairs = dict(zip(node["k"], node["v"]))
        filled = {k: _fill(pairs[k], leaves) for k in sorted(pairs)}
        return {k: filled[k] for k in node["k"]}
    seq = [_fill(x, leaves) for x in node["v"]]
    return seq if node["t"] == "list" else tuple(seq)


class SweepCheckpointer:
    """Periodic checkpoints of a chunked sweep.

    Keeps the ``keep`` newest checkpoints in ``directory``, each under an
    increasing step id; ``latest()`` gives the newest back.
    """

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.npz")

    def save(self, step: int, tree) -> str:
        p = self._path(step)
        save_pytree(p, tree)
        self._gc()
        return p

    def steps(self):
        return sorted(int(fn[5:-4]) for fn in os.listdir(self.dir)
                      if fn.startswith("ckpt_") and fn.endswith(".npz"))

    def latest(self):
        """(step, tree) of the newest checkpoint, or (None, None)."""
        ss = self.steps()
        if not ss:
            return None, None
        return ss[-1], load_pytree(self._path(ss[-1]))

    def _gc(self):
        for s in self.steps()[: -self.keep]:
            for ext in (".npz", ".treedef.json"):
                p = os.path.join(self.dir, f"ckpt_{s:08d}{ext}")
                if os.path.exists(p):
                    os.remove(p)


__all__ = ["SweepCheckpointer", "load_pytree", "save_pytree"]
