"""Running a cell on the CPU at a toy size: the harness's run with the
port's plain kernels (``impl="plain"``), no card, no trace."""

from __future__ import annotations

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parked(cell, manifest=None):
    """The manifest with a parked cell's entries (``parked/<cell>.json``:
    its workload and the metrics only it reports) added, as
    ``BENCHMARK.json`` would carry them once the cell is back."""
    from portbench.harness import core

    m = copy.deepcopy(manifest or core.load_manifest())
    for key, entries in core.load_json("parked", f"{cell}.json").items():
        m[key] += entries
    return m


def cpu_run(workload, seconds=1.0, seed=7, traffic=None, config=None, manifest=None,
            control=None, patch=None):
    """``(out, checks)`` of ``workload`` on the CPU; ``traffic`` overrides
    the cell's traffic parameters and ``config`` its configuration's blocks
    (toy sizes), ``patch(kind)`` may break the kind's timed path before the
    run."""
    import torch

    from portbench import run as bench
    from portbench.harness import core

    manifest = manifest or core.load_manifest()
    w, cfg, tr = core.cell(manifest, workload)
    tr = copy.deepcopy(tr)
    tr.update(traffic or {})
    cfg = copy.deepcopy(cfg)
    for k, v in (config or {}).items():
        cfg[k] = {**cfg[k], **v} if isinstance(v, dict) else v
    if patch is not None:
        patch(core.load_module("kinds", tr["kind"]))
        loader = core.load_module
        core.load_module = lambda folder, name, *a, **kw: (
            sys.modules[f"portbench_{folder}_{name}".replace(".", "_")]
            if folder == "kinds" else loader(folder, name, *a, **kw))
    try:
        return bench.execute(manifest, w, cfg, tr, seed, seconds, 0, torch.device("cpu"), {},
                             control=control, impl="plain")
    finally:
        if patch is not None:
            core.load_module = loader


def failed(checks):
    """The names of the checks that do not hold."""
    return [n for n, v, lim in checks if not v <= lim]


def wrap_setup(kind, change):
    """Break a kind's timed path: ``change(state)`` after its set-up."""
    setup = kind.setup

    def broken(run):
        st = setup(run)
        change(st)
        return st

    kind.setup = broken


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch at one thread in a test module that imports this fixture."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
