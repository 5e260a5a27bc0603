"""The port's native (C++) A* (native/) on the CPU: its cells equal the
JAX package's native search on every demo grid, its path cost the
reference-exact Python search's, the batch entry the single one, an
unreachable goal gives None, ``reference_path_for(native=True)`` the JAX
package's; the library is built from the port's own ``native/astar.cpp``
into the port's gitignored ``native/_build/``, and a failed build raises.
No module of the port, and not chip_smoke.py, imports jax or the JAX
package."""

import math
import os
import shutil
import subprocess

import numpy as np
import pytest

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.native import (
    astar_solve_native as jnative,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.runtime import (
    astar_host as jastar,
)

from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.native import (
    astar_solve_batch_native, astar_solve_native, build,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.runtime import (
    astar_host,
)
from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch.scenarios import (
    build_scenario, demo_names, get_demo,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu_torch"
JAX_PKG = "vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu"

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ unavailable")


@pytest.fixture(scope="module")
def private_jax_native(tmp_path_factory):
    """The JAX package builds its native library on first use into its own
    directory, and tests/test_native_astar.py may build the same file in
    another worker at the same moment: a library still being written fails
    to load, and the JAX loader then answers None for the rest of the
    process. This module's uses build the JAX package's copy (its own
    loader, its own source) in a private directory instead."""
    from vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu.native import build as jb

    saved = (jb._LIB, jb._cached, jb._failed)
    jb._LIB = str(tmp_path_factory.mktemp("jax_native") / "libastar.so")
    jb._cached, jb._failed = None, False
    yield
    jb._LIB, jb._cached, jb._failed = saved


pytestmark = pytest.mark.usefixtures("private_jax_native")


def _cost(cells):
    return sum(math.hypot(a[0] - b[0], a[1] - b[1]) for a, b in zip(cells[:-1], cells[1:]))


def _demo(name):
    demo = get_demo(name)
    scn, _ = build_scenario(demo, device="cpu")
    s = (int(demo.start[1]), int(demo.start[0]))
    g = (int(demo.goal[1]), int(demo.goal[0]))
    return demo, scn.grid.numpy(), s, g


@needs_gxx
@pytest.mark.parametrize("name", demo_names())
def test_native_matches_jax_native_and_python_cost(name):
    demo, grid, s, g = _demo(name)
    cells = astar_solve_native(grid, s, g)
    np.testing.assert_array_equal(cells, jnative(grid, s, g))
    assert tuple(cells[0]) == g and tuple(cells[-1]) == s
    py = astar_host.solve_grid_astar(grid, s, g) + [s]   # the Python route excludes start
    assert abs(_cost(cells) - _cost(py)) < 1e-4
    ref = astar_host.reference_path_for(grid, demo.start, demo.goal, native=True)
    np.testing.assert_array_equal(
        ref, jastar.reference_path_for(grid, demo.start, demo.goal, native=True))


@needs_gxx
def test_native_batch_matches_single():
    grid = np.zeros((12, 12), np.uint8)
    grid[4:8, 4:8] = 1
    starts = np.array([[0, 0], [11, 0], [0, 0], [0, 0]], np.int32)
    goals = np.array([[11, 11], [0, 11], [0, 1], [5, 5]], np.int32)   # the last blocked
    batch = astar_solve_batch_native(grid, starts, goals)
    assert len(batch) == 4 and batch[3] is None
    for i in range(3):
        np.testing.assert_array_equal(batch[i], astar_solve_native(grid, starts[i], goals[i]))


@needs_gxx
def test_native_unreachable_returns_none():
    grid = np.zeros((5, 5), np.uint8)
    grid[:, 2] = 1
    assert astar_solve_native(grid, (0, 0), (0, 4)) is None
    with pytest.raises(ValueError, match="unreachable"):
        astar_host.reference_path_for(grid, (0, 0, 0), (4, 0, 0), native=True)


@needs_gxx
def test_library_is_built_from_the_port_into_its_build_dir():
    astar_solve_native(np.zeros((3, 3), np.uint8), (0, 0), (2, 2))
    port_native = os.path.join(ROOT, PORT, "native")
    assert build.SRC == os.path.join(port_native, "astar.cpp")
    assert build.LIB == os.path.join(port_native, "_build", "libastar.so")
    assert os.path.exists(build.LIB)
    assert os.path.getmtime(build.LIB) >= os.path.getmtime(build.SRC)
    ignored = subprocess.run(["git", "check-ignore", "-q", build.LIB], cwd=ROOT)
    assert ignored.returncode == 0, "native/_build/ must be listed in .gitignore"
    with open(build.SRC, "rb") as a, open(os.path.join(ROOT, JAX_PKG, "native", "astar.cpp"),
                                          "rb") as b:
        assert a.read() == b.read()


@needs_gxx
def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "astar.cpp"
    bad.write_text("extern \"C\" int astar_solve( { not c++\n")
    monkeypatch.setattr(build, "SRC", str(bad))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "LIB", str(tmp_path / "_build" / "libastar.so"))
    with pytest.raises(RuntimeError, match="native A\\* build failed"):
        build.build()
    assert not os.path.exists(build.LIB)


def test_failed_build_never_falls_back_to_python(monkeypatch):
    def broken():
        raise RuntimeError("native A* build failed: g++ refused")

    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_stale", lambda: True)
    monkeypatch.setattr(build, "build", broken)
    grid = np.zeros((4, 4), np.uint8)
    with pytest.raises(RuntimeError, match="build failed"):
        astar_host.reference_path_for(grid, (0, 0, 0), (3, 3, 0), native=True)


def _import_lines(path):
    for i, line in enumerate(open(path), 1):
        s = line.strip()
        if s.startswith(("import ", "from ")):
            yield i, s


def test_port_and_chip_smoke_never_import_jax():
    """No import line of the port or of chip_smoke.py names jax or the JAX
    package (the port's own name contains the JAX package's)."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, PORT)):
        files += [os.path.join(dirpath, f) for f in names if f.endswith(".py")]
    offenders = []
    for path in files:
        for i, s in _import_lines(path):
            words = s.replace(",", " ").split()
            mods = [w for w in words[1:] if w not in ("import", "as")]
            if any(m == "jax" or m.startswith("jax.") or m == JAX_PKG
                   or m.startswith(JAX_PKG + ".") for m in mods):
                offenders.append(f"{path}:{i}: {s}")
    assert not offenders, offenders
    assert len(files) > 40
