"""The import guard: what may not be loaded in a benchmark process.

The benchmark measures the PyTorch port and nothing else. JAX, its
libraries and the JAX package (the port's reference, never benchmarked)
may not be loaded in the process that prints a result. Module names are
compared by their top-level name (the part before the first dot), whole:
the port's own package name begins with the JAX package's, and is
allowed.
"""

from __future__ import annotations

import sys

JAX_PACKAGE = "vehicle_motion_planning_with_obstacles_avoidance_using_mpc_tpu"
PORT_PACKAGE = JAX_PACKAGE + "_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", JAX_PACKAGE)


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top_level(n) in FORBIDDEN)


class GuardError(RuntimeError):
    pass


def check(where: str, modules=None) -> None:
    """Raise :class:`GuardError` naming every forbidden module loaded."""
    bad = forbidden_loaded(modules)
    if bad:
        raise GuardError(f"import guard ({where}): forbidden modules loaded: {', '.join(bad)}")


def reference_imports_port() -> list[str]:
    """The port's modules that a module of the benchmark's reference
    (``portbench.reference``) imports, by the names bound in its globals:
    the reference works everything out again and may import nothing of
    the port."""
    bad = []
    for name, mod in list(sys.modules.items()):
        if not name.startswith("portbench.reference") or mod is None:
            continue
        for value in vars(mod).values():
            owner = getattr(value, "__module__", None) or getattr(value, "__name__", None)
            if isinstance(owner, str) and top_level(owner) == PORT_PACKAGE:
                bad.append(f"{name} -> {owner}")
    return sorted(set(bad))


def reference_sources_naming(ref_dir: str, names=(PORT_PACKAGE, *FORBIDDEN)) -> list[str]:
    """``file: line`` of each import line in the reference's sources that
    names the port, JAX or the JAX package (a static look beside the
    run-time one)."""
    import os
    import re

    pat = re.compile(r"^\s*(from|import)\s+([\w.]+)")
    out = []
    for fn in sorted(os.listdir(ref_dir)):
        if not fn.endswith(".py"):
            continue
        with open(os.path.join(ref_dir, fn)) as f:
            for i, line in enumerate(f, 1):
                m = pat.match(line)
                if m and top_level(m.group(2)) in names:
                    out.append(f"{fn}:{i}")
    return out
