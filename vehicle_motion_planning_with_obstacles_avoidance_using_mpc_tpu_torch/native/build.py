"""Build-on-first-use of the native A* library.

Compiles ``astar.cpp`` (this package's own copy of the JAX package's
``native/astar.cpp``) with g++ into ``native/_build/libastar.so``, listed
in ``.gitignore``, and loads it with ``ctypes``; the library is rebuilt
when the source is newer. The flags are the JAX package's
(``-O3 -march=native``, then without ``-march=native`` where that fails).
No pybind11: the interface is plain C. A failed build raises with g++'s
output; nothing falls back to the Python search.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "astar.cpp")
BUILD_DIR = os.path.join(_DIR, "_build")
LIB = os.path.join(BUILD_DIR, "libastar.so")
FLAGS = (["-O3", "-march=native", "-shared", "-fPIC"], ["-O3", "-shared", "-fPIC"])

_lock = threading.Lock()
_lib = None


def _stale() -> bool:
    return not os.path.exists(LIB) or os.path.getmtime(SRC) > os.path.getmtime(LIB)


def build():
    """Compile ``astar.cpp`` into :data:`LIB` (through a temporary file
    renamed into place, so concurrent builds never load a partial one)."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("native A*: g++ not found")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB}.{os.getpid()}.tmp"
    errors = []
    for flags in FLAGS:
        p = subprocess.run([gxx, *flags, "-o", tmp, SRC], capture_output=True, text=True,
                           timeout=120)
        if p.returncode == 0:
            os.replace(tmp, LIB)
            return LIB
        errors.append(f"$ g++ {' '.join(flags)} (rc={p.returncode})\n{p.stderr}")
    raise RuntimeError("native A* build failed:\n" + "\n".join(errors))


def load_native_astar():
    """The loaded library (built first where stale), its two entries
    bound with the JAX package's argtypes."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            lib = ctypes.CDLL(LIB)
            lib.astar_solve.restype = ctypes.c_int
            lib.astar_solve.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
            lib.astar_solve_batch.restype = None
            lib.astar_solve_batch.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
            _lib = lib
        return _lib
