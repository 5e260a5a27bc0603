"""Build-on-first-use of the CUDA kernel libraries.

Each ``csrc/*.cu`` source is compiled by its own ``nvcc`` process (all
started together) into a shared library with a plain C interface, then
loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>.so csrc/<name>.cu

No ``--use_fast_math``: a non-SPD block must still give NaN through IEEE
``sqrt`` and division. The build directory ``kernels/_build/`` is listed
in ``.gitignore``; a library is rebuilt when any source is newer than it.
A failed build raises — there is no fallback.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "_build")
SOURCES = ("obca_kkt_provider", "spd_inv", "newton", "step_linesearch", "kkt_qr",
           "astar_wavefront")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}
build_info: dict = {}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _lib_path(name):
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name):
    lib = _lib_path(name)
    if not os.path.exists(lib):
        return True
    newest = max(os.path.getmtime(os.path.join(SRC_DIR, f))
                 for f in os.listdir(SRC_DIR))
    return newest > os.path.getmtime(lib)


def build_all():
    """Compile every stale library, one nvcc per source in parallel.
    Returns ``build_info``: wall seconds and each library's path and
    ptxas report."""
    with _lock:
        stale = [s for s in SOURCES if _stale(s)]
        t0 = time.time()
        if stale:
            os.makedirs(BUILD_DIR, exist_ok=True)
            nvcc = _nvcc()
            procs = {}
            for name in stale:
                cmd = [nvcc, *NVCC_FLAGS, "-o", _lib_path(name),
                       os.path.join(SRC_DIR, f"{name}.cu")]
                procs[name] = subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
            failed = []
            for name, p in procs.items():
                out, _ = p.communicate()
                build_info[name] = {"path": _lib_path(name), "log": out}
                if p.returncode != 0:
                    failed.append(f"--- {name} (rc={p.returncode})\n{out}")
            if failed:
                raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        for name in SOURCES:
            build_info.setdefault(name, {"path": _lib_path(name), "log": ""})
        build_info["seconds"] = time.time() - t0
        return build_info


_SIG = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_void_p]

_ENTRIES = {
    "obca_kkt_provider": ("obca_kkt_provider",),
    "spd_inv": ("spd_inv",),
    "newton": ("newton_assemble", "newton_schur", "newton_al_solve"),
    "step_linesearch": ("step_linesearch",),
    "kkt_qr": ("kkt_qr",),
    "astar_wavefront": ("astar_cost_to_go", "astar_extract_path"),
}


def load(name):
    """The loaded ctypes library of source ``name`` (built if needed)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    if any(_stale(s) for s in SOURCES):
        build_all()
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(_lib_path(name))
            for fn in _ENTRIES[name]:
                f = getattr(lib, fn)
                f.argtypes = _SIG
                f.restype = ctypes.c_int
            lib.vmp_error_string.argtypes = [ctypes.c_int]
            lib.vmp_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]
