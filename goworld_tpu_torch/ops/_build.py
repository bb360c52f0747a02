"""Build the port's CUDA sources and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
``build/goworld_tpu_torch/lib<name>.so`` (relative to the repository
root, listed in ``.gitignore``) with::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so <name>.cu

The sources expose a plain C interface (no PyTorch headers), so a build
takes seconds; they may include the shared headers ``csrc/*.cuh``, and a
change to one rebuilds every source.  ``--use_fast_math`` is never passed: its flush-to-zero
changes the AOI predicate on subnormal inputs.  :func:`build_all` starts
one ``nvcc`` per source, all together, and waits for every one.  Nothing
here runs at import time; the CPU never builds.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "goworld_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# compiler output of the last build of each source (ptxas register and
# shared-memory report); chip_smoke.py prints it
build_log: dict[str, str] = {}


def sources() -> list[str]:
    """Names of the CUDA sources (``csrc/<name>.cu``), sorted."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def _so_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _fresh(name: str) -> bool:
    """The library is newer than its source and every shared header."""
    so = _so_path(name)
    deps = [f"{name}.cu"] + [f for f in os.listdir(CSRC_DIR)
                             if f.endswith(".cuh")]
    return os.path.exists(so) and os.path.getmtime(so) >= max(
        os.path.getmtime(os.path.join(CSRC_DIR, f)) for f in deps)


def build_all(force: bool = False) -> dict[str, str]:
    """Compile every stale source in parallel (one ``nvcc`` each, started
    together).  Raises with the compiler's output when any build fails.
    Returns the paths of all libraries."""
    with _lock:
        names = sources()
        todo = [n for n in names if force or not _fresh(n)]
        if todo:
            nvcc = _nvcc()
            os.makedirs(BUILD_DIR, exist_ok=True)
            procs = {}
            for n in todo:
                tmp = _so_path(n) + f".tmp{os.getpid()}"
                cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                       os.path.join(CSRC_DIR, f"{n}.cu")]
                procs[n] = (tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            failed = []
            for n, (tmp, p) in procs.items():
                out, _ = p.communicate()
                build_log[n] = out
                if p.returncode != 0:
                    if os.path.exists(tmp):
                        os.remove(tmp)
                    failed.append(f"--- {n}.cu (nvcc exit {p.returncode})\n"
                                  f"{out}")
                else:
                    os.replace(tmp, _so_path(n))
                    _libs.pop(n, None)
            if failed:
                raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
        return {n: _so_path(n) for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if
    needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    paths = build_all()
    if name not in paths:
        raise KeyError(f"no CUDA source csrc/{name}.cu")
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(paths[name])
            _libs[name] = lib
    return lib
