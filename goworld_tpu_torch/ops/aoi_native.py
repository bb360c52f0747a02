"""The production host calculator of the port: the native C++ AOI sweep.

The port's counterpart of the JAX package's ``ops/aoi_native.py``: the
shared library ``native/libgwaoi.so`` (at the repository root, built by
``native/Makefile``; ``native/`` belongs to both packages) loaded through
the port's own ctypes loader.  It evaluates the exact predicate of
:mod:`.aoi_predicate` and is bit-exact with :class:`.aoi_oracle.
CPUAOIOracle` and with the device step.  The engine routes small spaces
here (``aoi_backend="cpp"``, or ``"auto"`` below the CUDA capacity
threshold): a space that small finishes on the host in microseconds.

The library builds with ``make`` on first use; ``GW_SANITIZED_NATIVE=1``
loads its ASAN+UBSAN build (``make sanitize``) instead.
:func:`available` says whether it loaded; without it the engine warns and
runs the numpy oracle.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from . import aoi_predicate as P

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_SO_NAME = ("libgwaoi.san.so"
            if os.environ.get("GW_SANITIZED_NATIVE") == "1"
            else "libgwaoi.so")
_SO_PATH = os.path.join(_NATIVE_DIR, _SO_NAME)
_lib = None
_tried = False
_build_lock = threading.Lock()


def _load():
    """The calculator library, building it with ``make`` on first use;
    None when there is no toolchain."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _build_lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO_PATH):
            try:
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR, "-s", _SO_NAME],
                    check=True, capture_output=True, timeout=120,
                )
            except (OSError, subprocess.SubprocessError):
                return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.gwaoi_step.restype = ctypes.c_int64
        lib.gwaoi_step.argtypes = [
            f32p, f32p, f32p, u8p, ctypes.c_int32, u32p,
            i32p, ctypes.c_int64, i32p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# candidate enumeration of the library: "sweep" (the sorted-x window
# scan), "grid" (uniform cell binning, faster at high density), "auto"
# (grid when the layout supports it, else sweep); all bit-exact
_ALGOS = {"auto": 0, "sweep": 1, "grid": 2}


class NativeAOIOracle:
    """:class:`.aoi_oracle.CPUAOIOracle`'s interface over libgwaoi."""

    def __init__(self, capacity: int, algorithm: str = "auto"):
        self.capacity = P.round_capacity(capacity)
        self.W = P.words_per_row(self.capacity)
        self.prev_words = np.zeros((self.capacity, self.W), np.uint32)
        self._algo = _ALGOS.get(algorithm, 0)
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("libgwaoi.so unavailable (no C++ toolchain?); "
                               "use the numpy oracle instead")
        # event buffers grow on overflow (a -1 return)
        self._cap_pairs = 4096

    def reset(self) -> None:
        self.prev_words[:] = 0

    def _padded(self, a, dtype):
        a = np.ascontiguousarray(a, dtype)
        if a.shape[0] > self.capacity:
            raise ValueError(
                f"{a.shape[0]} entities exceed capacity {self.capacity}")
        if a.shape[0] < self.capacity:
            a = np.concatenate(
                [a, np.zeros(self.capacity - a.shape[0], dtype)])
        return a

    def step(self, x, z, radius, active):
        """Advance one tick; returns (enter_pairs, leave_pairs) int32
        [K, 2], each sorted lexicographically."""
        x = self._padded(x, np.float32)
        z = self._padded(z, np.float32)
        radius = self._padded(radius, np.float32)
        act = self._padded(np.asarray(active, bool), np.uint8)
        prev = np.ascontiguousarray(self.prev_words)
        while True:
            enter = np.empty((self._cap_pairs, 2), np.int32)
            leave = np.empty((self._cap_pairs, 2), np.int32)
            n_leave = ctypes.c_int64(0)
            ne = self._lib.gwaoi_step(
                _ptr(x, ctypes.c_float), _ptr(z, ctypes.c_float),
                _ptr(radius, ctypes.c_float), _ptr(act, ctypes.c_uint8),
                self.capacity, _ptr(prev, ctypes.c_uint32),
                _ptr(enter, ctypes.c_int32), self._cap_pairs,
                _ptr(leave, ctypes.c_int32), self._cap_pairs,
                ctypes.byref(n_leave), self._algo,
            )
            if ne < 0:
                self._cap_pairs *= 4
                continue
            self.prev_words = prev
            return enter[:ne].copy(), leave[: n_leave.value].copy()
