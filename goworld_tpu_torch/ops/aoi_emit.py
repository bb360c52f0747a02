"""Event emit fan-out: fetched triples -> replay-ready sorted pairs.

Port of the JAX package's ``ops/aoi_emit.py``, in its three modes:

  * ``native`` -- the shared C++ library ``native/libgwemit.so`` (at the
    repository root, built by ``native/Makefile``), loaded here through
    the port's own ctypes loader;
  * ``vector`` -- the NumPy argsort path;
  * ``host``   -- the per-word host decode: the triples are folded back
    into their classified word stream (:func:`..ops.events.
    triples_to_words`) and expanded with :func:`..ops.events.
    expand_classified_host`.  It is the bit-exact oracle of the other
    two and the target of the ``aoi.emit`` fault seam's demotion.

All three give the same (space, observer, observed) order: one integer
sort key, unique within a tick.  The sharded buckets decode word streams
every tick and expand them with :func:`expand_words_native` in ``native``
mode, with the numpy expansion otherwise.  Everything here is
harvest-phase numpy on already-fetched arrays.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from .aoi_predicate import words_per_row

EMIT_MODES = ("native", "vector", "host")
# stats["emit_path"] levels, as in the JAX package: higher is more demoted
EMIT_LEVEL = {"native": 0, "vector": 1, "host": 2}

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_SO_PATH = os.path.join(_NATIVE_DIR, "libgwemit.so")
_lib = None
_tried = False
_build_lock = threading.Lock()


def _load():
    """The fan-out library, building it with ``make`` on first use; None
    when there is no toolchain."""
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
                    ["make", "-C", _NATIVE_DIR, "-s", "libgwemit.so"],
                    check=True, capture_output=True, timeout=120,
                )
            except (OSError, subprocess.SubprocessError):
                return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.gwemit_fanout.restype = ctypes.c_int64
        lib.gwemit_fanout.argtypes = [
            i32p, ctypes.c_int64, ctypes.c_int32, i32p, i32p,
            ctypes.POINTER(ctypes.c_int64),
        ]
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.gwemit_count.restype = ctypes.c_int64
        lib.gwemit_count.argtypes = [u32p, ctypes.c_int64]
        lib.gwemit_words.restype = ctypes.c_int64
        lib.gwemit_words.argtypes = [
            u32p, u32p, i64p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, i32p, ctypes.c_int64, i32p, ctypes.c_int64,
            i64p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def resolve_mode(requested: str | None) -> str:
    """Resolve an ``aoi_emit`` request to a concrete mode: ``auto`` (the
    default) is ``native`` when libgwemit loads, else ``vector``; an
    explicit ``native`` also becomes ``vector`` without the library (mode
    selection must never make an engine unconstructable)."""
    if requested is None or requested == "auto":
        return "native" if available() else "vector"
    if requested not in EMIT_MODES:
        raise ValueError(
            f"aoi_emit must be one of {('auto',) + EMIT_MODES}, "
            f"got {requested!r}")
    if requested == "native" and not available():
        return "vector"
    return requested


def fanout_triples(tri, capacity: int, native: bool = True):
    """VALID (obs, observed, kind) triples [n, 3] int32 (obs = global
    observer row ``s * capacity + i``) -> (enter [K, 3], leave [L, 3])
    int32 (space, observer, observed) rows, each sorted lexicographically.
    ``native=False`` forces the NumPy path (the ``vector`` mode)."""
    n = len(tri)
    if n == 0:
        e = np.empty((0, 3), np.int32)
        return e, e
    lib = _load() if native else None
    if lib is not None:
        t = np.ascontiguousarray(tri, np.int32)
        enter = np.empty((n, 3), np.int32)
        leave = np.empty((n, 3), np.int32)
        nl = ctypes.c_int64(0)
        ne = lib.gwemit_fanout(
            _ptr(t, ctypes.c_int32), n, capacity,
            _ptr(enter, ctypes.c_int32), _ptr(leave, ctypes.c_int32),
            ctypes.byref(nl),
        )
        if ne < 0:
            raise RuntimeError("gwemit_fanout rejected the triples")
        return enter[:ne].copy(), leave[:nl.value].copy()
    obs = tri[:, 0].astype(np.int64)
    key = obs * capacity + tri[:, 1]
    out = np.empty((n, 3), np.int32)
    out[:, 0] = obs // capacity
    out[:, 1] = obs % capacity
    out[:, 2] = tri[:, 1]
    order = np.argsort(key)  # keys unique per tick: any sort is the order
    out = out[order]
    ent = tri[order, 2] == 1
    return (np.ascontiguousarray(out[ent]),
            np.ascontiguousarray(out[~ent]))


def expand_words_native(chg_vals, ent_vals, gidx, capacity: int):
    """Classified word stream (``chg`` words, their enter subsets ``chg &
    new``, flat word indices over [s, capacity, W] grids) -> (enter
    [K, 3], leave [L, 3]) int32 (space, observer, observed) rows, each
    sorted lexicographically: the bit expansion, partition and sort in
    C++, equal to :func:`..ops.events.expand_classified_host`.  Raises
    when the library is missing or rejects the stream."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libgwemit.so unavailable")
    cv = np.ascontiguousarray(chg_vals, np.uint32)
    ev = np.ascontiguousarray(ent_vals, np.uint32)
    gi = np.ascontiguousarray(gidx, np.int64)
    n = len(cv)
    if n == 0:
        e = np.empty((0, 3), np.int32)
        return e, e
    total = lib.gwemit_count(_ptr(cv, ctypes.c_uint32), n)
    enter = np.empty((total, 3), np.int32)
    leave = np.empty((total, 3), np.int32)
    nl = ctypes.c_int64(0)
    ne = lib.gwemit_words(
        _ptr(cv, ctypes.c_uint32), _ptr(ev, ctypes.c_uint32),
        _ptr(gi, ctypes.c_int64), n, capacity, words_per_row(capacity),
        _ptr(enter, ctypes.c_int32), total,
        _ptr(leave, ctypes.c_int32), total, ctypes.byref(nl),
    )
    if ne < 0:
        raise RuntimeError("gwemit_words rejected the word stream")
    return enter[:ne].copy(), leave[:nl.value].copy()
