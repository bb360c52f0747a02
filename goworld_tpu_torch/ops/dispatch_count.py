"""Test-visible counter of device dispatches, and of capture keys.

Port of the JAX package's ``ops/dispatch_count.py``.  A dispatch means
what it means there: one program that the host enqueues.  In the port a
program is one step of the bucket (the kernel with its mask and
compaction), one delta scatter (:mod:`.aoi_stage`), one maintenance
pass, or one replay of a captured CUDA graph (:mod:`.fused`).  The
unfused delta-staged tick of the single-device bucket counts 2 (the
scatter and the step), a fused tick 1 (the replay); each shard of the
sharded buckets counts its own step and scatter.  Transfers (uploads,
the count and triple copies to the host) are not dispatches.

``record_key`` notes the key a launch site compiles or captures under
(the fused tick's graph key), so a test can pin "no new captures in the
steady state" with :func:`reset_keys` / :func:`new_keys`.

Pure host integers: nothing here touches the device.
"""

from __future__ import annotations

_n = 0
_keys: set = set()
_new_keys = 0


def record(n=1):
    """Count ``n`` dispatches (call beside the launch)."""
    global _n
    _n += n


def read():
    """Dispatches recorded since the last :func:`reset`."""
    return _n


def reset():
    """Zero the counter."""
    global _n
    _n = 0


def record_key(site: str, key) -> bool:
    """Record the key a launch site is about to compile or capture under.
    Returns True when ``(site, key)`` is new since the last
    :func:`clear_keys` (this call builds a program)."""
    global _new_keys
    k = (site, key)
    if k in _keys:
        return False
    _keys.add(k)
    _new_keys += 1
    return True


def new_keys() -> int:
    """Fresh keys seen since the last :func:`reset_keys`."""
    return _new_keys


def reset_keys():
    """Zero the new-key counter, keeping the seen set (the warm-up /
    measure bracket)."""
    global _new_keys
    _new_keys = 0


def clear_keys():
    """Forget every seen key."""
    global _new_keys
    _keys.clear()
    _new_keys = 0
