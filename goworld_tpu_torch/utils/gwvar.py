"""Process-wide published variables (reference role: engine/gwvar -- expvar
flags like ``IsDeploymentReady`` served on the debug HTTP port, gwvar.go:5-29).

Vars are JSON-serializable values behind a lock; :func:`snapshot` is what the
debug server's ``/debug/vars`` endpoint returns.

The port's copy of the JAX package's ``utils/gwvar.py``.
"""

from __future__ import annotations

import threading
from typing import Any

_lock = threading.Lock()
_vars: dict[str, Any] = {}


def set_var(name: str, value: Any) -> None:
    with _lock:
        _vars[name] = value


def get_var(name: str, default: Any = None) -> Any:
    with _lock:
        return _vars.get(name, default)


def add(name: str, delta: int | float = 1):
    with _lock:
        _vars[name] = _vars.get(name, 0) + delta


def snapshot() -> dict[str, Any]:
    with _lock:
        return dict(_vars)


def reset() -> None:
    with _lock:
        _vars.clear()
