"""Crash isolation: run a user callback so one bad hook cannot kill the
process (the port's copy of the JAX package's ``utils/gwutils.py``)."""

from __future__ import annotations

import traceback
from typing import Callable


def run_panicless(fn: Callable, *args, logger=None, **kwargs):
    """Run fn, swallowing (and logging) any exception.  Returns (ok, result)."""
    try:
        return True, fn(*args, **kwargs)
    except Exception:
        if logger is not None:
            logger.error("panic in %r:\n%s", fn, traceback.format_exc())
        else:
            traceback.print_exc()
        return False, None


def repeat_until_panicless(fn: Callable, *args, logger=None, **kwargs):
    """Re-run fn until it returns without raising (service main loops)."""
    while True:
        ok, result = run_panicless(fn, *args, logger=logger, **kwargs)
        if ok:
            return result
