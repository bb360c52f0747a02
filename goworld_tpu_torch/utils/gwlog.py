"""Leveled logging with per-component source tags.

The port's copy of the JAX package's ``utils/gwlog.py``: stdlib logging
used as ``gwlog.logger("game1").info(...)``, the level from config,
optional file output, and a parseable readiness tag.

``setup(json_lines=True)`` (or ``GW_LOG_JSON=1``) switches to one JSON
record per line -- ts/level/component/msg -- so logs are machine-parseable
next to the metrics.  When telemetry is live a line also carries ``span``
(the innermost open ``trace.span`` on the logging thread) and
``trace_id`` (the wire trace most recently handled there).  The readiness
line stays greppable either way: ``READY_TAG`` rides inside ``msg``."""

from __future__ import annotations

import json
import logging
import os
import sys

# a supervisor's start barrier greps for this tag
READY_TAG = "COMPONENT_READY"

_configured = False


class _JsonLinesFormatter(logging.Formatter):
    """One compact JSON object per record: ts (unix seconds), level,
    component (the ``gw.<tag>`` logger name), msg.  Keys are sorted so the
    line layout is stable for downstream parsers."""

    def format(self, record: logging.LogRecord) -> str:
        doc = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "component": record.name,
            "msg": record.getMessage(),
        }
        # tracing correlation keys, only when they exist: the active span
        # and the wire trace id this thread last handled.  Late import --
        # gwlog must stay importable before the telemetry package.
        try:
            from ..telemetry import trace as _trace
            from ..telemetry import tracectx as _tracectx

            span = _trace.current_span()
            if span:
                doc["span"] = span
            tid = _tracectx.current_trace_id()
            if tid:
                doc["trace_id"] = tid
        except Exception:
            pass
        return json.dumps(doc, sort_keys=True, separators=(",", ":"),
                          default=str)


def setup(level: str = "info", logfile: str | None = None,
          json_lines: bool | None = None):
    global _configured
    if json_lines is None:
        json_lines = os.environ.get("GW_LOG_JSON", "") in ("1", "true", "yes")
    root = logging.getLogger("gw")
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    root.handlers.clear()
    handler = (
        logging.FileHandler(logfile) if logfile else logging.StreamHandler(sys.stderr)
    )
    handler.setFormatter(
        _JsonLinesFormatter()
        if json_lines
        else logging.Formatter(
            "%(asctime)s %(levelname).1s %(name)s: %(message)s", "%H:%M:%S"
        )
    )
    root.addHandler(handler)
    _configured = True


def logger(tag: str) -> logging.Logger:
    if not _configured:
        setup()
    return logging.getLogger(f"gw.{tag}")


def announce_ready(tag: str, component: str):
    """Emit the supervisor-parseable readiness line."""
    logger(tag).info("%s %s", READY_TAG, component)
