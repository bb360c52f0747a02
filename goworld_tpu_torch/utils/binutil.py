"""Per-process debug HTTP server + daemonize (reference role: engine/binutil
-- pprof/expvar HTTP server on each process, binutil.go:17-47; daemonize,
unix.go).

Endpoints (the Python analog of Go's pprof/expvar surface):

  * ``/debug/vars``    -- gwvar snapshot as JSON (expvar analog)
  * ``/debug/opmon``   -- opmon per-operation stats as JSON
  * ``/debug/metrics`` -- unified telemetry registry, Prometheus text
                          exposition (docs/observability.md)
  * ``/debug/trace``   -- buffered spans as Chrome trace-event JSON
                          (``?ticks=N`` windows to the last N ticks;
                          save the body and load it in Perfetto); carries
                          a ``wireHops`` table so bodies from several
                          processes merge by trace_id
                          (``telemetry.tracectx.merge_traces``)
  * ``/debug/flight``  -- live flight-recorder rings as JSON
                          (docs/observability.md "Flight recorder")
  * ``/debug/stacks``  -- current stack of every thread, plain text
                          (the goroutine-dump analog of /debug/pprof)
  * ``/debug/health``  -- 200 "ok" liveness probe

The port's copy of the JAX package's ``utils/binutil.py``.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

from .. import telemetry
from ..telemetry import flight as gwflight
from ..telemetry import trace as gwtrace
from ..telemetry import tracectx as gwtracectx
from . import gwlog, gwvar, opmon

log = gwlog.logger("binutil")


class _DebugHandler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 (stdlib API)
        path = self.path.split("?", 1)[0]
        if path == "/debug/vars":
            self._json(gwvar.snapshot())
        elif path == "/debug/opmon":
            self._json(opmon.dump())
        elif path == "/debug/metrics":
            self._reply(telemetry.render_prometheus().encode(),
                        "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/debug/trace":
            qs = parse_qs(self.path.partition("?")[2])
            ticks = None
            if qs.get("ticks"):
                try:
                    ticks = max(1, int(qs["ticks"][0]))
                except ValueError:
                    self.send_error(400, "bad ticks param")
                    return
            doc = gwtrace.export_chrome_trace(last_ticks=ticks)
            # cross-process join key: /debug/trace bodies from several
            # components merge by trace_id (tracectx.merge_traces)
            doc["wireHops"] = gwtracectx.wire_hops_by_trace()
            self._json(doc)
        elif path == "/debug/flight":
            self._json(gwflight.state())
        elif path == "/debug/stacks":
            self._text(_format_stacks())
        elif path in ("/debug/health", "/healthz"):
            self._text("ok")
        else:
            self.send_error(404)

    def _json(self, obj):
        body = json.dumps(obj, indent=1, default=str).encode()
        self._reply(body, "application/json")

    def _text(self, s: str):
        self._reply(s.encode(), "text/plain; charset=utf-8")

    def _reply(self, body: bytes, ctype: str):
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet by default
        pass


def _format_stacks() -> str:
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        out.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
    return "\n".join(out) + "\n"


def setup_http_server(port: int, host: str = "127.0.0.1"):
    """Start the debug HTTP server in a daemon thread; returns the server
    (``.server_address`` carries the bound port when ``port`` is 0 =
    ephemeral).  Callers gate on config: http_port 0 in the ini means
    disabled, so components only call this for a configured port."""
    srv = ThreadingHTTPServer((host, port), _DebugHandler)
    srv.daemon_threads = True
    threading.Thread(
        target=srv.serve_forever, name="debug-http", daemon=True
    ).start()
    gwvar.set_var("debug_http_addr", "%s:%d" % srv.server_address[:2])
    log.info("debug http server on %s:%d", *srv.server_address[:2])
    return srv


def daemonize():
    """Classic unix double-fork detach (reference: binutil daemonize)."""
    if os.name != "posix":
        raise OSError("daemonize is only supported on posix")
    if os.fork() > 0:
        os._exit(0)
    os.setsid()
    if os.fork() > 0:
        os._exit(0)
    devnull = os.open(os.devnull, os.O_RDWR)
    for fd in (0, 1, 2):
        os.dup2(devnull, fd)
