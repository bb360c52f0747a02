"""Black-box flight recorder: what was this process doing when it died?

The port's copy of the JAX package's ``telemetry/flight.py``.  Every
process keeps a small always-on ring of recent activity -- fault-seam
firings, packet headers, free-form notes (failovers, SLO breaches),
metric deltas -- in plain deques, with telemetry on or off (the crash
most worth explaining is the one in an un-instrumented build).  On a
trigger the rings dump as one JSON document to the flight directory:

* any ``clu.*`` fault-seam firing (hooked in :mod:`..faults`);
* an SLO breach: a tick over the ``GW_TICK_BUDGET_MS`` budget
  (``engine/runtime.py``);
* SIGTERM (installed when a flight dir is configured from the main
  thread);
* a periodic heartbeat every ``GW_FLIGHT_INTERVAL_S`` seconds -- the only
  way a SIGKILLed process leaves a body behind.

The flight directory comes from ``GW_FLIGHT_DIR`` or from
:func:`configure`.  No directory -> ``dump`` returns None and the
recorder costs a few deque appends.  Dumps are written atomically (tmp +
rename), so a reader never sees a torn file.  ``python -m
goworld_tpu_torch.telemetry.flight DUMP.json`` renders a dump as a
Chrome trace (:func:`to_chrome`).
"""

from __future__ import annotations

import collections
import json
import os
import signal
import threading
import time

_FAULT_RING = 64
_PACKET_RING = 128
_NOTE_RING = 128

_lock = threading.Lock()
_faults = collections.deque(maxlen=_FAULT_RING)
_packets = collections.deque(maxlen=_PACKET_RING)
_notes = collections.deque(maxlen=_NOTE_RING)
_dir: str | None = os.environ.get("GW_FLIGHT_DIR") or None
_component: str = ""
_seq = 0
_dumps = 0
_last_metrics: dict = {}
_interval_thread: threading.Thread | None = None
_sigterm_installed = False
_prev_sigterm = None


def _counter():
    from . import counter

    return counter("flight.dumps", "flight-recorder dumps written")


def configure(dir: str | None = None, component: str | None = None) -> None:
    """Point the recorder at a dump directory and/or name the component.
    The first directory wins: ``GW_FLIGHT_DIR`` (applied at import, the
    ops override) beats a default a component passes later.  Starts the periodic heartbeat (``GW_FLIGHT_INTERVAL_S``)
    and installs the SIGTERM hook once a directory exists."""
    global _dir, _component
    if component is not None:
        _component = component
    if dir is not None and not _dir:
        _dir = dir
    if _dir:
        _maybe_start_interval()
        install_sigterm()


def flight_dir() -> str | None:
    return _dir


# -- recording ---------------------------------------------------------------

def note_fault(fired: dict) -> None:
    """Hooked from ``faults.FaultPlan._hit``: every taken fault lands
    here; ``clu.*`` seams additionally trigger a dump (the cluster seams
    are the ones whose post-mortems matter across processes)."""
    entry = dict(fired)
    entry["ns"] = time.monotonic_ns()
    with _lock:
        _faults.append(entry)
    if _dir and str(fired.get("seam", "")).startswith("clu."):
        dump("fault:%s" % fired["seam"])


def note_packet(direction: str, msgtype: int, nbytes: int) -> None:
    with _lock:
        _packets.append((time.monotonic_ns(), direction, msgtype, nbytes))


def note(kind: str, **fields) -> None:
    entry = {"kind": kind, "ns": time.monotonic_ns()}
    entry.update(fields)
    with _lock:
        _notes.append(entry)


def slo_breach(tick: int, dur_ms: float, budget_ms: float) -> str | None:
    """A tick blew its budget: record it and dump (rate-limited by the
    caller's budget check being per-tick anyway)."""
    note("slo.tick_budget", tick=tick, dur_ms=round(dur_ms, 3),
         budget_ms=budget_ms)
    return dump("slo:tick%d" % tick)


# -- dumping -----------------------------------------------------------------

def state(span_tail: int = 256) -> dict:
    """The live black box as one JSON-able document."""
    from . import snapshot
    from . import trace as _trace
    from . import tracectx as _tcx

    metrics_now = {}
    try:
        metrics_now = {k: v for k, v in snapshot().items()
                       if isinstance(v, (int, float))}
    except Exception:
        pass
    global _last_metrics
    with _lock:
        deltas = {k: v - _last_metrics.get(k, 0.0)
                  for k, v in metrics_now.items()
                  if v != _last_metrics.get(k, 0.0)}
        _last_metrics = metrics_now
        doc = {
            "pid": os.getpid(),
            "component": _component,
            "wall_time": time.time(),
            "monotonic_ns": time.monotonic_ns(),
            "faults": list(_faults),
            "packets": [{"ns": ns, "dir": d, "msgtype": mt, "bytes": nb}
                        for ns, d, mt, nb in _packets],
            "notes": list(_notes),
            "metric_deltas": deltas,
            "metrics": metrics_now,
            "dumps": _dumps,
        }
    doc["spans"] = [{"name": nm, "tid": tid, "t0": t0, "t1": t1}
                    for nm, tid, t0, t1 in _trace.spans()[-span_tail:]]
    doc["wire_hops"] = _tcx.wire_hops_by_trace()
    return doc


def dump(reason: str) -> str | None:
    """Write the black box to the flight dir; returns the path (None when
    no dir is configured).  Never raises -- the recorder must not take
    down the process it is documenting."""
    global _seq, _dumps
    d = _dir
    if not d:
        return None
    try:
        os.makedirs(d, exist_ok=True)
        with _lock:
            _seq += 1
            seq = _seq
        doc = state()
        doc["reason"] = reason
        who = _component or ("pid%d" % os.getpid())
        safe = "".join(c if c.isalnum() or c in "._-" else "_"
                       for c in reason)[:48]
        path = os.path.join(d, "flight_%s_%04d_%s.json" % (who, seq, safe))
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        # stable per-process pointer: readers that only know the
        # component find the freshest dump without sorting
        latest = os.path.join(d, "flight_%s_latest.json" % who)
        try:
            tmp2 = latest + ".tmp"
            with open(tmp2, "w", encoding="utf-8") as fh:
                json.dump(doc, fh)
            os.replace(tmp2, latest)
        except OSError:
            pass
        with _lock:
            _dumps += 1
        _counter().inc()
        return path
    except Exception:
        return None


def reset() -> None:
    """Test hook: clear rings and counters (not the configured dir)."""
    global _seq, _dumps, _last_metrics
    with _lock:
        _faults.clear()
        _packets.clear()
        _notes.clear()
        _seq = 0
        _dumps = 0
        _last_metrics = {}


# -- triggers ----------------------------------------------------------------

def _maybe_start_interval() -> None:
    global _interval_thread
    try:
        interval = float(os.environ.get("GW_FLIGHT_INTERVAL_S", "0") or 0)
    except ValueError:
        interval = 0.0
    if interval <= 0 or _interval_thread is not None:
        return

    def _beat():
        # dump-first: the moment the heartbeat is armed there is a body
        # on disk, so even a SIGKILL inside the first interval leaves a
        # post-mortem behind
        while True:
            dump("interval")
            time.sleep(interval)

    _interval_thread = threading.Thread(target=_beat, name="flight-beat",
                                        daemon=True)
    _interval_thread.start()


def install_sigterm() -> bool:
    """Chain a SIGTERM hook that dumps before the previous disposition
    runs.  Only possible from the main thread (signal API contract);
    callers on other threads just skip it."""
    global _sigterm_installed, _prev_sigterm
    if _sigterm_installed:
        return True
    if threading.current_thread() is not threading.main_thread():
        return False

    def _on_term(signum, frame):
        dump("sigterm")
        prev = _prev_sigterm
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

    try:
        _prev_sigterm = signal.signal(signal.SIGTERM, _on_term)
    except (ValueError, OSError):
        return False
    _sigterm_installed = True
    return True


# -- loader ------------------------------------------------------------------

def load(path: str) -> dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def to_chrome(doc: dict) -> dict:
    """Render a flight dump as Chrome trace-event JSON: spans as slices,
    faults/notes/packets as instants -- the black box on a timeline."""
    pid = doc.get("pid", 0)
    events: list[dict] = [
        {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": "flight:%s" % (doc.get("component") or pid)}}]
    spans = doc.get("spans") or []
    bases = [s["t0"] for s in spans]
    base_s = min(bases) if bases else 0.0
    for s in spans:
        events.append({"name": s["name"], "cat": "span", "ph": "X",
                       "ts": round((s["t0"] - base_s) * 1e6, 3),
                       "dur": round((s["t1"] - s["t0"]) * 1e6, 3),
                       "pid": pid, "tid": s.get("tid", 0)})
    ns_stamps = ([f["ns"] for f in doc.get("faults", [])]
                 + [n["ns"] for n in doc.get("notes", [])]
                 + [p["ns"] for p in doc.get("packets", [])])
    base_ns = min(ns_stamps) if ns_stamps else 0
    for f in doc.get("faults", []):
        events.append({"name": "fault %s" % f.get("seam"), "cat": "fault",
                       "ph": "i", "s": "p",
                       "ts": (f["ns"] - base_ns) / 1e3,
                       "pid": pid, "tid": 0, "args": f})
    for n in doc.get("notes", []):
        events.append({"name": n.get("kind", "note"), "cat": "note",
                       "ph": "i", "s": "p",
                       "ts": (n["ns"] - base_ns) / 1e3,
                       "pid": pid, "tid": 0, "args": n})
    for p in doc.get("packets", []):
        events.append({"name": "pkt mt=%d" % p["msgtype"], "cat": "pkt",
                       "ph": "i", "s": "t",
                       "ts": (p["ns"] - base_ns) / 1e3,
                       "pid": pid, "tid": 1, "args": p})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="render a flight-recorder dump as a Chrome trace")
    ap.add_argument("dump", help="flight_*.json written by the recorder")
    ap.add_argument("-o", "--out", default=None,
                    help="output path (default: stdout)")
    args = ap.parse_args(argv)
    doc = to_chrome(load(args.dump))
    text = json.dumps(doc)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(text)
    else:
        print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
