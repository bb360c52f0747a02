"""Cross-process causal trace context on the movement wire.

The port's copy of the JAX package's ``telemetry/tracectx.py`` (over the
port's :mod:`..netutil.packet`).  One client movement batch should show
up as ONE trace across the gate, the dispatcher relay and the game's
ingest, with the wire latency of every hop measurable.  The carrier is a
compact **trailer** appended to relayed movement-sync packets:

    TRACE_WIRE = "<QQQBBH": trace_id u64 | origin_ns u64 | send_ns u64
                            | hop u8 | version u8 | magic u16   (28 bytes)

A trailer (not a header) leaves every reader untouched: the movement
body stays a flat run of 32-byte records, and the trailer is detectable
by structure -- a pure record body has ``remaining % 32 == 0``, a stamped
one ``remaining % 32 == 28`` -- then confirmed by the magic before a byte
is consumed.  Consumption is version-gated: fields are interpreted only
for versions this build knows (``TRACE_WIRE_VERSION``); a newer trailer
is still stripped (so record parsing survives) but its payload ignored.
Callers stamp only while telemetry is enabled, so a telemetry-off
process moves byte-identical packets.

Timestamps are ``time.monotonic_ns()``: CLOCK_MONOTONIC is shared by the
processes of one host, so ``recv_ns - send_ns`` is a real per-hop wire
latency there.  Received hops land in a bounded ring apart from the span
ring; :func:`wire_hops_by_trace` groups them by trace id and
:func:`merge_traces` joins per-process documents into one Chrome trace
whose async rows nest every hop under its trace id.  The wire's users
(gate, dispatcher) are not in the port yet.
"""

from __future__ import annotations

import collections
import itertools
import os
import struct
import threading
import time

from . import trace as _trace

# Versioned wire trailer: the struct name ends in _WIRE with a matching
# _VERSION constant, and every ``.unpack`` consumer sits behind a version
# comparison.
TRACE_WIRE = struct.Struct("<QQQBBH")
TRACE_WIRE_VERSION = 1
TRACE_WIRE_MAGIC = 0x67C7  # 'gC' -- goworld Context
TRACE_WIRE_SIZE = TRACE_WIRE.size  # 28

# Movement-sync stride the structural check is defined against
# (entity_id 16B + SYNC_RECORD tail 16B -- ingest/movement.RECORD_SIZE).
_RECORD_STRIDE = 32

_HOP_RING = 4096


class TraceCtx:
    """A decoded trace context: identity + origin/send stamps + hop."""

    __slots__ = ("trace_id", "origin_ns", "send_ns", "hop", "version")

    def __init__(self, trace_id: int, origin_ns: int, send_ns: int,
                 hop: int, version: int):
        self.trace_id = trace_id
        self.origin_ns = origin_ns
        self.send_ns = send_ns
        self.hop = hop
        self.version = version

    def __repr__(self):
        return (f"TraceCtx({self.trace_id:#018x} hop={self.hop} "
                f"v{self.version})")


_ids = itertools.count(1)


def new_trace_id() -> int:
    """Fresh nonzero 64-bit trace id: random high bits (collision-safe
    across processes) + a local sequence in the low bits (readable)."""
    rnd = int.from_bytes(os.urandom(6), "little")
    return ((rnd << 16) | (next(_ids) & 0xFFFF)) or 1


def now_ns() -> int:
    return time.monotonic_ns()


def stamp(pkt, trace_id: int, hop: int, origin_ns: int | None = None) -> None:
    """Append a trace trailer to ``pkt``.  Callers gate on
    ``telemetry.enabled()`` -- a disabled process must emit byte-identical
    packets."""
    send_ns = time.monotonic_ns()
    if origin_ns is None:
        origin_ns = send_ns
    pkt.buf += TRACE_WIRE.pack(trace_id & 0xFFFFFFFFFFFFFFFF,
                               origin_ns, send_ns, hop & 0xFF,
                               TRACE_WIRE_VERSION, TRACE_WIRE_MAGIC)


def try_strip(pkt, stride: int = _RECORD_STRIDE) -> TraceCtx | None:
    """Detect, remove, and decode a trace trailer from ``pkt``.

    Structural check first (a pure ``stride``-sized record body leaves
    ``remaining % stride == 0``; a stamped one leaves ``TRACE_WIRE_SIZE``),
    then the magic confirms.  Always strips a confirmed trailer --
    otherwise record parsing would read garbage -- but only *interprets*
    versions this build knows.  Must run before any ``read_view`` of the
    body: stripping edits ``pkt.buf`` in place and memoryviews pin it.
    """
    rem = pkt.remaining()
    if rem < TRACE_WIRE_SIZE or rem % stride != TRACE_WIRE_SIZE % stride:
        return None
    tail = bytes(pkt.buf[-TRACE_WIRE_SIZE:])
    trace_id, origin_ns, send_ns, hop, ver, magic = TRACE_WIRE.unpack(tail)
    if magic != TRACE_WIRE_MAGIC:
        return None
    del pkt.buf[-TRACE_WIRE_SIZE:]
    if ver < 1 or ver > TRACE_WIRE_VERSION:
        # versioned consumption: strip (structure must survive) but do
        # not interpret fields from a future layout
        return None
    return TraceCtx(trace_id, origin_ns, send_ns, hop, ver)


# -- received-hop ring --------------------------------------------------------

_hops = collections.deque(maxlen=_HOP_RING)
_hops_lock = threading.Lock()
_current = threading.local()  # last trace id handled on this thread


def _counter():
    # late import avoids a metrics<->package cycle at module import
    from . import counter

    return counter("trace.hops", "wire hops received with a trace context")


def record_hop(ctx: TraceCtx, where: str,
               recv_ns: int | None = None) -> int:
    """Record one received hop; returns the wire latency in ns.  ``where``
    names the receiving stage ("dispatcher.sync", "game.ingest", ...)."""
    if recv_ns is None:
        recv_ns = time.monotonic_ns()
    with _hops_lock:
        _hops.append((ctx.trace_id, ctx.hop, where, ctx.origin_ns,
                      ctx.send_ns, recv_ns))
    _current.trace_id = ctx.trace_id
    _counter().inc()
    return recv_ns - ctx.send_ns


def current_trace_id() -> str | None:
    """Hex id of the trace most recently handled on this thread (None
    before any hop, or while telemetry is disabled).  GW_LOG_JSON log
    lines carry it (utils/gwlog.py)."""
    tid = getattr(_current, "trace_id", None)
    if not tid:
        return None
    from . import enabled  # late: avoids a package<->module import cycle

    return ("%016x" % tid) if enabled() else None


def hops() -> list[tuple]:
    """Snapshot: (trace_id, hop, where, origin_ns, send_ns, recv_ns)."""
    with _hops_lock:
        return list(_hops)


def reset() -> None:
    with _hops_lock:
        _hops.clear()
    # drop the calling thread's log-join id too -- a stale one would leak
    # a trace_id key into GW_LOG_JSON lines long after tracing stopped
    _current.trace_id = None


# -- exposition ---------------------------------------------------------------

def wire_hops_by_trace() -> dict:
    """Hops grouped by hex trace id, each with its wire latency: the
    per-process half of :func:`merge_traces`."""
    out: dict[str, list[dict]] = {}
    pid = os.getpid()
    for tid, hop, where, origin_ns, send_ns, recv_ns in hops():
        out.setdefault("%016x" % tid, []).append({
            "hop": hop, "where": where, "pid": pid,
            "origin_ns": origin_ns, "send_ns": send_ns,
            "recv_ns": recv_ns, "wire_ns": recv_ns - send_ns,
        })
    for hl in out.values():
        hl.sort(key=lambda h: (h["hop"], h["send_ns"]))
    return out


def merge_traces(docs: list[dict]) -> dict:
    """Join per-process documents (each ``{"wireHops":
    wire_hops_by_trace()}``) into one Chrome trace.

    Each document contributes its ``wireHops`` table; hops sharing a
    trace id become one async row (``ph b/e`` pairs keyed ``id=trace_id``)
    so Perfetto nests every hop of a batch under a single id, with an
    ``X`` slice per hop whose duration is the wire latency.  Timestamps
    are CLOCK_MONOTONIC microseconds rebased to the earliest send -- valid
    across processes on one host.
    """
    merged: dict[str, list[dict]] = {}
    for doc in docs:
        for tid, hl in (doc.get("wireHops") or {}).items():
            merged.setdefault(tid, []).extend(hl)
    events: list[dict] = []
    all_ns = [h["send_ns"] for hl in merged.values() for h in hl]
    base = min(all_ns) if all_ns else 0
    for tid in sorted(merged):
        hl = sorted(merged[tid], key=lambda h: (h["hop"], h["send_ns"]))
        lo = min(h["send_ns"] for h in hl)
        hi = max(h["recv_ns"] for h in hl)
        aid = "0x" + tid
        events.append({"name": "trace %s" % tid, "cat": "wire", "ph": "b",
                       "id": aid, "ts": (lo - base) / 1e3,
                       "pid": 0, "tid": 0})
        for h in hl:
            events.append({
                "name": "wire.hop", "cat": "wire", "ph": "X",
                "ts": (h["send_ns"] - base) / 1e3,
                "dur": max(h["wire_ns"], 0) / 1e3,
                "pid": h.get("pid", 0), "tid": h["hop"],
                "args": {"trace_id": tid, "hop": h["hop"],
                         "where": h["where"],
                         "wire_us": h["wire_ns"] / 1e3},
            })
        events.append({"name": "trace %s" % tid, "cat": "wire", "ph": "e",
                       "id": aid, "ts": (hi - base) / 1e3,
                       "pid": 0, "tid": 0})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "byTrace": merged}


def record_local_span(ctx: TraceCtx, name: str) -> None:
    """Bridge a wire context onto the local span ring (a zero-length
    marker is enough for the join; the real timing lives in the hop
    ring).  No-op while tracing is disabled."""
    tr = _trace._TRACER
    if tr is not None:
        t0 = tr.clock()
        tr.record(name, t0, t0)
