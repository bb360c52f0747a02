"""The port's cluster tracing, flight recorder and federated metrics
against the JAX package's (tests/test_cluster_trace.py's scenarios on
goworld_tpu_torch): the 28-byte trace trailer (structural detection,
magic confirm, version-gated interpretation), hop records, the merged
Chrome trace, the flight recorder's triggers (``clu.*`` faults, the
``GW_TICK_BUDGET_MS`` budget, the ``GW_FLIGHT_INTERVAL_S`` heartbeat
that survives a kill -9, the ``GW_FLIGHT_DIR`` override), ``gwlog``'s
JSON context, the dispatcher's ``clu.metric_sources`` federation and the
``accelerator_absent`` gauge.  The trailer's bytes are held equal both
ways: one stamp in each package on one clock gives the same bytes, and
each package strips and reads the other's.  The four bench-gate tests
read the JAX package's bench history and have no twin here."""

from __future__ import annotations

import glob
import os
import struct
import time

import pytest
from torch_threads import one_intra_op_thread  # noqa: F401

from goworld_tpu_torch import config, telemetry
from goworld_tpu_torch.netutil.packet import Packet
from goworld_tpu_torch.telemetry import flight, tracectx


@pytest.fixture
def clean_telemetry():
    telemetry.disable()
    tracectx.reset()
    flight.reset()
    yield
    telemetry.disable()
    tracectx.reset()
    flight.reset()


@pytest.fixture
def flight_dir(tmp_path, monkeypatch):
    """Point the recorder at a fresh dir for one test (the module keeps
    process-global first-dir-wins state)."""
    d = tmp_path / "flight"
    monkeypatch.setattr(flight, "_dir", str(d))
    monkeypatch.setattr(flight, "_component", "t1")
    flight.reset()
    yield str(d)
    flight.reset()


def _records_packet(n_records: int) -> Packet:
    p = Packet()
    p.append_bytes(b"\x00" * (32 * n_records))
    return p


# -- trace-context trailer ---------------------------------------------------


def test_trace_trailer_round_trip(clean_telemetry):
    p = _records_packet(3)
    tracectx.stamp(p, 0xABC, hop=0)
    assert p.remaining() % 32 == tracectx.TRACE_WIRE_SIZE % 32
    ctx = tracectx.try_strip(p)
    assert ctx is not None
    assert (ctx.trace_id, ctx.hop, ctx.version) == (0xABC, 0, 1)
    assert ctx.send_ns >= ctx.origin_ns > 0
    # trailer fully removed: the flat record body is intact
    assert p.remaining() == 96 and p.remaining() % 32 == 0


def test_trace_trailer_absent_leaves_packet_untouched(clean_telemetry):
    p = _records_packet(2)
    before = bytes(p.buf)
    assert tracectx.try_strip(p) is None
    assert bytes(p.buf) == before


def test_trace_trailer_bad_magic_not_stripped(clean_telemetry):
    p = _records_packet(1)
    p.append_bytes(tracectx.TRACE_WIRE.pack(1, 2, 3, 0,
                                            tracectx.TRACE_WIRE_VERSION,
                                            0xDEAD))
    before = bytes(p.buf)
    assert tracectx.try_strip(p) is None
    assert bytes(p.buf) == before


def test_trace_trailer_future_version_stripped_not_interpreted(
        clean_telemetry):
    """A newer TRACE_WIRE_VERSION is structurally removed (record parsing
    must survive a rolling restart) but its fields are never consumed --
    the versioned-consumption half of the gwlint telemetry wire rule."""
    p = _records_packet(2)
    p.append_bytes(tracectx.TRACE_WIRE.pack(
        7, 1, 2, 0, tracectx.TRACE_WIRE_VERSION + 1,
        tracectx.TRACE_WIRE_MAGIC))
    assert tracectx.try_strip(p) is None
    assert p.remaining() == 64  # stripped anyway


def test_trace_trailer_is_28_bytes_forever():
    # the structural detection (rem % stride == 28 % stride) depends on it
    assert tracectx.TRACE_WIRE_SIZE == 28
    assert tracectx.TRACE_WIRE.size == struct.calcsize("<QQQBBH")


def test_record_hop_feeds_ring_counter_and_log_context(clean_telemetry):
    telemetry.enable()
    p = _records_packet(1)
    tracectx.stamp(p, 0x55AA, hop=1)
    ctx = tracectx.try_strip(p)
    lat = tracectx.record_hop(ctx, "game.ingest")
    assert lat >= 0
    assert telemetry.snapshot().get("trace.hops", 0) >= 1
    # the thread-local id GW_LOG_JSON lines join on
    assert tracectx.current_trace_id() == "%016x" % 0x55AA
    hops = tracectx.wire_hops_by_trace()["%016x" % 0x55AA]
    assert hops[0]["where"] == "game.ingest" and hops[0]["hop"] == 1


def test_merge_traces_builds_async_rows_with_wire_hop_slices(
        clean_telemetry):
    telemetry.enable()
    for hop, where in ((0, "dispatcher.sync"), (1, "game.ingest")):
        p = _records_packet(1)
        tracectx.stamp(p, 0xF00D, hop=hop)
        tracectx.record_hop(tracectx.try_strip(p), where)
    doc = {"wireHops": tracectx.wire_hops_by_trace()}
    merged = tracectx.merge_traces([doc])
    # the JAX package merges the port's document into the same rows
    from goworld_tpu.telemetry import tracectx as jax_tracectx

    assert merged == jax_tracectx.merge_traces([doc])
    evs = merged["traceEvents"]
    aid = "0x" + "%016x" % 0xF00D
    assert any(e["ph"] == "b" and e.get("id") == aid for e in evs)
    assert any(e["ph"] == "e" and e.get("id") == aid for e in evs)
    xs = [e for e in evs if e["ph"] == "X" and e["name"] == "wire.hop"]
    assert len(xs) == 2
    assert {e["args"]["where"] for e in xs} == {"dispatcher.sync",
                                                "game.ingest"}


# -- flight recorder ---------------------------------------------------------


def test_flight_clu_fault_triggers_dump(clean_telemetry, flight_dir):
    telemetry.enable()  # so flight.dumps counts the write
    flight.note_fault({"seam": "clu.lease", "kind": "stall"})
    dumps = glob.glob(os.path.join(flight_dir, "flight_t1_*fault_clu*"))
    assert dumps, os.listdir(flight_dir) if os.path.isdir(flight_dir) else []
    doc = flight.load(dumps[0])
    assert doc["component"] == "t1"
    assert any(f.get("seam") == "clu.lease" for f in doc["faults"])
    assert doc["reason"] == "fault:clu.lease"
    # the latest-pointer follows the newest dump
    latest = flight.load(os.path.join(flight_dir, "flight_t1_latest.json"))
    assert latest["reason"] == doc["reason"]
    assert telemetry.snapshot().get("flight.dumps", 0) >= 1


def test_flight_non_clu_fault_recorded_without_dump(clean_telemetry,
                                                    flight_dir):
    flight.note_fault({"seam": "aoi.kernel", "kind": "error"})
    assert not glob.glob(os.path.join(flight_dir, "flight_t1_0*"))
    assert any(f.get("seam") == "aoi.kernel"
               for f in flight.state()["faults"])


def test_flight_dump_renders_as_chrome_trace(clean_telemetry, flight_dir):
    flight.note("failover", game=2)
    flight.note_packet("rx", 60, 128)
    path = flight.dump("unit")
    chrome = flight.to_chrome(flight.load(path))
    # the JAX package renders the port's dump alike
    from goworld_tpu.telemetry import flight as jax_flight

    assert chrome == jax_flight.to_chrome(jax_flight.load(path))
    cats = {e.get("cat") for e in chrome["traceEvents"]}
    assert "note" in cats and "pkt" in cats
    assert chrome["displayTimeUnit"] == "ms"


def test_flight_slo_breach_dumps_on_tick_budget(clean_telemetry, flight_dir,
                                                monkeypatch):
    """GW_TICK_BUDGET_MS is the SLO seam: a tick over budget trips
    Runtime.tick -> flight.slo_breach -> an slo:* dump."""
    from goworld_tpu_torch.engine import runtime as rt_mod

    monkeypatch.setenv("GW_TICK_BUDGET_MS", "0.000001")
    monkeypatch.setattr(rt_mod, "_TICK_BUDGET_MS", 0.000001)
    rt = rt_mod.Runtime(aoi_backend="cpu", device="cpu")
    rt.tick()
    dumps = glob.glob(os.path.join(flight_dir, "flight_t1_*slo_tick*"))
    assert dumps
    doc = flight.load(dumps[0])
    assert any(n.get("kind") == "slo.tick_budget" for n in doc["notes"])


def test_flight_no_dir_costs_nothing(clean_telemetry, monkeypatch):
    monkeypatch.setattr(flight, "_dir", None)
    flight.note_fault({"seam": "clu.kill", "kind": "error"})
    assert flight.dump("unit") is None


def test_gwlog_json_carries_span_and_trace_id(clean_telemetry, tmp_path):
    """A GW_LOG_JSON line emitted inside an open span, after
    a wire hop, joins on the same keys as /debug/trace -- and neither key
    leaks once tracing is reset/disabled."""
    import json as _json
    import logging

    from goworld_tpu_torch.telemetry import trace
    from goworld_tpu_torch.utils import gwlog

    telemetry.enable()
    p = _records_packet(1)
    tracectx.stamp(p, 0xBEEF, hop=0)
    tracectx.record_hop(tracectx.try_strip(p), "game.ingest")
    logf = tmp_path / "t.log"
    gwlog.setup("info", str(logf), json_lines=True)
    try:
        with trace.span("tick.aoi"):
            logging.getLogger("gw.game1").info("inside")
        logging.getLogger("gw.game1").info("outside")
    finally:
        gwlog.setup("info")
    inside, outside = [
        _json.loads(ln) for ln in logf.read_text().strip().splitlines()]
    assert inside["span"] == "tick.aoi"
    assert inside["trace_id"] == "%016x" % 0xBEEF
    assert "span" not in outside  # no open span on this thread
    assert outside["trace_id"] == "%016x" % 0xBEEF
    # reset + disable: the join keys must vanish, not linger
    tracectx.reset()
    assert tracectx.current_trace_id() is None


# -- federated metrics + accelerator gauge -----------------------------------


def test_dispatcher_federates_component_snapshots(clean_telemetry):
    """clu.metric_sources counts reporting components; every numeric key
    of a stored snapshot re-emits labeled by component -- one dispatcher
    scrape reads the whole cluster."""
    from goworld_tpu_torch.components.dispatcher.service import DispatcherService

    cfg = config.loads(
        "[deployment]\ndispatchers = 1\ngames = 1\ngates = 1\n"
        "[dispatcher1]\nhost = 127.0.0.1\nport = 0\n")
    ds = DispatcherService(1, cfg)
    ds._store_metrics("game1", {"tick.count": 5.0, "junk": "str"})
    ds._store_metrics("gate1", {"net.packets_sent": 7})
    samples = ds._telemetry_collect()
    by_name = {}
    for s in samples:
        by_name.setdefault(s.name, []).append(s)
    assert by_name["clu.metric_sources"][0].value == 2.0
    [tick] = by_name["tick.count"]
    assert tick.labels["component"] == "game1" and tick.value == 5.0
    assert all(s.name != "junk" for s in samples)


def test_accelerator_absent_gauge_always_on(clean_telemetry):
    """The gauge scrapes truthfully even with telemetry disabled, and on
    the CPU-pinned test backend it must read absent."""
    assert telemetry.accelerator_absent() is True  # torch sees no card
    assert telemetry.snapshot().get("accelerator_absent") == 1.0
    assert "gw_accelerator_absent" in telemetry.render_prometheus()


# -- end to end: SIGKILL a worker, read its black box ------------------------


def test_host_failover_kill9_leaves_flight_dump(tmp_path, clean_telemetry):
    """The kill -9 failover scenario (workers on the cpu tier), run
    with the flight recorder's heartbeat on (GW_FLIGHT_INTERVAL_S via
    worker_env); the SIGKILLed game1 cannot trap anything, so its latest
    heartbeat dump IS the post-mortem.  Failover forensics ride along:
    the survivor still loses nothing, and the dispatcher (in-process
    here, telemetry on) serves the failover counters plus the workers'
    piggybacked snapshots in its federated exposition."""
    from goworld_tpu_torch.engine.failover import host_failover_scenario

    telemetry.enable()
    fdir = str(tmp_path / "flight")
    res = host_failover_scenario(
        str(tmp_path), cap=16, ticks=24, kill_at=12, pace_s=0.005,
        lease_ttl_s=2.0, tier="cpu",
        worker_env={"GW_FLIGHT_DIR": fdir, "GW_FLIGHT_INTERVAL_S": "0.1",
                    "GW_TELEMETRY": "1"})
    assert res["events_lost"] == 0, res
    assert res["parity_ok"] and res["survivor_space_ok"], res
    assert res["clu_stats"]["failovers"] >= 1
    dumps = glob.glob(os.path.join(fdir, "flight_game1_*.json"))
    assert dumps, "SIGKILLed worker left no flight dump"
    doc = flight.load(os.path.join(fdir, "flight_game1_latest.json"))
    assert doc["component"] == "game1"
    assert doc["reason"] == "interval"  # the heartbeat, not a trap
    chrome = flight.to_chrome(doc)
    assert chrome["traceEvents"], "empty post-mortem"
    # the federated /debug/metrics body the dispatcher would serve: its
    # own failover counters + the lease-renew piggybacked worker series
    prom = telemetry.render_prometheus()
    assert "gw_clu_failovers" in prom
    assert 'component="game' in prom, "no piggybacked worker snapshot"


# -- the trailer across the packages -------------------------------------------


def _stamped(tc, pk, monkeypatch, trace_id, hop, origin_ns):
    """Two 32-byte records stamped by ``tc`` (a tracectx module) on a
    pinned clock, as bytes."""
    monkeypatch.setattr(time, "monotonic_ns", lambda: 987654321)
    p = pk.Packet()
    p.append_bytes(bytes(range(64)))
    tc.stamp(p, trace_id, hop=hop, origin_ns=origin_ns)
    return bytes(p.buf)


def test_trace_trailer_bytes_equal_jax_both_ways(clean_telemetry,
                                                 monkeypatch):
    from goworld_tpu.netutil import packet as jax_packet
    from goworld_tpu.telemetry import tracectx as jax_tracectx
    from goworld_tpu_torch.netutil import packet as port_packet

    assert tracectx.TRACE_WIRE.format == jax_tracectx.TRACE_WIRE.format
    assert (tracectx.TRACE_WIRE_VERSION, tracectx.TRACE_WIRE_MAGIC) == (
        jax_tracectx.TRACE_WIRE_VERSION, jax_tracectx.TRACE_WIRE_MAGIC)
    pairs = ((tracectx, port_packet), (jax_tracectx, jax_packet))
    for trace_id, hop, origin in ((0xABC, 0, 5), (0xF00DF00DF00DF00D, 3,
                                                 123456), (1, 255, 0)):
        got, want = (_stamped(tc, pk, monkeypatch, trace_id, hop, origin)
                     for tc, pk in pairs)
        assert got == want
        # each package reads the other's trailer: same fields, same body
        for (reader, rpk), data in (((jax_tracectx, jax_packet), got),
                                    ((tracectx, port_packet), want)):
            p = rpk.Packet(bytearray(data))
            ctx = reader.try_strip(p)
            assert (ctx.trace_id, ctx.hop, ctx.version, ctx.origin_ns,
                    ctx.send_ns) == (trace_id, hop, 1, origin, 987654321)
            assert bytes(p.buf) == bytes(range(64))
