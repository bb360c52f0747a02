"""Telemetry of the port (goworld_tpu_torch.telemetry, utils/, the
runtime's spans, crontab and tick budget), held to the JAX package's on
the CPU.  Tolerance: exact equality -- of the event streams with
telemetry on and off, of span names, nesting and stamps on an injected
clock, of Prometheus metric names, types and labels (and the values that
are not times), of crontab firings at the same injected times, of flight
dumps rendered as Chrome traces and of trace-context trailers.

Mirrors tests/test_telemetry.py (without its opmon and dispatcher-link
cases, which come with the cluster components) and tests/test_crontab.py.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import threading
from datetime import datetime
from pathlib import Path

import numpy as np
import pytest

from goworld_tpu import faults as jfaults
from goworld_tpu import telemetry as jtelemetry
from goworld_tpu.engine.aoi import AOIEngine as JaxEngine
from goworld_tpu.telemetry import flight as jflight
from goworld_tpu.telemetry import metrics as jmetrics
from goworld_tpu.telemetry import trace as jtrace
from goworld_tpu.telemetry import tracectx as jtracectx
from goworld_tpu.utils import crontab as jcrontab
from goworld_tpu_torch import faults, telemetry
from goworld_tpu_torch.engine.aoi import AOIEngine
from goworld_tpu_torch.netutil.packet import Packet
from goworld_tpu_torch.telemetry import flight, trace, tracectx
from goworld_tpu_torch.telemetry.metrics import (HIST_BOUNDS, Registry,
                                                 Sample, bucket_index)
from goworld_tpu_torch.utils import crontab, gwlog
from test_aoi_delta import _assert_same, _drive
from torch_threads import one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _telemetry_off_after():
    """Telemetry state is process-global in both packages: never leak it."""
    yield
    telemetry.disable()
    jtelemetry.disable()
    faults.clear()
    jfaults.clear()


class _Clock:
    """An injected clock that advances ``step`` on every read."""

    def __init__(self, t=100.0, step=0.0):
        self.t = t
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t

    def advance(self, dt):
        self.t += dt


# -- bit-exact parity: telemetry on vs off -------------------------------------


def _walk(cap=256, ticks=6, n=180, **kw):
    engines = {"cpu": JaxEngine(default_backend="cpu"),
               "port": AOIEngine(device="cpu", **kw)}
    handles = {k: e.create_space(cap) for k, e in engines.items()}
    out, _ = _drive(engines, handles, cap, ticks, n=n)
    _assert_same(out)
    return out


@pytest.mark.parametrize("kw", [{}, {"fused": True, "cohort": "auto"},
                                {"mesh": "cpu2"}],
                         ids=["single", "cohort", "mesh"])
def test_parity_on_vs_off(kw):
    """The same sparse walk with telemetry off and on gives the same event
    stream (equal to the JAX oracle's), and the traced run recorded the
    flush's split-phase spans."""
    if kw.get("mesh") == "cpu2":
        from goworld_tpu_torch.parallel import SpaceMesh

        kw = {"mesh": SpaceMesh(["cpu"] * 2)}
    off = _walk(**kw)
    telemetry.enable()
    trace.reset()
    on = _walk(**kw)
    names = {nm for nm, *_ in trace.spans()}
    telemetry.disable()
    for (oe, ol), (ne, nl) in zip(off["port"], on["port"]):
        np.testing.assert_array_equal(oe, ne)
        np.testing.assert_array_equal(ol, nl)
    assert {"aoi.dispatch", "aoi.harvest"} <= names, names


# -- disabled path ---------------------------------------------------------------


def test_disabled_instruments_are_noops():
    telemetry.disable()
    assert not telemetry.enabled() and not trace.enabled()
    assert trace.t() == 0.0
    assert trace.lap("tick", 0.0) == 0.0
    assert trace.span("tick.aoi") is trace.span("tick.sync")
    assert trace.spans() == [] and trace.current_span() is None
    reg = Registry(enabled=False)
    c = reg.counter("aoi.h2d_bytes")
    c.inc(5)
    g = reg.gauge("aoi.buckets")
    g.set(3)
    h = reg.histogram("tick.seconds")
    h.observe(1.0)
    assert (c.value, g.value, h.count) == (0.0, 0.0, 0)


def test_gw_telemetry_env_enables_at_import():
    code = ("from goworld_tpu_torch import telemetry\n"
            "from goworld_tpu_torch.telemetry import trace\n"
            "import sys\n"
            "print(telemetry.enabled(), trace.enabled(), "
            "'torch' in sys.modules)\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    env.pop("GW_TELEMETRY", None)
    outs = []
    for extra in ({}, {"GW_TELEMETRY": "1"}):
        r = subprocess.run([sys.executable, "-c", code], env={**env, **extra},
                           cwd=REPO, capture_output=True, text=True,
                           timeout=120)
        assert r.returncode == 0, r.stderr
        outs.append(r.stdout.split())
    # the package never imports torch at import time
    assert outs == [["False", "False", "False"], ["True", "True", "False"]]


# -- trace export ----------------------------------------------------------------


def _trace_doc(tel, tr, **kw):
    clk = _Clock()
    tel.enable(clock=clk)
    tr.reset()
    for n in (1, 2):
        clk.advance(1.0)
        tr.mark_tick(n)
        t0 = tr.t()
        with tr.span("tick.aoi"):
            clk.advance(0.002)
            with tr.span("aoi.flush"):
                clk.advance(0.001)
        tr.lap("tick", t0)
    doc = tr.export_chrome_trace(**kw)
    tel.disable()
    return doc


def _strip_ids(doc):
    evs = []
    for e in doc["traceEvents"]:
        e = {k: v for k, v in e.items() if k not in ("pid", "tid")}
        if e["ph"] == "M":
            e["args"] = {}
        evs.append(e)
    return evs


@pytest.mark.parametrize("last_ticks", [None, 1])
def test_chrome_trace_equal_jax(last_ticks):
    """The same spans on the same injected clock export the same Chrome
    trace-event JSON as the JAX package's (apart from the process name,
    pid and tid): "X" spans nest, "i" tick marks, ``last_ticks``
    windows."""
    doc = _trace_doc(telemetry, trace, last_ticks=last_ticks)
    want = _trace_doc(jtelemetry, jtrace, last_ticks=last_ticks)
    assert _strip_ids(doc) == _strip_ids(want)
    evs = doc["traceEvents"]
    assert evs[0]["args"]["name"] == "goworld_tpu_torch"
    xs = [e for e in evs if e["ph"] == "X"]
    assert all(e["pid"] == os.getpid() for e in xs)
    assert all(e["tid"] == threading.get_ident() for e in xs)
    marks = [e["name"] for e in evs if e["ph"] == "i"]
    assert marks == (["tick 2"] if last_ticks else ["tick 1", "tick 2"])
    # spans nest: each aoi.flush inside its tick.aoi, inside its tick
    for inner, outer in zip(xs, xs[1:]):
        if (inner["name"], outer["name"]) in (("aoi.flush", "tick.aoi"),
                                              ("tick.aoi", "tick")):
            assert outer["ts"] <= inner["ts"]
            assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_trace_ring_is_bounded():
    telemetry.enable(ring=4)
    trace.reset()
    for _ in range(10):
        trace.lap("tick", trace.t())
    assert len(trace.spans()) == 4


def test_chrome_trace_file_export(tmp_path):
    telemetry.enable(clock=_Clock())
    trace.reset()
    with trace.span("tick.aoi"):
        assert trace.current_span() == "tick.aoi"
    path = tmp_path / "trace.json"
    doc = trace.export_chrome_trace(path=str(path))
    assert json.loads(path.read_text()) == doc
    assert doc["displayTimeUnit"] == "ms"


def test_cuda_annotations_bridge_is_off_without_cuda():
    import torch

    assert trace.enable_cuda_annotations() is False  # tracing disabled
    telemetry.enable()
    if not torch.cuda.is_available():
        assert trace.enable_cuda_annotations() is False
    assert trace.enable_cuda_annotations(False) is True
    with trace.span("tick.aoi"):
        pass
    assert [nm for nm, *_ in trace.spans()] == ["tick.aoi"]


def _runtime_spans(Runtime, kw, seed=3):
    """One space of 40 entities on the cpu backend, 3 ticks with the
    walk, on a clock that advances 1 ms at every read: the span ring."""
    from importlib import import_module

    pkg = Runtime.__module__.split(".")[0]
    Space = import_module(pkg + ".engine.space").Space
    Entity = import_module(pkg + ".engine.entity").Entity
    Vector3 = import_module(pkg + ".engine.vector").Vector3

    class TelScene(Space):
        pass

    class TelMob(Entity):
        use_aoi = True
        aoi_distance = 50.0

    clk = _Clock(step=0.001)
    rt = Runtime(now=clk, telemetry_on=True, aoi_backend="cpu", **kw)
    for cls in (TelScene, TelMob):
        rt.entities.register(cls)
    sp = rt.entities.create_space("TelScene", kind=1)
    sp.enable_aoi(50.0, capacity=128)
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, 300, (2, 40)).astype(np.float32)
    ents = [rt.entities.create("TelMob", space=sp,
                               pos=Vector3(float(p[0, i]), 0.0,
                                           float(p[1, i])))
            for i in range(40)]
    slots = np.array([e.aoi_slot for e in ents], np.int64)
    trace.reset()
    jtrace.reset()
    for _ in range(3):
        p += rng.uniform(-5, 5, p.shape).astype(np.float32)
        sp.move_entities(slots, p[0], p[1])
        rt.tick()
    return [(nm, t0, t1) for nm, _tid, t0, t1 in
            (trace.spans() if pkg == "goworld_tpu_torch"
             else jtrace.spans())]


def test_runtime_tick_spans_equal_jax():
    """Runtime(telemetry_on=True) routes span stamps through ``now``: on
    the same injected clock the port's tick records the JAX runtime's
    spans, in the same order with the same stamps (so the same nesting),
    and the whole-tick histogram observes each tick."""
    from goworld_tpu.engine.runtime import Runtime as JaxRuntime
    from goworld_tpu_torch.engine.runtime import Runtime

    hist = telemetry.registry().histogram("tick.seconds")
    count0 = hist.count
    got = _runtime_spans(Runtime, {"device": "cpu"})
    telemetry.disable()
    want = _runtime_spans(JaxRuntime, {})
    assert got == want
    names = [nm for nm, *_ in got]
    assert {"tick", "tick.timers", "tick.aoi", "aoi.flush", "aoi.dispatch",
            "aoi.harvest", "aoi.emit", "tick.sync", "tick.post"} <= set(names)
    assert hist.count == count0 + 3
    spans = {nm: (t0, t1) for nm, t0, t1 in got[-9:]}
    for inner, outer in (("aoi.dispatch", "aoi.flush"),
                         ("aoi.flush", "tick.aoi"), ("tick.aoi", "tick")):
        assert spans[outer][0] <= spans[inner][0] <= spans[inner][1] \
            <= spans[outer][1], (inner, outer)


def test_tick_budget_breach_dumps_flight(tmp_path, monkeypatch):
    """``GW_TICK_BUDGET_MS``: a tick over budget calls flight.slo_breach,
    which notes the breach and dumps the black box."""
    from goworld_tpu_torch.engine import runtime as R

    monkeypatch.setattr(R, "_TICK_BUDGET_MS", 1e-9)
    monkeypatch.setattr(flight, "_dir", str(tmp_path))
    flight.reset()
    rt = R.Runtime(device="cpu")
    rt.tick()
    dumps = sorted(p.name for p in tmp_path.glob("flight_*_0001_*.json"))
    assert dumps and "slo_tick1" in dumps[0]
    doc = flight.load(str(tmp_path / dumps[0]))
    assert doc["reason"] == "slo:tick1"
    assert doc["notes"][0]["kind"] == "slo.tick_budget"


# -- metrics registry --------------------------------------------------------------


def test_bucket_index_equal_jax():
    vals = [0.0, 1e-9, *HIST_BOUNDS, *(b * 0.75 for b in HIST_BOUNDS),
            HIST_BOUNDS[-1] * 2, 3e-4, 0.7]
    assert [bucket_index(v) for v in vals] == \
        [jmetrics.bucket_index(v) for v in vals]
    assert bucket_index(HIST_BOUNDS[-1] * 2) == len(HIST_BOUNDS)


def _fill(reg_cls, sample_cls):
    reg = reg_cls(enabled=True)
    reg.counter("aoi.h2d_bytes", "bytes shipped").inc(512)
    reg.gauge("aoi.buckets").set(2)
    h = reg.histogram("tick.seconds", "tick wall time")
    for v in (1.5e-6, 0.25, 100.0):
        h.observe(v)
    reg.register_collector(lambda: [
        sample_cls("faults.fired", "counter", 3.0, {"seam": "aoi.h2d",
                                                    "b": "0"}),
        sample_cls("aoi.cohorts", "gauge", 7.0, {"engine": "0"}),
    ])
    return reg


def test_prometheus_text_equal_jax():
    text = _fill(Registry, Sample).render_prometheus()
    assert text == _fill(jmetrics.Registry, jmetrics.Sample) \
        .render_prometheus()
    lines = text.splitlines()
    assert "# TYPE gw_aoi_h2d_bytes_total counter" in lines
    assert "gw_aoi_h2d_bytes_total 512" in lines
    assert "gw_aoi_buckets 2" in lines
    bucket_lines = [ln for ln in lines
                    if ln.startswith("gw_tick_seconds_bucket")]
    assert len(bucket_lines) == len(HIST_BOUNDS) + 1
    counts = [int(ln.rsplit(" ", 1)[1]) for ln in bucket_lines]
    assert counts == sorted(counts) and counts[-1] == 3
    assert 'gw_faults_fired_total{b="0",seam="aoi.h2d"} 3' in lines
    assert 'gw_aoi_cohorts{engine="0"} 7' in lines


def test_registry_rejects_kind_conflicts():
    reg = Registry(enabled=True)
    reg.counter("aoi.h2d_bytes")
    with pytest.raises(TypeError):
        reg.gauge("aoi.h2d_bytes")
    assert reg.counter("aoi.h2d_bytes") is reg.counter("aoi.h2d_bytes")


def test_registry_thread_safety():
    reg = Registry(enabled=True)
    c = reg.counter("aoi.h2d_bytes")
    h = reg.histogram("tick.seconds")

    def work():
        for _ in range(2000):
            c.inc()
            h.observe(0.001)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == h.count == sum(h.snapshot()["buckets"]) == 16000


def test_weak_collectors_die_with_their_owner():
    reg = Registry(enabled=True)
    eng = AOIEngine(device="cpu")
    reg.register_collector(eng._telemetry_collect, weak=True)
    assert reg.snapshot()['aoi.buckets{engine="%d"}'
                          % eng._telemetry_id] == 0
    del eng
    assert not any(k.startswith("aoi.") for k in reg.snapshot())


def _exposition(eng):
    """{name: (type, label keys)} and the non-time values of one
    engine's collector, through a registry of its own."""
    reg = Registry()
    reg.register_collector(eng._telemetry_collect, weak=True)
    types, values = {}, {}
    for ln in reg.render_prometheus().splitlines():
        if ln.startswith("# TYPE "):
            _, _, name, kind = ln.split()
            types[name] = kind
        elif not ln.startswith("#"):
            name, val = ln.rsplit(" ", 1)
            base, _, labels = name.partition("{")
            assert labels == 'engine="%d"}' % eng._telemetry_id, ln
            values[base] = float(val)
    return types, values


def test_engine_exposition_equal_jax():
    """The same cohort walk (a leave, a join and a demotion) on the JAX
    engine and the port's: the same ``aoi.*`` families, types and labels
    -- the port adds its prefetch counters -- and the same values where
    they are not times or bytes."""
    # the cohort seam is crossed once a flush and once more at each
    # restack's export or import (their get_prev/set_prev flush): @9 is
    # the second tick after the join
    plan = "aoi.cohort:fail@9"
    faults.install(plan)
    jfaults.install(plan)
    engines = {"cpu": JaxEngine(default_backend="cpu"),
               "jax": JaxEngine(default_backend="tpu", cohort="auto",
                                fused=True),
               "port": AOIEngine(device="cpu", cohort="auto", fused=True)}
    handles = {k: e.create_space(200) for k, e in engines.items()}
    out, state = _drive(engines, handles, 200, 3, n=100)
    for k in ("jax", "port"):
        engines[k].cohort_leave(handles[k])
    out2, state = _drive(engines, handles, 200, 2, n=100, state=state)
    for k in ("jax", "port"):
        engines[k].cohort_join(handles[k])
    out3, _ = _drive(engines, handles, 200, 3, n=100, state=state)
    for o in (out, out2, out3):
        _assert_same(o)
    types, values = _exposition(engines["port"])
    jtypes, jvalues = _exposition(engines["jax"])
    extra = {"gw_aoi_prefetch_hits_total", "gw_aoi_prefetch_misses_total"}
    assert set(types) == set(jtypes) | extra
    assert {k: types[k] for k in jtypes} == jtypes
    for name in ("gw_aoi_buckets", "gw_aoi_cohorts", "gw_aoi_cohort_spaces",
                 "gw_aoi_calc_level", "gw_aoi_cohort_joins_total",
                 "gw_aoi_cohort_leaves_total",
                 "gw_aoi_cohort_demoted_spaces_total",
                 "gw_aoi_migrations_total",
                 "gw_aoi_evacuations_total", "gw_aoi_decode_overflow_total"):
        assert values[name] == jvalues[name], name
    assert values["gw_aoi_cohort_demoted_spaces_total"] == 1
    assert values["gw_aoi_cohorts"] == values["gw_aoi_cohort_spaces"] == 0


def test_faults_collector_equal_jax():
    for mod in (faults, jfaults):
        mod.clear()
    assert telemetry.snapshot()["faults.active"] == 0.0
    plan = "aoi.h2d:oom@2;aoi.kernel:fail@1"
    seams = ("aoi.h2d", "aoi.h2d", "aoi.kernel", "aoi.fetch")
    # the samples of the seams crossed here: a thread another test left
    # running may cross other seams of one package while the plan is live
    mine = {"faults.active"} | {
        f'faults.{k}{{seam="{s}"}}' for k in ("occurrences", "fired")
        for s in seams}
    got = {}
    for mod, tel in ((faults, telemetry), (jfaults, jtelemetry)):
        mod.install(plan)
        for seam in seams:
            try:
                mod.check(seam)
            except mod.InjectedFault:
                pass
        got[mod.__name__] = {k: v for k, v in tel.snapshot().items()
                             if k in mine}
        mod.clear()
    port, jax = got.values()
    assert port == jax
    assert port['faults.fired{seam="aoi.h2d"}'] == 1.0
    assert port['faults.occurrences{seam="aoi.h2d"}'] == 2.0


def test_accelerator_absent_reads_torch_from_sys_modules():
    import torch

    want = 0.0 if torch.cuda.is_available() else 1.0
    assert telemetry.snapshot()["accelerator_absent"] == want


# -- flight recorder and trace context ----------------------------------------------


def test_flight_dump_and_chrome_equal_jax(tmp_path, monkeypatch):
    """A ``clu.*`` firing dumps the black box; the dump loads, and renders
    as the same Chrome trace through both packages' ``to_chrome``."""
    monkeypatch.setattr(flight, "_dir", str(tmp_path))
    monkeypatch.setattr(flight, "_component", "game1")
    flight.reset()
    telemetry.enable(clock=_Clock(step=0.5))
    with trace.span("tick.aoi"):
        pass
    flight.note_packet("in", 7, 120)
    flight.note("failover", disp=1)
    faults.install("clu.kill:fail@1")
    with pytest.raises(faults.InjectedFault):
        faults.check("clu.kill")
    path = tmp_path / "flight_game1_0001_fault_clu.kill.json"
    doc = flight.load(str(path))
    assert doc["reason"] == "fault:clu.kill"
    assert json.loads((tmp_path / "flight_game1_latest.json").read_text()) \
        == doc
    assert [f["seam"] for f in doc["faults"]] == ["clu.kill"]
    assert set(doc) == set(jflight.state()) | {"reason"}
    assert flight.to_chrome(doc) == jflight.to_chrome(doc)
    names = [e["name"] for e in flight.to_chrome(doc)["traceEvents"]]
    assert names[:2] == ["process_name", "tick.aoi"]
    assert {"fault clu.kill", "failover", "pkt mt=7"} <= set(names)
    out = tmp_path / "chrome.json"
    assert flight.main([str(path), "-o", str(out)]) == 0
    assert json.loads(out.read_text()) == flight.to_chrome(doc)
    flight.reset()


def test_trace_trailer_equal_jax():
    """A stamped movement packet carries the JAX package's 28-byte
    trailer; both strip and decode it the same, and a pure record body is
    left alone."""
    from goworld_tpu.netutil.packet import Packet as JaxPacket

    body = bytes(range(64))  # two 32-byte records
    pkts = []
    for P_ in (Packet, JaxPacket):
        p = P_(bytearray(body))
        tracectx.stamp(p, 0x1234, 2, origin_ns=5)
        pkts.append(p)
    assert len(pkts[0].buf) == 64 + tracectx.TRACE_WIRE_SIZE == 92
    assert pkts[0].buf[:64] == pkts[1].buf[:64] == body
    ctx = tracectx.try_strip(pkts[0])
    jctx = jtracectx.try_strip(pkts[1])
    assert (ctx.trace_id, ctx.origin_ns, ctx.hop, ctx.version) == \
        (jctx.trace_id, jctx.origin_ns, jctx.hop, jctx.version) == \
        (0x1234, 5, 2, 1)
    assert bytes(pkts[0].buf) == body
    assert tracectx.try_strip(Packet(bytearray(body))) is None
    tracectx.reset()
    tracectx.record_hop(ctx, "game.ingest", recv_ns=ctx.send_ns + 1000)
    hops = tracectx.wire_hops_by_trace()
    assert hops["%016x" % 0x1234][0]["wire_ns"] == 1000
    doc = {"wireHops": hops}
    assert tracectx.merge_traces([doc]) == jtracectx.merge_traces([doc])
    tracectx.reset()


# -- structured logs --------------------------------------------------------------


def test_gwlog_json_lines_keeps_ready_tag(tmp_path):
    logf = tmp_path / "game.log"
    gwlog.setup("info", str(logf), json_lines=True)
    try:
        telemetry.enable()
        with trace.span("tick.post"):
            gwlog.announce_ready("game1", "game")
    finally:
        gwlog.setup("info")
    line = logf.read_text().strip().splitlines()[-1]
    rec = json.loads(line)
    assert sorted(rec) == ["component", "level", "msg", "span", "ts"]
    assert (rec["component"], rec["level"], rec["span"]) == \
        ("gw.game1", "INFO", "tick.post")
    assert gwlog.READY_TAG in rec["msg"] and gwlog.READY_TAG in line


def test_gwlog_json_env_gate(tmp_path, monkeypatch):
    monkeypatch.setenv("GW_LOG_JSON", "1")
    logf = tmp_path / "env.log"
    gwlog.setup("info", str(logf))
    try:
        logging.getLogger("gw.gate1").info("hello")
    finally:
        gwlog.setup("info")
    rec = json.loads(logf.read_text().strip().splitlines()[-1])
    assert (rec["component"], rec["msg"]) == ("gw.gate1", "hello")


# -- crontab (tests/test_crontab.py), firings equal to the JAX package's ------------


def _both(register):
    """A port and a JAX crontab with the same entries (``register(ct,
    hits)``); each callback appends its tag to its package's hits."""
    out = []
    for mod in (crontab, jcrontab):
        ct, hits = mod.Crontab(), []
        register(ct, hits)
        out.append((ct, hits))
    return out


CRON_CASES = {
    "exact": ([(30, 12, 15, 6, -1)],
              [datetime(2026, 6, 15, 12, 30), datetime(2026, 6, 15, 12, 31),
               datetime(2026, 6, 15, 13, 30), datetime(2026, 7, 15, 12, 30)]),
    "every_5_minutes": ([(-5, -1, -1, -1, -1)],
                        [datetime(2026, 1, 1, 0, m) for m in range(12)]),
    "every_6_hours": ([(0, -6, -1, -1, -1)],
                      [datetime(2026, 1, 1, h, m) for h in (0, 6, 7)
                       for m in (0, 1)]),
    "sunday_0_and_7": ([(0, 9, -1, -1, 0), (0, 9, -1, -1, 7),
                        (0, 9, -1, -1, 1)],
                       [datetime(2026, 7, 26, 9, 0),
                        datetime(2026, 7, 27, 9, 0)]),
}


@pytest.mark.parametrize("case", sorted(CRON_CASES))
def test_crontab_fires_equal_jax(case):
    entries, times = CRON_CASES[case]

    def register(ct, hits):
        for i, e in enumerate(entries):
            ct.register(*e, lambda i=i: hits.append(i))

    (ct, hits), (jct, jhits) = _both(register)
    fired = [ct.check_at(dt) for dt in times]
    assert fired == [jct.check_at(dt) for dt in times]
    assert hits == jhits and sum(fired) == len(hits) > 0


def test_crontab_exact_and_every_n():
    (ct, hits), _ = _both(lambda ct, h: ct.register(
        -5, -1, -1, -1, -1, lambda: h.append(1)))
    assert [ct.check_at(datetime(2026, 1, 1, 0, m)) for m in range(12)] == \
        [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0]


def test_crontab_unregister_and_len():
    ct = crontab.Crontab()
    h = ct.register(-1, -1, -1, -1, -1, lambda: None)
    assert len(ct) == 1 and ct.unregister(h) and not ct.unregister(h)
    assert len(ct) == 0
    assert ct.check_at(datetime(2026, 1, 1, 0, 0)) == 0


def test_crontab_callback_exception_isolated():
    ct = crontab.Crontab()
    hits = []
    ct.register(-1, -1, -1, -1, -1, lambda: 1 / 0)
    ct.register(-1, -1, -1, -1, -1, lambda: hits.append(1))
    assert ct.check_at(datetime(2026, 1, 1, 0, 0)) == 2
    assert hits == [1]


@pytest.mark.parametrize("bad", [
    (60, -1, -1, -1, -1), (-61, -1, -1, -1, -1), (0, 24, -1, -1, -1),
    (0, 0, 0, -1, -1), (0, 0, 32, -1, -1), (0, 0, 1, 0, -1),
    (0, 0, 1, 13, -1), (0, 0, 1, 1, 8), (0, 0, 1, 1, -2)])
def test_crontab_validate_rejects(bad):
    for mod in (crontab, jcrontab):
        with pytest.raises(ValueError):
            mod.validate(*bad)


def test_crontab_maybe_check_equal_jax():
    """maybe_check at the same injected wall-clock readings fires the
    same entries as the JAX package's: never on the first reading, once
    a minute boundary."""
    readings = [120.0, 125.0, 180.0, 181.0, 241.0, 600.0, 601.0]
    fired = []
    for mod in (crontab, jcrontab):
        clock = [0.0]
        ct = mod.Crontab(wallclock=lambda: clock[0])
        ct.register(-1, -1, -1, -1, -1, lambda: None)
        row = []
        for r in readings:
            clock[0] = r
            row.append(ct.maybe_check())
        fired.append(row)
    assert fired[0] == fired[1] == [0, 0, 1, 0, 1, 1, 0]


def test_runtime_wires_crontab():
    """The runtime's tick.timers phase calls crontab.maybe_check(); the
    same ticks at the same wall-clock readings fire as the JAX
    runtime's."""
    from goworld_tpu.engine.runtime import Runtime as JaxRuntime
    from goworld_tpu_torch.engine.runtime import Runtime

    hits = {}
    for name, rt in (("port", Runtime(device="cpu")), ("jax", JaxRuntime())):
        clock = [0.0]
        rt.crontab._wallclock = lambda clock=clock: clock[0]
        hits[name] = []
        rt.crontab.register(-1, -1, -1, -1, -1,
                            lambda h=hits[name]: h.append(1))
        for t in (0.0, 60.0, 61.0, 125.0):
            clock[0] = t
            rt.tick()
    assert hits["port"] == hits["jax"] == [1, 1]
