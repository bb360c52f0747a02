"""The port's network fault seams, operation monitor, dispatcher-link
gauges and checkpoint instruments against the JAX package's (the named
scenarios of tests/test_faults.py, tests/test_telemetry.py and
tests/test_checkpoint.py on goworld_tpu_torch).

* ``conn.recv`` and ``conn.send``: an injected reset closes the link and
  raises; ``disp.connect``: two injected connect resets, then the
  dispatcher link comes up with its attempt counter cleared.
* opmon: quantiles agree with the registry collector, operations land in
  the trace ring, and the components' operations (``disp.route``,
  ``gate.client_pkt``, ``game.outbox``, ``storage.op``) reach it from a
  live cluster and a storage service.
* the DispatcherCluster's per-link gauges and its drop-oldest counter.
* ``ckpt.*``: every span fires on a checkpoint and restore cycle, the
  journal's counters move, and retries and torn records count under the
  ``store.write`` faults.

The series' names, kinds, labels and help texts (opmon's collector, the
``disp.*`` collector, the ``ckpt.*`` instruments) are held equal to the
JAX package's."""

from __future__ import annotations

import socket
import threading
import time

import numpy as np
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401

from goworld_tpu_torch import config as gwconfig
from goworld_tpu_torch import faults, telemetry
from goworld_tpu_torch.client import GameClientConnection
from goworld_tpu_torch.components.dispatcher.service import DispatcherService
from goworld_tpu_torch.components.game.service import GameService
from goworld_tpu_torch.components.gate.service import GateService
from goworld_tpu_torch.dispatchercluster import DispatcherCluster
from goworld_tpu_torch.engine.aoi import AOIEngine
from goworld_tpu_torch.engine.checkpoint import (CheckpointController,
                                                 _open_backends)
from goworld_tpu_torch.engine.entity import Entity
from goworld_tpu_torch.engine.rpc import OWN_CLIENT, rpc
from goworld_tpu_torch.netutil.conn import FrameParser, PacketConnection, \
    serve_tcp
from goworld_tpu_torch.netutil.packet import Packet
from goworld_tpu_torch.proto import GWConnection
from goworld_tpu_torch.telemetry import trace
from goworld_tpu_torch.utils import opmon


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    faults.clear()
    yield
    faults.clear()


def series(samples):
    """Each series of a collector's samples: name, kind, label names and
    help (values aside).  Read from the collector itself, not from the
    process's exposition, where a live dispatcher of another test may
    re-emit its components' series under the same names."""
    return sorted({(x.name, x.kind, tuple(sorted(x.labels or {})), x.help)
                   for x in samples})


# -- the network tier ----------------------------------------------------------

def _pc_pair():
    a, b = socket.socketpair()
    return PacketConnection(a), b


def _packet(payload: bytes):
    return Packet(bytearray(payload))


def test_conn_recv_reset():
    faults.install("conn.recv:reset@1")
    pc, peer = _pc_pair()
    with pytest.raises(ConnectionResetError):
        pc.recv_packet()
    assert pc.closed
    peer.close()


def test_conn_send_reset_closes_link():
    faults.install("conn.send:reset@1")
    a, b = socket.socketpair()
    gw = GWConnection(PacketConnection(a))
    with pytest.raises(ConnectionResetError):
        gw.send(_packet(b"p"))
    assert gw.pc.closed
    b.close()


class _Recorder:
    """A dispatcher stand-in: records every framed payload it receives."""

    def __init__(self):
        self.payloads: list[bytes] = []
        self.conn_count = 0
        self._stop = threading.Event()
        self.ls = serve_tcp(("127.0.0.1", 0), self._on_conn,
                            stop_event=self._stop)
        self.addr = self.ls.getsockname()

    def _on_conn(self, sock, peer):
        self.conn_count += 1
        parser = FrameParser()
        while not self._stop.is_set():
            try:
                data = sock.recv(65536)
            except OSError:
                return
            if not data:
                return
            for p in parser.feed(data):
                self.payloads.append(p.payload)

    def close(self):
        self._stop.set()
        self.ls.close()


def _cluster(addrs, **kw):
    kw.setdefault("backoff_base", 0.05)
    kw.setdefault("backoff_cap", 0.2)
    return DispatcherCluster(addrs, on_packet=lambda i, p: None,
                             register=lambda c: None, tag="test", **kw)


def test_disp_connect_fault_then_recovery():
    rec = _Recorder()
    faults.install("disp.connect:reset@1x2")
    c = _cluster([rec.addr]).start()
    try:
        assert c.wait_connected(5.0)
        st = c.status()[0]
        assert st["connected"] and st["attempts"] == 0, st
        assert faults.plan().counts["disp.connect"] >= 3
    finally:
        c.stop()
        rec.close()


# -- opmon ---------------------------------------------------------------------

def test_opmon_quantiles_and_registry_agreement():
    """/debug/opmon and /debug/metrics render the same _stats dict: the
    dump's p50/p99 are exactly the registry collector's, scaled to ms."""
    opmon.reset()
    for _ in range(20):
        with opmon.Operation("storage.op"):
            pass
    d = opmon.dump()["storage.op"]
    assert d["count"] == 20
    assert 0 < d["p50_ms"] <= d["p99_ms"] <= d["max_ms"] * 64  # pow2-coarse
    snap = telemetry.snapshot()
    assert snap['opmon.count{op="storage.op"}'] == 20
    assert snap['opmon.p50_seconds{op="storage.op"}'] * 1e3 == d["p50_ms"]
    assert snap['opmon.p99_seconds{op="storage.op"}'] * 1e3 == d["p99_ms"]
    assert snap['opmon.peak_seconds{op="storage.op"}'] * 1e3 == d["max_ms"]
    # the sum of the twenty is at least the longest of them
    assert snap['opmon.total_seconds{op="storage.op"}'] >= \
        snap['opmon.peak_seconds{op="storage.op"}'] > 0


def test_opmon_operations_land_in_trace_ring():
    telemetry.enable()
    try:
        trace.reset()
        with opmon.Operation("game.outbox"):
            pass
        assert "game.outbox" in [nm for nm, *_ in trace.spans()]
    finally:
        telemetry.disable()


COMPONENT_OPS = ("disp.route", "gate.client_pkt", "game.outbox",
                 "storage.op")

OPS_CONFIG = """
[deployment]
dispatchers = 1
games = 1
gates = 1

[dispatcher1]
port = 0

[game_common]
boot_entity = OpsAvatar
aoi_backend = cpu
aoi_device = cpu

[gate1]
port = 0
heartbeat_timeout_s = 0
"""


class OpsAvatar(Entity):
    @rpc(expose=OWN_CLIENT)
    def echo(self, text):
        self.call_client("echoed", text)


def test_component_operations_reach_opmon(tmp_path):
    """A client's RPC through a live cluster counts the dispatcher's
    ``disp.route``, the gate's ``gate.client_pkt`` and the game's
    ``game.outbox``; a storage write counts ``storage.op``.  The opmon
    series of the four are the JAX package's names, kinds and help."""
    from goworld_tpu.utils import opmon as jax_opmon
    from goworld_tpu_torch.storage import EntityStorageService
    from goworld_tpu_torch.storage.backends import FilesystemEntityStorage

    opmon.reset()
    cfg = gwconfig.loads(OPS_CONFIG)
    disp = DispatcherService(1, cfg).start()
    cfg.dispatchers[1].host, cfg.dispatchers[1].port = disp.addr
    game = GameService(1, cfg, freeze_dir=str(tmp_path))
    game.register_entity_type(OpsAvatar)
    game.start()
    gate = GateService(1, cfg).start()
    try:
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not game.deployment_ready:
            time.sleep(0.01)
        assert game.deployment_ready
        c = GameClientConnection(gate.addr)
        assert c.wait_for(lambda c: c.player is not None, 10)
        c.call_player("echo", "ops")
        assert c.wait_for(lambda c: ("echoed", ("ops",)) in c.player.calls,
                          10)
        c.close()
    finally:
        gate.stop()
        game.stop()
        disp.stop()
    st = EntityStorageService(FilesystemEntityStorage(str(tmp_path / "st")),
                              post=lambda fn: fn())
    st.save("OpsAvatar", "e" * 16, {"a": 1})
    assert st.wait_idle(10.0)
    st.close()
    counts = {op: v["count"] for op, v in opmon.dump().items()}
    for op in COMPONENT_OPS:
        assert counts.get(op, 0) > 0, (op, counts)
    jax_opmon.reset()
    for op in COMPONENT_OPS:
        with jax_opmon.Operation(op):
            pass
    got = series(opmon._telemetry_collect())
    assert got == series(jax_opmon._telemetry_collect())
    assert len(got) == 5  # count, total, peak, p50, p99


# -- the dispatcher links' gauges -----------------------------------------------

def test_dispatchercluster_status_in_registry():
    # two dispatcher addrs, maintain threads never started: both links
    # report down through the registry under per-cluster labels
    dc = DispatcherCluster([("127.0.0.1", 1), ("127.0.0.1", 2)],
                           on_packet=lambda i, pkt: None,
                           register=lambda conn: None, tag="game1")
    cid = dc._telemetry_id
    snap = telemetry.snapshot()
    for i in range(2):
        key = ('disp.connected{cluster="%d",disp="%d",tag="game1"}'
               % (cid, i))
        assert snap[key] == 0.0
    dc.stop()


def test_dispatchercluster_dropped_counter_in_registry():
    """Overflowing the outage buffer surfaces in the labeled registry
    counter, not just status(): drop-oldest is counted, never silent."""
    dc = DispatcherCluster([("127.0.0.1", 1)],
                           on_packet=lambda i, pkt: None,
                           register=lambda conn: None, tag="game1",
                           pending_cap=4)
    try:
        for i in range(7):  # link down: all buffer; 3 past cap drop oldest
            assert not dc.post(0, Packet(bytearray(b"p%d" % i)))
        snap = telemetry.snapshot()
        lbl = 'cluster="%d",disp="0",tag="game1"' % dc._telemetry_id
        assert snap["disp.dropped{%s}" % lbl] == 3.0
        assert snap["disp.pending{%s}" % lbl] == 4.0
    finally:
        dc.stop()


DISP_GAUGES = ("disp.connected", "disp.attempts", "disp.backoff_s",
               "disp.next_retry_in", "disp.pending", "disp.replayed",
               "disp.dropped")


def test_dispatchercluster_series_equal_jax():
    """Each link's series: the JAX package's names, kinds, labels and
    help."""
    from goworld_tpu.dispatchercluster import DispatcherCluster as JaxDC

    made = [cls([("127.0.0.1", 1)], on_packet=lambda i, pkt: None,
                register=lambda conn: None, tag="twin")
            for cls in (DispatcherCluster, JaxDC)]
    try:
        got, want = (series(dc._telemetry_collect()) for dc in made)
        assert got == want
        assert {name for name, *_ in got} == set(DISP_GAUGES)
    finally:
        for dc in made:
            dc.stop()


# -- the checkpoint's instruments ----------------------------------------------

CKPT_SPANS = ("ckpt.snapshot", "ckpt.delta", "ckpt.flush", "ckpt.restore")
CKPT_METRICS = ("ckpt.bytes", "ckpt.records", "ckpt.epochs", "ckpt.retries",
                "ckpt.torn", "ckpt.backlog", "ckpt.lag_ticks")


def _frames(cap, ticks, seed=7, world=100.0, step=3.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, world, cap).astype(np.float32)
    z = rng.uniform(0.0, world, cap).astype(np.float32)
    out = []
    for _ in range(ticks):
        x = x + rng.uniform(-step, step, cap).astype(np.float32)
        z = z + rng.uniform(-step, step, cap).astype(np.float32)
        out.append((x.copy(), z.copy()))
    return out


def _drive(ctl, eng, h, frames, start=0):
    n = len(frames[0][0])
    r = np.full(n, 12.0, np.float32)
    act = np.ones(n, bool)
    for t, (x, z) in enumerate(frames, start + 1):
        eng.submit(h, x, z, r, act)
        eng.flush()
        eng.take_events(h)
        ctl.step(t)


def _controller(tmp_path, plan=None, **kw):
    eng = AOIEngine(device="cpu")
    store, kv = _open_backends(str(tmp_path / "ck"))
    ctl = CheckpointController(eng, store, kv, mode="continuous", **kw)
    h = eng._create_handle(64, "cuda")
    ctl.track("s", h)
    if plan:
        faults.install(plan)
    return eng, ctl, store, kv, h


def test_ckpt_telemetry_catalog(tmp_path):
    """Every ckpt.* span fires on a checkpoint+restore cycle and every
    journal counter moves."""
    from goworld_tpu_torch.engine import checkpoint as ck

    telemetry.enable()
    trace.reset()
    try:
        eng, ctl, store, kv, h = _controller(tmp_path)
        _drive(ctl, eng, h, _frames(64, 3))
        assert ctl.drain()
        rest = CheckpointController(eng, store, kv, mode="off")
        assert rest.restore("s") is not None
        names = {s[0] for s in trace.spans()}
        for span in CKPT_SPANS:
            assert span in names, f"span {span} never fired"
        assert ck._BYTES.value > 0          # ckpt.bytes
        assert ck._RECORDS.value >= 3       # ckpt.records
        assert ck._EPOCHS.value >= 3        # ckpt.epochs
        ctl.close()
    finally:
        telemetry.disable()


def test_ckpt_retries_and_torn_count(tmp_path):
    """``ckpt.retries`` counts a write retried after an injected failure,
    ``ckpt.torn`` a poisoned record the restore detects; ``ckpt.backlog``
    and ``ckpt.lag_ticks`` read the writer's queue and lag."""
    from goworld_tpu_torch.engine import checkpoint as ck

    telemetry.enable()
    try:
        retries, torn = ck._RETRIES.value, ck._TORN.value
        eng, ctl, store, kv, h = _controller(
            tmp_path / "a", "store.write:fail@1x2", retry_base_s=0.0)
        _drive(ctl, eng, h, _frames(64, 3))
        assert ctl.drain(timeout=10.0)
        faults.clear()
        assert ck._RETRIES.value == retries + 2
        assert ck._BACKLOG.value == 0 and ck._LAG.value >= 0
        ctl.close()
        eng, ctl, store, kv, h = _controller(tmp_path / "b",
                                             "store.write:poison@2")
        _drive(ctl, eng, h, _frames(64, 3))
        assert ctl.drain(timeout=10.0)
        faults.clear()
        CheckpointController(eng, store, kv, mode="off").restore("s")
        assert ck._TORN.value > torn
        ctl.close()
    finally:
        telemetry.disable()


def test_ckpt_series_equal_jax():
    """The seven instruments: the JAX package's names, kinds and help."""
    from goworld_tpu.engine import checkpoint as jax_ck
    from goworld_tpu_torch.engine import checkpoint as ck

    def instruments(mod):
        return sorted((m.name, type(m).__name__, m.help) for m in (
            mod._BYTES, mod._RECORDS, mod._EPOCHS, mod._RETRIES, mod._TORN,
            mod._BACKLOG, mod._LAG))

    got = instruments(ck)
    assert got == instruments(jax_ck)
    assert [name for name, *_ in got] == sorted(CKPT_METRICS)
