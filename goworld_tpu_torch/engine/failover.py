"""Kill-a-host failover driver: SIGKILL a real game process, lose nothing.

The cluster-supervision proof (docs/robustness.md "Cluster supervision &
host failover"), built like the crash-restart driver in
engine/checkpoint.py but one level up: instead of one process SIGKILLing
itself, a real DispatcherService (leases armed) supervises two child GAME
WORKER processes, and the parent kills one of them mid-traffic with a
genuine ``kill -9``.

Worker (``python -m goworld_tpu_torch.engine.failover --worker ...``): a raw
wire client owning one space.  It registers its slot eids over
MT_SET_GAME_ID, renews its lease after every applied batch, applies each
regrouped MT_SYNC_POSITION_YAW_FROM_CLIENT batch as one engine tick
(the tick stamp rides the records' unused y field), journals one line
per tick ("<tick> <crc:08x> <n_events>", line-buffered -- the
delivered-event record a SIGKILL cannot retract) and streams continuous
checkpoints into the SHARED checkpoint store.  On MT_REHOME_SPACES it
adopts a dead peer's spaces via CheckpointController.restore_into; on
MT_REPLAY_MOVES it re-applies the dispatcher-buffered batches, deduping
by stamp against the restored checkpoint tick.

Parent (:func:`host_failover_scenario`): in-process dispatcher + a raw
gate link driving deterministic per-(tick, slot) movement for both
spaces, a poll-then-SIGKILL of worker 1 once its journal reaches
``kill_at`` (crossing the ``clu.kill`` seam first), and the merge: the
dead worker's journal plus the survivor's post-restore journal must be
CRC-equal, tick for tick, to an unkilled in-process oracle --
events_lost == 0 is the acceptance bar, ticks_to_recover the cost.

The port's copy of the JAX package's ``engine/failover.py``.  A worker's
space lives on ``--tier`` (``cuda``, the default, puts the bucket on the
card, so the worker ticks the step kernel and a survivor's
``restore_into`` imports the adopted space onto the card; ``cpu`` and
``cpp`` are the host calculators).  The unkilled oracle runs on
``oracle_tier`` (``cpu``, the reference's numpy sweep, by default;
``cpp``, the independent native calculator, where the numpy sweep is too
slow for the slot count).
"""

from __future__ import annotations

import json
import os
import signal
import struct
import subprocess
import sys
import threading
import time

import numpy as np

from .. import faults
from ..netutil import Packet, PacketConnection, connect_tcp
from .. import telemetry
from ..telemetry import flight, tracectx
from ..proto import GWConnection, msgtypes as MT
from .checkpoint import (CheckpointController, _open_backends,
                         _read_journal, _tick_crc, _walk_frames)
from .ids import fixed_id

_REC = struct.Struct("<4f")  # x, y (tick stamp), z, yaw
# the parent's longest wait on the workers (registration, the victim's
# journal, the survivor's last tick): sized for a cuda worker at 16384
# slots, whose first tick builds the step kernel
WAIT_S = 300.0


def _space_eids(space_id: str, cap: int) -> list[str]:
    """Deterministic slot eids -- parent and workers compute identically
    (slot i of space S is always fixed_id("S:i"))."""
    return [fixed_id(f"{space_id}:{i}") for i in range(cap)]


# -- worker: one real game process ------------------------------------------


class _WorkerSpace:
    """One owned space: engine handle + the full position arrays each
    applied batch overwrites (records cover every slot, so the arrays
    never need restoring -- only the bucket's interest state does).
    ``ctl`` is the checkpoint controller journaling this space: the
    worker's own for native spaces, the dead game's re-opened namespace
    for adopted ones (the chain must stay monotonic where it lives)."""

    def __init__(self, handle, ctl, space_id: str, cap: int,
                 journal_dir: str, last_tick: int):
        self.h = handle
        self.ctl = ctl
        self.id = space_id
        self.slot = {eid: i for i, eid in enumerate(_space_eids(space_id, cap))}
        self.x = np.zeros(cap, np.float32)
        self.z = np.zeros(cap, np.float32)
        self.r = np.full(cap, 100.0, np.float32)
        self.act = np.ones(cap, bool)
        self.last = last_tick  # highest applied tick stamp (dedup fence)
        self.jf = open(os.path.join(journal_dir, f"{space_id}.journal"),
                       "a", buffering=1)


class _Worker:
    def __init__(self, args):
        from .aoi import AOIEngine

        self.args = args
        self.eng = AOIEngine(device="cuda" if args.tier == "cuda" else "cpu")
        # per-game namespace under the SHARED checkpoint root: each game
        # writes its own manifest log (no cross-process append races); a
        # survivor restores by re-opening the dead game's namespace fresh
        store, kv = _open_backends(
            os.path.join(args.ckpt_dir, f"game{args.game_id}"))
        self.ctl = CheckpointController(self.eng, store, kv,
                                        mode="continuous", interval=4)
        self.spaces: dict[str, _WorkerSpace] = {}
        h = self.eng._create_handle(args.cap, args.tier)
        self.ctl.track(args.space, h)
        self.spaces[args.space] = _WorkerSpace(
            h, self.ctl, args.space, args.cap, args.journal_dir, 0)
        self.epoch: int | None = None
        self.restore_ms: list[float] = []
        self.conn = GWConnection(PacketConnection(
            connect_tcp((args.host, args.port), timeout=10.0)))
        self.conn.send_set_game_id(
            args.game_id, False,
            [eid for sp in self.spaces.values() for eid in sp.slot])
        self.conn.flush()

    def run(self) -> int:
        args = self.args
        while True:
            pkt = self.conn.recv_packet()
            if pkt is None:
                return 1  # dispatcher gone
            # clu.zombie: a stall here parks the whole packet loop -- the
            # lease lapses, our spaces fail over, and everything we send
            # after resuming is fenced (the split-brain probe)
            faults.check("clu.zombie")
            rc = self._handle(pkt)
            if rc is not None:
                return rc
            if all(sp.last >= args.ticks for sp in self.spaces.values()):
                for sp in self.spaces.values():
                    sp.ctl.close()
                self._write_stats()
                return 0

    def _handle(self, pkt) -> int | None:
        msgtype = pkt.read_u16()
        if msgtype == MT.MT_SYNC_POSITION_YAW_FROM_CLIENT:
            self._apply_sync(pkt)
            if self.epoch is not None:
                # piggyback the snapshot like the real GameService does,
                # so the parent dispatcher federates this worker's series
                metrics = (telemetry.snapshot()
                           if telemetry.enabled() else None)
                if metrics is None:
                    self.conn.send_game_lease_renew(
                        self.args.game_id, self.epoch, sorted(self.spaces))
                else:
                    self.conn.send_game_lease_renew(
                        self.args.game_id, self.epoch, sorted(self.spaces),
                        metrics=metrics)
                self.conn.flush()
        elif msgtype == MT.MT_GAME_LEASE_GRANT:
            self.epoch = pkt.read_u32()
            pkt.read_f32()  # ttl: renewal here is per-batch, not timed
        elif msgtype == MT.MT_REHOME_SPACES:
            self._rehome(pkt)
        elif msgtype == MT.MT_REPLAY_MOVES:
            pkt.read_u16()  # dead gid
            n = pkt.read_u32()
            for _ in range(n):
                body = Packet(bytearray(pkt.read_varbytes()))
                assert body.read_u16() == MT.MT_SYNC_POSITION_YAW_FROM_CLIENT
                self._apply_sync(body)
        elif msgtype == MT.MT_GAME_SHUTDOWN:
            print("fenced: shutdown notice", file=sys.stderr)
            return 3
        return None  # anything else (deployment ready, srvdis, ...) ignored

    def _apply_sync(self, pkt) -> None:
        """One regrouped batch = one engine tick for each space it names.
        Dedup by stamp: batches at or below a space's last applied tick
        (the replayed prefix the restored checkpoint already covers) are
        dropped -- the exactly-once half of the failover argument."""
        per_space: dict[str, list] = {}
        stamp = 0
        # defensive: the dispatcher re-stamps relayed batches with a trace
        # trailer when telemetry is on; strip it before the stride-32 loop
        tracectx.try_strip(pkt)
        while pkt.remaining() > 0:
            eid = pkt.read_entity_id()
            x, y, z, _yaw = _REC.unpack(pkt.read_bytes(16))
            stamp = int(round(y))
            for sp in self.spaces.values():
                s = sp.slot.get(eid)
                if s is not None:
                    per_space.setdefault(sp.id, []).append((s, x, z))
                    break
        for sid, recs in per_space.items():
            sp = self.spaces[sid]
            if stamp <= sp.last:
                continue
            for s, x, z in recs:
                sp.x[s] = x
                sp.z[s] = z
            self.eng.submit(sp.h, sp.x, sp.z, sp.r, sp.act)
            self.eng.flush()
            e, lv = self.eng.take_events(sp.h)
            crc, n = _tick_crc(e, lv)
            sp.jf.write(f"{stamp} {crc:08x} {n}\n")
            sp.last = stamp
            sp.ctl.capture(sid, stamp)

    def _rehome(self, pkt) -> None:
        dead_gid = pkt.read_u16()
        epoch = pkt.read_u32()
        n = pkt.read_u32()
        # fresh controller over the DEAD game's checkpoint namespace: the
        # filesystem kvdb replays its manifest log at open, so only a
        # fresh open sees everything the dead process landed before the
        # kill.  The adopted spaces keep checkpointing through it -- their
        # manifest chains stay monotonic where they already live.
        store, kv = _open_backends(
            os.path.join(self.args.ckpt_dir, f"game{dead_gid}"))
        ctl = CheckpointController(self.eng, store, kv,
                                   mode="continuous", interval=4)
        for _ in range(n):
            sid = pkt.read_varstr()
            t0 = time.perf_counter()
            try:
                faults.check("clu.restore")
                res = ctl.restore_into(self.eng, sid, tier=self.args.tier)
            except Exception as e:
                print(f"rehome {sid} failed: {e!r}", file=sys.stderr)
                continue
            if res is None:
                print(f"rehome {sid}: no consistent checkpoint",
                      file=sys.stderr)
                continue
            self.restore_ms.append((time.perf_counter() - t0) * 1e3)
            h, tick, ck_epoch = res
            sp = _WorkerSpace(h, ctl, sid, self.args.cap,
                              self.args.journal_dir, tick)
            self.spaces[sid] = sp
            sp.jf.write(f"# restored epoch={ck_epoch} tick={tick} "
                        f"ownership={epoch}\n")

    def _write_stats(self) -> None:
        """The worker's own numbers beside its journals, at a clean exit:
        the hand-written kernels' launches (``ops/aoi_cuda.launches`` and
        ``ops/events_cuda.launches``) and each adopted space's restore
        ms."""
        from ..ops import aoi_cuda, events_cuda

        with open(os.path.join(self.args.journal_dir, "worker.json"),
                  "w") as f:
            json.dump({"launches": {**aoi_cuda.launches,
                                    **events_cuda.launches},
                       "restore_ms": self.restore_ms}, f)


def _worker_main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="failover game worker (raw wire client)")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--game-id", type=int, required=True)
    ap.add_argument("--space", required=True)
    ap.add_argument("--cap", type=int, default=48)
    ap.add_argument("--ticks", type=int, default=48)
    ap.add_argument("--tier", default="cuda", choices=("cpu", "cpp", "cuda"))
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--journal-dir", required=True)
    args = ap.parse_args(argv)
    os.makedirs(args.journal_dir, exist_ok=True)
    # black box beside the shared checkpoint store (GW_FLIGHT_DIR, if the
    # harness set it, already won at import); with GW_FLIGHT_INTERVAL_S the
    # heartbeat is what leaves a post-mortem behind after SIGKILL
    flight.configure(dir=os.path.join(args.ckpt_dir, "flight"),
                     component=f"game{args.game_id}")
    return _Worker(args).run()


# -- parent harness ----------------------------------------------------------


def _oracle_crcs(cap: int, frames,
                 oracle_tier: str = "cpu") -> tuple[dict, dict]:
    """{tick: crc_hex}, {tick: n_events} of an unkilled in-process run --
    the same submit/flush/take_events sequence the workers execute, on
    ``oracle_tier``."""
    from .aoi import AOIEngine

    eng = AOIEngine(device="cpu")  # a host tier: no tensor is made
    h = eng._create_handle(cap, oracle_tier)
    r = np.full(cap, 100.0, np.float32)
    act = np.ones(cap, bool)
    crcs, counts = {}, {}
    for t, (x, z) in enumerate(frames, start=1):
        eng.submit(h, x, z, r, act)
        eng.flush()
        e, lv = eng.take_events(h)
        crc, n = _tick_crc(e, lv)
        crcs[t] = f"{crc:08x}"
        counts[t] = n
    return crcs, counts


def _poll(pred, timeout: float, interval: float = 0.005) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def _journal_or_empty(path: str) -> tuple[dict, dict, int]:
    if not os.path.exists(path):
        return {}, {}, -1
    return _read_journal(path)


def _journal_last_tick(path: str) -> int:
    crcs, _, _ = _journal_or_empty(path)
    return max(crcs) if crcs else -1


def host_failover_scenario(base_dir: str, cap: int = 48,
                           world: float = 200.0, ticks: int = 48,
                           kill_at: int = 24, tier: str = "cuda",
                           lease_ttl_s: float = 2.0, pace_s: float = 0.01,
                           seed: int = 17,
                           worker_env: dict | None = None,
                           oracle_tier: str = "cpu") -> dict:
    """Parent harness: dispatcher (leases armed) + 2 worker processes +
    a raw gate link; SIGKILL worker 1 at ``kill_at``; assert the merged
    delivered stream is CRC-equal to the unkilled oracle.  Returns the
    parity verdict, recovery stats and the dispatcher's clu.* counters."""
    from .. import config
    from ..components.dispatcher.service import DispatcherService

    os.makedirs(base_dir, exist_ok=True)
    ck_dir = os.path.join(base_dir, "ckpt")
    # the package's root on the workers' path, wherever they start
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = {**os.environ, **(worker_env or {})}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    j_dirs = {1: os.path.join(base_dir, "j1"), 2: os.path.join(base_dir, "j2")}
    spaces = {1: "w1", 2: "w2"}
    cfg = config.loads(
        "[deployment]\ndispatchers = 1\ngames = 2\ngates = 1\n"
        "[dispatcher1]\nhost = 127.0.0.1\nport = 0\n"
        f"lease_ttl_s = {lease_ttl_s}\n")
    disp = DispatcherService(1, cfg).start()
    host, port = disp.addr
    procs: dict[int, subprocess.Popen] = {}
    gate = None
    try:
        for gid in (1, 2):
            procs[gid] = subprocess.Popen(
                [sys.executable, "-m", "goworld_tpu_torch.engine.failover",
                 "--worker", "--host", host, "--port", str(port),
                 "--game-id", str(gid), "--space", spaces[gid],
                 "--cap", str(cap), "--ticks", str(ticks), "--tier", tier,
                 "--ckpt-dir", ck_dir, "--journal-dir", j_dirs[gid]],
                env=env)
        if not _poll(lambda: len(disp.entities) >= 2 * cap, WAIT_S):
            raise RuntimeError("workers failed to register")
        gate = GWConnection(PacketConnection(
            connect_tcp((host, port), timeout=10.0)))
        gate.send_set_gate_id(1)
        gate.flush()
        # drain dispatcher->gate traffic so backpressure never stalls it
        def _drain_gate():
            try:
                while gate.recv_packet() is not None:
                    pass
            except (OSError, ValueError):
                pass
        threading.Thread(target=_drain_gate, daemon=True).start()

        frames = {gid: _walk_frames(cap, world, ticks, seed + gid)
                  for gid in (1, 2)}
        eids = {gid: _space_eids(spaces[gid], cap) for gid in (1, 2)}
        crash_j = os.path.join(j_dirs[1], "w1.journal")

        killed_tick = -1
        t0_recover = 0.0
        for t in range(1, ticks + 1):
            p = Packet.for_msgtype(MT.MT_SYNC_POSITION_YAW_FROM_CLIENT)
            for gid in (1, 2):
                x, z = frames[gid][t - 1]
                for i, eid in enumerate(eids[gid]):
                    p.append_entity_id(eid)
                    p.append_bytes(_REC.pack(x[i], float(t), z[i], 0.0))
            gate.send(p)
            gate.flush()
            time.sleep(pace_s)
            if killed_tick < 0 and t >= kill_at:
                # let the victim journal (= deliver) through kill_at, so
                # the crash journal provably overlaps the replay window
                _poll(lambda: _journal_last_tick(crash_j) >= kill_at,
                      WAIT_S)
                faults.check("clu.kill")
                procs[1].send_signal(signal.SIGKILL)
                procs[1].wait(timeout=30)
                killed_tick = _journal_last_tick(crash_j)
                t0_recover = time.perf_counter()
        ok = _poll(lambda: all(
            _journal_last_tick(os.path.join(j_dirs[2], f"{s}.journal"))
            >= ticks for s in spaces.values()), WAIT_S)
        recover_wall_s = time.perf_counter() - t0_recover
        procs[2].wait(timeout=WAIT_S)
    finally:
        if gate is not None:
            gate.close()
        for pr in procs.values():
            if pr.poll() is None:
                pr.kill()
        disp.stop()

    results = {"survivor_done": bool(ok), "killed_tick": killed_tick}
    stats = os.path.join(j_dirs[2], "worker.json")
    if os.path.exists(stats):
        with open(stats) as f:
            results["survivor"] = json.load(f)
    # w1: dead worker's prefix + survivor's post-restore suffix vs oracle
    o_crc, o_n = _oracle_crcs(cap, frames[1], oracle_tier)
    c_crc, c_n, _ = _journal_or_empty(crash_j)
    r_crc, r_n, restored_tick = _journal_or_empty(
        os.path.join(j_dirs[2], "w1.journal"))
    overlap = sorted(set(c_crc) & set(r_crc))
    replay_ok = all(c_crc[t] == r_crc[t] for t in overlap)
    merged, merged_n = dict(c_crc), dict(c_n)
    merged.update(r_crc)
    merged_n.update(r_n)
    parity_ok = (replay_ok and set(merged) == set(o_crc)
                 and all(merged[t] == o_crc[t] for t in o_crc))
    # w2: the survivor's own space must be untouched by the failover
    o2_crc, _o2_n = _oracle_crcs(cap, frames[2], oracle_tier)
    w2_crc, _, _ = _journal_or_empty(os.path.join(j_dirs[2], "w2.journal"))
    w2_ok = (set(w2_crc) == set(o2_crc)
             and all(w2_crc[t] == o2_crc[t] for t in o2_crc))
    results.update({
        "ticks": ticks,
        "kill_tick": kill_at,
        "restored_tick": restored_tick,
        "ticks_to_recover": (killed_tick - restored_tick
                             if restored_tick >= 0 else -1),
        "recover_wall_s": recover_wall_s,
        "replayed_overlap_ticks": len(overlap),
        "replay_parity_ok": bool(replay_ok),
        "parity_ok": bool(parity_ok),
        "survivor_space_ok": bool(w2_ok),
        "events_lost": int(sum(o_n.values())
                           - sum(merged_n.get(t, 0) for t in o_n)),
        "oracle_events": int(sum(o_n.values())),
        "clu_stats": dict(disp.clu_stats),
    })
    return results


if __name__ == "__main__":
    if "--worker" in sys.argv[1:]:
        sys.exit(_worker_main(sys.argv[1:]))
    import argparse

    ap = argparse.ArgumentParser(description="host-failover scenario")
    ap.add_argument("--dir", required=True)
    ap.add_argument("--ticks", type=int, default=48)
    ap.add_argument("--kill-at", type=int, default=24)
    ap.add_argument("--cap", type=int, default=48)
    ap.add_argument("--tier", default="cuda", choices=("cpu", "cpp", "cuda"))
    args = ap.parse_args()
    res = host_failover_scenario(args.dir, cap=args.cap, ticks=args.ticks,
                                 kill_at=args.kill_at, tier=args.tier)
    print(res)
    sys.exit(0 if res["events_lost"] == 0 and res["parity_ok"] else 1)
