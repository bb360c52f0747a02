"""Headless load-test bot client (reference: examples/test_client -- N bots
speaking the full client protocol with strict assertions and a per-op
latency profiler, ClientBot.go / ClientEntity.go / profile.go:19-51).

The port's twin of ``examples/test_client.py``, over the port's
``client.py``.  Pairs with the ``unity_demo`` game script (its Avatar exposes the
``enter_game``/``move`` RPC surface the bots drive); ``test_game``
is the in-process everything-at-once scene exercised by the tests.

    python -m goworld_tpu_torch.examples.test_client \
        --gate 127.0.0.1:17001 -N 50 --duration 30 --strict --profile 1

Strict mode layers three oracles on the live cluster:
  * protocol invariants inside the client mirror (goworld_tpu_torch.client:
    duplicate creates, destroys for unknown mirrors, handshake reuse);
  * attr-mirror invariants: the bot's own writes must round-trip through
    the server's delta stream onto its player mirror;
  * cross-bot AOI visibility: two bots steadily within the interest radius
    must each mirror the other's player entity; steadily far apart they
    must not (the interest sets ARE the product -- this asserts them from
    the outside, against ground-truth positions the bots themselves chose).
"""

from __future__ import annotations

import argparse
import math
import os
import random
import statistics
import sys
import threading
import time

if __name__ == "__main__":  # run as a file: the package's root joins the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from goworld_tpu_torch.client import GameClientConnection

AOI_DISTANCE = 100.0  # unity_demo scene radius (unity_demo.py)
# visibility-oracle hysteresis: only assert when a pair has been steadily
# inside (or outside) these bounds for the full grace window, so in-flight
# enters/leaves and sync latency can't fake a violation
SEE_DIST = 0.7 * AOI_DISTANCE
UNSEE_DIST = 1.8 * AOI_DISTANCE
GRACE_S = 3.0


class SharedTruth:
    """Ground-truth positions each bot reports about itself; the visibility
    oracle reads it to decide which pairs MUST (not) see each other."""

    def __init__(self):
        self.lock = threading.Lock()
        self.pos: dict[int, tuple] = {}  # bot idx -> (player_eid, x, z)

    def report(self, idx, eid, x, z):
        with self.lock:
            self.pos[idx] = (eid, x, z)

    def retract(self, idx):
        """A finished/failed bot must leave the oracle's world: its entity
        is (being) destroyed server-side, so judging against its last
        position would hard-fail every nearby surviving bot."""
        with self.lock:
            self.pos.pop(idx, None)

    def snapshot(self):
        with self.lock:
            return dict(self.pos)


class Stats:
    def __init__(self):
        self.lock = threading.Lock()
        self.samples: dict[str, list[float]] = {}
        self.window: dict[str, list[float]] = {}
        self.counters: dict[str, int] = {}

    def record(self, op, dt):
        with self.lock:
            self.samples.setdefault(op, []).append(dt)
            self.window.setdefault(op, []).append(dt)

    def count(self, name, n):
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def dump_window(self):
        with self.lock:
            win, self.window = self.window, {}
        parts = []
        for op, xs in sorted(win.items()):
            ms = [x * 1e3 for x in xs]
            parts.append(f"{op} n={len(ms)} avg={statistics.mean(ms):.1f}ms "
                         f"max={max(ms):.1f}ms")
        if parts:
            print("[profile] " + "  ".join(parts), flush=True)

    def dump(self):
        for op, xs in sorted(self.samples.items()):
            ms = [x * 1e3 for x in xs]
            p95 = (statistics.quantiles(ms, n=20)[-1]
                   if len(ms) > 20 else max(ms))
            print(f"{op:8s} n={len(ms):<7d} avg={statistics.mean(ms):8.2f}ms "
                  f"p50={statistics.median(ms):8.2f}ms "
                  f"p95={p95:8.2f}ms max={max(ms):8.2f}ms")
        for name, n in sorted(self.counters.items()):
            print(f"{name}: {n}")


class Bot(threading.Thread):
    def __init__(self, addr, idx, duration, strict, stats, truth,
                 transport="tcp", tls=False):
        super().__init__(daemon=True)
        self.addr = addr
        self.transport = transport
        self.tls = tls
        self.idx = idx
        self.duration = duration
        self.strict = strict
        self.stats = stats
        self.truth = truth
        self.ok = False
        self.error = ""
        self.visibility_checks = 0
        self._pair_state: dict[int, tuple] = {}  # oidx -> (zone, eid, since)
        self._oracle_pause_until = 0.0

    def run(self):
        try:
            self._run()
            self.ok = True
        except Exception as e:
            self.error = f"{type(e).__name__}: {e}"
            if self.strict:
                raise
        finally:
            self.truth.retract(self.idx)

    def _assert(self, cond, msg):
        if self.strict:
            assert cond, f"bot{self.idx}: {msg}"

    def _check_visibility(self, c, my_x, my_z, now):
        """Cross-bot AOI oracle: a pair STEADILY in the near (far) zone for
        GRACE_S must (must not) be mirrored.  The per-pair zone tracker
        restarts its clock on every zone change, so fast approaches don't
        assert before the server's enter event can possibly have arrived."""
        if now < self._oracle_pause_until:
            self._pair_state.clear()
            return
        for oidx, (oeid, ox, oz) in self.truth.snapshot().items():
            if oidx == self.idx:
                continue
            d = math.hypot(ox - my_x, oz - my_z)
            zone = "near" if d < SEE_DIST else (
                "far" if d > UNSEE_DIST else "mid")
            prev = self._pair_state.get(oidx)
            if prev is None or prev[0] != zone or prev[1] != oeid:
                self._pair_state[oidx] = (zone, oeid, now)
                continue
            if now - prev[2] < GRACE_S or zone == "mid":
                continue
            if zone == "near":
                self._assert(
                    oeid in c.entities,
                    f"bot{oidx}'s player {oeid} steadily at distance "
                    f"{d:.0f} (< {SEE_DIST:.0f}) for {GRACE_S}s, "
                    f"never mirrored",
                )
            else:
                self._assert(
                    oeid not in c.entities,
                    f"bot{oidx}'s player {oeid} steadily at distance "
                    f"{d:.0f} (> {UNSEE_DIST:.0f}) for {GRACE_S}s, "
                    f"still mirrored",
                )
            self.visibility_checks += 1

    def _run(self):
        rng = random.Random(self.idx)
        t0 = time.perf_counter()
        c = GameClientConnection(self.addr, transport=self.transport,
                                 tls=self.tls, strict=self.strict)
        self._assert(
            c.wait_for(lambda c: c.player is not None, 15), "no boot entity"
        )
        self.stats.record("login", time.perf_counter() - t0)
        c.call_player("enter_game", f"bot{self.idx}")
        # attr-mirror invariant: our own write must round-trip via the
        # server's delta stream
        self._assert(
            c.wait_for(lambda c: c.player is not None
                       and c.player.attrs.get("name") == f"bot{self.idx}", 15),
            "enter_game attr never mirrored",
        )
        # wait to land in the real space (player re-created on space enter)
        time.sleep(0.5)
        c.poll(0.1)
        x, z = rng.uniform(0, 200), rng.uniform(0, 200)
        deadline = time.time() + self.duration
        last_hb = 0.0
        last_vis = 0.0
        last_rx = time.monotonic()
        while time.time() < deadline:
            dx, dz = rng.uniform(-5, 5), rng.uniform(-5, 5)
            x = min(max(x + dx, 0.0), 400.0)
            z = min(max(z + dz, 0.0), 400.0)
            t = time.perf_counter()
            c.send_position(x, 0.0, z)
            handled = c.poll(0.05)
            self.stats.record("tick", time.perf_counter() - t)
            now = time.monotonic()
            if handled:
                last_rx = now
            elif now - last_rx > 1.0:
                # the event stream is stalled (e.g. a hot reload froze the
                # games): visibility timing guarantees are void until the
                # server has also worked through the backlog of moves
                # queued while frozen, so park the oracle well past resume
                self._pair_state.clear()
                self._oracle_pause_until = now + 15.0
            if c.player is not None and len(c.entities) > 1:
                # >1 mirror means we left the nil space (the scene spawns
                # monsters next to every player) -- only then are we a
                # legitimate subject for the cross-bot visibility oracle
                self.truth.report(self.idx, c.player.id, x, z)
            if time.time() - last_hb > 5:
                c.heartbeat()
                last_hb = time.time()
            if self.strict and c.player is not None:
                for e in list(c.entities.values()):
                    assert e.id, "mirror with empty id"
                if now - last_vis > 1.0:
                    self._check_visibility(c, x, z, now)
                    last_vis = now
        for kind, n in c.anomalies.items():
            self.stats.count(f"anomaly.{kind}", n)
        c.close()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--gate", default="127.0.0.1:17001",
        help="gate address, or a comma-separated list -- bots spread over "
             "them round-robin (reference: ClientBot picks any gate, "
             "ClientBot.go:81-84)",
    )
    ap.add_argument("-N", type=int, default=10)
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--strict", action="store_true")
    ap.add_argument("--profile", type=float, default=0.0,
                    help="dump per-op latency every N seconds (reference: "
                         "test_client profile.go:19-51)")
    ap.add_argument("--transport", default="tcp", choices=["tcp", "ws", "kcp"])
    ap.add_argument("--tls", action="store_true")
    args = ap.parse_args()
    addrs = []
    for part in args.gate.split(","):
        part = part.strip()
        if not part:
            continue
        host, port = part.rsplit(":", 1)
        addrs.append((host, int(port)))
    stats = Stats()
    truth = SharedTruth()
    bots = [Bot(addrs[i % len(addrs)], i, args.duration, args.strict, stats,
                truth, transport=args.transport, tls=args.tls)
            for i in range(args.N)]
    for b in bots:
        b.start()
        time.sleep(0.01)
    if args.profile > 0:
        stop = time.monotonic() + args.duration + 5
        while time.monotonic() < stop and any(b.is_alive() for b in bots):
            time.sleep(args.profile)
            stats.dump_window()
    for b in bots:
        b.join(args.duration + 60)
    failed = [b for b in bots if not b.ok]
    stats.dump()
    vis = sum(b.visibility_checks for b in bots)
    if args.strict:
        print(f"visibility checks: {vis}")
    print(f"{len(bots) - len(failed)}/{len(bots)} bots OK")
    for b in failed[:5]:
        print(f"  bot{b.idx} failed: {b.error}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
