"""Tick-driven timer scheduler.

A min-heap of (fire_time, seq) entries drained by the game loop each tick
(reference: goTimer wheel ticked from GameService.go:177; per-entity timers
with migration round-trip at Entity.go:271-390).

Entity-facing timers are addressed by a handle and serialize to
``(method_name, interval, repeat, args)`` tuples so they survive migration
and freeze/restore -- the method name is resolved against the entity type on
restore, exactly the property the reference's dump/restore provides.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Any, Callable


class TimerQueue:
    """Process-wide (per logic thread) timer heap.  Not thread-safe by
    design: only the logic thread touches it (workers use post)."""

    def __init__(self, now: Callable[[], float]):
        self._now = now
        self._heap: list[tuple[float, int]] = []
        self._entries: dict[int, "_Timer"] = {}
        self._seq = itertools.count(1)

    def add(self, delay: float, fn: Callable[..., None], *, repeat: bool = False,
            interval: float | None = None, args: tuple = (),
            pass_tid: bool = False) -> int:
        if repeat and (interval is None or interval <= 0):
            raise ValueError("repeating timer needs a positive interval")
        tid = next(self._seq)
        fire = self._now() + max(0.0, delay)
        t = _Timer(fn, bool(repeat), interval or 0.0, args, pass_tid)
        t.fire_at = fire
        self._entries[tid] = t
        heapq.heappush(self._heap, (fire, tid))
        return tid

    def remaining(self, tid: int) -> float | None:
        """Seconds until the timer next fires (None if unknown tid).  Used to
        preserve timer phase across migration/freeze (the dump records time
        remaining, not the original delay)."""
        t = self._entries.get(tid)
        if t is None:
            return None
        return max(0.0, t.fire_at - self._now())

    def cancel(self, tid: int) -> bool:
        return self._entries.pop(tid, None) is not None

    def tick(self, on_error: Callable[[BaseException], None] | None = None) -> int:
        """Fire everything due; returns number fired."""
        now = self._now()
        fired = 0
        while self._heap and self._heap[0][0] <= now:
            _, tid = heapq.heappop(self._heap)
            t = self._entries.get(tid)
            if t is None:  # cancelled
                continue
            if t.repeat:
                t.fire_at = now + t.interval
                heapq.heappush(self._heap, (t.fire_at, tid))
            else:
                del self._entries[tid]
            try:
                if t.pass_tid:
                    t.fn(tid, *t.args)
                else:
                    t.fn(*t.args)
            except Exception as e:
                if on_error:
                    on_error(e)
                else:
                    raise
            fired += 1
        return fired

    def next_deadline(self) -> float | None:
        while self._heap:
            fire, tid = self._heap[0]
            if tid in self._entries:
                return fire
            heapq.heappop(self._heap)
        return None

    def __len__(self) -> int:
        return len(self._entries)


class _Timer:
    __slots__ = ("fn", "repeat", "interval", "args", "pass_tid", "fire_at")

    def __init__(self, fn, repeat, interval, args, pass_tid=False):
        self.fn = fn
        self.repeat = repeat
        self.interval = interval
        self.args = args
        self.pass_tid = pass_tid
        self.fire_at = 0.0
