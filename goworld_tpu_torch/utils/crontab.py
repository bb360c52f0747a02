"""Minute-resolution crontab (the port's copy of the JAX package's
``utils/crontab.py``).

Entries match on (minute, hour, day, month, dayofweek); a non-negative
field must equal the current value, a negative field ``-N`` means "every
N" (value % N == 0).  ``dayofweek`` accepts 0..7 with both 0 and 7
meaning Sunday and ``-1`` meaning any weekday; :func:`validate` bounds
the fields.

The logic loop calls :meth:`Crontab.maybe_check` every tick (the
runtime's ``tick.timers`` phase); entries fire once per wall-clock
minute, on the first tick at or after the minute boundary.  Callbacks
run panicless on the logic thread.
"""

from __future__ import annotations

import time as _time
from datetime import datetime
from typing import Callable

from . import gwlog, gwutils

log = gwlog.logger("crontab")


class _Entry:
    __slots__ = ("minute", "hour", "day", "month", "dayofweek", "cb")

    def __init__(self, minute, hour, day, month, dayofweek, cb):
        self.minute = minute
        self.hour = hour
        self.day = day
        self.month = month
        self.dayofweek = dayofweek
        self.cb = cb

    def match(self, dt: datetime) -> bool:
        for want, have in (
            (self.minute, dt.minute),
            (self.hour, dt.hour),
            (self.day, dt.day),
            (self.month, dt.month),
        ):
            if want >= 0:
                if want != have:
                    return False
            elif have % -want != 0:
                return False
        dow = self.dayofweek
        if dow >= 0:
            # python: Monday=0..Sunday=6; cron: Sunday=0 or 7, Mon=1..Sat=6
            have = (dt.weekday() + 1) % 7  # Sunday=0..Saturday=6
            if dow == 7:
                dow = 0
            if dow != have:
                return False
        return True


def validate(minute: int, hour: int, day: int, month: int, dayofweek: int):
    if minute > 59 or minute < -60:
        raise ValueError(f"invalid minute = {minute}")
    if hour > 23 or hour < -24:
        raise ValueError(f"invalid hour = {hour}")
    if day > 31 or day < -31 or day == 0:
        raise ValueError(f"invalid day = {day}")
    if month > 12 or month < -12 or month == 0:
        raise ValueError(f"invalid month = {month}")
    if dayofweek > 7 or dayofweek < -1:
        raise ValueError(f"invalid dayofweek = {dayofweek}")


class Crontab:
    """Per-logic-thread crontab registry.  Not thread-safe by design (same
    contract as TimerQueue): register/unregister from the logic thread only;
    worker threads must go through post."""

    def __init__(self, wallclock: Callable[[], float] | None = None):
        self._wallclock = wallclock or _time.time
        self._entries: dict[int, _Entry] = {}
        self._next_handle = 1
        self._last_minute: int | None = None

    def register(self, minute: int, hour: int, day: int, month: int,
                 dayofweek: int, cb: Callable[[], None]) -> int:
        """Register ``cb`` to fire whenever the wall-clock matches; returns a
        handle for :meth:`unregister`."""
        validate(minute, hour, day, month, dayofweek)
        h = self._next_handle
        self._next_handle += 1
        self._entries[h] = _Entry(minute, hour, day, month, dayofweek, cb)
        return h

    def unregister(self, handle: int) -> bool:
        return self._entries.pop(handle, None) is not None

    def __len__(self):
        return len(self._entries)

    # -- driving -----------------------------------------------------------
    def maybe_check(self) -> int:
        """Called every tick; fires matching entries once per minute.
        Returns number of callbacks fired (0 when the minute hasn't
        changed)."""
        now = self._wallclock()
        minute_index = int(now // 60)
        if minute_index == self._last_minute:
            return 0
        first = self._last_minute is None
        self._last_minute = minute_index
        if first:
            # don't fire on the very first tick after boot -- only on real
            # minute boundaries observed while running
            return 0
        return self.check_at(datetime.fromtimestamp(minute_index * 60))

    def check_at(self, dt: datetime) -> int:
        """Fire every entry matching ``dt`` (exposed for tests)."""
        fired = 0
        for entry in list(self._entries.values()):
            if entry.match(dt):
                gwutils.run_panicless(entry.cb, logger=log)
                fired += 1
        return fired
