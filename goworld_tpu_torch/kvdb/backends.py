"""KVDB backends: the port's copy of the JAX package's ``KVDBBackend``
and ``FilesystemKVDB`` (``kvdb/backends.py``).

Backend interface: ``get(key) -> str | None``, ``put(key, val)``,
``find(begin, end) -> list[(key, val)]`` over the half-open range
``[begin, end)`` in key order, ``close()``; ``get_or_put`` is built from
get and put.

``FilesystemKVDB`` is an append-only log (one JSON record a line)
replayed into a dict on open: a torn trailing line (a kill -9 mid-append)
is discarded and sealed off with a newline, and the log is compacted when
it grows well past the live key count.
"""

from __future__ import annotations

import json
import logging
import os

log = logging.getLogger("goworld_tpu_torch.kvdb")


class KVDBBackend:
    def get(self, key: str) -> str | None:
        raise NotImplementedError

    def put(self, key: str, val: str) -> None:
        raise NotImplementedError

    def find(self, begin: str, end: str) -> list[tuple[str, str]]:
        raise NotImplementedError

    def get_or_put(self, key: str, val: str) -> str | None:
        """The existing value, or write ``val`` and return None."""
        cur = self.get(key)
        if cur is not None:
            return cur
        self.put(key, val)
        return None

    def close(self) -> None:
        pass


_COMPACT_MIN_LOG = 1024  # a smaller log is never compacted


class FilesystemKVDB(KVDBBackend):
    def __init__(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, "kvdb.log")
        self.data: dict[str, str] = {}
        self._log_records = 0
        self._replay()
        self._compact_if_worthwhile()
        self._seal_torn_tail()
        self._log = open(self.path, "a", encoding="utf-8")

    def _seal_torn_tail(self):
        """A kill -9 mid-append can leave the log without its trailing
        newline; the next record appended straight after would join the
        torn fragment and both lines would be lost at the next replay.
        Close the tail with a newline, so the fragment stays a line of its
        own, discarded."""
        try:
            with open(self.path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                torn = f.read(1) != b"\n"
        except (FileNotFoundError, OSError):
            return  # no log, or an empty one: nothing to seal
        if torn:
            with open(self.path, "ab") as f:
                f.write(b"\n")

    def _replay(self):
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # a torn trailing write
                    self.data[rec["k"]] = rec["v"]
                    self._log_records += 1
        except FileNotFoundError:
            pass

    def _compaction_due(self) -> bool:
        return (self._log_records >= _COMPACT_MIN_LOG
                and self._log_records >= 4 * max(1, len(self.data)))

    def _compact_if_worthwhile(self):
        if not self._compaction_due():
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for k in sorted(self.data):
                f.write(json.dumps({"k": k, "v": self.data[k]}) + "\n")
        os.replace(tmp, self.path)
        self._log_records = len(self.data)

    def get(self, key: str) -> str | None:
        return self.data.get(key)

    def put(self, key: str, val: str) -> None:
        self.data[key] = val
        self._log.write(json.dumps({"k": key, "v": val}) + "\n")
        self._log.flush()
        self._log_records += 1
        if self._compaction_due():
            # the record above is durable already: a failed compaction
            # (a full disk) must not fail the put, and later puts keep
            # appending to the intact log
            self._log.close()
            try:
                self._compact_if_worthwhile()
            except OSError as e:
                log.warning("kvdb compaction failed (will retry later): "
                            "%r", e)
            finally:
                self._log = open(self.path, "a", encoding="utf-8")

    def find(self, begin: str, end: str) -> list[tuple[str, str]]:
        return [(k, self.data[k]) for k in sorted(self.data)
                if begin <= k < end]

    def close(self) -> None:
        self._log.close()
