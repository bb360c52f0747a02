"""Binary packets (port copy): pooled buffers with typed little-endian
append/read.

The port's copy of the JAX package's ``netutil/packet.py``: a Packet
wraps a bytearray from a size-classed free pool; reads use a cursor.
Wire scalar encoding: little-endian; EntityID/ClientID are fixed 16-byte
ascii; varstr is u32 length + utf-8 bytes.  The msgpack ``data`` blobs
(``append_data`` / ``read_data`` / ``append_args`` / ``read_args``)
come with the game service (ROADMAP.md queue 1, item 10).
"""

from __future__ import annotations

import struct
import threading

from ..consts import MAX_PACKET_SIZE  # noqa: F401  (re-export; 25 MiB)
from ..engine.ids import ID_LENGTH

_POOL_CLASSES = (256, 1024, 8192, 65536, 1 << 20)
_POOL_MAX_EACH = 256

_u16 = struct.Struct("<H")
_u32 = struct.Struct("<I")
_u64 = struct.Struct("<Q")
_f32 = struct.Struct("<f")


class _Pool:
    def __init__(self):
        self._lock = threading.Lock()
        self._free: dict[int, list[bytearray]] = {c: [] for c in _POOL_CLASSES}

    def get(self, need: int) -> bytearray:
        for c in _POOL_CLASSES:
            if need <= c:
                with self._lock:
                    lst = self._free[c]
                    if lst:
                        buf = lst.pop()
                        del buf[:]
                        return buf
                return bytearray()
        return bytearray()

    def put(self, buf: bytearray):
        cap = len(buf)
        for c in _POOL_CLASSES:
            if cap <= c:
                with self._lock:
                    lst = self._free[c]
                    if len(lst) < _POOL_MAX_EACH:
                        lst.append(buf)
                return


_pool = _Pool()


class Packet:
    """An outgoing or incoming message payload (msgtype + body)."""

    __slots__ = ("buf", "rpos")

    def __init__(self, buf: bytearray | None = None):
        self.buf = buf if buf is not None else _pool.get(256)
        self.rpos = 0

    @classmethod
    def for_msgtype(cls, msgtype: int) -> "Packet":
        p = cls()
        p.append_u16(msgtype)
        return p

    def release(self):
        """Return the buffer to the pool.  The packet must not be used after."""
        buf, self.buf = self.buf, None  # type: ignore[assignment]
        if buf is not None:
            _pool.put(buf)

    # -- appends -----------------------------------------------------------
    def append_u8(self, v: int):
        self.buf.append(v & 0xFF)

    def append_u16(self, v: int):
        self.buf += _u16.pack(v)

    def append_u32(self, v: int):
        self.buf += _u32.pack(v)

    def append_u64(self, v: int):
        self.buf += _u64.pack(v)

    def append_f32(self, v: float):
        self.buf += _f32.pack(v)

    def append_bool(self, v: bool):
        self.buf.append(1 if v else 0)

    def append_bytes(self, b: bytes):
        self.buf += b

    def append_entity_id(self, eid: str):
        raw = eid.encode("ascii")
        if len(raw) != ID_LENGTH:
            raise ValueError(f"bad entity id {eid!r}")
        self.buf += raw

    append_client_id = append_entity_id

    def append_varstr(self, s: str):
        raw = s.encode("utf-8")
        self.append_u32(len(raw))
        self.buf += raw

    def append_varbytes(self, b: bytes):
        self.append_u32(len(b))
        self.buf += b

    # -- reads -------------------------------------------------------------
    def _take(self, n: int) -> memoryview:
        if self.rpos + n > len(self.buf):
            raise ValueError("packet underflow")
        mv = memoryview(self.buf)[self.rpos : self.rpos + n]
        self.rpos += n
        return mv

    def read_u8(self) -> int:
        return self._take(1)[0]

    def read_u16(self) -> int:
        return _u16.unpack(self._take(2))[0]

    def read_u32(self) -> int:
        return _u32.unpack(self._take(4))[0]

    def read_u64(self) -> int:
        return _u64.unpack(self._take(8))[0]

    def read_f32(self) -> float:
        return _f32.unpack(self._take(4))[0]

    def read_bool(self) -> bool:
        return self._take(1)[0] != 0

    def read_bytes(self, n: int) -> bytes:
        return bytes(self._take(n))

    def read_entity_id(self) -> str:
        return bytes(self._take(ID_LENGTH)).decode("ascii")

    read_client_id = read_entity_id

    def read_varstr(self) -> str:
        n = self.read_u32()
        return bytes(self._take(n)).decode("utf-8")

    def read_varbytes(self) -> bytes:
        n = self.read_u32()
        return bytes(self._take(n))

    def read_view(self, n: int) -> memoryview:
        """Consume ``n`` bytes and return them as a zero-copy memoryview
        (the batched ingest decodes flat record arrays straight out of the
        packet buffer -- ingest/).  The view aliases the pooled
        buffer: consumers must copy anything that outlives the packet."""
        return self._take(n)

    # -- misc --------------------------------------------------------------
    @property
    def payload(self) -> bytes:
        return bytes(self.buf)

    def remaining(self) -> int:
        return len(self.buf) - self.rpos

    def __len__(self) -> int:
        return len(self.buf)
