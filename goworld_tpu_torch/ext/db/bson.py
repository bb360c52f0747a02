"""BSON encode/decode (the subset MongoDB commands and entity data use).

Backs the wire-level mongo stack (ext/db/mongowire): both the in-repo
client driver and the hermetic server parse and emit REAL BSON, so the
storage/kvdb mongo backends exercise genuine type mapping on a genuine
socket -- the coverage the reference gets from running its mongodb backend
(engine/storage/backend/mongodb/mongodb.go) against a live mongod in CI.

Types: document, array, utf-8 string, double, int32, int64, bool, null,
binary (subtype 0).  Python ints encode as int32 when they fit (pymongo's
rule), else int64; both decode to int.  Unsupported BSON element types in
input raise rather than corrupt.

The port's copy of the JAX package's ``ext/db/bson.py``: the same bytes
for the same document, so either package's driver talks to the other's
server.
"""

from __future__ import annotations

import struct

_S_I32 = struct.Struct("<i")
_S_I64 = struct.Struct("<q")
_S_F64 = struct.Struct("<d")

_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


class BSONError(ValueError):
    pass


def _encode_value(out: bytearray, key: bytes, v) -> None:
    if isinstance(v, bool):  # before int (bool is an int subclass)
        out += b"\x08" + key + b"\x00" + (b"\x01" if v else b"\x00")
    elif isinstance(v, int):
        if _I32_MIN <= v <= _I32_MAX:
            out += b"\x10" + key + b"\x00" + _S_I32.pack(v)
        elif _I64_MIN <= v <= _I64_MAX:
            out += b"\x12" + key + b"\x00" + _S_I64.pack(v)
        else:
            raise BSONError(f"int out of int64 range: {v}")
    elif isinstance(v, float):
        out += b"\x01" + key + b"\x00" + _S_F64.pack(v)
    elif isinstance(v, str):
        b = v.encode("utf-8")
        out += b"\x02" + key + b"\x00" + _S_I32.pack(len(b) + 1) + b + b"\x00"
    elif v is None:
        out += b"\x0a" + key + b"\x00"
    elif isinstance(v, dict):
        out += b"\x03" + key + b"\x00" + encode(v)
    elif isinstance(v, (list, tuple)):
        out += b"\x04" + key + b"\x00" + encode(
            {str(i): item for i, item in enumerate(v)}
        )
    elif isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        out += b"\x05" + key + b"\x00" + _S_I32.pack(len(b)) + b"\x00" + b
    else:
        raise BSONError(f"cannot BSON-encode {type(v).__name__}")


def encode(doc: dict) -> bytes:
    """dict -> BSON document bytes."""
    body = bytearray()
    for k, v in doc.items():
        if not isinstance(k, str):
            raise BSONError(f"document keys must be str, got {type(k).__name__}")
        kb = k.encode("utf-8")
        if b"\x00" in kb:
            raise BSONError("document key contains NUL")
        _encode_value(body, kb, v)
    return _S_I32.pack(len(body) + 5) + bytes(body) + b"\x00"


def _read_cstring(buf: bytes, at: int) -> tuple[str, int]:
    end = buf.index(b"\x00", at)
    return buf[at:end].decode("utf-8"), end + 1


def _decode_doc(buf: bytes, at: int) -> tuple[dict, int]:
    (total,) = _S_I32.unpack_from(buf, at)
    if total < 5 or at + total > len(buf):
        raise BSONError("truncated document")
    end = at + total - 1  # position of the trailing NUL
    if buf[end] != 0:
        raise BSONError("document missing terminator")
    at += 4
    doc: dict = {}
    while at < end:
        t = buf[at]
        at += 1
        key, at = _read_cstring(buf, at)
        if t == 0x01:
            (doc[key],) = _S_F64.unpack_from(buf, at)
            at += 8
        elif t == 0x02:
            (n,) = _S_I32.unpack_from(buf, at)
            at += 4
            if n < 1 or buf[at + n - 1] != 0:
                raise BSONError("bad string")
            doc[key] = buf[at:at + n - 1].decode("utf-8")
            at += n
        elif t == 0x03:
            doc[key], at = _decode_doc(buf, at)
        elif t == 0x04:
            sub, at = _decode_doc(buf, at)
            doc[key] = [sub[str(i)] for i in range(len(sub))]
        elif t == 0x05:
            (n,) = _S_I32.unpack_from(buf, at)
            at += 4
            subtype = buf[at]
            at += 1
            if subtype not in (0x00, 0x80):
                raise BSONError(f"unsupported binary subtype {subtype:#x}")
            doc[key] = buf[at:at + n]
            at += n
        elif t == 0x08:
            doc[key] = buf[at] != 0
            at += 1
        elif t == 0x0A:
            doc[key] = None
        elif t == 0x10:
            (doc[key],) = _S_I32.unpack_from(buf, at)
            at += 4
        elif t == 0x12:
            (doc[key],) = _S_I64.unpack_from(buf, at)
            at += 8
        else:
            raise BSONError(f"unsupported BSON element type {t:#04x}")
    if at != end:
        raise BSONError("document element overrun")
    return doc, end + 1


def decode(buf: bytes, at: int = 0) -> dict:
    """BSON document bytes -> dict (whole buffer must be one document)."""
    doc, end = _decode_doc(buf, at)
    if end != len(buf):
        raise BSONError("trailing bytes after document")
    return doc


def decode_at(buf: bytes, at: int) -> tuple[dict, int]:
    """Decode one document starting at ``at``; returns (doc, next_offset)."""
    return _decode_doc(buf, at)
