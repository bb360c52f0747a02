"""Message packers (reference: engine/netutil/MsgPacker.go -- MessagePack is
the engine default, JSON available).  The default packer is msgpack with
use_bin_type so bytes/str round-trip distinctly.

The port's copy of the JAX package's ``netutil/msgpacker.py``."""

from __future__ import annotations

import json


class MsgPacker:
    name = "base"

    def pack(self, obj) -> bytes:
        raise NotImplementedError

    def unpack(self, raw: bytes):
        raise NotImplementedError


class MessagePackMsgPacker(MsgPacker):
    name = "messagepack"

    def __init__(self):
        import msgpack

        self._packb = msgpack.packb
        self._unpackb = msgpack.unpackb

    def pack(self, obj) -> bytes:
        return self._packb(obj, use_bin_type=True, default=_default)

    def unpack(self, raw: bytes):
        return self._unpackb(raw, raw=False, strict_map_key=False)


class JSONMsgPacker(MsgPacker):
    name = "json"

    def pack(self, obj) -> bytes:
        return json.dumps(obj, separators=(",", ":")).encode()

    def unpack(self, raw: bytes):
        return json.loads(raw)


class PickleMsgPacker(MsgPacker):
    """Language-native binary codec (reference role: GobMsgPacker.go --
    Go-native gob).  ONLY for links where both ends are this framework's
    own trusted server processes: unpickling attacker-controlled bytes
    executes code, so this packer must never face clients."""

    def pack(self, obj) -> bytes:
        import pickle

        return pickle.dumps(obj, protocol=4)

    def unpack(self, raw: bytes):
        import pickle

        return pickle.loads(raw)


def _default(obj):
    # tuples arrive as lists on the far side (same as the reference's
    # msgpack behavior); sets are not wire types
    if isinstance(obj, tuple):
        return list(obj)
    raise TypeError(f"unpackable type {type(obj).__name__}")


default_packer = MessagePackMsgPacker()
