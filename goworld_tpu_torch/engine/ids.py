"""Entity / client ID generation.

IDs are 16-character URL-safe strings (96 bits): 4 bytes seconds timestamp,
3 bytes machine hash, 2 bytes pid, 3 bytes counter -- ordered, unique across
processes, fixed width so they pack into wire messages at a known offset.
Mirrors the role of the reference's Mongo-ObjectId-style IDs
(reference engine/uuid/uuid.go:27-59) without copying its encoding.
"""

from __future__ import annotations

import base64
import hashlib
import os
import socket
import threading
import time

ID_LENGTH = 16

_counter_lock = threading.Lock()
_counter = int.from_bytes(os.urandom(3), "big")
_machine = hashlib.sha256(socket.gethostname().encode()).digest()[:3]


def gen_id() -> str:
    """A fresh 16-char ID (time-ordered, unique)."""
    global _counter
    with _counter_lock:
        _counter = (_counter + 1) & 0xFFFFFF
        c = _counter
    raw = (
        int(time.time()).to_bytes(4, "big")
        + _machine
        + (os.getpid() & 0xFFFF).to_bytes(2, "big")
        + c.to_bytes(3, "big")
    )
    return base64.urlsafe_b64encode(raw).decode()


def fixed_id(tag: str) -> str:
    """Deterministic ID derived from a tag -- used for per-game nil spaces
    (reference: GenFixedUUID, engine/entity/space_ops.go:43-46)."""
    raw = hashlib.sha256(tag.encode()).digest()[:12]
    return base64.urlsafe_b64encode(raw).decode()


def is_valid_id(s: str) -> bool:
    return isinstance(s, str) and len(s) == ID_LENGTH
