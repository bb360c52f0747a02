"""Packet compressors (reference role: engine/netutil/compress/compress.go
with formats snappy/gwsnappy/lz4/lzw/flate; gwsnappy is the reference's only
native code -- our native equivalent is the C++ ``gwlz`` codec).

Available codecs:
  * ``gwlz``  -- native C++ LZ77 (native/gwlz.cpp via ctypes); the default
                 when built.  ``make -C native`` builds it; auto-built on
                 first use if g++ is available.
  * ``flate`` -- stdlib zlib (always available; the fallback).
  * ``none``  -- identity.

The port's copy of the JAX package's ``netutil/compress.py``.
"""

from __future__ import annotations

import ctypes
import logging
import os
import shutil
import subprocess
import tempfile
import threading
import zlib

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
# GW_SANITIZED_NATIVE=1 loads the ASAN+UBSAN build (make sanitize) instead
_GWLZ_SO_NAME = ("libgwlz.san.so"
                 if os.environ.get("GW_SANITIZED_NATIVE") == "1"
                 else "libgwlz.so")
_SO_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, _GWLZ_SO_NAME))

_build_lock = threading.Lock()
_log = logging.getLogger("gw.netutil")
_gwlz = None
_gwlz_tried = False


class Compressor:
    name = "base"

    def compress(self, data: bytes) -> bytes:
        raise NotImplementedError

    def decompress(self, data: bytes) -> bytes:
        raise NotImplementedError


class NoCompressor(Compressor):
    name = "none"

    def compress(self, data: bytes) -> bytes:
        return data

    def decompress(self, data: bytes) -> bytes:
        return data


class FlateCompressor(Compressor):
    name = "flate"

    def compress(self, data: bytes) -> bytes:
        return zlib.compress(data, 1)

    def decompress(self, data: bytes) -> bytes:
        return zlib.decompress(data)


class LzmaCompressor(Compressor):
    """High-ratio/slow codec (role of the reference's lz4 "alternative
    format" slot, stdlib-backed)."""

    name = "lzma"

    def compress(self, data: bytes) -> bytes:
        import lzma

        return lzma.compress(data, preset=6)

    def decompress(self, data: bytes) -> bytes:
        import lzma

        return lzma.decompress(data)


class LZWCompressor(Compressor):
    """LZW (reference: compress.go's compress/lzw entry).  Variable-width
    codes 9..12 bits MSB-first, dictionary reset at 4096 entries -- the
    classic GIF/compress scheme, self-contained."""

    name = "lzw"
    _MAX_CODE = 1 << 12

    def compress(self, data: bytes) -> bytes:
        # 4-byte LE uncompressed-length header makes the end of stream
        # exact -- the final byte's padding bits could otherwise decode as a
        # phantom code
        if not data:
            return (0).to_bytes(4, "little")
        table = {bytes([i]): i for i in range(256)}
        next_code = 256
        width = 9
        out = bytearray()
        acc = 0
        nbits = 0

        def emit(code):
            nonlocal acc, nbits
            acc = (acc << width) | code
            nbits += width
            while nbits >= 8:
                nbits -= 8
                out.append((acc >> nbits) & 0xFF)

        cur = b""
        for b in data:
            nxt = cur + bytes([b])
            if nxt in table:
                cur = nxt
                continue
            emit(table[cur])
            if next_code < self._MAX_CODE:
                table[nxt] = next_code
                next_code += 1
                if next_code > (1 << width) and width < 12:
                    width += 1
            else:  # dictionary full: reset (both sides track this)
                table = {bytes([i]): i for i in range(256)}
                next_code = 256
                width = 9
            cur = bytes([b])
        emit(table[cur])
        if nbits:
            out.append((acc << (8 - nbits)) & 0xFF)
        return len(data).to_bytes(4, "little") + bytes(out)

    def decompress(self, data: bytes) -> bytes:
        if len(data) < 4:
            raise ValueError("truncated lzw stream")
        n = int.from_bytes(data[:4], "little")
        table = {i: bytes([i]) for i in range(256)}
        next_code = 256
        width = 9
        acc = 0
        nbits = 0
        out = bytearray()
        prev: bytes | None = None
        # The decoder's table lags the encoder's by one entry (the classic
        # LZW lag; code == next_code is the KwKwK case), so its widen check
        # is ``next_code + 1`` where the encoder's is ``next_code``, and the
        # table reset fires as soon as the lagged add fills the code space
        # (the encoder reset before emitting its next code).
        for byte in data[4:]:
            if len(out) >= n:
                break
            acc = (acc << 8) | byte
            nbits += 8
            while nbits >= width and len(out) < n:
                nbits -= width
                code = (acc >> nbits) & ((1 << width) - 1)
                if code in table:
                    entry = table[code]
                elif prev is not None and code == next_code:
                    entry = prev + prev[:1]  # the KwKwK case
                else:
                    raise ValueError("corrupt lzw stream")
                out += entry
                if prev is not None:
                    table[next_code] = prev + entry[:1]
                    next_code += 1
                    if next_code == self._MAX_CODE:
                        table = {i: bytes([i]) for i in range(256)}
                        next_code = 256
                        width = 9
                        prev = None
                        continue
                    if next_code + 1 > (1 << width) and width < 12:
                        width += 1
                prev = entry
        if len(out) != n:
            raise ValueError("truncated lzw stream")
        return bytes(out)


def _build_gwlz():
    """Build the library in a private directory of ``native/`` and rename
    it into place: the rename is atomic, so a process that finds the file
    finds it whole."""
    tmp = tempfile.mkdtemp(prefix=".build-", dir=_NATIVE_DIR)
    try:
        for name in ("Makefile", "gwlz.cpp"):
            shutil.copy(os.path.join(_NATIVE_DIR, name), tmp)
        subprocess.run(
            ["make", "-C", tmp, "-s", _GWLZ_SO_NAME],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(os.path.join(tmp, _GWLZ_SO_NAME), _SO_PATH)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _load_gwlz():
    """Load (building if needed) the native codec; None if unavailable.

    The processes of a cluster start together and each loads the codec at
    its first connection, so several may build it at once: each builds
    apart and renames (:func:`_build_gwlz`), and none loads a half-written
    file -- which would fall back to flate and leave the peers on
    different codecs.  Within a process the links of a cluster with
    several dispatchers connect on threads of their own at once: the
    attempt is marked done only when it has ended, so a thread that
    arrives meanwhile waits on the lock for its outcome instead of
    reading "tried, none" and falling back alone."""
    global _gwlz, _gwlz_tried
    if _gwlz is not None or _gwlz_tried:
        return _gwlz
    with _build_lock:
        if _gwlz is not None or _gwlz_tried:
            return _gwlz
        try:
            if not os.path.exists(_SO_PATH):
                _build_gwlz()
            try:
                lib = ctypes.CDLL(_SO_PATH)
            except OSError:
                # a file another process is still writing in place (the
                # JAX package's loader runs make on the shared path)
                _build_gwlz()
                lib = ctypes.CDLL(_SO_PATH)
            lib.gwlz_max_compressed.restype = ctypes.c_size_t
            lib.gwlz_max_compressed.argtypes = [ctypes.c_size_t]
            lib.gwlz_compress.restype = ctypes.c_size_t
            lib.gwlz_compress.argtypes = [
                ctypes.c_char_p,
                ctypes.c_size_t,
                ctypes.c_char_p,
                ctypes.c_size_t,
            ]
            lib.gwlz_uncompressed_length.restype = ctypes.c_int64
            lib.gwlz_uncompressed_length.argtypes = [ctypes.c_char_p,
                                                     ctypes.c_size_t]
            lib.gwlz_decompress.restype = ctypes.c_int64
            lib.gwlz_decompress.argtypes = [
                ctypes.c_char_p,
                ctypes.c_size_t,
                ctypes.c_char_p,
                ctypes.c_size_t,
            ]
            _gwlz = lib
        except (OSError, subprocess.SubprocessError) as e:
            _log.warning("libgwlz.so: %r", e)
        finally:
            _gwlz_tried = True
        return _gwlz


class GwlzCompressor(Compressor):
    """Native C++ codec; raises RuntimeError at construction if unavailable."""

    name = "gwlz"

    def __init__(self):
        self._lib = _load_gwlz()
        if self._lib is None:
            raise RuntimeError("libgwlz.so unavailable (g++ build failed?)")

    def compress(self, data: bytes) -> bytes:
        lib = self._lib
        cap = lib.gwlz_max_compressed(len(data))
        out = ctypes.create_string_buffer(cap)
        n = lib.gwlz_compress(data, len(data), out, cap)
        if n == 0 and len(data) > 0:
            raise RuntimeError("gwlz_compress failed")
        return out.raw[:n]

    def decompress(self, data: bytes) -> bytes:
        lib = self._lib
        size = lib.gwlz_uncompressed_length(data, len(data))
        if size < 0:
            raise ValueError("corrupt gwlz stream")
        out = ctypes.create_string_buffer(max(1, size))
        n = lib.gwlz_decompress(data, len(data), out, size)
        if n != size:
            raise ValueError("corrupt gwlz stream")
        return out.raw[:size]


_REGISTRY = {
    "none": NoCompressor,
    "flate": FlateCompressor,
    "lzma": LzmaCompressor,
    "lzw": LZWCompressor,
    "gwlz": GwlzCompressor,
}


def new_compressor(fmt: str) -> Compressor:
    """Reference: compress.NewCompressor (compress.go:19-35).  ``gwlz`` falls
    back to ``flate`` when the native library can't be built."""
    if fmt in ("", "none"):
        return NoCompressor()
    if fmt == "gwlz":
        try:
            return GwlzCompressor()
        except RuntimeError:
            # LOUD fallback: peers must all pick the same codec -- a silent
            # mismatch would surface as corrupt frames on the other side
            _log.warning(
                "libgwlz.so unavailable; falling back to flate -- every "
                "cluster member must agree (set compression=flate in config "
                "if any host lacks a C++ toolchain)"
            )
            return FlateCompressor()
    cls = _REGISTRY.get(fmt)
    if cls is None:
        raise ValueError(f"unknown compression format {fmt!r}")
    return cls()
