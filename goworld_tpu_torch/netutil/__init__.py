"""Wire layer of the port: packets, framing, connections, compression,
packers (the port's copy of the JAX package's ``netutil/``; the KCP and
WebSocket transports come with ROADMAP.md queue 1, item 10c)."""

from .compress import Compressor, new_compressor  # noqa: F401
from .conn import (  # noqa: F401
    COMPRESS_THRESHOLD,
    FrameParser,
    PacketConnection,
    connect_tcp,
    serve_tcp,
)
from .msgpacker import JSONMsgPacker, MessagePackMsgPacker, default_packer  # noqa: F401
from .packet import MAX_PACKET_SIZE, Packet  # noqa: F401
