"""Wire layer of the port: packets, framing, connections, compression,
packers, and the KCP and WebSocket transports (the port's copy of the JAX
package's ``netutil/``)."""

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
from . import kcp, websocket  # noqa: F401
