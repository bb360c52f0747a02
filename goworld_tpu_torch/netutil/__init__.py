"""Wire helpers of the port: the pooled binary :class:`~.packet.Packet`
the batched ingest decodes (the rest of the JAX package's ``netutil/``
comes with ROADMAP.md queue 1, item 10)."""

from .packet import MAX_PACKET_SIZE, Packet

__all__ = ["MAX_PACKET_SIZE", "Packet"]
