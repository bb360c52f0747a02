"""Constants of the port (its own copies of the JAX package's
``consts.py`` values that its modules use)."""

MAX_PACKET_SIZE = 25 * 1024 * 1024  # a packet's largest payload (25 MiB)
TRACE_RING_SPANS = 65536  # completed spans kept by the tracer
TRACE_TICK_MARKS = 1024   # tick boundaries kept for last-N-ticks windowing
