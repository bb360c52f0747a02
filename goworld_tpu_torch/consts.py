"""Constants of the port: its own copies of the JAX package's
``consts.py`` values (tick cadences, queue bounds, the compression
threshold, the dispatcher's block caps and timeouts) and the names of its
AOI calculators.  This module imports nothing, so every other module can
import it; deployment-varying values live in goworld.ini
(:mod:`.config`), whose defaults come from here."""

# wire protocol
MAX_PACKET_SIZE = 25 * 1024 * 1024  # a packet's largest payload (25 MiB)
COMPRESS_THRESHOLD = 512  # compress payloads >= this many bytes

# main-loop cadence
TICK_INTERVAL_MS = 5
FLUSH_INTERVAL_MS = 5
POSITION_SYNC_INTERVAL_MS = 100

# component inbound queues (messages)
COMPONENT_QUEUE_MAX = 100_000

# dispatcher block/replay state machine
BLOCKED_ENTITY_QUEUE_MAX = 1000
BLOCKED_GAME_QUEUE_MAX = 1_000_000
MIGRATE_BLOCK_TIMEOUT = 60.0
# a slow storage load must keep parked calls queued, not expire them early
LOAD_BLOCK_TIMEOUT = 60.0
FREEZE_BLOCK_TIMEOUT = 10.0

# persistence
ENTITY_SAVE_INTERVAL_S = 300  # 5 min

# ops
OPMON_DUMP_INTERVAL_S = 60.0  # periodic op-table log
TRACE_RING_SPANS = 65536  # completed spans kept by the tracer
TRACE_TICK_MARKS = 1024   # tick boundaries kept for last-N-ticks windowing

# AOI
DEFAULT_AOI_DISTANCE = 100.0
# the calculators a space can get (engine/aoi.py), and the JAX package's
# backend names that the port does not have, with why
AOI_BACKENDS = ("cuda", "cpu", "cpp", "auto")
LATER_AOI_BACKENDS = {
    "tpu": "nothing: the port's device backend is named 'cuda'",
}


def check_aoi_backend(backend) -> None:
    """Raise ValueError unless ``backend`` names one of the port's
    calculators."""
    if backend in AOI_BACKENDS:
        return
    later = LATER_AOI_BACKENDS.get(backend)
    if later is None:
        raise ValueError(f"unknown AOI backend {backend!r} (one of "
                         f"{AOI_BACKENDS})")
    raise ValueError(f"AOI backend {backend!r} is not in the port; it "
                     f"comes with {later}")
