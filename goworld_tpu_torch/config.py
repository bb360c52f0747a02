"""Cluster configuration: one ini file shared by every process.

Reference model: engine/config/read_config.go -- sections ``[dispatcherN]``,
``[gameN]``, ``[gateN]`` with ``*_common`` inheritance, a ``[deployment]``
section declaring desired counts, strict unknown-section validation.

Example (tests/ and examples/ ship real ones):

    [deployment]
    dispatchers = 1
    games = 2
    gates = 1

    [dispatcher1]
    host = 127.0.0.1
    port = 16001

    [game_common]
    aoi_backend = cuda
    aoi_device = cuda
    position_sync_interval_ms = 100

    [game1]
    [game2]

    [gate1]
    host = 127.0.0.1
    port = 17001

The port's copy of the JAX package's ``config.py``: the same grammar,
sections and strictness.  What differs is the game's AOI: ``aoi_backend``
takes the port's calculators (``cuda`` by default; ``tpu`` is refused),
``aoi_tpu_min_capacity`` is ``aoi_cuda_min_capacity`` (the old key is
refused with a message that names the new one), and ``aoi_device`` is the
torch device the ``cuda`` backend's tensors live on (``cuda`` by
default; ``cpu`` runs the kernels' plain PyTorch versions).
"""

from __future__ import annotations

import configparser
from dataclasses import dataclass, field

from . import consts


@dataclass
class DispatcherConfig:
    host: str = "127.0.0.1"
    port: int = 16001
    http_port: int = 0
    # enable the unified telemetry layer (metrics instruments + tick span
    # tracing -- docs/observability.md); exposition rides http_port
    telemetry: bool = False
    # cluster supervision (docs/robustness.md "Cluster supervision & host
    # failover"): > 0 arms lease-based liveness -- every registered game is
    # granted an ownership epoch and must renew within this many seconds or
    # its spaces are failed over to the least-loaded survivor; stale-epoch
    # packets are fenced.  0 (the default) keeps the classic
    # disconnect-only death detection.
    lease_ttl_s: float = 0.0
    # bounded per-game buffer of regrouped client movement batches kept for
    # failover replay (the "since the last consistent epoch" window);
    # oldest-first overflow
    lease_replay_cap: int = 256


@dataclass
class GameConfig:
    # cuda (the step kernel on aoi_device) | cpu (python sweep) | cpp
    # (native sweep) | auto (route each space by capacity: >=
    # aoi_cuda_min_capacity goes to the cuda bucket, smaller spaces to the
    # native host calculator -- a 1k-entity space is launch-bound on a
    # card while the native sweep finishes in microseconds; a 8k+ space
    # is the reverse)
    aoi_backend: str = "cuda"
    # the torch device of the cuda bucket: cuda (raises without a card) or
    # cpu (the kernels' plain PyTorch versions)
    aoi_device: str = "cuda"
    aoi_cuda_min_capacity: int = 4096
    # with a mesh: a single space at or above this capacity shards its
    # interest ROWS over the chips (engine/aoi_rowshard -- the oversized-
    # hot-space answer); below it, spaces shard whole
    aoi_rowshard_min_capacity: int = 65536
    # >0 with aoi_backend=cuda/auto: shard every cuda bucket's spaces over
    # an N-device mesh (engine/aoi_mesh); 0 = single device
    aoi_mesh_devices: int = 0
    # double-buffer the cuda flush: AOI events arrive one tick late, device
    # and D2H time overlap the host tick (engine/aoi.py)
    aoi_pipeline: bool = False
    # durable world state (engine/checkpoint.py): off | interval |
    # continuous.  Non-off streams per-space incremental checkpoints into
    # the [storage]/[kvdb] backends (GameService.attach_checkpoints)
    aoi_checkpoint: str = "off"
    aoi_checkpoint_interval: int = 16
    tick_interval_ms: int = consts.TICK_INTERVAL_MS
    position_sync_interval_ms: int = consts.POSITION_SYNC_INTERVAL_MS
    save_interval_s: int = consts.ENTITY_SAVE_INTERVAL_S
    boot_entity: str = ""
    log_file: str = ""
    http_port: int = 0
    # enable the unified telemetry layer (metrics instruments + tick span
    # tracing -- docs/observability.md); exposition rides http_port
    telemetry: bool = False


@dataclass
class GateConfig:
    host: str = "127.0.0.1"
    port: int = 17001
    websocket_port: int = 0
    kcp_port: int = 0
    compression: str = "gwlz"
    heartbeat_timeout_s: float = 30.0
    position_sync_interval_ms: int = consts.POSITION_SYNC_INTERVAL_MS
    log_file: str = ""
    http_port: int = 0
    # enable the unified telemetry layer (metrics instruments + tick span
    # tracing -- docs/observability.md); exposition rides http_port
    telemetry: bool = False
    # both set -> TLS on the TCP and WebSocket listeners (reference:
    # GateService.go:97-118)
    tls_cert: str = ""
    tls_key: str = ""


@dataclass
class StorageConfig:
    backend: str = "filesystem"  # filesystem|sqlite|redis|redis_cluster|mongodb|mysql
    directory: str = "entity_storage"  # directory-kind backends
    host: str = "127.0.0.1"  # server-kind backends (redis/mongodb/mysql)
    port: int = 6379
    db: int = 0
    addrs: str = ""  # cluster-kind backends: "host:port,host:port,..."
    user: str = "root"  # sql-server backends (mysql)
    password: str = ""


@dataclass
class KVDBConfig:
    backend: str = "filesystem"  # filesystem|sqlite|redis|redis_cluster|mongodb|mysql
    directory: str = "kvdb"
    host: str = "127.0.0.1"
    port: int = 6379
    db: int = 0
    addrs: str = ""  # cluster-kind backends: "host:port,host:port,..."
    user: str = "root"  # sql-server backends (mysql)
    password: str = ""


@dataclass
class ClusterConfig:
    dispatchers: dict[int, DispatcherConfig] = field(default_factory=dict)
    games: dict[int, GameConfig] = field(default_factory=dict)
    gates: dict[int, GateConfig] = field(default_factory=dict)
    storage: StorageConfig = field(default_factory=StorageConfig)
    kvdb: KVDBConfig = field(default_factory=KVDBConfig)

    def dispatcher_addrs(self) -> list[tuple[str, int]]:
        return [
            (d.host, d.port)
            for _, d in sorted(self.dispatchers.items())
        ]


_KNOWN_PREFIXES = ("dispatcher", "game", "gate")
_KNOWN_SECTIONS = ("deployment", "storage", "kvdb", "game_common", "gate_common",
                   "dispatcher_common", "debug")


# keys of the JAX package's config the port renamed: old -> new
_RENAMED = {"aoi_tpu_min_capacity": "aoi_cuda_min_capacity"}


def _apply(dc, section):
    for key, value in section.items():
        if key in _RENAMED and hasattr(dc, _RENAMED[key]):
            raise ValueError(
                f"config key {key!r} in {type(dc).__name__} is named "
                f"{_RENAMED[key]!r} in the port")
        if not hasattr(dc, key):
            raise ValueError(f"unknown config key {key!r} in {type(dc).__name__}")
        cur = getattr(dc, key)
        if isinstance(cur, bool):
            value = value.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            value = int(value)
        elif isinstance(cur, float):
            value = float(value)
        if key == "aoi_backend":
            consts.check_aoi_backend(value)
        setattr(dc, key, value)


def load(path: str) -> ClusterConfig:
    cp = configparser.ConfigParser()
    read = cp.read(path)
    if not read:
        raise FileNotFoundError(path)
    return parse(cp)


def loads(text: str) -> ClusterConfig:
    cp = configparser.ConfigParser()
    cp.read_string(text)
    return parse(cp)


def parse(cp: configparser.ConfigParser) -> ClusterConfig:
    cfg = ClusterConfig()
    dep = cp["deployment"] if cp.has_section("deployment") else {}
    n_disp = int(dep.get("dispatchers", 1))
    n_games = int(dep.get("games", 1))
    n_gates = int(dep.get("gates", 1))

    for name in cp.sections():
        if name in _KNOWN_SECTIONS:
            continue
        if not any(
            name.startswith(p) and name[len(p) :].isdigit()
            for p in _KNOWN_PREFIXES
        ):
            raise ValueError(f"unknown config section [{name}]")

    def build(prefix, n, cls, common_name):
        out = {}
        for i in range(1, n + 1):
            dc = cls()
            if cp.has_section(common_name):
                _apply(dc, cp[common_name])
            sect = f"{prefix}{i}"
            if cp.has_section(sect):
                _apply(dc, cp[sect])
            out[i] = dc
        return out

    cfg.dispatchers = build("dispatcher", n_disp, DispatcherConfig, "dispatcher_common")
    cfg.games = build("game", n_games, GameConfig, "game_common")
    cfg.gates = build("gate", n_gates, GateConfig, "gate_common")
    # default distinct ports when unspecified
    for i, d in cfg.dispatchers.items():
        if d.port == 16001 and i > 1:
            d.port = 16000 + i
    for i, g in cfg.gates.items():
        if g.port == 17001 and i > 1:
            g.port = 17000 + i
    if cp.has_section("storage"):
        _apply(cfg.storage, cp["storage"])
    if cp.has_section("kvdb"):
        _apply(cfg.kvdb, cp["kvdb"])
    return cfg
