"""The port's gate against hostile client traffic, as the JAX package's
(tests/test_gate_robustness.py's scenarios on goworld_tpu_torch):
garbage frames, truncated and oversized frames, abrupt disconnects and
well-framed garbage for known msgtypes must not take the gate down, and
a well-behaved client is still served after them.  The game runs the
cpu calculator on ``aoi_device = cpu``."""

import os
import random
import socket
import struct
import time

import pytest
from torch_threads import one_intra_op_thread  # noqa: F401

from goworld_tpu_torch import config as gwconfig
from goworld_tpu_torch.client import GameClientConnection
from goworld_tpu_torch.components.dispatcher.service import DispatcherService
from goworld_tpu_torch.components.game.service import GameService
from goworld_tpu_torch.components.gate.service import GateService
from goworld_tpu_torch.engine.entity import Entity
from goworld_tpu_torch.engine.rpc import OWN_CLIENT, rpc

CONFIG = """
[deployment]
dispatchers = 1
games = 1
gates = 1

[dispatcher1]
port = 0

[game_common]
boot_entity = RobustAvatar
aoi_backend = cpu
aoi_device = cpu

[gate1]
port = 0
heartbeat_timeout_s = 0
"""


class RobustAvatar(Entity):
    @rpc(expose=OWN_CLIENT)
    def echo(self, text):
        self.call_client("echoed", text)


@pytest.fixture()
def cluster(tmp_path):
    cfg = gwconfig.loads(CONFIG)
    disp = DispatcherService(1, cfg).start()
    cfg.dispatchers[1].host, cfg.dispatchers[1].port = disp.addr
    game = GameService(1, cfg, freeze_dir=str(tmp_path))
    game.register_entity_type(RobustAvatar)
    game.start()
    gate = GateService(1, cfg).start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not game.deployment_ready:
        time.sleep(0.01)
    assert game.deployment_ready
    yield disp, game, gate
    gate.stop()
    game.stop()
    disp.stop()


def _good_client_works(gate, tag):
    c = GameClientConnection(gate.addr)
    assert c.wait_for(lambda c: c.player is not None, 10), f"{tag}: no boot"
    c.call_player("echo", tag)
    assert c.wait_for(
        lambda c: ("echoed", (tag,)) in c.player.calls, 10
    ), f"{tag}: echo lost"
    c.close()


def test_gate_survives_garbage_frames(cluster):
    disp, game, gate = cluster
    _good_client_works(gate, "before")

    rng = random.Random(0)
    attacks = [
        b"GET / HTTP/1.1\r\nHost: x\r\n\r\n",          # plain http
        os.urandom(512),                                 # random bytes
        struct.pack("<I", 0),                            # empty frame
        struct.pack("<I", 10) + b"abc",                  # truncated frame
        struct.pack("<I", 100 * 1024 * 1024),            # oversized length
        struct.pack("<I", 0x80000000 | 16) + os.urandom(16),  # bad compressed
        struct.pack("<I", 6) + struct.pack("<HI", 9999, 1),   # unknown msgtype
        struct.pack("<I", 4) + struct.pack("<H", 2001) + b"",  # short handshake
        bytes(rng.randrange(256) for _ in range(3000)),  # long random stream
    ]
    for i, payload in enumerate(attacks):
        s = socket.create_connection(gate.addr, timeout=5)
        try:
            s.sendall(payload)
            time.sleep(0.05)
        finally:
            s.close()

    # a flood of connect-then-slam clients
    for _ in range(30):
        s = socket.create_connection(gate.addr, timeout=5)
        s.close()

    # the gate must still be fully functional for well-behaved clients
    _good_client_works(gate, "after")
    # and no stale client proxies accumulate forever (gone clients drain)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and len(gate.clients) > 0:
        time.sleep(0.05)
    assert len(gate.clients) <= 1  # at most a raced straggler


def test_gate_survives_malformed_known_msgtypes(cluster):
    disp, game, gate = cluster
    # well-formed frames whose bodies are garbage for their msgtype
    from goworld_tpu_torch.proto import msgtypes as MT

    def frame(body):
        return struct.pack("<I", len(body)) + body

    bodies = [
        struct.pack("<H", MT.MT_CALL_ENTITY_METHOD_FROM_CLIENT) + b"short",
        struct.pack("<H", MT.MT_SYNC_POSITION_YAW_FROM_CLIENT) + b"x" * 7,
        struct.pack("<H", MT.MT_HEARTBEAT) + b"trailing-garbage",
    ]
    s = socket.create_connection(gate.addr, timeout=5)
    try:
        for b in bodies:
            s.sendall(frame(b))
        time.sleep(0.2)
    finally:
        s.close()
    _good_client_works(gate, "post-malformed")
