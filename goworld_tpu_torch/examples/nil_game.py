"""nil_game equivalent (reference: examples/nil_game -- the minimal game:
no custom spaces or entities beyond the implicit nil space; proves the
engine boots, reaches deployment readiness, and serves a boot entity).

The port's twin of ``examples/nil_game/server.py``, over
``goworld_tpu_torch``.
"""

from goworld_tpu_torch.engine.entity import Entity
from goworld_tpu_torch.engine.rpc import OWN_CLIENT, rpc


class NilBoot(Entity):
    """Minimal boot entity so clients can connect (the reference nil_game
    configures no boot entity at all; a ping surface makes it testable)."""

    @rpc(expose=OWN_CLIENT)
    def ping(self, x):
        self.call_client("pong", x)


def setup(game):
    game.register_entity_type(NilBoot)
