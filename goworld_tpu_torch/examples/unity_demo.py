"""unity_demo equivalent: the baseline AOI scene.

Reference: the reference's examples/unity_demo -- a space with AOI distance
100, players with client-synced positions, monsters with AI that chases
players via their interest sets, a SpaceService capping avatars per space.

The port's twin of ``examples/unity_demo/server.py``: the same game over
``goworld_tpu_torch`` (run it with ``python -m goworld_tpu_torch.cli
start -c goworld_tpu_torch/examples/unity_demo.ini -s
goworld_tpu_torch/examples/unity_demo.py -d run``).
"""

from goworld_tpu_torch.engine.entity import Entity
from goworld_tpu_torch.engine.rpc import OWN_CLIENT, rpc
from goworld_tpu_torch.engine.space import Space
from goworld_tpu_torch.engine.vector import Vector3
from goworld_tpu_torch.services import ServiceManager

AOI_DISTANCE = 100.0
MAX_AVATARS_PER_SPACE = 100


class MySpace(Space):
    def on_space_init(self):
        self.enable_aoi(AOI_DISTANCE)

    def on_entity_enter_space(self, e):
        if e.type_name == "Player":
            # monsters ~ 2x players (reference: MySpace.go:43-47)
            mgr = self.manager
            n_players = sum(
                1 for x in self.entities if x.type_name == "Player"
            )
            n_monsters = sum(
                1 for x in self.entities if x.type_name == "Monster"
            )
            while n_monsters < 2 * n_players:
                mgr.create(
                    "Monster",
                    space=self,
                    pos=Vector3(
                        e.position.x + 30 + 10 * n_monsters, 0, e.position.z + 30
                    ),
                )
                n_monsters += 1


class Player(Entity):
    use_aoi = True
    aoi_distance = AOI_DISTANCE
    all_client_attrs = frozenset({"name", "lv", "hp"})
    client_attrs = frozenset({"exp"})
    persistent_attrs = frozenset({"name", "lv", "hp", "exp"})
    persistent = True

    def on_created(self):
        self.attrs.set_default("name", "noname")
        self.attrs.set_default("lv", 1)
        self.attrs.set_default("hp", 100)
        self.set_client_syncing(True)

    @rpc(expose=OWN_CLIENT)
    def enter_game(self, name):
        self.attrs.set("name", name)
        self.request_space()

    def request_space(self):
        # SpaceService may not be claimed yet right after boot; retry until
        # the srvdis registration lands
        svc = self._runtime().game.services
        if self.space is None or self.space.is_nil:
            if not svc.call_service("SpaceService", "enter_space", self.id):
                self.add_callback(0.5, "request_space")

    @rpc(expose=OWN_CLIENT)
    def whoami(self):
        self.call_client("on_whoami", self.attrs.get_str("name"))

    @rpc
    def do_enter_space(self, space_id):
        self.enter_space(space_id, Vector3(0, 0, 0))


class Monster(Entity):
    use_aoi = True
    aoi_distance = AOI_DISTANCE
    all_client_attrs = frozenset({"name"})

    def on_created(self):
        self.attrs.set("name", "monster")
        self.add_timer(0.1, "ai_tick")

    def ai_tick(self):
        # neighbors() is the lazy-aware accessor: a hook-less clientless
        # entity's interests live in the calculator's packed words
        prey = [e for e in self.neighbors() if e.type_name == "Player"]
        if not prey:
            return
        target = min(prey, key=lambda p: p.position.distance_to(self.position))
        d = target.position.sub(self.position)
        dist = d.distance_to(Vector3())
        if dist > 3.0:
            step = d.normalized().scale(2.0)
            self.set_position(self.position.add(step))
            self.set_yaw(d.dir_to_yaw())


class SpaceService(Entity):
    """Cluster singleton that places avatars into spaces, spinning up a new
    space when the current one is full (reference: unity_demo/SpaceService.go)."""

    def on_init(self):
        self.attrs.get_list("spaces")  # [space_id, ...]
        self.attrs.get_map("counts")   # space_id -> member count

    @rpc
    def enter_space(self, player_eid):
        game = self._runtime().game
        counts = self.attrs.get_map("counts")
        for sid in self.attrs.get_list("spaces"):
            if counts.get_int(sid) < MAX_AVATARS_PER_SPACE:
                counts.set(sid, counts.get_int(sid) + 1)
                game.call_entity(player_eid, "do_enter_space", sid)
                return
        sp = game.rt.entities.create_space("MySpace", kind=1)
        self.attrs.get_list("spaces").append(sp.id)
        counts.set(sp.id, 1)
        game.call_entity(player_eid, "do_enter_space", sp.id)


def setup(game):
    game.register_entity_type(MySpace)
    game.register_entity_type(Player)
    game.register_entity_type(Monster)
    services = ServiceManager(game)
    services.register(SpaceService)
    services.setup()
    game.services = services
