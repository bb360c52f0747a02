"""test_game equivalent (reference: examples/test_game -- the full engine
exercise: Avatar with filter props, MailService, OnlineService, pubsub
subscriptions, AOITester).  Used by the e2e suite as the "everything at
once" scene.

The port's twin of ``examples/test_game/server.py``: the same game over
``goworld_tpu_torch`` (run it with ``python -m goworld_tpu_torch.cli
start -c goworld_tpu_torch/examples/test_game.ini -s
goworld_tpu_torch/examples/test_game.py -d run``).
"""

from goworld_tpu_torch.engine.entity import Entity
from goworld_tpu_torch.engine.rpc import ALL_CLIENTS, OWN_CLIENT, rpc
from goworld_tpu_torch.engine.space import Space
from goworld_tpu_torch.engine.vector import Vector3
from goworld_tpu_torch.ext.pubsub import PublishSubscribeService
from goworld_tpu_torch.proto.msgtypes import FILTER_OP_EQ
from goworld_tpu_torch.services import ServiceManager
from goworld_tpu_torch.utils.asyncjobs import JobError

AOI_DISTANCE = 100.0


class TestSpace(Space):
    def on_space_init(self):
        self.enable_aoi(AOI_DISTANCE)


class OnlineService(Entity):
    """Tracks online avatars (reference: test_game/OnlineService.go)."""

    def on_init(self):
        self.attrs.get_map("online")  # eid -> name

    @rpc
    def check_in(self, eid, name):
        self.attrs.get_map("online").set(eid, name)

    @rpc
    def check_out(self, eid):
        online = self.attrs.get_map("online")
        if eid in online:
            online.delete(eid)

    @rpc
    def query_online(self, caller_eid):
        self.call_entity(
            caller_eid, "on_online_list",
            sorted(self.attrs.get_map("online").keys()),
        )


class MailService(Entity):
    """Store-and-forward mail through kvdb (reference: test_game/
    MailService.go writes mails through kvdb with ordered ids)."""

    def on_init(self):
        self.attrs.set_default("next_mail_id", 1)

    @rpc
    def send_mail(self, sender_name, target_eid, text):
        kv = self.kvdb
        if kv is None:
            return
        mail_id = self.attrs.get("next_mail_id")
        self.attrs.set("next_mail_id", mail_id + 1)
        key = f"mail${target_eid}${mail_id:010d}"
        kv.put(
            key, f"{sender_name}: {text}",
            callback=lambda _r, t=target_eid: self.call_entity(
                t, "on_mail_delivered", mail_id
            ),
        )

    @rpc
    def fetch_mails(self, caller_eid):
        kv = self.kvdb
        if kv is None:
            return

        def on_found(rows):
            if isinstance(rows, JobError):
                return
            self.call_entity(
                caller_eid, "on_mails", [v for _k, v in rows]
            )

        kv.find(f"mail${caller_eid}$", f"mail${caller_eid}%", on_found)


class Avatar(Entity):
    use_aoi = True
    aoi_distance = AOI_DISTANCE
    all_client_attrs = frozenset({"name"})
    client_attrs = frozenset({"mails_got"})
    persistent_attrs = frozenset({"name"})
    persistent = True

    def on_created(self):
        self.attrs.set_default("name", "anon")
        self.attrs.set_default("mails_got", 0)
        self.set_client_syncing(True)

    def on_client_connected(self):
        self._announce_online()
        self.set_filter_prop("team", "blue")

    @rpc
    def _announce_online(self):
        """check_in + subscribe, retried until the cluster singletons have
        been placed (service reconciliation is periodic, so a client that
        connects during cluster formation must not lose its check-in)."""
        svc = self.game.services if self.game else None
        if svc is None:
            return
        ok = svc.call_service(
            "OnlineService", "check_in", self.id, self.attrs.get("name")
        ) and svc.call_service(
            "PublishSubscribeService", "subscribe", self.id, "broadcast.*"
        )
        if not ok and self.client is not None:
            self.add_callback(0.5, "_announce_online")

    def on_destroy(self):
        svc = self.game.services if self.game else None
        if svc is not None:
            svc.call_service("OnlineService", "check_out", self.id)

    # -- space / aoi -------------------------------------------------------
    @rpc(expose=OWN_CLIENT)
    def join_scene(self):
        scene_id = self.game.srvmap.get("test_scene") if self.game else None
        if scene_id:
            self.enter_space(scene_id, Vector3(10.0, 0.0, 10.0))
        else:
            # scene not declared yet (cluster still forming): retry
            self.add_callback(0.5, "join_scene")

    @rpc(expose=OWN_CLIENT)
    def set_name(self, name):
        self.attrs.set("name", name)

    # -- mail --------------------------------------------------------------
    @rpc(expose=OWN_CLIENT)
    def mail_to(self, target_eid, text):
        svc = self.game.services if self.game else None
        if svc is not None:
            svc.call_service(
                "MailService", "send_mail",
                self.attrs.get("name"), target_eid, text,
            )

    @rpc(expose=OWN_CLIENT)
    def read_mails(self):
        svc = self.game.services if self.game else None
        if svc is not None:
            svc.call_service("MailService", "fetch_mails", self.id)

    @rpc
    def on_mail_delivered(self, mail_id):
        self.attrs.set("mails_got", self.attrs.get("mails_got") + 1)

    @rpc
    def on_mails(self, mails):
        self.call_client("mails", mails)

    # -- pubsub ------------------------------------------------------------
    @rpc(expose=OWN_CLIENT)
    def shout(self, text):
        svc = self.game.services if self.game else None
        if svc is not None:
            svc.call_service(
                "PublishSubscribeService", "publish",
                "broadcast.all", self.attrs.get("name"), text,
            )

    @rpc
    def on_published(self, subject, name, text):
        self.call_client("heard", subject, name, text)

    # -- online list -------------------------------------------------------
    @rpc(expose=OWN_CLIENT)
    def who_is_online(self):
        svc = self.game.services if self.game else None
        if svc is not None:
            svc.call_service("OnlineService", "query_online", self.id)

    @rpc
    def on_online_list(self, eids):
        self.call_client("online_list", eids)

    # -- filtered broadcast ------------------------------------------------
    @rpc(expose=OWN_CLIENT)
    def team_shout(self, text):
        self.call_filtered_clients(
            "team", FILTER_OP_EQ, "blue", "team_heard",
            self.attrs.get("name"), text,
        )


class AOITester(Entity):
    """Server-side AOI assertion entity (reference: test_game/AOITester.go):
    counts enter/leave callbacks and verifies symmetry on demand."""

    use_aoi = True
    aoi_distance = AOI_DISTANCE

    def on_created(self):
        self.enters = 0
        self.leaves = 0

    def on_enter_aoi(self, other):
        self.enters += 1

    def on_leave_aoi(self, other):
        self.leaves += 1

    @rpc
    def assert_consistent(self):
        assert self.enters >= self.leaves, (
            f"AOI leave without enter: {self.enters} < {self.leaves}"
        )
        assert len(self.interested_in) == self.enters - self.leaves, (
            "interest set out of sync with enter/leave events"
        )


def make_scene(game):
    """Game 1 creates the shared scene + declares it via srvdis."""
    sp = game.rt.entities.create_space("TestSpace", kind=1)
    game.declare_service("test_scene", sp.id)
    return sp


def setup(game):
    game.register_entity_type(TestSpace)
    game.register_entity_type(Avatar)
    game.register_entity_type(AOITester)
    services = ServiceManager(game)
    services.register(OnlineService)
    services.register(MailService)
    services.register(PublishSubscribeService)
    services.setup()
    game.services = services


def on_ready(game):
    if game.id == 1:
        make_scene(game)
