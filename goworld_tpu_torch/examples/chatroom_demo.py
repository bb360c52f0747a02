"""chatroom_demo equivalent (reference: examples/chatroom_demo -- account
register/login via KVDB, LoadEntityAnywhere + GiveClientTo handoff, room
switching broadcast via filtered client calls).

Flow (reference Account.go:20-121):
  * boot entity is an Account; client calls register(username, password)
    -> kvdb get/put ("password$<u>"), creates+saves an Avatar, stores
    "avatarID$<u>";
  * login(username, password) -> kvdb checks -> LoadEntityAnywhere(Avatar)
    -> call avatar "get_room" -> GiveClientTo(avatar);
  * avatar joins a chat room by setting its client filter prop "room" and
    says things via CallFilteredClients(room == X, "hear", ...).

The port's twin of ``examples/chatroom_demo/server.py``: the same game over
``goworld_tpu_torch`` (run it with ``python -m goworld_tpu_torch.cli
start -c goworld_tpu_torch/examples/chatroom_demo.ini -s
goworld_tpu_torch/examples/chatroom_demo.py -d run``).
"""

from goworld_tpu_torch.engine.entity import Entity
from goworld_tpu_torch.engine.rpc import OWN_CLIENT, rpc
from goworld_tpu_torch.proto.msgtypes import FILTER_OP_EQ
from goworld_tpu_torch.utils.asyncjobs import JobError


class Account(Entity):
    def on_created(self):
        self.logining = False

    @rpc(expose=OWN_CLIENT)
    def register(self, username, password):
        kv = self.kvdb
        if kv is None:
            self.call_client("show_error", "no kvdb attached")
            return

        def on_claimed(existing):
            if isinstance(existing, JobError):
                self.call_client("show_error", "server error")
                return
            if existing is not None:
                # get_or_put returned a prior value: the name was taken --
                # atomic on the ordered kvdb worker, so two simultaneous
                # registrations cannot both claim it
                self.call_client("show_error", "account already exists")
                return
            # create the avatar record (reference: CreateEntityLocally +
            # immediate destroy to force one save, Account.go:33-36)
            avatar = self.manager.create("Avatar")
            avatar.attrs.set("name", username)
            avatar_id = avatar.id
            game = self.game
            if game is not None and game.storage is not None:
                game.storage.save(
                    "Avatar", avatar_id, avatar.persistent_data()
                )
            avatar.destroy()
            kv.put(
                f"avatarID${username}", avatar_id,
                callback=lambda _r: self.call_client(
                    "show_info", "registered; please log in"
                ),
            )

        kv.get_or_put(f"password${username}", password, on_claimed)

    @rpc(expose=OWN_CLIENT)
    def login(self, username, password):
        if self.logining:
            return
        kv = self.kvdb
        if kv is None:
            self.call_client("show_error", "no kvdb attached")
            return
        self.logining = True

        def fail(msg):
            self.logining = False
            self.call_client("show_error", msg)

        def on_password(correct):
            if isinstance(correct, JobError):
                return fail("server error")
            if correct is None:
                return fail("no such account")
            if password != correct:
                return fail("wrong password")
            kv.get(f"avatarID${username}", on_avatar_id)

        def on_avatar_id(avatar_id):
            if isinstance(avatar_id, JobError) or avatar_id is None:
                return fail("server error")
            game = self.game
            if game is not None:
                game.load_entity_anywhere("Avatar", avatar_id)
            # ask the avatar where it is; it answers on_avatar_ready
            # (routed through the dispatcher, queued while it loads)
            self.call_entity(avatar_id, "query_ready", self.id)

        kv.get(f"password${username}", on_password)

    @rpc()
    def on_avatar_ready(self, avatar_id):
        """Avatar answered: it is loaded on this or another game.
        give_client_to handles both: local fast path, or the cross-game
        MT_GIVE_CLIENT_TO handoff (the gate switches its owner entity when
        the avatar's is_player create arrives; the account entity then sees
        on_client_disconnected and cleans itself up)."""
        self.logining = False
        self.give_client_to(avatar_id)

    def on_client_disconnected(self):
        self.destroy()


class Avatar(Entity):
    persistent = True
    persistent_attrs = frozenset({"name", "room"})
    client_attrs = frozenset({"name", "room"})

    def on_created(self):
        self.attrs.set_default("name", "noname")
        self.attrs.set_default("room", "lobby")

    @rpc()
    def query_ready(self, account_id):
        self.call_entity(account_id, "on_avatar_ready", self.id)

    def on_client_connected(self):
        # joining the room = setting the gate-side filter prop
        self.set_filter_prop("room", self.attrs.get("room"))
        self.call_client("show_info", f"welcome {self.attrs.get('name')}")

    @rpc(expose=OWN_CLIENT)
    def enter_room(self, room):
        self.attrs.set("room", room)
        self.set_filter_prop("room", room)
        self.call_client("show_info", f"joined {room}")

    @rpc(expose=OWN_CLIENT)
    def say(self, text):
        room = self.attrs.get("room")
        self.call_filtered_clients(
            "room", FILTER_OP_EQ, room, "hear",
            self.attrs.get("name"), text,
        )


def setup(game):
    game.register_entity_type(Account)
    game.register_entity_type(Avatar)
