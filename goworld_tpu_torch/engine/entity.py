"""Entity: the unit of game logic.

Re-design of the reference's Entity (reference engine/entity/Entity.go:44-70):
identity, attribute tree with client replication classes, RPC, timers, space
membership, AOI interest sets, client binding, migration data.  Differences
from the reference are deliberate and TPU/batch-first:

  * AOI events arrive *batched per tick* from the space's calculator (see
    engine/aoi.py) instead of synchronously during moves;
  * client-bound traffic (creates/destroys/attr deltas/position sync) is
    accumulated per tick and flushed by the runtime's sync phase, mirroring
    the reference's own batched position sync (Entity.go:1221-1267) but
    applied uniformly;
  * RPC exposure is declared with decorators (engine/rpc.py), not name
    suffixes.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Iterable

from .attrs import MapAttr
from .ecs import PositionView
from .vector import Vector3

if TYPE_CHECKING:
    from .manager import EntityManager, EntityTypeDesc
    from .space import Space

# sync-info flags (reference: sifSyncOwnClient/sifSyncNeighborClients,
# Entity.go:1199-1204)
SYNC_OWN = 1
SYNC_NEIGHBORS = 2


class GameClient:
    """Server-side handle to a client connection (reference: GameClient.go).

    Wire ops accumulate in ``outbox`` as (op, *payload) tuples; the runtime's
    sync phase drains them into per-gate packets.  In single-process tests the
    outbox is inspected directly.
    """

    __slots__ = ("client_id", "gate_id", "outbox", "on_dirty")

    def __init__(self, client_id: str, gate_id: int = 0, on_dirty=None):
        self.client_id = client_id
        self.gate_id = gate_id
        self.outbox: list[tuple] = []
        # called on the first op after each drain, so the host component
        # visits only clients with traffic (no per-tick all-entities scan)
        self.on_dirty = on_dirty

    def _push(self, op: tuple):
        if not self.outbox and self.on_dirty is not None:
            self.on_dirty(self)
        self.outbox.append(op)

    # -- ops toward the client (batched) ----------------------------------
    def create_entity(self, e: "Entity", is_player: bool):
        self._push(
            (
                "create_entity",
                e.type_name,
                e.id,
                is_player,
                e.client_visible_attrs(to_owner=is_player),
                e.position.to_tuple(),
                e.yaw,
            )
        )

    def destroy_entity(self, e: "Entity"):
        self._push(("destroy_entity", e.type_name, e.id))

    def attr_delta(self, eid: str, path: tuple, op: str, value: Any):
        self._push(("attr_delta", eid, path, op, value))

    def call_client(self, eid: str, method: str, args: tuple):
        self._push(("call", eid, method, args))


class Entity:
    """Base class for all game entities.  Subclass and register via
    ``EntityManager.register``."""

    # -- subclass-overridable declarations --------------------------------
    # attr replication classes, by top-level attr key
    client_attrs: frozenset[str] = frozenset()
    all_client_attrs: frozenset[str] = frozenset()
    persistent_attrs: frozenset[str] = frozenset()
    # AOI defaults for this type (reference: SetUseAOI, EntityManager.go:51-59)
    use_aoi: bool = False
    aoi_distance: float = 0.0
    # persistence (reference: EntityTypeDesc.IsPersistent)
    persistent: bool = False

    def __init__(self):
        # populated by EntityManager.create; never construct directly
        self.id: str = ""
        self.type_name: str = ""
        self.manager: "EntityManager | None" = None
        self.desc: "EntityTypeDesc | None" = None
        self.attrs = MapAttr()
        self.attrs._owner = self
        # ECS hot/cold split (engine/ecs.py): position and yaw are HOT --
        # while the entity holds an AOI slot they live in the space's
        # columns and these fields are views/fallbacks.  _pos is the
        # detached f64 snapshot (authoritative while slotless); the
        # PositionView reads/writes through to the columns when slotted.
        self._pos = Vector3()
        self._pos_view = PositionView(self)
        self._yaw: float = 0.0
        self.space: "Space | None" = None
        self.aoi_slot: int = -1  # slot in the space's arrays while in a space
        self.interested_in: set[Entity] = set()
        self.interested_by: set[Entity] = set()
        # how many of interested_by have a client -- maintained by
        # _interest/_uninterest/set_client so the sync phase can skip the
        # neighbor fanout for entities nobody's client is watching (the
        # common case: server-side mobs far from any player)
        self._watcher_clients = 0
        self.client: GameClient | None = None
        self.client_syncing = False  # accept client-originated position sync
        self._timer_ids: dict[int, tuple] = {}  # tid -> (method, interval, repeat, args)
        self._sync_flags = 0
        self._attr_deltas: list[tuple] = []  # (path, op, value) this tick
        self.destroyed = False
        # hot-path caches, set by EntityManager.create: the runtime's stable
        # dirty-set object, and whether AOI event replay for this entity is
        # pure set bookkeeping (no client, default hooks -- the batched fast
        # path in Space.dispatch_aoi_events)
        self._dirty_set: set | None = None
        self._plain_aoi = True

    # ------------------------------------------------------------------ api
    def _mark_dirty(self):
        """Register with the runtime's per-tick dirty set so the sync phase
        touches only entities that actually changed (the reference's
        CollectEntitySyncInfos scans every entity each tick, Entity.go:1221
        -- compiled Go affords that; a host-language tick loop does not)."""
        s = self._dirty_set
        if s is not None:
            s.add(self)

    def _recompute_plain(self):
        if self.desc is not None:
            self._plain_aoi = self.client is None and self.desc.plain_aoi_hooks
        else:
            cls = type(self)
            self._plain_aoi = self.client is None and (
                cls.on_enter_aoi is Entity.on_enter_aoi
                and cls.on_leave_aoi is Entity.on_leave_aoi
            )
        if self.aoi_slot >= 0 and self.space is not None:
            self.space._nonplain[self.aoi_slot] = not self._plain_aoi

    def _touch_watched(self):
        """Mirror "some client can see this entity" into the space's
        ``watched`` column (engine/ecs.py) -- the vectorized ingest path's
        sync drain filters flagged movers by it, so it must track every
        _watcher_clients / client transition while slotted."""
        slot = self.aoi_slot
        if slot >= 0 and self.space is not None:
            self.space._cols.watched[slot] = (
                self._watcher_clients > 0 or self.client is not None)

    @property
    def is_space(self) -> bool:
        return False

    def __repr__(self):
        return f"<{self.type_name}:{self.id}>"

    # -- lifecycle hooks (override in subclasses) -------------------------
    def on_init(self):  # attrs attached, not yet in any space
        pass

    def on_created(self):
        pass

    def on_game_ready(self):  # deployment barrier passed
        pass

    def on_enter_space(self):
        pass

    def on_leave_space(self, space: "Space"):
        pass

    def on_destroy(self):
        pass

    def on_enter_aoi(self, other: "Entity"):
        pass

    def on_leave_aoi(self, other: "Entity"):
        pass

    def on_client_connected(self):
        pass

    def on_client_disconnected(self):
        pass

    def on_migrate_out(self):
        pass

    def on_migrate_in(self):
        pass

    def on_freeze(self):
        pass

    def on_restored(self):
        pass

    # -- attrs ------------------------------------------------------------
    def _on_attr_delta(self, path: tuple, op: str, value: Any):
        self._attr_deltas.append((path, op, value))
        self._mark_dirty()

    def client_visible_attrs(self, to_owner: bool) -> dict:
        """Snapshot of attrs visible to a client (own client sees ``client``
        + ``all_clients`` classes; neighbors see ``all_clients`` only)."""
        keys = set(self.all_client_attrs)
        if to_owner:
            keys |= set(self.client_attrs)
        return {k: v for k, v in self.attrs.to_dict().items() if k in keys}

    def persistent_data(self) -> dict:
        return {
            k: v
            for k, v in self.attrs.to_dict().items()
            if k in self.persistent_attrs
        }

    def save(self):
        """Queue an async save of the persistent attr subset (reference:
        Entity.Save; periodic timer per save_interval, Entity.go:215-222)."""
        if not self.persistent or self.destroyed:
            return
        game = getattr(self._runtime(), "game", None)
        storage = getattr(game, "storage", None) if game is not None else None
        if storage is not None:
            storage.save(self.type_name, self.id, self.persistent_data())

    def _flush_attr_deltas(self):
        """Route this tick's attr deltas to own client / neighbor clients."""
        if not self._attr_deltas:
            return
        deltas = self._attr_deltas
        self._attr_deltas = []
        for path, op, value in deltas:
            top = path[0]
            to_owner = top in self.client_attrs or top in self.all_client_attrs
            to_neighbors = top in self.all_client_attrs
            if to_owner and self.client is not None:
                self.client.attr_delta(self.id, path, op, value)
            if to_neighbors:
                for other in self.interested_by:
                    if other.client is not None:
                        other.client.attr_delta(self.id, path, op, value)

    # -- position / AOI ----------------------------------------------------
    @property
    def position(self) -> PositionView:
        """The entity's position as a live view: component access reads
        the space's columns while the entity holds an AOI slot (f32, the
        AOI boundary precision), the detached f64 snapshot otherwise.
        It IS a Vector3 (subclass), so equality/arithmetic keep working."""
        return self._pos_view

    @position.setter
    def position(self, pos: Vector3):
        # plain assignment: update value only (no sync flags -- that is
        # set_position's job).  Read components FIRST: ``pos`` may be this
        # entity's own view.
        x, y, z = pos.x, pos.y, pos.z
        p = self._pos
        p.x = x
        p.y = y
        p.z = z
        slot = self.aoi_slot
        if slot >= 0:
            sp = self.space
            if sp is not None:
                cols = sp._cols
                cols.x[slot] = x
                cols.y[slot] = y
                cols.z[slot] = z
                sp._aoi_dirty = True

    @property
    def yaw(self) -> float:
        slot = self.aoi_slot
        if slot >= 0:
            sp = self.space
            if sp is not None:
                return float(sp._cols.yaw[slot])
        return self._yaw

    @yaw.setter
    def yaw(self, v: float):
        v = float(v)
        self._yaw = v
        slot = self.aoi_slot
        if slot >= 0:
            sp = self.space
            if sp is not None:
                sp._cols.yaw[slot] = v

    def set_position(self, pos: Vector3):
        # the single hottest host call in the engine (once per entity move
        # per tick); space.move_entity is inlined and the dirty-set add uses
        # the cached stable set
        self.position = pos
        if self.client_syncing:
            self._sync_flags |= SYNC_NEIGHBORS
        else:
            # server-driven move must also correct the owner client
            self._sync_flags |= SYNC_OWN | SYNC_NEIGHBORS
        s = self._dirty_set
        if s is not None:
            s.add(self)

    def set_yaw(self, yaw: float):
        self.yaw = float(yaw)
        self._sync_flags |= SYNC_NEIGHBORS
        if not self.client_syncing:
            self._sync_flags |= SYNC_OWN
        self._mark_dirty()

    def set_client_syncing(self, flag: bool):
        """Allow the owner client to drive this entity's position
        (reference: SetClientSyncing, Entity.go:430-440)."""
        self.client_syncing = bool(flag)

    def sync_position_yaw_from_client(self, pos: Vector3, yaw: float):
        if not self.client_syncing or self.space is None:
            return
        self.space.move_entity(self, pos)
        self.yaw = float(yaw)
        self._sync_flags |= SYNC_NEIGHBORS
        self._mark_dirty()

    # interest bookkeeping -- driven by the space's batched AOI events
    # (reference: interest/uninterest, Entity.go:236-246)
    def _interest(self, other: "Entity"):
        # flush other's pending deltas to its *pre-existing* audience before
        # we join it: the snapshot below already contains them, and a mirror
        # that applied both would double-apply non-idempotent ops (APPEND/POP)
        if self.client is not None:
            other._flush_attr_deltas()
        if other not in self.interested_in and self.client is not None:
            other._watcher_clients += 1
            other._touch_watched()
        self.interested_in.add(other)
        other.interested_by.add(self)
        if self.client is not None:
            self.client.create_entity(other, is_player=False)
        self.on_enter_aoi(other)

    def _uninterest(self, other: "Entity"):
        if other in self.interested_in and self.client is not None:
            other._watcher_clients -= 1
            other._touch_watched()
        self.interested_in.discard(other)
        other.interested_by.discard(self)
        if self.client is not None:
            self.client.destroy_entity(other)
        self.on_leave_aoi(other)

    def neighbors(self) -> Iterable["Entity"]:
        """Entities this one is currently interested in (as of the last AOI
        flush).  PLAIN entities -- no client, default hooks -- derive the
        answer from the calculator's packed interest words on demand; their
        ``interested_in``/``interested_by`` sets are intentionally EMPTY
        (event replay for them is a vectorized no-op).  Entities with a
        client or overridden hooks keep eagerly maintained sets."""
        if self._plain_aoi and self.aoi_slot >= 0 and self.space is not None:
            return self.space.derive_interests(self.aoi_slot)
        return self.interested_in

    def observers(self) -> Iterable["Entity"]:
        """Entities currently interested in this one (see neighbors)."""
        if self.aoi_slot >= 0 and self.space is not None \
                and self.space.aoi_enabled:
            return self.space.derive_observers(self.aoi_slot)
        return self.interested_by

    def _materialize_interests(self):
        """Promote lazily tracked interests into the eager sets -- called
        when a plain entity stops being plain (gains a client): the client
        needs create_entity ops and watcher counts for every current
        neighbor, so the packed state must surface."""
        if self.aoi_slot < 0 or self.space is None:
            return
        for other in self.space.derive_interests(self.aoi_slot):
            self.interested_in.add(other)
            other.interested_by.add(self)

    def _dematerialize_interests(self):
        """Inverse of _materialize_interests: the entity became plain again
        (lost its client); its eager sets would go stale because future
        events take the vectorized fast path, so drop them back into the
        packed-only representation."""
        if self.interested_in:
            for other in self.interested_in:
                other.interested_by.discard(self)
            self.interested_in.clear()

    # -- client binding ----------------------------------------------------
    def drop_client_ref(self):
        """Detach the client WITHOUT emitting client ops -- the connection is
        already gone (peer disconnect, duplicate-entity teardown).  Keeps the
        _watcher_clients bookkeeping consistent, which raw ``e.client = None``
        assignments would silently corrupt."""
        if self.client is None:
            return
        for other in self.interested_in:
            other._watcher_clients -= 1
            other._touch_watched()
        self.client = None
        self._touch_watched()
        self._recompute_plain()
        if self._plain_aoi:
            self._dematerialize_interests()

    def set_client(self, client: GameClient | None):
        was_plain = self._plain_aoi
        old = self.client
        if old is not None:
            old.destroy_entity(self)
            for other in self.interested_in:
                old.destroy_entity(other)
                other._watcher_clients -= 1
                other._touch_watched()
            self.client = None
            self._touch_watched()
            self.on_client_disconnected()
        if client is not None:
            if was_plain:
                # surface the packed interest state: the new client needs a
                # create op and a watcher count per current neighbor
                self._materialize_interests()
            for other in self.interested_in:
                other._watcher_clients += 1
                other._touch_watched()
            # flush pending deltas to the old audiences first -- the
            # snapshots below already contain them (see _interest)
            self._flush_attr_deltas()
            for other in self.interested_in:
                other._flush_attr_deltas()
            self.client = client
            self._touch_watched()
            client.create_entity(self, is_player=True)
            for other in self.interested_in:
                client.create_entity(other, is_player=False)
            self._recompute_plain()
            self.on_client_connected()
        else:
            self._recompute_plain()
            if self._plain_aoi:
                self._dematerialize_interests()

    def give_client_to(self, other: "Entity | str"):
        """Move client ownership to another entity -- local fast path, or
        cross-game by entity id through MT_GIVE_CLIENT_TO (reference:
        GiveClientTo, Entity.go:752-765; the client's gate switches its
        owner when the target's is_player create arrives,
        GateService.go:263-294)."""
        client = self.client
        if client is None:
            return
        target = other if isinstance(other, Entity) else (
            self.manager.entities.get(other))
        if target is not None:
            self.set_client(None)
            target.set_client(client)
            return
        game = self.game
        if game is None:
            raise KeyError(f"give_client_to: no local entity {other!r} "
                           "(not clustered)")
        game.give_client_to(self, other)

    # -- space movement ----------------------------------------------------
    def enter_space(self, space_id: str, pos: Vector3 | None = None):
        """Move to another space -- same-game fast path or cross-game
        migration when clustered (reference: EnterSpace, Entity.go:956-973)."""
        pos = pos or Vector3()
        rt = self._runtime()
        game = getattr(rt, "game", None)
        if game is not None:
            game.enter_space(self, space_id, pos)
            return
        sp = self.manager.spaces.get(space_id)
        if sp is None:
            raise KeyError(f"no local space {space_id} (not clustered)")
        if self.space is not None:
            self.space.leave_entity(self)
        sp.enter_entity(self, pos)

    # -- cluster conveniences ----------------------------------------------
    @property
    def game(self):
        """The hosting GameService when clustered, else None."""
        return getattr(self._runtime(), "game", None)

    @property
    def kvdb(self):
        """The game's KVDB service (None when not attached)."""
        game = self.game
        return getattr(game, "kvdb", None) if game is not None else None

    def call_entity(self, eid: str, method: str, *args):
        """Call a method on another entity by id (reference: goworld.Call /
        EntityManager.Call).  Clustered: the game routes (local fast path or
        dispatcher fabric); unclustered: local post only."""
        game = self.game
        if game is not None:
            game.call_entity(eid, method, *args)
            return
        local = self.manager.entities.get(eid)
        if local is None:
            raise KeyError(f"no local entity {eid} (not clustered)")
        self._runtime().post.post(lambda: local.call(method, *args))

    def set_filter_prop(self, key: str, value: str):
        """Set a gate-side filter property on this entity's client
        (reference: Entity.SetFilterProp, Entity.go:1136-1150)."""
        game = self.game
        if game is not None and self.client is not None:
            game.set_client_filter_prop(self, key, value)

    def call_filtered_clients(self, key: str, op: int, value: str,
                              method: str, *args):
        """Broadcast an RPC to every client whose filter props match
        (reference: Entity.CallFilteredClients, Entity.go:1150-1170)."""
        game = self.game
        if game is not None:
            game.call_filtered_clients(key, op, value, method, *args)

    # -- client calls ------------------------------------------------------
    def call_client(self, method: str, *args):
        if self.client is not None:
            self.client.call_client(self.id, method, args)

    def call_all_clients(self, method: str, *args):
        """Own client + every interested neighbor's client
        (reference: CallAllClients, Entity.go:743-748)."""
        self.call_client(method, *args)
        for other in self.interested_by:
            if other.client is not None:
                other.client.call_client(self.id, method, args)

    # -- timers ------------------------------------------------------------
    def add_callback(self, delay: float, method: str, *args) -> int:
        """One-shot timer; ``method`` is resolved on this entity so the timer
        survives migration/freeze by name (reference: Entity.go:271-311)."""
        tid = self._runtime().timers.add(
            delay, self._fire_timer, args=(method, args), pass_tid=True
        )
        self._timer_ids[tid] = (method, float(delay), False, args)
        return tid

    def add_timer(self, interval: float, method: str, *args) -> int:
        tid = self._runtime().timers.add(
            interval,
            self._fire_timer,
            repeat=True,
            interval=interval,
            args=(method, args),
            pass_tid=True,
        )
        self._timer_ids[tid] = (method, float(interval), True, args)
        return tid

    def cancel_timer(self, tid: int):
        self._timer_ids.pop(tid, None)
        self._runtime().timers.cancel(tid)

    def _fire_timer(self, tid: int, method: str, args: tuple):
        if self.destroyed:
            return
        rec = self._timer_ids.get(tid)
        if rec is not None and not rec[2]:
            # fired one-shots must not leak or re-fire after migration/restore
            del self._timer_ids[tid]
        getattr(self, method)(*args)

    def dump_timers(self) -> list:
        """Serializable timer state for migration/freeze.  Records the time
        *remaining* until next fire so the timer keeps its phase on the
        destination (reference behavior: restore by FireTime - now,
        Entity.go:349-390).  Record: [method, interval, repeat, args, remaining]."""
        timers = self._runtime().timers
        out = []
        for tid, (method, interval, repeat, args) in self._timer_ids.items():
            remaining = timers.remaining(tid)
            if remaining is None:
                continue
            out.append([method, interval, repeat, args, remaining])
        return out

    def restore_timers(self, dumped: list):
        for method, interval, repeat, args, remaining in dumped:
            if repeat:
                tid = self._runtime().timers.add(
                    remaining,
                    self._fire_timer,
                    repeat=True,
                    interval=interval,
                    args=(method, tuple(args)),
                    pass_tid=True,
                )
                self._timer_ids[tid] = (method, float(interval), True, tuple(args))
            else:
                tid = self._runtime().timers.add(
                    remaining,
                    self._fire_timer,
                    args=(method, tuple(args)),
                    pass_tid=True,
                )
                self._timer_ids[tid] = (method, float(interval), False, tuple(args))

    # -- RPC ---------------------------------------------------------------
    def call(self, method: str, *args):
        """In-process direct dispatch (the local fast path; remote routing is
        the dispatcher fabric's job -- reference EntityManager.go:429-442)."""
        desc = self.desc.rpc_descs.get(method) if self.desc else None
        if desc is None:
            raise AttributeError(f"{self.type_name} has no RPC {method!r}")
        return desc.func(self, *args)

    def on_call_from_client(self, method: str, args: tuple, client_id: str):
        from .rpc import may_call

        desc = self.desc.rpc_descs.get(method) if self.desc else None
        if desc is None:
            raise AttributeError(f"{self.type_name} has no RPC {method!r}")
        is_owner = self.client is not None and self.client.client_id == client_id
        if not may_call(desc, from_client=True, is_owner=is_owner):
            raise PermissionError(
                f"client {client_id} may not call {self.type_name}.{method}"
            )
        if not desc.arity_ok(len(args)):
            # reject malformed client input at the wire boundary, not inside
            # entity logic
            raise TypeError(
                f"{self.type_name}.{method} expects "
                f"{desc.min_args}..{desc.max_args} args, got {len(args)}"
            )
        return desc.func(self, *args)

    # -- migration / freeze data ------------------------------------------
    def migrate_data(self) -> dict:
        """Full state snapshot for EnterSpace migration and freeze/restore
        (reference: entityMigrateData, Entity.go:78-89,631-651)."""
        return {
            "type": self.type_name,
            "id": self.id,
            "attrs": self.attrs.to_dict(),
            "pos": self.position.to_tuple(),
            "yaw": self.yaw,
            "timers": self.dump_timers(),
            "client": (
                (self.client.client_id, self.client.gate_id)
                if self.client
                else None
            ),
            "client_syncing": self.client_syncing,
            "space_id": self.space.id if self.space else None,
        }

    # -- destroy -----------------------------------------------------------
    def destroy(self):
        if self.destroyed:
            return
        self._destroy_impl(is_migrate=False)

    def _destroy_impl(self, is_migrate: bool):
        self.destroyed = True
        if self.space is not None:
            self.space.leave_entity(self)
        if not is_migrate:
            if self.persistent:
                self.destroyed = False  # save() guards on destroyed
                self.save()
                self.destroyed = True
            self.on_destroy()
            if self.client is not None:
                self.client.destroy_entity(self)
                self.client = None
        for tid in list(self._timer_ids):
            self._runtime().timers.cancel(tid)
        self._timer_ids.clear()
        if self.manager is not None:
            self.manager._on_entity_destroyed(self)

    def _runtime(self):
        return self.manager.runtime
