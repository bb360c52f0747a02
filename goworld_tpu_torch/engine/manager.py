"""Entity type registry + per-process entity manager.

Reference: engine/entity/EntityManager.go (type descriptors
:24-36, registration :151-189, create :229-273, restore :275-335).  Here
type metadata comes from class declarations (no reflection pass): attr
replication classes, AOI flags and persistence are class attributes on the
Entity subclass; RPC exposure comes from decorators (engine/rpc.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

from .entity import Entity
from .ids import gen_id
from .rpc import RpcDesc, collect_rpc_descs
from .vector import Vector3

if TYPE_CHECKING:
    from .runtime import Runtime
    from .space import Space


@dataclass(frozen=True)
class EntityTypeDesc:
    type_name: str
    cls: type
    is_space: bool
    persistent: bool
    use_aoi: bool
    aoi_distance: float
    rpc_descs: dict[str, RpcDesc]
    # True when the type keeps the default (no-op) AOI hooks: event replay
    # for clientless instances is then pure interest-set bookkeeping and
    # rides the batched fast path (Space.dispatch_aoi_events)
    plain_aoi_hooks: bool = True


class EntityManager:
    def __init__(self, runtime: "Runtime"):
        self.runtime = runtime
        self.registry: dict[str, EntityTypeDesc] = {}
        self.entities: dict[str, Entity] = {}
        self.spaces: dict[str, "Space"] = {}
        # per-type live instances (reference: entity lists per type,
        # entity_map.go); O(1) maintenance, used by services reconciliation
        # and type-scoped queries
        self.by_type: dict[str, set[str]] = {}

    # -- registration ------------------------------------------------------
    def register(self, cls: type, type_name: str | None = None) -> EntityTypeDesc:
        from .space import Space

        if not issubclass(cls, Entity):
            raise TypeError(f"{cls} is not an Entity subclass")
        type_name = type_name or cls.__name__
        if type_name in self.registry:
            raise ValueError(f"entity type {type_name!r} already registered")
        desc = EntityTypeDesc(
            type_name=type_name,
            cls=cls,
            is_space=issubclass(cls, Space),
            persistent=bool(cls.persistent),
            use_aoi=bool(cls.use_aoi),
            aoi_distance=float(cls.aoi_distance),
            rpc_descs=collect_rpc_descs(cls),
            plain_aoi_hooks=(
                cls.on_enter_aoi is Entity.on_enter_aoi
                and cls.on_leave_aoi is Entity.on_leave_aoi
            ),
        )
        self.registry[type_name] = desc
        return desc

    # -- creation ----------------------------------------------------------
    def create(
        self,
        type_name: str,
        *,
        space: "Space | None" = None,
        pos: Vector3 | None = None,
        eid: str | None = None,
        attrs: dict | None = None,
    ) -> Entity:
        """Create an entity locally (reference: createEntity,
        EntityManager.go:229-273)."""
        desc = self.registry.get(type_name)
        if desc is None:
            raise KeyError(f"entity type {type_name!r} not registered")
        e = desc.cls()
        e.id = eid or gen_id()
        if e.id in self.entities:
            raise ValueError(f"entity id {e.id} already exists")
        e.type_name = type_name
        e.manager = self
        e.desc = desc
        e._dirty_set = self.runtime._dirty_entities  # stable set object
        e._plain_aoi = desc.plain_aoi_hooks
        if attrs:
            e.attrs.assign(attrs)
        e.on_init()
        self.entities[e.id] = e
        self.by_type.setdefault(type_name, set()).add(e.id)
        if desc.is_space:
            self.spaces[e.id] = e  # type: ignore[assignment]
        cb = getattr(self.runtime, "on_entity_registered", None)
        if cb is not None:
            cb(e)
        e.on_created()
        if space is not None:
            space.enter_entity(e, pos or Vector3())
        return e

    def create_space(self, cls_name: str, kind: int = 1,
                     eid: str | None = None,
                     attrs: dict | None = None) -> "Space":
        sp = self.create(cls_name, eid=eid, attrs=attrs)
        sp.kind = kind  # type: ignore[attr-defined]
        sp.on_space_init()  # type: ignore[attr-defined]
        return sp  # type: ignore[return-value]

    def restore(self, data: dict, client_factory=None) -> Entity:
        """Recreate an entity from migrate/freeze data (reference:
        restoreEntity, EntityManager.go:275-335).  Space re-entry is the
        caller's job (it knows the target space)."""
        e = self.create(
            data["type"], eid=data["id"], attrs=data.get("attrs") or {}
        )
        x, y, z = data.get("pos", (0, 0, 0))
        e.position = Vector3(x, y, z)
        e.yaw = float(data.get("yaw", 0.0))
        e.client_syncing = bool(data.get("client_syncing", False))
        e.restore_timers(data.get("timers") or [])
        cli = data.get("client")
        if cli is not None and client_factory is not None:
            e.client = client_factory(*cli)
            e._recompute_plain()
        e.on_migrate_in()
        return e

    # -- lookup ------------------------------------------------------------
    def get(self, eid: str) -> Entity | None:
        return self.entities.get(eid)

    def call(self, eid: str, method: str, *args):
        """Local-call fast path (reference: EntityManager.go:429-442); remote
        routing via the dispatcher fabric hooks in here once connected."""
        e = self.entities.get(eid)
        if e is None:
            raise KeyError(f"no local entity {eid}")
        return e.call(method, *args)

    def _on_entity_destroyed(self, e: Entity):
        self.entities.pop(e.id, None)
        self.spaces.pop(e.id, None)
        ids = self.by_type.get(e.type_name)
        if ids is not None:
            ids.discard(e.id)
        cb = getattr(self.runtime, "on_entity_unregistered", None)
        if cb is not None:
            cb(e)
