"""Space: a shard of the world holding co-located entities.

A Space is itself an entity (reference: Space.go:14 ``__space__``); it owns
the per-space AOI arrays and its handle into the process AOIEngine.  All
entities in a space are co-located on one game process (and their AOI rows on
one chip) -- this is the framework's unit of sharding.

Batched AOI protocol per tick (north-star hot loop; reference equivalent:
Space.go:188-261 enter/leave/move -> go-aoi callbacks):

    * ``enter_entity``/``leave_entity``/``move_entity`` update the packed
      per-slot arrays (x, z, radius, active) incrementally -- O(1) each;
    * the runtime's tick calls ``submit_aoi`` then ``AOIEngine.flush`` then
      ``dispatch_aoi_events``, which replays enter/leave pairs (sorted,
      deterministic) through Entity._interest/_uninterest.

The nil space (reference: Space.go:127-140) is a kindless space with AOI
disabled where entities live when not in a real space.
"""

from __future__ import annotations

import numpy as np

from .ecs import ColumnStore
from .entity import Entity
from .vector import Vector3

SPACE_TYPE_NAME = "__space__"
_MIN_CAPACITY = 128


class Space(Entity):
    # spaces are never AOI members themselves
    use_aoi = False

    def __init__(self):
        super().__init__()
        self.kind = 0
        self.entities: set[Entity] = set()
        self._aoi_handle = None
        self._aoi_default_dist = 0.0
        # columnar ECS store (engine/ecs.py): the hot per-slot attributes
        # (x/z/r/act/nonplain + the y/yaw/sync/watched host companions)
        # as capacity-sized arrays grown by doubling.  Entities hold VIEWS
        # into these columns while slotted (Entity.position); submit_aoi
        # hands the calculator the columns themselves, so the flush()
        # delta diff reads them directly -- no per-entity walk anywhere
        self._cap = 0
        self._cols = ColumnStore()
        # slot -> entity.  A list, never a numpy object array: the cycle
        # collector does not traverse an object array, so entity -> space
        # -> array -> entity cycles (and with them the Runtime and its
        # device memory) would never be freed
        self._slot_entity: list[Entity | None] = []
        self._free_slots: list[int] = []
        # two-stage cooling for freed slots: a pipelined calculator's events
        # for a slot freed during tick T are dispatched at T and only
        # DELIVERED at T+1's AOI phase, so the slot must stay unallocatable
        # through the end of T+1 -- not just this tick's phase (timers and
        # user code between ticks allocate too).  recycle_aoi_slots advances
        # cooling -> cooling2 -> free at the end of each AOI phase.
        self._free_cooling: list[int] = []
        self._free_cooling2: list[int] = []
        self._slot_watermark = 0
        self._aoi_dirty = False
        # event-stream subscription last applied to the calculator: a space
        # with no nonplain entity opts out (set_subscribed) so device
        # backends skip its extraction/fetch/decode entirely
        self._aoi_subscribed = True

    @property
    def is_space(self) -> bool:
        return True

    @property
    def is_nil(self) -> bool:
        return self.kind == 0

    # legacy accessors for the packed arrays -- the columns ARE the
    # arrays now (ColumnStore); kept so calculators, tests and tools that
    # index `space._x[slot]` keep working against the live column
    @property
    def _x(self) -> np.ndarray:
        return self._cols.x

    @property
    def _z(self) -> np.ndarray:
        return self._cols.z

    @property
    def _r(self) -> np.ndarray:
        return self._cols.r

    @property
    def _act(self) -> np.ndarray:
        return self._cols.act

    @property
    def _nonplain(self) -> np.ndarray:
        return self._cols.nonplain

    def on_space_init(self):  # user hook (reference ISpace)
        pass

    def on_entity_enter_space(self, e: Entity):
        pass

    def on_entity_leave_space(self, e: Entity):
        pass

    # -- AOI management ----------------------------------------------------
    def enable_aoi(self, default_dist: float, backend: str | None = None,
                   capacity: int | None = None):
        """Turn on interest management for this space (reference:
        EnableAOI, Space.go:91-107).  Must be called before entities enter.

        ``capacity`` pre-sizes the space: population grows capacity on
        demand anyway, but an expected-oversized space (>= the row-shard
        threshold) should pre-size so it lands on the row-sharded
        calculator directly instead of repacking through every doubling."""
        if self._aoi_handle is not None:
            raise RuntimeError("AOI already enabled")
        if self.entities:
            raise RuntimeError("enable AOI before entities enter the space")
        self._aoi_default_dist = float(default_dist)
        self._ensure_capacity(max(_MIN_CAPACITY, int(capacity or 0)))
        self._aoi_handle = self._runtime().aoi.create_space(self._cap, backend)

    @property
    def aoi_enabled(self) -> bool:
        return self._aoi_handle is not None

    def enable_interest(self, *policies, mode: str | None = None):
        """Attach a composable interest-policy stack to this space
        (goworld_tpu_torch/interest/): team/faction visibility, tiered
        update rates, line-of-sight occlusion -- one kernel launch a step,
        composed with the base radius predicate.  Requires ``enable_aoi``
        first; like it, must run before entities enter (the stack's
        previous-step state starts empty).  Returns the PolicyStack."""
        if self._aoi_handle is None:
            raise RuntimeError("enable_aoi before enable_interest")
        if self.entities:
            raise RuntimeError(
                "enable interest policies before entities enter the space")
        return self._runtime().aoi.attach_interest(
            self._aoi_handle, policies, mode=mode)

    @property
    def interest_stack(self):
        """The attached PolicyStack, or None (radius-only space)."""
        h = self._aoi_handle
        return None if h is None else getattr(h, "_policy_stack", None)

    def set_aoi_team(self, e: Entity, team: int, vis: int | None = None):
        """Set an entity's faction columns (team_mask policy semantics:
        observer A sees B iff ``vis[A] & team[B] != 0``).  ``team`` is
        B-side (what bitmask the entity presents), ``vis`` is A-side
        (which team bits the entity can see); ``vis=None`` keeps the
        current visibility mask.  Entities enter with team=1,
        vis=0xFFFFFFFF -- mutually visible until told otherwise."""
        if e.space is not self or e.aoi_slot < 0:
            raise ValueError(f"{e} holds no AOI slot in this space")
        cols = self._cols
        cols.team[e.aoi_slot] = np.uint32(team)
        if vis is not None:
            cols.vis[e.aoi_slot] = np.uint32(vis)
        self._aoi_dirty = True

    def _ensure_capacity(self, n: int):
        if n <= self._cap:
            return
        new_cap = max(_MIN_CAPACITY, self._cap or _MIN_CAPACITY)
        while new_cap < n:
            new_cap *= 2
        self._cols.ensure_capacity(new_cap)
        self._slot_entity.extend([None] * (new_cap - len(self._slot_entity)))
        old_cap = self._cap
        self._cap = new_cap
        if self._aoi_handle is not None and old_cap:
            self._aoi_handle = self._runtime().aoi.grow_space(
                self._aoi_handle, new_cap
            )
            # the fresh bucket slot defaults to subscribed; reset the cached
            # flag so the next submit re-applies an unsubscription (an
            # all-plain space must not silently resume event extraction)
            self._aoi_subscribed = True

    # -- membership --------------------------------------------------------
    def enter_entity(self, e: Entity, pos: Vector3, is_restore: bool = False):
        """Reference: Space.enter, Space.go:188-226.  ``is_restore``
        re-establishes membership after freeze-restore WITHOUT firing the
        user enter hooks (reference: restore re-enters quietly,
        EntityManager.go:591-652 -- a restore reconstructs state, it is not
        a new enter; hooks like the demo's spawn-monsters-per-player must
        not re-fire)."""
        if e.space is not None:
            raise ValueError(f"{e} already in a space")
        e.space = self
        e.position = pos
        self.entities.add(e)
        if self._aoi_handle is not None and e.use_aoi:
            if self._free_slots:
                slot = self._free_slots.pop()
            else:
                slot = self._next_slot()
            e.aoi_slot = slot
            self._slot_entity[slot] = e
            cols = self._cols
            cols.nonplain[slot] = not e._plain_aoi
            cols.x[slot] = pos.x
            cols.y[slot] = pos.y
            cols.z[slot] = pos.z
            cols.yaw[slot] = e._yaw
            cols.r[slot] = (
                e.aoi_distance if e.aoi_distance > 0 else self._aoi_default_dist
            )
            cols.act[slot] = True
            # faction defaults: on one team, sees everyone -- a space with
            # a team_mask policy behaves exactly radius-like until
            # set_aoi_team says otherwise
            cols.team[slot] = np.uint32(1)
            cols.vis[slot] = np.uint32(0xFFFFFFFF)
            cols.sync[slot] = 0
            cols.watched[slot] = (e._watcher_clients > 0
                                  or e.client is not None)
            self._aoi_dirty = True
        if not is_restore:
            self.on_entity_enter_space(e)
            e.on_enter_space()

    def _next_slot(self) -> int:
        if self._slot_watermark >= self._cap:
            self._ensure_capacity(self._cap + 1)
        slot = self._slot_watermark
        self._slot_watermark += 1
        return slot

    def leave_entity(self, e: Entity):
        """Reference: Space.leave, Space.go:228-251."""
        if e.space is not self:
            return
        if e.aoi_slot >= 0:
            slot = e.aoi_slot
            cols = self._cols
            # detach the entity's position/yaw views: snapshot the column
            # values back into the f64 Vector3 the views fall through to
            # (batched moves and ingest write columns only, so the
            # snapshot may be the ONLY up-to-date copy)
            p = e._pos
            p.x = float(cols.x[slot])
            p.y = float(cols.y[slot])
            p.z = float(cols.z[slot])
            e._yaw = float(cols.yaw[slot])
            cols.clear_slot(slot)
            self._slot_entity[slot] = None
            self._free_cooling.append(slot)
            e.aoi_slot = -1
            self._aoi_dirty = True
            # erase the slot from the calculator's previous-tick state: the
            # interests are severed synchronously below, so the batched diff
            # must not re-emit them (and a reused slot must start clean)
            self._runtime().aoi.clear_entity(self._aoi_handle, slot)
            # departure events must fire this tick; sever interests now so
            # callbacks and client destroys are immediate and deterministic
            for other in list(e.interested_in):
                e._uninterest(other)
            for other in list(e.interested_by):
                other._uninterest(e)
        self.entities.discard(e)
        e.space = None
        self.on_entity_leave_space(e)
        e.on_leave_space(self)

    def move_entities(self, slots, xs, zs, ys=None, yaws=None):
        """Batched position update: one call moves many entities (reference
        analog: the gate->game client-sync path decodes a flat array of
        positions and applies them in one pass, GameService.go:398-410).
        All position/yaw writes are vectorized column writes (entities
        VIEW the columns -- engine/ecs.py -- so nothing per-entity needs
        updating); sync bookkeeping runs just for entities some client can
        actually see.  This is the device-cadence movement path: at 64k
        entities it costs ~20 ms where per-entity set_position costs
        ~100 ms.  (The fully-batched wire path, goworld_tpu_torch/ingest/,
        replaces even the bookkeeping loop with a sync-column write.)

        With ``ys``/``yaws`` (the client-sync ingest,
        sync_entities_from_client) height and yaw update too."""
        slots = np.asarray(slots, np.int64)
        cols = self._cols
        cols.x[slots] = xs
        cols.z[slots] = zs
        if ys is not None:
            cols.y[slots] = ys
            cols.yaw[slots] = yaws
        self._aoi_dirty = True
        se = self._slot_entity
        # sync bookkeeping (client-driven entities get no owner echo --
        # same rule as set_position: correcting the owner fights
        # client-side prediction; server-driven ones do).  Inlined, not a
        # helper: a per-entity call costs ~5 ms at 64k on the
        # device-cadence path.
        for s in slots.tolist():
            e = se[s]
            if e is None:
                continue
            if e._watcher_clients > 0 or e.client is not None:
                e._sync_flags |= 2 if e.client_syncing else 3
                ds = e._dirty_set
                if ds is not None:
                    ds.add(e)

    def sync_entities_from_client(self, slots, xs, ys, zs, yaws):
        """Batched client-driven position/yaw sync: the gate->game sync
        packet decodes into flat arrays and applies in one pass (reference:
        GameService.go:398-410 decodes the flat sync array;
        Entity.go:1221-1267 batches the outbound half).  Semantically one
        ``sync_position_yaw_from_client`` per entry; shares move_entities'
        apply loop -- the sync-flag policy there already reduces to
        SYNC_NEIGHBORS-only for client-syncing entities (no owner echo:
        correcting the owner fights client-side prediction)."""
        self.move_entities(slots, xs, zs, ys=ys, yaws=yaws)

    def move_entity(self, e: Entity, pos: Vector3):
        """Reference: Space.move, Space.go:253-261.  (Entity.set_position
        inlines this; other callers use it directly.)  The position
        assignment writes the columns and marks AOI dirty when slotted
        (Entity.position setter)."""
        e.position = pos

    # -- per-tick AOI ------------------------------------------------------
    def recycle_aoi_slots(self):
        """Advance the two-stage cooling pipeline (see ``_free_cooling``).
        Called at the END of each AOI phase, after event delivery: a slot
        freed during tick T becomes allocatable only after T+1's delivery
        of the events dispatched while it was live."""
        if self._free_cooling2:
            self._free_slots.extend(self._free_cooling2)
            self._free_cooling2.clear()
        if self._free_cooling:
            self._free_cooling2.extend(self._free_cooling)
            self._free_cooling.clear()

    def submit_aoi(self) -> bool:
        """Stage this tick's arrays if anything changed; returns staged?"""
        if self._aoi_handle is None or not self._aoi_dirty:
            return False
        aoi = self._runtime().aoi
        stack = getattr(self._aoi_handle, "_policy_stack", None)
        # subscription tracks "does anyone consume events?": pairs whose
        # observer is plain are dropped at delivery anyway, so an all-plain
        # space needs no event stream at all -- the calculator skips its
        # extraction/fetch/decode and interest state derives on demand.
        # With an interest stack attached the BUCKET's stream is never
        # consumed at all (the stack owns take_events), so the bucket
        # unsubscribes outright while still carrying the base state.
        cols = self._cols
        sub = (stack is None
               and bool(cols.nonplain[: self._slot_watermark].any()))
        if sub != self._aoi_subscribed:
            self._aoi_subscribed = sub
            aoi.set_subscribed(self._aoi_handle, sub)
        # the columns ARE the staged arrays: flush()'s delta diff
        # (engine/aoi._stage_inputs) reads them directly against the host
        # shadows -- wire/logic writes land here vectorized and nothing
        # walks entities between a move and the H2D packet
        aoi.submit(self._aoi_handle, cols.x, cols.z, cols.r, cols.act)
        if stack is not None:
            stack.submit(cols.x, cols.z, cols.r, cols.act,
                         cols.team, cols.vis)
        self._aoi_dirty = False
        return True

    def drain_column_sync(self):
        """Fold pending column sync flags (set vectorized by the batched
        ingest path, goworld_tpu_torch/ingest/) into the per-entity sync
        machinery.  One vectorized scan finds flagged slots; only WATCHED
        movers (some client can see them -- the ``watched`` column) pay a
        per-entity visit, which routes through ``_sync_flags`` +
        the dirty set so records emit exactly once per entity per tick
        even when batched and per-entity writes mix."""
        cols = self._cols
        sf = cols.sync[: self._slot_watermark]
        idx = np.nonzero(sf)[0]
        if not idx.size:
            return
        flags = sf[idx].copy()
        sf[idx] = 0
        w = cols.watched[idx]
        se = self._slot_entity
        for s, f in zip(idx[w].tolist(), flags[w].tolist()):
            e = se[s]
            if e is None or e.destroyed:
                continue
            e._sync_flags |= f
            ds = e._dirty_set
            if ds is not None:
                ds.add(e)

    def dispatch_aoi_events(self):
        """Replay batched enter/leave pairs through entity interest hooks.

        Fast path: a pair whose OBSERVER has no client and default AOI hooks
        (``_plain_aoi``) is pure interest-set bookkeeping -- two C-level set
        ops, no method dispatch.  Observers with a client or overridden
        hooks take the full ``_interest``/``_uninterest`` path (client
        create/destroy ops, watcher counts, user callbacks).  Slot->entity
        resolution indexes the slot list per pair."""
        if self._aoi_handle is None:
            return
        enter, leave = self._runtime().aoi.take_events(self._aoi_handle)
        se = self._slot_entity
        nonplain = self._nonplain
        # leaves first: a slot reused within one tick (leave+enter) must
        # destroy before re-creating on clients.  Pairs with a PLAIN
        # observer are dropped wholesale (one vectorized mask): their
        # interest state is the calculator's packed words, derived on
        # demand -- no per-pair host work at all.
        if len(leave):
            need = leave[nonplain[leave[:, 0]]].tolist()
            for i, j in need:
                a, b = se[i], se[j]
                if a is not None and b is not None:
                    a._uninterest(b)
        if len(enter):
            need = enter[nonplain[enter[:, 0]]].tolist()
            for i, j in need:
                a, b = se[i], se[j]
                if a is not None and b is not None:
                    a._interest(b)

    # -- lazy interest derivation ------------------------------------------
    def derive_interests(self, slot: int) -> list[Entity]:
        """Entities the slot's entity is interested in, derived from the
        calculator's packed interest words (post-last-flush state).  This is
        how PLAIN entities -- no client, default hooks -- answer
        ``neighbors()`` without any per-event host bookkeeping: the
        authoritative interest state never leaves the packed representation
        until someone actually asks."""
        h = self._aoi_handle
        if h is None or slot < 0:
            return []
        stack = getattr(h, "_policy_stack", None)
        if stack is not None:
            # policy space: the stack's post-step words ARE the interest
            # state (the bucket's base words ignore team/tier/los)
            row = stack.words[slot]
        else:
            derive = getattr(h.bucket, "derive_row", None)
            if derive is not None:
                # row-sharded oversized space: fetch ONE observer's words
                # [W] (16 KB) instead of materializing the full [C, W]
                row = derive(h.slot, slot)
            else:
                words = h.bucket.peek_words(h.slot)
                if words is None:
                    words = h.bucket.get_prev(h.slot)
                row = words[slot]
        w_per = row.shape[0]
        sn = self._slot_entity
        out = []
        for w in np.nonzero(row)[0]:
            bits = int(row[w])
            while bits:
                k = (bits & -bits).bit_length() - 1
                bits &= bits - 1
                e = sn[k * w_per + w]  # planar layout: j = k*W + w
                if e is not None:
                    out.append(e)
        return out

    def derive_observers(self, slot: int) -> list[Entity]:
        """Entities interested IN the slot's entity (the packed column)."""
        h = self._aoi_handle
        if h is None or slot < 0:
            return []
        stack = getattr(h, "_policy_stack", None)
        derive = getattr(h.bucket, "derive_col", None)
        if stack is None and derive is not None:
            rows = derive(h.slot, slot)
        else:
            if stack is not None:
                words = stack.words
            else:
                words = h.bucket.peek_words(h.slot)
                if words is None:
                    words = h.bucket.get_prev(h.slot)
            from ..ops import aoi_predicate as AP

            w, b = AP.word_bit_for_column(slot, self._cap)
            rows = np.nonzero(words[:, w] & (np.uint32(1) << np.uint32(b)))[0]
        sn = self._slot_entity
        return [sn[i] for i in rows if sn[i] is not None]

    # -- destroy -----------------------------------------------------------
    def _destroy_impl(self, is_migrate: bool):
        for e in list(self.entities):
            e.destroy()
        if self._aoi_handle is not None:
            self._runtime().aoi.release_space(self._aoi_handle)
            self._aoi_handle = None
        super()._destroy_impl(is_migrate)
