"""Columnar ECS store for hot entity attributes.

The ECS turn (ROADMAP #4; *The Essence of Entity Component System*,
PAPERS.md): the attributes the device pipeline consumes every tick --
x/z/r/act/sub(nonplain) -- live in per-space columnar host arrays that
entity objects VIEW rather than own.  Cold attributes (the replicated
attr tree, timers, RPC state) keep the per-entity dict path in
engine/attrs.py; the split is hot-by-column, cold-by-entity.

Why columns:

* ``Space.submit_aoi`` hands the calculator the column arrays themselves
  -- the delta-staging diff in ``flush()`` (engine/aoi._stage_inputs)
  reads columns directly; there is no per-entity walk anywhere between a
  position write and the H2D packet.
* the gate->device ingest path (goworld_tpu/ingest/) decodes client
  movement wire records straight into vectorized column writes in the
  ``ops/aoi_stage.pad_packet`` (row, col, x, z) layout -- zero
  per-entity Python attribute writes on the hot path.
* entity-facing reads stay coherent for free: ``Entity.position`` is a
  :class:`PositionView` reading the columns while the entity holds an
  AOI slot, so a column write (batched move, ingest) is immediately
  visible to game logic without any write-back pass.

Precision contract: the hot columns are float32 (the AOI boundary has
always quantized there -- engine/vector.py).  While an entity holds a
slot its position/yaw reads are therefore f32-quantized; the f64
``Vector3`` snapshot is re-materialized from the columns when the
entity leaves its slot.

The companion columns (y/yaw/sync/watched) are host-only: they exist so
the ingest and batched-move paths can update height/yaw and flag
position sync fully vectorized.  ``sync`` holds pending SYNC_* flags
per slot (drained by ``Space.drain_column_sync`` into the runtime's
dirty-entity machinery); ``watched`` mirrors "some client can see this
entity" (``_watcher_clients > 0 or client is not None``) so the drain
touches only entities whose movement anyone observes.
"""

from __future__ import annotations

import numpy as np

from .vector import Vector3

# columns staged to the device every tick (the delta-staging shadow set;
# engine/aoi._TPUBucket._hx/_hz/_hr/_hact/_hsub).  team/vis feed the
# interest-policy stack's fused step (goworld_tpu/interest/) on spaces
# with a team_mask policy: observer A sees B iff vis[A] & team[B] != 0
HOT_DEVICE_COLUMNS = ("x", "z", "r", "act", "nonplain", "team", "vis")
# host-only companions enabling fully vectorized ingest + sync flagging
HOST_COLUMNS = ("y", "yaw", "sync", "watched")


class ColumnStore:
    """Per-space columnar arrays, grown by doubling (never shrunk: slot
    indices are stable for the space's lifetime)."""

    __slots__ = ("cap", "x", "z", "r", "act", "nonplain", "team", "vis",
                 "y", "yaw", "sync", "watched")

    def __init__(self):
        self.cap = 0
        self.x = np.empty(0, np.float32)
        self.z = np.empty(0, np.float32)
        self.r = np.empty(0, np.float32)
        self.act = np.empty(0, bool)
        self.nonplain = np.zeros(0, bool)
        self.team = np.zeros(0, np.uint32)
        self.vis = np.zeros(0, np.uint32)
        self.y = np.empty(0, np.float32)
        self.yaw = np.empty(0, np.float32)
        self.sync = np.zeros(0, np.uint8)
        self.watched = np.zeros(0, bool)

    def ensure_capacity(self, new_cap: int):
        if new_cap <= self.cap:
            return
        for name in ("x", "z", "r", "y", "yaw"):
            arr = getattr(self, name)
            grown = np.zeros(new_cap, np.float32)
            grown[: len(arr)] = arr
            setattr(self, name, grown)
        for name, dt in (("act", bool), ("nonplain", bool),
                         ("team", np.uint32), ("vis", np.uint32),
                         ("sync", np.uint8), ("watched", bool)):
            arr = getattr(self, name)
            grown = np.zeros(new_cap, dt)
            grown[: len(arr)] = arr
            setattr(self, name, grown)
        self.cap = new_cap

    def clear_slot(self, slot: int):
        """Reset a freed slot's columns (position/r may stay; everything
        that gates behavior must not leak to the next occupant)."""
        self.act[slot] = False
        self.nonplain[slot] = False
        self.team[slot] = 0
        self.vis[slot] = 0
        self.sync[slot] = 0
        self.watched[slot] = False


class PositionView(Vector3):
    """A live view of an entity's position.

    While the entity holds an AOI slot, component reads/writes go to the
    owning space's columns (f32, the AOI boundary precision); otherwise
    they fall through to the entity's detached f64 ``Vector3`` snapshot.
    Writes go to BOTH (the snapshot is what survives leaving the slot)
    and mark the space AOI-dirty, so a direct ``e.position.x = v``
    propagates exactly like ``set_position`` minus the sync flags.

    Subclasses Vector3 so ``isinstance`` checks, ``__eq__``/``__hash__``
    and the arithmetic helpers (which construct plain Vector3 results)
    keep working; the x/y/z properties shadow the parent's slots.
    """

    __slots__ = ("_e",)

    def __init__(self, e):
        self._e = e

    def _cols(self):
        """(cols, slot) while slotted, else None."""
        e = self._e
        s = e.aoi_slot
        if s >= 0:
            sp = e.space
            if sp is not None:
                return sp._cols, s
        return None

    @property
    def x(self):
        cs = self._cols()
        if cs is not None:
            return float(cs[0].x[cs[1]])
        return self._e._pos.x

    @x.setter
    def x(self, v):
        v = float(v)
        self._e._pos.x = v
        cs = self._cols()
        if cs is not None:
            cs[0].x[cs[1]] = v
            self._e.space._aoi_dirty = True

    @property
    def y(self):
        cs = self._cols()
        if cs is not None:
            return float(cs[0].y[cs[1]])
        return self._e._pos.y

    @y.setter
    def y(self, v):
        v = float(v)
        self._e._pos.y = v
        cs = self._cols()
        if cs is not None:
            cs[0].y[cs[1]] = v

    @property
    def z(self):
        cs = self._cols()
        if cs is not None:
            return float(cs[0].z[cs[1]])
        return self._e._pos.z

    @z.setter
    def z(self, v):
        v = float(v)
        self._e._pos.z = v
        cs = self._cols()
        if cs is not None:
            cs[0].z[cs[1]] = v
            self._e.space._aoi_dirty = True

    # attrs-tree protocol (engine/attrs._AttrNode._wrap): storing a live
    # view into the replicated attr tree must snapshot BY VALUE -- the
    # tree serializes and diffs, a view would alias mutable column state
    def __attr_plain__(self):
        return [self.x, self.y, self.z]

    def detach(self) -> Vector3:
        """A plain f64 Vector3 snapshot of the current value."""
        return Vector3(self.x, self.y, self.z)
