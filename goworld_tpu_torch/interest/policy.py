"""Composable per-space interest policies and the PolicyStack (port).

The port's copy of the JAX package's ``interest/policy.py``.  The AOI
base predicate ("everything within my radius") is ONE interest
policy of many; this module is the registry and the composition engine
for the rest.  A :class:`PolicyStack` attaches to a space's AOI handle
(``AOIEngine.attach_interest`` / ``Space.enable_interest``) and takes
over the space's event stream: the base bucket keeps computing and
carrying the radius state (migration, checkpoint, growth all ride the
existing machinery untouched), while the stack evaluates the full
composition -- radius AND team mask AND tier cadence AND line of sight
-- in one launch of ``csrc/interest_step.cu`` on the engine's device
(interest/device.py) and delivers the enter/leave diff through the same
``take_events`` seam the buckets use.

Every registered policy declares a CPU oracle; stack-level oracle
composition lives in interest/oracle.py and is bit-exact with the device
step by shared construction (ops/interest_kernels.py).

Degradation (docs/robustness.md): the ``aoi.interest`` fault seam fires
at step entry -- a poisoned mask, stale tier, or corrupt distance field
demotes the stack STICKY to the radius-only oracle path (the one filter
no corrupt policy state can reach), counted in ``demotions``; the
operator re-arm is :meth:`PolicyStack.reset_interest`.  An injected
device fault during the device step (engine/aoi._device_fault) is
different: that single step re-evaluates on the CPU oracle (same
semantics, counted in ``host_steps``) and the device path resumes next
tick.  A real CUDA error, an out-of-memory or a failed build propagates.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import faults, telemetry
from ..ops import aoi_predicate as P
from ..ops import interest_kernels as K
from . import oracle as O
from .field import DistanceField

# unified telemetry (docs/observability.md "Interest policies"): counters
# only -- reading them never touches the device
_STEPS = telemetry.counter(
    "interest.steps", "policy-stack evaluations (full + off-cadence)")
_FULL_EVALS = telemetry.counter(
    "interest.full_evals", "full-cadence stack evaluations (tier boundary "
    "ticks; off-cadence ticks skip every line-of-sight sample)")
_DEMOTIONS = telemetry.counter(
    "interest.demotions", "sticky stack demotions to the radius-only "
    "oracle path (aoi.interest seam; reset_interest re-arms)")
_HOST_STEPS = telemetry.counter(
    "interest.host_steps", "stack steps evaluated by the CPU oracle after "
    "a device fault (single-step fallback, not a demotion)")
_LOS_EVALS = telemetry.counter(
    "interest.los_pair_evals", "line-of-sight segment samples evaluated "
    "(pairs x samples; the tiered-rate device-work saving shows here)")


POLICIES: dict[str, type] = {}


def register(cls):
    """Class decorator: add an InterestPolicy subclass to the registry.
    The registry key is the class's ``name`` constant."""
    if not getattr(cls, "name", ""):
        raise ValueError(f"{cls.__name__} must define a non-empty name")
    if cls.name in POLICIES:
        raise ValueError(f"interest policy {cls.name!r} already registered "
                         f"by {POLICIES[cls.name].__name__}")
    POLICIES[cls.name] = cls
    return cls


class InterestPolicy:
    """Base class for per-space interest filters.

    Subclasses define ``name`` (the registry key), declare a CPU
    ``oracle`` (the numpy reference for their mask), and expose their
    scalars via ``params()`` (rides the snapshot payload)."""

    name = ""

    def oracle(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} declares no CPU oracle")

    def params(self) -> dict:
        return {}


@register
class TeamVisibilityPolicy(InterestPolicy):
    """Faction visibility masks: observer A sees B iff
    ``vis[A] & team[B] != 0`` -- two uint32 columns in the ECS store
    (engine/ecs.py), AND-ed into the neighbor predicate inside the
    device step.  Defaults (team=1, vis=all-ones) make every entity
    mutually visible until ``Space.set_aoi_team`` says otherwise."""

    name = "team_mask"

    def oracle(self, team, vis) -> np.ndarray:
        return K.team_mask(np.asarray(team, np.uint32),
                           np.asarray(vis, np.uint32), np)


@register
class TieredRatePolicy(InterestPolicy):
    """Tiered update rates: pairs within ``near_frac`` of the observer
    radius are NEAR and re-evaluate every tick; FAR pairs re-evaluate
    (and sample line of sight) only every ``period``-th stack step,
    holding their decision bit in between.  Tier assignment is computed
    in the device step with bit-exact hysteresis (enter near at
    ``r*near_frac``, leave at that times ``hysteresis``) so entities on
    the boundary never flap tiers -- and updates EVERY step, which is
    what makes stacks with different periods agree bit-exactly on
    coinciding boundary ticks."""

    name = "tiered_rate"

    def __init__(self, near_frac: float = 0.5, hysteresis: float = 1.25,
                 period: int = 4):
        if not 0.0 < near_frac <= 1.0:
            raise ValueError(f"near_frac must be in (0, 1], got {near_frac}")
        if hysteresis < 1.0:
            raise ValueError(f"hysteresis must be >= 1, got {hysteresis}")
        if period < 1:
            raise ValueError(f"period must be >= 1, got {period}")
        self.near_frac = np.float32(near_frac)
        self.hysteresis = np.float32(hysteresis)
        self.period = int(period)

    def oracle(self, d, r, prev_near, gate) -> np.ndarray:
        return K.near_mask(d, np.asarray(r, np.float32), prev_near, gate,
                           self.near_frac, self.hysteresis, np)

    def params(self) -> dict:
        return {"near_frac": float(self.near_frac),
                "hysteresis": float(self.hysteresis),
                "period": self.period}


@register
class LineOfSightPolicy(InterestPolicy):
    """Occlusion via a precomputed per-space distance field
    (interest/field.py): a FAR pair is visible only when no dyadic
    midpoint of its segment samples an occluded grid cell.  ``depth``
    sets the sample count (2^depth - 1).  With a tier policy in the
    stack, near pairs bypass occlusion (unoccludable at close range by
    design) -- which is exactly why off-cadence ticks cost no distance-
    field samples at all."""

    name = "line_of_sight"

    def __init__(self, field: DistanceField, depth: int = 2):
        if not isinstance(field, DistanceField):
            raise TypeError("LineOfSightPolicy needs a DistanceField")
        if not 1 <= depth <= 4:
            raise ValueError(f"depth must be in [1, 4], got {depth}")
        self.field = field
        self.depth = int(depth)

    def oracle(self, x, z) -> np.ndarray:
        f = self.field
        return K.los_clear(np.asarray(x, np.float32),
                           np.asarray(z, np.float32), f.grid, f.origin_x,
                           f.origin_z, f.inv_cell, self.depth, np)

    def params(self) -> dict:
        return {"depth": self.depth, "field": self.field.key()}


@dataclass(frozen=True)
class StackConfig:
    """The static shape of a stack: the policy mix and its scalars (the
    kernel's template choice and launch arguments)."""

    has_team: bool
    has_tier: bool
    has_los: bool
    near_frac: np.float32
    hysteresis: np.float32
    period: int
    origin_x: np.float32
    origin_z: np.float32
    inv_cell: np.float32
    los_depth: int

    def key(self) -> tuple:
        return (self.has_team, self.has_tier, self.has_los,
                float(self.near_frac), float(self.hysteresis), self.period,
                float(self.origin_x), float(self.origin_z),
                float(self.inv_cell), self.los_depth)


def _build_config(policies) -> tuple[StackConfig, DistanceField | None]:
    team = any(p.name == TeamVisibilityPolicy.name for p in policies)
    tier = next((p for p in policies
                 if p.name == TieredRatePolicy.name), None)
    los = next((p for p in policies
                if p.name == LineOfSightPolicy.name), None)
    f = los.field if los is not None else None
    z32 = np.float32(0.0)
    cfg = StackConfig(
        has_team=team, has_tier=tier is not None, has_los=los is not None,
        near_frac=tier.near_frac if tier else np.float32(1.0),
        hysteresis=tier.hysteresis if tier else np.float32(1.0),
        period=tier.period if tier else 1,
        origin_x=f.origin_x if f else z32,
        origin_z=f.origin_z if f else z32,
        inv_cell=f.inv_cell if f else z32,
        los_depth=los.depth if los else 0)
    return cfg, f


def _empty_pairs():
    return np.empty((0, 2), np.int32)


class PolicyStack:
    """Per-space composition state + the per-tick evaluation driver.

    Rides the :class:`~goworld_tpu_torch.engine.aoi.SpaceAOIHandle`;
    growth repacks its word planes exactly like the base bucket repacks
    interest state (``AOIEngine.grow_space`` calls :meth:`grow`);
    :meth:`export_payload` / :meth:`import_payload` carry its state.

    ``device`` is where a ``mode="device"`` stack steps: ``"cuda"`` (the
    default; the hand kernel, and an error without a GPU) or ``"cpu"``
    (the kernel's plain PyTorch version, what the tests run).
    """

    def __init__(self, capacity: int, policies, mode: str = "device",
                 device="cuda"):
        if mode not in ("device", "host"):
            raise ValueError(f"interest mode must be device|host, got {mode!r}")
        policies = list(policies)
        if not policies:
            raise ValueError("a PolicyStack needs at least one policy")
        names = [p.name for p in policies]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate policy in stack: {sorted(names)}")
        for p in policies:
            reg = POLICIES.get(p.name)
            if reg is None or not isinstance(p, reg):
                raise ValueError(
                    f"policy {p.name!r} ({type(p).__name__}) is not "
                    "registered (interest.policy.register)")
        self.policies = policies
        self.mode = mode
        if mode == "device":
            from ..engine.aoi import resolve_device

            self.device = resolve_device(device)
        else:
            self.device = torch.device("cpu")
        self.capacity = int(capacity)
        self.W = P.words_per_row(self.capacity)
        # packed previous-step state (host-authoritative: the handle owns
        # it across migration/evacuation/restore)
        self.final = np.zeros((self.capacity, self.W), np.uint32)
        self.near = np.zeros((self.capacity, self.W), np.uint32)
        self.step_count = 0
        self.demoted = False
        self._force_full = False
        self._pending: tuple | None = None
        self._events: tuple | None = None
        self.last_step_full = False
        self.stats = {"steps": 0, "full_evals": 0, "off_evals": 0,
                      "demoted_steps": 0, "demotions": 0, "resets": 0,
                      "host_steps": 0, "los_pair_evals": 0}
        self._cfg, self._field = _build_config(policies)

    # -- staging / evaluation ----------------------------------------------

    def submit(self, x, z, r, act, team, vis) -> None:
        """Stage this tick's columns (length == capacity; references,
        not copies -- same contract as bucket staging: the arrays must
        stay untouched until flush)."""
        self._pending = (x, z, r, act, team, vis)

    @property
    def has_pending(self) -> bool:
        return self._pending is not None

    def step(self) -> bool:
        """Evaluate one staged tick; accumulates the enter/leave diff
        for :meth:`take_events`.  Called by ``AOIEngine.flush`` after
        every bucket's harvest (the ``aoi.interest`` span)."""
        if self._pending is None:
            return False
        x, z, r, act, team, vis = self._pending
        self._pending = None
        c = self.capacity
        # the degradation gate: ANY fired kind on the seam -- poisoned
        # mask, stale tier, corrupt distance field, plain oom/fail --
        # demotes sticky to the radius-only path (reset_interest re-arms)
        demote = False
        try:
            if faults.check("aoi.interest") is not None:
                demote = True
        except (faults.InjectedFault, ConnectionResetError):
            demote = True
        if not demote and self._field is not None \
                and not self._field.validate():
            # a genuinely corrupt grid (however it got that way) is
            # indistinguishable from the injected kind: same demotion
            demote = True
        if demote and not self.demoted:
            self.demoted = True
            self.stats["demotions"] += 1
            _DEMOTIONS.inc()
        if self.demoted:
            new_final = O.eval_radius_only(x, z, r, act)
            new_near = np.zeros((c, self.W), np.uint32)
            self.stats["demoted_steps"] += 1
            self.last_step_full = True
        else:
            full = (self._force_full or not self._cfg.has_tier
                    or self.step_count % self._cfg.period == 0)
            self._force_full = False
            grid = self._field.grid if self._field is not None else None
            args = (x, z, r, act, team, vis, self.final, self.near,
                    self._cfg, full)
            if self.mode == "device":
                try:
                    new_final, new_near = _dev_eval(*args, grid=grid,
                                                    device=self.device)
                except Exception as e:  # noqa: BLE001 -- classified below
                    from ..engine.aoi import _device_fault

                    if not _device_fault(e):
                        raise
                    # single-step oracle fallback: same semantics, host
                    # arithmetic; the device path resumes next tick
                    new_final, new_near = O.eval_step(*args, grid=grid)
                    self.stats["host_steps"] += 1
                    _HOST_STEPS.inc()
            else:
                new_final, new_near = O.eval_step(*args, grid=grid)
            self.last_step_full = full
            if full:
                self.stats["full_evals"] += 1
                _FULL_EVALS.inc()
                if self._cfg.has_los:
                    n = c * c * ((1 << self._cfg.los_depth) - 1)
                    self.stats["los_pair_evals"] += n
                    _LOS_EVALS.inc(n)
            else:
                self.stats["off_evals"] += 1
        chg = new_final ^ self.final
        rows, ws = np.nonzero(chg)
        if rows.size:
            # only the changed words expand (the planes are [C, W])
            cw = chg[rows, ws]
            enter = P.pairs_from_sparse(rows, ws, new_final[rows, ws] & cw, c)
            leave = P.pairs_from_sparse(rows, ws, self.final[rows, ws] & cw,
                                        c)
        else:
            enter = leave = _empty_pairs()
        if self._events is None:
            self._events = (enter, leave)
        else:  # two flushes before a dispatch: append, never drop
            pe, pl = self._events
            self._events = (np.concatenate([pe, enter]),
                            np.concatenate([pl, leave]))
        self.final = new_final
        self.near = new_near
        self.step_count += 1
        self.stats["steps"] += 1
        _STEPS.inc()
        return True

    def take_events(self):
        ev = self._events
        self._events = None
        return ev if ev is not None else (_empty_pairs(), _empty_pairs())

    # -- queries ------------------------------------------------------------

    @property
    def words(self) -> np.ndarray:
        """Post-last-step packed interest words [C, W] np.uint32 -- what
        Space.derive_interests/derive_observers read for policy spaces."""
        return self.final

    def near_rows(self) -> np.ndarray:
        """bool [C]: slot has at least one NEAR pair as observer -- the
        load harness's per-client tier attribution."""
        return (self.near != 0).any(axis=1)

    # -- lifecycle ----------------------------------------------------------

    def clear_entity(self, slot: int) -> None:
        """Erase a departed slot's row and column from both planes
        (mirrors AOIEngine.clear_entity on the base state)."""
        w, b = P.word_bit_for_column(slot, self.capacity)
        mask = np.uint32(~(np.uint32(1) << np.uint32(b)) & 0xFFFFFFFF)
        for plane in (self.final, self.near):
            plane[slot, :] = 0
            plane[:, w] &= mask

    def grow(self, new_capacity: int) -> None:
        """Repack both word planes to a larger capacity (same planar
        column remap as AOIEngine.grow_space's base-state carry)."""
        new_capacity = P.round_capacity(new_capacity)
        if new_capacity <= self.capacity:
            raise ValueError("stack growth requires a larger capacity")
        ratio = new_capacity // self.capacity
        grown = []
        for plane in (self.final, self.near):
            if new_capacity == self.capacity * ratio \
                    and ratio & (ratio - 1) == 0:
                cap, words = self.capacity, plane
                while cap < new_capacity:
                    words = P.repack_columns_double(words, cap)
                    cap *= 2
            else:
                m = P.unpack_rows(plane, self.capacity)
                big = np.zeros((self.capacity, new_capacity), bool)
                big[:, : self.capacity] = m
                words = P.pack_rows(big)
            out = np.zeros((new_capacity, words.shape[1]), np.uint32)
            out[: self.capacity] = words
            grown.append(out)
        self.final, self.near = grown
        self.capacity = new_capacity
        self.W = P.words_per_row(new_capacity)

    # -- degradation / re-arm -----------------------------------------------

    def force_demote(self) -> None:
        """Demote as if the seam fired (deterministic reference runs drive
        a host twin through the same schedule)."""
        if not self.demoted:
            self.demoted = True
            self.stats["demotions"] += 1
            _DEMOTIONS.inc()

    def reset_interest(self) -> None:
        """Operator re-arm after a demotion (sticky by design, like
        reset_calc_chain/reset_emit_path).  Tier state restarts from
        scratch -- deterministic -- and the next step is a forced full
        evaluation whose diff against the demoted radius-only state
        re-emits exactly the policy transitions."""
        self.demoted = False
        self.near[:] = 0
        self._force_full = True
        self.stats["resets"] += 1

    # -- payloads (the state a checkpoint or a migration would carry) -------

    def export_payload(self) -> dict:
        out = {"capacity": self.capacity, "w": self.W,
               "final": self.final.tobytes(), "near": self.near.tobytes(),
               "step_count": self.step_count, "demoted": self.demoted,
               "policies": {p.name: p.params() for p in self.policies}}
        if self._field is not None:
            out["field"] = self._field.export_state()
        return out

    def import_payload(self, payload: dict | None) -> None:
        if payload is None:
            return
        cap, w = int(payload["capacity"]), int(payload["w"])
        if cap != self.capacity:
            raise ValueError(
                f"interest payload capacity {cap} != stack {self.capacity}")
        self.final = np.frombuffer(payload["final"], np.uint32) \
            .reshape(cap, w).copy()
        self.near = np.frombuffer(payload["near"], np.uint32) \
            .reshape(cap, w).copy()
        self.step_count = int(payload["step_count"])
        self.demoted = bool(payload["demoted"])
        if "field" in payload and self._field is not None:
            f = DistanceField.import_state(payload["field"])
            for p in self.policies:
                if p.name == LineOfSightPolicy.name:
                    p.field = f
            self._cfg, self._field = _build_config(self.policies)


def _dev_eval(*args, grid=None, device="cuda"):
    from . import device as D

    return D.eval_step(*args, grid=grid, device=device)
