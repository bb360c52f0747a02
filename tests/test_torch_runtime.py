"""The port's Runtime (goworld_tpu_torch.engine.runtime, device="cpu")
against the JAX package's Runtime on its "tpu" AOI backend, driven by the
same seeded game: hook-overriding watchers and plain entities, per-entity
set_position and bulk Space.move_entities, entities leaving, and growth
past capacity 128.  Every tick the CRC of the delivered enter/leave arrays,
every entity's neighbors() and the watchers' hook calls must be equal."""

import zlib

import numpy as np
import pytest

import goworld_tpu.engine.entity as JEnt
import goworld_tpu.engine.runtime as JRt
import goworld_tpu.engine.space as JSp
import goworld_tpu.engine.vector as JVec
import goworld_tpu_torch.engine.entity as TEnt
import goworld_tpu_torch.engine.runtime as TRt
import goworld_tpu_torch.engine.space as TSp
import goworld_tpu_torch.engine.vector as TVec
from torch_threads import one_intra_op_thread  # noqa: F401


class World:
    """One seeded game on one package's Runtime."""

    def __init__(self, rt, ent_mod, space_mod, vec_mod):
        self.rt = rt
        self.V = vec_mod.Vector3
        log = self.log = []

        class Scene(space_mod.Space):
            pass

        class Mob(ent_mod.Entity):
            use_aoi = True
            aoi_distance = 60.0

        class Watcher(ent_mod.Entity):
            use_aoi = True
            aoi_distance = 80.0

            def on_enter_aoi(self, other):
                log.append(("enter", self.idx, other.idx))

            def on_leave_aoi(self, other):
                log.append(("leave", self.idx, other.idx))

        for cls in (Scene, Mob, Watcher):
            rt.entities.register(cls)
        self.crc = 0
        take = rt.aoi.take_events

        def folding_take(h):
            ev = take(h)
            for a in ev:
                self.crc = zlib.crc32(np.ascontiguousarray(a).tobytes(),
                                      self.crc)
            return ev

        rt.aoi.take_events = folding_take
        self.space = rt.entities.create_space("Scene", kind=1)
        self.space.enable_aoi(60.0)
        self.ents = []

    def spawn(self, kind, x, z):
        e = self.rt.entities.create(kind, space=self.space,
                                    pos=self.V(float(x), 0.0, float(z)))
        e.idx = len(self.ents)
        self.ents.append(e)

    def snapshot(self):
        live = [e for e in self.ents if not e.destroyed]
        # hook calls as a sorted list: a destroy severs its pairs by
        # walking a set of entities, whose order is not defined
        return (self.crc, sorted(self.log),
                {e.idx: sorted(o.idx for o in e.neighbors()) for e in live})


def _game(world, seed):
    rng = np.random.default_rng(seed)
    for i in range(100):
        world.spawn("Watcher" if i % 10 == 0 else "Mob",
                    *rng.uniform(0, 400, 2))
    yield
    for t in range(7):
        live = [e for e in world.ents if not e.destroyed]
        moves = rng.uniform(-12, 12, (len(live), 2)).astype(np.float32)
        per_entity = rng.random(len(live)) < 0.3
        slots, xs, zs = [], [], []
        for e, (dx, dz), one in zip(live, moves, per_entity):
            x, z = e.position.x + dx, e.position.z + dz
            if one:
                e.set_position(world.V(float(x), 0.0, float(z)))
            else:
                slots.append(e.aoi_slot)
                xs.append(x)
                zs.append(z)
        world.space.move_entities(np.array(slots), np.array(xs, np.float32),
                                  np.array(zs, np.float32))
        if t == 2:  # growth past capacity 128
            for _ in range(60):
                world.spawn("Mob", *rng.uniform(0, 400, 2))
        if t in (3, 5):  # entities leave
            for i in rng.choice(len(world.ents), 12, replace=False):
                world.ents[i].destroy()
        yield


@pytest.mark.parametrize("seed", [0, 1])
def test_runtime_parity_with_jax(seed):
    jw = World(JRt.Runtime(aoi_backend="tpu"), JEnt, JSp, JVec)
    tw = World(TRt.Runtime(device="cpu"), TEnt, TSp, TVec)
    for _ in zip(_game(jw, seed), _game(tw, seed)):
        jw.rt.tick()
        tw.rt.tick()
        assert tw.snapshot() == jw.snapshot()
    assert tw.space._cap == jw.space._cap == 256
    assert len(tw.log) > 0 and sum(e.destroyed for e in tw.ents) > 0

