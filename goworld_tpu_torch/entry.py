"""Entry points of the port: the counterparts of the JAX package's
``__graft_entry__.py``.

``entry(device)``            -- one batched AOI tick (the ``emit="entlv"``
                                step) for 4 spaces x 256 entities, and its
                                example inputs on ``device``.
``dryrun_multichip(n, device)`` -- the multi-device tier once, on small
                                shapes: the space-sharded step and its
                                chunk extraction, the engine on a mesh
                                (``Runtime`` with a mesh bucket) and the
                                row-sharded engine, each checked against
                                the single-device port.

``device="cuda"`` (the default) runs on the card: ``dryrun_multichip``
then needs ``n`` distinct CUDA devices (``parallel.multichip_devices``
raises without them).  ``device="cpu"`` runs the plain versions on ``n``
virtual shards of the CPU, as the tests do.  The engine-on-mesh check
runs the mesh bucket pipelined (``aoi_pipeline=True``) against the
single-device runtime, one tick apart, as the JAX package's does.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine.aoi import resolve_device
from .ops import aoi_cuda as AK
from .ops import aoi_predicate as P
from .parallel import SpaceMesh, make_sharded_aoi_step, multichip_devices


def _example_batch(s, cap, seed=0):
    """The JAX entry's inputs (``__graft_entry__._example_batch``), numpy:
    x, z, r [s, cap] f32, act bool, prev uint32 [s, cap, cap / 32]."""
    rng = np.random.default_rng(seed)
    w = P.words_per_row(cap)
    x = rng.uniform(0, 400, (s, cap)).astype(np.float32)
    z = rng.uniform(0, 400, (s, cap)).astype(np.float32)
    r = np.full((s, cap), 25, np.float32)
    act = rng.random((s, cap)) < 0.9
    prev = np.zeros((s, cap, w), np.uint32)
    return x, z, r, act, prev


def entry(device="cuda"):
    """``(fn, example_args)``: ``fn(*example_args)`` is one batched AOI
    tick, ``(new, enter, leave)`` int32 words, for 4 spaces x 256
    entities on ``device``."""
    dev = resolve_device(device)

    def step(x, z, r, act, prev):
        return AK.aoi_step_entlv(x, z, r, act, prev)

    x, z, r, act, prev = _example_batch(4, 256)
    args = tuple(torch.from_numpy(a).to(dev) for a in (x, z, r, act))
    return step, args + (P.words_to_torch(prev, dev),)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The multi-device tier on ``n_devices`` shards (distinct CUDA
    devices, or virtual CPU shards with ``device="cpu"``); raises on any
    divergence."""
    if torch.device(device).type == "cuda":
        devices = multichip_devices(n_devices)
    else:
        devices = [torch.device(device)] * n_devices
    sm = SpaceMesh(devices)
    step = make_sharded_aoi_step(sm)
    s = 2 * n_devices  # 2 spaces per shard
    sharded = [sm.device_put(a) for a in _example_batch(s, 128, seed=1)]
    new, ent, lv, total = step(*sharded)
    assert [t.device for t in new] == sm.devices
    assert total > 0
    # a second step feeding the new words back: same inputs, no events
    _new2, _e2, _l2, total2 = step(*sharded[:4], new)
    assert total2 == 0, "same inputs and interests must give no events"
    # shard-local extraction; chunk_k=128 makes every chunk's slots
    # sufficient (a 128-word chunk holds at most 128 nonzero words)
    mw = 1024
    step_ex = make_sharded_aoi_step(sm, max_words=mw, chunk_k=128)
    _new3, ent_s, _lv_s, total3 = step_ex(*sharded)
    assert total3 == total and len(ent_s) == n_devices
    assert sum(int(e[2]) for e in ent_s) <= total3
    for _vals, _idx, _nw, nd, mcc in ent_s:
        assert int(nd) <= mw // 128, "dirty-chunk overflow"
        assert int(mcc) <= 128
    _dryrun_engine_on_mesh(sm, n_devices, devices[0])
    _dryrun_rowshard_on_mesh(sm, n_devices, devices[0])


def _dryrun_rowshard_on_mesh(sm, n_devices: int, device) -> None:
    """One space's interest rows partitioned over the mesh (rectangular
    step per shard); events equal to the single-device engine's, the
    clear storm silent."""
    from .engine.aoi import AOIEngine
    from .engine.aoi_rowshard import _RowShardCUDABucket

    cap = max(1024, n_devices * 128)
    eng = AOIEngine(device=device.type, mesh=sm, rowshard_min_capacity=cap)
    ref = AOIEngine(device=device.type)
    h = eng.create_space(cap)
    assert isinstance(h.bucket, _RowShardCUDABucket)
    rh = ref.create_space(cap)
    rng = np.random.default_rng(9)
    n = min(cap, 700)
    x = rng.uniform(0, 1200, n).astype(np.float32)
    z = rng.uniform(0, 1200, n).astype(np.float32)
    r = rng.uniform(40, 90, n).astype(np.float32)
    act = np.ones(n, bool)

    def tick(act):
        eng.submit(h, x, z, r, act)
        ref.submit(rh, x, z, r, act)
        eng.flush()
        ref.flush()
        e, lv = eng.take_events(h)
        re_, rl = ref.take_events(rh)
        assert np.array_equal(e, re_) and np.array_equal(lv, rl), (
            "row-sharded events diverged from the single-device engine")
        return e, lv

    for _t in range(2):
        x = np.clip(x + rng.uniform(-25, 25, n), 0, 1200).astype(np.float32)
        z = np.clip(z + rng.uniform(-25, 25, n), 0, 1200).astype(np.float32)
        tick(act)
    gone = rng.choice(n, 60, replace=False)
    act2 = act.copy()
    act2[gone] = False
    for s_ in gone:
        eng.clear_entity(h, int(s_))
        ref.clear_entity(rh, int(s_))
    _e, lv = tick(act2)
    assert len(lv) == 0, "clear storm must be silent"
    eng.release_space(h)


def _dryrun_engine_on_mesh(sm, n_devices: int, device) -> None:
    """``Runtime.tick`` with the mesh bucket in its pipelined mode against
    the sequential single-device runtime on the same walk: the mesh's
    calculator events arrive one tick late, so it is compared shifted at
    every movement tick and at a drain tick, and over the union of (storm
    tick, drain tick) where a clear storm's synchronous leaves and the
    late events interleave.  Multi-step churn, a clear storm and capacity
    growth (one space pushed past its 128 slots, carrying its interest
    state)."""
    from .engine.entity import Entity
    from .engine.runtime import Runtime
    from .engine.space import Space
    from .engine.vector import Vector3

    events = {"mesh": [], "single": []}

    def build(kind, mesh):
        log = events[kind]

        class Scene(Space):
            pass

        class Mob(Entity):
            use_aoi = True
            aoi_distance = 40.0

            def on_enter_aoi(self, other):
                log.append(("enter", self.id, other.id))

            def on_leave_aoi(self, other):
                log.append(("leave", self.id, other.id))

        rt = Runtime(device=device.type, aoi_mesh=mesh,
                     aoi_pipeline=mesh is not None)
        rt.entities.register(Scene)
        rt.entities.register(Mob)
        return rt

    runtimes = {"mesh": build("mesh", sm), "single": build("single", None)}
    rng = np.random.default_rng(5)
    n_spaces, per = 2 * n_devices, 48
    pos0 = rng.uniform(0, 250, (n_spaces, per, 2)).astype(np.float32)
    steps = rng.uniform(-25, 25, (3, n_spaces, per, 2)).astype(np.float32)
    ents = {}
    for kind, rt in runtimes.items():
        es = []
        for si in range(n_spaces):
            sp = rt.entities.create_space("Scene", kind=1)
            sp.enable_aoi(40.0)
            for ei in range(per):
                es.append(rt.entities.create(
                    "Mob", space=sp,
                    pos=Vector3(pos0[si, ei, 0], 0.0, pos0[si, ei, 1])))
        ents[kind] = es
        rt.tick()
    (bucket,) = runtimes["mesh"].aoi._buckets.values()
    assert bucket.pipeline, "the dryrun drives the pipelined mesh bucket"
    assert len(bucket.prev) == n_devices

    def canon(kind):
        idmap = {e.id: i for i, e in enumerate(ents[kind])}
        out = sorted((ev, idmap[a], idmap[b]) for ev, a, b in events[kind])
        events[kind].clear()
        return out

    assert canon("mesh") == [], "the pipelined flush delivered same-tick"
    expect = canon("single")  # the mass enter, due at the next mesh tick
    assert expect, "the mass-enter tick delivered nothing"
    pos = pos0.copy()
    for t in range(3):
        pos = np.clip(pos + steps[t], 0, 250)
        for rt_kind, rt in runtimes.items():
            es = ents[rt_kind]
            for si in range(n_spaces):
                for ei in range(per):
                    es[si * per + ei].set_position(
                        Vector3(pos[si, ei, 0], 0.0, pos[si, ei, 1]))
            rt.tick()
        m = canon("mesh")
        assert m == expect, (f"tick {t}: {len(m)} mesh events vs "
                             f"{len(expect)} one tick before")
        expect = canon("single")
    runtimes["mesh"].tick()  # drain tick: nothing staged, one in flight
    assert canon("mesh") == expect, "the drain tick diverged"
    # clear storm (one space's entities all destroyed) + growth
    newcomers = rng.uniform(0, 250, (130, 2)).astype(np.float32)
    for kind, rt in runtimes.items():
        for e in ents[kind][:per]:
            e.destroy()
        grow_space = ents[kind][per].space
        for p in newcomers:
            ents[kind].append(rt.entities.create(
                "Mob", space=grow_space,
                pos=Vector3(float(p[0]), 0.0, float(p[1]))))
        rt.tick()
    m_storm = canon("mesh")
    runtimes["mesh"].tick()  # drain
    m = sorted(m_storm + canon("mesh"))
    c = canon("single")
    assert m == c and len(m) > 0, (
        f"storm and growth: {len(m)} mesh events vs {len(c)} single")
    assert ents["mesh"][per].space._cap >= 256, "growth did not happen"
    assert not runtimes["mesh"].aoi.has_pending()
    assert bucket.full_roundtrips == 0, (
        "steady maintenance must not round-trip the full interest state")
