"""The port's paged storage (goworld_tpu_torch.ops.aoi_pages and the
buckets' ``paged`` mode) against the JAX package's.

The same numpy-seeded inputs go through both packages.  Tolerance: exact
equality everywhere -- the allocator's seven outputs against JAX's
``paged_extract`` (jitted on the CPU) and the numpy oracle; the helpers
(``decode_pages``, ``spill_stream``, ``validate_page_table``,
``pad_packet(page_granular=True)``, ``_PageDecay``) against JAX's; every
tick's enter/leave arrays of ``AOIEngine(device="cpu", paged=True)``
against JAX's ``AOIEngine("tpu", paged=True)`` and the CPU oracle
(shifted by one tick where deferred), with ``decode_overflow``,
``page_spills`` and ``page_occupancy``; the sharded absorbers on 8
virtual CPU shards with ``_max_chunks = 1`` (the row-sharded one against
the oracle only: see :func:`_forced`); and one ``aoi.pages`` plan
installed in both packages, with equal fired lists and counters.  A page
table that fails validation without an injected fault raises in the
port.
"""

import zlib

import numpy as np
import pytest
import torch

from goworld_tpu import faults as jfaults
from goworld_tpu.engine import aoi as JA
from goworld_tpu.engine.aoi import AOIEngine as JaxEngine
from goworld_tpu.ops import aoi_pages as JPG
from goworld_tpu.ops import aoi_stage as JAS
from goworld_tpu.parallel import SpaceMesh as JaxMesh
from goworld_tpu.parallel import multichip_devices as jax_devices
from goworld_tpu_torch import faults as tfaults
from goworld_tpu_torch.engine import aoi as A
from goworld_tpu_torch.engine.aoi import AOIEngine
from goworld_tpu_torch.ops import aoi_pages as PG
from goworld_tpu_torch.ops import aoi_stage as AS
from goworld_tpu_torch.ops import dispatch_count as DC
from goworld_tpu_torch.parallel import SpaceMesh

from test_aoi_delta import _pad, _scene, _sparse_step
from test_aoi_pages import clustered_frames
from torch_threads import one_intra_op_thread  # noqa: F401

PAGE_KEYS = ("decode_overflow", "page_spills", "page_occupancy")
FAULT_KEYS = ("rebuilds", "fallbacks", "host_ticks", "poisoned",
              "calc_level", "page_spills")


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


# -- the allocator -----------------------------------------------------------


def _grid(rng, n_words, density, bit31=False):
    chg = np.where(rng.random(n_words) < density,
                   rng.integers(1, 1 << 32, n_words, dtype=np.uint64)
                   .astype(np.uint32), np.uint32(0))
    if bit31:
        chg[chg != 0] |= np.uint32(1 << 31)
    new = rng.integers(0, 1 << 32, n_words, dtype=np.uint64).astype(np.uint32)
    return chg, new


def _hot_bin(rng, n_words, bw):
    chg, new = _grid(rng, n_words, 0.0)
    chg[3 * bw:4 * bw] = rng.integers(1, 1 << 32, bw, dtype=np.uint64)
    return chg, new


# (name, n_words, bin_words, n_pages, grid maker)
ALLOC_CASES = [
    ("sparse", 8192, 512, 16, lambda r, n, b: _grid(r, n, 0.01)),
    ("dense", 8192, 512, 160, lambda r, n, b: _grid(r, n, 0.9)),
    ("one_hot_bin", 8192, 512, 16, _hot_bin),
    ("serves_every_bin", 4096, 512, PG.pool_ceiling(4096, 512),
     lambda r, n, b: _grid(r, n, 0.7)),
    ("spills_some", 4096, 512, 16, lambda r, n, b: _grid(r, n, 0.5)),
    ("one_page_pool", 4096, 256, 1, lambda r, n, b: _grid(r, n, 0.3)),
    ("spills_over_max", 64 * 200, 64, 4, lambda r, n, b: _grid(r, n, 0.5)),
    ("ragged_last_bin", 4100, 512, 16, lambda r, n, b: _grid(r, n, 0.3)),
    ("bins_under_max_spill", 4096, 512, 2, lambda r, n, b: _grid(r, n, 0.6)),
    ("all_zero", 4096, 512, 16, lambda r, n, b: _grid(r, n, 0.0)),
    ("bit31_words", 8192, 512, 24,
     lambda r, n, b: _grid(r, n, 0.4, bit31=True)),
]


@pytest.mark.parametrize("name,n_words,bw,n_pages,make", ALLOC_CASES,
                         ids=[c[0] for c in ALLOC_CASES])
def test_allocator_matches_jax(name, n_words, bw, n_pages, make):
    import jax.numpy as jnp

    rng = np.random.default_rng(zlib.crc32(name.encode()))
    chg, new = make(rng, n_words, bw)
    free = rng.permutation(n_pages).astype(np.int32)
    got = PG.allocate_pages(torch.from_numpy(chg.view(np.int32)),
                            torch.from_numpy(new.view(np.int32)),
                            torch.from_numpy(free), PG.PAGE_WORDS, bw,
                            PG.MAX_SPILL)
    jax_out = JPG.paged_extract(jnp.asarray(chg), jnp.asarray(new),
                                jnp.asarray(free), page_words=PG.PAGE_WORDS,
                                bin_words=bw, max_spill=PG.MAX_SPILL)
    host = PG.allocate_pages_host(chg, new, free, PG.PAGE_WORDS, bw,
                                  PG.MAX_SPILL)
    for i, (t, j, h) in enumerate(zip(got, jax_out, host)):
        j = np.asarray(j)
        t = t.numpy().view(j.dtype)
        assert t.shape == j.shape == h.shape, (i, t.shape, j.shape)
        np.testing.assert_array_equal(t, j, err_msg=f"{name} output {i}")
        np.testing.assert_array_equal(h, j, err_msg=f"{name} oracle {i}")
    n_used, n_spill = (int(v) for v in host[6][:2])
    n_bins = -(-n_words // bw)
    if name == "spills_over_max":
        assert n_spill > PG.MAX_SPILL
    if name == "bins_under_max_spill":
        assert n_bins < PG.MAX_SPILL and got[5].shape == (n_bins,)
        assert n_spill > 0
    if name == "serves_every_bin":
        assert n_spill == 0 and n_used > 0
    if name in ("spills_some", "one_page_pool"):
        assert 0 < n_spill <= PG.MAX_SPILL
    # the used pages and the spilled bins cover the grid's change words
    gidx, cv, nv = PG.decode_pages(*(a.numpy()[:n_used] for a in got[:3]))
    sg, sc, sn = PG.spill_stream(torch.from_numpy(chg.view(np.int32)),
                                 torch.from_numpy(new.view(np.int32)),
                                 got[5].numpy(), bw, n_words)
    if n_spill <= PG.MAX_SPILL:
        allg = np.concatenate([gidx.astype(np.int64), sg])
        order = np.argsort(allg)
        ref = np.nonzero(chg)[0]
        np.testing.assert_array_equal(allg[order], ref)
        np.testing.assert_array_equal(np.concatenate([cv, sc])[order],
                                      chg[ref])
        np.testing.assert_array_equal(np.concatenate([nv, sn])[order],
                                      new[ref])


def test_allocator_on_word_grid_shape():
    """A [S, C, W] int32 grid (what the bucket hands it) with the default
    bin width: equal to JAX's on the same grid."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    chg, new = _grid(rng, 2 * 256 * 8, 0.2)
    shape = (2, 256, 8)
    free = np.arange(PG.pool_floor(chg.size), dtype=np.int32)
    got = PG.allocate_pages(torch.from_numpy(chg.view(np.int32)).view(shape),
                            torch.from_numpy(new.view(np.int32)).view(shape),
                            torch.from_numpy(free))
    want = JPG.paged_extract(jnp.asarray(chg.reshape(shape)),
                             jnp.asarray(new.reshape(shape)),
                             jnp.asarray(free))
    assert PG.bin_words_for(8) == JPG.bin_words_for(8) == 64
    for t, j in zip(got, want):
        j = np.asarray(j)
        np.testing.assert_array_equal(t.numpy().view(j.dtype), j)


# -- the helpers -------------------------------------------------------------


def test_constants_and_sizes_match_jax():
    assert (PG.PAGE_WORDS, PG.BIN_ROWS, PG.MAX_SPILL) == \
        (JPG.PAGE_WORDS, JPG.BIN_ROWS, JPG.MAX_SPILL)
    for n in (1, 100, 4096, 67108864, 12345):
        assert PG.pool_floor(n) == JPG.pool_floor(n)
        for bw in (64, 512, 4096):
            assert PG.pool_ceiling(n, bw) == JPG.pool_ceiling(n, bw)
    for w in (0, 1, 8, 512):
        assert PG.bin_words_for(w) == JPG.bin_words_for(w)


def test_decode_and_spill_stream_match_jax():
    rng = np.random.default_rng(8)
    chg, new = _grid(rng, 4100, 0.4)
    free = rng.permutation(8).astype(np.int32)
    pg, pc, pn, _tab, _free, sb, scal = PG.allocate_pages_host(
        chg, new, free, PG.PAGE_WORDS, 512, PG.MAX_SPILL)
    n_used = int(scal[0])
    assert int(scal[1]) > 0
    got = PG.decode_pages(pg[:n_used], pc[:n_used].view(np.int32),
                          pn[:n_used])
    want = JPG.decode_pages(pg[:n_used], pc[:n_used], pn[:n_used])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    got = PG.spill_stream(torch.from_numpy(chg.view(np.int32)),
                          torch.from_numpy(new.view(np.int32)), sb, 512, 4100)
    want = JPG.spill_stream(chg, new, sb, 512, 4100)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    empty = PG.spill_stream(chg, new, np.full(3, -1, np.int32), 512, 4100)
    for g, w in zip(empty, JPG.spill_stream(chg, new, np.full(3, -1),
                                            512, 4100)):
        assert g.dtype == w.dtype and g.size == w.size == 0


@pytest.mark.parametrize("tab,n_used,n_pages", [
    ([3, 0, 2, -1, -1], 3, 5), ([3, 0, 2, -1, -1], 4, 5),
    ([3, 3, 2, -1, -1], 3, 5), ([5, 0, 2, -1, -1], 3, 5),
    ([np.iinfo(np.int32).min] * 5, 3, 5), ([0, 1], 2, 3), ([0, 1], 3, 2),
    ([-1, -1], 0, 2), ([1, -1, 0], 1, 3)])
def test_validate_page_table_matches_jax(tab, n_used, n_pages):
    t = np.array(tab, np.int32)
    assert PG.validate_page_table(t, n_used, n_pages) == \
        JPG.validate_page_table(t, n_used, n_pages)


@pytest.mark.parametrize("k", [1, 30, 64, 65, 130, 511, 512, 513, 1000])
def test_pad_packet_page_granular_matches_jax(k):
    i = np.arange(k, dtype=np.int32)
    pkt = (i, i * 2, i.astype(np.float32), -i.astype(np.float32))
    for flag in (False, True):
        got = AS.pad_packet(*pkt, page_granular=flag)
        want = JAS.pad_packet(*pkt, page_granular=flag)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    # the fused tick's one length still wins
    assert len(AS.pad_packet(*pkt, length=1024, page_granular=True)[0]) \
        == 1024


def test_page_decay_matches_jax():
    rng = np.random.default_rng(4)
    mine, theirs = A._PageDecay(floor=64), JA._PageDecay(floor=64)
    cur = 4096
    for step in range(400):
        if step in (50, 210):
            mine.reset_after_growth()
            theirs.reset_after_growth()
        used = int(rng.integers(0, 3000 if step < 150 else 90))
        a, b = mine.observe(used, cur), theirs.observe(used, cur)
        assert a == b and mine.steady == theirs.steady, step
        if a is not None:
            cur = a


# -- the engine --------------------------------------------------------------

CAP = 256
TICKS = 9
SPECIAL = {3: "still", 5: "radius", 7: "mass"}


def _walk(engines, ticks=TICKS, seed=7, n=180, spaces=2, special=SPECIAL,
          setup=None):
    """One sparse walk per space into every engine (``special`` ticks:
    no mover, an r change, a mass move); per engine the per-tick events
    and dispatches, a deferred engine's trailing tick out of drain().
    ``setup(key, handles)`` runs before the first tick."""
    handles = {k: [e.create_space(CAP) for _ in range(spaces)]
               for k, e in engines.items()}
    if setup is not None:
        for k, hs in handles.items():
            setup(k, hs)
    scenes = [list(_scene(seed + i, CAP, n)) for i in range(spaces)]
    out = {k: [] for k in engines}
    disp = {k: [] for k in engines}
    for t in range(ticks):
        for rng, xs, zs, rr, _act in scenes:
            what = special.get(t)
            if what == "radius":
                rr[5] += 7.0
            elif what == "mass":
                _sparse_step(rng, xs, zs, frac=1.0)
            elif what is None:
                _sparse_step(rng, xs, zs)
        for k, e in engines.items():
            for (_r, xs, zs, rr, act), h in zip(scenes, handles[k]):
                e.submit(h, _pad(xs, CAP), _pad(zs, CAP), _pad(rr, CAP),
                         act.copy())
            DC.reset()
            e.flush()
            disp[k].append(DC.read())
            out[k].append([e.take_events(h) for h in handles[k]])
    for k, e in engines.items():
        if e.has_pending():
            # the JAX engine delivers its tick in flight at a flush with
            # nothing staged
            getattr(e, "drain", e.flush)()
            out[k].append([e.take_events(h) for h in handles[k]])
    return handles, out, disp


def _same_events(out, key, ref="cpu", shift=0):
    assert len(out[key]) == len(out[ref]) + shift
    for t, tick in enumerate(out[ref]):
        for s, ((we, wl), (ge, gl)) in enumerate(zip(tick,
                                                     out[key][t + shift])):
            np.testing.assert_array_equal(ge, we, err_msg=f"{key} t={t} s={s}")
            np.testing.assert_array_equal(gl, wl, err_msg=f"{key} t={t} s={s}")


def _same_stats(jb, tb, keys=PAGE_KEYS):
    assert {k: tb.stats[k] for k in keys} == \
        {k: jb.stats[k] for k in keys}, (tb.stats, jb.stats)


VARIANTS = [({}, 0), ({"pipeline": True}, 1), ({"emit": "host"}, 0),
            ({"flush_sched": False}, 0), ({"cross_tick": True}, 1),
            ({"fused": True}, 0), ({"fused": True, "cross_tick": True}, 1)]


@pytest.mark.parametrize("kw,shift", VARIANTS,
                         ids=["default", "pipeline", "emit_host",
                              "sequential_flush", "cross_tick", "fused",
                              "fused_cross_tick"])
def test_paged_engine_matches_jax(kw, shift):
    """Every tick's events equal the oracle's (shifted by one tick where
    deferred) and, undeferred, the JAX paged engine's; the page counters
    equal JAX's; a fused engine replays every eligible tick (one
    dispatch a steady tick per bucket)."""
    engines = {"cpu": JaxEngine(default_backend="cpu"),
               "jax": JaxEngine(default_backend="tpu", paged=True, **kw),
               "port": AOIEngine(device="cpu", paged=True, **kw)}
    handles, out, disp = _walk(engines)
    _same_events(out, "port", shift=shift)
    if not shift:
        _same_events(out, "jax")
    for jh, th in zip(handles["jax"], handles["port"]):
        assert th.bucket.paged
        _same_stats(jh.bucket, th.bucket)
        assert th.bucket.stats["decode_overflow"] == 0
        assert th.bucket.stats["page_occupancy"] > 0
        assert th.bucket._n_pages == jh.bucket._n_pages
    if kw.get("fused"):
        st = handles["port"][0].bucket.stats
        eligible = [t for t in range(TICKS) if t not in (0, 5, 7)]
        assert st["fused_dispatches"] == len(eligible)
        assert st["fused_demotions"] == 0
        assert [disp["port"][t] for t in eligible[1:]] == \
            [1] * (len(eligible) - 1)
        assert type(handles["port"][0].bucket._fz).__name__ == "FusedPaged"


def test_fused_paged_equals_unfused_per_tick():
    """The fused paged tick's events, pools and counters equal the
    unfused paged tick's on every tick (both undeferred)."""
    engines = {"plain": AOIEngine(device="cpu", paged=True),
               "fused": AOIEngine(device="cpu", paged=True, fused=True)}
    handles, out, _ = _walk(engines)
    _same_events(out, "fused", ref="plain")
    for p, f in zip(handles["plain"], handles["fused"]):
        _same_stats(p.bucket, f.bucket)
        assert f.bucket._n_pages == p.bucket._n_pages


def test_paged_tiny_pool_spills_and_rearms():
    """A pool preset to 4 pages spills (counted), republishes the same
    tick bit-exact, and grows as JAX's does."""
    def tiny(key, hs):
        if key != "cpu":  # the decay's floor sizes the first pool
            decay = A._PageDecay if key == "port" else JA._PageDecay
            hs[0].bucket._pages = decay(floor=4)

    engines = {"cpu": JaxEngine(default_backend="cpu"),
               "jax": JaxEngine(default_backend="tpu", paged=True),
               "port": AOIEngine(device="cpu", paged=True)}
    handles, out, _ = _walk(engines, spaces=1, setup=tiny)
    _same_events(out, "port")
    _same_events(out, "jax")
    tb, jb = handles["port"][0].bucket, handles["jax"][0].bucket
    _same_stats(jb, tb)
    assert tb.stats["page_spills"] > 0 and tb._n_pages > 4
    assert tb._n_pages == jb._n_pages


def test_clustered_crowd_capped_overflows_paged_absorbs():
    """The clustered crowd (capacity 1024, 800 entities, 5 ticks): the
    capped bucket overflows its triple cap (decode_overflow > 0), the
    paged one does not; both equal the oracle, the paged one's counters
    JAX's."""
    cap, n = 1024, 800
    frames = clustered_frames(cap, n, 5)
    engines = {"cpu": JaxEngine(default_backend="cpu"),
               "capped": AOIEngine(device="cpu"),
               "jax": JaxEngine(default_backend="tpu", paged=True),
               "port": AOIEngine(device="cpu", paged=True)}
    hs = {k: e.create_space(cap) for k, e in engines.items()}
    out = {k: [] for k in engines}
    for fr in frames:
        for k, e in engines.items():
            e.submit(hs[k], *fr)
            e.flush()
            out[k].append([e.take_events(hs[k])])
    for k in ("capped", "jax", "port"):
        _same_events(out, k)
    assert hs["capped"].bucket.stats["decode_overflow"] > 0
    _same_stats(hs["jax"].bucket, hs["port"].bucket)
    assert hs["port"].bucket.stats["decode_overflow"] == 0


def _forced(kind, paged, pipeline=False, plan=None, cap=1024, n=500,
            ticks=4):
    """The mesh (``kind="mesh"``) or row-sharded bucket on 8 virtual
    shards with ``_max_chunks = 1``: every shard's stream overflows, so
    with ``paged`` every shard takes the absorber (the JAX package's
    ``_forced_overflow_tier``).  The port and, paged and undeferred, the
    JAX mesh bucket against the oracle; returns both buckets.  The JAX
    row-sharded bucket's absorber is left out: it aborts the process now
    and then inside ``paged_extract`` (XLA on the CPU, a fatal abort, not
    an exception), which would take the test worker down with it, so the
    port's row-sharded absorber is held to the oracle only."""
    if plan is not None:
        jfaults.install(plan)
        tfaults.install(plan)
    kw = {"rowshard_min_capacity": cap} if kind == "rowshard" else {}
    engines = {"cpu": JaxEngine(default_backend="cpu"),
               "port": AOIEngine(device="cpu", mesh=SpaceMesh(["cpu"] * 8),
                                 paged=paged, pipeline=pipeline, **kw)}
    shift = int(pipeline and kind == "mesh")  # the row-sharded is sync
    if paged and not pipeline and kind == "mesh":
        engines["jax"] = JaxEngine(default_backend="tpu",
                                   mesh=JaxMesh(jax_devices(8)),
                                   paged=paged, pipeline=pipeline, **kw)
    hs = {k: e.create_space(cap) for k, e in engines.items()}
    for k in engines:
        if k != "cpu":
            hs[k].bucket._max_chunks = 1
    if "jax" in hs:
        hs["jax"].bucket._step_cache.clear()
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 600, cap).astype(np.float32)
    z = rng.uniform(0, 600, cap).astype(np.float32)
    r = np.full(cap, 80, np.float32)
    act = np.zeros(cap, bool)
    act[:n] = True
    out = {k: [] for k in engines}
    for _t in range(ticks):
        x = np.clip(x + rng.uniform(-25, 25, cap), 0, 600).astype(np.float32)
        z = np.clip(z + rng.uniform(-25, 25, cap), 0, 600).astype(np.float32)
        for k, e in engines.items():
            e.submit(hs[k], x, z, r, act)
            e.flush()
            out[k].append([e.take_events(hs[k])])
    if shift:
        engines["port"].drain()
        out["port"].append([engines["port"].take_events(hs["port"])])
    _same_events(out, "port", shift=shift)
    if "jax" in out:
        _same_events(out, "jax")
        return hs["port"].bucket, hs["jax"].bucket
    return hs["port"].bucket, None


@pytest.mark.parametrize("kind", ["mesh", "rowshard"])
@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["sequential", "pipelined"])
def test_sharded_absorber_matches_jax(kind, pipeline):
    """Capped, a forced overflow grows the caps and counts
    decode_overflow; paged, every shard is absorbed through the page pool
    with decode_overflow 0 and no cap growth, the counters JAX's."""
    tb, _ = _forced(kind, paged=False, pipeline=pipeline)
    assert tb.stats["decode_overflow"] > 0 and tb._max_chunks > 1
    tb, jb = _forced(kind, paged=True, pipeline=pipeline)
    assert tb.stats["decode_overflow"] == 0 and tb._max_chunks == 1
    assert tb.stats["page_occupancy"] > 0
    if jb is not None:
        _same_stats(jb, tb)
        assert tb._n_pages == jb._n_pages


@pytest.mark.parametrize("kind", ["mesh", "rowshard"])
def test_sharded_absorber_pages_seam(kind):
    """``aoi.pages`` ``oom`` and ``poison`` on the absorber: a counted
    whole-shard spill, the poisoned table caught by validation; the
    events stay the oracle's, no cap grows."""
    tb, _ = _forced(kind, paged=True, plan="aoi.pages:oom@2;"
                    "aoi.pages:poison@3")
    assert tb.stats["page_spills"] >= 2 and tb.stats["poisoned"] == 1
    assert tb.stats["decode_overflow"] == 0 and tb._max_chunks == 1
    assert [(f["seam"], f["kind"]) for f in tfaults.plan().fired] == [
        ("aoi.pages", "oom"), ("aoi.pages", "poison")]


PAGE_PLAN = "aoi.pages:oom@3;aoi.pages:partial@5;aoi.pages:poison@7"


def test_pages_seam_matches_jax():
    """One plan (``oom`` at 3, ``partial`` at 5, ``poison`` at 7) in both
    packages: the same events as the oracle, the same fired lists and
    counters.  ``oom``/``partial`` spill the tick to the host; the
    poisoned table is caught and the tick recomputed on the host, with
    no demotion."""
    jfaults.install(PAGE_PLAN)
    tfaults.install(PAGE_PLAN)
    engines = {"cpu": JaxEngine(default_backend="cpu"),
               "jax": JaxEngine(default_backend="tpu", paged=True),
               "port": AOIEngine(device="cpu", paged=True)}
    handles, out, _ = _walk(engines, ticks=10, spaces=1, special={})
    _same_events(out, "port")
    _same_events(out, "jax")
    tb, jb = handles["port"][0].bucket, handles["jax"][0].bucket
    _same_stats(jb, tb, FAULT_KEYS + PAGE_KEYS)
    assert tfaults.plan().fired == jfaults.plan().fired
    assert [f["kind"] for f in tfaults.plan().fired] == [
        "oom", "partial", "poison"]
    st = tb.stats
    assert st["page_spills"] >= 2 and st["poisoned"] == 1
    assert st["rebuilds"] == 1 and st["host_ticks"] == 1
    assert st["calc_level"] == 0


def test_corrupt_table_without_fault_raises(monkeypatch):
    """A page table that fails validation with no injected fault is an
    allocator bug: it propagates from the single-device harvest and from
    the sharded absorber."""
    real = PG.allocate_pages

    def duplicate(*a, **kw):
        out = list(real(*a, **kw))
        tab = out[3].clone()
        tab[1] = tab[0]  # a page handed out twice
        out[3] = tab
        return tuple(out)

    monkeypatch.setattr(PG, "allocate_pages", duplicate)
    eng = AOIEngine(device="cpu", paged=True)
    h = eng.create_space(CAP)
    rng, xs, zs, rr, act = _scene(5, CAP, 180)
    eng.submit(h, _pad(xs, CAP), _pad(zs, CAP), _pad(rr, CAP), act)
    with pytest.raises(RuntimeError, match="allocator") as e:
        eng.flush()
    assert not isinstance(e.value, tfaults.InjectedFault)
    eng = AOIEngine(device="cpu", mesh=SpaceMesh(["cpu"] * 8), paged=True)
    h = eng.create_space(1024)
    h.bucket._max_chunks = 1
    eng.submit(h, *clustered_frames(1024, 500, 1)[0])
    with pytest.raises(RuntimeError, match="allocator") as e:
        eng.flush()
    assert not isinstance(e.value, tfaults.InjectedFault)
