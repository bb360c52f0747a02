"""Chip smoke test of the PyTorch/CUDA port (goworld_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):

  1. device  -- torch must see a CUDA device; prints the card's name and
                power limit as nvidia-smi reports them;
  2. build   -- compiles every csrc/*.cu of the port with nvcc (sm_90a);
  3. kernels -- each kernel against its plain PyTorch version on the
                card, bit-exact, over edge-case inputs at the main path's
                shapes and around them (the persistent tile's edges too:
                W = 33 with R % 64 = 32, fewer work units than the
                resident grid and many more), timed with CUDA events;
  4. main    -- the port's main path at full size: Runtime(device="cuda"),
                8 spaces x 10,000 entities (capacity 16384, radius 100,
                world 4000, walk step 5), one hook-overriding watcher per
                space; a prime tick, 3 warm-up ticks and 20 measured ticks
                through Space.move_entities.  Checks that the prime tick
                went through the counted full-grid recovery and the steady
                ticks through on-device triples, that the final interest
                state equals the plain version over the staged inputs, and
                that every tick launched the kernel;
  5. parity  -- the same seeded walk at 2 spaces x 2,000 entities on
                device="cuda" and device="cpu": the CRCs of the delivered
                enter/leave arrays must be equal;
 13. deferred -- phase 4's world and walk on Runtime(aoi_pipeline=True),
                (aoi_cross_tick=True) and both, in turns with the
                sequential Runtime (each twice): the sequential per-tick
                CRCs equal phase 4's, a deferred run's equal them shifted
                by one tick (tick 0 empty, the last out of
                AOIEngine.drain); tick, loop (walk + tick) and split
                times, the triple prefetch's hit rate;
 14. fused   -- phase 4's world under a sparse walk (10% movers a tick,
                bench.py's movers_frac=0.1) with one r-change tick and one
                tick moving everyone (both restage in full: the unfused
                flow): unfused, fused (aoi_fused=True: a steady tick is one
                replay of a CUDA graph around csrc/aoi_step.cu) and fused
                + cross-tick in turns; fused CRCs equal the unfused ones
                per tick, fused + cross-tick's shifted by one; a measured
                tick counts 1 dispatch fused and 2 unfused; the fused
                dispatches equal the eligible ticks; no new capture key
                after warm-up; every aoi_step launch a replay, an unfused
                tick's or a capture's warm-up; graphs, their pool bytes;
 14b. sub change -- phase 4's world under the 10% walk with space 0
                opting out of the event stream and back in: a steady tick
                ships a delta packet, a subscription change restages
                x/z/sub in full (as the JAX bucket does); the ms, stage ms
                and H2D bytes of each;
 15. faults  -- phase 4's widths at 2 of its spaces (each host-recovered
                tick is numpy, about 4 s a space) through FAULT_PLAN (the
                plan of scripts/faults_smoke.py), then a second kernel
                failure (to the host oracle), an emit failure (to the
                host emit mode), reset_calc_chain() and 3 ticks:
                sequential and cross_tick on the card, sequential on the
                CPU path; per-tick CRCs equal to the fault-free card
                run's (shifted by one under cross_tick), the fault
                counters, levels and fired faults as planned, the kernel
                launched at the level-0 ticks only; the ms of the
                recovered, level-1, level-2 and back-at-0 ticks;
 15b. sharded faults -- the same plan on the mesh bucket (2 spaces on 4
                virtual shards; sequential and cross_tick) and on the
                row-sharded bucket (one space of 16384 over 4 virtual
                shards), each against its own fault-free run, with the
                same checks;
 16. routing -- Runtime(aoi_backend="auto") with bench.py's unity1k
                (1 x 1024, 1000 active, world 2000) beside phase 4's
                eight spaces: unity1k routes to cpp, the eight to cuda,
                per-tick CRCs equal to aoi_backend="cpu"; then phase 4's
                world and unity1k alone under cpp and cuda in turns: each
                bucket's tick ms.
 17. paged   -- phase 4's world and walk on Runtime(aoi_paged=True):
                sequential (its per-tick CRCs phase 4's; CUDA events
                around ops/aoi_pages.allocate_pages beside phase 4's
                extract_triples), pipeline and cross_tick (shifted by one
                tick), then phase 14's 10% walk unfused (equal to phase
                14's unfused run), fused (equal to unfused, 1 dispatch a
                steady tick) and fused + cross-tick (shifted); no
                decode_overflow, no page spill; tick and split ms, used
                pages, bytes fetched a tick, graphs and their pool bytes;
 17b. clustered crowd -- bench.py's bench_engine_clustered (1 x 2048,
                1,800 entities into one r=100 cluster at tick 2 of 8) on
                the cuda backend capped, paged and paged from a 4-page
                pool, against the cpu backend: equal CRCs; capped
                decode_overflow > 0, paged 0; the small pool spills and
                grows;
 17c. paged absorbers -- phase 11b's `million` on 4 virtual shards and
                phase 12's `zipf100k` row-sharded on 8, paged, 3 ticks,
                steady and with _max_chunks forced to 1 (every shard
                absorbed): CRCs equal those phases' non-paged ones,
                decode_overflow 0, no cap growth; the ms of each absorb;
 17d. pages seam -- phase 15's 2 spaces, paged, under aoi.pages oom at
                3, partial at 5 and poison at 7, on the card and on the
                CPU path: CRCs equal the fault-free card run's; 2 spills,
                1 poisoned table recovered on the host, calc level 0.
  6. giant kernels -- the rectangular step and the two block-culled
                kernels against their plain versions on the card,
                bit-exact, over edge-case inputs (NaN and +inf radii,
                inactive tails, nearly sorted orders) at BASELINE's giant
                shapes and around them (ragged: a 100-row rect block over
                1056 candidates, culled at C = 1056 and 4160); the culled
                step also against the dense kernel at full size, the
                words kernel's culled fraction equal to the step's and
                to the plain version of their vote (aoi_grid.tile_votes);
  6b. plans  -- both step modes (square and rect) and both culled kernels
                at the tile's edge shapes (and the words kernel's 16-byte
                stores at 8 x 4096) under three launch plans other than
                the card's own (its occupancy stood in for: one block, a
                few, one per SM), bit-exact against the plain versions,
                the culled fraction the same under each and equal to the
                plain vote's;
  7. grid    -- the fixed-order culled tick (ops/cadence.FixedOrderGrid)
                at BASELINE's `million` (64 x 16384) and `zipf100k`
                (1 x 131072, 100k active, 90% in a hot zone): a re-sort,
                16 ticks, a re-sort, 4 ticks; each tick runs the culled
                step, encodes the row stream on the device, fetches it,
                decodes it and replays it onto a host copy of the words,
                which must equal the device words (the replay is the
                check, timed apart from the decode); the final words
                must equal the plain dense words of the final positions;
                each re-sort's time is split into the sort and gathers,
                the words kernel's launch alone (CUDA events around the
                C call), the rest of its wrapper's bracket and the host
                remainder;
  8. zipfshare -- one device's 16,384-row block of a row-sharded
                `zipf100k` through the rectangular step, with the same
                codec and replay checks;
  9. entlv   -- the step kernel's emit="entlv" mode (new, enter, leave)
                against its plain version, bit-exact, on phase 3's edge
                inputs at (1, 128), (4, 256), (16, 128), (8, 16384),
                (64, 16384), the rectangular (3, 256, 4096) and the
                tile's edges (2, 1056), (3, 96), rect (2, 100, 1056); its
                new words against the chg mode's;
 10. sharded step -- parallel.make_sharded_aoi_step at `million` (64 x
                16384) on one shard, on 4 virtual shards of the card and,
                where torch sees several cards, on distinct cards: a prime
                tick and a walk tick, each mesh's words equal to the plain
                version, its total to the plain popcount, each shard's
                stream (max_words) to exactly its enter words; the
                kernel's launches are timed alone beside the wrapper's;
 11. engine on the mesh -- (a) Runtime on 4 virtual shards against the
                single-device Runtime on phase 4's world and walk, equal
                event CRC at every tick; (b) AOIEngine(mesh=...) at
                `million` on one shard and on 4 virtual shards: a prime
                tick (the counted recovery), 3 warm-up and 8 measured
                ticks decoding the per-shard streams, equal per-tick CRCs,
                final words equal to the plain dense words; then each
                mesh pipelined, its CRCs the same shifted by one tick;
 12. row-sharded -- one `zipf100k` space (1 x 131072) on the row-sharded
                bucket, on one shard and on 8 virtual shards (each then
                `zipfshare`'s 16384 x 131072 block): a prime tick and 4
                ticks, equal per-tick CRCs, the shards' words equal to the
                square kernel's, derive_row/derive_col equal to them.

 18. interest kernel -- csrc/interest_step.cu (the interest-policy
                stack step) against its plain version
                (ops/interest_kernels.step_words) on the card, bit for
                bit: the six policy mixes of tests/test_interest.py, full
                and off-cadence steps, LOS depths 1-4, at C = 128, 256
                and 384 on edge inputs (0.0 / -0.0, subnormals, NaN,
                +-inf, infinite and NaN radii, ties at r * near_frac and
                at rn * hysteresis, samples outside the world, team bit
                31, inactive slots, a NaN midpoint) and at C = 16384 on
                phase 18b's world; CUDA-event times, bounds (the LOS
                samples this run's inputs need) and SASS per pair;
 18b. interest slice -- phase 4's world with team + tier(period 4) +
                LOS(depth 2, five boxes baked at 100-unit cells) on every
                space, team/vis seeded as tests/test_interest.py's _walk;
                a prime tick, 3 warm-up and 12 measured: per-tick stack
                event CRCs and final words equal a twin whose step runs
                the plain version on the card and the pipelined Runtime
                (the stack steps in the flush that submitted it: no
                shift; trailing flushes deliver nothing); a cut run (2 x
                2048, 6 ticks) equal to aoi_interest="host"; tick_ms and
                its split (base stage / fetch / decode / emit, the stack
                step's upload, kernel, fetch and host diff, bytes a step);
 18c. load harness -- LoadHarness at scripts/loadgen_smoke.py's
                configuration (100,000 clients, 256 spaces, 8 gates,
                period 4) and bench.py bench_engine_load's (8192 clients,
                8 spaces, 4 gates), a 4-tick warm-up then 9 ticks, over
                the cpu and the cuda base calculators: moves/s, ms a
                tick, near/far p50/p99, the stack step's share; no
                per-entity write, no unclosed update, no demotion; every
                space's final words equal a host-mode run's.

Phases 13-17b and 17d run after phase 5, 17c after phase 12, 18-18c
last.  Every
fault-free phase checks that it
ended at calc level 0 with no recovery and the resolved emit mode.
Virtual shards are shards of one card taking turns on it: their times
are one card's, not a multi-card layout's.  The last lines are
{"main_path": ...}, {"giant": ...}, {"deferred": ...} (phases 13-14b),
{"faults": ..., "sharded_faults": ..., "routing": ...} (phases 15-16),
{"paged": ...} (phases 17-17d), {"mesh": ...}, {"interest": ...} (phases
18-18c), {"issue_floor": [...]} (each kernel's SASS instructions
per pair test, counted with cuobjdump in the libraries this run built,
and the least time to issue its pair tests at the SM clock read in phase
3), {"kernels": [...]} and {"ok": true, "device": {...}}.
Kernel launches are counted on the path each kernel serves, with the
counts reset just before it: the square step in phase 4 and in each
deferred and fused run of phases 13 and 14 (a graph replay counts one
launch), in phases 15 and 16 and on the mesh in phase 15b (its entry's
"launches" is their sum, "path_launches" each), the culled kernels in
phase 7, the rectangular step in phase 8 and on the row-sharded bucket
in phase 15b, the entlv mode in phase 10; phase 17's runs (17, 17b,
17d on the card) and the mesh of 17c add to the square step, the
row-sharded bucket of 17c to the rectangular one; the stack step's in
phase 18b (sequential, pipelined, the cut run) and in phase 18c.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

# -- H100 SXM peaks (NVIDIA data sheet): memory rate and f32 rate ------------
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per pair test of the AOI predicate: two subtracts, two
# abs, two compares
OPS_PER_PAIR = 6
ISSUE_LANES = 128  # thread-instructions an SM issues per clock (4 x 32)
SM_CLOCK_HZ = []   # SM clocks read during phase 3's timings

DEV = "cuda"  # every phase's tensors live on the current card

# the last two: the persistent tile's edges (W = 33 with R % 64 = 32;
# W = 3 and S above one SM's blocks)
KERNEL_SHAPES = [(1, 128), (3, 384), (8, 4096), (8, 16384), (64, 16384),
                 (2, 1056), (3, 96)]
MAIN_SHAPE = (8, 16384)

SPACES, PER_SPACE, CAPACITY = 8, 10_000, 16384
WORLD, RADIUS, STEP = 4000.0, 100.0, 5.0
WARMUP, MEASURED = 3, 20


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip smoke check failed: {msg}")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# -- phase 3: kernel vs plain ------------------------------------------------


def healthy(stats, label):
    """A fault-free run ends with no calculator demotion, no recovery and
    the emit mode the engine resolved: a demotion must never stand in for
    the kernel unseen."""
    from goworld_tpu_torch.ops import aoi_emit as AE

    bad = {k: stats[k] for k in ("calc_level", "fallbacks", "rebuilds",
                                 "host_ticks") if stats[k]}
    check(not bad, f"{label}: fault counters {bad} in a fault-free run")
    want = AE.EMIT_LEVEL[AE.resolve_mode("auto")]
    check(stats["emit_path"] == want,
          f"{label}: emit_path {stats['emit_path']}, want {want}")


def edge_inputs(s, c, seed, with_prev=True):
    """[S, C] inputs with the predicate's edge cases: a tie lattice, -0.0,
    NaN, +-inf, r = 0 with subnormal gaps, r = +inf, partially active
    rows, and (unless ``with_prev`` is false) prev words with bit 31
    set."""
    rng = np.random.default_rng(seed)
    w = c // 32
    x = (np.round(rng.uniform(0, 400, (s, c)) * 4) / 4).astype(np.float32)
    z = (np.round(rng.uniform(0, 400, (s, c)) * 4) / 4).astype(np.float32)
    r = rng.choice([0.0, 25.0, 50.0, 100.0], (s, c)).astype(np.float32)
    act = rng.random((s, c)) < 0.85
    n = min(c, 64)
    sub = np.float32(1e-40)  # subnormal
    x[:, :n:8] = 0.0
    x[:, 1:n:8] = -0.0
    x[:, 2:n:8] = sub
    x[:, 3:n:8] = -sub
    z[:, 2:n:8] = z[:, 3:n:8] = 0.0
    act[:, :8] = True
    z[:, :n:4] = 0.0
    r[:, :n:2] = 0.0
    x[:, 4:n:8] = np.nan
    z[:, 5:n:8] = np.inf
    x[:, 6:n:8] = -np.inf
    r[:, 7:n:16] = np.inf
    r[:, 15:n:16] = np.nan
    dev = DEV
    out = [torch.from_numpy(a).to(dev) for a in (x, z, r, act)]
    if with_prev:
        prev = rng.integers(-2**31, 2**31, (s, c, w), dtype=np.int64)
        prev = prev.astype(np.int32)
        prev[:, :, 0] |= np.int32(-2**31)  # bit 31 set
        out.append(torch.from_numpy(prev).to(dev))
    return out


def cuda_ms(fn, reps, warm=2):
    for _ in range(warm):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def aoi_step_bound(s, c, word_arrays=3):
    """Least time for one step at [S, C]: each input read once, each
    output written once, over the memory rate; the pair tests' f32
    operations over the f32 rate.  ``word_arrays``: prev in plus the
    outputs (3 for chg, 4 for entlv).  Returns (bound_ms, bound_by)."""
    w = c // 32
    nbytes = s * c * (4 + 4 + 4 + 1) + word_arrays * s * c * w * 4
    ops = s * c * c * OPS_PER_PAIR
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def read_sm_clock():
    """The SM clock now (Hz), as nvidia-smi reads it; kept for the issue
    floors."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout
    SM_CLOCK_HZ.append(float(out.split()[0]) * 1e6)


# the kernels whose pair region sass_per_pair reads: library, the
# function name's mark of the kernel, and whether its plane loop is
# unrolled (the dense step) or walks the voted planes (the culled kernels)
SASS_KERNELS = {"aoi_step": ("aoi_step", "aoi_step_kernelILN8aoi_tile4EmitE0E",
                             True),
                "aoi_step_entlv": ("aoi_step",
                                   "aoi_step_kernelILN8aoi_tile4EmitE1E",
                                   True),
                "aoi_words_culled": ("aoi_grid", "culled_words_kernel",
                                     False),
                "aoi_step_culled": ("aoi_grid", "culled_step_kernel",
                                    False)}
SASS_LINE = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                       r"([A-Z0-9_.]+)([^;]*);")


def pair_region(ins, unrolled):
    """Instructions per pair test of one kernel's SASS ``ins`` ([(address,
    opcode, operands)]); a pair test has two FSETP.  Unrolled: from the
    first to the last FSETP, over the pairs there.  Otherwise: the
    shortest loop (a backward branch) holding one plane's pairs, at least
    2 x 8 FSETP, over its pairs."""
    fsetp = [k for k, (_, op, _) in enumerate(ins) if op.startswith("FSETP")]
    if unrolled:
        return (fsetp[-1] - fsetp[0] + 1) / (len(fsetp) / 2)
    at = {a: k for k, (a, _, _) in enumerate(ins)}
    best = None
    for k, (a, op, args) in enumerate(ins):
        m = re.search(r"0x([0-9a-f]+)", args)
        if not op.startswith("BRA") or not m:
            continue
        head = at.get(int(m.group(1), 16))
        if head is None or head > k:
            continue
        n = sum(head <= j <= k for j in fsetp)
        if n >= 2 * 8 and (best is None or k - head + 1 < best[0]):
            best = (k - head + 1, n)
    return best[0] / (best[1] / 2)


def sass_per_pair(_build):
    """SASS instructions per pair test of each kernel, counted in the
    libraries this run built (``cuobjdump -sass``); None where the dump
    or the count fails (the issue floors are then not measured)."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    dumps, got = {}, {}
    for name, (lib, mark, unrolled) in SASS_KERNELS.items():
        try:
            if lib not in dumps:
                dumps[lib] = subprocess.run(
                    [tool, "-sass", os.path.join(_build.BUILD_DIR,
                                                 f"lib{lib}.so")],
                    capture_output=True, text=True, check=True,
                    timeout=120).stdout
            ins, inside = [], False
            for line in dumps[lib].splitlines():
                if "Function : " in line:
                    inside = mark in line
                elif inside and (m := SASS_LINE.match(line)):
                    if m.group(2) != "NOP":
                        ins.append((int(m.group(1), 16), m.group(2),
                                    m.group(3)))
            got[name] = pair_region(ins, unrolled)
        except (OSError, subprocess.SubprocessError, IndexError,
                TypeError) as e:
            log(f"sass_per_pair {name}: not measured ({e!r})")
            got[name] = None
    return got


def issue_floors(name, shape_rows, per_pair):
    """Least time to issue each shape's pair tests (the culled kernels':
    those their vote admits) at ``per_pair`` instructions a pair on every
    SM at the highest SM clock read in this run; None where the count is
    missing."""
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = n_sms * ISSUE_LANES * max(SM_CLOCK_HZ)
    out = []
    for r in shape_rows:
        s, *rc = r["shape"]
        pairs = s * rc[0] * rc[-1] * (1.0 - r.get("culled_frac", 0.0))
        out.append({"shape": r["shape"], "ms": r["ms"],
                    "bound_ms": r["bound_ms"],
                    "issue_floor_ms": (None if per_pair is None
                                       else pairs * per_pair / rate * 1e3)})
    return {"name": name, "sass_per_pair": per_pair,
            "sm_clock_hz": max(SM_CLOCK_HZ), "shapes": out}


def phase_kernels(AK, AD):
    rows, units = [], []
    for i, (s, c) in enumerate(KERNEL_SHAPES):
        x, z, r, act, prev = edge_inputs(s, c, seed=100 + i)
        new_k, chg_k = AK.aoi_step_chg_cuda(x, z, r, act, prev)
        new_p, chg_p = AD.aoi_step_chg_dense(x, z, r, act, prev)
        torch.cuda.synchronize()
        err = 0
        if not (torch.equal(new_k, new_p) and torch.equal(chg_k, chg_p)):
            err = max(int((new_k.long() - new_p.long()).abs().max()),
                      int((chg_k.long() - chg_p.long()).abs().max()))
        check(err == 0,
              f"aoi_step kernel != plain at S={s} C={c} (max |diff| {err})")
        del new_k, chg_k, new_p, chg_p
        ms = cuda_ms(lambda: AK.aoi_step_chg_cuda(x, z, r, act, prev),
                     reps=20 if c >= 16384 else 100)
        read_sm_clock()  # just after the kernel's timing, under load
        plain_ms = cuda_ms(lambda: AD.aoi_step_chg_dense(x, z, r, act, prev),
                           reps=1 if s * c >= 64 * 16384 else 3, warm=1)
        bound_ms, bound_by = aoi_step_bound(s, c)
        n_sms, bps = AK.occupancy("aoi_step", "gw_aoi_step_occupancy", 0,
                                  torch.device(DEV))
        plan = AK.last_plan["aoi_step"]  # what the timed launches walked
        units.append(plan.units / (n_sms * bps))
        row = {"shape": [s, c], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "max_abs_err": err}
        log("kernel aoi_step", json.dumps(row), "plan",
            json.dumps(dataclasses.asdict(plan)), "resident", n_sms * bps)
        rows.append(row)
        del x, z, r, act, prev
        torch.cuda.empty_cache()
    check(min(units) < 1 < max(units),
          f"phase 3 wants a shape with fewer work units than the resident "
          f"grid and one with more ({units})")
    return rows


# -- phase 4/5: the main path -------------------------------------------------


def build_world(Runtime, device, spaces, per_space, capacity, seed,
                extra=None, setup=None, **rt_kw):
    """``spaces`` spaces of ``per_space`` entities (world WORLD) on
    ``Runtime(device=device, **rt_kw)``, and with ``extra`` = (capacity,
    entities, world) one more space after them; ``setup(space)`` runs on
    each space after ``enable_aoi``, before its entities enter."""
    from goworld_tpu_torch.engine.entity import Entity
    from goworld_tpu_torch.engine.space import Space
    from goworld_tpu_torch.engine.vector import Vector3

    class SmokeScene(Space):
        world = WORLD  # the walk's bound

    class SmokeMob(Entity):
        use_aoi = True
        aoi_distance = RADIUS

    class SmokeWatcher(Entity):
        use_aoi = True
        aoi_distance = RADIUS

        def on_enter_aoi(self, other):  # non-plain: eager replay
            pass

    rt = Runtime(device=device, **rt_kw)
    for cls in (SmokeScene, SmokeMob, SmokeWatcher):
        rt.entities.register(cls)
    # v/events: the run's CRC and event count; t/te: the current tick's
    # (zeroed before each tick by the phase that ticks)
    crc = {"v": 0, "events": 0, "t": 0, "te": 0}
    take = rt.aoi.take_events

    def folding_take(h):
        ev = take(h)
        for a in ev:
            b = np.ascontiguousarray(a).tobytes()
            crc["v"] = zlib.crc32(b, crc["v"])
            crc["t"] = zlib.crc32(b, crc["t"])
            crc["events"] += len(a)
            crc["te"] += len(a)
        return ev

    rt.aoi.take_events = folding_take
    rng = np.random.default_rng(seed)
    spaces_l, slots, pos = [], [], []
    layout = [(capacity, per_space, WORLD)] * spaces
    if extra is not None:
        layout.append(extra)
    for cap, n, world in layout:
        sp = rt.entities.create_space("SmokeScene", kind=1)
        sp.world = world
        sp.enable_aoi(RADIUS, capacity=cap)
        if setup is not None:
            setup(sp)
        p = rng.uniform(0, world, (2, n)).astype(np.float32)
        ents = [rt.entities.create(
            "SmokeWatcher" if i == 0 else "SmokeMob", space=sp,
            pos=Vector3(float(p[0, i]), 0.0, float(p[1, i])))
            for i in range(n)]
        spaces_l.append(sp)
        slots.append(np.array([e.aoi_slot for e in ents], np.int64))
        pos.append(p)
    return rt, crc, spaces_l, slots, pos, rng


def walk(spaces_l, slots, pos, rng, frac=1.0):
    """One step of the seeded walk; ``frac < 1`` moves a random subset
    (sparse movement: the delta-packet staging path)."""
    for sp, sl, p in zip(spaces_l, slots, pos):
        sel = np.arange(p.shape[1])
        if frac < 1.0:
            sel = np.sort(rng.choice(p.shape[1], int(p.shape[1] * frac),
                                     replace=False))
        q = p[:, sel] + rng.uniform(-STEP, STEP, (2, len(sel))).astype(
            np.float32)
        p[:, sel] = np.clip(q, 0, sp.world)
        sp.move_entities(sl[sel], p[0, sel], p[1, sel])


def bucket_of(rt):
    (bucket,) = rt.aoi._buckets.values()
    return bucket


class DeviceTimer:
    """Wraps ``module.name`` so that, while ``on``, each call is bracketed
    by CUDA events (and the host clock: what the call blocks the host
    for, allocations included); ``ms()`` sums the device time of the
    timed calls, ``each()`` lists it."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.inner = getattr(module, name)
        self.on = False
        self.events, self.host_ms = [], []
        setattr(module, name, self)

    def __call__(self, *a, **kw):
        if not self.on:
            return self.inner(*a, **kw)
        return self.timed(self.inner, *a, **kw)

    def timed(self, fn, *a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        out = fn(*a, **kw)
        e1.record()
        self.host_ms.append((time.perf_counter() - t0) * 1e3)
        self.events.append((e0, e1))
        return out

    def restore(self):
        setattr(self.module, self.name, self.inner)

    def each(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]

    def ms(self):
        return sum(self.each())


class HostTimer:
    """Wraps ``owner.name`` (a module's function or a class's method) so
    that, while ``on``, each call adds its host seconds to ``s``."""

    def __init__(self, owner, name):
        self.owner, self.name = owner, name
        self.inner = inner = getattr(owner, name)
        self.on, self.s = False, 0.0

        def timed(*a, **kw):
            if not self.on:
                return inner(*a, **kw)
            t0 = time.perf_counter()
            try:
                return inner(*a, **kw)
            finally:
                self.s += time.perf_counter() - t0

        setattr(owner, name, timed)

    def restore(self):
        setattr(self.owner, self.name, self.inner)


class LaunchTimer(DeviceTimer):
    """Wraps a wrapper module's getter of its C entry (``_lib``): while
    ``on``, each call of the C function it hands out -- the kernel's
    launch alone, without the wrapper's checks and allocations -- is
    bracketed by CUDA events."""

    def __call__(self, *a, **kw):
        fn = self.inner(*a, **kw)
        if not self.on:
            return fn
        return lambda *args: self.timed(fn, *args)


def phase_main(Runtime, AK, AD, EV):
    t0 = time.perf_counter()
    rt, crc, spaces_l, slots, pos, rng = build_world(
        Runtime, "cuda", SPACES, PER_SPACE, CAPACITY, seed=7)
    log(f"main: world built in {time.perf_counter() - t0:.1f} s")
    bucket = bucket_of(rt)
    check(bucket.capacity == CAPACITY, f"bucket capacity {bucket.capacity}")

    # device time of the step and of the triple compaction on the main
    # path: CUDA events around each call the bucket makes (the wrappers
    # launch nothing of their own)
    timers = [DeviceTimer(AK, "aoi_step_chg"), DeviceTimer(EV, "extract_triples")]
    tick_crcs = []  # per tick: (CRC of its delivered arrays, their count)

    def tick():
        crc["t"] = crc["te"] = 0
        rt.tick()
        tick_crcs.append((f"{crc['t']:08x}", crc["te"]))

    try:
        AK.reset_launches()
        ticks = 0
        t0 = time.perf_counter()
        tick()  # prime: the mass enter
        ticks += 1
        torch.cuda.synchronize()
        prime_s = time.perf_counter() - t0
        prime_events = crc["events"]
        check(bucket.stats["decode_overflow"] == 1,
              f"prime tick: decode_overflow {bucket.stats['decode_overflow']}"
              " (want the counted full-grid recovery)")
        for _ in range(WARMUP):
            walk(spaces_l, slots, pos, rng)
            tick()
            ticks += 1
        overflow0 = bucket.stats["decode_overflow"]
        perf0 = dict(bucket.perf)
        ev0 = crc["events"]
        for t in timers:
            t.on = True
        torch.cuda.synchronize()
        tick_s = drive_s = 0.0
        for _ in range(MEASURED):
            td = time.perf_counter()
            walk(spaces_l, slots, pos, rng)
            tt = time.perf_counter()
            tick()
            ticks += 1
            torch.cuda.synchronize()
            drive_s += tt - td
            tick_s += time.perf_counter() - tt
        for t in timers:
            t.on = False
        launches = AK.launches["aoi_step"]
    finally:
        for t in timers:
            t.restore()
    check(launches == ticks,
          f"kernel launches {launches} != dispatched ticks {ticks}")
    check(bucket.stats["decode_overflow"] == overflow0,
          "a steady tick overflowed the on-device triples")
    steady_events = (crc["events"] - ev0) / MEASURED
    check(0 < steady_events <= bucket._max_triples,
          f"steady events/tick {steady_events}")
    kernel_ms, extract_ms = (t.ms() / MEASURED for t in timers)
    perf = {k[:-2] + "_ms": (bucket.perf[k] - perf0[k]) * 1e3 / MEASURED
            for k in bucket.perf}
    # the final state against the plain version over the staged inputs
    # (the host shadows: the durable truth the device copy must match)
    dev = torch.device("cuda")
    x, z, r = (torch.from_numpy(a).to(dev)
               for a in (bucket._hx, bucket._hz, bucket._hr))
    act = torch.from_numpy(bucket._hact).to(dev)
    zero = torch.zeros_like(bucket.prev)
    want, _ = AD.aoi_step_chg_dense(x, z, r, act, zero)
    for sp in spaces_l:
        h = sp._aoi_handle
        got = bucket.get_prev(h.slot)
        check(np.array_equal(got, want[h.slot].cpu().numpy().view(np.uint32)),
              f"slot {h.slot}: interest words != plain version")
    healthy(bucket.stats, "main")
    out = {"spaces": SPACES, "entities_per_space": PER_SPACE,
           "capacity": CAPACITY, "ticks": ticks, "measured": MEASURED,
           "prime_s": prime_s, "prime_events": prime_events,
           "tick_ms": tick_s * 1e3 / MEASURED,
           "drive_ms": drive_s * 1e3 / MEASURED,
           "kernel_ms": kernel_ms, "extract_ms": extract_ms,
           "perf_ms": perf, "events_per_tick": steady_events,
           "max_triples": bucket._max_triples,
           "decode_overflow": bucket.stats["decode_overflow"],
           "delta_flushes": bucket.stats["delta_flushes"],
           "full_flushes": bucket.stats["full_flushes"],
           "emit": bucket._emit, "crc": f"{crc['v']:08x}",
           "kernel_launches": launches}
    log("main", json.dumps(out))
    return out, tick_crcs


def phase_parity(Runtime):
    crcs = {}
    for device in ("cuda", "cpu"):
        rt, crc, spaces_l, slots, pos, rng = build_world(
            Runtime, device, 2, 2000, 2048, seed=11)
        rt.tick()
        for t in range(8):
            walk(spaces_l, slots, pos, rng, frac=1.0 if t % 2 else 0.1)
            rt.tick()
        stats = bucket_of(rt).stats
        check(stats["delta_flushes"] > 0 and stats["full_flushes"] > 0,
              f"parity walk staged {stats}")
        healthy(stats, f"parity on {device}")
        crcs[device] = (crc["v"], crc["events"])
    check(crcs["cuda"] == crcs["cpu"],
          f"card vs CPU event CRC differ: {crcs}")
    log("parity", json.dumps({d: f"{v[0]:08x} ({v[1]} events)"
                              for d, v in crcs.items()}))
    return crcs


# -- phases 13/14: the deferred and the fused tick at phase 4's world ---------

RT_MODES = {"sequential": {}, "pipeline": {"aoi_pipeline": True},
            "cross_tick": {"aoi_cross_tick": True},
            "both": {"aoi_pipeline": True, "aoi_cross_tick": True},
            "unfused": {}, "fused": {"aoi_fused": True},
            "fused+cross_tick": {"aoi_fused": True, "aoi_cross_tick": True}}
# phase 17: each of them with paged storage
RT_MODES.update({f"paged {k}": dict(v, aoi_paged=True)
                 for k, v in list(RT_MODES.items())})
# phase 13: phase 4's schedule (a prime tick, 3 warm-up, 20 measured, the
# full walk); the modes in turns, each twice
PIPE_TURNS = ["sequential", "pipeline", "cross_tick", "both", "both",
              "cross_tick", "pipeline", "sequential"]
PIPE_SCHEDULE = [None] + [1.0] * (WARMUP + MEASURED)
# phase 14: a prime tick, then bench.py's movers_frac=0.1 walk with one
# r-change tick and one tick where every entity moves (both restage in
# full: the unfused flow), then warm-up ticks until the triple cap has
# settled; measured from FUSED_MEASURE_FROM on
FUSED_TURNS = ["unfused", "fused", "fused+cross_tick", "fused+cross_tick",
               "fused", "unfused"]
FUSED_SCHEDULE = [None, 0.1, 0.1, 0.1, "radius", 1.0] + [0.1] * 40
FUSED_FALLBACK = [0, 4, 5]  # the ticks that restage in full
FUSED_MEASURE_FROM = 30


def run_schedule(Runtime, AK, DC, mode, schedule, measure_from,
                 timers=()):
    """Phase 4's world (same seed, same walk) on ``Runtime(**RT_MODES[
    mode])`` through ``schedule`` (per tick: None for the prime tick, a
    walk fraction, or "radius": one entity's r changes and 10% move).
    Per tick: the CRC and count of the arrays it delivered and its
    dispatches; the deferred trailing tick out of ``AOIEngine.drain``.
    Times over the ticks from ``measure_from`` on: ``tick_ms`` (the host
    in ``Runtime.tick``, no sync), ``loop_ms`` (walk + tick, one sync at
    the end: a deferred tick's device work overlaps the next walk), the
    bucket's perf split.  ``timers`` (DeviceTimer) are switched on for
    the measured ticks.  A row's fifth entry is the bucket's page
    occupancy after the tick."""
    import gc

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_stats()
    rt, crc, spaces_l, slots, pos, rng = build_world(
        Runtime, DEV, SPACES, PER_SPACE, CAPACITY, seed=7, **RT_MODES[mode])
    bucket = bucket_of(rt)
    AK.reset_launches()
    DC.clear_keys()
    rows, tick_s, mem1 = [], 0.0, None
    for t, what in enumerate(schedule):
        if t == measure_from:
            torch.cuda.synchronize()
            perf0, stats0 = dict(bucket.perf), dict(bucket.stats)
            mem1 = torch.cuda.memory_stats()
            DC.reset_keys()
            for tm in timers:
                tm.on = True
            t_loop = time.perf_counter()
        if what == "radius":
            spaces_l[0]._cols.r[slots[0][1]] += 7.0
            walk(spaces_l, slots, pos, rng, frac=0.1)
        elif what is not None:
            walk(spaces_l, slots, pos, rng, frac=what)
        crc["t"] = crc["te"] = 0
        DC.reset()
        t0 = time.perf_counter()
        rt.tick()
        if t >= measure_from:
            tick_s += time.perf_counter() - t0
        rows.append((f"{crc['t']:08x}", crc["te"], DC.read(),
                     bucket._max_triples, bucket.stats["page_occupancy"]))
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t_loop
    for tm in timers:
        tm.on = False
    n = len(schedule) - measure_from
    crc["t"] = crc["te"] = 0
    rt.aoi.drain()
    for sp in spaces_l:
        sp.dispatch_aoi_events()
    trailing = (f"{crc['t']:08x}", crc["te"])
    st = dict(bucket.stats)
    fz = bucket._fz
    out = {"mode": mode, "ticks": len(schedule), "measured": n,
           "n_pages": bucket._n_pages,
           "tick_ms": tick_s * 1e3 / n, "loop_ms": loop_s * 1e3 / n,
           "perf_ms": {k[:-2] + "_ms": (bucket.perf[k] - perf0[k]) * 1e3 / n
                       for k in bucket.perf},
           "stats": st, "measured_stats": {k: st[k] - stats0[k]
                                           for k in ("prefetch_hits",
                                                     "prefetch_misses",
                                                     "fused_dispatches")},
           "launches": AK.launches["aoi_step"],
           "new_keys_measured": DC.new_keys(),
           "graphs": 0 if fz is None else len(fz.graphs),
           "captures": 0 if fz is None else fz.captures,
           "graph_pool_bytes": 0 if fz is None else fz.pool_bytes(),
           # torch.cuda.memory_stats before the world and after warm-up
           "reserved_bytes": [mem0["reserved_bytes.all.current"],
                              mem1["reserved_bytes.all.current"]],
           "allocated_bytes": [mem0["allocated_bytes.all.current"],
                               mem1["allocated_bytes.all.current"]]}
    healthy(st, mode)
    del rt, bucket, fz, spaces_l
    gc.collect()
    torch.cuda.empty_cache()
    return out, rows, trailing


def shifted(label, rows, trailing, ref):
    """A deferred run's per-tick CRCs: tick 0 empty, tick t+1 the
    reference's tick t, the drained trailing tick its last."""
    check(rows[0][1] == 0, f"{label}: tick 0 delivered {rows[0][1]} events")
    got = [r[:2] for r in rows[1:]] + [trailing]
    check(got == [r[:2] for r in ref],
          f"{label}: CRCs are not the reference's shifted by one tick")


def mean_of(runs, mode, key):
    vals = [r[key] for r in runs if r["mode"] == mode]
    return sum(vals) / len(vals)


def phase_pipeline(Runtime, AK, DC, main_crcs, main_out):
    """Phase 13: the pipelined and cross-tick Runtime (and both flags) at
    phase 4's world and walk, the modes in turns with the sequential
    one: every per-tick CRC equal to phase 4's, a deferred run's shifted
    by one tick; times beside phase 4's; the prefetch's hit rate."""
    runs = []
    for mode in PIPE_TURNS:
        out, rows, trailing = run_schedule(Runtime, AK, DC, mode,
                                           PIPE_SCHEDULE, 1 + WARMUP)
        check(out["launches"] == len(PIPE_SCHEDULE),
              f"{mode}: aoi_step launches {out['launches']}")
        if mode == "sequential":
            check([r[:2] for r in rows] == [tuple(c) for c in main_crcs],
                  "sequential run: CRCs differ from phase 4's")
            check(trailing[1] == 0, "sequential run left a tick in flight")
        else:
            shifted(mode, rows, trailing, main_crcs)
            h, m = (out["stats"][k] for k in ("prefetch_hits",
                                              "prefetch_misses"))
            out["prefetch_hit_rate"] = h / max(h + m, 1)
        runs.append(out)
        log("pipeline", json.dumps(out))
    summary = {m: {k: mean_of(runs, m, k) for k in ("tick_ms", "loop_ms")}
               for m in dict.fromkeys(PIPE_TURNS)}
    for m in summary:
        summary[m]["perf_ms"] = {
            k: mean_of([dict(r["perf_ms"], mode=r["mode"]) for r in runs],
                       m, k) for k in runs[0]["perf_ms"]}
    summary["phase_4"] = {"tick_ms": main_out["tick_ms"],
                          "loop_ms": main_out["tick_ms"]
                          + main_out["drive_ms"],
                          "perf_ms": main_out["perf_ms"]}
    return {"runs": runs, "summary": summary,
            "launches": sum(r["launches"] for r in runs
                            if r["mode"] != "sequential")}


def phase_fused(Runtime, AK, DC):
    """Phase 14: the fused tick at phase 4's world under a sparse walk
    (10% movers a tick), with one r-change tick and one mass move, which
    fall back to the unfused flow.  Fused, unfused and fused + cross-tick
    in turns: fused CRCs equal the unfused ones per tick, fused +
    cross-tick's shifted by one; a measured tick counts 1 dispatch fused
    and 2 unfused; ``fused_dispatches`` equals the eligible ticks; no new
    capture key after warm-up; every aoi_step launch is a replay, an
    unfused tick's or a capture's warm-up."""
    eligible = len(FUSED_SCHEDULE) - len(FUSED_FALLBACK)
    runs, ref = [], None
    for mode in FUSED_TURNS:
        out, rows, trailing = run_schedule(Runtime, AK, DC, mode,
                                           FUSED_SCHEDULE, FUSED_MEASURE_FROM)
        st = out["stats"]
        measured = [r[2] for r in rows[FUSED_MEASURE_FROM:]]
        if mode == "unfused":
            check(st["delta_flushes"] == eligible
                  and st["full_flushes"] == len(FUSED_FALLBACK),
                  f"unfused: {st['delta_flushes']} delta ticks, want "
                  f"{eligible}")
            check(measured == [2] * len(measured),
                  f"unfused: dispatches per tick {measured}")
            check(out["launches"] == len(FUSED_SCHEDULE),
                  f"unfused: launches {out['launches']}")
            if ref is None:
                ref = rows
            check([r[:2] for r in rows] == [r[:2] for r in ref],
                  "unfused runs differ")
        else:
            check(st["fused_dispatches"] == eligible
                  and st["fused_demotions"] == 0,
                  f"{mode}: fused_dispatches {st['fused_dispatches']}, "
                  f"want {eligible}")
            check(measured == [1] * len(measured),
                  f"{mode}: dispatches per tick {measured}")
            check(out["new_keys_measured"] == 0,
                  f"{mode}: {out['new_keys_measured']} new capture keys "
                  f"after warm-up")
            check(out["launches"] == len(FUSED_FALLBACK) + eligible
                  + out["captures"],
                  f"{mode}: aoi_step launches {out['launches']} != "
                  f"unfused ticks + replays + captures")
            if mode == "fused":
                check([r[:2] for r in rows] == [r[:2] for r in ref],
                      "fused CRCs differ from the unfused ones")
            else:
                shifted(mode, rows, trailing, [r[:2] for r in ref])
        out["caps"] = sorted({r[3] for r in rows})
        runs.append(out)
        log("fused", json.dumps(out))
    summary = {m: {k: mean_of(runs, m, k) for k in ("tick_ms", "loop_ms")}
               for m in dict.fromkeys(FUSED_TURNS)}
    for m in summary:
        summary[m]["stage_ms"] = mean_of(
            [dict(mode=r["mode"], v=r["perf_ms"]["stage_ms"]) for r in runs],
            m, "v")
    return {"runs": runs, "summary": summary, "eligible": eligible,
            "replays": sum(r["stats"]["fused_dispatches"] for r in runs),
            "launches": sum(r["launches"] for r in runs
                            if r["mode"] != "unfused"),
            "ref_rows": [r[:2] for r in ref]}


# phase 14b: a subscription change amid a sparse walk (space 0 opts out,
# later back in): the tick restages x/z/sub in full, as the JAX bucket
# does, where a steady tick ships a delta packet
SUB_SCHEDULE = [None] + [0.1] * 6 + ["sub"] + [0.1] * 3 + ["sub"] + [0.1] * 3


def phase_sub_change(Runtime):
    """Phase 14b: phase 4's world, sequential and unfused, through
    SUB_SCHEDULE; per tick the ms (a sync before and after), the bucket's
    stage ms and H2D bytes and how its inputs were staged.  The steady
    ticks ship a delta packet, the subscription changes restage in full;
    the steady ticks' means and each change's numbers."""
    import gc

    rt, crc, spaces_l, slots, pos, rng = build_world(
        Runtime, DEV, SPACES, PER_SPACE, CAPACITY, seed=7)
    bucket = bucket_of(rt)
    h = spaces_l[0]._aoi_handle
    sub, rows = True, []
    for what in SUB_SCHEDULE:
        if what == "sub":
            sub = not sub
            rt.aoi.set_subscribed(h, sub)
        if what is not None:
            walk(spaces_l, slots, pos, rng, frac=0.1)
        st0, stage0 = dict(bucket.stats), bucket.perf["stage_s"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt.tick()
        torch.cuda.synchronize()
        rows.append({"what": what,
                     "ms": (time.perf_counter() - t0) * 1e3,
                     "stage_ms": (bucket.perf["stage_s"] - stage0) * 1e3,
                     "h2d_bytes": bucket.stats["h2d_bytes"]
                     - st0["h2d_bytes"],
                     "full": bucket.stats["full_flushes"]
                     - st0["full_flushes"]})
    healthy(bucket.stats, "phase 14b")
    steady = [r for r in rows[3:] if r["what"] == 0.1]
    subs = [r for r in rows if r["what"] == "sub"]
    check(all(r["full"] == 0 for r in steady)
          and all(r["full"] == 1 for r in subs),
          f"phase 14b: staging per tick {[r['full'] for r in rows]}")

    out = {"rows": rows,
           **{f"steady_{k}": sum(r[k] for r in steady) / len(steady)
              for k in ("ms", "stage_ms", "h2d_bytes")},
           # each change apart: the first opt-out is the process's first
           # masked tick
           **{f"sub_{k}": [r[k] for r in subs]
              for k in ("ms", "stage_ms", "h2d_bytes")}}
    log("sub change", json.dumps(out))
    del rt, bucket, spaces_l
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phases 15/16: the fault chains and the host calculators -------------

# phase 15: phase 4's widths with 2 of its 8 spaces (each host-recovered
# tick is the numpy predicate, about 4 s a space); the plan of
# scripts/faults_smoke.py, then (added while the run goes, at the seam's
# next crossing) a second kernel failure and an emit failure
FAULT_SPACES = 2
FAULT_PLAN = ("seed=7;aoi.h2d:oom@3;aoi.kernel:fail@5;aoi.scalars:poison@7;"
              "aoi.fetch:stall@2:0.001")
FAULT_TICKS = 9       # a prime tick and 8 walk ticks under FAULT_PLAN
FAULT_AFTER = 3       # ticks after reset_calc_chain()
# phase 15b: the same schedule on the mesh and row-sharded buckets
# (their levels, launches and fired faults differ from the single-device
# bucket's: the seams are crossed as often as in the JAX package's
# buckets of the same kind, held to them by tests/test_torch_faults.py).
# The h2d OOM strikes while their step is enqueued and demotes them at
# the prime tick, so the kernel failure at tick 5 sends them to the host
# oracle: 6 ticks before the added faults keep the host ticks few
SHARDED_FAULT_TICKS = 6
SHARDED_STATS = {"rebuilds": 3, "fallbacks": 3, "host_ticks": 6,
                 "poisoned": 1, "calc_level": 0, "fused_demotions": 0,
                 "emit_path": 2}
# per tick: the level it dispatched at, and whether the kernel launched
# (the faults at the prime tick and after the first reset strike before
# the launch)
SHARDED_LEVELS = [0, 1, 1, 1, 1, 2, 2, 2, 0, 1, 1, 0, 0, 0]
SHARDED_LAUNCHED = [False] * 11 + [True] * 3
SHARDED_FIRED = [("aoi.fetch", "stall", 2), ("aoi.h2d", "oom", 3),
                 ("aoi.kernel", "fail", 5), ("aoi.kernel", "fail", 6),
                 ("aoi.scalars", "poison", 7)]
# kind -> its spaces, and per mode the aoi.emit crossing the added emit
# fault lands on (the row-sharded bucket stays synchronous)
SHARDED_FAULTS = {
    "mesh": {"spaces": FAULT_SPACES,
             "emit_at": {"sequential": 8, "cross_tick": 7}},
    "rowshard": {"spaces": 1, "emit_at": {"sequential": 8}},
}
# phase 16: bench.py's unity1k (1 space x 1024, 1000 active, world 2000,
# r 100: `bench.py:203`) beside phase 4's eight spaces; the numpy oracle
# reference costs about 6 s a space a tick, so a prime tick and one walk
UNITY = (1024, 1000, 2000.0)
ROUTE_TICKS = 2
ROUTE_TURNS = ["cpp", "cuda", "cuda", "cpp"]
ROUTE_WARMUP, ROUTE_MEASURED = 2, 5


def fault_run(Runtime, AK, device, mode, plan, spaces=FAULT_SPACES,
              ticks=FAULT_TICKS, resets=1, **rt_kw):
    """Phase 15's schedule on ``Runtime(device=device, fault_plan=plan,
    **RT_MODES[mode], **rt_kw)`` at ``spaces`` spaces of phase 4's world
    (one bucket): ``ticks`` ticks
    (the h2d OOM recovered at the prime tick, the kernel failure at tick
    5 demoting to the plain step, the poisoned count, the stalled fetch),
    a second kernel failure (to the host oracle), an emit failure (to the
    host emit mode), then ``resets`` times ``reset_calc_chain()`` and
    FAULT_AFTER ticks.  Per tick: CRC, events, the calc level it dispatched at,
    kernel launches, ms (a sync before and after).  Returns (rows, the
    drained trailing tick, stats, fired)."""
    import gc

    from goworld_tpu_torch import faults

    rt, crc, spaces_l, slots, pos, rng = build_world(
        Runtime, device, spaces, PER_SPACE, CAPACITY, seed=7,
        fault_plan=plan, **RT_MODES[mode], **rt_kw)
    bucket = bucket_of(rt)
    fp = faults.plan()
    rows = []
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def tick(label):
        if rows:
            walk(spaces_l, slots, pos, rng)
        crc["t"] = crc["te"] = 0
        level, n0 = bucket._calc_level, AK.launches["aoi_step"]
        sync()
        t0 = time.perf_counter()
        rt.tick()
        sync()
        rows.append({"label": label, "crc": f"{crc['t']:08x}",
                     "events": crc["te"], "level": level,
                     "launches": AK.launches["aoi_step"] - n0,
                     "ms": (time.perf_counter() - t0) * 1e3})

    def next_crossing(seam, kind):
        if fp is not None:
            fp.add(seam, kind, fp.counts.get(seam, 0) + 1)

    try:
        check(bucket._emit == "native", f"phase 15 needs the native fan-out "
              f"(resolved {bucket._emit!r}) for its aoi.emit fault")
        for t in range(ticks):
            tick("prime" if t == 0 else f"walk {t}")
        next_crossing("aoi.kernel", "fail")
        tick("kernel fail 2")
        next_crossing("aoi.emit", "fail")
        tick("level 2 + emit fail")
        for i in range(resets):
            bucket.reset_calc_chain()
            for t in range(FAULT_AFTER):
                tick(f"after reset {i} {t}")
        crc["t"] = crc["te"] = 0
        rt.aoi.drain()
        for sp in spaces_l:
            sp.dispatch_aoi_events()
        trailing = (f"{crc['t']:08x}", crc["te"])
        stats = dict(bucket.stats)
        fired = [] if fp is None else [dict(f) for f in fp.fired]
    finally:
        faults.clear()
    del rt, bucket, spaces_l
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return rows, trailing, stats, fired


def fired_set(fired):
    return sorted((f["seam"], f["kind"], f["occurrence"]) for f in fired)


def phase_sharded_faults(Runtime, AK, SpaceMesh):
    """Phase 15b: phase 15's schedule, cut to SHARDED_FAULT_TICKS ticks
    before the added faults and with a second reset_calc_chain() and
    FAULT_AFTER ticks, on the sharded buckets of the card, each against
    its own fault-free run: the mesh bucket (FAULT_SPACES
    spaces on phase 11's 4 virtual shards; sequential and cross_tick) and
    the row-sharded bucket (one space of CAPACITY over 4 virtual shards;
    synchronous).  Per-tick CRCs equal to the fault-free run's (shifted by
    one tick under cross_tick), the fault counters, the levels and the
    fired faults as planned, the kernel launched at the level-0 ticks
    only."""
    dev = torch.device(DEV)
    out = {}
    for kind, want in SHARDED_FAULTS.items():
        kw = {"aoi_mesh": SpaceMesh([dev] * 4)}
        if kind == "rowshard":
            kw["aoi_rowshard_min_capacity"] = CAPACITY
        free, _tr, free_st, _ = fault_run(
            Runtime, AK, DEV, "sequential", None, want["spaces"],
            SHARDED_FAULT_TICKS, 2, **kw)
        healthy(free_st, f"phase 15b {kind} fault-free")
        ref = [(r["crc"], r["events"]) for r in free]
        res = {}
        for mode, emit_at in want["emit_at"].items():
            rows, trailing, st, fired = fault_run(
                Runtime, AK, DEV, mode, FAULT_PLAN, want["spaces"],
                SHARDED_FAULT_TICKS, 2, **kw)
            label = f"phase 15b {kind} {mode}"
            got_st = {k: st[k] for k in SHARDED_STATS}
            check(got_st == SHARDED_STATS, f"{label}: stats {got_st}")
            levels = [r["level"] for r in rows]
            check(levels == SHARDED_LEVELS, f"{label}: levels {levels}")
            got_l = [r["launches"] for r in rows]
            check([n > 0 for n in got_l] == SHARDED_LAUNCHED,
                  f"{label}: kernel launches per tick {got_l}")
            check(fired_set(fired) == sorted(
                SHARDED_FIRED + [("aoi.emit", "fail", emit_at)]),
                f"{label}: fired {fired_set(fired)}")
            got = [(r["crc"], r["events"]) for r in rows]
            if mode == "cross_tick":
                shifted(label, got, trailing, ref)
            else:
                check(got == ref and trailing[1] == 0,
                      f"{label}: CRCs differ from the fault-free run")
            res[mode] = {"stats": st, "launches": sum(got_l),
                         "ticks": [[r["label"], r["level"], r["launches"],
                                    r["ms"]] for r in rows],
                         "fault_free_ms": [r["ms"] for r in free]}
        out[kind] = res
    log("sharded faults", json.dumps(out))
    return out


def phase_faults(Runtime, AK):
    """Phase 15: phase 4's widths at 2 spaces through FAULT_PLAN and the
    added faults, sequential and under cross_tick, on the card; the same
    plan sequential on the port's CPU path; the fault-free card run of the
    same world.  Per-tick CRCs: the sequential runs (card, CPU) equal the
    fault-free run's, the cross_tick run's them shifted by one tick.  The
    stats and the fired faults as planned (card = CPU); the kernel
    launched at every tick dispatched at level 0, at none at level 1 or 2
    or where the fault struck before the launch."""
    free, free_tr, free_st, _ = fault_run(Runtime, AK, DEV, "sequential",
                                          None)
    healthy(free_st, "phase 15 fault-free")
    ref = [(r["crc"], r["events"]) for r in free]
    AK.reset_launches()
    seq = fault_run(Runtime, AK, DEV, "sequential", FAULT_PLAN)
    cross = fault_run(Runtime, AK, DEV, "cross_tick", FAULT_PLAN)
    launches = AK.launches["aoi_step"]
    cpu = fault_run(Runtime, AK, "cpu", "sequential", FAULT_PLAN)
    want_stats = {"rebuilds": 3, "fallbacks": 2, "host_ticks": 4,
                  "poisoned": 1, "calc_level": 0, "fused_demotions": 0,
                  "emit_path": 2}
    # the fault ticks: h2d OOM at the prime tick, kernel failures at
    # ticks 5 and 9 (all before the launch); tick 10 on the host oracle
    want_levels = [0] * 6 + [1] * 3 + [1, 2] + [0] * FAULT_AFTER
    want_launches = [0, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0] + [1] * FAULT_AFTER
    want_fired = {("aoi.h2d", "oom", 3), ("aoi.fetch", "stall", 2),
                  ("aoi.kernel", "fail", 5), ("aoi.scalars", "poison", 7),
                  ("aoi.kernel", "fail", 9)}
    for label, (rows, trailing, st, fired) in (("sequential", seq),
                                              ("cross_tick", cross),
                                              ("cpu sequential", cpu)):
        got_st = {k: st[k] for k in want_stats}
        check(got_st == want_stats, f"phase 15 {label}: stats {got_st}")
        check([r["level"] for r in rows] == want_levels,
              f"phase 15 {label}: levels {[r['level'] for r in rows]}")
        got_fired = {(f["seam"], f["kind"], f["occurrence"]) for f in fired}
        emit = [f for f in fired if f["seam"] == "aoi.emit"]
        check(got_fired - {(f["seam"], f["kind"], f["occurrence"])
                           for f in emit} == want_fired and len(emit) == 1,
              f"phase 15 {label}: fired {fired}")
        if label == "cross_tick":
            shifted(f"phase 15 {label}", [(r["crc"], r["events"])
                                          for r in rows], trailing, ref)
        else:
            check([(r["crc"], r["events"]) for r in rows] == ref
                  and trailing[1] == 0,
                  f"phase 15 {label}: CRCs differ from the fault-free run")
        if label != "cpu sequential":
            got_l = [r["launches"] for r in rows]
            check(got_l == want_launches,
                  f"phase 15 {label}: kernel launches per tick {got_l}")
    check(seq[3] == cpu[3], f"phase 15: card fired {seq[3]} != CPU fired "
          f"{cpu[3]}")
    check(launches == 2 * sum(want_launches),
          f"phase 15: {launches} kernel launches")

    def ms_of(rows):
        return {"recovered (kernel fail, tick 5)": rows[5]["ms"],
                "level 1 (tick 6)": rows[6]["ms"],
                "level 2 (tick 10)": rows[10]["ms"],
                "back at level 0 (first after reset)": rows[11]["ms"],
                "level 0 (tick 4)": rows[4]["ms"]}

    out = {"spaces": FAULT_SPACES, "plan": FAULT_PLAN,
           "stats": seq[2], "fired": seq[3],
           "ms": {"sequential": ms_of(seq[0]), "cross_tick": ms_of(cross[0]),
                  "cpu sequential": ms_of(cpu[0]),
                  "fault-free (tick 4, tick 11)": [free[4]["ms"],
                                                   free[11]["ms"]]},
           "launches": launches}
    log("faults", json.dumps(out))
    return out


def route_run(Runtime, backend, extra, spaces, ticks, measured=0):
    """``Runtime(aoi_backend=backend)`` on ``spaces`` of phase 4's spaces
    and the ``extra`` space, ``ticks`` ticks of phase 4's walk (a sync
    before and after each): per-tick CRCs, the buckets' kinds and spaces,
    and over the last ``measured`` ticks the mean tick ms and each
    bucket's perf split."""
    import gc

    rt, crc, spaces_l, slots, pos, rng = build_world(
        Runtime, DEV, spaces, PER_SPACE, CAPACITY, seed=7, extra=extra,
        aoi_backend=backend)
    buckets = {f"{k[0]} {k[1]}": b for k, b in sorted(rt.aoi._buckets.items())}
    homes = [(sp._aoi_handle.backend, sp._aoi_handle.capacity)
             for sp in spaces_l]
    rows, tick_s, perf0 = [], 0.0, None
    for t in range(ticks):
        if t == ticks - measured:
            perf0 = {k: dict(b.perf) for k, b in buckets.items()}
        if t:
            walk(spaces_l, slots, pos, rng)
        crc["t"] = crc["te"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt.tick()
        torch.cuda.synchronize()
        if t >= ticks - measured:
            tick_s += time.perf_counter() - t0
        rows.append((f"{crc['t']:08x}", crc["te"]))
    out = {"backend": backend, "homes": homes, "crcs": rows,
           "buckets": list(buckets)}
    if measured:
        out["tick_ms"] = tick_s * 1e3 / measured
        out["bucket_ms"] = {
            k: {p[:-2] + "_ms": (b.perf[p] - perf0[k][p]) * 1e3 / measured
                for p in b.perf} for k, b in buckets.items()}
    for k, b in buckets.items():
        if hasattr(b, "stats"):
            healthy(b.stats, f"phase 16 {backend} {k}")
    del rt, buckets, spaces_l
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_routing(Runtime, AK):
    """Phase 16: Runtime(aoi_backend="auto") with unity1k beside phase
    4's eight spaces: unity1k routes to cpp, the eight to cuda, per-tick
    CRCs equal to Runtime(aoi_backend="cpu") on the same world; then
    phase 4's world alone, and unity1k alone, under "cpp" and "cuda" in
    turns, twice each: the tick ms and each bucket's split."""
    AK.reset_launches()
    auto = route_run(Runtime, "auto", UNITY, SPACES, ROUTE_TICKS,
                     ROUTE_TICKS - 1)
    auto_launches = AK.launches["aoi_step"]
    check(auto["homes"] == [("cuda", CAPACITY)] * SPACES + [("cpp", UNITY[0])],
          f"phase 16: auto homes {auto['homes']}")
    check(auto_launches == ROUTE_TICKS,
          f"phase 16: auto run launched the kernel {auto_launches} times")
    ref = route_run(Runtime, "cpu", UNITY, SPACES, ROUTE_TICKS)
    check(ref["homes"] == [("cpu", CAPACITY)] * SPACES + [("cpu", UNITY[0])],
          f"phase 16: cpu homes {ref['homes']}")
    check(auto["crcs"] == ref["crcs"],
          f"phase 16: auto CRCs {auto['crcs']} != cpu {ref['crcs']}")
    turns = {}
    AK.reset_launches()
    ticks = 1 + ROUTE_WARMUP + ROUTE_MEASURED
    for world, spaces, extra in (("phase 4", SPACES, None),
                                 ("unity1k", 0, UNITY)):
        runs = [route_run(Runtime, b, extra, spaces, ticks, ROUTE_MEASURED)
                for b in ROUTE_TURNS]
        check(all(r["crcs"] == runs[0]["crcs"] for r in runs),
              f"phase 16 {world}: cpp and cuda CRCs differ")
        turns[world] = [{k: r[k] for k in ("backend", "tick_ms",
                                           "bucket_ms")} for r in runs]
    turn_launches = AK.launches["aoi_step"]
    check(turn_launches == 2 * 2 * ticks,
          f"phase 16: the cuda turns launched {turn_launches} times")
    out = {"auto": {k: auto[k] for k in ("homes", "crcs", "buckets",
                                         "tick_ms", "bucket_ms")},
           "cpu_reference_crcs": ref["crcs"], "turns": turns,
           "launches": auto_launches + turn_launches}
    log("routing", json.dumps(out))
    return out


# -- phase 6: the giant path's kernels vs plain --------------------------------

# -- phase 17: paged storage ---------------------------------------------------

# phase 17: phase 4's world and walk under Runtime(aoi_paged=True):
# sequential (timed like phase 4), pipeline and cross_tick (phase 13's
# schedule), then phase 14's 10% walk unfused, fused and fused+cross_tick
PAGED_PIPE_TURNS = ["paged sequential", "paged pipeline",
                    "paged cross_tick"]
PAGED_FUSED_TURNS = ["paged unfused", "paged fused",
                     "paged fused+cross_tick"]
# phase 17b: bench.py's clustered crowd (`bench_engine_clustered`,
# bench.py:1663-1740): one space of 2048 slots, 1,800 entities spread
# over world 4000 teleport into one r=100 cluster at tick 2 of 8 and
# disperse at tick 7; seed 23
CLUSTER = dict(cap=2048, n=1800, ticks=8, world=4000.0, seed=23)
CLUSTER_FLOOR = 4  # the tiny pool of the re-arm run
# phase 17c: the sharded absorbers, a prime tick and 2 walk ticks
PAGED_SHARDED_TICKS = 3
# phase 17d: the aoi.pages seam at phase 15's 2 spaces, a prime tick and
# 8 walk ticks (the seam is crossed once a tick)
PAGES_PLAN = "aoi.pages:oom@3;aoi.pages:partial@5;aoi.pages:poison@7"
PAGES_TICKS = 9
PAGES_STATS = {"page_spills": 2, "poisoned": 1, "rebuilds": 1,
               "host_ticks": 1, "calc_level": 0, "fallbacks": 0,
               "decode_overflow": 0}
PAGES_FIRED = [("aoi.pages", "oom", 3), ("aoi.pages", "partial", 5),
               ("aoi.pages", "poison", 7)]


def paged_fetch_bytes(n_used, n_pages, spill_width, fused):
    """Bytes one paged harvest copies to the host: the used prefix of the
    three pools (rounded up to 16 pages, as the harvest fetches it), the
    page table, the spilled bins and the four scalars (fused: one
    bundle of the last three)."""
    pages = min(n_pages, -(-n_used // 16) * 16)
    return 3 * pages * 64 * 4 + (4 + n_pages + spill_width) * 4


def phase_paged(Runtime, AK, DC, PG, main_out, main_crcs, fused):
    """Phase 17: paged storage on phase 4's main path.  The sequential
    paged Runtime through phase 4's schedule (its per-tick CRCs equal
    phase 4's), with CUDA events around the allocator beside phase 4's
    ``extract_triples``; pipeline and cross_tick (phase 4's CRCs shifted
    by one tick); phase 14's 10% walk unfused, fused (equal to unfused,
    1 dispatch a steady tick) and fused + cross-tick (shifted).  Every
    run: no decode_overflow, no page spill, calc level 0."""
    pipe_runs, fused_runs = [], []
    launches = 0
    for mode in PAGED_PIPE_TURNS:
        timers = ([DeviceTimer(PG, "allocate_pages")]
                  if mode == "paged sequential" else [])
        try:
            out, rows, trailing = run_schedule(
                Runtime, AK, DC, mode, PIPE_SCHEDULE, 1 + WARMUP, timers)
        finally:
            for tm in timers:
                tm.restore()
        launches += out["launches"]
        check(out["launches"] == len(PIPE_SCHEDULE),
              f"{mode}: aoi_step launches {out['launches']}")
        if timers:
            n = out["measured"]
            alloc = timers[0].each()
            check(len(alloc) == n, f"{mode}: {len(alloc)} allocator calls "
                  f"in {n} measured ticks")
            out["allocator_ms"] = sum(alloc) / n
            out["extract_triples_ms_phase4"] = main_out["extract_ms"]
            out["tick_ms_phase4"] = main_out["tick_ms"]
            check([r[:2] for r in rows] == [tuple(c) for c in main_crcs],
                  "paged sequential: CRCs differ from phase 4's")
            check(trailing[1] == 0, "paged sequential left a tick in flight")
        else:
            shifted(mode, rows, trailing, main_crcs)
            h, m = (out["stats"][k] for k in ("prefetch_hits",
                                              "prefetch_misses"))
            out["prefetch_hit_rate"] = h / max(h + m, 1)
        used = [r[4] * out["n_pages"] for r in rows[1 + WARMUP:]]
        out["n_used_pages"] = sum(used) / len(used)
        out["fetch_bytes_per_tick"] = sum(paged_fetch_bytes(
            int(round(u)), out["n_pages"], PG.MAX_SPILL, False)
            for u in used) / len(used)
        out["page_occupancy"] = out["stats"]["page_occupancy"]
        st = out["stats"]
        check(st["decode_overflow"] == 0 and st["page_spills"] == 0,
              f"{mode}: decode_overflow {st['decode_overflow']}, "
              f"page_spills {st['page_spills']}")
        pipe_runs.append(out)
        log("paged", json.dumps(out))
    eligible = len(FUSED_SCHEDULE) - len(FUSED_FALLBACK)
    ref = None
    for mode in PAGED_FUSED_TURNS:
        out, rows, trailing = run_schedule(Runtime, AK, DC, mode,
                                           FUSED_SCHEDULE, FUSED_MEASURE_FROM)
        launches += out["launches"]
        st = out["stats"]
        measured = [r[2] for r in rows[FUSED_MEASURE_FROM:]]
        check(st["decode_overflow"] == 0 and st["page_spills"] == 0,
              f"{mode}: decode_overflow {st['decode_overflow']}, "
              f"page_spills {st['page_spills']}")
        if mode == "paged unfused":
            ref = rows
            check([r[:2] for r in rows] == fused["ref_rows"],
                  "paged unfused: CRCs differ from phase 14's unfused run")
            check(measured == [2] * len(measured),
                  f"paged unfused: dispatches per tick {measured}")
        else:
            check(st["fused_dispatches"] == eligible
                  and st["fused_demotions"] == 0,
                  f"{mode}: fused_dispatches {st['fused_dispatches']}, "
                  f"want {eligible}")
            check(measured == [1] * len(measured),
                  f"{mode}: dispatches per tick {measured}")
            check(out["new_keys_measured"] == 0,
                  f"{mode}: {out['new_keys_measured']} new capture keys")
            check(out["launches"] == len(FUSED_FALLBACK) + eligible
                  + out["captures"], f"{mode}: aoi_step launches "
                  f"{out['launches']}")
            if mode == "paged fused":
                check([r[:2] for r in rows] == [r[:2] for r in ref],
                      "paged fused: CRCs differ from paged unfused")
            else:
                shifted(mode, rows, trailing, [r[:2] for r in ref])
        used = [r[4] * out["n_pages"] for r in rows[FUSED_MEASURE_FROM:]]
        out["n_used_pages"] = sum(used) / len(used)
        out["fetch_bytes_per_tick"] = sum(paged_fetch_bytes(
            int(round(u)), out["n_pages"], PG.MAX_SPILL,
            mode != "paged unfused") for u in used) / len(used)
        fused_runs.append(out)
        log("paged fused", json.dumps(out))
    seq = pipe_runs[0]
    summary = {
        "tick_ms": seq["tick_ms"], "perf_ms": seq["perf_ms"],
        "allocator_ms": seq["allocator_ms"],
        "extract_triples_ms_phase4": seq["extract_triples_ms_phase4"],
        "tick_ms_phase4": seq["tick_ms_phase4"],
        "n_used_pages": seq["n_used_pages"], "n_pages": seq["n_pages"],
        "fetch_bytes_per_tick": seq["fetch_bytes_per_tick"],
        "page_occupancy": seq["page_occupancy"],
        "modes": {r["mode"]: {k: r.get(k) for k in (
            "tick_ms", "loop_ms", "perf_ms", "n_used_pages",
            "fetch_bytes_per_tick", "prefetch_hit_rate", "captures",
            "graphs", "graph_pool_bytes")} for r in pipe_runs + fused_runs}}
    return {"summary": summary, "runs": pipe_runs + fused_runs,
            "launches": launches}


def cluster_frames():
    """bench.py ``_clustered_walk``: per tick (x, z) of CLUSTER["n"]
    entities, spread -> one cluster -> dispersal."""
    c = CLUSTER
    rng = np.random.default_rng(c["seed"])
    n, world = c["n"], c["world"]
    x0 = rng.uniform(0.0, world, n).astype(np.float32)
    z0 = rng.uniform(0.0, world, n).astype(np.float32)
    tx = world / 2 + rng.uniform(-40.0, 40.0, n)
    tz = world / 2 + rng.uniform(-40.0, 40.0, n)
    frames = []
    for t in range(c["ticks"]):
        f = 1.0 if 2 <= t < c["ticks"] - 1 else 0.0
        jx = rng.uniform(-2.0, 2.0, n)
        jz = rng.uniform(-2.0, 2.0, n)
        frames.append((
            np.clip(x0 * (1 - f) + tx * f + jx, 0, world).astype(np.float32),
            np.clip(z0 * (1 - f) + tz * f + jz, 0, world).astype(np.float32)))
    return frames


def cluster_run(AOIEngine, frames, backend, device, paged, floor=None):
    """One clustered-crowd walk through AOIEngine (bench.py
    ``_clustered_run``): the CRC of the delivered streams, events, per-tick
    ms (a sync after each), the bucket's stats and pool size."""
    from goworld_tpu_torch.engine.aoi import _PageDecay

    c = CLUSTER
    eng = AOIEngine(device=device, default_backend=backend, paged=paged)
    h = eng.create_space(c["cap"])
    if floor is not None:
        h.bucket._pages = _PageDecay(floor=floor)
    r = np.full(c["n"], 100.0, np.float32)
    act = np.ones(c["n"], bool)
    crc, n_ev, ms = 0, 0, []
    for x, z in frames:
        t0 = time.perf_counter()
        eng.submit(h, x, z, r, act)
        eng.flush()
        e, lv = eng.take_events(h)
        if device == "cuda":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        e = np.ascontiguousarray(e, np.int32)
        lv = np.ascontiguousarray(lv, np.int32)
        crc = zlib.crc32(lv.tobytes(), zlib.crc32(e.tobytes(), crc))
        n_ev += len(e) + len(lv)
    st = dict(getattr(h.bucket, "stats", {}))
    return {"crc": f"{crc:08x}", "events": n_ev, "ms": ms, "stats": st,
            "n_pages": getattr(h.bucket, "_n_pages", None)}


def phase_clustered(AOIEngine, AK):
    """Phase 17b: the clustered crowd on the ``cuda`` backend capped,
    paged, and paged from a pool preset to CLUSTER_FLOOR pages, against
    the CPU oracle: all CRCs equal; capped shows decode_overflow > 0,
    paged 0 (its spills and pool growth printed); the tiny pool spills
    and re-arms."""
    frames = cluster_frames()
    n0 = AK.launches["aoi_step"]
    cpu = cluster_run(AOIEngine, frames, "cpu", "cpu", False)
    capped = cluster_run(AOIEngine, frames, "cuda", DEV, False)
    paged = cluster_run(AOIEngine, frames, "cuda", DEV, True)
    tiny = cluster_run(AOIEngine, frames, "cuda", DEV, True,
                       floor=CLUSTER_FLOOR)
    launches = AK.launches["aoi_step"] - n0
    for label, run in (("capped", capped), ("paged", paged),
                       ("tiny pool", tiny)):
        check((run["crc"], run["events"]) == (cpu["crc"], cpu["events"]),
              f"phase 17b {label}: CRC {run['crc']} != CPU oracle "
              f"{cpu['crc']}")
        healthy(run["stats"], f"phase 17b {label}")
    check(capped["stats"]["decode_overflow"] > 0,
          "phase 17b: the capped storm did not overflow")
    for label, run in (("paged", paged), ("tiny pool", tiny)):
        check(run["stats"]["decode_overflow"] == 0,
              f"phase 17b {label}: decode_overflow "
              f"{run['stats']['decode_overflow']}")
    check(tiny["stats"]["page_spills"] > 0
          and tiny["n_pages"] > CLUSTER_FLOOR,
          f"phase 17b tiny pool: spills {tiny['stats']['page_spills']}, "
          f"pool {tiny['n_pages']}")
    check(launches == 3 * CLUSTER["ticks"],
          f"phase 17b: aoi_step launches {launches}")
    out = {"config": CLUSTER, "crc": cpu["crc"], "events": cpu["events"],
           "launches": launches}
    for label, run in (("capped", capped), ("paged", paged),
                       ("tiny_pool", tiny), ("cpu", cpu)):
        out[label] = {"ms": run["ms"], "n_pages": run["n_pages"],
                      **{k: run["stats"].get(k) for k in (
                          "decode_overflow", "page_spills",
                          "page_occupancy")}}
    log("clustered", json.dumps(out))
    return out


def phase_paged_sharded(AOIEngine, AK, SpaceMesh, engine_mesh, rowshard):
    """Phase 17c: the paged absorbers of the sharded buckets: `million`
    on 4 virtual shards (phase 11b's world) and `zipf100k` row-sharded
    on 8 (phase 12's), PAGED_SHARDED_TICKS ticks each, steady (the prime
    tick's overflow absorbed) and with ``_max_chunks`` forced to 1 (every
    shard absorbed every tick).  Per-tick CRCs equal the non-paged runs'
    of phases 11b and 12, decode_overflow 0, the caps never grow; the
    host ms of each absorbed shard (the allocator, its fetches and the
    decode)."""
    from goworld_tpu_torch.engine import aoi_mesh, aoi_rowshard

    dev = torch.device(DEV)
    absorbs = []
    inner = aoi_mesh._paged_absorb_shard

    def timed_absorb(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = inner(*a, **kw)
        torch.cuda.synchronize()
        absorbs.append((time.perf_counter() - t0) * 1e3)
        return got

    ref = {
        "million": next(r for r in engine_mesh["million"]
                        if r["shards"] == 4 and not r.get("pipeline")),
        "zipf100k": next(r for r in rowshard if r["shards"] == 8)}
    cases = {"million": (SpaceMesh([dev] * 4),
                         1 + MESH_WARMUP + MESH_MEASURED, {}),
             "zipf100k": (SpaceMesh([dev] * 8), 1 + ROWSHARD_TICKS,
                          {"rowshard_min_capacity": ROWSHARD_MIN})}
    out, launches = {}, {"aoi_step": 0, "aoi_step rect": 0}
    for mod in (aoi_mesh, aoi_rowshard):
        mod._paged_absorb_shard = timed_absorb
    try:
        for name, (mesh, walk_ticks, kw) in cases.items():
            cfg = GIANT[name]
            _qx, _qz, xs, zs = make_walk(cfg, np.random.default_rng(0),
                                         walk_ticks - 1)
            s, c = cfg["s"], cfg["cap"]
            if cfg["zipf"]:
                r_t, act_t = make_state(cfg)
                r, act = r_t.cpu().numpy(), act_t.cpu().numpy()
                del r_t, act_t
            else:
                r = np.full((s, c), cfg["radius"], np.float32)
                act = np.ones((s, c), bool)
            want = [t_["crc"] for t_ in ref[name]["ticks"]][
                :PAGED_SHARDED_TICKS]
            res = {}
            for how in ("steady", "forced"):
                absorbs.clear()
                n0 = AK.launches["aoi_step"]

                def force(bucket, how=how):
                    if how == "forced":
                        bucket._max_chunks = 1

                eng, hs, run = engine_run(
                    AOIEngine, mesh, cfg, xs, zs, r, act,
                    PAGED_SHARDED_TICKS, PAGED_SHARDED_TICKS - 1,
                    paged=True, setup=force, **kw)
                b = hs[0].bucket
                label = f"phase 17c {name} {how}"
                got = [t_["crc"] for t_ in run["ticks"]]
                check(got == want, f"{label}: CRCs {got} != the non-paged "
                      f"run's {want}")
                check(b.stats["decode_overflow"] == 0,
                      f"{label}: decode_overflow {b.stats['decode_overflow']}")
                n_abs = len(absorbs)
                if how == "forced":
                    check(b._max_chunks == 1 and n_abs >= mesh.n_devices
                          * (PAGED_SHARDED_TICKS - 1),
                          f"{label}: caps {b._max_chunks}, {n_abs} absorbs")
                elif name == "million":
                    # phase 11b's prime tick overflows the chunk caps
                    check(n_abs > 0, f"{label}: the prime tick's overflow "
                          f"was not absorbed")
                launches["aoi_step rect" if cfg["zipf"] else "aoi_step"] += (
                    AK.launches["aoi_step"] - n0)
                res[how] = {"absorbs": n_abs,
                            "absorb_ms": list(absorbs),
                            "absorb_ms_mean": sum(absorbs) / max(n_abs, 1),
                            "tick_ms": [t_["tick_ms"] for t_ in run["ticks"]],
                            "n_pages": b._n_pages,
                            **{k: b.stats[k] for k in (
                                "page_spills", "page_occupancy",
                                "decode_overflow")}}
                if getattr(b, "exclusive", False):
                    eng.release_space(hs[0])
                del eng, hs, b
                torch.cuda.empty_cache()
            out[name] = res
            log("paged sharded", name, json.dumps(res))
    finally:
        for mod in (aoi_mesh, aoi_rowshard):
            mod._paged_absorb_shard = inner
    out["launches"] = launches
    return out


def pages_run(Runtime, AK, device, plan):
    """PAGES_TICKS ticks of phase 15's world (FAULT_SPACES spaces) on the
    paged Runtime under ``plan`` (a sync around each tick): per-tick CRC
    and ms, the kernel launches, the stats and the fired faults."""
    import gc

    from goworld_tpu_torch import faults

    rt, crc, spaces_l, slots, pos, rng = build_world(
        Runtime, device, FAULT_SPACES, PER_SPACE, CAPACITY, seed=7,
        fault_plan=plan, aoi_paged=True)
    bucket = bucket_of(rt)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    rows = []
    n0 = AK.launches["aoi_step"]
    try:
        for t in range(PAGES_TICKS):
            if t:
                walk(spaces_l, slots, pos, rng)
            crc["t"] = crc["te"] = 0
            sync()
            t0 = time.perf_counter()
            rt.tick()
            sync()
            rows.append((f"{crc['t']:08x}", crc["te"],
                         (time.perf_counter() - t0) * 1e3))
        fp = faults.plan()
        fired = [] if fp is None else [dict(f) for f in fp.fired]
        stats = dict(bucket.stats)
    finally:
        faults.clear()
    launches = AK.launches["aoi_step"] - n0
    del rt, bucket, spaces_l
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return rows, stats, fired, launches


def phase_pages_seam(Runtime, AK):
    """Phase 17d: PAGES_PLAN (aoi.pages oom at 3, partial at 5, poison at
    7) at phase 15's 2 spaces, sequential, on the card and on the CPU
    path, against the fault-free paged card run: per-tick CRCs equal, the
    counters and fired faults as planned (oom and partial spill the whole
    tick; the poisoned table is caught and the tick recomputed on the
    host, without demotion)."""
    free, free_st, _, free_l = pages_run(Runtime, AK, DEV, None)
    healthy(free_st, "phase 17d fault-free")
    check(free_st["page_spills"] == 0, f"phase 17d fault-free: "
          f"{free_st['page_spills']} page spills")
    out = {"plan": PAGES_PLAN, "fault_free_ms": [r[2] for r in free],
           "launches": free_l}
    for device in (DEV, "cpu"):
        rows, st, fired, n_l = pages_run(Runtime, AK, device, PAGES_PLAN)
        label = f"phase 17d {device}"
        got = {k: st[k] for k in PAGES_STATS}
        check(got == PAGES_STATS, f"{label}: stats {got}")
        check(fired_set(fired) == sorted(PAGES_FIRED),
              f"{label}: fired {fired_set(fired)}")
        check([r[:2] for r in rows] == [r[:2] for r in free],
              f"{label}: CRCs differ from the fault-free run")
        out[device] = {"ms": [r[2] for r in rows], "stats": got,
                       "fired": fired}
        if device == DEV:
            out["launches"] += n_l
    log("pages seam", json.dumps(out))
    return out


RECT_PATH_SHAPE = (1, 16384, 131072)  # phase 8 (`zipfshare`'s block)
RECT_SHAPES = [(1, 128, 384), (3, 256, 4096), RECT_PATH_SHAPE,
               (2, 100, 1056)]
CULLED_SHAPES = [(1, 4096), (8, 16384), (64, 16384), (1, 131072),
                 (2, 1056), (1, 4160)]
FULL = 131072  # from this many slots on: the dense-kernel check, fewer reps


def words_equal(name, got, want):
    """Bit-exact check of two int32 word tensors; returns max |diff| (0)."""
    if torch.equal(got, want):
        return 0
    err = int((got.long() - want.long()).abs().max())
    raise RuntimeError(f"chip smoke check failed: {name} (max |diff| {err})")


def random_words(shape, seed):
    """int32 words with random bits (bit 31 included) made on the card
    from a seed."""
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                         device=DEV, generator=g)


def rect_inputs(s, c_rows, c_cols, seed):
    """:func:`edge_inputs` over a whole space of c_cols slots, rolled so
    the edge cases land in the observer block [row0, row0 + c_rows) in
    the middle of the space; row ids are the block's global slots."""
    x, z, r, act = edge_inputs(s, c_cols, seed, with_prev=False)
    row0 = (c_cols - c_rows) // 2
    x, z, r, act = (torch.roll(a, row0, dims=1) for a in (x, z, r, act))
    act[:, row0 + c_rows - c_rows // 8:row0 + c_rows] = False  # inactive tail
    b = slice(row0, row0 + c_rows)
    rows = [a[:, b].contiguous() for a in (x, z, r, act)]
    rid = torch.arange(row0, row0 + c_rows, dtype=torch.int32,
                       device=DEV).expand(s, c_rows).contiguous()
    prev = random_words((s, c_rows, c_cols // 32), seed)
    return rows, (x, z, act), rid, prev


def culled_inputs(AG, s, c, seed):
    """x-sorted inputs at `million`'s density (world 11314 per 16384 slots,
    r = 100) with a NaN radius on one active row, a +inf radius, NaN and
    infinite positions, -0.0, subnormal and tie-lattice slots, an inactive
    tail, then 1% of the slots swapped (a nearly sorted order)."""
    rng = np.random.default_rng(seed)
    world = 11314.0 * (c / 16384) ** 0.5
    x = rng.uniform(0, world, (s, c)).astype(np.float32)
    z = rng.uniform(0, world, (s, c)).astype(np.float32)
    r = np.full((s, c), 100.0, np.float32)
    act = np.ones((s, c), bool)
    act[:, c - c // 16:] = False  # inactive tail
    x[:, :64:4] = np.round(x[:, :64:4] / 50) * 50  # ties at |dx| == r / 2
    x[:, 1], x[:, 2], x[:, 3] = -0.0, np.float32(1e-40), np.nan
    z[:, 5], x[:, 6] = np.inf, -np.inf
    r[:, 2] = 0.0
    r[:, c // 3] = np.nan  # one active row with a NaN radius
    r[:, c // 2] = np.inf
    dev = DEV
    xs, zs, rs, acts, _ = AG.sort_spaces(*(torch.from_numpy(a).to(dev)
                                           for a in (x, z, r, act)))
    n = max(1, c // 100)
    perm = np.tile(np.arange(c), (s, 1))
    for si in range(s):  # n disjoint swaps per space
        a, b = rng.choice(c, 2 * n, replace=False).reshape(2, n)
        perm[si, a], perm[si, b] = perm[si, b], perm[si, a]
    perm = torch.from_numpy(perm).to(dev)
    return [t.gather(1, perm) for t in (xs, zs, rs, acts)]


def vote_frac(AG, x, r, act):
    """The culled fraction of the kernels' vote in its plain version
    (:func:`aoi_grid.tile_votes`), rounded as the wrappers round theirs."""
    votes = AG.tile_votes(x, r, act).cpu().numpy().astype(np.uint32)
    n = votes.size * 32
    kept = int(np.unpackbits(votes.view(np.uint8)).sum())
    return float(np.float32((n - kept) / n))


def bytes_ops_bound(nbytes, pair_tests):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = pair_tests * OPS_PER_PAIR / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def phase_rect(AK, AD):
    rows_out = []
    for i, (s, cr, cc) in enumerate(RECT_SHAPES):
        rows, cols, rid, prev = rect_inputs(s, cr, cc, seed=300 + i)
        new_k, chg_k = AK.aoi_step_chg_cuda(*rows, prev, cols=cols,
                                            row_ids=rid)
        new_p, chg_p = AD.aoi_step_chg_dense(*rows, prev, cols=cols,
                                             row_ids=rid)
        err = max(words_equal(f"rect new at {(s, cr, cc)}", new_k, new_p),
                  words_equal(f"rect chg at {(s, cr, cc)}", chg_k, chg_p))
        del new_k, chg_k, new_p, chg_p

        def run():
            return AK.aoi_step_chg_cuda(*rows, prev, cols=cols, row_ids=rid)

        ms = cuda_ms(run, reps=20 if cr * cc >= 16384 * 16384 else 100)
        plain_ms = cuda_ms(lambda: AD.aoi_step_chg_dense(
            *rows, prev, cols=cols, row_ids=rid), reps=1, warm=1)
        w = cc // 32
        bound_ms, bound_by = bytes_ops_bound(
            s * cr * (13 + 4) + s * cc * 9 + 3 * s * cr * w * 4, s * cr * cc)
        row = {"shape": [s, cr, cc], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "max_abs_err": err}
        log("kernel aoi_step rect", json.dumps(row))
        rows_out.append(row)
        del rows, cols, rid, prev
        torch.cuda.empty_cache()
    return rows_out


def phase_culled(AG, AK):
    out = {"aoi_words_culled": [], "aoi_step_culled": []}
    for i, (s, c) in enumerate(CULLED_SHAPES):
        x, z, r, act = culled_inputs(AG, s, c, seed=400 + i)
        w = c // 32
        prev = random_words((s, c, w), seed=500 + i)
        words_k, frac_w = AG.aoi_words_culled_cuda(x, z, r, act)
        new_k, chg_k, frac_s = AG.aoi_step_culled_cuda(x, z, r, act, prev)
        t0 = time.perf_counter()
        plain, _ = AG.aoi_words_culled_plain(x, z, r, act)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(words_equal(f"culled words at {(s, c)}", words_k, plain),
                  words_equal(f"culled step new at {(s, c)}", new_k, plain))
        del words_k
        plain ^= prev  # the plain chg, in place
        err = max(err, words_equal(f"culled step chg at {(s, c)}", chg_k,
                                   plain))
        del plain
        dense_ms = yard = None
        if s * c >= FULL:
            # the culled step against the dense kernel on the same inputs
            new_d, chg_d = AK.aoi_step_chg_cuda(x, z, r, act, prev)
            words_equal(f"culled vs dense kernel new at {(s, c)}", new_k,
                        new_d)
            words_equal(f"culled vs dense kernel chg at {(s, c)}", chg_k,
                        chg_d)
            del new_d, chg_d
            # memory yardsticks for one [S, C, W] word array: a fill
            # (write only, as the words kernel) and a copy (read + write)
            yard = {"fill_ms": cuda_ms(lambda: chg_k.fill_(1), 10),
                    "copy_ms": cuda_ms(lambda: chg_k.copy_(prev), 10)}
            dense_ms = cuda_ms(lambda: AK.aoi_step_chg_cuda(
                x, z, r, act, prev), reps=3, warm=1)
        del new_k, chg_k
        frac_w, frac_s = float(frac_w), float(frac_s)
        check(0.0 < frac_s < 1.0 and frac_w == frac_s,
              f"culled_frac {frac_w} / {frac_s} at {(s, c)}")
        frac_v = vote_frac(AG, x, r, act)
        check(frac_w == frac_v, f"culled_frac {frac_w} != the plain "
              f"vote's {frac_v} at {(s, c)}")
        reps = 10 if s * c >= FULL else 30
        ms_w = cuda_ms(lambda: AG.aoi_words_culled_cuda(x, z, r, act), reps)
        ms_s = cuda_ms(lambda: AG.aoi_step_culled_cuda(x, z, r, act, prev),
                       reps)
        pairs = (1.0 - frac_s) * s * c * c  # the admitted pair tests
        ins = s * c * 13
        for name, ms, outs in (("aoi_words_culled", ms_w, 1),
                               ("aoi_step_culled", ms_s, 3)):
            bound_ms, bound_by = bytes_ops_bound(ins + outs * s * c * w * 4,
                                                 pairs)
            row = {"shape": [s, c], "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "max_abs_err": err, "culled_frac": frac_s,
                   "dense_kernel_ms": dense_ms, "words_yardstick": yard}
            log(f"kernel {name}", json.dumps(row))
            out[name].append(row)
        del x, z, r, act, prev
        torch.cuda.empty_cache()
    return out


# occupancies stood in for the card's own, so the kernels walk other
# launch plans: one block with long runs, a few blocks, one block per SM
# with one tile per unit
FORCED_OCCUPANCY = [(1, 1), (3, 2), (132, 1)]
PLAN_SHAPES = [(2, 1056, None), (3, 96, None), (2, 100, 1056),
               (8, 4096, None)]
PLAN_CULLED = [(2, 1056), (1, 4160), (8, 4096)]


def phase_plans(AK, AG, AD):
    """Both dense modes and both culled kernels under launch plans other
    than the card's own, bit-exact against the plain versions at the
    tile's edge shapes; the culled fraction must not depend on the plan.
    The kernels' decoding of a unit is checked here and only here."""
    real = (AK.occupancy, AG.occupancy)
    plans, fracs = set(), {}
    modes = (("aoi_step", AK.aoi_step_chg_cuda, AD.aoi_step_chg_dense),
             ("aoi_step_entlv", AK.aoi_step_entlv_cuda,
              AD.aoi_step_entlv_dense))
    try:
        for occ in FORCED_OCCUPANCY:
            AK.occupancy = AG.occupancy = lambda *a, occ=occ: occ
            for i, (s, cr, cc) in enumerate(PLAN_SHAPES):
                if cc is None:
                    x, z, r, act, prev = edge_inputs(s, cr, seed=700 + i)
                    args, kw = (x, z, r, act, prev), {}
                else:
                    rows, cols, rid, prev = rect_inputs(s, cr, cc,
                                                        seed=710 + i)
                    args, kw = (*rows, prev), {"cols": cols, "row_ids": rid}
                for mode, kernel, plain in modes:
                    got, want = kernel(*args, **kw), plain(*args, **kw)
                    for g, w_ in zip(got, want):
                        words_equal(f"{mode} at {(s, cr, cc)} under "
                                    f"occupancy {occ}", g, w_)
                    plans.add(AK.last_plan[mode])
            for i, (s, c) in enumerate(PLAN_CULLED):
                x, z, r, act = culled_inputs(AG, s, c, seed=720 + i)
                prev = random_words((s, c, c // 32), seed=730 + i)
                words, frac_w = AG.aoi_words_culled_cuda(x, z, r, act)
                new, chg, frac_s = AG.aoi_step_culled_cuda(x, z, r, act,
                                                           prev)
                plain, _ = AG.aoi_words_culled_plain(x, z, r, act)
                at = f"{(s, c)} under occupancy {occ}"
                words_equal(f"culled words at {at}", words, plain)
                words_equal(f"culled step new at {at}", new, plain)
                words_equal(f"culled step chg at {at}", chg, plain ^ prev)
                fracs.setdefault((s, c), set()).update(
                    (float(frac_w), float(frac_s),
                     vote_frac(AG, x, r, act)))
                plans.add(AG.last_plan["aoi_step_culled"])
                plans.add(AG.last_plan["aoi_words_culled"])
                check(AG.last_plan["aoi_words_culled"].tiles
                      <= AG.WORDS_UNIT_TILES,
                      f"words plan {AG.last_plan['aoi_words_culled']}")
    finally:
        AK.occupancy, AG.occupancy = real
    check(all(len(f) == 1 for f in fracs.values()),
          f"culled_frac depends on the launch plan: {fracs}")
    grids = sorted({p.grid for p in plans})
    tiles = sorted({p.tiles for p in plans})
    check(grids[0] == 1 and len(tiles) > 1,
          f"phase 6b walked too few plans: grids {grids}, tiles {tiles}")
    log("phase 6b: launch plans", json.dumps({"grids": grids,
                                                "tiles": tiles}))


# -- phases 7-8: the giant-capacity tick ---------------------------------------

QMAX = 80  # walk step 5: int8 deltas in [-80, 80] x 1/16
GIANT = {
    # BASELINE's north-star shapes, as bench.py:170-196 configures them
    "million": dict(s=64, cap=16384, world=11314.0, radius=100.0,
                    n_active=64 * 16384, zipf=False),
    "zipf100k": dict(s=1, cap=131072, world=60000.0, radius=100.0,
                     n_active=100_000, zipf=True),
}
RESORT_K, TAIL_TICKS = 16, 4  # a re-sort, 16 ticks, a re-sort, 4 ticks
SHARE_ROWS, SHARE_TICKS = 16384, 8
MESH_RT_TICKS = 5  # phase 11a: a prime tick and 4 walk ticks
MESH_WARMUP, MESH_MEASURED = 3, 8  # phase 11b, after a prime tick
ROWSHARD_TICKS = 4  # phase 12, after a prime tick
ROWSHARD_MIN = 65536  # phase 12's row-shard threshold (the engine default)


def make_initial(cfg, rng):
    """Initial positions (bench.py make_initial): uniform, or with 90% of
    the entities in the central 10%-linear hot zone."""
    s, cap, world = cfg["s"], cfg["cap"], cfg["world"]
    if cfg["zipf"]:
        hot = rng.random((s, cap)) < 0.9
        lo, hi = 0.45 * world, 0.55 * world
        x = np.where(hot, rng.uniform(lo, hi, (s, cap)),
                     rng.uniform(0, world, (s, cap)))
        z = np.where(hot, rng.uniform(lo, hi, (s, cap)),
                     rng.uniform(0, world, (s, cap)))
    else:
        x = rng.uniform(0, world, (s, cap))
        z = rng.uniform(0, world, (s, cap))
    return x.astype(np.float32), z.astype(np.float32)


def make_walk(cfg, rng, ticks):
    """int8 per-tick deltas and the host positions they lead to (bench.py
    make_walk): ``x = clip(x + q / 16, 0, world)`` in f32, products exact,
    so host and device positions agree bit for bit."""
    s, cap = cfg["s"], cfg["cap"]
    qx = rng.integers(-QMAX, QMAX + 1, (ticks, s, cap)).astype(np.int8)
    qz = rng.integers(-QMAX, QMAX + 1, (ticks, s, cap)).astype(np.int8)
    x, z = make_initial(cfg, rng)
    xs = np.empty((ticks + 1, s, cap), np.float32)
    zs = np.empty((ticks + 1, s, cap), np.float32)
    xs[0], zs[0] = x, z
    w = np.float32(cfg["world"])
    scale = np.float32(1.0 / 16.0)
    for t in range(ticks):
        x = np.clip(x + qx[t].astype(np.float32) * scale, np.float32(0), w)
        z = np.clip(z + qz[t].astype(np.float32) * scale, np.float32(0), w)
        xs[t + 1], zs[t + 1] = x, z
    return qx, qz, xs, zs


def make_state(cfg):
    """Device radius/activity (bench.py make_radius/make_active) and the
    seeded walk."""
    s, cap = cfg["s"], cfg["cap"]
    act = np.zeros((s, cap), bool)
    per = cfg["n_active"] // s
    act[:, :per] = True
    act[0, per:per + cfg["n_active"] - per * s] = True
    r = torch.full((s, cap), cfg["radius"], dtype=torch.float32,
                   device=DEV)
    return r, torch.from_numpy(act).to(DEV)


def host_words(words):
    return words.cpu().numpy().view(np.uint32).reshape(-1)


class StreamRun:
    """Codec, fetch, decode and host replay of a run's ticks, with the
    per-tick timing splits (CUDA events for device work, the host clock
    for the fetch, the decode and the replay).  The decode is the path's
    work; the replay (the decoded chg XORed into a host copy of the
    words) is this script's check, timed apart so that it stays out of
    the path's numbers."""

    def __init__(self, CD, words, n_stream_chunks, grid):
        self.CD = CD
        self.host = host_words(words)
        self.n = n_stream_chunks
        self.caps = CD.Caps.first_guess(n_stream_chunks, grid=grid)
        self.ms = {"encode": 0.0, "fetch": 0.0, "decode": 0.0, "replay": 0.0}
        self.events, self.ticks, self.overflow = 0, 0, 0
        self.peaks = {}

    def warm(self, new, chg):
        """The warm-up tick: refit the caps to its density (the counts are
        exact past the caps) until its stream fits, then replay it."""
        for _ in range(4):
            buf = self.CD.encode_tick(new, chg, self.caps).cpu().numpy()
            sc, dec = self.CD.decode_tick(buf, self.caps)
            fit = self.caps.refit(self.n, sc)
            if dec is not None and fit == self.caps:
                break
            self.caps = fit
        else:
            check(dec is not None, f"warm-up stream overflows: {sc}")
        log("caps", json.dumps(dataclasses.asdict(self.caps)), json.dumps(sc))
        self.host[dec[2]] ^= dec[0]

    def tick(self, new, chg):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        enc = self.CD.encode_tick(new, chg, self.caps)
        e1.record()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        buf = enc.cpu().numpy()
        t1 = time.perf_counter()
        sc, dec = self.CD.decode_tick(buf, self.caps)
        t2 = time.perf_counter()
        if dec is None:
            self.overflow += 1
            check(False, f"stream overflowed its refit caps: {sc}")
        chg_vals, _, gidx = dec
        self.host[gidx] ^= chg_vals
        t3 = time.perf_counter()
        self.ms["encode"] += e0.elapsed_time(e1)
        self.ms["fetch"] += (t1 - t0) * 1e3
        self.ms["decode"] += (t2 - t1) * 1e3
        self.ms["replay"] += (t3 - t2) * 1e3
        self.events += int(np.unpackbits(chg_vals.view(np.uint8)).sum())
        self.ticks += 1
        for k, v in sc.items():
            self.peaks[k] = max(self.peaks.get(k, 0), v)

    def replay_check(self, words, what):
        check(np.array_equal(self.host, host_words(words)),
              f"{what}: stream replay != device words")

    def report(self):
        t = max(self.ticks, 1)
        return {"encode_ms": self.ms["encode"] / t,
                "fetch_ms": self.ms["fetch"] / t,
                "decode_ms": self.ms["decode"] / t,
                "replay_check_ms": self.ms["replay"] / t,
                "events_per_tick": self.events / t,
                "overflow_ticks": self.overflow, "ticks": self.ticks,
                "caps": dataclasses.asdict(self.caps), "peaks": self.peaks}


def phase_grid(AG, CD, name):
    cfg = GIANT[name]
    qx, qz, xs, zs = make_walk(cfg, np.random.default_rng(0),
                               RESORT_K + TAIL_TICKS)
    r, act = make_state(cfg)
    dev = torch.device(DEV)
    timers = [DeviceTimer(AG, "aoi_step_culled"),
              DeviceTimer(AG, "aoi_words_culled"),
              DeviceTimer(AG, "sort_spaces"), LaunchTimer(AG, "_lib")]
    resort_ms = []

    def timed_resort(grid):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timers[3].on = True  # the words kernel's launch alone
        words = grid.resort()
        timers[3].on = False
        torch.cuda.synchronize()
        resort_ms.append((time.perf_counter() - t0) * 1e3)
        return words

    launches0 = dict(AG.launches)
    try:
        for t in timers:  # the launch timer only around the re-sorts
            t.on = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid = CD.FixedOrderGrid(torch.from_numpy(xs[0]).to(dev),
                                 torch.from_numpy(zs[0]).to(dev), r, act,
                                 cfg["world"])
        timers[3].on = False
        torch.cuda.synchronize()
        resort_ms.append((time.perf_counter() - t0) * 1e3)
        run = StreamRun(CD, grid.words, grid.n_stream_chunks, grid=True)
        fracs = []
        new, chg, frac = grid.step(qx[0], qz[0])
        run.warm(new, chg)
        step_timer = timers[0]
        step_timer.events.clear()
        for t in range(1, RESORT_K + TAIL_TICKS):
            if t == RESORT_K:
                run.replay_check(grid.words, f"{name} before the re-sort")
                del new, chg
                run.host = host_words(timed_resort(grid))
            new, chg, frac = grid.step(qx[t], qz[t])
            run.tick(new, chg)
            fracs.append(float(frac))
        del new, chg
        kernel_ms = step_timer.ms() / run.ticks
        words_ms = timers[1].each()
        # each re-sort's time split: the sort and gathers and the words
        # wrapper on the device clock, the wrapper's launch alone (the
        # rest of its bracket is the device waiting for the host: the
        # output's allocation), the wrapper's host time, and what is
        # left of the host clock (the permutation's fetch to the host)
        split = [{"resort_ms": rs, "sort_gather_ms": sg,
                  "words_bracket_ms": wb, "words_launch_ms": wl,
                  "words_wait_ms": wb - wl, "words_host_ms": wh,
                  "rest_ms": rs - sg - wb}
                 for rs, sg, wb, wl, wh in zip(
                     resort_ms, timers[2].each(), words_ms,
                     timers[3].each(), timers[1].host_ms)]
    finally:
        for t in timers:
            t.restore()
    run.replay_check(grid.words, f"{name} at the end")
    check(np.array_equal(grid.x.cpu().numpy(), xs[-1]) and
          np.array_equal(grid.sx.cpu().numpy(), np.take_along_axis(
              xs[-1], grid.perm_host, axis=1)),
          f"{name}: device positions != the host walk")
    plain, _ = AG.aoi_words_culled_plain(grid.sx, grid.sz, grid.rs,
                                         grid.acts)
    words_equal(f"{name}: final words vs plain dense", grid.words, plain)
    del plain, grid
    torch.cuda.empty_cache()
    out = {"config": name, "spaces": cfg["s"], "capacity": cfg["cap"],
           "active": cfg["n_active"], "ticks": RESORT_K + TAIL_TICKS,
           "measured": run.ticks, "kernel_ms": kernel_ms,
           **run.report(), "resort_ms": resort_ms,
           "resort_words_kernel_ms": words_ms,
           "resort_words_launch_ms": [d["words_launch_ms"] for d in split],
           "resort_split": split,
           "culled_frac_mean": sum(fracs) / len(fracs),
           "culled_frac_min": min(fracs),
           "launches": {k: v - launches0[k] for k, v in AG.launches.items()}}
    log("grid", json.dumps(out))
    return out


def phase_share(AK, AD, CD):
    cfg = GIANT["zipf100k"]
    qx, qz, xs, zs = make_walk(cfg, np.random.default_rng(0),
                               SHARE_TICKS + 1)
    r, act = make_state(cfg)
    dev = torch.device(DEV)
    timer = DeviceTimer(AK, "aoi_step_chg")
    try:
        blk = CD.RowBlock(torch.from_numpy(xs[0]).to(dev),
                          torch.from_numpy(zs[0]).to(dev), r, act,
                          cfg["world"], SHARE_ROWS)
        run = StreamRun(CD, blk.words, blk.n_stream_chunks, grid=False)
        new, chg = blk.step(qx[0], qz[0])
        run.warm(new, chg)
        timer.on = True
        for t in range(1, SHARE_TICKS + 1):
            new, chg = blk.step(qx[t], qz[t])
            run.tick(new, chg)
        del new, chg
        timer.on = False
        kernel_ms = timer.ms() / run.ticks
    finally:
        timer.restore()
    run.replay_check(blk.words, "zipfshare")
    check(np.array_equal(blk.x.cpu().numpy(), xs[-1]),
          "zipfshare: device positions != the host walk")
    b = blk.rows
    plain, _ = AD.aoi_step_chg_dense(
        blk.x[:, b], blk.z[:, b], blk.r[:, b], blk.act[:, b], blk.words,
        cols=(blk.x, blk.z, blk.act), row_ids=blk.row_ids)
    words_equal("zipfshare: final words vs plain dense", blk.words, plain)
    del plain, blk
    torch.cuda.empty_cache()
    out = {"config": "zipfshare", "rows": SHARE_ROWS,
           "candidates": cfg["cap"], "ticks": SHARE_TICKS + 1,
           "measured": run.ticks, "kernel_ms": kernel_ms, **run.report(),
           "launches": dict(AK.launches)}
    log("zipfshare", json.dumps(out))
    return out


# -- phase 9: the entlv mode of the step kernel vs plain ---------------------

ENTLV_SHAPES = [(1, 128), (4, 256), (16, 128), (8, 16384), (64, 16384)]
ENTLV_RECT = (3, 256, 4096)
ENTLV_EDGE = [(2, 1056, None), (3, 96, None), (2, 100, 1056)]
ENTLV_PATH_SHAPE = (64, 16384)  # phase 10 (`million`)


def phase_entlv(AK, AD):
    """emit="entlv" (new, enter, leave) against its plain version on the
    edge inputs of phase 3 (prev words with bit 31 set), square and one
    rectangular shape; its new words against the chg kernel's."""
    rows_out = []
    shapes = [(s, c, None) for s, c in ENTLV_SHAPES] + [ENTLV_RECT] + \
        ENTLV_EDGE
    for i, (s, cr, cc) in enumerate(shapes):
        if cc is None:
            x, z, r, act, prev = edge_inputs(s, cr, seed=900 + i)
            args, kw, c_cols = (x, z, r, act, prev), {}, cr
        else:
            rows, cols, rid, prev = rect_inputs(s, cr, cc, seed=900 + i)
            args, kw, c_cols = (*rows, prev), {"cols": cols,
                                                "row_ids": rid}, cc
        shape = [s, cr] if cc is None else [s, cr, cc]
        got = AK.aoi_step_entlv_cuda(*args, **kw)
        new_c, _chg = AK.aoi_step_chg_cuda(*args, **kw)
        del _chg
        err = words_equal(f"entlv new vs chg new at {shape}", got[0], new_c)
        del new_c
        want = AD.aoi_step_entlv_dense(*args, **kw)
        for g, w_, name in zip(got, want, ("new", "enter", "leave")):
            err = max(err, words_equal(f"entlv {name} at {shape}", g, w_))
        del got, want
        torch.cuda.empty_cache()
        big = s * cr * c_cols >= 8 * 16384 * 16384
        ms = cuda_ms(lambda: AK.aoi_step_entlv_cuda(*args, **kw),
                     reps=10 if big else 100)
        plain_ms = cuda_ms(lambda: AD.aoi_step_entlv_dense(*args, **kw),
                           reps=1 if big else 3, warm=1)
        if cc is None:
            bound_ms, bound_by = aoi_step_bound(s, cr, word_arrays=4)
        else:
            bound_ms, bound_by = bytes_ops_bound(
                s * cr * (13 + 4) + s * cc * 9 + 4 * s * cr * (cc // 32) * 4,
                s * cr * cc)
        row = {"shape": shape, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "max_abs_err": err}
        log("kernel aoi_step_entlv", json.dumps(row))
        rows_out.append(row)
        del args, kw, prev
        torch.cuda.empty_cache()
    return rows_out


# -- phases 10-12: the multi-device tier on one card ---------------------------


def meshes(SpaceMesh, n_virtual):
    """(label, mesh): one shard on the card, ``n_virtual`` virtual shards
    of it, and -- where torch sees more cards -- distinct cards."""
    dev = torch.device(DEV)
    out = [("1 shard", SpaceMesh([dev])),
           (f"{n_virtual} virtual shards of one card",
            SpaceMesh([dev] * n_virtual))]
    n = torch.cuda.device_count()
    if n > 1:
        out.append((f"{n} cards", SpaceMesh([torch.device("cuda", i)
                                             for i in range(n)])))
    return out


def shard_block(parts, lo, hi):
    """Global spaces [lo, hi) of per-shard tensors, on the card."""
    b = parts[0].shape[0]
    return torch.cat([parts[d][max(lo, d * b) - d * b:
                               min(hi, (d + 1) * b) - d * b].to(DEV)
                      for d in range(lo // b, (hi - 1) // b + 1)])


def million_inputs():
    """`million` (bench.py:193-195): 64 x 16384, all active, world 11314,
    r = 100, uniform, seed 0; the positions of the prime tick and of one
    tick of the int8 walk."""
    cfg = GIANT["million"]
    _qx, _qz, xs, zs = make_walk(cfg, np.random.default_rng(0), 1)
    s, c = cfg["s"], cfg["cap"]
    r = np.full((s, c), cfg["radius"], np.float32)
    act = np.ones((s, c), bool)
    return xs, zs, r, act


def phase_sharded_step(AK, AD, EV, SpaceMesh, make_sharded_aoi_step):
    """The space-sharded entlv step at `million` on each mesh: a prime
    tick from zero prev, then a tick after a walk.  Each mesh's new,
    enter and leave words equal the plain version's, 8 spaces at a time
    (so they equal across meshes), its total the plain popcount, and each
    shard's stream (max_words) exactly its enter words."""
    xs, zs, r, act = million_inputs()
    s, c = r.shape
    w = c // 32
    rt_, at = torch.from_numpy(r).to(DEV), torch.from_numpy(act).to(DEV)
    timer = DeviceTimer(AK, "aoi_step_entlv")
    launch = LaunchTimer(AK, "_lib")  # the kernel's launches alone
    runs = []
    try:
        for label, mesh in meshes(SpaceMesh, 4):
            step = make_sharded_aoi_step(mesh)
            put = mesh.device_put
            stat = [put(r), put(act)]
            prev = put(np.zeros((s, c, w), np.uint32))
            run = {"mesh": label, "shards": mesh.n_devices,
                   "cards": mesh.n_distinct, "ticks": []}
            for t in range(2):
                x, z = put(xs[t]), put(zs[t])
                timer.events.clear()
                launch.events.clear()
                timer.on = launch.on = True
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                new, ent, lv, total = step(x, z, *stat, prev)
                torch.cuda.synchronize()
                step_ms = (time.perf_counter() - t0) * 1e3
                timer.on = launch.on = False
                xt = torch.from_numpy(xs[t]).to(DEV)
                zt = torch.from_numpy(zs[t]).to(DEV)
                plain_total = 0
                for lo in range(0, s, 8):
                    hi = lo + 8
                    want = AD.aoi_step_entlv_dense(
                        xt[lo:hi], zt[lo:hi], rt_[lo:hi], at[lo:hi],
                        shard_block(prev, lo, hi))
                    for g, w_, name in zip((new, ent, lv), want,
                                           ("new", "enter", "leave")):
                        words_equal(f"sharded {name} vs plain, {label}, "
                                    f"tick {t}, spaces {lo}..{hi - 1}",
                                    shard_block(g, lo, hi), w_)
                    plain_total += int(EV.popcount_total(want[1])
                                       + EV.popcount_total(want[2]))
                    del want
                check(total == plain_total, f"{label} tick {t}: total "
                      f"{total} != plain {plain_total}")
                if runs:
                    check(total == runs[0]["ticks"][t]["total_events"],
                          f"{label} tick {t}: total differs from "
                          f"{runs[0]['mesh']}")
                run["ticks"].append({"total_events": total,
                                     "step_ms": step_ms,
                                     "kernel_ms": timer.ms(),
                                     "launch_ms": launch.ms()})
                if t == 1:
                    run["streams"] = check_streams(
                        make_sharded_aoi_step, mesh, x, z, stat, prev, ent)
                prev = new
                del ent, lv
            runs.append(run)
            log("sharded step", json.dumps(run))
            del prev, stat, new
            torch.cuda.empty_cache()
    finally:
        timer.restore()
        launch.restore()
    return {"config": "million", "spaces": s, "capacity": c, "meshes": runs}


def check_streams(make_sharded_aoi_step, mesh, x, z, stat, prev, ent):
    """The walk tick again with shard-local extraction (max_words sized to
    the largest shard's nonzero enter words, chunk_k = 128): every shard's
    stream must be complete and hold exactly its nonzero enter words, in
    ascending order."""
    nnz = [int(torch.count_nonzero(e)) for e in ent]
    max_words = 128 * (max(nnz) + 1)
    step = make_sharded_aoi_step(mesh, max_words=max_words, chunk_k=128)
    _new, streams, _lv, _total = step(x, z, *stat, prev)
    for d, (vals, idx, n_words, nd, mcc) in enumerate(streams):
        check(int(nd) <= max_words // 128 and int(mcc) <= 128,
              f"shard {d}: stream overflow ({int(nd)}, {int(mcc)})")
        valid = idx >= 0
        flat = ent[d].reshape(-1)
        want_idx = torch.nonzero(flat).reshape(-1)
        check(int(n_words) == nnz[d] == int(valid.sum()),
              f"shard {d}: {int(n_words)} words extracted, {nnz[d]} nonzero")
        check(torch.equal(idx[valid], want_idx) and
              torch.equal(vals[valid], flat[want_idx]),
              f"shard {d}: stream != its enter words")
    return {"max_words": max_words, "words_per_shard": nnz}


def walk_crcs(Runtime, mesh, ticks):
    """Phase 4's world and seeded walk on one Runtime; the event CRC after
    each tick."""
    kw = {} if mesh is None else {"aoi_mesh": mesh}
    rt, crc, spaces_l, slots, pos, rng = build_world(
        Runtime, DEV, SPACES, PER_SPACE, CAPACITY, seed=7, **kw)
    crcs = []
    for t in range(ticks):
        if t:
            walk(spaces_l, slots, pos, rng)
        rt.tick()
        torch.cuda.synchronize()
        crcs.append((f"{crc['v']:08x}", crc["events"]))
    stats = dict(bucket_of(rt).stats)
    healthy(stats, "engine on mesh (Runtime)" if mesh else "single device")
    del rt
    torch.cuda.empty_cache()
    return crcs, stats


def engine_run(AOIEngine, mesh, cfg, xs, zs, r, act, ticks, measured,
               setup=None, **eng_kw):
    """``ticks`` flushes of one engine on ``mesh`` through submit/flush:
    per-tick event CRC and decode_overflow, the bucket's perf split over
    the last ``measured`` ticks, device peak memory.  ``setup(bucket)``
    runs before the first tick."""
    torch.cuda.reset_peak_memory_stats()
    eng = AOIEngine(device=DEV, mesh=mesh, **eng_kw)
    hs = [eng.create_space(cfg["cap"]) for _ in range(cfg["s"])]
    bucket = hs[0].bucket
    if setup is not None:
        setup(bucket)
    rows, t_ms, perf0 = [], 0.0, None

    def fold():
        crc, n_ev = 0, 0
        for h in hs:
            for a in eng.take_events(h):
                crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
                n_ev += len(a)
        return crc, n_ev

    for t in range(ticks):
        if t == ticks - measured:
            perf0 = dict(bucket.perf)
            ev0 = sum(r_["events"] for r_ in rows)
        ov0 = bucket.stats["decode_overflow"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for si, h in enumerate(hs):
            eng.submit(h, xs[t][si], zs[t][si], r[si], act[si])
        eng.flush()
        crc, n_ev = fold()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        if t >= ticks - measured:
            t_ms += dt
        rows.append({"crc": f"{crc:08x}", "events": n_ev, "tick_ms": dt,
                     "decode_overflow": bucket.stats["decode_overflow"]
                     - ov0})
    perf = {k[:-2] + "_ms": (bucket.perf[k] - perf0[k]) * 1e3 / measured
            for k in bucket.perf}
    trailing = None
    if eng.has_pending():  # deferred: the last tick comes out of drain()
        eng.drain()
        crc, n_ev = fold()
        trailing = {"crc": f"{crc:08x}", "events": n_ev}
    out = {"ticks": rows, "tick_ms": t_ms / measured, "perf_ms": perf,
           "trailing": trailing,
           "events_per_tick": (sum(r_["events"] for r_ in rows) - ev0)
           / measured,
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "caps": [bucket._max_chunks, bucket._kcap, bucket._max_gaps,
                    bucket._max_exc],
           "stats": dict(bucket.stats)}
    healthy(out["stats"], f"{type(bucket).__name__} engine run")
    return eng, hs, out


def phase_engine_mesh(Runtime, AOIEngine, AK, AD, SpaceMesh):
    """(a) Runtime on 4 virtual shards vs the single-device Runtime on
    phase 4's world and walk, per-tick CRC; (b) AOIEngine on the mesh at
    `million`, 1 shard and 4 virtual shards: a prime tick, 3 warm-up and
    8 measured, per-tick CRCs equal, final words equal to the plain dense
    words of the final positions."""
    dev = torch.device(DEV)
    single, s_stats = walk_crcs(Runtime, None, MESH_RT_TICKS)
    AK.reset_launches()
    virt, v_stats = walk_crcs(Runtime, SpaceMesh([dev] * 4), MESH_RT_TICKS)
    check(AK.launches["aoi_step"] == 4 * MESH_RT_TICKS,
          f"mesh Runtime step launches {AK.launches}")
    check(single == virt, f"mesh Runtime CRCs {virt} != single-device "
          f"Runtime {single}")
    rt_out = {"ticks": MESH_RT_TICKS, "crcs": virt,
              "single_device_crcs": single, "mesh_stats": v_stats,
              "single_stats": s_stats}
    log("engine on mesh (Runtime)", json.dumps(rt_out))

    cfg = GIANT["million"]
    ticks = 1 + MESH_WARMUP + MESH_MEASURED
    _qx, _qz, xs, zs = make_walk(cfg, np.random.default_rng(0), ticks - 1)
    s, c = cfg["s"], cfg["cap"]
    r = np.full((s, c), cfg["radius"], np.float32)
    act = np.ones((s, c), bool)
    runs = []
    for label, mesh in meshes(SpaceMesh, 4):
        AK.reset_launches()
        eng, hs, run = engine_run(AOIEngine, mesh, cfg, xs, zs, r, act,
                                  ticks, MESH_MEASURED)
        run.update(mesh=label, shards=mesh.n_devices,
                   cards=mesh.n_distinct, launches=dict(AK.launches))
        check(AK.launches["aoi_step"] == mesh.n_devices * ticks,
              f"{label}: step launches {AK.launches}")
        check(run["ticks"][0]["decode_overflow"] > 0,
              f"{label}: the prime tick did not take the counted recovery")
        late = [t_["decode_overflow"] for t_ in run["ticks"][-MESH_MEASURED:]]
        check(sum(late) <= 1 and late[-2:] == [0, 0],
              f"{label}: the measured ticks did not decode from the stream "
              f"({late})")
        if runs:
            check([t_["crc"] for t_ in run["ticks"]] ==
                  [t_["crc"] for t_ in runs[0]["ticks"]],
                  f"{label}: per-tick CRCs differ from {runs[0]['mesh']}")
        # final words vs the plain dense words of the final positions
        xt, zt = (torch.from_numpy(a[-1]).to(DEV) for a in (xs, zs))
        rt_, at = torch.from_numpy(r).to(DEV), torch.from_numpy(act).to(DEV)
        for si, h in enumerate(hs):
            want = AD.interest_words_dense(xt[si], zt[si], rt_[si], at[si])
            check(np.array_equal(h.bucket.get_prev(h.slot),
                                 want.cpu().numpy().view(np.uint32)),
                  f"{label}: slot {si} words != plain dense")
        del eng, hs
        torch.cuda.empty_cache()
        log("engine on mesh (million)", json.dumps(run))
        runs.append(run)
        # the same run pipelined: the CRCs shifted by one tick
        AK.reset_launches()
        eng, hs, prun = engine_run(AOIEngine, mesh, cfg, xs, zs, r, act,
                                   ticks, MESH_MEASURED, pipeline=True)
        prun.update(mesh=label, shards=mesh.n_devices, pipeline=True,
                    launches=dict(AK.launches))
        check(AK.launches["aoi_step"] == mesh.n_devices * ticks,
              f"{label} pipelined: step launches {AK.launches}")
        check(prun["ticks"][0]["events"] == 0,
              f"{label} pipelined: tick 0 delivered events")
        got = [(t_["crc"], t_["events"]) for t_ in prun["ticks"][1:]]
        got.append((prun["trailing"]["crc"], prun["trailing"]["events"]))
        check(got == [(t_["crc"], t_["events"]) for t_ in run["ticks"]],
              f"{label} pipelined: CRCs are not the sequential run's "
              f"shifted by one tick")
        del eng, hs
        torch.cuda.empty_cache()
        log("engine on mesh (million, pipelined)", json.dumps(prun))
        runs.append(prun)
    return {"runtime": rt_out, "million": runs}


def phase_rowshard(AOIEngine, AK, SpaceMesh):
    """The row-sharded bucket at `zipf100k` on 1 shard and on 8 virtual
    shards (each then `zipfshare`'s 16384 x 131072 block): a prime tick
    and 4 ticks, per-tick CRCs equal, the shards' words equal to the
    square step kernel's words of the final positions, derive_row and
    derive_col equal to those words."""
    cfg = GIANT["zipf100k"]
    ticks = 1 + ROWSHARD_TICKS
    _qx, _qz, xs, zs = make_walk(cfg, np.random.default_rng(0), ticks - 1)
    c = cfg["cap"]
    r_t, act_t = make_state(cfg)
    r, act = r_t.cpu().numpy(), act_t.cpu().numpy()
    del r_t, act_t
    dev = torch.device(DEV)
    runs = []
    sq = None
    for label, mesh in (("1 shard", SpaceMesh([dev])),
                        ("8 virtual shards of one card",
                         SpaceMesh([dev] * 8))):
        AK.reset_launches()
        eng, hs, run = engine_run(AOIEngine, mesh, cfg, xs, zs, r, act,
                                  ticks, ROWSHARD_TICKS,
                                  rowshard_min_capacity=ROWSHARD_MIN)
        b = hs[0].bucket
        check(type(b).__name__ == "_RowShardCUDABucket",
              f"{label}: zipf100k landed on {type(b).__name__}")
        run.update(mesh=label, shards=mesh.n_devices,
                   launches=dict(AK.launches))
        check(AK.launches["aoi_step"] == mesh.n_devices * ticks,
              f"{label}: rect launches {AK.launches}")
        if runs:
            check([t_["crc"] for t_ in run["ticks"]] ==
                  [t_["crc"] for t_ in runs[0]["ticks"]],
                  f"{label}: per-tick CRCs differ from {runs[0]['mesh']}")
        if sq is None:
            # the square kernel over the final positions, once
            xt, zt = (torch.from_numpy(a[-1]).to(DEV) for a in (xs, zs))
            rt_ = torch.from_numpy(r).to(DEV)
            at = torch.from_numpy(act).to(DEV)
            zero = torch.zeros((1, c, c // 32), dtype=torch.int32,
                               device=DEV)
            sq, _chg = AK.aoi_step_chg_cuda(xt, zt, rt_, at, zero)
            del _chg, zero
            sq = sq[0]
        cl = b.c_local
        for d, blk in enumerate(b.prev):
            words_equal(f"{label}: shard {d} words vs the square kernel",
                        blk, sq[d * cl:(d + 1) * cl])
        for e in (0, 7, c // 2 + 3, cfg["n_active"] - 1):
            row = b.derive_row(0, e)
            check(np.array_equal(row, sq[e].cpu().numpy().view(np.uint32)),
                  f"{label}: derive_row({e})")
            w, bit = e % (c // 32), e // (c // 32)
            colw = sq[:, w].cpu().numpy().view(np.uint32)
            check(np.array_equal(b.derive_col(0, e), np.nonzero(
                colw & (np.uint32(1) << np.uint32(bit)))[0]),
                f"{label}: derive_col({e})")
        eng.release_space(hs[0])
        del eng, hs, b
        torch.cuda.empty_cache()
        log("rowshard (zipf100k)", json.dumps(run))
        runs.append(run)
    del sq
    torch.cuda.empty_cache()
    return runs


# -- phases 18-18c: interest-policy stacks ------------------------------------

INTEREST_COMBOS = ["team", "tier", "los", "team+tier", "tier+los",
                   "team+tier+los"]
INTEREST_SMALL = [128, 256, 384]  # 384: a multiple of 128, not a power of 2
INTEREST_FULL = CAPACITY
# phase 18b's field: five buildings in phase 4's 4000-wide world, baked
# at 100-unit cells (40 x 40 cells, 6.4 KB)
INTEREST_BOXES = [(500.0, 500.0, 900.0, 700.0),
                  (1800.0, 1200.0, 2000.0, 2600.0),
                  (2600.0, 3000.0, 3400.0, 3200.0),
                  (300.0, 2800.0, 700.0, 3600.0),
                  (3000.0, 600.0, 3600.0, 1000.0)]
INTEREST_CELL = 100.0
INTEREST_PERIOD, INTEREST_DEPTH = 4, 2
INTEREST_WARMUP, INTEREST_MEASURED = 3, 12  # after a prime tick
INTEREST_CUT = (2, 2000, 2048, 6)  # check 2: spaces, entities, capacity, ticks
# f32 operations: a pair test (2 sub, 2 abs, 2 compares), the tier's 4
# compares, one line-of-sight sample (midpoint 2 add + 2 mul; cell 2 sub
# + 2 mul + 2 floor + 4 min/max; 1 compare)
INTEREST_OPS_PAIR, INTEREST_OPS_TIER, INTEREST_OPS_SAMPLE = 6, 4, 15
# the kernel instantiations whose SASS per pair phase 18 counts
INTEREST_SASS = {"off": "interest_step_kernelILb1ELb1ELb0ELb0EE",
                 "full": "interest_step_kernelILb1ELb1ELb1ELb1EE"}
# phase 18c: scripts/loadgen_smoke.py's and bench.py bench_engine_load's
# harnesses (clients, spaces, gates, period, seed), a 4-tick warm-up then
# 9 ticks (2 periods + 1: the last tick a full step)
LOAD_CONFIGS = {"loadgen_smoke": (100_000, 256, 8, 4, 11),
                "engine_load": (8192, 8, 4, 4, 29)}
LOAD_WARMUP, LOAD_TICKS = 4, 9


def interest_policies(TI, combo, field, depth=INTEREST_DEPTH,
                      period=INTEREST_PERIOD):
    ps = []
    if "team" in combo:
        ps.append(TI.TeamVisibilityPolicy())
    if "tier" in combo:
        ps.append(TI.TieredRatePolicy(period=period))
    if "los" in combo:
        ps.append(TI.LineOfSightPolicy(field, depth=depth))
    return ps


def interest_field(TI, small):
    """The tests' 200-wide field with its first grid column blocked (a NaN
    sample's cell 0 then decides a pair), or phase 18b's."""
    if small:
        return TI.DistanceField.from_boxes(
            [(20.0, 20.0, 45.0, 60.0), (-60.0, -10.0, -30.0, 10.0),
             (-100.0, -100.0, -97.0, 100.0)], (-100.0, -100.0),
            (200.0, 200.0), cell=5.0)
    return TI.DistanceField.from_boxes(INTEREST_BOXES, (0.0, 0.0),
                                       (WORLD, WORLD), cell=INTEREST_CELL)


def interest_inputs(c, seed, small):
    """The stack step's inputs on the card: x, z, r, act, team, vis and
    two random previous planes (bit 31 set in word 0).  ``small``: the
    tests' 200-wide world; else phase 18b's (4000 wide, radius 100,
    PER_SPACE active).  Both carry the edge cases in their first 64
    slots: 0.0 / -0.0, subnormals, NaN, +-inf, infinite and NaN radii,
    ties at r * near_frac and at rn * hysteresis, samples outside the
    world, team bit 31, and the +inf -> -inf pair under an infinite
    radius (its midpoints are NaN)."""
    rng = np.random.default_rng(seed)
    if small:
        x = (np.round(rng.uniform(-110, 110, c) * 4) / 4).astype(np.float32)
        z = (np.round(rng.uniform(-110, 110, c) * 4) / 4).astype(np.float32)
        r = rng.choice([0.0, 10.0, 20.0, 40.0], c).astype(np.float32)
        act = rng.random(c) < 0.85
    else:
        x = rng.uniform(0, WORLD, c).astype(np.float32)
        z = rng.uniform(0, WORLD, c).astype(np.float32)
        r = np.full(c, RADIUS, np.float32)
        act = np.arange(c) < PER_SPACE
    team = (np.uint32(1) << rng.integers(0, 4, c).astype(np.uint32))
    vis = np.where(rng.random(c) < 0.75, 0xFFFFFFFF, 1).astype(np.uint32)
    n, sub = 64, np.float32(1e-40)
    act[:24] = True
    x[:n:8], x[1:n:8], x[2:n:8], x[3:n:8] = 0.0, -0.0, sub, -sub
    z[:n:4] = 0.0
    x[4:n:16], z[5:n:16], x[6:n:16] = np.nan, np.inf, -np.inf
    z[7:n:16], x[12:n:16] = -np.inf, np.inf
    r[7:n:16], r[15:n:16], r[8:n:16] = np.inf, np.nan, 0.0
    x[16], z[16], r[16], vis[16] = 0.0, 0.0, 40.0, 0x80000000
    x[17], x[18] = 20.0, 25.0  # r * 0.5 and (r * 0.5) * 1.25
    x[19] = np.nextafter(np.float32(25.0), np.float32(30.0))
    z[17] = z[18] = z[19] = 0.0
    x[20], z[20], team[21] = -1000.0, 5000.0, 0x80000000
    x[22], z[22], r[22], vis[22] = np.inf, 0.0, np.inf, 0xFFFFFFFF
    x[23], z[23], team[23] = -np.inf, 0.0, 1
    prev = rng.integers(-2**31, 2**31, (2, c, c // 32), dtype=np.int64) \
        .astype(np.int32)
    prev[:, :, 0] |= np.int32(-2**31)
    dev = torch.device(DEV)
    cols = [torch.from_numpy(a).to(dev) for a in (x, z, r, act)]
    tv = [torch.from_numpy(a.view(np.int32)).to(dev) for a in (team, vis)]
    return cols + tv + [torch.from_numpy(prev[0]).to(dev),
                        torch.from_numpy(prev[1]).to(dev)]


def far_base_pairs(K, args, cfg):
    """Pairs whose base bit is set and whose near bit is not (those are
    the pairs a full LOS step samples), counted in row blocks."""
    x, z, r, act, team, vis, _, prev_near = args
    c = x.shape[0]
    n = 0
    for lo in range(0, c, 1024):
        rows = (lo, min(c, lo + 1024))
        gate = K.pair_gate(act, torch, rows)
        if cfg.has_team:
            gate = gate & K.team_mask(team, vis, torch, rows)
        base = K.base_mask(x, z, r, gate, torch, rows)
        if cfg.has_tier:
            pn = K.unpack_words(prev_near[rows[0]:rows[1]], c, torch)
            near = K.near_mask(K.chebyshev(x, z, torch, rows), r, pn, gate,
                               cfg.near_frac, cfg.hysteresis, torch, rows)
            base = base & ~near
        n += int(base.sum())
    return n


def interest_bound(K, args, cfg, full, grid):
    """(bound_ms, bound_by, samples) for one step: the bytes it must move
    (columns, the planes it reads -- prev_near with a tier, prev_final on
    an off step -- both planes out, the field on a LOS step) over the
    memory rate; its f32 operations (pair tests, tier compares, the LOS
    samples this run's inputs need) over the f32 rate."""
    c = args[0].shape[0]
    plane = c * (c // 32) * 4
    planes_in = int(cfg.has_tier) + int(not full)
    los = cfg.has_los and full
    nbytes = c * (3 * 4 + 1 + 2 * 4) + (planes_in + 2) * plane
    samples = 0
    if los:
        nbytes += grid.numel() * 4
        samples = far_base_pairs(K, args, cfg) * ((1 << cfg.los_depth) - 1)
    ops = c * c * (INTEREST_OPS_PAIR + INTEREST_OPS_TIER * cfg.has_tier) \
        + samples * INTEREST_OPS_SAMPLE
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", samples)


def interest_sass_per_pair(_build):
    """SASS instructions per pair of the stack-step kernel's unrolled bit
    loop (first to last FSETP over its 32 pairs; a LOS sample is a call
    out of the loop), for the off step and the full team+tier+LOS step;
    None where cuobjdump is missing or the count fails."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    got = {}
    try:
        dump = subprocess.run(
            [tool, "-sass", os.path.join(_build.BUILD_DIR,
                                         "libinterest_step.so")],
            capture_output=True, text=True, check=True, timeout=120).stdout
    except (OSError, subprocess.SubprocessError) as e:
        log(f"interest sass: not measured ({e!r})")
        return {k: None for k in INTEREST_SASS}
    for k, mark in INTEREST_SASS.items():
        ins, inside = [], False
        for line in dump.splitlines():
            if "Function : " in line:
                inside = mark in line
            elif inside and (m := SASS_LINE.match(line)):
                if m.group(2) != "NOP":
                    ins.append(m.group(2))
        fsetp = [i for i, op in enumerate(ins) if op.startswith("FSETP")]
        got[k] = ((fsetp[-1] - fsetp[0] + 1) / 32) if fsetp else None
    return got


def phase_interest_kernel(IC, K, TI):
    """Phase 18: csrc/interest_step.cu against its plain version on the
    card, bit for bit: the six policy mixes, full and off steps, LOS
    depths 1-4, on edge inputs at C = 128, 256, 384, and at C = 16384 on
    phase 18b's world; CUDA-event times and bounds at 16384."""
    from goworld_tpu_torch.interest.policy import _build_config

    def cfg_of(combo, field, depth):
        cfg, f = _build_config(interest_policies(TI, combo, field, depth))
        g = None if f is None else torch.from_numpy(f.grid).to(DEV)
        return cfg, g

    def same(args, cfg, full, g, label):
        kf, kn = IC.interest_step_cuda(*args, cfg, full, grid=g)
        pf, pn = IC.interest_step_plain(*args, cfg, full, grid=g)
        torch.cuda.synchronize()
        err = 0
        if not (torch.equal(kf, pf) and torch.equal(kn, pn)):
            err = int((kf != pf).sum()) + int((kn != pn).sum())
        check(err == 0, f"interest_step kernel != plain: {label} "
              f"({err} words differ)")

    small = interest_field(TI, True)
    n_cases = 0
    for i, c in enumerate(INTEREST_SMALL):
        for combo in INTEREST_COMBOS:
            for depth in (1, 2, 3, 4) if "los" in combo else (2,):
                cfg, g = cfg_of(combo, small, depth)
                args = interest_inputs(c, 300 + 10 * i + depth, small=True)
                fulls = (True, False) if "tier" in combo and depth == 2 \
                    else (True,)
                for full in fulls:
                    same(args, cfg, full, g, f"C={c} {combo} depth {depth} "
                         f"{'full' if full else 'off'}")
                    n_cases += 1
    big = interest_field(TI, False)
    args = interest_inputs(INTEREST_FULL, 400, small=False)
    rows = []
    for combo, full, depth in (("team+tier+los", True, INTEREST_DEPTH),
                               ("team+tier+los", False, INTEREST_DEPTH),
                               ("los", True, 4)):
        cfg, g = cfg_of(combo, big, depth)
        label = f"C={INTEREST_FULL} {combo} depth {depth} " \
                f"{'full' if full else 'off'}"
        same(args, cfg, full, g, label)
        n_cases += 1
        ms = cuda_ms(lambda: IC.interest_step_cuda(*args, cfg, full, grid=g),
                     reps=20)
        read_sm_clock()
        plain_ms = cuda_ms(lambda: IC.interest_step_plain(*args, cfg, full,
                                                          grid=g),
                           reps=2, warm=1)
        bound_ms, bound_by, samples = interest_bound(K, args, cfg, full, g)
        row = {"shape": [1, INTEREST_FULL], "combo": combo,
               "step": "full" if full else "off", "depth": depth, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "los_samples": samples,
               "max_abs_err": 0}
        log("kernel interest_step", json.dumps(row))
        rows.append(row)
    del args
    torch.cuda.empty_cache()
    log(f"phase 18: {n_cases} cases bit-exact")
    return {"cases": n_cases, "rows": rows}


def crc_of(arrays, crc=0):
    for a in arrays:
        crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
    return crc


def interest_run(Runtime, TI, IC, D, label, spaces, per_space, capacity,
                 ticks, measured=0, plain=False, **rt_kw):
    """Phase 4's world (``spaces`` x ``per_space``) with the phase-18b
    stack on every space (team/vis seeded as tests/test_interest.py's
    _walk seeds them), walked for ``ticks`` ticks (the first the prime
    tick) through ``Runtime(device="cuda", **rt_kw)``; the last
    ``measured`` ticks are timed.  ``plain``: the stack step calls the
    plain PyTorch version on the card in place of the kernel.  Returns
    per-tick event CRCs, the whole stream's CRC, final words, launches
    and the timing split."""
    field = interest_field(TI, False)

    def setup(sp):
        sp.enable_interest(*interest_policies(TI, "team+tier+los", field))

    rt, crc, spaces_l, slots, pos, rng = build_world(
        Runtime, "cuda", spaces, per_space, capacity, seed=7, setup=setup,
        **rt_kw)
    trng = np.random.default_rng(3)
    for sp, sl in zip(spaces_l, slots):
        team = np.uint32(1) << trng.integers(0, 4, len(sl)).astype(np.uint32)
        vis = np.where(trng.random(len(sl)) < 0.75, 0xFFFFFFFF, 1)
        for s, t_, v in zip(sl.tolist(), team.tolist(), vis.tolist()):
            sp.set_aoi_team(sp._slot_entity[s], t_, v)
    stacks = [sp.interest_stack for sp in spaces_l]
    kernel = IC.interest_step
    if plain:
        IC.interest_step = IC.interest_step_plain
    # the stack step's parts: upload, kernel (or the plain twin's step),
    # the two planes' fetch (CUDA events), the whole step and its
    # evaluation (host clock; the rest of the step is the host diff)
    timers = [DeviceTimer(D, "_upload"), DeviceTimer(IC, "interest_step"),
              DeviceTimer(D, "words_to_numpy"),
              HostTimer(TI.PolicyStack, "step"), HostTimer(D, "eval_step")]
    IC.reset_launches()
    tick_crcs = []
    tick_s = 0.0
    try:
        for t in range(ticks):
            if t == ticks - measured:
                perf0 = dict(bucket_of(rt).perf)
                torch.cuda.synchronize()
                for tm in timers:
                    tm.on = True
            if t:
                walk(spaces_l, slots, pos, rng)
            crc["t"] = crc["te"] = 0
            t0 = time.perf_counter()
            rt.tick()
            torch.cuda.synchronize()
            if t >= ticks - measured:
                tick_s += time.perf_counter() - t0
            tick_crcs.append((f"{crc['t']:08x}", crc["te"]))
        for tm in timers:
            tm.on = False
        trailing = 0
        while rt.aoi.has_pending():  # a deferred bucket's last tick
            rt.aoi.flush()
            for sp in spaces_l:
                trailing += sum(len(a) for a in rt.aoi.take_events(
                    sp._aoi_handle))
    finally:
        for tm in reversed(timers):
            tm.restore()
        IC.interest_step = kernel
    launches = IC.launches["interest_step"]
    for s in stacks:
        check(s.stats["demotions"] == 0 and s.stats["host_steps"] == 0,
              f"{label}: stack stats {s.stats}")
    healthy(bucket_of(rt).stats, label)
    out = {"label": label, "ticks": ticks, "crcs": tick_crcs,
           "stream_crc": f"{crc['v']:08x}", "events": crc["events"],
           "trailing_events": trailing, "launches": launches,
           "words": [s.words.copy() for s in stacks],
           "full_evals": sum(s.stats["full_evals"] for s in stacks),
           "los_pair_evals": sum(s.stats["los_pair_evals"] for s in stacks)}
    if measured:
        b = bucket_of(rt)
        h2d, kern, d2h, step, ev = timers
        plane = capacity * (capacity // 32) * 4
        out["split"] = {
            "tick_ms": tick_s * 1e3 / measured,
            **{k[:-2] + "_ms": (b.perf[k] - perf0[k]) * 1e3 / measured
               for k in b.perf},
            "stack_step_ms": step.s * 1e3 / measured,
            "stack_eval_ms": ev.s * 1e3 / measured,
            "stack_diff_ms": (step.s - ev.s) * 1e3 / measured,
            "h2d_ms": h2d.ms() / measured, "kernel_ms": kern.ms() / measured,
            "d2h_ms": d2h.ms() / measured,
            "h2d_bytes_per_step": capacity * (3 * 4 + 1 + 2 * 4) + 2 * plane
            + field.grid.nbytes,
            "d2h_bytes_per_step": 2 * plane,
            "steps_per_tick": len(kern.events) / measured}
    log(label, json.dumps({k: v for k, v in out.items()
                           if k not in ("words", "crcs")}))
    return out


def phase_interest_slice(Runtime, IC, TI, D):
    """Phase 18b: phase 4's world with a team + tier(4) + LOS(2) stack on
    every space, a prime tick, 3 warm-up and 12 measured ticks (three
    full periods): the kernel run against a twin whose stack step calls
    the plain version on the card (per-tick event CRCs, final words),
    a cut run against aoi_interest="host", and the pipelined Runtime
    (stack events undeferred: equal per tick, trailing flushes empty)."""
    ticks = 1 + INTEREST_WARMUP + INTEREST_MEASURED
    runs = {}
    for name, kw in (("kernel", {}), ("plain twin", {"plain": True}),
                     ("pipelined", {"aoi_pipeline": True})):
        runs[name] = interest_run(
            Runtime, TI, IC, D, f"phase 18b {name}", SPACES, PER_SPACE,
            CAPACITY, ticks, measured=INTEREST_MEASURED, **kw)
    k = runs["kernel"]
    check(k["launches"] == SPACES * ticks,
          f"phase 18b: {k['launches']} kernel launches, want "
          f"{SPACES * ticks}")
    check(runs["plain twin"]["launches"] == 0,
          "phase 18b: the plain twin launched the kernel")
    check(runs["pipelined"]["launches"] == SPACES * ticks,
          "phase 18b pipelined: kernel launches")
    check(k["events"] > 0, "phase 18b: no stack event")
    for name in ("plain twin", "pipelined"):
        r = runs[name]
        check(r["crcs"] == k["crcs"], f"phase 18b {name}: per-tick stack "
              f"CRCs {r['crcs']} != the kernel run's {k['crcs']}")
        check(r["stream_crc"] == k["stream_crc"],
              f"phase 18b {name}: stream CRC")
        check(r["trailing_events"] == 0,
              f"phase 18b {name}: trailing flushes delivered stack events")
        check(all(np.array_equal(a, b) for a, b in zip(r["words"],
                                                       k["words"])),
              f"phase 18b {name}: final words differ")
    s, n, cap, t = INTEREST_CUT
    cut = {m: interest_run(Runtime, TI, IC, D, f"phase 18b cut {m}", s, n,
                           cap, t, aoi_interest=m)
           for m in ("device", "host")}
    check(cut["device"]["launches"] == s * t and
          cut["host"]["launches"] == 0, "phase 18b cut: launches")
    check(cut["device"]["crcs"] == cut["host"]["crcs"] and all(
        np.array_equal(a, b) for a, b in zip(cut["device"]["words"],
                                             cut["host"]["words"])),
          "phase 18b cut: device != host mode")
    out = {"spaces": SPACES, "entities_per_space": PER_SPACE,
           "capacity": CAPACITY, "ticks": ticks,
           "measured": INTEREST_MEASURED,
           "policies": f"team + tier(period {INTEREST_PERIOD}) + "
                       f"LOS(depth {INTEREST_DEPTH})",
           "field_boxes": INTEREST_BOXES, "field_cell": INTEREST_CELL,
           "events": k["events"], "stream_crc": k["stream_crc"],
           "full_evals": k["full_evals"],
           "los_pair_evals": k["los_pair_evals"],
           "splits": {name: r["split"] for name, r in runs.items()},
           "launches": {"sequential": k["launches"],
                        "pipelined": runs["pipelined"]["launches"],
                        "cut": cut["device"]["launches"]},
           "cut_crc": cut["device"]["stream_crc"]}
    log("phase 18b", json.dumps(out))
    return out


def phase_load(TL, TI, IC):
    """Phase 18c: the load harness at loadgen_smoke's and engine_load's
    configurations, stacks on the card over the cpu and the cuda base
    calculators, each against a host-mode run of the same harness (the
    stacks' words do not depend on the base calculator)."""
    out, launches = {}, 0
    for name, (n, spaces, gates, period, seed) in LOAD_CONFIGS.items():
        runs = {}
        for backend, mode in (("cpu", "device"), ("cuda", "device"),
                              ("cuda", "host")):
            label = f"phase 18c {name} {backend} {mode}"
            t0 = time.perf_counter()
            hz = TL.LoadHarness(n, n_spaces=spaces, n_gates=gates,
                                period=period, seed=seed, device="cuda",
                                aoi_backend=backend, interest_mode=mode)
            build_s = time.perf_counter() - t0
            hz.run(LOAD_WARMUP)
            IC.reset_launches()
            step = HostTimer(TI.PolicyStack, "step")
            step.on = True
            try:
                rep = hz.run(LOAD_TICKS)
                torch.cuda.synchronize()
            finally:
                step.restore()
            n_launch = IC.launches["interest_step"]
            stack_s = step.s
            ing = rep["ingest"]
            check(ing["per_entity_writes"] == 0 and rep["unclosed"] == 0
                  and rep["interest"]["demotions"] == 0,
                  f"{label}: {ing} unclosed {rep['unclosed']} "
                  f"{rep['interest']}")
            check(rep["records"] == n * LOAD_TICKS, f"{label}: records")
            want = spaces * LOAD_TICKS if mode == "device" else 0
            check(n_launch == want, f"{label}: {n_launch} launches, want "
                  f"{want}")
            runs[(backend, mode)] = (hz, rep)
            row = {"build_s": build_s, "moves_per_s": rep["moves_per_s"],
                   "ms_per_tick": rep["wall_s"] * 1e3 / LOAD_TICKS,
                   "stack_share": stack_s / rep["wall_s"],
                   "tiers": rep["tiers"], "launches": n_launch,
                   "interest": rep["interest"]}
            out[f"{name} {backend} {mode}"] = row
            log(label, json.dumps(row))
            launches += n_launch
        host, _ = runs[("cuda", "host")]
        for key in (("cpu", "device"), ("cuda", "device")):
            hz, rep = runs[key]
            check(rep["interest"] == runs[("cuda", "host")][1]["interest"],
                  f"phase 18c {name} {key}: stack stats != host mode's")
            check(all(np.array_equal(a.interest_stack.words,
                                     b.interest_stack.words)
                      for a, b in zip(hz.spaces, host.spaces)),
                  f"phase 18c {name} {key}: final words != host mode's")
        del runs, host, hz
    return {"runs": out, "launches": launches}


def interest_entry(interest_k, interest_slice, load_out):
    """The ``kernels`` line's entry of csrc/interest_step.cu: its times
    at the main path's full team + tier + LOS step (C = 16384), the off
    step beside them, its launches on each path."""
    rows = interest_k["rows"]
    full = next(r for r in rows if r["step"] == "full"
                and r["combo"] == "team+tier+los")
    off = next(r for r in rows if r["step"] == "off")
    paths = {**interest_slice["launches"], "load": load_out["launches"]}
    return {"name": "interest_step", "route": "cuda",
            "source": "goworld_tpu_torch/csrc/interest_step.cu",
            "replaces": "goworld_tpu/interest/device.py:32",
            "launches": sum(paths.values()), "max_abs_err": 0,
            "ms": full["ms"], "plain_ms": full["plain_ms"],
            "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
            "library_ms": None, "shape": full["shape"],
            "off_step": {k: off[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by")},
            "main_path_kernel_ms": interest_slice["splits"]["kernel"][
                "kernel_ms"],
            "path_launches": paths, "cases": interest_k["cases"],
            "shapes": rows}


def main():
    if not torch.cuda.is_available():
        log("chip_smoke: torch sees no CUDA device")
        return 2
    from goworld_tpu_torch.engine.aoi import AOIEngine
    from goworld_tpu_torch import interest as TI
    from goworld_tpu_torch import load as TL
    from goworld_tpu_torch.engine.runtime import Runtime
    from goworld_tpu_torch.interest import device as D
    from goworld_tpu_torch.ops import _build
    from goworld_tpu_torch.ops import aoi_cuda as AK
    from goworld_tpu_torch.ops import aoi_pages as PG
    from goworld_tpu_torch.ops import aoi_dense as AD
    from goworld_tpu_torch.ops import aoi_grid as AG
    from goworld_tpu_torch.ops import cadence as CD
    from goworld_tpu_torch.ops import dispatch_count as DC
    from goworld_tpu_torch.ops import events as EV
    from goworld_tpu_torch.ops import interest_cuda as IC
    from goworld_tpu_torch.ops import interest_kernels as K
    from goworld_tpu_torch.parallel import SpaceMesh, make_sharded_aoi_step

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    log("torch", torch.__version__, "cuda", torch.version.cuda, "card", card)
    t0 = time.perf_counter()
    _build.build_all(force=True)
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, text in _build.build_log.items():
        log(f"--- {name}.cu\n{text.strip()}")
    per_pair = sass_per_pair(_build)
    log("SASS instructions per pair test", json.dumps(per_pair))
    interest_pp = interest_sass_per_pair(_build)
    log("interest_step SASS per pair", json.dumps(interest_pp))

    rows = phase_kernels(AK, AD)
    main_out, main_crcs = phase_main(Runtime, AK, AD, EV)
    phase_parity(Runtime)
    pipelined = phase_pipeline(Runtime, AK, DC, main_crcs, main_out)
    fused = phase_fused(Runtime, AK, DC)
    sub_change = phase_sub_change(Runtime)
    faults_out = phase_faults(Runtime, AK)
    sharded_faults = phase_sharded_faults(Runtime, AK, SpaceMesh)
    routing = phase_routing(Runtime, AK)
    paged = phase_paged(Runtime, AK, DC, PG, main_out, main_crcs, fused)
    clustered = phase_clustered(AOIEngine, AK)
    pages_seam = phase_pages_seam(Runtime, AK)
    rect_rows = phase_rect(AK, AD)
    culled_rows = phase_culled(AG, AK)
    phase_plans(AK, AG, AD)
    AG.reset_launches()  # phase 7 is the culled kernels' path
    grid_out = [phase_grid(AG, CD, name) for name in GIANT]
    culled_launches = dict(AG.launches)
    AK.reset_launches()  # phase 8 is the rectangular step's path
    share_out = phase_share(AK, AD, CD)
    rect_launches = AK.launches["aoi_step"]
    entlv_rows = phase_entlv(AK, AD)
    AK.reset_launches()  # phase 10 is the entlv mode's path
    sharded = phase_sharded_step(AK, AD, EV, SpaceMesh,
                                 make_sharded_aoi_step)
    entlv_launches = AK.launches["aoi_step_entlv"]
    engine_mesh = phase_engine_mesh(Runtime, AOIEngine, AK, AD, SpaceMesh)
    rowshard = phase_rowshard(AOIEngine, AK, SpaceMesh)
    paged_sharded = phase_paged_sharded(AOIEngine, AK, SpaceMesh,
                                        engine_mesh, rowshard)
    torch.cuda.empty_cache()
    interest_k = phase_interest_kernel(IC, K, TI)
    interest_slice = phase_interest_slice(Runtime, IC, TI, D)
    load_out = phase_load(TL, TI, IC)
    paged_l = (paged["launches"] + clustered["launches"]
               + pages_seam["launches"])
    paged_mesh_l = paged_sharded["launches"]["aoi_step"]
    paged_row_l = paged_sharded["launches"]["aoi_step rect"]
    for name, n in (*culled_launches.items(), ("aoi_step rect",
                                               rect_launches),
                    ("aoi_step_entlv", entlv_launches),
                    ("aoi_step deferred", pipelined["launches"]),
                    ("aoi_step fused replays", fused["replays"]),
                    ("aoi_step faults", faults_out["launches"]),
                    *((f"aoi_step faults {k} {m}", r["launches"])
                      for k, v in sharded_faults.items()
                      for m, r in v.items()),
                    ("aoi_step routing", routing["launches"]),
                    ("aoi_step paged", paged_l),
                    ("aoi_step paged mesh", paged_mesh_l),
                    ("aoi_step rect paged rowshard", paged_row_l),
                    *((f"interest_step {k}", v) for k, v in
                      interest_slice["launches"].items()),
                    ("interest_step load", load_out["launches"])):
        check(n > 0, f"{name}: no launch on its path")

    def entry(name, replaces, launches, shape_rows, shape, **extra):
        at = next(r for r in shape_rows if tuple(r["shape"]) == shape)
        return {"name": name, "route": "cuda",
                "source": "goworld_tpu_torch/csrc/" + (
                    "aoi_grid.cu" if "culled" in name else "aoi_step.cu"),
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in shape_rows),
                "ms": at["ms"], "plain_ms": at["plain_ms"],
                "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
                "library_ms": None, "shape": list(shape), **extra,
                "shapes": shape_rows}

    grid_ms = {g["config"]: g["kernel_ms"] for g in grid_out}
    words_full = next(r for r in culled_rows["aoi_words_culled"]
                      if tuple(r["shape"]) == (64, 16384))
    entlv_path_ms = {m["mesh"]: m["ticks"][1]["kernel_ms"]
                     for m in sharded["meshes"]}
    mesh_fault_l = sum(r["launches"] for r in sharded_faults["mesh"].values())
    row_fault_l = sum(r["launches"]
                      for r in sharded_faults["rowshard"].values())
    kernels = {"kernels": [
        entry("aoi_step", "goworld_tpu/ops/aoi_pallas.py:176",
              main_out["kernel_launches"] + pipelined["launches"]
              + fused["launches"] + faults_out["launches"] + mesh_fault_l
              + routing["launches"] + paged_l + paged_mesh_l, rows,
              MAIN_SHAPE,
              main_path_ms=main_out["kernel_ms"],
              path_launches={"main": main_out["kernel_launches"],
                             "deferred": pipelined["launches"],
                             "fused": fused["launches"],
                             "fused_replays": fused["replays"],
                             "faults": faults_out["launches"],
                             "faults_mesh": mesh_fault_l,
                             "routing": routing["launches"],
                             "paged": paged_l,
                             "paged_mesh": paged_mesh_l}),
        entry("aoi_step_rect", "goworld_tpu/ops/aoi_pallas.py:176",
              rect_launches + row_fault_l + paged_row_l, rect_rows,
              RECT_PATH_SHAPE, main_path_ms=share_out["kernel_ms"],
              path_launches={"share": rect_launches,
                             "faults_rowshard": row_fault_l,
                             "paged_rowshard": paged_row_l}),
        entry("aoi_words_culled", "goworld_tpu/ops/aoi_grid.py:192",
              culled_launches["aoi_words_culled"],
              culled_rows["aoi_words_culled"], (64, 16384),
              main_path_ms={g["config"]: g["resort_words_kernel_ms"]
                            for g in grid_out},
              main_path_launch_ms={g["config"]: g["resort_words_launch_ms"]
                                   for g in grid_out},
              fill_ms=words_full["words_yardstick"]["fill_ms"]),
        entry("aoi_step_culled", "goworld_tpu/ops/aoi_grid.py:235",
              culled_launches["aoi_step_culled"],
              culled_rows["aoi_step_culled"], (64, 16384),
              main_path_ms=grid_ms),
        entry("aoi_step_entlv", "goworld_tpu/ops/aoi_pallas.py:176",
              entlv_launches, entlv_rows, ENTLV_PATH_SHAPE,
              main_path_ms=entlv_path_ms),
        interest_entry(interest_k, interest_slice, load_out)]}
    issue = {"issue_floor": [
        issue_floors("aoi_step", rows, per_pair["aoi_step"]),
        issue_floors("aoi_step_rect", rect_rows, per_pair["aoi_step"]),
        *(issue_floors(name, culled_rows[name], per_pair[name])
          for name in ("aoi_words_culled", "aoi_step_culled")),
        issue_floors("aoi_step_entlv", entlv_rows,
                     per_pair["aoi_step_entlv"]),
        *(issue_floors(f"interest_step {k}",
                       [r for r in interest_k["rows"]
                        if r["step"] == k and r["combo"] == "team+tier+los"],
                       interest_pp[k]) for k in INTEREST_SASS)]}
    print(card)
    print(json.dumps({"main_path": main_out}))
    print(json.dumps({"giant": grid_out + [share_out]}))
    print(json.dumps({"deferred": {"pipelined": pipelined["summary"],
                                   "fused": fused["summary"],
                                   "sub_change": {k: v for k, v in
                                                  sub_change.items()
                                                  if k != "rows"},
                                   "fused_runs": [
                                       {k: r[k] for k in (
                                           "mode", "captures", "graphs",
                                           "graph_pool_bytes",
                                           "reserved_bytes", "caps")}
                                       for r in fused["runs"]]}}))
    print(json.dumps({"faults": faults_out, "sharded_faults": sharded_faults,
                      "routing": routing}))
    print(json.dumps({"paged": {
        "main_path": paged["summary"], "clustered": clustered,
        "sharded": paged_sharded, "pages_seam": pages_seam}}))
    print(json.dumps({"mesh": {
        "note": "virtual shards are shards of one card taking turns; "
                "their times are one card's",
        "sharded_step": sharded, "engine": engine_mesh,
        "rowshard": rowshard}}))
    print(json.dumps({"interest": {
        "kernel": interest_k, "slice": interest_slice,
        "load": load_out["runs"]}}))
    print(json.dumps(issue))
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
