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
                resident grid and many more), timed with CUDA events; the
                square step also under random row masks (stg / sub, the
                fused tick's) against ops/aoi_cuda.row_masks_plain;
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
                sequential Runtime (each once): the sequential per-tick
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
 15. faults  -- phase 4's widths at 1 of its spaces (each host-recovered
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
 15b. sharded faults -- the same plan on the mesh bucket (1 space on 4
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
 17d. pages seam -- phase 15's space, paged, under aoi.pages oom at
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
                stack step over resident word planes) against its plain
                version (ops/interest_cuda.interest_step_plain) on the
                card, bit for bit: the planes after the step in place,
                the changed-word counts, and the changed-word lists as
                sets (each entry a distinct changed word with its new
                value; the plain version's too); the six policy mixes
                of tests/test_interest.py, full and off-cadence steps,
                LOS depths 1-4, at C = 128, 256 and 384 on edge inputs
                (0.0 / -0.0, subnormals, NaN, +-inf, infinite and NaN
                radii, ties at r * near_frac and at rn * hysteresis,
                samples outside the world, team bit 31, inactive slots,
                a NaN midpoint) and at C = 16384 on phase 18b's world,
                from random planes and from a path step's planes;
                forced list overflows (caps 0, 5 and 4096); CUDA-event
                times from both kinds of planes, bounds (the LOS samples
                and changed words this run's inputs need) and SASS per
                pair;
 18b. interest slice -- phase 4's world with team + tier(period 4) +
                LOS(depth 2, five boxes baked at 100-unit cells) on every
                space, team/vis seeded as tests/test_interest.py's _walk;
                a prime tick, 3 warm-up and 12 measured: per-tick stack
                event CRCs and final words equal a twin whose step runs
                the plain version on the card and the pipelined Runtime
                (the stack steps in the flush that submitted it: no
                shift; trailing flushes deliver nothing), the stream CRC
                INTEREST_CRC (this world's fixed answer); a cut run (2 x
                2048, 6 ticks) equal to aoi_interest="host"; the resident
                planes equal the host planes after the run, no plane
                upload and no list overflow; tick_ms and its split (base stage /
                fetch / decode / emit; a stack step's columns up, kernel,
                count and list fetch, host apply, expand; bytes each way
                and changed words a step);
 18c. load harness -- LoadHarness at scripts/loadgen_smoke.py's
                configuration (100,000 clients, 256 spaces, 8 gates,
                period 4) and bench.py bench_engine_load's (8192 clients,
                8 spaces, 4 gates), a 4-tick warm-up then 5 ticks, over
                the cpu and the cuda base calculators: moves/s, ms a
                tick, near/far p50/p99, the stack step's share and its
                split as in 18b; no per-entity write, no unclosed update,
                no demotion, no plane upload, no list overflow; every
                space's final words equal a host-mode run's.
 19. migration -- phase 4's world as AOIEngine spaces on the card's
                single-device bucket (an engine with a mesh of 4 virtual
                shards), space 0 with phase 18b's stack, 19 ticks of a
                seeded walk; live migrations one after another: space 0
                cuda -> cpp -> cuda, space 1 to the mesh, space 2 to the
                row-sharded tier (16384 = 32 x 4 x 128), space 3 re-homed
                on its own tier; pipeline off and on (lag deltas -1, 0,
                +1), each against the same walk unmoved: every space's
                enter and leave streams equal, each tick's CRC equal where
                the cadence held (and for the stacked space); every move
                done, none rolled back; export, replay, cover flushes,
                swap and migration ms, snapshot bytes, cover ticks beside
                steady ticks;
 19b. evacuation -- aoi.device:reset at the 4th dispatch of 2 of phase
                4's spaces on the single-device bucket and on the mesh
                bucket (4 virtual shards; the faulted tick is recovered on
                the host, about 4 s a space): per-tick CRCs equal the
                fault-free run's, one evacuation, every space on one fresh
                bucket at calc level 0 whose kernel launches every later
                tick; the aoi.evacuate ms and the three ticks after it;
 19c. checkpoints -- Runtime(aoi_checkpoint="continuous") at 2 of phase
                4's spaces (space 0 stacked) into a temporary directory,
                16 ticks, then 8 more with their inputs recorded; every
                space restored into a fresh AOIEngine on the card
                (restore_into; the stack's payload through
                attach_interest) and fed them: per-tick CRCs equal the
                uninterrupted run's; capture ms a tick, record bytes
                (base, delta), the writer's lag in ticks, restore ms a
                space; then crash_restart_scenario on the card at its
                default size (kill -9, restore, events_lost == 0).
 20. cohorts -- bench.py's bench_engine_multispace shard (256 spaces x
                96 entities, capacity 128, ladder (256,), world 1000, r
                100, 10% movers up to 15, 3 warm-up + 5 measured ticks)
                through AOIEngine(cohort="auto", fused), cohort="solo"
                (fused) and the cpu backend: per-tick CRCs equal, 1
                dispatch a tick against 256, no new capture key after
                warm-up, the solo buckets (and their device memory) freed
                with their spaces; ms a tick, the cohort bucket's stage /
                fetch / decode / emit split, captures and graph-pool
                bytes; then the shard through Runtime(aoi_cohort=True,
                aoi_fused=True) with a quarter of the spaces quiet each
                tick: CRCs the cpu backend's Runtime's, 1 dispatch a
                steady tick (the staged-row mask of ops/fused.py);
 20b. ladder -- 192 spaces, capacities uniform in [96, 4000], 75% full,
                world side 1000 * sqrt(n / 96): the cohort engine (3
                buckets, one a rung of 256/1024/4096), the classic pooling
                (a bucket a rounded capacity), the cohort paged, all
                fused, and the cpp backend: equal CRCs, dispatches and ms
                a tick;
 20c. demotion -- scripts/multispace_smoke.py's 24 spaces on rung 256:
                aoi.cohort fail, oom and reset at the seam's 4th crossing,
                split-phase and sequential flush: the cohort demotes in
                that tick (24 spaces onto solo buckets), recohort()
                stacks them back, CRCs the fault-free run's; then
                CohortPlanner(mode="auto") sheds a member a window under
                a tiny hot_ms and folds them back under a large one;
 14c. fused graph -- the device ms of one replay of ops/fused.FusedTri at
                phase 4's shape under a 10% walk (CUDA events), every row
                staged and a quarter of the rows quiet (the staged-row
                mask in the kernel's store);
 20d. rung shapes -- every (S, C) at which phases 20-20c launched the
                square step (recorded by a spy on ops/aoi_cuda._launch
                that leaves the counts alone: the grown cohort grids, the
                solo and classic buckets), the kernel against its plain
                version there, bit-exact, unmasked and under random row
                masks; ms (masked with all-ones masks where the path
                launched it masked), plain ms and the bound;
 21. telemetry -- phase 4's world and schedule with Runtime(
                telemetry_on=True) and off, in turns: CRCs phase 4's,
                tick ms on and off, the tick's spans present and nested in
                the Chrome export, render_prometheus() parsed with the
                aoi.* families of phase 20's live cohort engine.
 22. game server -- phase 4's world as one GameService's spaces: of each
                space's 10,000 entities 32 are client avatars (256 in
                all), joined and walking in one 150 x 150 patch, 9,968
                NPCs that walk every 100 ms (a game timer, through
                Space.move_entities).  (a) The game with its
                DispatcherCluster a recorder, driven by step() through
                a script of inbound packets (connects, joins, a move
                batch a tick, an attr RPC, a disconnect; ids from one
                counter), on aoi_backend="cuda" (the card) and "cpp":
                every tick's outbound payloads equal (sorted, as the
                engine walks sets in hash order), its event CRC equal;
                step()'s split (inbound, Runtime.tick with a CUDA sync,
                outbox, position syncs, flush).  (b) Live over TCP: the
                port's dispatcher and gate as child processes (python
                -m, from an ini, ready on gwlog.READY_TAG), the game on
                its logic thread here, 256 bot clients
                (client.GameClientConnection) in 4 more children (two
                spaces' clients each: one process saturated); 5 s of
                warm-up, 30 s of steady traffic: ticks run against ticks
                due at 5 ms, the loop's split, launches, the clients'
                move latency (A's send_position to B's mirror update)
                and its legs (send to ingest, ingest to sync, sync to
                mirror; time.monotonic, one clock for the host), the
                gate's wire each way at the clients' sockets, each
                process's CPU seconds; once the clients' last moves are
                ingested and the wire is quiet, every client's
                mirror set equals its avatar's row of the device words
                and of the plain interest_matrix over the staged
                columns; no fault counter or decode_overflow moved, no
                logged tick error; the children exit 0.
 23. deployed game -- (a) python -m goworld_tpu_torch.cli build and
                start: a dispatcher, a game (components/game/__main__:
                aoi_backend and aoi_device cuda, sqlite storage, kvdb on
                a miniredis served here, interval checkpoints, telemetry
                on its http_port, the default 5 ms tick interval) and a
                gate, each one's readiness timed; the game script is
                the port's unity_demo twin with phase 4's world filled
                in (8 spaces of 16384 slots, 9,968 monsters each walking
                every 100 ms); 64 strict bots
                of the port's test_client (one process, 30 s: all OK,
                visibility checks > 0, their latency profile); a keeper
                client names itself and writes a kvdb key through the
                facade; cli reload (SIGHUP: freeze, restart with
                -restore on the card; its wall time and the freeze
                file's bytes) with the keeper connected, whoami answers
                its name; the game's /debug/metrics before and after the
                reload show ticks at calc level 0 and the step kernel's
                launches and dispatches (ops/aoi_cuda's collector);
                capture ms from its /debug/trace; cli stop; here the
                sqlite backend holds the keeper's record, the redis kvdb
                its key, and every checkpointed space restores onto the
                card (restore_into, no torn record) with its words equal
                to the plain words of its restored inputs.  (b)
                engine/failover.host_failover_scenario at 16384 slots and
                world 4000, two --tier cuda workers, worker 1 SIGKILLed
                at tick 24: events_lost == 0, every parity flag, the
                survivor's restore ms and launches, ticks_to_recover and
                the dispatcher's clu.* counters.

Phases 13-17b and 17d run after phase 5, 17c after phase 12, 18-18c
then 19-19c, then 20-21, 20d and 14c, then 22, and 23 last.  Every
fault-free phase checks that it
ended at calc level 0 with no recovery and the resolved emit mode.
Virtual shards are shards of one card taking turns on it: their times
are one card's, not a multi-card layout's.  The last lines are
{"main_path": ...}, {"giant": ...}, {"deferred": ...} (phases 13-14b),
{"faults": ..., "sharded_faults": ..., "routing": ...} (phases 15-16),
{"paged": ...} (phases 17-17d), {"mesh": ...}, {"interest": ...} (phases
18-18c), {"migration": ...} (phases 19-19c), {"cohort": ...} (phases
20-20c), {"telemetry": ...} (phase 21), {"game": ...} (phase 22),
{"deploy": ...} (phase 23),
{"issue_floor": [...]} (each kernel's SASS instructions
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
phase 18b (sequential, pipelined, the cut run) and in phase 18c; phase
19 (its four runs) adds to the square step, its row-sharded target to
the rectangular one and its stacked space to the stack step, phases 19b
and 19c to the square step (19c's stacked space to the stack step),
phases 20-20c (each run: a cohort bucket's replay steps hundreds of
spaces in one launch) and 21 to the square step, phase 22 (22a's
card run, 22b's steady window) to the square step, and phase 23's child
processes too: 23a's game (its two processes around the reload, each
count read from its /debug/metrics just before the reload and just
before cli stop; a fresh process counts from 0) and 23b's surviving
worker (written at its clean exit).
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

# (2, 1056) and (3, 96): the persistent tile's edges (W = 33 with R % 64
# = 32; W = 3 and S above one SM's blocks); the last three: a cohort of
# each rung's size (phase 20d checks the shapes the cohort phases launch)
KERNEL_SHAPES = [(1, 128), (3, 384), (8, 4096), (8, 16384), (64, 16384),
                 (2, 1056), (3, 96), (256, 256), (192, 1024), (64, 4096)]
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


def word_diff(a, b):
    """Max |a - b| over two int32 word arrays (0: bit-exact)."""
    if torch.equal(a, b):
        return 0
    return int((a.long() - b.long()).abs().max())


def row_masks(s, seed):
    """Random per-space row masks (int32 [S] of 1 or 0) on the card: the
    staged rows ``stg`` and the subscribed rows ``sub``."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.random(s) < p).astype(np.int32)).to(DEV)
            for p in (0.6, 0.7)]


def masked_err(AK, x, z, r, act, prev, new_p, chg_p, seed):
    """The square step under random row masks against the plain step's
    ``new_p`` / ``chg_p`` (masked in place by row_masks_plain)."""
    stg, sub = row_masks(x.shape[0], seed)
    new_m, chg_m = AK.aoi_step_chg_cuda(x, z, r, act, prev, stg=stg,
                                        sub=sub)
    AK.row_masks_plain(prev, new_p, chg_p, stg, sub)
    return max(word_diff(new_m, new_p), word_diff(chg_m, chg_p))


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
SASS_KERNELS = {"aoi_step": ("aoi_step",
                             "aoi_step_kernelILN8aoi_tile4EmitE0ELb0E", True),
                "aoi_step_masked": ("aoi_step",
                                    "aoi_step_kernelILN8aoi_tile4EmitE0ELb1E",
                                    True),
                "aoi_step_entlv": ("aoi_step",
                                   "aoi_step_kernelILN8aoi_tile4EmitE1ELb0E",
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
        err = max(word_diff(new_k, new_p), word_diff(chg_k, chg_p))
        del new_k, chg_k
        err = max(err, masked_err(AK, x, z, r, act, prev, new_p, chg_p,
                                  seed=200 + i))
        check(err == 0,
              f"aoi_step kernel != plain at S={s} C={c} (max |diff| {err})")
        del new_p, chg_p
        reps = 20 if c >= 16384 else 100
        ms = cuda_ms(lambda: AK.aoi_step_chg_cuda(x, z, r, act, prev),
                     reps=reps)
        read_sm_clock()  # just after the kernel's timing, under load
        ones = torch.ones(s, dtype=torch.int32, device=DEV)
        masked_ms = cuda_ms(lambda: AK.aoi_step_chg_cuda(
            x, z, r, act, prev, stg=ones, sub=ones), reps=reps)
        plain_ms = cuda_ms(lambda: AD.aoi_step_chg_dense(x, z, r, act, prev),
                           reps=1 if s * c >= 64 * 16384 else 3, warm=1)
        bound_ms, bound_by = aoi_step_bound(s, c)
        n_sms, bps = AK.occupancy("aoi_step", "gw_aoi_step_occupancy", 0,
                                  torch.device(DEV))
        plan = AK.last_plan["aoi_step"]  # what the timed launches walked
        units.append(plan.units / (n_sms * bps))
        row = {"shape": [s, c], "ms": ms, "masked_ms": masked_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "max_abs_err": err}
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
                extra=None, setup=None, world=WORLD, **rt_kw):
    """``spaces`` spaces of ``per_space`` entities (world side ``world``)
    on ``Runtime(device=device, **rt_kw)``, and with ``extra`` =
    (capacity, entities, world) one more space after them;
    ``setup(space)`` runs on each space after ``enable_aoi``, before its
    entities enter."""
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
    layout = [(capacity, per_space, world)] * spaces
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
# full walk); the modes in turns, each once (twice, in mirrored order,
# until the script neared its time limit with phase 23)
PIPE_TURNS = ["sequential", "pipeline", "cross_tick", "both"]
PIPE_SCHEDULE = [None] + [1.0] * (WARMUP + MEASURED)
# phase 14: a prime tick, then bench.py's movers_frac=0.1 walk with one
# r-change tick and one tick where every entity moves (both restage in
# full: the unfused flow), then warm-up ticks until the triple cap has
# settled; measured from FUSED_MEASURE_FROM on; each mode once (twice
# before phase 23, as PIPE_TURNS)
FUSED_TURNS = ["unfused", "fused", "fused+cross_tick"]
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

# phase 15: phase 4's widths with 1 of its 8 spaces (each host-recovered
# tick is the numpy predicate, about 4 s a space: cut from 2 spaces to
# keep the script inside its time limit); the plan of
# scripts/faults_smoke.py, then (added while the run goes, at the seam's
# next crossing) a second kernel failure and an emit failure
FAULT_SPACES = 1
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
    """Phase 15: phase 4's widths at 1 space through FAULT_PLAN and the
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
# phase 17d: the aoi.pages seam at phase 15's space, a prime tick and
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
    7) at phase 15's space, sequential, on the card and on the CPU
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
INTEREST_CRC = "0e8cf24e"  # phase 18b's stack stream over its 16 ticks
# f32 operations: a pair test (2 sub, 2 abs, 2 compares), the tier's 4
# compares, one line-of-sight sample (midpoint 2 add + 2 mul; cell 2 sub
# + 2 mul + 2 floor + 4 min/max; 1 compare)
INTEREST_OPS_PAIR, INTEREST_OPS_TIER, INTEREST_OPS_SAMPLE = 6, 4, 15
# the kernel instantiations whose SASS per pair phase 18 counts, and the
# FSETP a pair of each (radius and the tier's two thresholds)
INTEREST_SASS = {"off": ("interest_step_kernelILb1ELb1ELb0ELb0EE", 3),
                 "full": ("interest_step_kernelILb1ELb1ELb1ELb1EE", 3)}
# phase 18c: scripts/loadgen_smoke.py's and bench.py bench_engine_load's
# harnesses (clients, spaces, gates, period, seed), a 4-tick warm-up then
# 5 ticks (a period + 1: the last tick a full step; 9 before the script
# passed 1,050 s with phase 23)
LOAD_CONFIGS = {"loadgen_smoke": (100_000, 256, 8, 4, 11),
                "engine_load": (8192, 8, 4, 4, 29)}
LOAD_WARMUP, LOAD_TICKS = 4, 5


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


def interest_pairs(K, args, cfg):
    """(gated, far): the pairs whose gate (both active, not self, the team
    mask) is set -- those a step must test -- and of them those whose base
    bit is set and whose near bit is not (those a full LOS step samples),
    counted in row blocks."""
    x, z, r, act, team, vis, _, prev_near = args
    c = x.shape[0]
    gated = far = 0
    for lo in range(0, c, 1024):
        rows = (lo, min(c, lo + 1024))
        gate = K.pair_gate(act, torch, rows)
        if cfg.has_team:
            gate = gate & K.team_mask(team, vis, torch, rows)
        gated += int(gate.sum())
        base = K.base_mask(x, z, r, gate, torch, rows)
        if cfg.has_tier:
            pn = K.unpack_words(prev_near[rows[0]:rows[1]], c, torch)
            near = K.near_mask(K.chebyshev(x, z, torch, rows), r, pn, gate,
                               cfg.near_frac, cfg.hysteresis, torch, rows)
            base = base & ~near
        far += int(base.sum())
    return gated, far


def interest_bound(K, args, cfg, full, grid, changed):
    """(bound_ms, bound_by, samples) for one step: the bytes it must move
    (the columns; both planes read, for the change; each of the
    ``changed`` words written in place and as a list entry; the counts;
    the field on a LOS step) over the memory rate; its f32 operations
    (radius and tier compares over the gated pairs, the LOS samples of
    this run's inputs) over the f32 rate."""
    c = args[0].shape[0]
    plane = c * (c // 32) * 4
    los = cfg.has_los and full
    nbytes = c * (3 * 4 + 1 + 2 * 4) + 2 * plane + (4 + 8) * changed + 8
    gated, far = interest_pairs(K, args, cfg)
    samples = 0
    if los:
        nbytes += grid.numel() * 4
        samples = far * ((1 << cfg.los_depth) - 1)
    ops = gated * (INTEREST_OPS_PAIR + INTEREST_OPS_TIER * cfg.has_tier) \
        + samples * INTEREST_OPS_SAMPLE
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", samples)


def interest_sass_per_pair(_build):
    """SASS instructions per pair of the stack-step kernel's unrolled bit
    loop: from the first FADD after the warp vote that gates the row (the
    compiler hoists the subtracts and maxima above the first compare) to
    the FSETP of the loop's 32nd pair, over 32 (the out-of-line LOS
    sampler, listed after the kernel's body, has FSETP of its own), for
    the off step and the full team+tier+LOS step; None where cuobjdump is
    missing or the count fails."""
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
    for k, (mark, per) in INTEREST_SASS.items():
        ins, inside = [], False
        for line in dump.splitlines():
            if "Function : " in line:
                inside = mark in line
            elif inside and (m := SASS_LINE.match(line)):
                if m.group(2) != "NOP":
                    ins.append(m.group(2))
        fsetp = [i for i, op in enumerate(ins) if op.startswith("FSETP")]
        try:
            vote = max(i for i, op in enumerate(ins[:fsetp[0]])
                       if op.startswith("VOTE"))
            start = next(i for i in range(vote, fsetp[0])
                         if ins[i].startswith("FADD"))
            got[k] = (fsetp[32 * per - 1] - start + 1) / 32
        except (IndexError, ValueError, StopIteration) as e:
            log(f"interest sass {k}: not measured ({e!r})")
            got[k] = None
    return got


def interest_lists(c, cap=None):
    """A step's outputs beside its planes: changed-word lists of ``cap``
    entries a plane (every word of a plane by default) and the counts,
    both filled with -1."""
    cap = c * (c // 32) if cap is None else cap
    return (torch.full((2, cap, 2), -1, dtype=torch.int32, device=DEV),
            torch.full((2,), -1, dtype=torch.int32, device=DEV))


def interest_apply(fn, args, cfg, full, g, cap=None):
    """One step of ``fn`` (the kernel's wrapper or the plain version) on
    copies of ``args``' planes: (final, near, lists, counts)."""
    fin, near = args[6].clone(), args[7].clone()
    lists, counts = interest_lists(args[0].shape[0], cap)
    fn(*args[:6], fin, near, cfg, full, grid=g, lists=lists, counts=counts)
    return fin, near, lists, counts


def check_changed(label, prev, new, lists, counts, cap):
    """The changed-word lists as sets: each plane's count is its number of
    changed words, and its first min(count, cap) entries are distinct
    changed words with their new values (so all of them when count <=
    cap); nothing is written past them."""
    for p in range(2):
        changed = (new[p] != prev[p]).reshape(-1)
        n, want = int(counts[p]), int(changed.sum())
        check(n == want, f"{label}: plane {p} count {n}, {want} changed")
        k = min(n, cap)
        e = lists[p, :k]
        idx = e[:, 0].long()
        check(bool(((idx >= 0) & (idx < changed.numel())).all()),
              f"{label}: plane {p} list index out of range")
        s = torch.sort(idx).values
        check(k < 2 or bool((s[1:] != s[:-1]).all()),
              f"{label}: plane {p} lists a word twice")
        check(bool(changed[idx].all()) and torch.equal(
            new[p].reshape(-1)[idx], e[:, 1]),
              f"{label}: plane {p} list entries are not its changes")
        check(bool((lists[p, k:] == -1).all()),
              f"{label}: plane {p} list written past entry {k}")


def interest_same(IC, args, cfg, full, g, label, cap=None):
    """The kernel against its plain version on the same planes: both
    planes after the step bit for bit, the counts equal, the lists as
    sets (check_changed; the plain version's with every word's room)."""
    c = args[0].shape[0]
    kf, kn, kl, kc = interest_apply(IC.interest_step_cuda, args, cfg, full,
                                    g, cap)
    pf, pn, pl, pc = interest_apply(IC.interest_step_plain, args, cfg, full,
                                    g)
    torch.cuda.synchronize()
    err = 0
    if not (torch.equal(kf, pf) and torch.equal(kn, pn)):
        err = int((kf != pf).sum()) + int((kn != pn).sum())
    check(err == 0, f"interest_step kernel != plain: {label} "
          f"({err} words differ)")
    check(torch.equal(kc, pc), f"interest_step kernel != plain: {label} "
          f"counts {kc.tolist()} != {pc.tolist()}")
    words = c * (c // 32)
    check_changed(label, args[6:8], (kf, kn), kl, kc,
                  words if cap is None else cap)
    check_changed(label + " (plain)", args[6:8], (pf, pn), pl, pc, words)
    return [int(v) for v in kc]


def interest_timed(fn, args, cfg, full, g, reps):
    """Mean device ms of one step of ``fn`` (CUDA events around the call
    alone), its planes restored to ``args``' before every launch and the
    L2 flushed after (a path step finds its planes cold); one step first
    to warm up."""
    c = args[0].shape[0]
    fin, near = args[6].clone(), args[7].clone()
    lists, counts = interest_lists(c, list_cap_of(c))
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=DEV)
    evs = []
    for _ in range(reps + 1):
        fin.copy_(args[6])
        near.copy_(args[7])
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(*args[:6], fin, near, cfg, full, grid=g, lists=lists,
           counts=counts)
        e1.record()
        evs.append((e0, e1))
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in evs[1:]]
    return sum(ms) / len(ms)


def list_cap_of(c):
    from goworld_tpu_torch.interest import device as D

    return D.list_cap(c)


def interest_steady(IC, args, cfg, g, seed):
    """A path step's inputs: ``args``' columns moved by one walk step
    (slots 64 to PER_SPACE, up to STEP each way, clipped to the world; the
    edge slots stay), and as previous planes the plain version's after a
    full step and an off one (a full one without a tier) at the old
    positions, from zero planes."""
    c = args[0].shape[0]
    w = c // 32
    prev = [torch.zeros((c, w), dtype=torch.int32, device=DEV)
            for _ in range(2)]
    for full in (True, not cfg.has_tier):
        base = list(args[:6]) + prev
        fin, near, _, _ = interest_apply(IC.interest_step_plain, base, cfg,
                                         full, g, 1)
        prev = [fin, near]
    rng = np.random.default_rng(seed)
    moved = []
    for a in args[:2]:
        h = a.cpu().numpy().copy()
        step = rng.uniform(-STEP, STEP, PER_SPACE - 64).astype(np.float32)
        h[64:PER_SPACE] = np.clip(h[64:PER_SPACE] + step, 0, WORLD)
        moved.append(torch.from_numpy(h).to(DEV))
    return moved + list(args[2:6]) + prev


def phase_interest_kernel(IC, K, TI):
    """Phase 18: csrc/interest_step.cu against its plain version on the
    card (interest_same: planes in place, counts, changed-word lists as
    sets): the six policy mixes, full and off steps, LOS depths 1-4, on
    edge inputs at C = 128, 256, 384, and at C = 16384 on phase 18b's
    world, from random planes (every word changes) and from a path
    step's planes (interest_steady); forced list overflows at both sizes.
    CUDA-event times and bounds at 16384."""
    from goworld_tpu_torch.interest.policy import _build_config

    def cfg_of(combo, field, depth):
        cfg, f = _build_config(interest_policies(TI, combo, field, depth))
        g = None if f is None else torch.from_numpy(f.grid).to(DEV)
        return cfg, g

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
                    interest_same(IC, args, cfg, full, g,
                                  f"C={c} {combo} depth {depth} "
                                  f"{'full' if full else 'off'}")
                    n_cases += 1
        cfg, g = cfg_of("team+tier+los", small, 2)
        for cap in (0, 5):
            interest_same(IC, args, cfg, True, g,
                          f"C={c} forced overflow cap {cap}", cap=cap)
            n_cases += 1
    big = interest_field(TI, False)
    rand = interest_inputs(INTEREST_FULL, 400, small=False)
    rows = []
    for combo, full, depth in (("team+tier+los", True, INTEREST_DEPTH),
                               ("team+tier+los", False, INTEREST_DEPTH),
                               ("los", True, 4)):
        cfg, g = cfg_of(combo, big, depth)
        steady = interest_steady(IC, rand, cfg, g, 500 + depth)
        label = f"C={INTEREST_FULL} {combo} depth {depth} " \
                f"{'full' if full else 'off'}"
        interest_same(IC, rand, cfg, full, g, label + " random planes")
        changed = interest_same(IC, steady, cfg, full, g, label + " steady")
        n_cases += 2
        ms = interest_timed(IC.interest_step_cuda, steady, cfg, full, g, 20)
        read_sm_clock()
        ms_rand = interest_timed(IC.interest_step_cuda, rand, cfg, full, g,
                                 20)
        plain_ms = interest_timed(IC.interest_step_plain, steady, cfg, full,
                                  g, 2)
        bound_ms, bound_by, samples = interest_bound(K, steady, cfg, full, g,
                                                     sum(changed))
        act_rows = int(steady[3].sum())
        row = {"shape": [1, INTEREST_FULL], "combo": combo,
               "step": "full" if full else "off", "depth": depth, "ms": ms,
               "ms_random_planes": ms_rand, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "los_samples": samples, "changed_words": changed,
               "culled_frac": 1.0 - act_rows / INTEREST_FULL,
               "max_abs_err": 0}
        log("kernel interest_step", json.dumps(row))
        rows.append(row)
    cfg, g = cfg_of("team+tier+los", big, INTEREST_DEPTH)
    interest_same(IC, rand, cfg, True, g, f"C={INTEREST_FULL} forced "
                  f"overflow cap 4096", cap=4096)
    n_cases += 1
    del rand, steady
    torch.cuda.empty_cache()
    log(f"phase 18: {n_cases} cases bit-exact, lists as sets")
    return {"cases": n_cases, "rows": rows}


def crc_of(arrays, crc=0):
    for a in arrays:
        crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
    return crc


def interest_timers(TI, IC, D):
    """The stack step's parts, each timed while ``on``: this tick's
    columns up (upload_columns: host ms and CUDA events), the kernel (or
    the plain twin's step; CUDA events), the counts and list fetch
    (fetch_changes: host ms, the wait for the kernel included), the host
    apply and the pair expansion (host clock), the whole step."""
    return {"up": DeviceTimer(D, "upload_columns"),
            "kernel": DeviceTimer(IC, "interest_step"),
            "fetch": DeviceTimer(D, "fetch_changes"),
            "apply": HostTimer(TI.PolicyStack, "_apply_changes"),
            "expand": HostTimer(TI.PolicyStack, "_expand"),
            "step": HostTimer(TI.PolicyStack, "step")}


def timer_split(timers, steps, dstats):
    """ms a step of each timed part, and the device_stats deltas a step
    (``dstats``: the summed deltas over ``steps`` steps)."""
    up, kern, fetch = timers["up"], timers["kernel"], timers["fetch"]
    per = max(steps, 1)
    return {"stack_step_ms": timers["step"].s * 1e3 / per,
            "cols_up_ms": sum(up.host_ms) / per,
            "cols_up_device_ms": up.ms() / per,
            "kernel_ms": kern.ms() / per,
            "list_fetch_ms": sum(fetch.host_ms) / per,
            "list_fetch_device_ms": fetch.ms() / per,
            "apply_ms": timers["apply"].s * 1e3 / per,
            "expand_ms": timers["expand"].s * 1e3 / per,
            **{f"{k}_per_step": v / per for k, v in dstats.items()}}


def dstats_of(stacks):
    out = {}
    for s in stacks:
        for k, v in s.device_stats.items():
            out[k] = out.get(k, 0) + v
    return out


def interest_run(Runtime, TI, IC, D, label, spaces, per_space, capacity,
                 ticks, measured=0, plain=False, **rt_kw):
    """Phase 4's world (``spaces`` x ``per_space``) with the phase-18b
    stack on every space (team/vis seeded as tests/test_interest.py's
    _walk seeds them), walked for ``ticks`` ticks (the first the prime
    tick) through ``Runtime(device="cuda", **rt_kw)``; the last
    ``measured`` ticks are timed.  ``plain``: the stack step calls the
    plain PyTorch version on the card in place of the kernel.  Returns
    per-tick event CRCs, the whole stream's CRC, final words (the host
    planes, checked equal to the resident ones), launches, the stacks'
    device_stats and the timing split."""
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
    timers = interest_timers(TI, IC, D)
    IC.reset_launches()
    tick_crcs = []
    tick_s = 0.0
    try:
        for t in range(ticks):
            if t == ticks - measured:
                perf0 = dict(bucket_of(rt).perf)
                ds0 = dstats_of(stacks)
                torch.cuda.synchronize()
                for tm in timers.values():
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
        for tm in timers.values():
            tm.on = False
        trailing = 0
        while rt.aoi.has_pending():  # a deferred bucket's last tick
            rt.aoi.flush()
            for sp in spaces_l:
                trailing += sum(len(a) for a in rt.aoi.take_events(
                    sp._aoi_handle))
    finally:
        for tm in reversed(list(timers.values())):
            tm.restore()
        IC.interest_step = kernel
    launches = IC.launches["interest_step"]
    for s in stacks:
        check(s.stats["demotions"] == 0 and s.stats["host_steps"] == 0,
              f"{label}: stack stats {s.stats}")
        if s.mode == "device":
            pl = s._planes
            check(not pl.dirty and np.array_equal(
                pl.final.cpu().numpy().view(np.uint32), s.final)
                and np.array_equal(pl.near.cpu().numpy().view(np.uint32),
                                   s.near),
                  f"{label}: resident planes != host planes")
    healthy(bucket_of(rt).stats, label)
    dstats = dstats_of(stacks)
    if stacks[0].mode == "device":
        # a steady step moves no whole plane either way
        check(dstats["plane_uploads"] == 0 and dstats["list_overflows"] == 0,
              f"{label}: whole planes moved: {dstats}")
    out = {"label": label, "ticks": ticks, "crcs": tick_crcs,
           "stream_crc": f"{crc['v']:08x}", "events": crc["events"],
           "trailing_events": trailing, "launches": launches,
           "words": [s.words.copy() for s in stacks],
           "device_stats": dstats,
           "full_evals": sum(s.stats["full_evals"] for s in stacks),
           "los_pair_evals": sum(s.stats["los_pair_evals"] for s in stacks)}
    if measured:
        b = bucket_of(rt)
        steps = len(timers["kernel"].events)
        out["split"] = {
            "tick_ms": tick_s * 1e3 / measured,
            **{k[:-2] + "_ms": (b.perf[k] - perf0[k]) * 1e3 / measured
               for k in b.perf},
            "steps_per_tick": steps / measured,
            **timer_split(timers, steps,
                          {k: v - ds0[k] for k, v in dstats.items()})}
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
    check(k["stream_crc"] == INTEREST_CRC, f"phase 18b: stream CRC "
          f"{k['stream_crc']}, want {INTEREST_CRC}")
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
           "device_stats": {name: r["device_stats"]
                            for name, r in runs.items()},
           "launches": {"sequential": k["launches"],
                        "pipelined": runs["pipelined"]["launches"],
                        "cut": cut["device"]["launches"]},
           "cut_crc": cut["device"]["stream_crc"]}
    log("phase 18b", json.dumps(out))
    return out


def phase_load(TL, TI, IC, D):
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
            stacks = [sp.interest_stack for sp in hz.spaces]
            ds0 = dstats_of(stacks)
            timers = interest_timers(TI, IC, D)
            for tm in timers.values():
                tm.on = True
            try:
                rep = hz.run(LOAD_TICKS)
                torch.cuda.synchronize()
            finally:
                for tm in reversed(list(timers.values())):
                    tm.restore()
            n_launch = IC.launches["interest_step"]
            stack_s = timers["step"].s
            dstats = {k: v - ds0[k] for k, v in dstats_of(stacks).items()}
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
                   "interest": rep["interest"],
                   "split": timer_split(timers, spaces * LOAD_TICKS,
                                        dstats)}
            if mode == "device":
                check(dstats["plane_uploads"] == 0
                      and dstats["list_overflows"] == 0,
                      f"{label}: whole planes moved: {dstats}")
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


# -- phases 19-19c: live migration, evacuation, checkpoints -------------------

MIG_SHARDS = 4  # the mesh and row-sharded targets' virtual shards
# (tick, space, target tier): space 0 (stacked) cuda -> cpp -> cuda, space
# 1 to the mesh, space 2 row-sharded (16384 = 32 x 4 x 128), space 3
# re-homed on its own tier; each cover ends within two flushes
MIG_MOVES = [(3, 0, "cpp"), (6, 0, "cuda"), (9, 1, "mesh"),
             (12, 2, "rowshard"), (15, 3, "cuda")]
MIG_TICKS = 19
EVAC_SPACES = 2  # the faulted tick is recovered on the host: ~4 s a space
EVAC_TICKS, EVAC_AT = 8, 4  # 8 ticks; the 4th aoi.device crossing fires
CKPT_SPACES, CKPT_TICKS, CKPT_AFTER = 2, 16, 8


def engine_world(spaces, ticks, seed):
    """Phase 4's widths for AOIEngine: ``spaces`` spaces of PER_SPACE
    active entities in CAPACITY slots, world WORLD, r RADIUS, a walk of
    STEP a tick for everyone; (r, act, frames [tick][space, 2, C], team,
    vis) with the stacked space's team and vis seeded as phase 18b's."""
    rng = np.random.default_rng(seed)
    n = PER_SPACE
    r = np.full(CAPACITY, RADIUS, np.float32)
    act = np.arange(CAPACITY) < n
    pos = np.zeros((spaces, 2, CAPACITY), np.float32)
    pos[:, :, :n] = rng.uniform(0, WORLD, (spaces, 2, n))
    frames = []
    for t in range(ticks):
        if t:
            q = pos[:, :, :n] + rng.uniform(-STEP, STEP, (spaces, 2, n))
            pos[:, :, :n] = np.clip(q, 0, WORLD)
        frames.append(pos.copy())
    trng = np.random.default_rng(3)
    team = np.uint32(1) << trng.integers(0, 4, CAPACITY).astype(np.uint32)
    vis = np.where(trng.random(CAPACITY) < 0.75, 0xFFFFFFFF, 1).astype(
        np.uint32)
    return r, act, frames, team, vis


def snapshot_nbytes(snap):
    pkt = snap["packet"] or ()
    return sum(a.nbytes for a in (snap["r"], snap["act"], snap["words"],
                                  *pkt))


def span_ms(trace, name):
    return [(t1 - t0) * 1e3 for n, _, t0, t1 in trace.spans() if n == name]


class StreamCRC:
    """Per space: each tick's event CRC, and the CRCs of the whole enter
    and the whole leave stream (what a move across a deferred tier keeps:
    it shifts delivery by one tick, never the content)."""

    def __init__(self, n):
        self.ticks = [[] for _ in range(n)]
        self.enter, self.leave, self.events = [0] * n, [0] * n, [0] * n

    def fold(self, i, ev):
        e, lv = (np.ascontiguousarray(a, np.int32) for a in ev)
        self.ticks[i].append(f"{crc_of([e, lv]):08x}")
        self.enter[i] = zlib.crc32(e.tobytes(), self.enter[i])
        self.leave[i] = zlib.crc32(lv.tobytes(), self.leave[i])
        self.events[i] += len(e) + len(lv)

    def streams(self):
        return [f"{a:08x}/{b:08x}" for a, b in zip(self.enter, self.leave)]


def mig_run(AOIEngine, SpaceMesh, PL, TI, world, pipeline, moves):
    """Phase 4's world as AOIEngine spaces on the card's single-device
    bucket (an engine with a mesh of MIG_SHARDS virtual shards, so the
    mesh and row-sharded tiers exist), space 0 with phase 18b's stack,
    MIG_TICKS ticks; each of ``moves`` starts a live migration before its
    tick.  Per-space stream CRCs, tick ms, and a record a move."""
    from goworld_tpu_torch.telemetry import trace

    r, act, frames, team, vis = world
    eng = AOIEngine(device=DEV, pipeline=pipeline,
                    mesh=SpaceMesh([torch.device(DEV)] * MIG_SHARDS))
    pc = PL.PlacementController(eng)
    hs = [eng._create_handle(CAPACITY, "cuda") for _ in range(SPACES)]
    stack = eng.attach_interest(hs[0], interest_policies(
        TI, "team+tier+los", interest_field(TI, False)))
    sc = StreamCRC(SPACES)
    todo = {t: (i, tier) for t, i, tier in moves}
    ticks, moved, cur = [], [], None

    def take():
        for i, h in enumerate(hs):
            sc.fold(i, eng.take_events(h))

    for t in range(MIG_TICKS):
        if t in todo:
            check(cur is None and not eng._migrations,
                  f"phase 19: a cover still open at tick {t}")
            i, tier = todo[t]
            h = hs[i]
            src, b = eng._tier_of(h.bucket), h.bucket
            got = {}

            def grab(slot, _f=b.export_snapshot):
                got["snap"] = _f(slot)
                return got["snap"]

            b.export_snapshot = grab
            trace.reset()
            ms0 = eng.migration_stats["migration_ms"]
            try:
                mig = pc.migrate(h, tier)
            finally:
                del b.export_snapshot
            cur = (mig, {"tick": t, "space": i, "from": src, "to": tier,
                         "lag": mig.lag_t - mig.lag_s,
                         "export_ms": span_ms(trace, "aoi.migrate.snapshot")[0],
                         "replay_ms": span_ms(trace, "aoi.migrate.replay")[0],
                         "snapshot_bytes": snapshot_nbytes(got["snap"]),
                         "cover_flushes": 0, "cover_tick_ms": []}, ms0)
        for i, h in enumerate(hs):
            eng.submit(h, frames[t][i, 0], frames[t][i, 1], r, act)
        stack.submit(frames[t][0, 0], frames[t][0, 1], r, act, team, vis)
        covering = bool(eng._migrations)
        torch.cuda.synchronize()
        trace.reset()
        t0 = time.perf_counter()
        eng.flush()
        take()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ticks.append({"ms": ms, "cover": covering})
        if covering:
            mig, rec, ms0 = cur
            rec["cover_flushes"] += 1
            rec["cover_tick_ms"].append(ms)
            if mig.done:
                h = hs[rec["space"]]
                check(h._migration is None and eng._tier_of(h.bucket) in (
                    rec["to"], "cpu" if rec["to"] == "cpp" else rec["to"])
                      and eng.migration_stats["migration_rollbacks"] == 0,
                      f"phase 19: move {rec} rolled back or misplaced")
                rec["swap_ms"] = span_ms(trace, "aoi.migrate.swap")[0]
                rec["migration_ms"] = eng.migration_stats["migration_ms"] \
                    - ms0
                moved.append(rec)
                cur = None
    while eng.has_pending():
        eng.flush()
        take()
    check(cur is None and len(moved) == len(moves)
          and eng.migration_stats["migrations"] == len(moves)
          and eng.migration_stats["migration_rollbacks"] == 0,
          f"phase 19: {eng.migration_stats}, {len(moved)} moves done")
    check(stack.stats["demotions"] == 0 and stack.stats["host_steps"] == 0,
          f"phase 19: stack stats {stack.stats}")
    for b in eng._buckets.values():
        if hasattr(b, "stats"):
            healthy(b.stats, f"phase 19 {type(b).__name__}")
    steady = [r_["ms"] for t, r_ in enumerate(ticks) if t and not r_["cover"]]
    out = {"pipeline": pipeline, "moves": moved, "crc": sc,
           "tick_ms_steady": sum(steady) / len(steady),
           "tick_ms": [r_["ms"] for r_ in ticks]}
    del eng, hs, stack
    return out


def phase_migration(AOIEngine, SpaceMesh, AK, IC, PL, TI):
    """Phase 19: live migration at phase 4's world on the card, pipeline
    off and on (lag deltas 0; and -1, 0, +1), each against an unmigrated
    run of the same walk: every space's enter and leave streams equal,
    each tick's CRC equal where a space's moves all kept its cadence;
    every move done, none rolled back.  Counts the square step's, the
    rect step's (the row-sharded target) and the stack step's launches
    over the phase."""
    from goworld_tpu_torch import telemetry

    world = engine_world(SPACES, MIG_TICKS, seed=19)
    square = AK.aoi_step_chg
    rect = {"n": 0}

    def counted(*a, **kw):
        n0 = AK.launches["aoi_step"]
        try:
            return square(*a, **kw)
        finally:
            if kw.get("cols") is not None:
                rect["n"] += AK.launches["aoi_step"] - n0

    AK.reset_launches()
    IC.reset_launches()
    AK.aoi_step_chg = counted
    telemetry.enable()
    runs = {}
    try:
        for pipeline in (False, True):
            for moves in ((), MIG_MOVES):
                runs[(pipeline, bool(moves))] = mig_run(
                    AOIEngine, SpaceMesh, PL, TI, world, pipeline, moves)
                torch.cuda.empty_cache()
    finally:
        telemetry.disable()
        AK.aoi_step_chg = square
    launches = {"aoi_step": AK.launches["aoi_step"] - rect["n"],
                "aoi_step rect": rect["n"],
                "interest_step": IC.launches["interest_step"]}
    ref_streams = runs[(False, False)]["crc"].streams()
    for pipeline in (False, True):
        ref, got = runs[(pipeline, False)]["crc"], runs[(pipeline, True)]["crc"]
        check(got.streams() == ref.streams() == ref_streams,
              f"phase 19 pipeline={pipeline}: a space's stream diverged "
              f"from the unmigrated run's")
        for i in range(SPACES):
            lags = [m["lag"] for m in runs[(pipeline, True)]["moves"]
                    if m["space"] == i]
            if i == 0 or all(lag == 0 for lag in lags):
                # (space 0's stream is its stack's, stepped in the flush
                # that submitted it whatever the bucket's cadence)
                check(got.ticks[i] == ref.ticks[i],
                      f"phase 19 pipeline={pipeline}: space {i}'s per-tick "
                      f"CRCs diverged")
    lag_set = sorted({m["lag"] for (p, mv), r_ in runs.items() if mv
                      for m in r_["moves"]})
    check(lag_set == [-1, 0, 1], f"phase 19: lag deltas {lag_set}")
    check(all(v > 0 for v in launches.values()),
          f"phase 19: a kernel of the path never launched: {launches}")
    out = {"launches": launches, "lags": lag_set,
           "stream_crcs": ref_streams,
           "events": sum(runs[(False, True)]["crc"].events),
           "runs": {f"pipeline={p}" + (" moved" if mv else " unmoved"): {
               k: v for k, v in r_.items() if k != "crc"}
               for (p, mv), r_ in runs.items()}}
    log("phase 19", json.dumps(out))
    return out


def evac_run(AOIEngine, SpaceMesh, AK, world, shards, plan):
    """EVAC_SPACES of phase 4's spaces on the card's single-device bucket
    (``shards`` 0) or on a mesh of ``shards`` virtual shards, EVAC_TICKS
    ticks, under ``plan``: per tick the CRC, events, ms (a sync before
    and after), the step's launches and whether the space has moved to
    a fresh bucket."""
    from goworld_tpu_torch import faults, telemetry
    from goworld_tpu_torch.telemetry import trace

    r, act, frames, _team, _vis = world
    if plan:
        faults.install(plan)
    telemetry.enable()
    trace.reset()
    try:
        mesh = (SpaceMesh([torch.device(DEV)] * shards) if shards else None)
        eng = AOIEngine(device=DEV, mesh=mesh)
        hs = [eng.create_space(CAPACITY) for _ in range(EVAC_SPACES)]
        first = hs[0].bucket
        rows = []
        for t in range(EVAC_TICKS):
            for i, h in enumerate(hs):
                eng.submit(h, frames[t][i, 0], frames[t][i, 1], r, act)
            n0 = AK.launches["aoi_step"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.flush()
            evs = [eng.take_events(h) for h in hs]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            rows.append({"crc": f"{crc_of([a for ev in evs for a in ev]):08x}",
                         "events": sum(len(a) for ev in evs for a in ev),
                         "ms": ms, "launches": AK.launches["aoi_step"] - n0,
                         "fresh": hs[0].bucket is not first,
                         "level": hs[0].bucket.stats["calc_level"]})
        evac_ms = span_ms(trace, "aoi.evacuate")
        out = {"rows": rows, "evacuate_ms": evac_ms,
               "stats": dict(eng.migration_stats),
               "buckets": len({id(h.bucket) for h in hs}),
               "final": dict(hs[0].bucket.stats),
               "old": dict(first.stats)}
    finally:
        telemetry.disable()
        faults.clear()
    del eng, hs, first
    torch.cuda.empty_cache()
    return out


def phase_evacuation(AOIEngine, SpaceMesh, AK):
    """Phase 19b: aoi.device:reset at the EVAC_AT-th dispatch on the
    single-device bucket and on the mesh bucket (MIG_SHARDS virtual
    shards), each against its fault-free run: per-tick CRCs equal, one
    evacuation, every space on one fresh bucket at calc level 0 whose
    kernel launches on every later tick; the aoi.evacuate ms and the
    first three ticks after it."""
    world = engine_world(EVAC_SPACES, EVAC_TICKS, seed=23)
    out, launches = {}, 0
    for label, shards in (("single", 0), ("mesh", MIG_SHARDS)):
        ref = evac_run(AOIEngine, SpaceMesh, AK, world, shards, None)
        got = evac_run(AOIEngine, SpaceMesh, AK, world, shards,
                       f"aoi.device:reset@{EVAC_AT}")
        check([r_["crc"] for r_ in got["rows"]]
              == [r_["crc"] for r_ in ref["rows"]],
              f"phase 19b {label}: CRCs diverged from the fault-free run")
        fault = EVAC_AT - 1
        per = max(shards, 1)
        after = got["rows"][fault + 1:]
        check(got["stats"]["evacuations"] == 1 and got["buckets"] == 1
              and len(got["evacuate_ms"]) == 1
              and not any(r_["fresh"] for r_ in got["rows"][:fault])
              and all(r_["fresh"] for r_ in got["rows"][fault:])
              and got["rows"][fault]["launches"] == 0
              and all(r_["launches"] == per and r_["level"] == 0
                      for r_ in after)
              and got["old"]["host_ticks"] == 1
              and got["old"]["calc_level"] == 2,
              f"phase 19b {label}: {got['stats']} {got['rows']}")
        healthy(got["final"], f"phase 19b {label} evacuated bucket")
        healthy(ref["final"], f"phase 19b {label} fault-free")
        launches += sum(r_["launches"] for r_ in got["rows"])
        out[label] = {
            "evacuate_ms": got["evacuate_ms"][0],
            "faulted_tick_ms": got["rows"][fault]["ms"],
            "ticks_after_ms": [r_["ms"] for r_ in after[:3]],
            "fault_free_tick_ms": [r_["ms"] for r_ in ref["rows"][1:]],
            "crcs": [r_["crc"] for r_ in got["rows"]]}
        log(f"phase 19b {label}", json.dumps(out[label]))
    return {"runs": out, "launches": launches}


def phase_checkpoint(Runtime, AOIEngine, AK, IC, TI):
    """Phase 19c: Runtime(aoi_checkpoint="continuous") at CKPT_SPACES of
    phase 4's spaces (space 0 with phase 18b's stack) into a temporary
    directory for CKPT_TICKS ticks, then CKPT_AFTER more ticks with the
    inputs recorded; every space restored into a fresh AOIEngine on the
    card (restore_into, the stack's payload through attach_interest) and
    fed the recorded inputs: per-tick, per-space CRCs equal the
    uninterrupted run's.  Then crash_restart_scenario on the card at its
    default size: events_lost == 0."""
    import shutil
    import tempfile

    from goworld_tpu_torch.engine import checkpoint as CK

    tmp = tempfile.mkdtemp(prefix="gw_ckpt_")
    field = interest_field(TI, False)
    stacked = []

    def setup(sp):
        if not stacked:
            stacked.append(sp.enable_interest(
                *interest_policies(TI, "team+tier+los", field)))

    try:
        AK.reset_launches()
        IC.reset_launches()
        rt, crc, spaces_l, slots, pos, rng = build_world(
            Runtime, DEV, CKPT_SPACES, PER_SPACE, CAPACITY, seed=29,
            setup=setup, aoi_checkpoint="continuous",
            aoi_checkpoint_dir=os.path.join(tmp, "ck"))
        trng = np.random.default_rng(3)
        sp0, sl0 = spaces_l[0], slots[0]
        team = np.uint32(1) << trng.integers(0, 4, len(sl0)).astype(np.uint32)
        vis = np.where(trng.random(len(sl0)) < 0.75, 0xFFFFFFFF, 1)
        for s, t_, v in zip(sl0.tolist(), team.tolist(), vis.tolist()):
            sp0.set_aoi_team(sp0._slot_entity[s], t_, v)
        ctl = rt.checkpoint
        cap_t = HostTimer(CK.CheckpointController, "capture")
        lag, tick_ms = [], []
        try:
            cap_t.on = True
            for t in range(CKPT_TICKS):
                if t:
                    walk(spaces_l, slots, pos, rng)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rt.tick()
                torch.cuda.synchronize()
                tick_ms.append((time.perf_counter() - t0) * 1e3)
                lag.append(max(sh.enqueued_tick - sh.acked_tick
                               for sh in ctl._shadows.values()))
        finally:
            cap_t.restore()
        t0 = time.perf_counter()
        check(ctl.drain(timeout=600), "phase 19c: the writer did not drain")
        drain_s = time.perf_counter() - t0
        stats = dict(ctl.stats)
        ctl.close()
        rt.checkpoint = None  # the continuation is not journaled
        check(stats["records_written"] == CKPT_SPACES * CKPT_TICKS
              and stats["backlog_drops"] == 0
              and stats["dropped_epochs"] == 0,
              f"phase 19c: {stats}")
        store, kv = CK._open_backends(os.path.join(tmp, "ck"))
        rec_bytes = {"base": [], "delta": []}
        for sp in spaces_l:
            for _k, v in kv.find(f"{CK.MANIFEST_PREFIX}{sp.id}/",
                                 f"{CK.MANIFEST_PREFIX}{sp.id}/~"):
                e = json.loads(v)
                rec_bytes[e["kind"]].append(e["nbytes"])
        # the uninterrupted run's next ticks, their inputs recorded
        handles = [sp._aoi_handle for sp in spaces_l]
        inputs, stack_in = [], []
        sc_run = StreamCRC(CKPT_SPACES)
        aoi = rt.aoi
        submit, take = aoi.submit, aoi.take_events
        stack_submit = stacked[0].submit

        def rec_submit(h, *a):
            inputs[-1][handles.index(h)] = [np.array(x) for x in a]
            return submit(h, *a)

        def rec_stack(*a):
            stack_in.append([np.array(x) for x in a])
            return stack_submit(*a)

        def rec_take(h):
            ev = take(h)
            sc_run.fold(handles.index(h), ev)
            return ev

        aoi.submit, aoi.take_events = rec_submit, rec_take
        stacked[0].submit = rec_stack
        try:
            for t in range(CKPT_AFTER):
                inputs.append([None] * CKPT_SPACES)
                walk(spaces_l, slots, pos, rng)
                rt.tick()
        finally:
            aoi.submit, aoi.take_events = submit, take
            del stacked[0].submit
        check(all(all(x is not None for x in row) for row in inputs)
              and len(stack_in) == CKPT_AFTER,
              "phase 19c: a space did not submit every tick")
        # a fresh engine: every space restored, fed the recorded inputs
        eng = AOIEngine(device=DEV)
        rest = CK.CheckpointController(eng, store, kv, mode="off")
        hs, restore_ms = [], []
        for sp in spaces_l:
            t0 = time.perf_counter()
            res = rest.restore_into(eng, sp.id, tier="cuda")
            torch.cuda.synchronize()
            restore_ms.append((time.perf_counter() - t0) * 1e3)
            check(res is not None and res[1] == CKPT_TICKS,
                  f"phase 19c: restore of space {sp.id}: {res}")
            hs.append(res[0])
        check(hs[0]._interest_snapshot is not None,
              "phase 19c: the stack's payload did not ride the journal")
        stack2 = eng.attach_interest(hs[0], interest_policies(
            TI, "team+tier+los", field))
        check(stack2.step_count == stacked[0].step_count - CKPT_AFTER,
              "phase 19c: the restored stack's step count")
        sc_rest = StreamCRC(CKPT_SPACES)
        for t in range(CKPT_AFTER):
            for h, a in zip(hs, inputs[t]):
                eng.submit(h, *a)
            stack2.submit(*stack_in[t])
            eng.flush()
            for i, h in enumerate(hs):
                sc_rest.fold(i, eng.take_events(h))
        torch.cuda.synchronize()
        check(sc_rest.ticks == sc_run.ticks and sum(sc_run.events),
              "phase 19c: the restored CRCs diverged from the "
              "uninterrupted run's")
        for h in hs:
            healthy(h.bucket.stats, "phase 19c restored bucket")
        launches = {"aoi_step": AK.launches["aoi_step"],
                    "interest_step": IC.launches["interest_step"]}
        store.close()
        kv.close()
        del rt, eng, hs, stack2, rest, stacked[:]
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        crash = CK.crash_restart_scenario(os.path.join(tmp, "crash"),
                                          tier="cuda", device=DEV,
                                          timeout=300)
        crash["wall_s"] = time.perf_counter() - t0
        check(crash["events_lost"] == 0 and crash["parity_ok"]
              and crash["crash_rc"] == -9 and crash["oracle_rc"] == 0
              and crash["resume_rc"] == 0,
              f"phase 19c: crash_restart_scenario {crash}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n = CKPT_SPACES * CKPT_TICKS
    out = {"capture_ms_per_tick": cap_t.s * 1e3 / CKPT_TICKS,
           "capture_ms_per_space": cap_t.s * 1e3 / n,
           "tick_ms": sum(tick_ms[1:]) / (CKPT_TICKS - 1),
           "record_bytes": {k: sum(v) / max(len(v), 1)
                            for k, v in rec_bytes.items()},
           "records": {k: len(v) for k, v in rec_bytes.items()},
           "bytes_written": stats["bytes_written"],
           "lag_ticks_max": max(lag), "lag_ticks_last": lag[-1],
           "drain_s": drain_s, "restore_ms": restore_ms,
           "crcs": sc_run.ticks, "launches": launches,
           "crash_restart": crash}
    log("phase 19c", json.dumps(out))
    return out


# -- phases 20-21: space-stacked cohorts and the tick's telemetry -----------

# phase 20: bench.py bench_engine_multispace at its defaults (the shard
# shape: hundreds of scenes of ~100 entities)
MS_SPACES, MS_CAP, MS_N = 256, 128, 96
MS_WORLD, MS_RADIUS = 1000.0, 100.0  # bench.py: cfg.world / 4, cfg.radius
MS_TICKS, MS_WARMUP = 8, 3
MS_LADDER = (256,)
MS_QUIET = 4  # the Runtime run: space i is quiet on tick t >= 1 when
              # (i + t) % MS_QUIET == 0 (a quarter of them every tick)
# phase 20b: the full ladder, capacities uniform in [96, 4000], 75% full,
# each world side scaled so the density is phase 20's
LADDER_SPACES, LADDER_CAPS, LADDER_FILL = 192, (96, 4000), 0.75
# phase 20c: scripts/multispace_smoke.py's shard on one rung
DEMOTE_CAPS = [128 if i % 3 else 256 for i in range(24)]
DEMOTE_TICKS, DEMOTE_AT = 8, 4
# phase 21: the spans the tick must record with telemetry on
TICK_SPANS = ("tick", "tick.timers", "tick.aoi", "aoi.flush", "aoi.dispatch",
              "aoi.harvest", "aoi.emit", "tick.sync", "tick.post")
TELEMETRY_TURNS = ["telemetry off", "telemetry on", "telemetry on",
                   "telemetry off"]
RT_MODES.update({"telemetry off": {}, "telemetry on": {"telemetry_on": True}})


def ms_frames(ns, worlds, ticks, seed=31):
    """bench.py's _multispace_frames with an entity count and a world side
    per space: per tick, per space (x, z); about 10% of the entities move
    up to 15 a tick, clipped to the world.  One generator drives every
    space, so every engine sees the same positions (with one count and
    one side for all, the same numbers as bench.py's)."""
    rng = np.random.default_rng(seed)
    xs = [rng.uniform(0, w, n).astype(np.float32) for n, w in zip(ns, worlds)]
    zs = [rng.uniform(0, w, n).astype(np.float32) for n, w in zip(ns, worlds)]
    frames = []
    for _t in range(ticks):
        frame = []
        for s, (n, w) in enumerate(zip(ns, worlds)):
            move = rng.random(n) < 0.1
            k = int(move.sum())
            xs[s][move] = np.clip(xs[s][move] + rng.uniform(-15, 15, k), 0,
                                  w).astype(np.float32)
            zs[s][move] = np.clip(zs[s][move] + rng.uniform(-15, 15, k), 0,
                                  w).astype(np.float32)
            frame.append((xs[s].copy(), zs[s].copy()))
        frames.append(frame)
    return frames


def fold_events(evs, crc=0):
    for e, lv in evs:
        crc = zlib.crc32(np.ascontiguousarray(lv, np.int32).tobytes(),
                         zlib.crc32(np.ascontiguousarray(
                             e, np.int32).tobytes(), crc))
    return crc


def graph_pool_bytes(fzs):
    """Bytes the private memory pools of these fused ticks hold on the
    card (one memory snapshot for all of them)."""
    pools = {tuple(fz.pool) for fz in fzs if fz.pool is not None}
    if not pools:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) in pools)


def ms_run(AOIEngine, AK, DC, frames, caps, radius, warmup, keep=False,
           **kw):
    """The many-spaces walk through ``AOIEngine(device=DEV, **kw)``: per
    tick every space submits and the engine flushes once; the per-tick
    CRC of every space's enter and leave arrays in space order, and over
    the ticks from ``warmup`` on the dispatches (ops/dispatch_count), the
    new capture keys, ms a tick (submit to delivered events, a sync at
    the end), the device buckets' perf split, their graphs and pool
    bytes.  ``keep``: the engine and handles ride along (``"engine"``)."""
    eng = AOIEngine(device=DEV, **kw)
    hs = [eng.create_space(c) for c in caps]
    rs = [np.full(len(x), radius, np.float32) for x, _z in frames[0]]
    acts = [np.ones(len(x), bool) for x, _z in frames[0]]
    l0 = AK.launches["aoi_step"]
    crcs, walls = [], []
    for t, frame in enumerate(frames):
        if t == warmup:
            torch.cuda.synchronize()
            DC.reset()
            DC.reset_keys()
            perf0 = {id(b): dict(getattr(b, "perf", {}))
                     for b in eng._buckets.values()}
        t0 = time.perf_counter()
        for h, (x, z), r, a in zip(hs, frame, rs, acts):
            eng.submit(h, x, z, r, a)
        eng.flush()
        evs = [eng.take_events(h) for h in hs]
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        crcs.append(f"{fold_events(evs):08x}")
    meas = len(frames) - warmup
    buckets = list({id(h.bucket): h.bucket for h in hs}.values())
    split = {}
    for b in buckets:
        for k, v in getattr(b, "perf", {}).items():
            split[k[:-2] + "_ms"] = split.get(k[:-2] + "_ms", 0.0) + (
                v - perf0.get(id(b), {}).get(k, 0.0)) * 1e3 / meas
    fzs = [b._fz for b in buckets if getattr(b, "_fz", None) is not None]
    for b in buckets:
        if hasattr(b, "_calc_level"):
            healthy(b.stats, f"multispace {kw}")
    out = {"crcs": crcs, "ms_per_tick": sum(walls[warmup:]) * 1e3 / meas,
           "dispatches_per_tick": DC.read() / meas,
           "new_keys_after_warmup": DC.new_keys(), "buckets": len(buckets),
           "split_ms": split, "launches": AK.launches["aoi_step"] - l0,
           "captures": sum(fz.captures for fz in fzs),
           "graphs": sum(len(fz.graphs) for fz in fzs),
           "graph_pool_bytes": graph_pool_bytes(fzs),
           "allocated_bytes": torch.cuda.memory_allocated()}
    if keep:
        out["engine"] = (eng, hs)
    return out


def quiet_walk(spaces_l, slots, pos, rng, t):
    """Phase 20's Runtime walk: on tick t a space moves 10% of its
    entities up to 15 (clipped to its world), except the quarter that is
    quiet on that tick (nothing moves: it stages nothing)."""
    for i, (sp, sl, p) in enumerate(zip(spaces_l, slots, pos)):
        if (i + t) % MS_QUIET == 0:
            continue
        sel = np.flatnonzero(rng.random(p.shape[1]) < 0.1)
        q = p[:, sel] + rng.uniform(-15, 15, (2, len(sel))).astype(
            np.float32)
        p[:, sel] = np.clip(q, 0, sp.world)
        sp.move_entities(sl[sel], p[0, sel], p[1, sel])


def quiet_runtime(Runtime, DC, **rt_kw):
    """Phase 20's shard through ``Runtime.tick`` (one watcher a space, so
    every space is subscribed), a prime tick and MS_TICKS quiet-walk
    ticks: per tick (CRC, events, dispatches)."""
    rt, crc, spaces_l, slots, pos, rng = build_world(
        Runtime, DEV, MS_SPACES, MS_N, MS_CAP, seed=31, world=MS_WORLD,
        **rt_kw)
    rows = []
    for t in range(1 + MS_TICKS):
        if t:
            quiet_walk(spaces_l, slots, pos, rng, t)
        crc["t"] = crc["te"] = 0
        DC.reset()
        rt.tick()
        rows.append((f"{crc['t']:08x}", crc["te"], DC.read()))
    return rt, rows


def phase_cohort(Runtime, AOIEngine, AK, DC):
    """Phase 20: bench.py's bench_engine_multispace shard (256 spaces x 96
    entities, capacity 128, ladder (256,), world 1000, r 100, 10% movers,
    3 warm-up + 5 measured ticks) through the cohort engine, the solo
    baseline (both fused) and the cpu backend: equal per-tick CRCs, 1
    dispatch a tick against 256, no new capture key after warm-up; the
    solo buckets freed with their spaces; then the same shard through
    Runtime(aoi_cohort=True, aoi_fused=True) with a quarter of the spaces
    quiet each tick, equal to the cpu backend's Runtime and still 1
    dispatch a tick."""
    import gc

    caps = [MS_CAP] * MS_SPACES
    frames = ms_frames([MS_N] * MS_SPACES, [MS_WORLD] * MS_SPACES, MS_TICKS)
    AK.reset_launches()
    runs = {"cpu": ms_run(AOIEngine, AK, DC, frames, caps, MS_RADIUS,
                          MS_WARMUP, default_backend="cpu"),
            "cohort": ms_run(AOIEngine, AK, DC, frames, caps, MS_RADIUS,
                             MS_WARMUP, keep=True, fused=True,
                             cohort="auto", cohort_ladder=MS_LADDER)}
    gc.collect()
    torch.cuda.empty_cache()
    alloc0 = torch.cuda.memory_allocated()
    runs["solo"] = ms_run(AOIEngine, AK, DC, frames, caps, MS_RADIUS,
                          MS_WARMUP, keep=True, fused=True, cohort="solo")
    eng, hs = runs["solo"].pop("engine")
    for h in hs:
        eng.release_space(h)
    left = len(eng._buckets)
    del eng, hs
    gc.collect()
    torch.cuda.empty_cache()
    runs["solo"]["allocated_after_release"] = torch.cuda.memory_allocated()
    check(left == 0, f"phase 20: {left} solo buckets outlived their spaces")
    check(runs["solo"]["allocated_after_release"] - alloc0 <= 16 << 20,
          f"phase 20: solo release left "
          f"{runs['solo']['allocated_after_release'] - alloc0} bytes")
    co, so = runs["cohort"], runs["solo"]
    check(co["crcs"] == so["crcs"] == runs["cpu"]["crcs"],
          "phase 20: cohort / solo / cpu CRCs differ")
    check(co["buckets"] == 1 and so["buckets"] == MS_SPACES,
          f"phase 20: buckets {co['buckets']} / {so['buckets']}")
    check(co["dispatches_per_tick"] == 1
          and so["dispatches_per_tick"] == MS_SPACES,
          f"phase 20: dispatches a tick {co['dispatches_per_tick']} / "
          f"{so['dispatches_per_tick']}")
    ratio = co["dispatches_per_tick"] / so["dispatches_per_tick"]
    check(ratio <= 0.05, f"phase 20: dispatch ratio {ratio}")
    check(co["new_keys_after_warmup"] == so["new_keys_after_warmup"] == 0,
          "phase 20: a capture key after warm-up")
    eng_c, _hs_c = co["engine"]
    (bucket,) = eng_c._buckets.values()
    check(bucket.stats["cohort_dispatches"] == MS_TICKS
          and bucket.stats["fused_dispatches"] >= MS_TICKS - 1,
          f"phase 20: cohort bucket stats {bucket.stats}")
    # the Runtime with quiet spaces: still one replay a tick (the staged-
    # row mask), equal to the cpu backend's Runtime
    rt, rows = quiet_runtime(Runtime, DC, aoi_cohort=True, aoi_fused=True,
                             aoi_cohort_ladder=MS_LADDER)
    rb = list(rt.aoi._buckets.values())
    check(len(rb) == 1 and rb[0].cohort,
          f"phase 20: Runtime buckets {list(rt.aoi._buckets)}")
    rt_stats = dict(rb[0].stats)
    del rt, rb
    rt_cpu, rows_cpu = quiet_runtime(Runtime, DC, aoi_backend="cpu")
    del rt_cpu
    check([r[:2] for r in rows] == [r[:2] for r in rows_cpu],
          "phase 20: quiet Runtime CRCs differ from the cpu backend's")
    steady = [r[2] for r in rows[1 + MS_WARMUP:]]
    check(steady == [1] * len(steady),
          f"phase 20: quiet Runtime dispatches a tick {steady}")
    check(rt_stats["fused_dispatches"] >= len(steady),
          f"phase 20: quiet Runtime stats {rt_stats}")
    out = {"spaces": MS_SPACES, "entities": MS_N, "capacity": MS_CAP,
           "ladder": list(MS_LADDER), "ticks": MS_TICKS,
           "warmup": MS_WARMUP, "crc": co["crcs"][-1],
           "dispatch_ratio": ratio,
           "runs": {k: {kk: vv for kk, vv in v.items()
                        if kk not in ("crcs", "engine")}
                    for k, v in runs.items()},
           "runtime_quiet": {"rows": rows, "steady_dispatches": steady,
                             "fused_dispatches": rt_stats[
                                 "fused_dispatches"]},
           "launches": AK.launches["aoi_step"]}
    log("phase 20", json.dumps(out))
    return out, co["engine"]


def phase_ladder(AOIEngine, AK, DC):
    """Phase 20b: the full ladder (256/1024/4096): LADDER_SPACES spaces,
    capacities from the seed uniform in LADDER_CAPS, LADDER_FILL of each
    occupied, world side 1000 * sqrt(n / 96) (phase 20's density), r 100,
    10% movers: the cohort engine (fused; one bucket a rung), the classic
    pooling (cohort=False, fused: one bucket a rounded capacity), the cpp
    backend (the CRC truth) and the cohort engine paged: equal per-tick
    CRCs; dispatches and ms a tick of each."""
    rng = np.random.default_rng(41)
    caps = [int(c) for c in rng.integers(LADDER_CAPS[0],
                                         LADDER_CAPS[1] + 1, LADDER_SPACES)]
    ns = [int(c * LADDER_FILL) for c in caps]
    worlds = [MS_WORLD * float(np.sqrt(n / MS_N)) for n in ns]
    frames = ms_frames(ns, worlds, MS_TICKS, seed=43)
    AK.reset_launches()
    runs = {}
    for name, kw in (("cpp", {"default_backend": "cpp"}),
                     ("cohort", {"fused": True, "cohort": "auto"}),
                     ("classic", {"fused": True}),
                     ("cohort paged", {"fused": True, "cohort": "auto",
                                       "paged": True})):
        runs[name] = ms_run(AOIEngine, AK, DC, frames, caps, MS_RADIUS,
                            MS_WARMUP, **kw)
        torch.cuda.empty_cache()
    for name in ("cohort", "classic", "cohort paged"):
        check(runs[name]["crcs"] == runs["cpp"]["crcs"],
              f"phase 20b: {name} CRCs differ from cpp's")
    check(runs["cohort"]["buckets"] == 3
          and runs["cohort"]["dispatches_per_tick"] == 3,
          f"phase 20b: cohort {runs['cohort']['buckets']} buckets, "
          f"{runs['cohort']['dispatches_per_tick']} dispatches a tick")
    check(runs["cohort"]["new_keys_after_warmup"] == 0,
          "phase 20b: a capture key after warm-up")
    out = {"spaces": LADDER_SPACES, "caps": caps,
           "rungs": {str(r): sum(1 for c in caps if
                                 (r // 4 if r > 256 else 0) < c <= r)
                     for r in (256, 1024, 4096)},
           "runs": {k: {kk: vv for kk, vv in v.items() if kk != "crcs"}
                    for k, v in runs.items()},
           "crc": runs["cpp"]["crcs"][-1],
           "launches": AK.launches["aoi_step"]}
    log("phase 20b", json.dumps(out))
    return out


def demote_frames(ticks, seed):
    """scripts/multispace_smoke.py's shard: 24 spaces, cap - 32 entities
    each in a 400 x 400 world, r in [20, 60], 30% movers up to 8 a tick."""
    rng = np.random.default_rng(seed)
    scenes = []
    for cap in DEMOTE_CAPS:
        n = cap - 32
        scenes.append([rng.uniform(0, 400, n).astype(np.float32),
                       rng.uniform(0, 400, n).astype(np.float32),
                       rng.uniform(20, 60, n).astype(np.float32)])
    frames = []
    for _t in range(ticks):
        for sc in scenes:
            move = rng.random(len(sc[0])) < 0.3
            k = int(move.sum())
            sc[0][move] += rng.uniform(-8, 8, k).astype(np.float32)
            sc[1][move] += rng.uniform(-8, 8, k).astype(np.float32)
        frames.append([(x.copy(), z.copy(), r) for x, z, r in scenes])
    return frames


def demote_drive(eng, hs, frames, after=None):
    """Per-tick CRCs of the shard through ``eng``; ``after(t)`` runs
    after tick t (a planner's step)."""
    crcs = []
    for t, frame in enumerate(frames):
        for h, (x, z, r) in zip(hs, frame):
            eng.submit(h, x, z, r, np.ones(len(x), bool))
        eng.flush()
        crcs.append(f"{fold_events([eng.take_events(h) for h in hs]):08x}")
        if after is not None:
            after(t)
    return crcs


def phase_demotion(AOIEngine, PL, AK, FT):
    """Phase 20c: the aoi.cohort seam and the planner on the card at
    scripts/multispace_smoke.py's 24 spaces (one rung, 256): ``fail``,
    ``oom`` and ``reset`` at the seam's 4th crossing, split-phase and
    sequential flush: the cohort demotes in that tick (24 spaces onto solo
    buckets) with the fault-free run's CRCs, ``recohort()`` stacks all 24
    back on one bucket and 2 more ticks (a second walk) stay equal; then
    CohortPlanner(mode="auto") with a tiny hot_ms sheds one member a
    window and with a large one folds them back, CRCs unchanged."""
    frames = demote_frames(DEMOTE_TICKS, 11) + demote_frames(2, 12)
    AK.reset_launches()
    ladder = {"cohort": "auto", "cohort_ladder": (256,)}
    eng = AOIEngine(device=DEV, **ladder)
    hs = [eng.create_space(c) for c in DEMOTE_CAPS]
    ref = demote_drive(eng, hs, frames)
    del eng, hs
    runs = []
    for sched in (True, False):
        for kind in ("fail", "oom", "reset"):
            FT.install(f"aoi.cohort:{kind}@{DEMOTE_AT}")
            try:
                eng = AOIEngine(device=DEV, flush_sched=sched, **ladder)
                hs = [eng.create_space(c) for c in DEMOTE_CAPS]
                t0 = time.perf_counter()
                crcs = demote_drive(eng, hs, frames[:DEMOTE_TICKS])
                drive_s = time.perf_counter() - t0
                fired = [(f["seam"], f["kind"], f["occurrence"])
                         for f in FT.plan().fired]
            finally:
                FT.clear()
            label = f"phase 20c {kind} flush_sched={sched}"
            st = dict(eng.cohort_stats)
            check(fired == [("aoi.cohort", kind, DEMOTE_AT)],
                  f"{label}: fired {fired}")
            check(st["cohort_demoted_spaces"] == len(DEMOTE_CAPS)
                  and not any(getattr(h.bucket, "cohort", False)
                              for h in hs), f"{label}: {st}")
            moved = eng.recohort()
            check(moved == len(DEMOTE_CAPS)
                  and len({id(h.bucket) for h in hs}) == 1,
                  f"{label}: recohort moved {moved}")
            crcs += demote_drive(eng, hs, frames[DEMOTE_TICKS:])
            check(crcs == ref, f"{label}: CRCs differ from the fault-free "
                               f"run's")
            runs.append({"kind": kind, "flush_sched": sched,
                         "demoted": st["cohort_demoted_spaces"],
                         "restacked": moved, "drive_ms": drive_s * 1e3,
                         "demote_ms": eng.migration_stats["migration_ms"]})
            del eng, hs
    # the planner: a tiny hot_ms sheds a member each window, a large one
    # folds the solo spaces back
    eng = AOIEngine(device=DEV, **ladder)
    hs = [eng.create_space(c) for c in DEMOTE_CAPS]
    planner = PL.CohortPlanner(eng, mode="auto", hot_ms=1e-6,
                               churn_budget=1, cooldown_ticks=0)

    def step(t):
        if t == 4:
            planner.hot_ms = 1e9  # from here on every solo space is light
            planner.churn_budget = 4
        planner.step()

    crcs = demote_drive(eng, hs, frames, after=step)
    st = dict(eng.cohort_stats)
    check(crcs == ref, "phase 20c planner: CRCs differ")
    check(st["cohort_leaves"] >= 3 and st["cohort_joins"] == st[
        "cohort_leaves"] and all(h.bucket.cohort for h in hs),
          f"phase 20c planner: {st}")
    out = {"runs": runs, "planner": st, "ref_crc": ref[-1],
           "launches": AK.launches["aoi_step"]}
    log("phase 20c", json.dumps(out))
    return out


class LaunchShapes:
    """While entered, records the (S, C) of every square chg launch of
    ``aoi_step.cu`` and whether it carried row masks (a spy around
    ops/aoi_cuda._launch: a captured graph's launch passes through it at
    capture, its replays run the same shape).  It counts nothing: the
    launch counts stay the wrapper's."""

    def __init__(self, AK):
        self.AK, self.shapes = AK, {}

    def __enter__(self):
        self._launch = self.AK._launch

        def spy(mode, x, z, radius, active, prev, cols, row_ids, out,
                stg=None, sub=None):
            if mode == "aoi_step" and cols is None:
                key = tuple(x.shape)
                self.shapes[key] = self.shapes.get(key, False) or (
                    stg is not None)
            return self._launch(mode, x, z, radius, active, prev, cols,
                                row_ids, out, stg, sub)

        self.AK._launch = spy
        return self

    def __exit__(self, *exc):
        self.AK._launch = self._launch


def phase_rung_shapes(AK, AD, shapes):
    """Phase 20d: ``aoi_step.cu`` against its plain version at every (S, C)
    that phases 20-20c launched (``shapes``: (S, C) -> launched with row
    masks), bit-exact, unmasked and under random row masks; ms (under
    all-ones masks where the path launched it masked), the plain step's
    ms (one run) and the bound."""
    rows = []
    for i, ((s, c), masked) in enumerate(sorted(shapes.items())):
        x, z, r, act, prev = edge_inputs(s, c, seed=300 + i)
        new_k, chg_k = AK.aoi_step_chg_cuda(x, z, r, act, prev)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        new_p, chg_p = AD.aoi_step_chg_dense(x, z, r, act, prev)
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1)
        err = max(word_diff(new_k, new_p), word_diff(chg_k, chg_p))
        del new_k, chg_k
        err = max(err, masked_err(AK, x, z, r, act, prev, new_p, chg_p,
                                  seed=400 + i))
        del new_p, chg_p
        check(err == 0, f"phase 20d: aoi_step kernel != plain at S={s} "
                        f"C={c} (max |diff| {err})")
        ones = torch.ones(s, dtype=torch.int32, device=DEV)
        mk = {"stg": ones, "sub": ones} if masked else {}
        ms = cuda_ms(lambda: AK.aoi_step_chg_cuda(x, z, r, act, prev, **mk),
                     reps=20)
        bound_ms, bound_by = aoi_step_bound(s, c)
        rows.append({"shape": [s, c], "masked": masked, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "max_abs_err": err})
        del x, z, r, act, prev
    torch.cuda.empty_cache()
    log("phase 20d", json.dumps(rows))
    return rows


def fused_graph_ms(AK, AS, FZ, reps=20, warm=3):
    """Phase 14c: the device ms of one fused replay (ops/fused.FusedTri,
    CUDA events around ``run``) at phase 4's shape and widths (8 x 16384,
    10,000 entities a space, world 4000, r 100), a 10% walk of step 5 a
    tick, every row subscribed: with every row staged (a steady tick)
    and with a quarter of the rows quiet (a cohort's quiet members).  Runs
    after every path has been read, and puts the launch counts back."""
    s, c = MAIN_SHAPE
    launches0 = dict(AK.launches)
    rng = np.random.default_rng(17)
    hx = np.zeros((s, c), np.float32)
    hz = np.zeros((s, c), np.float32)
    hx[:, :PER_SPACE] = rng.uniform(0, WORLD, (s, PER_SPACE))
    hz[:, :PER_SPACE] = rng.uniform(0, WORLD, (s, PER_SPACE))
    act = np.zeros((s, c), bool)
    act[:, :PER_SPACE] = True
    x, z = (torch.from_numpy(a).to(DEV) for a in (hx, hz))
    r = torch.full((s, c), RADIUS, dtype=torch.float32, device=DEV)
    act = torch.from_numpy(act).to(DEV)
    fz = FZ.FusedTri(s, c, FZ.packet_len(s, c, 0.25), torch.device(DEV))
    fz.words[0].copy_(AK.aoi_step_chg_cuda(x, z, r, act,
                                           torch.zeros_like(fz.words[0]))[0])
    fz.set_sub(np.ones(s, bool))
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    out = {}
    for label, quiet in (("all staged", 0), ("a quarter quiet", 4)):
        staged = np.ones(s, bool)
        if quiet:
            staged[::quiet] = False
        fz.set_staged(staged)
        times = []
        for t in range(warm + reps):
            mv = (rng.random((s, PER_SPACE)) < 0.1) & staged[:, None]
            rows, cols = np.nonzero(mv)
            for h in (hx, hz):
                h[rows, cols] = np.clip(
                    h[rows, cols] + rng.uniform(-STEP, STEP, len(rows)), 0,
                    WORLD)
            fz.load_packet(t % 2, *AS.pad_packet(
                rows, cols, hx[rows, cols], hz[rows, cols], length=fz.plen))
            e0.record()
            fz.run(t % 2, 1 << 20, x, z, r, act)
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        out[label] = sum(times[warm:]) / reps
    AK.launches.update(launches0)
    log("phase 14c", json.dumps(out))
    return out


def span_tree_ok(doc):
    """Every X span of a Chrome trace lies inside the spans that enclose
    it in TICK_SPANS's nesting (aoi.dispatch/harvest in aoi.flush, it and
    aoi.emit in tick.aoi, the phases in tick)."""
    parent = {"aoi.dispatch": "aoi.flush", "aoi.harvest": "aoi.flush",
              "aoi.flush": "tick.aoi", "aoi.emit": "tick.aoi",
              "tick.timers": "tick", "tick.aoi": "tick", "tick.sync": "tick",
              "tick.post": "tick"}
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    by = {}
    for e in xs:
        by.setdefault(e["name"], []).append(e)
    n = 0
    for e in xs:
        p = parent.get(e["name"])
        if p is None:
            continue
        n += 1
        if not any(o["ts"] <= e["ts"] and e["ts"] + e["dur"]
                   <= o["ts"] + o["dur"] + 1e-3 for o in by.get(p, ())):
            return False, n
    return True, n


def phase_telemetry(Runtime, AK, DC, TEL, main_crcs, main_out, cohort_eng):
    """Phase 21: phase 4's world and schedule with Runtime(telemetry_on=
    True) and with it off, in turns: per-tick CRCs equal phase 4's, tick
    ms on and off (their difference the overhead), the tick's spans
    present and nested in the Chrome export (which loads as JSON), and
    render_prometheus() parsing with the aoi.* families of a live cohort
    engine (phase 20's)."""
    from goworld_tpu_torch.telemetry import trace as TR

    runs = []
    for mode in TELEMETRY_TURNS:
        TR.reset()
        out, rows, trailing = run_schedule(Runtime, AK, DC, mode,
                                           PIPE_SCHEDULE, 1 + WARMUP)
        check([r[:2] for r in rows] == [tuple(c) for c in main_crcs]
              and trailing[1] == 0, f"phase 21 {mode}: CRCs differ from "
                                    f"phase 4's")
        if mode == "telemetry on":
            names = [nm for nm, *_ in TR.spans()]
            missing = [nm for nm in TICK_SPANS if nm not in names]
            check(not missing, f"phase 21: spans missing {missing}")
            doc = json.loads(json.dumps(TR.export_chrome_trace(
                last_ticks=4)))
            nested, n_nested = span_tree_ok(doc)
            check(nested and n_nested > 0, "phase 21: spans not nested")
            out["spans"] = {nm: names.count(nm) for nm in TICK_SPANS}
            out["chrome_events"] = len(doc["traceEvents"])
            TEL.disable()
        out["crc"] = main_out["crc"]
        runs.append(out)
        log("phase 21", json.dumps(out))
    # the exposition: the cohort engine of phase 20 is alive
    eng, _hs = cohort_eng
    text = TEL.render_prometheus()
    fams, samples = {}, 0
    for ln in text.splitlines():
        if ln.startswith("# TYPE "):
            _, _, name, kind = ln.split()
            fams[name] = kind
        elif ln and not ln.startswith("#"):
            name, val = ln.rsplit(" ", 1)
            float(val)
            samples += 1
    lbl = 'engine="%d"' % eng._telemetry_id
    want = ("gw_aoi_buckets", "gw_aoi_cohorts", "gw_aoi_cohort_spaces",
            "gw_aoi_cohort_joins_total", "gw_aoi_cohort_leaves_total",
            "gw_aoi_cohort_demoted_spaces_total",
            "gw_aoi_cohort_dispatches_total", "gw_aoi_fused_dispatches_total",
            "gw_aoi_stage_seconds_total", "gw_aoi_migrations_total",
            "gw_faults_active", "gw_accelerator_absent")
    check(all(w in fams for w in want),
          f"phase 21: families missing {[w for w in want if w not in fams]}")
    check(f"gw_aoi_cohorts{{{lbl}}} 1" in text
          and f"gw_aoi_cohort_spaces{{{lbl}}} {MS_SPACES}" in text
          and "gw_accelerator_absent 0" in text,
          "phase 21: the cohort engine's gauges")
    mean = {m: mean_of(runs, m, "tick_ms") for m in ("telemetry off",
                                                     "telemetry on")}
    # one span's own cost with tracing on (enter, two clock reads, the
    # ring append), times the spans a tick records
    TEL.enable()
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        with TR.span("tick.aoi"):
            pass
    span_us = (time.perf_counter() - t0) * 1e6 / n
    TEL.disable()
    out = {"runs": runs, "tick_ms": mean,
           "overhead_ms": mean["telemetry on"] - mean["telemetry off"],
           "span_us": span_us,
           "spans_per_tick": len(TICK_SPANS),
           "prometheus": {"families": len(fams), "samples": samples},
           "launches": sum(r["launches"] for r in runs)}
    log("phase 21", json.dumps({k: v for k, v in out.items()
                                if k != "runs"}))
    return out


def interest_entry(interest_k, interest_slice, load_out, moved):
    """The ``kernels`` line's entry of csrc/interest_step.cu: its times
    at the main path's full team + tier + LOS step (C = 16384, a path
    step's planes; from random planes beside), the off step beside them,
    its ms a step on phase 18b's path, its launches on each path."""
    rows = interest_k["rows"]
    full = next(r for r in rows if r["step"] == "full"
                and r["combo"] == "team+tier+los")
    off = next(r for r in rows if r["step"] == "off")
    paths = {**interest_slice["launches"], "load": load_out["launches"],
             **moved}
    return {"name": "interest_step", "route": "cuda",
            "source": "goworld_tpu_torch/csrc/interest_step.cu",
            "replaces": "goworld_tpu/interest/device.py:32",
            "launches": sum(paths.values()), "max_abs_err": 0,
            "ms": full["ms"], "plain_ms": full["plain_ms"],
            "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
            "library_ms": None, "shape": full["shape"],
            "ms_random_planes": full["ms_random_planes"],
            "off_step": {k: off[k] for k in ("ms", "ms_random_planes",
                                             "plain_ms", "bound_ms",
                                             "bound_by")},
            "main_path_kernel_ms_per_step": interest_slice["splits"][
                "kernel"]["kernel_ms"],
            "path_launches": paths, "cases": interest_k["cases"],
            "shapes": rows}


# -- phase 22: the game server over the wire -----------------------------------

# phase 22: phase 4's world (8 x 10,000 in 16384 slots, world 4000, r 100,
# step 5) as the spaces of one game: of each space's entities GAME_CLIENTS
# are client avatars (256 in all), joined and walking in one patch of the
# space so that they see each other, the rest server-side NPCs that walk
# every POSITION_SYNC_INTERVAL_MS; each client moves once every 100 ms
GAME_CLIENTS = 32
GAME_PATCH = 150.0
# 22a: the scripted run (cpp costs about 0.66 s a tick at this world); a
# client moves every GAME_EVERY-th tick; the NPCs walk at GAME_NPC_TICKS
# (at 12 after nine client-only ticks, whose few events decay the triple
# cap; at 13 again with the cap grown back)
GAME_SCRIPT_TICKS = 14
GAME_EVERY = 10
GAME_NPC_TICKS = (2, 12, 13)
# 22b: warm-up and steady seconds of the live run; ticks run after the
# clients' last move is ingested, before the mirrors are read; the longest
# wait for a process or a state
GAME_WARM_S, GAME_STEADY_S = 5.0, 30.0
# bot processes, each with whole spaces' clients: one Python process
# saturates its core at 256 clients, sends fewer than the 2,560 moves a
# second, and its backlog reads as move latency
GAME_BOT_PROCS = 4
GAME_QUIET_TICKS = 8
GAME_DRAIN_S = 0.5  # no client move ingested for this long: five gate flushes
GAME_WAIT_S = 120.0
SYNC_RECORD = 48  # client id, entity id, x, y, z, yaw


def port_game_mods():
    """The port's modules the scripted game runs on (the tests build the
    same namespace over the JAX package)."""
    import types

    from goworld_tpu_torch import config, telemetry
    from goworld_tpu_torch.components.game import service as game_service
    from goworld_tpu_torch.engine import ids, manager
    from goworld_tpu_torch.engine.entity import Entity
    from goworld_tpu_torch.engine.rpc import OWN_CLIENT, rpc
    from goworld_tpu_torch.engine.space import Space
    from goworld_tpu_torch.engine.vector import Vector3
    from goworld_tpu_torch.netutil import Packet
    from goworld_tpu_torch.proto import GWConnection
    from goworld_tpu_torch.proto import msgtypes as MT

    return types.SimpleNamespace(
        config=config, telemetry=telemetry,
        GameService=game_service.GameService,
        id_modules=(ids, manager, game_service), fixed_id=ids.fixed_id,
        Entity=Entity, Space=Space, Vector3=Vector3, rpc=rpc,
        OWN_CLIENT=OWN_CLIENT, Packet=Packet, GWConnection=GWConnection,
        MT=MT, device_key=True)


def game_types(m):
    """The smoke game's entity types over the engine of ``m``."""

    class SmokeScene(m.Space):
        pass

    class SmokeNpc(m.Entity):
        use_aoi = True
        aoi_distance = RADIUS

    class SmokeAvatar(m.Entity):
        use_aoi = True
        aoi_distance = RADIUS
        all_client_attrs = frozenset({"name"})
        client_attrs = frozenset({"secret"})

        def on_created(self):
            self.attrs.set("name", "anon")
            self.attrs.set("secret", 7)
            self.set_client_syncing(True)

        @m.rpc(expose=m.OWN_CLIENT)
        def join(self, space, x, z):
            sp = self._runtime().game.smoke_spaces[space]
            self.enter_space(sp.id, m.Vector3(x, 0.0, z))

        @m.rpc(expose=m.OWN_CLIENT)
        def set_name(self, name):
            self.attrs.set("name", name)

        def on_client_disconnected(self):
            self.destroy()

    return SmokeScene, SmokeNpc, SmokeAvatar


class CounterIds:
    """One counter stood in for ``gen_id`` in each of ``modules``: a script
    then names its entities alike in every run and in both packages."""

    def __init__(self, modules):
        self.n = 0
        self.saved = [(mod, mod.gen_id) for mod in modules]
        for mod in modules:
            mod.gen_id = self

    def __call__(self):
        self.n += 1
        return f"E{self.n:015d}"

    def restore(self):
        for mod, f in self.saved:
            mod.gen_id = f


class RecorderPC:
    """A PacketConnection that keeps the payload of every packet sent."""

    closed = False

    def __init__(self):
        self.sent = []

    def send_packet(self, p, release=True):
        self.sent.append(p.payload)
        if release:
            p.release()

    def flush(self):
        return 0

    def close(self):
        pass


class RecorderCluster:
    """A game's DispatcherCluster with no dispatcher: every route is one
    connection of the game's package over a :class:`RecorderPC`."""

    def __init__(self, GWConnection):
        self.pc = RecorderPC()
        self.conn = GWConnection(self.pc)
        self.conns = [self.conn]
        self.addrs = [("recorder", 0)]

    def by_entity(self, _key):
        return self.conn

    by_gate = by_srvid = by_entity

    def all(self):
        return [self.conn]

    def flush_all(self):
        pass

    def start(self):
        pass

    def stop(self):
        pass

    def renew_leases(self, *a, **kw):
        pass

    def take(self):
        out, self.pc.sent = self.pc.sent, []
        return out


def canonical(payloads, MT):
    """A tick's outbound payloads, sorted; a position-sync batch's records
    sorted too.  The engine walks its dirty set and each entity's
    ``interested_by`` set in hash order, which differs between runs (and
    between the packages); what is sent does not."""
    out = []
    for b in payloads:
        if int.from_bytes(b[:2], "little") == MT.MT_SYNC_POSITION_YAW_ON_CLIENTS:
            body = b[4:]
            b = b[:4] + b"".join(sorted(
                body[i:i + SYNC_RECORD]
                for i in range(0, len(body), SYNC_RECORD)))
        out.append(b)
    return sorted(out)


def client_patches(spaces, clients, seed, world):
    """Each client's patch (lower corner) and join position."""
    rng = np.random.default_rng(seed)
    center = rng.uniform(GAME_PATCH, world - GAME_PATCH, (spaces, 2))
    lo = np.repeat(center - GAME_PATCH / 2, clients, axis=0)
    pos = lo + rng.uniform(0, GAME_PATCH, lo.shape)
    return lo.astype(np.float32), pos.astype(np.float32)


def client_ids(n):
    return ([f"C{i:015d}" for i in range(n)],
            [f"A{i:015d}" for i in range(n)])


def game_script(spaces, clients, ticks, every, seed, world):
    """Per tick, the payloads a dispatcher would deliver to the smoke game:
    deployment ready and every client's connect (tick 0), each client's
    join RPC (1), one client-move batch a tick from tick 2 (each client
    every ``every``-th tick), client 0's attr RPC (3) and client 1's
    disconnect (``ticks - 2``)."""
    import struct

    from goworld_tpu_torch.netutil import Packet
    from goworld_tpu_torch.proto import msgtypes as MT

    n = spaces * clients
    cids, eids = client_ids(n)
    lo, pos = client_patches(spaces, clients, seed, world)
    rng = np.random.default_rng(seed + 1)
    script = [[] for _ in range(ticks)]
    script[0].append(Packet.for_msgtype(MT.MT_NOTIFY_DEPLOYMENT_READY).payload)
    for i in range(n):
        p = Packet.for_msgtype(MT.MT_NOTIFY_CLIENT_CONNECTED)
        p.append_client_id(cids[i])
        p.append_entity_id(eids[i])
        p.append_u16(1)
        script[0].append(p.payload)

    def call(t, i, method, *args):
        p = Packet.for_msgtype(MT.MT_CALL_ENTITY_METHOD_FROM_CLIENT)
        p.append_entity_id(eids[i])
        p.append_varstr(method)
        p.append_args(args)
        p.append_client_id(cids[i])
        script[t].append(p.payload)

    for i in range(n):
        call(1, i, "join", i // clients, float(pos[i, 0]), float(pos[i, 1]))
    call(3, 0, "set_name", "bob")
    for t in range(2, ticks):
        movers = np.arange(t % every, n, every)
        q = pos[movers] + rng.uniform(-STEP, STEP, (len(movers), 2))
        pos[movers] = np.clip(q, lo[movers], lo[movers] + GAME_PATCH)
        p = Packet.for_msgtype(MT.MT_SYNC_POSITION_YAW_FROM_CLIENT)
        for i in movers:
            p.append_entity_id(eids[i])
            p.append_bytes(struct.pack("<ffff", pos[i, 0], 0.0, pos[i, 1],
                                       0.0))
        script[t].append(p.payload)
    p = Packet.for_msgtype(MT.MT_NOTIFY_CLIENT_DISCONNECTED)
    p.append_client_id(cids[1])
    p.append_entity_id(eids[1])
    script[ticks - 2].append(p.payload)
    return script


def build_game_world(game, m, spaces, per_space, clients, capacity, world,
                     seed):
    """``spaces`` SmokeScenes of ``capacity`` slots, each with ``per_space
    - clients`` NPCs at seeded positions; ``game.smoke_spaces`` lists them
    for the avatars' join RPC."""
    rng = np.random.default_rng(seed)
    game.smoke_spaces = []
    for _ in range(spaces):
        sp = game.rt.entities.create_space("SmokeScene", kind=1)
        sp.enable_aoi(RADIUS, capacity=capacity)
        p = rng.uniform(0, world, (2, per_space - clients)).astype(np.float32)
        for i in range(p.shape[1]):
            game.rt.entities.create("SmokeNpc", space=sp, pos=m.Vector3(
                float(p[0, i]), 0.0, float(p[1, i])))
        game.smoke_spaces.append(sp)


class NpcWalk:
    """The NPCs' walk: a call moves every smoke space's NPCs one seeded
    step of at most STEP (``Space.move_entities``), clipped to the world."""

    def __init__(self, spaces, seed, world):
        self.spaces, self.seed, self.world = spaces, seed, world
        self.calls = 0
        self.slots, self.pos = [], []
        for sp in spaces:
            npcs = sorted((e for e in sp.entities
                           if e.type_name == "SmokeNpc"), key=lambda e: e.id)
            self.slots.append(np.array([e.aoi_slot for e in npcs], np.int64))
            self.pos.append(np.array(
                [[e.position.x for e in npcs], [e.position.z for e in npcs]],
                np.float32))

    def __call__(self):
        rng = np.random.default_rng((self.seed, self.calls))
        self.calls += 1
        for sp, sl, p in zip(self.spaces, self.slots, self.pos):
            q = p + rng.uniform(-STEP, STEP, p.shape).astype(np.float32)
            p[:] = np.clip(q, 0, self.world)
            sp.move_entities(sl, p[0], p[1])


def game_ini(backend, device=None, dispatcher=None, gate=None):
    lines = ["[deployment]", "dispatchers = 1", "games = 1", "gates = 1", "",
             "[game1]", "boot_entity = SmokeAvatar",
             f"aoi_backend = {backend}", "save_interval_s = 0"]
    if device is not None:
        lines.append(f"aoi_device = {device}")
    if dispatcher is not None:
        lines += ["", "[dispatcher1]", "host = 127.0.0.1",
                  f"port = {dispatcher}"]
    if gate is not None:
        lines += ["", "[gate1]", "host = 127.0.0.1", f"port = {gate}"]
    return "\n".join(lines) + "\n"


class ErrorCount:
    """Counts the ERROR records of a game's logger: run_panicless logs a
    tick's exception there, and the loop goes on."""

    def __init__(self, log_):
        import logging

        count = self

        class H(logging.Handler):
            def emit(self, record):
                count.n += 1
                count.last = record.getMessage()[:2000]

        self.n, self.last = 0, ""
        self.log, self.handler = log_, H(logging.ERROR)
        log_.addHandler(self.handler)

    def close(self):
        self.log.removeHandler(self.handler)


class LoopSplit:
    """Times a game loop's parts on the host clock: inbound handling
    (``_handle``), ``Runtime.tick`` (``sync()`` at its end), the outbox
    drain, ``_send_position_syncs`` and ``flush_all``.  An iteration ends
    at ``flush_all``; ``rows`` keeps each iteration's parts in ms, and
    with ``probe`` (the kernel's launch count) whether its tick
    launched the kernel."""

    PARTS = ("inbound", "tick", "outbox", "syncs", "flush")

    def __init__(self, game, sync, probe=None):
        self.rows, self.cur = [], dict.fromkeys(self.PARTS, 0.0)
        self.saved, self.probe, self.launched = [], probe, False
        for part, owner, name in (
                ("inbound", game, "_handle"), ("tick", game.rt, "tick"),
                ("outbox", game, "_drain_client_outboxes"),
                ("syncs", game, "_send_position_syncs"),
                ("flush", game.cluster, "flush_all")):
            self.saved.append((owner, name))
            setattr(owner, name, self.timed(part, getattr(owner, name),
                                            sync if part == "tick" else None))

    def timed(self, part, inner, after):
        def run(*a, **kw):
            n0 = self.probe() if self.probe and part == "tick" else 0
            t0 = time.perf_counter()
            try:
                out = inner(*a, **kw)
                if after is not None:
                    after()
                return out
            finally:
                self.cur[part] += (time.perf_counter() - t0) * 1e3
                if part == "tick" and self.probe:
                    self.launched = self.probe() > n0
                if part == "flush":
                    row, self.cur = self.cur, dict.fromkeys(self.PARTS, 0.0)
                    row["loop"] = sum(row.values())
                    if self.probe:
                        row["launched"], self.launched = self.launched, False
                    self.rows.append(row)
        return run

    def restore(self):
        for owner, name in self.saved:
            try:
                delattr(owner, name)  # the instance attribute over the method
            except AttributeError:
                pass

    @staticmethod
    def summary(rows):
        out = {}
        for key in LoopSplit.PARTS + ("loop",):
            v = np.array([r[key] for r in rows]) if rows else np.zeros(1)
            out[key] = {"p50": float(np.percentile(v, 50)),
                        "p99": float(np.percentile(v, 99)),
                        "mean": float(v.mean())}
        return out


class ScriptedGame:
    """One GameService of the package ``m`` (see :func:`port_game_mods`)
    whose DispatcherCluster is a recorder, driven by ``step()``: the
    inbound payloads of a script in, each tick's outbound payloads and AOI
    event CRC out.  ``restore`` starts it from the freeze file in
    ``tmpdir`` (the JAX package's ``_do_freeze`` format) instead of a nil
    space."""

    def __init__(self, m, backend, device, tmpdir, restore=False):
        self.m = m
        ini = game_ini(backend, device if m.device_key else None)
        self.game = g = m.GameService(1, m.config.loads(ini),
                                      freeze_dir=str(tmpdir))
        self.rec = g.cluster = RecorderCluster(m.GWConnection)
        for cls in game_types(m):
            g.register_entity_type(cls)
        if restore:
            g._is_restore = True
            g._restore_from_freeze()
        else:
            g.nil_space = g.rt.entities.create(
                "__nil_space__", eid=m.fixed_id(f"nilspace-game{g.id}"))
        # the per-tick CRC folds the events delivered to subscribed spaces:
        # a space no entity observes is unsubscribed, and the card then
        # emits no events for it (its state is still computed) where the
        # host calculators emit them anyway, unread
        self.crc = {"t": 0}
        take = g.rt.aoi.take_events

        def folding_take(h):
            ev = take(h)
            if any(sp._aoi_handle is h and sp._aoi_subscribed
                   for sp in g.rt.entities.spaces.values()):
                for a in ev:
                    self.crc["t"] = zlib.crc32(
                        np.ascontiguousarray(a).tobytes(), self.crc["t"])
            return ev

        g.rt.aoi.take_events = folding_take

    def run(self, script, ticks, walk=None, walk_at=(), after=None):
        """Feed ``script[t]`` and step once for each ``t`` in ``ticks``
        (``walk`` as a timer of the tick at the ``walk_at`` ticks;
        ``after()`` after each step); returns each tick's canonical
        payloads and event CRC."""
        out, crcs = [], []
        g = self.game
        for t in ticks:
            for b in script[t]:
                g.queue.put((0, self.m.Packet(bytearray(b))))
            if t in walk_at:
                g.rt.timers.add(0.0, walk)
            self.crc["t"] = 0
            g.step()
            if after is not None:
                after()
            out.append(canonical(self.rec.take(), self.m.MT))
            crcs.append(f"{self.crc['t']:08x}")
        return out, crcs


def scripted_run(m, backend, device, tmpdir, spaces, per_space, clients,
                 capacity, world, ticks=GAME_SCRIPT_TICKS, every=GAME_EVERY,
                 walk_at=GAME_NPC_TICKS, seed=11, split_sync=None):
    """22a and its CPU twin: the script on a fresh game of ``m``; returns
    the setup payloads, each tick's payloads and CRCs, the game, and with
    ``split_sync`` the loop split of every step and the cuda bucket's
    ``decode_overflow`` after it."""
    ids = CounterIds(m.id_modules)
    try:
        sg = ScriptedGame(m, backend, device, tmpdir)
        g = sg.game
        build_game_world(g, m, spaces, per_space, clients, capacity, world,
                         seed)
        setup = canonical(sg.rec.take(), m.MT)
        walk = NpcWalk(g.smoke_spaces, seed, world)
        split = LoopSplit(g, split_sync) if split_sync else None
        errors = ErrorCount(g.log)
        script = game_script(spaces, clients, ticks, every, seed, world)
        overflow = []

        def after():
            if split is not None and backend == "cuda":
                overflow.append(bucket_of(g.rt).stats["decode_overflow"])

        out, crcs = sg.run(script, range(ticks), walk, set(walk_at), after)
        if split is not None:
            split.restore()
        errors.close()
    finally:
        ids.restore()
    return {"setup": setup, "ticks": out, "crcs": crcs, "game": g,
            "errors": errors.n, "last_error": errors.last,
            "split": split.rows if split is not None else None,
            "overflow": overflow}


def interest_rows(game, AP):
    """For every avatar in a smoke space: its row of the device's interest
    words and of the plain ``interest_matrix`` over the bucket's staged
    columns, as sets of entity ids.  Runs on the game's logic thread."""
    out = {}
    for sp in game.smoke_spaces:
        h = sp._aoi_handle
        bk = h.bucket
        words = bk.get_prev(h.slot)
        cols = (bk._hx[h.slot], bk._hz[h.slot], bk._hr[h.slot],
                bk._hact[h.slot])
        se = sp._slot_entity

        def ids(row):
            return sorted(se[j].id for j in np.nonzero(row)[0])

        for e in list(sp.entities):
            if e.type_name == "SmokeAvatar":
                i = e.aoi_slot
                out[e.id] = {
                    "device": ids(AP.unpack_rows(words[i:i + 1],
                                                 bk.capacity)[0]),
                    "plain": ids(AP.interest_matrix(*cols, lo=i,
                                                    hi=i + 1)[0])}
    return out


def phase_game_script(AK):
    """22a: the script at phase 4's world on cuda (on the card) and on cpp;
    outbound payloads equal tick by tick, and each tick's event CRC."""
    import tempfile

    m = port_game_mods()
    m.telemetry.disable()
    runs = {}
    for backend, device in (("cuda", DEV), ("cpp", "cpu")):
        torch.cuda.synchronize()
        AK.reset_launches()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            r = scripted_run(m, backend, device, tmp, SPACES, PER_SPACE,
                             GAME_CLIENTS, CAPACITY, WORLD,
                             split_sync=torch.cuda.synchronize)
        r["seconds"] = time.perf_counter() - t0
        r["launches"] = AK.launches["aoi_step"]
        g = r.pop("game")
        r["stats"] = dict(bucket_of(g.rt).stats) if backend == "cuda" \
            else None
        check(r["errors"] == 0, f"22a {backend}: {r['errors']} logged errors:"
              f" {r['last_error']}")
        runs[backend] = r
        log(f"22a {backend}: {r['seconds']:.1f} s, crcs {r['crcs']}")
        del g
        torch.cuda.empty_cache()
    cu, cp = runs["cuda"], runs["cpp"]
    check(cu["setup"] == cp["setup"], "22a: setup payloads differ")
    for t, (a, b) in enumerate(zip(cu["ticks"], cp["ticks"])):
        check(a == b, f"22a tick {t}: outbound payloads differ "
              f"({len(a)} against {len(b)})")
    check(cu["crcs"] == cp["crcs"], f"22a: CRCs {cu['crcs']} != {cp['crcs']}")
    # every tick stages a move but tick 1 (the joins land in its post
    # phase)
    check(cu["launches"] == GAME_SCRIPT_TICKS - 1,
          f"22a: {cu['launches']} launches in {GAME_SCRIPT_TICKS} ticks")
    check(cp["launches"] == 0, "22a: the cpp run launched the kernel")
    stats = cu["stats"]
    healthy(stats, "22a cuda")
    rows = cu["split"]
    # client-only ticks: 3 to 11 (tick 2 also lands the joins)
    client = [rows[t] for t in range(3, GAME_NPC_TICKS[1])]
    out = {"ticks": GAME_SCRIPT_TICKS, "crcs": cu["crcs"],
           "npc_ticks": GAME_NPC_TICKS,
           "packets": [len(t) for t in cu["ticks"]],
           "bytes": [sum(map(len, t)) for t in cu["ticks"]],
           "launches": cu["launches"],
           "tick_ms": [r["tick"] for r in rows],
           "loop_ms": [r["loop"] for r in rows],
           "decode_overflow": cu["overflow"],
           "split_ms": rows, "client_tick_split": LoopSplit.summary(client),
           "npc_tick_split": {k: rows[GAME_NPC_TICKS[2]][k]
                              for k in LoopSplit.PARTS + ("loop",)},
           "cuda_s": cu["seconds"], "cpp_s": cp["seconds"],
           "cpp_tick_ms": [r["tick"] for r in cp["split"]]}
    log("22a", json.dumps({k: v for k, v in out.items() if k != "split_ms"}))
    return out


def free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def proc_cpu_s(pid):
    """User + system CPU seconds of a live process (/proc)."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


class LatencyProbe:
    """The game's stamps on 22b's move latency, on ``time.monotonic``
    (CLOCK_MONOTONIC: one clock for every process of the host, the one
    the bots stamp with): when each client-move batch is ingested, with
    its records, and when each ``_send_position_syncs`` ends."""

    REC = np.dtype([("eid", "S16"), ("x", "<f4"), ("y", "<f4"),
                    ("z", "<f4"), ("yaw", "<f4")])

    def __init__(self, game):
        self.on, self.batches, self.syncs = False, [], []
        self.last = time.monotonic()  # the last batch's ingest, always
        syncs, probe = game._send_position_syncs, self

        class StampedIngest:  # the MovementIngest, its batches stamped
            def __init__(self, inner):
                self.inner = inner

            def ingest(self, pkt):
                probe.last = time.monotonic()
                if probe.on:
                    probe.batches.append((probe.last, np.frombuffer(
                        bytes(pkt.buf[pkt.rpos:]), probe.REC)))
                return self.inner.ingest(pkt)

            def __getattr__(self, name):
                return getattr(self.inner, name)

        def stamped_syncs():
            out = syncs()
            if self.on:
                self.syncs.append(time.monotonic())
            return out

        game.ingest = StampedIngest(game.ingest)
        game._send_position_syncs = stamped_syncs

    def legs(self, players, moves, receipts):
        """Per mirror update: client A's send -> client B's mirror update
        (the move latency); per move: send -> game ingest (the gate's
        batching, the dispatcher), ingest -> the end of the next
        position-sync send (the tick, the sync cadence); per mirror
        update: that send -> the update (dispatcher, gate fan-out, the
        client's read).  ms percentiles of each."""
        idx = {p.encode(): i for i, p in enumerate(players)}
        ing = {}
        for t, recs in self.batches:
            for r in recs:
                key = (idx.get(bytes(r["eid"]), -1), float(r["x"]),
                       float(r["z"]))
                ing.setdefault(key, t)
        syncs = np.array(sorted(self.syncs))

        def after(t):
            k = np.searchsorted(syncs, t)
            return syncs[k] if k < len(syncs) else np.nan

        a, b, c, total = [], [], [], []
        sent = {}
        for i, x, z, t in moves:
            key = (int(i), float(x), float(z))
            sent[key] = t
            ti = ing.get(key)
            if ti is not None:
                a.append(ti - t)
                b.append(after(ti) - ti)
        for i, x, z, t in receipts:
            key = (int(i), float(x), float(z))
            total.append(t - sent[key])
            ti = ing.get(key)
            if ti is not None:
                c.append(t - after(ti))

        def pct(v):
            v = np.array(v, np.float64) * 1e3
            v = v[np.isfinite(v)]
            if not len(v):
                return None
            return {"p50": float(np.percentile(v, 50)),
                    "p99": float(np.percentile(v, 99)), "n": len(v)}

        return {"send_to_mirror": pct(total), "send_to_ingest": pct(a),
                "ingest_to_sync": pct(b), "sync_to_mirror": pct(c),
                "moves_ingested": len(a), "moves_sent": len(moves)}


def phase_game_live(AK):
    """22b: the port's dispatcher and gate as child processes, the game
    in this process on the card, 256 bot clients in GAME_BOT_PROCS more
    children."""
    import signal
    import tempfile

    from goworld_tpu_torch.ops import aoi_predicate as AP
    from goworld_tpu_torch.utils import gwlog

    from goworld_tpu_torch.netutil import compress

    m = port_game_mods()
    m.telemetry.disable()
    # the codec every process of the cluster loads, built here before any
    # child starts (a process on the flate fallback corrupts its peers'
    # frames)
    check(compress.new_compressor("gwlz").name == "gwlz",
          "22b: libgwlz.so did not load")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs, files = {}, {}
    tmpd = tempfile.TemporaryDirectory()
    tmp = tmpd.name
    disp_port, gate_port = free_port(), free_port()
    ini = os.path.join(tmp, "goworld.ini")
    with open(ini, "w") as f:
        f.write(game_ini("cuda", DEV, disp_port, gate_port))

    def spawn(name, args):
        files[name] = open(os.path.join(tmp, f"{name}.log"), "w+")
        procs[name] = subprocess.Popen(
            [sys.executable, *args], cwd=root, env=env,
            stdout=files[name], stderr=subprocess.STDOUT)

    def logged(name, tag):
        with open(os.path.join(tmp, f"{name}.log")) as f:
            return tag in f.read()

    def tail(name):
        with open(os.path.join(tmp, f"{name}.log")) as f:
            return f.read()[-3000:]

    def wait_for(pred, what, timeout=GAME_WAIT_S):
        """Poll ``pred`` until it holds; a child's exit or the timeout
        fails the phase with the children's log tails."""
        deadline = time.monotonic() + timeout
        while not pred():
            gone = [k for k, p in procs.items() if p.poll() is not None]
            late = time.monotonic() >= deadline
            if gone or late:
                logs = "".join(f"\n--- {k}: {tail(k)[-1500:]}"
                               for k in (gone or procs))
                check(False, f"22b: {what}: " + (
                    f"{gone} exited" if gone else "timed out") + logs)
            time.sleep(0.01)

    game = errors = split = None
    try:
        spawn("dispatcher", ["-m", "goworld_tpu_torch.components.dispatcher",
                             "-dispid", "1", "-configfile", ini])
        wait_for(lambda: logged("dispatcher", gwlog.READY_TAG),
                 "dispatcher ready")
        gwlog.setup("warning")
        cfg = m.config.load(ini)
        game = m.GameService(1, cfg, freeze_dir=tmp)
        for cls in game_types(m):
            game.register_entity_type(cls)
        t0 = time.perf_counter()
        build_game_world(game, m, SPACES, PER_SPACE, GAME_CLIENTS, CAPACITY,
                         WORLD, seed=12)
        walk = NpcWalk(game.smoke_spaces, 12, WORLD)
        interval = game.gcfg.position_sync_interval_ms / 1000.0
        walk_tid = game.rt.timers.add(interval, walk, repeat=True,
                                      interval=interval)
        log(f"22b: world built in {time.perf_counter() - t0:.1f} s")
        errors = ErrorCount(game.log)
        split = LoopSplit(game, torch.cuda.synchronize,
                          lambda: AK.launches["aoi_step"])
        probe = LatencyProbe(game)
        game.start()
        spawn("gate", ["-m", "goworld_tpu_torch.components.gate",
                       "-gateid", "1", "-configfile", ini])
        wait_for(lambda: logged("gate", gwlog.READY_TAG), "gate ready")
        wait_for(lambda: game.deployment_ready, "deployment ready")
        check(SPACES % GAME_BOT_PROCS == 0, "22b: spaces per bot process")
        n = SPACES * GAME_CLIENTS
        share = n // GAME_BOT_PROCS
        bots_k = [f"bots{k}" for k in range(GAME_BOT_PROCS)]
        for k, name in enumerate(bots_k):
            spawn(name, [os.path.abspath(__file__), "--bots", json.dumps({
                "gate": ["127.0.0.1", gate_port], "proc": k,
                "first": k * share, "count": share, "spaces": SPACES,
                "per_space": GAME_CLIENTS, "seed": 12, "world": WORLD,
                "dir": tmp, "warm_s": GAME_WARM_S,
                "steady_s": GAME_STEADY_S})])

        def marks(what):
            return all(os.path.exists(os.path.join(tmp, f"{what}-{k}.mark"))
                       for k in range(GAME_BOT_PROCS))

        wait_for(lambda: marks("joined"), "bots joined")
        with open(os.path.join(tmp, "go.mark"), "w"):
            pass
        wait_for(lambda: marks("steady"), "bots warm")
        bucket = bucket_of(game.rt)
        overflow0 = bucket.stats["decode_overflow"]
        rows0, ticks0 = len(split.rows), game.rt.tick_count
        AK.reset_launches()
        probe.on = True
        cpu0 = {k: proc_cpu_s(p.pid) for k, p in procs.items()}
        ot = os.times()
        cpu0["game"] = ot.user + ot.system
        t_steady = time.perf_counter()
        wait_for(lambda: marks("stopped"), "steady traffic",
                 timeout=GAME_STEADY_S + GAME_WAIT_S)
        steady_s = time.perf_counter() - t_steady
        probe.on = False
        launches = AK.launches["aoi_step"]
        cpu1 = {k: proc_cpu_s(p.pid) for k, p in procs.items()}
        ot = os.times()
        cpu1["game"] = ot.user + ot.system
        steady_rows = split.rows[rows0:]
        ticks = game.rt.tick_count - ticks0
        # quiescence: the NPC timer stops; the clients' last moves (up to
        # a gate flush interval behind) are ingested and GAME_QUIET_TICKS
        # ticks run after the last; then the interest rows are read on
        # the logic thread
        stop_at = []
        game.rt.post.post(lambda: stop_at.append(
            (game.rt.timers.cancel(walk_tid), game.rt.tick_count)))
        wait_for(lambda: stop_at, "the NPC timer's stop")
        quiet = {"last": probe.last, "tick": game.rt.tick_count}

        def drained():
            if probe.last != quiet["last"]:
                quiet.update(last=probe.last, tick=game.rt.tick_count)
            return (time.monotonic() - probe.last > GAME_DRAIN_S
                    and game.rt.tick_count >= quiet["tick"]
                    + GAME_QUIET_TICKS)

        wait_for(drained, "the clients' last moves")
        got = []
        game.rt.post.post(lambda: got.append(interest_rows(game, AP)))
        wait_for(lambda: got, "interest rows")
        rows = got[0]
        with open(os.path.join(tmp, "snap.mark"), "w"):
            pass
        bots = []
        for k, name in enumerate(bots_k):
            rc = procs[name].wait(timeout=GAME_WAIT_S)
            check(rc == 0, f"22b: {name} exited {rc}: {tail(name)}")
            with open(os.path.join(tmp, f"result-{k}.mark")) as f:
                bots.append(json.load(f))
            bots[-1]["lat"] = np.load(os.path.join(tmp,
                                                   f"latency-{k}.npz"))
        players = [p for b in bots for p in b["players"]]
        legs = probe.legs(players, *(np.concatenate([b["lat"][key]
                                                     for b in bots])
                                     for key in ("moves", "receipts")))
        stats = dict(bucket.stats)
        quiet_launches = AK.launches["aoi_step"] - launches
        game.stop(save=False)
        game = None
        for name in ("gate", "dispatcher"):
            procs[name].send_signal(signal.SIGTERM)
            rc = procs[name].wait(timeout=GAME_WAIT_S)
            check(rc == 0, f"22b: {name} exited {rc} on SIGTERM: {tail(name)}")
        for name in procs:
            check(not logged(name, "falling back to flate"),
                  f"22b: {name} fell back to flate")
    finally:
        if game is not None:
            game.stop(save=False)
        if split is not None:
            split.restore()
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files.values():
            f.close()
        tmpd.cleanup()
    check(errors.n == 0, f"22b: the game logged {errors.n} errors: "
          f"{errors.last}")
    errors.close()
    healthy(stats, "22b")
    check(stats["decode_overflow"] == overflow0,
          f"22b: decode_overflow {overflow0} -> {stats['decode_overflow']}")
    check(launches > 0, "22b: no kernel launch in the steady window")
    mirrors = {eid: seen for b in bots for eid, seen in b["mirrors"].items()}
    check(len(mirrors) == n, f"22b: {len(mirrors)} bots reported of {n}")
    bad = []
    for eid, seen in mirrors.items():
        row = rows.get(eid)
        check(row is not None, f"22b: avatar {eid} is in no smoke space")
        check(row["device"] == row["plain"],
              f"22b: {eid}: device interest row != plain interest_matrix")
        if sorted(seen) != row["device"]:
            bad.append((eid, len(set(row["device"]) - set(seen)),
                        len(set(seen) - set(row["device"]))))
    check(not bad, f"22b: {len(bad)} clients' mirrors differ from their "
          f"avatars' interest rows (avatar, missing, extra: {bad[:3]})")
    due = steady_s * 1000.0 / cfg.games[1].tick_interval_ms
    busy = [r for r in steady_rows if r["launched"]]
    out = {"clients": n, "steady_s": steady_s, "ticks_run": ticks,
           "ticks_due": due, "ticks_run_frac": ticks / due,
           "ticks_launched": len(busy),
           "loop": LoopSplit.summary(steady_rows),
           "loop_launched": LoopSplit.summary(busy),
           "launches": launches, "launches_quiet": quiet_launches,
           "move_latency_ms": legs.pop("send_to_mirror"),
           "latency_legs_ms": legs,
           "gate_wire": {key: sum(b["wire_per_s"][key] for b in bots)
                         for key in bots[0]["wire_per_s"]},
           "mirrors_checked": len(mirrors),
           "mirror_entities": int(sum(len(v) for v in mirrors.values())),
           "cpu_s": {k: cpu1[k] - cpu0[k] for k in cpu1},
           "bot_procs": GAME_BOT_PROCS,
           "bots_cpu_s": [b["cpu_s"] for b in bots],
           "anomalies": [b["anomalies"] for b in bots if b["anomalies"]],
           "decode_overflow": stats["decode_overflow"],
           "tick_errors": errors.n}
    log("22b", json.dumps(out))
    return out


def bots_main(a):
    """One 22b bot process: the clients ``first`` to ``first + count`` (whole
    spaces, so a move and its neighbors' mirrors share the process)
    connect, join their patches, move every 100 ms (warm-up, then steady)
    and stop; after the parent's snap mark they drain the wire, and the
    process reports each client's mirror set, the wire counts, and on
    ``time.monotonic`` its moves and its mirror updates of them."""
    import select

    from goworld_tpu_torch.client import GameClientConnection
    from goworld_tpu_torch.proto import msgtypes as MT

    first, n, per = a["first"], a["count"], a["per_space"]
    lo, pos = client_patches(a["spaces"], per, a["seed"], a["world"])
    lo, pos = lo[first:first + n], pos[first:first + n]
    rng = np.random.default_rng((a["seed"], first))
    mark = os.path.join(a["dir"], "{}" + f"-{a['proc']}.mark")
    wire = {"rx_packets": 0, "rx_bytes": 0, "tx_packets": 0, "tx_bytes": 0}
    sent, moves, receipts = {}, [], []
    measure = [False]
    rec = LatencyProbe.REC

    class CountingSock:
        def __init__(self, sock):
            self._s = sock

        def recv(self, k):
            d = self._s.recv(k)
            wire["rx_bytes"] += len(d)
            return d

        def sendall(self, b):
            wire["tx_bytes"] += len(b)
            wire["tx_packets"] += 1
            return self._s.sendall(b)

        def __getattr__(self, k):
            return getattr(self._s, k)

    class Bot(GameClientConnection):
        def read_ready(self):
            """One recv on a socket select found readable (so it does not
            block), its frames handled: poll() would wait out a socket
            timeout after the data, per client."""
            data = self.pc._sock.recv(65536)
            if not data:
                self.closed = True
                return
            for pkt in self.pc._parser.feed(data):
                self._handle(pkt)

        def _handle(self, pkt):
            wire["rx_packets"] += 1
            b = pkt.buf
            if measure[0] and int.from_bytes(b[:2], "little") == \
                    MT.MT_SYNC_POSITION_YAW_ON_CLIENTS:
                now = time.monotonic()
                r = np.frombuffer(bytes(b[2:]), rec)
                r = r[np.isin(r["eid"], eid_arr)]
                for eid, x, z in zip(r["eid"].tolist(), r["x"].tolist(),
                                     r["z"].tolist()):
                    key = (eid, x, z)
                    if key in sent:
                        receipts.append((idx_of[eid], x, z, now))
            super()._handle(pkt)

    bots = []
    for _ in range(n):
        c = Bot(tuple(a["gate"]))
        c.pc._sock.settimeout(None)
        c.pc._sock = CountingSock(c.pc._sock)
        bots.append(c)
    by_fd = {c.pc._sock.fileno(): c for c in bots}

    def pump(timeout):
        r, _, _ = select.select(list(by_fd), [], [], timeout)
        for fd in r:
            by_fd[fd].read_ready()
        return len(r)

    def until(pred, what):
        deadline = time.monotonic() + GAME_WAIT_S
        while not pred():
            if time.monotonic() > deadline:
                raise RuntimeError(f"bots: {what}: timed out")
            pump(0.01)

    until(lambda: all(c.player is not None for c in bots), "boot entities")
    for i, c in enumerate(bots):
        c.call_player("join", (first + i) // per, float(pos[i, 0]),
                      float(pos[i, 1]))
    until(lambda: all(len(c.entities) > 1 for c in bots), "joins")
    eid_bytes = [c.player.id.encode() for c in bots]
    eid_arr = np.array(eid_bytes, "S16")
    idx_of = {e: first + i for i, e in enumerate(eid_bytes)}
    with open(mark.format("joined"), "w"):
        pass
    until(lambda: os.path.exists(os.path.join(a["dir"], "go.mark")),
          "the parent's go")

    def drive(seconds):
        period = 0.1
        t0 = time.perf_counter()
        nxt = t0 + np.arange(n) * (period / n)
        end = t0 + seconds
        while True:
            now = time.perf_counter()
            if now >= end:
                return
            for i in np.nonzero(nxt <= now)[0]:
                q = pos[i] + rng.uniform(-STEP, STEP, 2)
                pos[i] = np.clip(q, lo[i], lo[i] + GAME_PATCH)
                x, z = (float(v) for v in pos[i])
                if measure[0]:
                    t = time.monotonic()
                    sent[(eid_bytes[i], x, z)] = t
                    moves.append((first + i, x, z, t))
                bots[i].send_position(x, 0.0, z)
                nxt[i] += period
            pump(max(0.0, min(0.005, float(nxt.min()) - now)))

    drive(a["warm_s"])
    with open(mark.format("steady"), "w"):
        pass
    w0 = dict(wire)
    t0 = time.perf_counter()
    measure[0] = True
    drive(a["steady_s"])
    measure[0] = False
    dt = time.perf_counter() - t0
    w1 = dict(wire)
    with open(mark.format("stopped"), "w"):
        pass
    last_hb = time.monotonic()
    snap = os.path.join(a["dir"], "snap.mark")
    while not os.path.exists(snap):
        pump(0.01)
        if time.monotonic() - last_hb > 5.0:
            for c in bots:
                c.heartbeat()
            last_hb = time.monotonic()
    quiet = time.monotonic()
    while time.monotonic() - quiet < 1.0:
        if pump(0.05):
            quiet = time.monotonic()
    check(not any(c.closed for c in bots), "bots: a client was disconnected")
    ot = os.times()
    result = {
        "mirrors": {c.player.id: sorted(e for e in c.entities
                                        if e != c.player.id) for c in bots},
        "wire_per_s": {k: (w1[k] - w0[k]) / dt for k in w1},
        "cpu_s": ot.user + ot.system,
        "players": [c.player.id for c in bots],
        "anomalies": [c.anomalies for c in bots if c.anomalies][:5]}
    np.savez(os.path.join(a["dir"], f"latency-{a['proc']}.npz"),
             moves=np.array(moves, np.float64).reshape(-1, 4),
             receipts=np.array(receipts, np.float64).reshape(-1, 4))
    tmp = mark.format("result") + ".tmp"
    with open(tmp, "w") as f:
        json.dump(result, f)
    os.replace(tmp, mark.format("result"))
    for c in bots:
        c.close()
    return 0


# -- phase 23: the deployed game (the operator CLI) and host failover -------

# 23a: the bots' process (the port's strict test_client) and its seconds.
# The game runs at the default 5 ms tick interval.  Every 16th tick
# captures 8 spaces (0.5-2.2 s), and the clients then hear nothing for
# about a second; a bot's oracle parks for 15 s after 1 s of silence, so
# a 10 s run could end with no visibility check at all (it did, once at
# 5 ms and once at 50 ms).  30 s leaves the oracle time to assert after a
# park.  The longest wait for a component, the fill, a reload or a scrape
DEPLOY_BOTS, DEPLOY_BOT_S = 64, 30.0
DEPLOY_WAIT_S = 300.0
# 23b: host_failover_scenario at phase 4's slot count and world, a space a
# worker.  The lease is sized from the capture, not the reference's 2 s:
# a worker renews once a batch it applies, and a batch costs about 0.2 s
# a space on the card (phase 19c's 165 ms capture and the tick); the
# survivor applies the replayed batches and its own back to back, up to
# the whole run (48 ticks x 2 spaces x 0.2 s = 19 s) without a renewal
# in between.  A kill -9 is seen at once all the same: the dead worker's
# link drops, and a dropped link fails over when leases are armed.
FAILOVER = {"cap": CAPACITY, "world": WORLD, "ticks": 48, "kill_at": 24,
            "tier": "cuda"}
FAILOVER_LEASE_S = 30.0
FAILOVER_PACE_S = 0.05

# the game script of 23a: the unity_demo twin, its spaces filled to phase
# 4's world (written beside the ini; the smoke's constants formatted in)
DEPLOY_SCRIPT = '''"""Phase 23's game: goworld_tpu_torch's unity_demo twin with its
spaces filled to chip_smoke.py phase 4's world: {spaces} spaces of
{capacity} slots, {fill} monsters each at seeded positions, walking one
step of at most {step} every position_sync_interval_ms (one batched
``Space.move_entities`` a space, not an AI timer a monster).  The
SpaceService seats players in the filled spaces; ``put_kv`` writes a
kvdb key through the facade."""

import time

import numpy as np

from goworld_tpu_torch import goworld
from goworld_tpu_torch.examples import unity_demo as U
from goworld_tpu_torch.services import ServiceManager

SPACES, CAPACITY, FILL = {spaces}, {capacity}, {fill}
WORLD, STEP, SEED = {world}, {step}, {seed}


class FilledSpace(U.MySpace):
    def on_space_init(self):
        self.enable_aoi(U.AOI_DISTANCE, capacity=CAPACITY)


class Monster(U.Monster):
    def on_created(self):
        self.attrs.set("name", "monster")


class Player(U.Player):
    @goworld.rpc(expose=goworld.OWN_CLIENT)
    def put_kv(self, key):
        goworld.kvdb_put(key, self.attrs.get_str("name"),
                         lambda _r: self.call_client("on_kv_put", key))


def filled(game):
    return sorted((sp for sp in game.rt.entities.spaces.values()
                   if sp.type_name == "FilledSpace"), key=lambda sp: sp.id)


class SpaceService(U.SpaceService):
    @goworld.rpc
    def enter_space(self, player_eid):
        spaces = self.attrs.get_list("spaces")
        if not len(spaces):
            counts = self.attrs.get_map("counts")
            for sp in filled(goworld.current_game()):
                spaces.append(sp.id)
                counts.set(sp.id, 0)
        U.SpaceService.enter_space(self, player_eid)

    def on_restored(self):
        # a restored game gets no deployment-ready notice (on_ready does
        # not run): the walk re-arms once the restore is done
        goworld.post(lambda: walk(goworld.current_game(), True, 0.0))


class Walk:
    def __init__(self, spaces, seed):
        self.spaces, self.rng = spaces, np.random.default_rng(seed)
        self.slots, self.pos = [], []
        for sp in spaces:
            ms = sorted((e for e in sp.entities if e.type_name == "Monster"),
                        key=lambda e: e.id)
            self.slots.append(np.array([e.aoi_slot for e in ms], np.int64))
            self.pos.append(np.array([[e.position.x for e in ms],
                                      [e.position.z for e in ms]],
                                     np.float32))

    def __call__(self):
        for sp, sl, p in zip(self.spaces, self.slots, self.pos):
            q = p + self.rng.uniform(-STEP, STEP, p.shape).astype(np.float32)
            p[:] = np.clip(q, 0, WORLD)
            sp.move_entities(sl, p[0], p[1])


def setup(game):
    for cls in (U.MySpace, FilledSpace, Player, Monster):
        game.register_entity_type(cls)
    services = ServiceManager(game)
    services.register(SpaceService)
    services.setup()
    game.services = services


ARMED = []


def walk(game, restored, seconds):
    """Arm the monsters' walk once (a timer of the game)."""
    if ARMED:
        return
    ARMED.append(Walk(filled(game), (SEED, int(restored))))
    interval = game.gcfg.position_sync_interval_ms / 1000.0
    game.rt.timers.add(interval, ARMED[0], repeat=True, interval=interval)
    print(f"DEPLOY_FILLED restored={{int(restored)}} "
          f"spaces={{len(ARMED[0].spaces)}} "
          f"monsters={{sum(len(s) for s in ARMED[0].slots)}} "
          f"seconds={{seconds:.3f}}", flush=True)


def on_ready(game):
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    for _ in range(SPACES):
        sp = game.rt.entities.create_space("FilledSpace", kind=1)
        p = rng.uniform(0, WORLD, (2, FILL)).astype(np.float32)
        for i in range(FILL):
            game.rt.entities.create("Monster", space=sp, pos=goworld.Vector3(
                float(p[0, i]), 0.0, float(p[1, i])))
    walk(game, False, time.perf_counter() - t0)
'''


def deploy_ini(disp, gate, http, redis_addr, device):
    return "\n".join([
        "[deployment]", "dispatchers = 1", "games = 1", "gates = 1", "",
        "[dispatcher1]", "host = 127.0.0.1", f"port = {disp}", "",
        "[game1]", "boot_entity = Player", "aoi_backend = cuda",
        f"aoi_device = {device}",
        "aoi_checkpoint = interval",
        "telemetry = true", f"http_port = {http}", "",
        "[gate1]", "host = 127.0.0.1", f"port = {gate}", "",
        "[storage]", "backend = sqlite", "directory = entity_storage", "",
        "[kvdb]", "backend = redis", f"host = {redis_addr[0]}",
        f"port = {redis_addr[1]}", "db = 0", ""])


def scrape(port, path="/debug/metrics"):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return resp.read().decode("utf-8", "replace")


def game_metrics(port, CLI):
    """The game's ``/debug/metrics`` as ``cli gwtop`` reads it: the tick
    count, the worst calc level, the step kernel's launches and the
    dispatches (``ops/aoi_cuda``'s collector)."""
    out = {"ticks": 0.0, "calc_level": 0.0, "launches": 0.0,
           "dispatches": 0.0}
    seen = set()
    for name, labels, val in CLI._parse_prometheus(scrape(port)):
        seen.add(name)
        if name == "gw_tick_seconds_count":
            out["ticks"] += val
        elif name == "gw_aoi_calc_level":
            out["calc_level"] = max(out["calc_level"], val)
        elif name == "gw_ops_kernel_launches_total" \
                and labels.get("kernel") == "aoi_step":
            out["launches"] += val
        elif name == "gw_ops_dispatches_total":
            out["dispatches"] += val
    check({"gw_tick_seconds_count", "gw_aoi_calc_level",
           "gw_ops_kernel_launches_total"} <= seen,
          f"23a: the game's metrics lack a series: {sorted(seen)[:40]}")
    return out


def capture_ms(port, spaces):
    """Checkpoint capture ms from the game's ``/debug/trace``: the
    ``ckpt.snapshot`` (export) and ``ckpt.delta`` spans a space, and their
    sum over a capture tick (``spaces`` captures)."""
    ev = json.loads(scrape(port, "/debug/trace"))["traceEvents"]
    snap = [e["dur"] / 1e3 for e in ev if e.get("name") == "ckpt.snapshot"]
    delta = [e["dur"] / 1e3 for e in ev if e.get("name") == "ckpt.delta"]
    if not snap:
        return {"captures": 0}
    return {"captures": len(snap),
            "snapshot_ms": float(np.mean(snap)),
            "delta_ms": float(np.mean(delta)) if delta else None,
            "capture_ms_per_tick": (sum(snap) + sum(delta))
            / (len(snap) / spaces)}


def serve_keeper(keeper, procs, each=None):
    """Keep a client's connection served (its mirror read, a heartbeat
    every 5 s: the gate drops a client silent for heartbeat_timeout_s)
    until every process of ``procs`` exits or DEPLOY_WAIT_S pass;
    ``each()`` every round."""
    deadline = time.monotonic() + DEPLOY_WAIT_S
    beat = time.monotonic()
    while any(p.poll() is None for p in procs):
        check(time.monotonic() < deadline, "a deployment child process hung")
        keeper.poll(0.02)
        if each is not None:
            each()
        if time.monotonic() - beat > 5.0:
            keeper.heartbeat()
            beat = time.monotonic()


def bot_profile(text):
    """Per-op latency of a bots process's summary (``Stats.dump``)."""
    return {m.group(1): {"n": int(m.group(2)), "avg": float(m.group(3)),
                         "p50": float(m.group(4)), "p95": float(m.group(5)),
                         "max": float(m.group(6))}
            for m in re.finditer(
                r"^(\w+)\s+n=(\d+)\s+avg=\s*([\d.]+)ms p50=\s*([\d.]+)ms "
                r"p95=\s*([\d.]+)ms max=\s*([\d.]+)ms", text, re.M)}


class CliRun:
    """One deployment through ``python -m goworld_tpu_torch.cli`` in a
    temporary directory: the CLI's commands, the components' logs, a
    bounded wait; ``tag`` names the phase in every failure."""

    NAMES = ("dispatcher1", "game1", "gate1")

    def __init__(self, tag):
        import tempfile

        self.tag = tag
        self.root = os.path.dirname(os.path.abspath(__file__))
        self.env = dict(os.environ, PYTHONPATH=self.root + os.pathsep
                        + os.environ.get("PYTHONPATH", ""))
        self.tmpd = tempfile.TemporaryDirectory(prefix=f"gw_{tag}_")
        self.tmp = self.tmpd.name
        self.run = os.path.join(self.tmp, "run")
        self.started = False

    def cli(self, *args, timeout=DEPLOY_WAIT_S):
        return subprocess.run(
            [sys.executable, "-m", "goworld_tpu_torch.cli", *args],
            cwd=self.root, env=self.env, capture_output=True, text=True,
            timeout=timeout)

    def popen(self, *args, **kw):
        return subprocess.Popen([sys.executable, "-m", *args],
                                cwd=self.root, env=self.env, text=True, **kw)

    def log_of(self, name):
        try:
            with open(os.path.join(self.run, f"{name}.log")) as f:
                return f.read()
        except OSError:
            return ""

    def tails(self):
        return "".join(f"\n--- {n}: {self.log_of(n)[-2000:]}"
                       for n in self.NAMES)

    def wait_for(self, pred, what, timeout=DEPLOY_WAIT_S):
        deadline = time.monotonic() + timeout
        while not pred():
            check(time.monotonic() < deadline,
                  f"{self.tag}: {what}: timed out" + self.tails())
            time.sleep(0.05)

    def filled_lines(self):
        return re.findall(r"DEPLOY_FILLED (.*)", self.log_of("game1"))

    def start(self, ini, script):
        """``cli start``; each component's readiness s from its log."""
        from goworld_tpu_torch.utils import gwlog

        t0 = time.perf_counter()
        proc = self.popen("goworld_tpu_torch.cli", "start", "-c", ini, "-s",
                          script, "-d", self.run, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT)
        self.started = True
        ready = {}
        while proc.poll() is None or len(ready) < len(self.NAMES):
            for n in self.NAMES:
                if n not in ready and gwlog.READY_TAG in self.log_of(n):
                    ready[n] = time.perf_counter() - t0
            if proc.poll() is not None and proc.returncode != 0:
                break
            check(time.perf_counter() - t0 < DEPLOY_WAIT_S,
                  f"{self.tag}: cli start timed out" + self.tails())
            time.sleep(0.05)
        start_out = proc.communicate()[0]
        start_s = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"{self.tag}: cli start: {start_out}" + self.tails())
        return start_s, ready

    def stop(self):
        """``cli stop``, then wait for the components' exit (a game saves,
        then destroys every entity, and may outlive the stop's wait)."""
        t0 = time.perf_counter()
        r = self.cli("stop", "-d", self.run)
        check(r.returncode == 0, f"{self.tag}: cli stop: {r.stdout}{r.stderr}")
        self.wait_for(lambda: "RUNNING" not in self.cli(
            "status", "-d", self.run).stdout, "the components' exit")
        self.started = False
        return time.perf_counter() - t0

    def close(self):
        if self.started:
            self.cli("kill", "-d", self.run, timeout=60)
        self.tmpd.cleanup()


def phase_deploy(AD):
    """23a: ``python -m goworld_tpu_torch.cli`` builds and starts a
    dispatcher, a game (``aoi_device`` the card, sqlite storage, kvdb on a
    miniredis served here, interval checkpoints, telemetry on its
    ``http_port``) and a gate; the game script fills phase 4's world; 64
    strict bots; a keeper client across ``cli reload``; the game's metrics
    before and after; ``cli stop``; the keeper's record and kvdb key read
    back here; every checkpointed space restored onto the card."""
    import types

    from goworld_tpu_torch import cli as CLI
    from goworld_tpu_torch.client import GameClientConnection
    from goworld_tpu_torch.engine import checkpoint as CK
    from goworld_tpu_torch.engine.aoi import AOIEngine, _unpack_positions
    from goworld_tpu_torch.ext.db.miniredis import MiniRedis
    from goworld_tpu_torch.kvdb.backends import RedisKVDB
    from goworld_tpu_torch.storage.backends import SqliteEntityStorage

    dep = CliRun("23a")
    cli, run, tails, wait_for = dep.cli, dep.run, dep.tails, dep.wait_for
    filled_lines = dep.filled_lines
    redis = MiniRedis()
    disp, gate, http = free_port(), free_port(), free_port()
    ini = os.path.join(dep.tmp, "goworld.ini")
    script = os.path.join(dep.tmp, "deploy_game.py")
    with open(ini, "w") as f:
        f.write(deploy_ini(disp, gate, http, redis.addr, DEV))
    with open(script, "w") as f:
        f.write(DEPLOY_SCRIPT.format(spaces=SPACES, capacity=CAPACITY,
                                     fill=PER_SPACE - GAME_CLIENTS,
                                     world=WORLD, step=STEP, seed=41))
    out, keeper = {}, None
    try:
        t0 = time.perf_counter()
        r = cli("build", "-c", ini, "-s", script)
        out["build_s"] = time.perf_counter() - t0
        check(r.returncode == 0 and "build OK" in r.stdout,
              f"23a: cli build: {r.stdout}{r.stderr}")
        out["start_s"], out["ready_s"] = dep.start(ini, script)
        r = cli("status", "-d", run)
        check(r.returncode == 0 and r.stdout.count("RUNNING") == 3,
              f"23a: cli status: {r.stdout}")
        wait_for(lambda: filled_lines(), "the game's fill")
        out["fill"] = filled_lines()[0]
        # the keeper: a name, a kvdb key through the facade
        # (first: once it stands in a filled space, the space service is
        # up and the bots' oracle has a space to judge)
        t0 = time.perf_counter()
        keeper = GameClientConnection(("127.0.0.1", gate))
        check(keeper.wait_for(lambda c: c.player is not None, 60),
              "23a: the keeper got no boot entity" + tails())
        out["keeper_login_s"] = time.perf_counter() - t0
        keeper.call_player("enter_game", "keeper")
        check(keeper.wait_for(
            lambda c: c.player.attrs.get("name") == "keeper"
            and len(c.entities) > 1, 60),
            "23a: the keeper did not enter a space" + tails())
        out["keeper_enter_s"] = time.perf_counter() - t0
        keeper.call_player("put_kv", "deploy:keeper")
        check(keeper.wait_for(lambda c: any(
            ("on_kv_put", ("deploy:keeper",)) in e.calls
            for e in c.entities.values()), 60),
            "23a: the keeper's kvdb write was not acknowledged" + tails())
        # 64 strict bots of the port's test_client, one process
        t0 = time.perf_counter()
        proc = dep.popen(
            "goworld_tpu_torch.examples.test_client", "--gate",
            f"127.0.0.1:{gate}", "-N", str(DEPLOY_BOTS), "--duration",
            str(DEPLOY_BOT_S), "--strict", stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)
        serve_keeper(keeper, [proc])
        bots = types.SimpleNamespace(returncode=proc.returncode)
        bots.stdout, bots.stderr = proc.communicate()
        out["bots_s"] = time.perf_counter() - t0
        check(bots.returncode == 0
              and f"{DEPLOY_BOTS}/{DEPLOY_BOTS} bots OK" in bots.stdout,
              f"23a: bots: {bots.stdout[-3000:]}{bots.stderr[-3000:]}")
        vis = re.search(r"visibility checks: (\d+)", bots.stdout)
        check(vis and int(vis.group(1)) > 0,
              f"23a: no visibility check: {bots.stdout[-2000:]} "
              f"{game_metrics(http, CLI)}" + tails())
        out["visibility_checks"] = int(vis.group(1))
        out["bot_profile_ms"] = bot_profile(bots.stdout)
        out["bot_anomalies"] = dict(
            (m.group(1), int(m.group(2))) for m in
            re.finditer(r"^anomaly\.(\w+): (\d+)", bots.stdout, re.M))
        kid = keeper.player.id
        before = game_metrics(http, CLI)
        check(before["ticks"] > 0 and before["calc_level"] == 0
              and before["launches"] > 0 and before["dispatches"] > 0,
              f"23a: the game's metrics before reload: {before}")
        out["capture"] = capture_ms(http, SPACES)
        out["metrics_before"] = before
        # hot reload: SIGHUP, freeze, restart with -restore on the card
        frozen = os.path.join(run, "game1_frozen.dat")
        t0 = time.perf_counter()
        proc = dep.popen("goworld_tpu_torch.cli", "reload", "-c", ini, "-s",
                         script, "-d", run, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT)
        seen = []

        def watch():
            try:
                seen.append(os.path.getsize(frozen))
            except OSError:
                pass

        serve_keeper(keeper, [proc], watch)
        freeze_bytes = max(seen, default=0)
        reload_out = proc.communicate()[0]
        out["reload_s"] = time.perf_counter() - t0
        check(proc.returncode == 0, f"23a: cli reload: {reload_out}"
              + tails())
        out["freeze_bytes"] = freeze_bytes
        check(freeze_bytes > 0, "23a: no freeze file seen")
        wait_for(lambda: len(filled_lines()) > 1, "the restored fill")
        out["restored_fill"] = filled_lines()[1]
        check("restored=1" in out["restored_fill"],
              f"23a: the reload did not restore the spaces: "
              f"{out['restored_fill']}")
        keeper.call_player("whoami")
        check(keeper.wait_for(lambda c: any(
            ("on_whoami", ("keeper",)) in e.calls
            for e in c.entities.values()), 60),
            "23a: the keeper's name did not survive the reload" + tails())
        check(not keeper.closed, "23a: the keeper's connection broke")
        wait_for(lambda: game_metrics(http, CLI)["launches"] > 0,
                 "a launch after the reload")
        after = game_metrics(http, CLI)
        check(after["calc_level"] == 0 and after["dispatches"] > 0,
              f"23a: the game's metrics after reload: {after}")
        out["metrics_after"] = after
        out["launches"] = int(before["launches"] + after["launches"])
        keeper.close()
        keeper = None
        out["stop_s"] = dep.stop()
        # the keeper's record and key, read back here
        be = SqliteEntityStorage(os.path.join(run, "entity_storage"))
        rec = be.read("Player", kid)
        be.close()
        check(rec is not None and rec.get("name") == "keeper",
              f"23a: the keeper's record after stop: {rec}")
        kv = RedisKVDB(*redis.addr)
        check(kv.get("deploy:keeper") == "keeper",
              "23a: the keeper's kvdb key after stop")
        # every checkpointed space, restored onto the card
        store = SqliteEntityStorage(os.path.join(
            run, "checkpoints", "entity_storage"))
        sids = sorted({k.split("/")[1] for k, _v in kv.find(
            CK.MANIFEST_PREFIX, CK.MANIFEST_PREFIX + "~")})
        check(len(sids) == SPACES, f"23a: {len(sids)} spaces checkpointed")
        restore_ms, restored_ticks = [], []
        for sid in sids:
            eng = AOIEngine(device=DEV)
            ctl = CK.CheckpointController(eng, store, kv, mode="off")
            t0 = time.perf_counter()
            res = ctl.restore_into(eng, sid, tier="cuda")
            torch.cuda.synchronize()
            restore_ms.append((time.perf_counter() - t0) * 1e3)
            check(res is not None and ctl.stats["torn_records"] == 0,
                  f"23a: restore of {sid}: {res} {ctl.stats}")
            h, tick, _epoch = res
            restored_ticks.append(tick)
            snap = h.bucket.export_snapshot(h.slot)
            x, z = _unpack_positions(snap)
            t = [torch.from_numpy(a).to(DEV) for a in
                 (x, z, snap["r"], snap["act"])]
            want = AD.interest_words_dense(*t).cpu().numpy().view(np.uint32)
            check(np.array_equal(snap["words"], want),
                  f"23a: space {sid}: restored words != the plain words "
                  "of its restored inputs")
            check(int(snap["act"].sum()) >= PER_SPACE - GAME_CLIENTS,
                  f"23a: space {sid}: {int(snap['act'].sum())} active")
            del eng, ctl, h
        store.close()
        kv.close()
        out["restore_ms"] = restore_ms
        out["restored_ticks"] = restored_ticks
    finally:
        if keeper is not None:
            keeper.close()
        dep.close()
        redis.close()
    torch.cuda.empty_cache()
    log("23a", json.dumps(out))
    return out


def phase_failover():
    """23b: the host-failover driver on the card: two worker processes
    (``--tier cuda``), one space of FAILOVER["cap"] slots each, worker 1
    SIGKILLed at FAILOVER["kill_at"]; the survivor restores its space onto
    the card and replays; the unkilled oracle runs on the native ``cpp``
    calculator."""
    import tempfile

    from goworld_tpu_torch.engine.failover import host_failover_scenario

    with tempfile.TemporaryDirectory(prefix="gw_failover_") as tmp:
        t0 = time.perf_counter()
        res = host_failover_scenario(
            tmp, oracle_tier="cpp", lease_ttl_s=FAILOVER_LEASE_S,
            pace_s=FAILOVER_PACE_S, **FAILOVER)
        res["wall_s"] = time.perf_counter() - t0
    surv = res.get("survivor", {})
    check(res["events_lost"] == 0 and res["parity_ok"]
          and res["replay_parity_ok"] and res["survivor_space_ok"]
          and res["survivor_done"] and res["clu_stats"]["failovers"] >= 1,
          f"23b: {res}")
    check(len(surv.get("restore_ms", [])) == 1,
          f"23b: the survivor's restore: {surv}")
    res["launches"] = surv["launches"]["aoi_step"]
    log("23b", json.dumps(res))
    return res


# -- phase 24: the deployment over KCP, WebSocket, mongo and mysql ---------

# 23a's filled unity_demo twin at phase 4's width (CAPACITY slots, PER_SPACE
# - GAME_CLIENTS monsters a space), on WIRE_SPACES spaces; entity storage on
# a MiniMongoServer and kvdb on a MiniMySQLServer, both served here and
# reached over their wire protocols; no checkpoints (23a drives them, and a
# capture's stall parks the bots' oracle); WIRE_BOTS strict bots a
# transport, one process each, for WIRE_BOT_S.
WIRE_SPACES = 2
WIRE_BOTS, WIRE_BOT_S = 16, 15.0
WIRE_TRANSPORTS = ("tcp", "kcp", "ws")
WIRE_DB = 24


def wire_ini(disp, gates, http, mongo_port, mysql_port, device):
    return "\n".join([
        "[deployment]", "dispatchers = 1", "games = 1", "gates = 1", "",
        "[dispatcher1]", "host = 127.0.0.1", f"port = {disp}", "",
        "[game1]", "boot_entity = Player", "aoi_backend = cuda",
        f"aoi_device = {device}", "telemetry = true", f"http_port = {http}",
        "",
        "[gate1]", "host = 127.0.0.1", f"port = {gates['tcp']}",
        f"kcp_port = {gates['kcp']}", f"websocket_port = {gates['ws']}", "",
        "[storage]", "backend = mongodb", "host = 127.0.0.1",
        f"port = {mongo_port}", f"db = {WIRE_DB}", "",
        "[kvdb]", "backend = mysql", "host = 127.0.0.1",
        f"port = {mysql_port}", f"db = {WIRE_DB}", ""])


def phase_deploy_wire():
    """24: ``python -m goworld_tpu_torch.cli start`` of a dispatcher, a game
    (``aoi_device`` the card, ``mongodb`` storage and ``mysql`` kvdb over
    the wire to the port's mini servers served here) and a gate serving
    TCP, KCP and WebSocket; WIRE_SPACES of 23a's filled spaces; a keeper
    over WebSocket names itself and writes a kvdb key; WIRE_BOTS strict
    bots over each transport; ``cli stop``; the keeper's record read back
    from the mongo server and its key from the mysql server, each over
    its wire."""
    from goworld_tpu_torch import cli as CLI
    from goworld_tpu_torch.client import GameClientConnection
    from goworld_tpu_torch.ext.db.mongowire import MiniMongoServer
    from goworld_tpu_torch.ext.db.mysqlwire import MiniMySQLServer
    from goworld_tpu_torch.kvdb.backends import MySQLKVDB
    from goworld_tpu_torch.storage.backends import MongoEntityStorage

    t_phase = time.perf_counter()
    dep = CliRun("24")
    mongo, mysql = MiniMongoServer(), MiniMySQLServer()
    disp, http = free_port(), free_port()
    gates = {t: free_port() for t in WIRE_TRANSPORTS}
    ini = os.path.join(dep.tmp, "goworld.ini")
    script = os.path.join(dep.tmp, "wire_game.py")
    with open(ini, "w") as f:
        f.write(wire_ini(disp, gates, http, mongo.port, mysql.port, DEV))
    with open(script, "w") as f:
        f.write(DEPLOY_SCRIPT.format(spaces=WIRE_SPACES, capacity=CAPACITY,
                                     fill=PER_SPACE - GAME_CLIENTS,
                                     world=WORLD, step=STEP, seed=43))
    out, keeper, bots = {}, None, []
    try:
        out["start_s"], out["ready_s"] = dep.start(ini, script)
        dep.wait_for(dep.filled_lines, "the game's fill")
        out["fill"] = dep.filled_lines()[0]
        # the keeper over WebSocket: a name, a kvdb key through the facade
        t0 = time.perf_counter()
        keeper = GameClientConnection(("127.0.0.1", gates["ws"]),
                                      transport="ws")
        check(keeper.wait_for(lambda c: c.player is not None, 60),
              "24: the keeper got no boot entity" + dep.tails())
        out["keeper_login_s"] = time.perf_counter() - t0
        keeper.call_player("enter_game", "keeper")
        check(keeper.wait_for(
            lambda c: c.player.attrs.get("name") == "keeper"
            and len(c.entities) > 1, 60),
            "24: the keeper did not enter a space" + dep.tails())
        keeper.call_player("put_kv", "wire:keeper")
        check(keeper.wait_for(lambda c: any(
            ("on_kv_put", ("wire:keeper",)) in e.calls
            for e in c.entities.values()), 60),
            "24: the keeper's kvdb write was not acknowledged" + dep.tails())
        kid = keeper.player.id
        # WIRE_BOTS strict bots over each transport, one process each
        t0 = time.perf_counter()
        bots = [dep.popen(
            "goworld_tpu_torch.examples.test_client", "--gate",
            f"127.0.0.1:{gates[t]}", "--transport", t, "-N", str(WIRE_BOTS),
            "--duration", str(WIRE_BOT_S), "--strict",
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for t in WIRE_TRANSPORTS]
        serve_keeper(keeper, bots)
        out["bots_s"] = time.perf_counter() - t0
        out["transports"] = {}
        for t, p in zip(WIRE_TRANSPORTS, bots):
            so, se = p.communicate()
            check(p.returncode == 0
                  and f"{WIRE_BOTS}/{WIRE_BOTS} bots OK" in so,
                  f"24: {t} bots: {so[-3000:]}{se[-3000:]}" + dep.tails())
            vis = re.search(r"visibility checks: (\d+)", so)
            check(vis and int(vis.group(1)) > 0,
                  f"24: {t}: no visibility check: {so[-2000:]}")
            prof = bot_profile(so)
            out["transports"][t] = {
                "visibility_checks": int(vis.group(1)),
                "login_p50_ms": prof["login"]["p50"],
                "tick_p50_ms": prof["tick"]["p50"], "profile_ms": prof}
        bots = []
        metrics = game_metrics(http, CLI)
        check(metrics["ticks"] > 0 and metrics["calc_level"] == 0
              and metrics["launches"] > 0,
              f"24: the game's metrics: {metrics}")
        out["metrics"] = metrics
        out["launches"] = int(metrics["launches"])
        keeper.close()
        keeper = None
        out["stop_s"] = dep.stop()
        # the keeper's record from mongo and its key from mysql, each read
        # back over its wire
        be = MongoEntityStorage(port=mongo.port, db=WIRE_DB)
        rec = be.read("Player", kid)
        out["players_saved"] = len(be.list_entity_ids("Player"))
        be.close()
        check(rec is not None and rec.get("name") == "keeper",
              f"24: the keeper's record in mongo after stop: {rec}")
        kv = MySQLKVDB(port=mysql.port, db=WIRE_DB)
        val = kv.get("wire:keeper")
        kv.close()
        check(val == "keeper", f"24: the keeper's key in mysql: {val!r}")
    finally:
        for p in bots:
            p.kill()
            p.communicate()
        if keeper is not None:
            keeper.close()
        dep.close()
        mongo.close()
        mysql.close()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log("24", json.dumps(out))
    return out


def main():
    if not torch.cuda.is_available():
        log("chip_smoke: torch sees no CUDA device")
        return 2
    from goworld_tpu_torch.engine.aoi import AOIEngine
    from goworld_tpu_torch.engine import placement as PL
    from goworld_tpu_torch import faults as FT
    from goworld_tpu_torch import interest as TI
    from goworld_tpu_torch import load as TL
    from goworld_tpu_torch import telemetry as TEL
    from goworld_tpu_torch.engine.runtime import Runtime
    from goworld_tpu_torch.interest import device as D
    from goworld_tpu_torch.ops import _build
    from goworld_tpu_torch.ops import aoi_cuda as AK
    from goworld_tpu_torch.ops import aoi_pages as PG
    from goworld_tpu_torch.ops import aoi_dense as AD
    from goworld_tpu_torch.ops import aoi_grid as AG
    from goworld_tpu_torch.ops import cadence as CD
    from goworld_tpu_torch.ops import dispatch_count as DC
    from goworld_tpu_torch.ops import aoi_stage as AS
    from goworld_tpu_torch.ops import events as EV
    from goworld_tpu_torch.ops import fused as FZ
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

    laps, lap_t = {}, [time.perf_counter()]

    def lap(name):  # wall seconds of each phase, logged at the end
        now = time.perf_counter()
        laps[name] = now - lap_t[0]
        lap_t[0] = now

    rows = phase_kernels(AK, AD)
    lap("3")
    main_out, main_crcs = phase_main(Runtime, AK, AD, EV)
    lap("4")
    phase_parity(Runtime)
    pipelined = phase_pipeline(Runtime, AK, DC, main_crcs, main_out)
    fused = phase_fused(Runtime, AK, DC)
    sub_change = phase_sub_change(Runtime)
    lap("5, 13-14b")
    faults_out = phase_faults(Runtime, AK)
    lap("15")
    sharded_faults = phase_sharded_faults(Runtime, AK, SpaceMesh)
    lap("15b")
    routing = phase_routing(Runtime, AK)
    lap("16")
    paged = phase_paged(Runtime, AK, DC, PG, main_out, main_crcs, fused)
    clustered = phase_clustered(AOIEngine, AK)
    pages_seam = phase_pages_seam(Runtime, AK)
    lap("17, 17b, 17d")
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
    lap("6-10")
    engine_mesh = phase_engine_mesh(Runtime, AOIEngine, AK, AD, SpaceMesh)
    rowshard = phase_rowshard(AOIEngine, AK, SpaceMesh)
    paged_sharded = phase_paged_sharded(AOIEngine, AK, SpaceMesh,
                                        engine_mesh, rowshard)
    torch.cuda.empty_cache()
    lap("11-12, 17c")
    interest_k = phase_interest_kernel(IC, K, TI)
    interest_slice = phase_interest_slice(Runtime, IC, TI, D)
    load_out = phase_load(TL, TI, IC, D)
    torch.cuda.empty_cache()
    lap("18-18c")
    migration = phase_migration(AOIEngine, SpaceMesh, AK, IC, PL, TI)
    evacuation = phase_evacuation(AOIEngine, SpaceMesh, AK)
    checkpoint = phase_checkpoint(Runtime, AOIEngine, AK, IC, TI)
    torch.cuda.empty_cache()
    lap("19-19c")
    with LaunchShapes(AK) as spy:
        cohort, cohort_eng = phase_cohort(Runtime, AOIEngine, AK, DC)
        ladder = phase_ladder(AOIEngine, AK, DC)
        demotion = phase_demotion(AOIEngine, PL, AK, FT)
    telemetry_out = phase_telemetry(Runtime, AK, DC, TEL, main_crcs,
                                    main_out, cohort_eng)
    del cohort_eng
    lap("20-21")
    rung_rows = phase_rung_shapes(AK, AD, spy.shapes)
    fused_graph = fused_graph_ms(AK, AS, FZ)
    lap("20d, 14c")
    game_script_out = phase_game_script(AK)
    lap("22a")
    game_live = phase_game_live(AK)
    lap("22b")
    deploy = phase_deploy(AD)
    lap("23a")
    failover = phase_failover()
    lap("23b")
    wire = phase_deploy_wire()
    lap("24")
    log("phase seconds", json.dumps(laps))
    cohort_l = {"cohort": cohort["launches"], "ladder": ladder["launches"],
                "demotion": demotion["launches"]}
    mig_l = migration["launches"]
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
                    ("interest_step load", load_out["launches"]),
                    ("aoi_step migration", mig_l["aoi_step"]),
                    ("aoi_step rect migration", mig_l["aoi_step rect"]),
                    ("interest_step migration", mig_l["interest_step"]),
                    ("aoi_step evacuation", evacuation["launches"]),
                    ("aoi_step checkpoint",
                     checkpoint["launches"]["aoi_step"]),
                    ("interest_step checkpoint",
                     checkpoint["launches"]["interest_step"]),
                    *((f"aoi_step {k}", v) for k, v in cohort_l.items()),
                    ("aoi_step telemetry", telemetry_out["launches"]),
                    ("aoi_step game script", game_script_out["launches"]),
                    ("aoi_step game live", game_live["launches"]),
                    ("aoi_step deploy", deploy["launches"]),
                    ("aoi_step failover", failover["launches"]),
                    ("aoi_step wire", wire["launches"])):
        check(n > 0, f"{name}: no launch on its path")

    def entry(name, replaces, launches, shape_rows, shape, **extra):
        at = next(r for r in shape_rows if tuple(r["shape"]) == shape)
        return {"name": name, "route": "cuda",
                "source": "goworld_tpu_torch/csrc/" + (
                    "aoi_grid.cu" if "culled" in name else "aoi_step.cu"),
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in
                                   shape_rows + extra.get("cohort_shapes",
                                                          [])),
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
              + routing["launches"] + paged_l + paged_mesh_l
              + mig_l["aoi_step"] + evacuation["launches"]
              + checkpoint["launches"]["aoi_step"]
              + sum(cohort_l.values()) + telemetry_out["launches"]
              + game_script_out["launches"] + game_live["launches"]
              + deploy["launches"] + failover["launches"]
              + wire["launches"], rows,
              MAIN_SHAPE,
              main_path_ms=main_out["kernel_ms"],
              cohort_shapes=rung_rows,
              path_launches={"main": main_out["kernel_launches"],
                             "deferred": pipelined["launches"],
                             "fused": fused["launches"],
                             "fused_replays": fused["replays"],
                             "faults": faults_out["launches"],
                             "faults_mesh": mesh_fault_l,
                             "routing": routing["launches"],
                             "paged": paged_l,
                             "paged_mesh": paged_mesh_l,
                             "migration": mig_l["aoi_step"],
                             "evacuation": evacuation["launches"],
                             "checkpoint": checkpoint["launches"][
                                 "aoi_step"],
                             **cohort_l,
                             "telemetry": telemetry_out["launches"],
                             "game_script": game_script_out["launches"],
                             "game_live": game_live["launches"],
                             "deploy": deploy["launches"],
                             "failover": failover["launches"],
                             "wire": wire["launches"]}),
        entry("aoi_step_rect", "goworld_tpu/ops/aoi_pallas.py:176",
              rect_launches + row_fault_l + paged_row_l
              + mig_l["aoi_step rect"], rect_rows,
              RECT_PATH_SHAPE, main_path_ms=share_out["kernel_ms"],
              path_launches={"share": rect_launches,
                             "faults_rowshard": row_fault_l,
                             "paged_rowshard": paged_row_l,
                             "migration_rowshard": mig_l["aoi_step rect"]}),
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
        interest_entry(interest_k, interest_slice, load_out,
                       {"migration": mig_l["interest_step"],
                        "checkpoint": checkpoint["launches"][
                            "interest_step"]})]}
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
                                   "fused_graph_ms": fused_graph,
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
    print(json.dumps({"migration": {
        "note": "virtual shards are shards of one card taking turns",
        "live": migration, "evacuation": evacuation["runs"],
        "checkpoint": checkpoint}}))
    print(json.dumps({"cohort": {
        "multispace": cohort, "ladder": ladder, "demotion": demotion}}))
    print(json.dumps({"telemetry": {k: v for k, v in telemetry_out.items()
                                    if k != "launches"}}))
    print(json.dumps({"game": {
        "script": {k: v for k, v in game_script_out.items()
                   if k != "split_ms"},
        "live": game_live}}))
    print(json.dumps({"deploy": {
        "note": "23a's launches are scraped from the game process's "
                "/debug/metrics, 23b's from the surviving worker",
        "cli": deploy, "failover": failover, "wire": wire}}))
    print(json.dumps(issue))
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def deploy_main(phases):
    """``--deploy 24 23a 23b``: the kernels built, then the named
    deployment phases alone, in the order given, one JSON line each (the
    card's name and power limit first).  The children inherit this
    process's environment, so ``OMP_NUM_THREADS`` set here sizes the game
    process's OpenMP pool."""
    if not torch.cuda.is_available():
        log("chip_smoke: torch sees no CUDA device")
        return 2
    from goworld_tpu_torch.ops import _build
    from goworld_tpu_torch.ops import aoi_dense as AD

    run = {"23a": lambda: phase_deploy(AD), "23b": phase_failover,
           "24": phase_deploy_wire}
    check(phases and set(phases) <= set(run), f"--deploy {phases}: "
          f"name phases of {sorted(run)}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    _build.build_all(force=True)
    for name in phases:
        t0 = time.perf_counter()
        out = run[name]()
        print(json.dumps({"phase": name, "wall_s": time.perf_counter() - t0,
                          "omp_num_threads": os.environ.get(
                              "OMP_NUM_THREADS"), "out": out}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--bots"]:  # phase 22b's client process
        sys.exit(bots_main(json.loads(sys.argv[2])))
    if sys.argv[1:2] == ["--deploy"]:
        sys.exit(deploy_main(sys.argv[2:]))
    sys.exit(main())
