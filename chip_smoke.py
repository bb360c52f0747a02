"""Chip smoke test of the PyTorch/CUDA port (goworld_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):

  1. device  -- torch must see a CUDA device; prints the card's name and
                power limit as nvidia-smi reports them;
  2. build   -- compiles every csrc/*.cu of the port with nvcc (sm_90a);
  3. kernels -- each kernel against its plain PyTorch version on the
                card, bit-exact, over edge-case inputs at the main path's
                shapes and around them, timed with CUDA events;
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
                enter/leave arrays must be equal.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Kernel launches counted on the main path
are those of phase 4 alone (counts are reset just before it).
"""

from __future__ import annotations

import json
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

KERNEL_SHAPES = [(1, 128), (3, 384), (8, 4096), (8, 16384), (64, 16384)]
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


def edge_inputs(s, c, seed):
    """[S, C] inputs with the predicate's edge cases: a tie lattice, -0.0,
    NaN, +-inf, r = 0 with subnormal gaps, r = +inf, partially active
    rows, and prev words with bit 31 set."""
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
    prev = rng.integers(-2**31, 2**31, (s, c, w), dtype=np.int64)
    prev = prev.astype(np.int32)
    prev[:, :, 0] |= np.int32(-2**31)  # bit 31 set
    dev = "cuda"
    return (torch.from_numpy(x).to(dev), torch.from_numpy(z).to(dev),
            torch.from_numpy(r).to(dev), torch.from_numpy(act).to(dev),
            torch.from_numpy(prev).to(dev))


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


def aoi_step_bound(s, c):
    """Least time for one step at [S, C]: each input read once, each
    output written once, over the memory rate; the pair tests' f32
    operations over the f32 rate.  Returns (bound_ms, bound_by)."""
    w = c // 32
    nbytes = s * c * (4 + 4 + 4 + 1) + 3 * s * c * w * 4
    ops = s * c * c * OPS_PER_PAIR
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def phase_kernels(AK, AD):
    rows = []
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
        plain_ms = cuda_ms(lambda: AD.aoi_step_chg_dense(x, z, r, act, prev),
                           reps=1 if s * c >= 64 * 16384 else 3, warm=1)
        bound_ms, bound_by = aoi_step_bound(s, c)
        row = {"shape": [s, c], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "max_abs_err": err}
        log("kernel aoi_step", json.dumps(row))
        rows.append(row)
        del x, z, r, act, prev
        torch.cuda.empty_cache()
    return rows


# -- phase 4/5: the main path -------------------------------------------------


def build_world(Runtime, device, spaces, per_space, capacity, seed):
    from goworld_tpu_torch.engine.entity import Entity
    from goworld_tpu_torch.engine.space import Space
    from goworld_tpu_torch.engine.vector import Vector3

    class SmokeScene(Space):
        pass

    class SmokeMob(Entity):
        use_aoi = True
        aoi_distance = RADIUS

    class SmokeWatcher(Entity):
        use_aoi = True
        aoi_distance = RADIUS

        def on_enter_aoi(self, other):  # non-plain: eager replay
            pass

    rt = Runtime(device=device)
    for cls in (SmokeScene, SmokeMob, SmokeWatcher):
        rt.entities.register(cls)
    crc = {"v": 0, "events": 0}
    take = rt.aoi.take_events

    def folding_take(h):
        ev = take(h)
        for a in ev:
            crc["v"] = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc["v"])
            crc["events"] += len(a)
        return ev

    rt.aoi.take_events = folding_take
    rng = np.random.default_rng(seed)
    spaces_l, slots, pos = [], [], []
    for _ in range(spaces):
        sp = rt.entities.create_space("SmokeScene", kind=1)
        sp.enable_aoi(RADIUS, capacity=capacity)
        p = rng.uniform(0, WORLD, (2, per_space)).astype(np.float32)
        ents = [rt.entities.create(
            "SmokeWatcher" if i == 0 else "SmokeMob", space=sp,
            pos=Vector3(float(p[0, i]), 0.0, float(p[1, i])))
            for i in range(per_space)]
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
        p[:, sel] = np.clip(q, 0, WORLD)
        sp.move_entities(sl[sel], p[0, sel], p[1, sel])


def bucket_of(rt):
    (bucket,) = rt.aoi._buckets.values()
    return bucket


class DeviceTimer:
    """Wraps ``module.name`` so that, while ``on``, each call is bracketed
    by CUDA events; ``ms()`` sums the device time of the timed calls."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.inner = getattr(module, name)
        self.on = False
        self.events = []
        setattr(module, name, self)

    def __call__(self, *a):
        if not self.on:
            return self.inner(*a)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = self.inner(*a)
        e1.record()
        self.events.append((e0, e1))
        return out

    def restore(self):
        setattr(self.module, self.name, self.inner)

    def ms(self):
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


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
    try:
        AK.reset_launches()
        ticks = 0
        t0 = time.perf_counter()
        rt.tick()  # prime: the mass enter
        ticks += 1
        torch.cuda.synchronize()
        prime_s = time.perf_counter() - t0
        prime_events = crc["events"]
        check(bucket.stats["decode_overflow"] == 1,
              f"prime tick: decode_overflow {bucket.stats['decode_overflow']}"
              " (want the counted full-grid recovery)")
        for _ in range(WARMUP):
            walk(spaces_l, slots, pos, rng)
            rt.tick()
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
            rt.tick()
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
    return out


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
        crcs[device] = (crc["v"], crc["events"])
    check(crcs["cuda"] == crcs["cpu"],
          f"card vs CPU event CRC differ: {crcs}")
    log("parity", json.dumps({d: f"{v[0]:08x} ({v[1]} events)"
                              for d, v in crcs.items()}))
    return crcs


def main():
    if not torch.cuda.is_available():
        log("chip_smoke: torch sees no CUDA device")
        return 2
    from goworld_tpu_torch.engine.runtime import Runtime
    from goworld_tpu_torch.ops import _build
    from goworld_tpu_torch.ops import aoi_cuda as AK
    from goworld_tpu_torch.ops import aoi_dense as AD
    from goworld_tpu_torch.ops import events as EV

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    log("torch", torch.__version__, "cuda", torch.version.cuda)
    t0 = time.perf_counter()
    _build.build_all(force=True)
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, text in _build.build_log.items():
        log(f"--- {name}.cu\n{text.strip()}")

    rows = phase_kernels(AK, AD)
    main_out = phase_main(Runtime, AK, AD, EV)
    phase_parity(Runtime)

    at_main = next(r for r in rows if tuple(r["shape"]) == MAIN_SHAPE)
    kernels = {"kernels": [{
        "name": "aoi_step", "route": "cuda",
        "source": "goworld_tpu_torch/csrc/aoi_step.cu",
        "replaces": "goworld_tpu/ops/aoi_pallas.py:176",
        "launches": main_out["kernel_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": at_main["ms"], "plain_ms": at_main["plain_ms"],
        "bound_ms": at_main["bound_ms"], "bound_by": at_main["bound_by"],
        "library_ms": None, "shape": list(MAIN_SHAPE),
        "main_path_ms": main_out["kernel_ms"], "shapes": rows}]}
    print(card)
    print(json.dumps({"main_path": main_out}))
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
