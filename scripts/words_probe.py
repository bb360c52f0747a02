"""The culled words pass on one GPU: its ablations, memory floors and the
parent's kernel against the tree's, timed in turns.

    git archive <parent commit> goworld_tpu_torch | tar -x -C build/parent
    python3 scripts/words_probe.py --parent build/parent

From the parent tree's ``csrc/aoi_grid.cu`` it generates, under the
git-ignored ``build/words_probe/``: the parent's kernel as it is, the same
without its pair loop, the same without its vote (no plane admitted), and
zero fills of the [S, C, C / 32] words with 16-byte stores in address
order and in the kernels' tile order; from this tree's source, its words
kernel at other occupancies, with a static walk of its units in place of
its queue, with 2 or 8 rows a lane in its walk in place of 4, and with its pair test's bit added by a
multiply-add in place of its OR.  Each is built with the port's nvcc
flags into its own library.  It then times, in turns (rounds alternate
forward and backward) with every output allocated beforehand, those and
the tree's own words kernel on three inputs that ``chip_smoke.py`` makes:
phase 7's first re-sort at ``million`` and at ``zipf100k``, and phase 6's
(64, 16384).  It also times the tree's wrapper with a fresh output
allocation against the same call's kernel launch alone, times the
parent's culled step against the tree's in turns, reports each
library's registers, spills and occupancy, and checks that the parent's
kernel and the tree's variants give the tree's words.  Prints one JSON
object and writes the whole report (ptxas output included) to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402
from goworld_tpu_torch.ops import _build  # noqa: E402
from goworld_tpu_torch.ops import aoi_grid as AG  # noqa: E402

OUT_DIR = os.path.join(ROOT, "build", "words_probe")

# text patches of the parent's aoi_grid.cu: {variant: [(old, new), ...]}
PAIR_LOOP = "test_planes<true>(cols, rows, need, acc);"
VOTE = ("const uint32_t need = __ballot_sync(\n"
        "        FULL, ball || (col_lo[tx] <= bhi + m && col_hi[tx] >= "
        "blo - m));")
VARIANTS = {
    "parent": [],
    "parent_no_pair_loop": [(PAIR_LOOP, "for (int q = 0; q < RPT; ++q) "
                                        "acc[q] = 0u;")],
    "parent_no_vote": [(VOTE, "const uint32_t need = 0u;")],
}
# and of the tree's: its occupancy, its unit queue and its walk's layout
QUEUE = """\
    if (tid == 0)
      next_unit = (int)gridDim.x + (int)atomicAdd(skipped + 1, 1ull);
    __syncthreads();
    u = next_unit;
"""
BLOCKS = "constexpr int WORDS_MIN_BLOCKS = 2;"
OR_TESTS = """\
          const uint32_t bit = 1u << p;
#pragma unroll
          for (int q = 0; q < LROWS; ++q) {
            pair_test(v[q][0], xj.x, zj.x, xi[q], zi[q], ri[q], bit);
            pair_test(v[q][1], xj.y, zj.y, xi[q], zi[q], ri[q], bit);
            pair_test(v[q][2], xj.z, zj.z, xi[q], zi[q], ri[q], bit);
            pair_test(v[q][3], xj.w, zj.w, xi[q], zi[q], ri[q], bit);
          }
"""
# the pair test with its bit added on the FMA pipe (IMAD of an FSET mask
# and -bit) in place of the predicated OR, which issues to the ALU pipe
# with the two compares
MAD_TEST = r"""
__device__ __forceinline__ void pair_test_mad(uint32_t& acc, float xj,
                                              float zj, float xi, float zi,
                                              float ri, uint32_t nbit) {
  asm("{\n\t.reg .f32 d;\n\t.reg .pred p;\n\t.reg .u32 m;\n\t"
      "sub.rn.f32 d, %1, %3;\n\t"
      "abs.f32 d, d;\n\t"
      "setp.le.f32 p, d, %5;\n\t"
      "sub.rn.f32 d, %2, %4;\n\t"
      "abs.f32 d, d;\n\t"
      "set.le.and.u32.f32 m, d, %5, p;\n\t"
      "mad.lo.u32 %0, m, %6, %0;\n\t}"
      : "+r"(acc)
      : "f"(xj), "f"(zj), "f"(xi), "f"(zi), "f"(ri), "r"(nbit));
}

"""
WORDS_HEAD = "// Row tiles a words unit holds at most"
LROWS = "constexpr int LROWS = 4;"
TREE_VARIANTS = {
    "change_min_3_blocks": [(BLOCKS, BLOCKS.replace("2", "3"))],
    "change_min_4_blocks": [(BLOCKS, BLOCKS.replace("2", "4"))],
    "change_2_rows_a_lane": [(LROWS, LROWS.replace("4", "2"))],
    "change_8_rows_a_lane": [(LROWS, LROWS.replace("4", "8"))],
    "change_mad_accumulate": [
        (OR_TESTS, OR_TESTS.replace("bit = 1u << p", "bit = 0u - (1u << p)")
         .replace("pair_test(", "pair_test_mad(")),
        (WORDS_HEAD, MAD_TEST + WORDS_HEAD)],
    "change_static_walk": [(QUEUE, "    __syncthreads();\n"
                                   "    u += gridDim.x;\n")],
}

FILL_SRC = r"""
// Zero fills of an [S, C, W] int32 array with 16-byte stores: in address
// order (a grid-stride loop) and in the culled kernels' tile order (the
// persistent walk of aoi_tile.cuh, each tile's 4-word chunks as the
// kernels' culled tiles store them).
#include "aoi_tile.cuh"
using namespace aoi_tile;

__global__ void fill_addr(uint4* out, int64_t n) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    out[i] = zero;
}

__global__ void __launch_bounds__(TW * TY, 4)
fill_tile(int32_t* out, int C, int W, const Plan plan) {
  const int tid = threadIdx.y * TW + threadIdx.x;
  const int c4 = (tid % CHUNKS) * 4;
  Cursor cur;
  for (cur.enter(plan, blockIdx.x); cur.ok(plan); cur.next(plan)) {
    const int w0 = cur.g * TW + c4;
    if (w0 >= W) continue;
    const int64_t base = (int64_t)cur.s * C;
    const int row0 = cur.t * TR;
    for (int rr = tid / CHUNKS; rr < TR && row0 + rr < C; rr += CH_ROWS)
      *reinterpret_cast<uint4*>(out + (base + row0 + rr) * (int64_t)W + w0) =
          make_uint4(0u, 0u, 0u, 0u);
  }
}

extern "C" int gw_fill_addr(void* out, int64_t n16, void* stream,
                            int64_t grid) {
  fill_addr<<<(unsigned)grid, 256, 0, (cudaStream_t)stream>>>((uint4*)out,
                                                               n16);
  return (int)cudaGetLastError();
}

extern "C" int gw_fill_tile(void* out, int64_t S, int64_t C, void* stream,
                            int64_t grid, int64_t tiles) {
  Plan plan;
  if (C % 128 != 0 || !make_plan(plan, S, C, C / 32, grid, tiles))
    return (int)cudaErrorInvalidValue;
  fill_tile<<<(unsigned)grid, dim3(TW, TY), 0, (cudaStream_t)stream>>>(
      (int32_t*)out, (int)C, (int)(C / 32), plan);
  return (int)cudaGetLastError();
}
"""


def _patched(tree, sub, variants):
    """Write each variant of ``tree``'s csrc/aoi_grid.cu into OUT_DIR/sub
    beside a copy of its aoi_tile.cuh; returns the sources' paths."""
    csrc = os.path.join(tree, "goworld_tpu_torch", "csrc")
    out = os.path.join(OUT_DIR, sub)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(csrc, "aoi_grid.cu")) as f:
        grid_src = f.read()
    with open(os.path.join(csrc, "aoi_tile.cuh")) as f:
        tile_src = f.read()
    with open(os.path.join(out, "aoi_tile.cuh"), "w") as f:
        f.write(tile_src)
    paths = {}
    for name, patches in variants.items():
        src = grid_src
        for old, new in patches:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: {tree} has no single {old!r}")
            src = src.replace(old, new)
        paths[name] = os.path.join(out, f"{name}.cu")
        with open(paths[name], "w") as f:
            f.write(src)
    return paths


def generate(parent):
    """Write the variants' sources and the fills; returns their paths."""
    paths = {**_patched(parent, "parent", VARIANTS),
             **_patched(ROOT, "tree", TREE_VARIANTS)}
    paths["fill"] = os.path.join(OUT_DIR, "parent", "fill.cu")
    with open(paths["fill"], "w") as f:
        f.write(FILL_SRC)
    return paths


def build(paths):
    """One nvcc per source, started together; returns {name: (lib, log)}."""
    nvcc = _build._nvcc()
    procs = {}
    for n, src in paths.items():
        so = os.path.join(OUT_DIR, f"lib{n}.so")
        procs[n] = (so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for n, (so, p) in procs.items():
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc {n}.cu failed:\n{text}")
        out[n] = (ctypes.CDLL(so), text)
    return out


def ptxas_summary(text):
    """Each kernel's registers, spills and shared memory from ptxas -v."""
    rows, fn = [], None
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            fn = m.group(1)
        elif "spill" in line and fn:
            rows.append({"fn": fn, "spills": line.split(":", 1)[-1].strip()})
        elif (m := re.search(r"Used (\d+) registers(.*)", line)) and fn:
            rows.append({"fn": fn, "registers": int(m.group(1)),
                         "rest": m.group(2).strip(" ,")})
    return rows


def culled_fn(lib):
    fn = lib.gw_aoi_culled
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 2 + \
        [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p] + \
        [ctypes.c_int64] * 2
    return fn


def lib_occupancy(lib, step=0):
    fn = lib.gw_aoi_culled_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_int)]
    n, b = ctypes.c_int(0), ctypes.c_int(0)
    rc = fn(step, ctypes.byref(n), ctypes.byref(b))
    CS.check(rc == 0, f"occupancy query failed: {rc}")
    return n.value, b.value


def stream():
    return torch.cuda.current_stream().cuda_stream


def words_call(fn, plan, ins, out, skipped, prev=None, chg=None):
    """The words kernel (or, given prev and chg, the step) of one library
    on preallocated buffers, the counters zeroed first as the wrapper
    zeroes them."""
    s, c = ins[0].shape
    tiles = ctypes.c_int64(0)
    skipped.zero_()
    rc = fn(*(t.data_ptr() for t in ins),
            None if prev is None else prev.data_ptr(), out.data_ptr(),
            None if chg is None else chg.data_ptr(), skipped.data_ptr(), s,
            c, ctypes.byref(tiles), stream(), plan.grid, plan.tiles)
    CS.check(rc == 0, f"launch failed: CUDA error {rc}")


def step_turns(libs, ins, rounds, reps):
    """The parent's culled step against the tree's, in turns, on the same
    inputs with random prev words; their outputs must be equal."""
    s, c = ins[0].shape
    prev = CS.random_words((s, c, c // 32), seed=7)
    bufs = {k: (torch.empty_like(prev), torch.empty_like(prev))
            for k in ("parent", "tree")}
    skipped = torch.zeros(2, dtype=torch.int64, device=CS.DEV)
    fns = {"parent": culled_fn(libs["parent"][0]), "tree": AG._lib()}
    occ = {"parent": lib_occupancy(libs["parent"][0], 1),
           "tree": AG.occupancy("aoi_grid", "gw_aoi_culled_occupancy", 1,
                                torch.device(CS.DEV))}
    runs = {k: (lambda k=k: words_call(
        fns[k], AG.culled_plan(s, c, *occ[k]), ins, bufs[k][0], skipped,
        prev, bufs[k][1])) for k in fns}
    for k in runs:
        runs[k]()
    torch.cuda.synchronize()
    CS.check(torch.equal(bufs["parent"][0], bufs["tree"][0]) and
             torch.equal(bufs["parent"][1], bufs["tree"][1]),
             "the parent's step != the tree's")
    times = {k: [] for k in runs}
    for rnd in range(rounds):
        for k in (list(runs) if rnd % 2 == 0 else list(runs)[::-1]):
            times[k].append(CS.cuda_ms(runs[k], reps, warm=1))
    return {"median_ms": {k: float(np.median(v)) for k, v in times.items()},
            "ms": times}


def inputs():
    """(label, [x, z, r, act]) sorted as the words pass gets them."""
    out = []
    for name in ("million", "zipf100k"):
        cfg = CS.GIANT[name]
        _, _, xs, zs = CS.make_walk(cfg, np.random.default_rng(0),
                                    CS.RESORT_K + CS.TAIL_TICKS)
        r, act = CS.make_state(cfg)
        x = torch.from_numpy(xs[0]).to(CS.DEV)
        z = torch.from_numpy(zs[0]).to(CS.DEV)
        sx, sz, rs, acts, _ = AG.sort_spaces(x, z, r, act)
        out.append((f"{name} first re-sort", [sx, sz, rs, acts]))
    i = CS.CULLED_SHAPES.index((64, 16384))
    out.append(("phase 6 (64, 16384)",
                CS.culled_inputs(AG, 64, 16384, seed=400 + i)))
    return out


def first_pass(ins, reps=3):
    """The tree's wrapper with a fresh output allocation (the caching
    allocator emptied first) and with a cached one, each bracketed by
    CUDA events, beside the same calls' kernel launches alone (events
    around the C call) and the host time of the allocation alone."""
    real = AG._lib
    launch = []

    def timed_lib():
        fn = real()

        def call(*a):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            rc = fn(*a)
            e1.record()
            launch.append((e0, e1))
            return rc
        return call

    shape = (*ins[0].shape, ins[0].shape[1] // 32)
    res = {}
    AG._lib = timed_lib
    try:
        for mode in ("fresh", "cached"):
            brackets, allocs = [], []
            launch.clear()
            for _ in range(reps):
                torch.cuda.synchronize()
                if mode == "fresh":
                    torch.cuda.empty_cache()
                t0 = time.perf_counter()
                probe = torch.empty(shape, dtype=torch.int32, device=CS.DEV)
                allocs.append((time.perf_counter() - t0) * 1e3)
                del probe
                if mode == "fresh":
                    torch.cuda.empty_cache()
                torch.cuda.synchronize()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                e0.record()
                words, _ = AG.aoi_words_culled_cuda(*ins)
                e1.record()
                host = (time.perf_counter() - t0) * 1e3
                torch.cuda.synchronize()
                brackets.append({"bracket_ms": e0.elapsed_time(e1),
                                 "wrapper_host_ms": host})
                del words
            torch.cuda.synchronize()
            for b, (a0, a1) in zip(brackets, launch):
                b["launch_ms"] = a0.elapsed_time(a1)
            res[mode] = {"calls": brackets, "alloc_host_ms": allocs}
    finally:
        AG._lib = real
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="an unpacked tree of the parent commit")
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "report.json"),
                    help="where the whole report goes (JSON)")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("words_probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.build_all(force=True)
    libs = build(generate(args.parent))
    report = {"card": card, "build_s": time.perf_counter() - t0,
              "ptxas": {n: ptxas_summary(t) for n, (_, t) in libs.items()},
              "tree_ptxas": {n: ptxas_summary(t)
                             for n, t in _build.build_log.items()},
              "occupancy": {n: lib_occupancy(lib)
                            for n, (lib, _) in libs.items() if n != "fill"},
              "tree_occupancy": AG.occupancy(
                  "aoi_grid", "gw_aoi_culled_occupancy", 0,
                  torch.device(CS.DEV)),
              "inputs": []}
    fill = libs["fill"][0]
    fill.gw_fill_addr.restype = fill.gw_fill_tile.restype = ctypes.c_int
    fill.gw_fill_addr.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_void_p, ctypes.c_int64]
    fill.gw_fill_tile.argtypes = [ctypes.c_void_p] + [ctypes.c_int64] * 2 + \
        [ctypes.c_void_p] + [ctypes.c_int64] * 2
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, ins in inputs():
        s, c = ins[0].shape
        w = c // 32
        out = torch.empty((s, c, w), dtype=torch.int32, device=CS.DEV)
        ref = torch.empty_like(out)
        skipped = torch.zeros(2, dtype=torch.int64, device=CS.DEV)
        words, frac = AG.aoi_words_culled_cuda(*ins)  # the tree's plan
        tree_plan = AG.last_plan["aoi_words_culled"]
        ref.copy_(words)
        del words
        runs = {"tree": lambda: words_call(AG._lib(), tree_plan,
                                           ins, out, skipped)}
        for name in [*VARIANTS, *TREE_VARIANTS]:
            fn = culled_fn(libs[name][0])
            plan = (AG.culled_plan if name in VARIANTS else AG.words_plan)(
                s, c, *lib_occupancy(libs[name][0]))
            runs[name] = (lambda fn=fn, plan=plan:
                          words_call(fn, plan, ins, out, skipped))
        runs["fill_addr_16B"] = lambda: CS.check(fill.gw_fill_addr(
            out.data_ptr(), out.numel() // 4, stream(), n_sms * 8) == 0,
            "fill_addr")
        runs["fill_tile_16B"] = lambda: CS.check(fill.gw_fill_tile(
            out.data_ptr(), s, c, stream(), tree_plan.grid,
            tree_plan.tiles) == 0, "fill_tile")
        runs["torch_zero_"] = out.zero_
        for name in ["parent", *TREE_VARIANTS]:
            out.fill_(-1)
            runs[name]()
            torch.cuda.synchronize()
            CS.check(torch.equal(out, ref), f"{label}: {name} != tree words")
        times = {k: [] for k in runs}
        order = list(runs)
        for rnd in range(args.rounds):
            for k in (order if rnd % 2 == 0 else order[::-1]):
                times[k].append(CS.cuda_ms(runs[k], args.reps, warm=1))
        row = {"input": label, "shape": [s, c], "culled_frac": float(frac),
               "tree_plan": dataclasses.asdict(tree_plan),
               "median_ms": {k: float(np.median(v)) for k, v in
                             times.items()},
               "ms": times}
        del out, ref
        row["step"] = step_turns(libs, ins, args.rounds, args.reps)
        if "first re-sort" in label:
            row["first_pass"] = first_pass(ins)
        print(json.dumps(row), file=sys.stderr, flush=True)
        report["inputs"].append(row)
        del ins
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(card)
    print(json.dumps({k: v for k, v in report.items()
                      if k not in ("ptxas", "tree_ptxas")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
