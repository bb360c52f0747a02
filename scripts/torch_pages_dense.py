"""Time the page allocator's write pass with and without its dense branch.

``csrc/pages.cu``'s ``page_write`` rereads a granted bin whole when it
is dense (``cnt * SPAN >= bw * sum_words``: a lane's expected
flagged groups reach the whole reread's steps) and gathers the
summary's flagged groups otherwise.  This script builds two more variants of the source
(the branch always taken, and never taken) beside the source as it
stands, and times all three on the card in turns (base, always, never,
never, always, base) on the same inputs:

- each paged tick of ``chip_smoke.py`` phase 17b's clustered crowd (the
  allocator's inputs recorded on the paged run);
- phase 3d's full grid (every word nonzero);
- phase 4's last tick at its pool floor (phase 3d's main case);
- 1 x 16384 x 512 words of seeded random words at densities from 1% to
  30% (every bin granted), which place the branch's threshold.

Every variant's seven outputs are held to ``allocate_pages_plain``.
Prints the card's name and power limit, then one JSON line a case:
``graph_ms`` (CUDA events around graph replays of 20 calls: device time)
and ``page_write`` (torch.profiler, the write pass's device ms) for each
variant and turn.  Run on a machine with a CUDA card::

    python3 scripts/torch_pages_dense.py

The variants build under ``build/pages_dense/`` (listed in
``.gitignore``).  Exits 1 without a card.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

DENSE_IF = "if (static_cast<i64>(cnt[b]) * SPAN >= bw * sum_words) {"
VARIANTS = {"base": None, "always": "if (true) {", "never": "if (false) {"}
TURNS = ["base", "always", "never", "never", "always", "base"]
DENSITIES = (0.01, 0.03, 0.06, 0.09, 0.12, 0.15, 0.3)
DEV = "cuda"


def build(_build, PC):
    """Each variant's ``gw_allocate_pages``, built in parallel."""
    src = open(os.path.join(_build.CSRC_DIR, "pages.cu")).read()
    if DENSE_IF not in src:
        raise RuntimeError("page_write's dense branch not found in pages.cu")
    procs = {}
    for name, cond in VARIANTS.items():
        d = os.path.join(ROOT, "build", "pages_dense", name)
        os.makedirs(d, exist_ok=True)
        cu = os.path.join(d, "pages.cu")
        with open(cu, "w") as f:
            f.write(src if cond is None else src.replace(DENSE_IF, cond))
        so = os.path.join(d, "libpages.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{out}")
        fn = ctypes.CDLL(so).gw_allocate_pages
        fn.restype = ctypes.c_int
        fn.argtypes = PC._ARGTYPES
        fns[name] = fn
    return fns


def cluster_inputs(C, PC):
    """The allocator's inputs on each tick of phase 17b's paged run."""
    from goworld_tpu_torch.engine.aoi import AOIEngine

    rec = []
    orig = PC.allocate_pages_cuda

    def recording(chg, new, free, page_words, bin_words, max_spill,
                  out=None, scratch=None):
        rec.append((chg.clone(), new.clone(), free.clone(), bin_words))
        return orig(chg, new, free, page_words, bin_words, max_spill,
                    out=out, scratch=scratch)

    PC.allocate_pages_cuda = recording
    try:
        C.cluster_run(AOIEngine, C.cluster_frames(), "cuda", C.DEV, True)
    finally:
        PC.allocate_pages_cuda = orig
    return [(f"17b tick {i}", c, n, f, bw)
            for i, (c, n, f, bw) in enumerate(rec)]


def random_grid(PG, density, seed=5):
    g = torch.Generator(device=DEV).manual_seed(seed)
    w = torch.randint(1, 2**31 - 1, (1, 16384, 512), device=DEV,
                      dtype=torch.int32, generator=g)
    w[torch.rand(w.shape, device=DEV, generator=g) >= density] = 0
    bw = PG.bin_words_for(512)
    n_pages = int((w != 0).sum()) // 64 + w.numel() // bw + 1
    free = torch.randperm(n_pages, device=DEV, generator=g).int()
    return (f"1x16384x512 at {density}", w, torch.roll(w, 1), free, bw)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_pages_dense: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as C
    from goworld_tpu_torch.engine.runtime import Runtime
    from goworld_tpu_torch.ops import _build, aoi_cuda as AK
    from goworld_tpu_torch.ops import aoi_dense as AD, events as EV
    from goworld_tpu_torch.ops import aoi_pages as PG, pages_cuda as PC

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build.build_all()
    fns = build(_build, PC)
    cases = cluster_inputs(C, PC)
    cases += [("3d " + e[0], *e[1:]) for e in C.pages_edge_cases(C.DEV)
              if e[0].startswith("full grid")]
    _, _, grids = C.phase_main(Runtime, AK, AD, EV)
    chg, new = grids[:2]
    n_pages = PG.pool_floor(chg.numel())
    rng = np.random.default_rng(43)
    free = torch.from_numpy(rng.permutation(n_pages).astype(np.int32)).to(
        C.DEV)
    cases.append(("phase 4 tick", chg, new, free,
                  PG.bin_words_for(chg.shape[-1])))
    cases += [random_grid(PG, d) for d in DENSITIES]
    orig = PC._fn
    try:
        for label, c, n, f, bw in cases:
            def call():
                return PC.allocate_pages_cuda(c, n, f, PG.PAGE_WORDS, bw,
                                              PG.MAX_SPILL)

            want = PG.allocate_pages_plain(c, n, f, PG.PAGE_WORDS, bw,
                                           PG.MAX_SPILL)
            row = {"case": label, "words": c.numel(),
                   "nonzero": int((c != 0).sum()), "n_pages": f.numel()}
            for name in TURNS:
                PC._fn = lambda fn=fns[name]: fn
                got = call()
                torch.cuda.synchronize()
                C.check(all(torch.equal(a, b) for a, b in zip(got, want)),
                        f"{label}: the {name} variant disagrees with "
                        f"allocate_pages_plain")
                row.setdefault(name, []).append({
                    "graph_ms": C.graph_ms(call),
                    "page_write": C.stage_split(call).get("page_write")})
            print(json.dumps(row), flush=True)
    finally:
        PC._fn = orig
    return 0


if __name__ == "__main__":
    sys.exit(main())
