// Block-culled AOI words and step for Hopper (sm_90a): the dense
// predicate of aoi_step.cu, skipping every (row tile, bit plane) step
// whose widened x windows are disjoint.  One source, two kernels:
//
//   * culled_words_kernel replaces goworld_tpu/ops/aoi_grid.py
//     aoi_words_culled (Pallas body _culled_kernel): the words under a
//     fresh x order, once per re-sort;
//   * culled_step_kernel replaces goworld_tpu/ops/aoi_grid.py
//     aoi_step_culled (Pallas body _culled_step_kernel): the same words
//     fused with chg = new ^ prev, once per tick.
//
// Plain versions they are held to bit for bit:
// goworld_tpu_torch/ops/aoi_grid.py aoi_words_culled_plain /
// aoi_step_culled_plain (the dense words of aoi_dense.py); their vote's
// plain version is aoi_grid.py tile_votes.
//
// What it computes, for every space s, observer row i and word w
// (W = C / 32, the caller's slot order -- x-sorted for the cull to bite):
//   new[s, i, w] bit k  <=>  j = k*W + w satisfies
//       |x_j - x_i| <= r_i  &&  |z_j - z_i| <= r_i  &&  act_i && act_j
//       && i != j
// in IEEE float32 (sub -> abs -> compare), built without fast math.
//
// The cull only ever admits: a tile of TR rows and TW words evaluates
// plane k unless
//     min over the plane's candidate columns of x  >  row_hi + m   or
//     max over the plane's candidate columns of x  <  row_lo - m
// with row_lo = min(x_i - r_i), row_hi = max(x_i + r_i) over the tile's
// active rows with finite x_i and r_i, column bounds over active columns
// with finite x_j, and the margin m = 1e-3 + 1e-5 * max(|x_i| + |r_i|)
// over the same rows (one fused multiply-add).  A hit needs
// fl(|x_j - x_i|) <= r_i, so x_j lies within r_i (1 + 2^-24) of x_i; the
// rounding of the bounds and of the widening is at most a few 2^-24
// (|x_i| + r_i), far below m.  Rows that can hit nothing (NaN x or r, an
// infinite x with a finite r, inactive) stay out of the bounds, so a NaN
// never poisons them -- the JAX cull table's global margin max(radius)
// turns NaN on one NaN radius and drops every block.  An active row with
// r = +inf can hit infinite columns too, so its tile evaluates every
// plane.  Every admitted pair is then re-checked by the exact predicate,
// activity as masks: the words equal the dense definition at any tile
// size.  Both kernels vote per (64-row tile, 32-word group, plane) by
// this rule, so their culled fractions are equal.
//
// What bounds them: at BASELINE's `million` (S = 64, C = 16384) and
// `zipf100k` (S = 1, C = 131072) shapes one [S, C, W] word array is
// 2 GiB.  The step reads prev and writes new and chg (6 GiB, 1.92 ms at
// 3.35 TB/s); the words kernel writes new only (2 GiB, 0.64 ms).  The
// pair tests are the admitted fraction of 17.2 G: about 2-3 % on the
// path's sorted inputs, where bytes bound both, and 45 % on the nearly
// sorted ones of chip_smoke.py phase 6, where the words kernel is bound
// by its pair tests (7.7 G at 5.7 SASS instructions each, 1.3 ms of
// issue).
//
// Both kernels write every word, culled or not, at 64-bit offsets, and
// count their culled planes in one device counter (a few atomics a
// block), so the culled fraction is a device scalar with no sync.
//
// The step: the persistent walk of aoi_tile.cuh (the
// grid is what fits on the card, gw_aoi_culled_occupancy;
// ops/aoi_grid.py culled_plan chooses the row tiles per unit).  A unit's
// 32 planes x TW columns of x and z are staged in shared memory once and
// its 32 plane bounds reduced once, for all its tiles; the next tile's
// rows (one register per lane) and prev words (cp.async into the tile's
// three-slot ring, 16 bytes a thread where rows are aligned) are in
// flight while the current tile votes and stores, so prev holds no
// registers.  Each tile reduces its row reach across lanes (one row a
// lane), passes one barrier (the reach is double-buffered by tile parity,
// and the barrier also makes the ring readable), then every warp reduces
// the block's reach and votes the 32 plane flags into one word itself
// (no cull table in device memory, no pre-pass, no host sync).  A tile
// with no plane to test writes new = 0 and chg = prev straight from the
// ring, 16 bytes a store where rows are aligned; otherwise only the voted
// planes are visited (a loop over the set bits, uniform across the
// block) and the rows are spread to registers only then.  It runs at
// about the speed of one pass that reads prev and writes both outputs in
// its tile order (PERF.md section 6).
//
// The words pass: on the step's design it took 1.22 / 1.06 ms on the
// path's first re-sort inputs at `million` / `zipf100k`, 0.90 / 0.88
// without its pair loop and 0.87 / 0.84 without its vote, against 0.72
// for a 16-byte zero fill of the array in the same tile order and 0.675
// in address order (scripts/words_probe.py, the step-0 chip call of
// PERF.md section 6, NVIDIA H100 80GB HBM3 at 700 W): every tile's
// block barrier left the pair loop's latency exposed, and the reach and
// barrier cost 0.15 ms over the fill.  Its own design:
//   * a unit (space, 32-word group, at most UNIT_TILES row tiles) is
//     staged once: its columns and their plane bounds, and its rows,
//     loaded coalesced into shared memory; then one warp a tile reduces
//     the tile's reach and votes its 32 planes into a need mask; five
//     barriers a unit, none in the walk;
//   * the walk: TILE_WARPS warps share a tile, each walking its own rows
//     of every other tile on its own; a lane tests 4 rows against 4
//     words (16 pair tests a plane from two 16-byte shared loads),
//     applies activity and self-exclusion once per word, and writes each
//     row's 4 words as one 16-byte store where rows are aligned (4-byte
//     stores otherwise); a tile with no plane to test stores zeros on
//     the same path;
//   * units past the grid are taken from a queue in device memory (one
//     atomic a unit), since their costs differ with the culled fraction;
//   * about 80 registers, 3 blocks an SM, no spills (more blocks or
//     fewer registers were slower in the same script's turns).
// Measured (the same script and card in turns with the step's design,
// PERF.md section 6): 0.80 / 0.84 ms on those inputs (1.23 / 1.07
// before), 2.00 ms on phase 6's (3.22 before), where the pair tests'
// issue floor is 1.3 ms.
// Outputs may not alias prev.
#include "aoi_tile.cuh"

namespace {

using namespace aoi_tile;

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// The x bounds of the staged planes over their active columns with a
// finite x (warp ty takes planes ty, ty + TY, ...; read after a barrier).
__device__ __forceinline__ void plane_bounds(const Cols& cols, float* col_lo,
                                             float* col_hi) {
  const int tx = threadIdx.x;
  const float inf = __int_as_float(0x7f800000);
  for (int k = threadIdx.y; k < PLANES; k += TY) {
    const float xv = cols.xs[k][tx];
    const bool in = ((cols.act_plane[k] >> tx) & 1u) && isfinite(xv);
    const float lo = warp_min(in ? xv : inf);
    const float hi = warp_max(in ? xv : -inf);
    if (tx == 0) {
      col_lo[k] = lo;
      col_hi[k] = hi;
    }
  }
}

// -- the step ------------------------------------------------------------------

// A tile with no plane to test: new = 0 and chg = prev from the ring,
// 4-word chunks (copy_prev's) as one 16-byte store where `vec`.
__device__ __forceinline__ void store_culled(const PrevSlot& pv,
                                             int64_t row_base, int row0,
                                             int R, int W, int g, bool vec,
                                             int32_t* __restrict__ new_out,
                                             int32_t* __restrict__ chg_out) {
  const int tid = threadIdx.y * TW + threadIdx.x;
  const int c4 = (tid % CHUNKS) * 4, w0 = g * TW + c4;
  if (w0 >= W) return;
#pragma unroll
  for (int rr = tid / CHUNKS; rr < TR; rr += CH_ROWS) {
    if (row0 + rr >= R) break;
    const int64_t o = (row_base + row0 + rr) * (int64_t)W + w0;
    if (vec) {
      *reinterpret_cast<uint4*>(new_out + o) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(chg_out + o) =
          *reinterpret_cast<const uint4*>(&pv[rr][c4]);
    } else {
      for (int e = 0; e < 4 && w0 + e < W; ++e) {
        new_out[o + e] = 0;
        chg_out[o + e] = (int32_t)pv[rr][c4 + e];
      }
    }
  }
}

// at most 64 registers, so 4 blocks share an SM
__global__ void __launch_bounds__(TW * TY, 4)
culled_step_kernel(const float* __restrict__ x, const float* __restrict__ z,
                   const float* __restrict__ r,
                   const uint8_t* __restrict__ act,
                   const int32_t* __restrict__ prev,
                   int32_t* __restrict__ new_out,
                   int32_t* __restrict__ chg_out,
                   unsigned long long* __restrict__ skipped, int C, int W,
                   const Plan plan) {
  __shared__ Cols cols;
  __shared__ __align__(16) PrevSlot ring[SLOTS];
  __shared__ float col_lo[PLANES], col_hi[PLANES];
  __shared__ float part_lo[2][TY], part_hi[2][TY], part_mag[2][TY];
  __shared__ int part_all[2][TY];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const float inf = __int_as_float(0x7f800000);

  Cursor cur;
  cur.enter(plan, blockIdx.x);
  if (!cur.ok(plan)) return;  // the whole block
  RowFetch f = fetch_rows(x, z, r, act, nullptr, (int64_t)cur.s * C,
                          cur.t * TR, C);
  const bool vec = rows_aligned16(new_out, W) && rows_aligned16(prev, W) &&
                   rows_aligned16(chg_out, W);
  copy_prev(ring[0], prev, (int64_t)cur.s * C, cur.t * TR, C, W, cur.g, vec);
  cp_async_commit();
  int staged = -1, slot = 0, par = 0;
  int culled = 0;  // thread (0, 0): culled planes of the block's tiles
  for (;;) {
    const int64_t base = (int64_t)cur.s * C;
    const int row0 = cur.t * TR;
    const int w = cur.g * TW + tx;
    if (cur.u != staged) {  // uniform across the block
      stage_cols(cols, x, z, act, base, W, w);
      plane_bounds(cols, col_lo, col_hi);  // read after this tile's barrier
      staged = cur.u;
    }
    RowFetch fn = f;
    Cursor nxt = cur;
    nxt.next(plan);
    const bool more = nxt.ok(plan);
    if (more) {  // the next tile's rows and prev, in flight from here
      fn = fetch_rows(x, z, r, act, nullptr, (int64_t)nxt.s * C, nxt.t * TR,
                      C);
      copy_prev(ring[(slot + 1) % SLOTS], prev, (int64_t)nxt.s * C,
                nxt.t * TR, C, W, nxt.g, vec);
    }
    cp_async_commit();

    // the warp's reach over its active rows with finite x and r: lane l
    // takes row l % RPT, then the 8 lanes of a row set reduce
    float lo = inf, hi = -inf, mag = 0.f;
    {
      const int q = tx % RPT;
      const float xi = __uint_as_float(__shfl_sync(FULL, f.v, q));
      const float ri = __uint_as_float(__shfl_sync(FULL, f.v, 2 * RPT + q));
      const bool a = (__ballot_sync(FULL, f.v != 0u) >> (3 * RPT + q)) & 1u;
      if (a && isfinite(xi) && isfinite(ri)) {
        lo = xi - ri;
        hi = xi + ri;
        mag = fabsf(xi) + fabsf(ri);
      }
      const bool all = __ballot_sync(FULL, a && ri == inf) != 0u;
#pragma unroll
      for (int o = 1; o < RPT; o <<= 1) {
        lo = fminf(lo, __shfl_xor_sync(FULL, lo, o));
        hi = fmaxf(hi, __shfl_xor_sync(FULL, hi, o));
        mag = fmaxf(mag, __shfl_xor_sync(FULL, mag, o));
      }
      if (tx == 0) {
        part_lo[par][ty] = lo;
        part_hi[par][ty] = hi;
        part_mag[par][ty] = mag;
        part_all[par][ty] = all;
      }
    }
    // this thread's copies of this tile landed; after the barrier, every
    // other thread's too
    cp_async_wait_prior();
    __syncthreads();

    // every warp votes: the block's reach reduced over the TY parts (lane
    // l reads part l % TY), then lane k decides plane k
    float blo = part_lo[par][tx % TY], bhi = part_hi[par][tx % TY];
    float bmag = part_mag[par][tx % TY];
#pragma unroll
    for (int o = 1; o < TY; o <<= 1) {
      blo = fminf(blo, __shfl_xor_sync(FULL, blo, o));
      bhi = fmaxf(bhi, __shfl_xor_sync(FULL, bhi, o));
      bmag = fmaxf(bmag, __shfl_xor_sync(FULL, bmag, o));
    }
    const bool ball = __ballot_sync(FULL, part_all[par][tx % TY] != 0) != 0u;
    const float m = 1e-3f + 1e-5f * bmag;
    const uint32_t need = __ballot_sync(
        FULL, ball || (col_lo[tx] <= bhi + m && col_hi[tx] >= blo - m));
    if (tx == 0 && ty == 0) culled += PLANES - __popc(need);

    if (need) {  // uniform across the block
      Rows rows;
      take_rows(rows, f);
      uint32_t acc[RPT];
      test_planes<true>(cols, rows, need, acc);
      store_rows<Emit::kChg>(cols, rows, acc, ring[slot], plan, C, base,
                             row0, C, W, w, new_out, chg_out, nullptr);
    } else {
      store_culled(ring[slot], base, row0, C, W, cur.g, vec, new_out,
                   chg_out);
    }
    if (!more) break;
    cur = nxt;
    f = fn;
    slot = (slot + 1) % SLOTS;
    par ^= 1;
  }
  if (tx == 0 && ty == 0 && culled)
    atomicAdd(skipped, (unsigned long long)culled);
}

// -- the words pass --------------------------------------------------------------

// Row tiles a words unit holds at most (ops/aoi_grid.py WORDS_UNIT_TILES).
constexpr int UNIT_TILES = 32;

// One words unit in shared memory (about 34 KB): its columns and their
// plane bounds, its rows, and each tile's voted planes.
struct WordsUnit {
  Cols cols;
  float col_lo[PLANES], col_hi[PLANES];
  float x[UNIT_TILES * TR], z[UNIT_TILES * TR], r[UNIT_TILES * TR];
  uint8_t act[UNIT_TILES * TR];
  uint32_t need[UNIT_TILES];
};

// Rows a lane tests in the walk (against 4 words): a warp covers 4 * LROWS
// rows of a tile, TILE_WARPS warps the whole tile.
constexpr int LROWS = 4;
constexpr int TILE_WARPS = TR / (4 * LROWS);

// At least 2 blocks an SM (at most 128 registers a thread): ptxas takes 80,
// so 3 blocks of 35 KB share an SM.
constexpr int WORDS_MIN_BLOCKS = 2;

__global__ void __launch_bounds__(TW * TY, WORDS_MIN_BLOCKS)
culled_words_kernel(const float* __restrict__ x,
                    const float* __restrict__ z,
                    const float* __restrict__ r,
                    const uint8_t* __restrict__ act,
                    int32_t* __restrict__ new_out,
                    unsigned long long* __restrict__ skipped, int C, int W,
                    const Plan plan) {
  __shared__ __align__(16) WordsUnit su;
  __shared__ int next_unit;

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TW + tx;
  const float inf = __int_as_float(0x7f800000);
  const bool vec = rows_aligned16(new_out, W);
  // in the walk, lane tx takes words 4 * (tx % 8) .. + 3 of the group in
  // rows lrow + 4 * q (q < LROWS) of the tiles it walks: TILE_WARPS warps
  // share a tile, so the block walks TY / TILE_WARPS tiles at once
  const int quad = 4 * (tx % 8);
  const int lrow = (ty % TILE_WARPS) * 4 * LROWS + tx / 8;
  int culled = 0;  // lane 0: culled planes of the warp's votes

  for (int u = blockIdx.x; u < plan.units;) {
    Cursor cur;
    cur.enter(plan, u);
    const int64_t base = (int64_t)cur.s * C;
    const int row0 = cur.t * TR;
    const int nt = cur.t_end - cur.t;

    // the unit's columns (stage_cols opens with a barrier: the previous
    // unit's walk is over), their plane bounds and its rows
    stage_cols(su.cols, x, z, act, base, W, cur.g * TW + tx);
    plane_bounds(su.cols, su.col_lo, su.col_hi);
#pragma unroll 4
    for (int k = tid; k < nt * TR; k += TW * TY) {
      const int i = row0 + k;
      float xv = 0.f, zv = 0.f, rv = 0.f;
      uint8_t a = 0;
      if (i < C) {
        xv = x[base + i];
        zv = z[base + i];
        rv = r[base + i];
        a = act[base + i] != 0;
      }
      su.x[k] = xv;
      su.z[k] = zv;
      su.r[k] = rv;
      su.act[k] = a;
    }
    // the block's next unit: units past the grid go to whichever block
    // asks first (their costs differ with the culled fraction)
    if (tid == 0)
      next_unit = (int)gridDim.x + (int)atomicAdd(skipped + 1, 1ull);
    __syncthreads();
    u = next_unit;

    // the vote, one warp a tile: the reach over the tile's active rows
    // with finite x and r (lane l takes rows l and l + 32), widened by
    // the margin, against each plane's bounds (lane k takes plane k)
    for (int t = ty; t < nt; t += TY) {
      float lo = inf, hi = -inf, mag = 0.f;
      bool all = false;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = t * TR + h * TW + tx;
        const float xi = su.x[k], ri = su.r[k];
        const bool a = su.act[k];
        if (a && isfinite(xi) && isfinite(ri)) {
          lo = fminf(lo, xi - ri);
          hi = fmaxf(hi, xi + ri);
          mag = fmaxf(mag, fabsf(xi) + fabsf(ri));
        }
        all = all || (a && ri == inf);
      }
      lo = warp_min(lo);
      hi = warp_max(hi);
      mag = warp_max(mag);
      const bool ball = __ballot_sync(FULL, all) != 0u;
      const float m = 1e-3f + 1e-5f * mag;
      const uint32_t need = __ballot_sync(
          FULL,
          ball || (su.col_lo[tx] <= hi + m && su.col_hi[tx] >= lo - m));
      if (tx == 0) {
        su.need[t] = need;
        culled += PLANES - __popc(need);
      }
    }
    __syncthreads();

    // the walk: each warp its own rows of every other tile, no barrier; a
    // tile with no plane to test stores zeros on the same path
    const int w0 = cur.g * TW + quad;
    if (w0 >= W) continue;
    const uint4 am = *reinterpret_cast<const uint4*>(&su.cols.actw[quad]);
    for (int t = ty / TILE_WARPS; t < nt; t += TY / TILE_WARPS) {
      const uint32_t need = su.need[t];  // uniform across the warp
      int k[LROWS];
      uint32_t v[LROWS][4];
#pragma unroll
      for (int q = 0; q < LROWS; ++q) {
        k[q] = t * TR + lrow + 4 * q;
#pragma unroll
        for (int e = 0; e < 4; ++e) v[q][e] = 0u;
      }
      if (need) {
        float xi[LROWS], zi[LROWS], ri[LROWS];
#pragma unroll
        for (int q = 0; q < LROWS; ++q) {
          xi[q] = su.x[k[q]];
          zi[q] = su.z[k[q]];
          ri[q] = su.r[k[q]];
        }
        for (uint32_t nm = need; nm; nm &= nm - 1) {
          const int p = __ffs(nm) - 1;
          const float4 xj =
              *reinterpret_cast<const float4*>(&su.cols.xs[p][quad]);
          const float4 zj =
              *reinterpret_cast<const float4*>(&su.cols.zs[p][quad]);
          const uint32_t bit = 1u << p;
#pragma unroll
          for (int q = 0; q < LROWS; ++q) {
            pair_test(v[q][0], xj.x, zj.x, xi[q], zi[q], ri[q], bit);
            pair_test(v[q][1], xj.y, zj.y, xi[q], zi[q], ri[q], bit);
            pair_test(v[q][2], xj.z, zj.z, xi[q], zi[q], ri[q], bit);
            pair_test(v[q][3], xj.w, zj.w, xi[q], zi[q], ri[q], bit);
          }
        }
        // activity and self-exclusion as masks: row i's own column is
        // i = kk * W + wi, bit kk of word wi
#pragma unroll
        for (int q = 0; q < LROWS; ++q) {
          const int i = row0 + k[q];
          const uint32_t row_on = su.act[k[q]] ? FULL : 0u;
          const int kk = div_w(plan, i);
          const int wi = i - kk * W;
          const uint32_t own = 1u << kk;
          v[q][0] &= am.x & row_on & (wi == w0 ? ~own : FULL);
          v[q][1] &= am.y & row_on & (wi == w0 + 1 ? ~own : FULL);
          v[q][2] &= am.z & row_on & (wi == w0 + 2 ? ~own : FULL);
          v[q][3] &= am.w & row_on & (wi == w0 + 3 ? ~own : FULL);
        }
      }
#pragma unroll
      for (int q = 0; q < LROWS; ++q) {
        const int i = row0 + k[q];
        if (i >= C) continue;
        const int64_t o = (base + i) * (int64_t)W + w0;
        if (vec) {
          *reinterpret_cast<uint4*>(new_out + o) =
              make_uint4(v[q][0], v[q][1], v[q][2], v[q][3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (w0 + e < W) new_out[o + e] = (int32_t)v[q][e];
        }
      }
    }
  }
  if (tx == 0 && culled) atomicAdd(skipped, (unsigned long long)culled);
}

}  // namespace

// The persistent grid's inputs for one kernel (step != 0: the step, else
// the words kernel) on the current device: its SM count and how many
// blocks of the kernel fit on one SM.  Returns a CUDA error code (0 =
// read).
extern "C" int gw_aoi_culled_occupancy(int step, int* n_sms,
                                       int* blocks_per_sm) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = step ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   blocks_per_sm, culled_step_kernel, TW * TY, 0)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   blocks_per_sm, culled_words_kernel, TW * TY, 0);
  return (int)e;
}

// x, z, r: float32 [S, C]; act: uint8 (torch.bool) [S, C]; prev, chg_out:
// int32 [S, C, C / 32] for the step, both null for the words kernel;
// new_out: int32 [S, C, C / 32], no output aliasing prev; skipped: two
// uint64, zeroed by the caller: [0] the culled (row tile, word group,
// plane) steps, which the kernel adds to, [1] the words kernel's queue of
// units.  All contiguous on one device.  grid and
// tiles are the plan of ops/aoi_grid.py culled_plan (the step) or
// words_plan (the words kernel: at most UNIT_TILES row tiles a unit).
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// *tiles receives the number of (row tile, word group, plane) steps of
// the launch.
extern "C" int gw_aoi_culled(const void* x, const void* z, const void* r,
                             const void* act, const void* prev,
                             void* new_out, void* chg_out, void* skipped,
                             int64_t S, int64_t C, int64_t* tiles,
                             void* stream, int64_t grid,
                             int64_t tiles_per_unit) {
  const int64_t W = C / 32;
  *tiles = ((W + TW - 1) / TW) * ((C + TR - 1) / TR) * S * PLANES;
  if (S <= 0 || C <= 0) return 0;
  Plan plan;
  if (C % 32 != 0 || C > (1 << 30) ||
      (prev == nullptr) != (chg_out == nullptr) ||
      (!prev && tiles_per_unit > UNIT_TILES) ||
      !make_plan(plan, S, C, W, grid, tiles_per_unit))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (prev) {
    culled_step_kernel<<<(unsigned)grid, dim3(TW, TY), 0, st>>>(
        (const float*)x, (const float*)z, (const float*)r,
        (const uint8_t*)act, (const int32_t*)prev, (int32_t*)new_out,
        (int32_t*)chg_out, (unsigned long long*)skipped, (int)C, (int)W,
        plan);
  } else {
    culled_words_kernel<<<(unsigned)grid, dim3(TW, TY), 0, st>>>(
        (const float*)x, (const float*)z, (const float*)r,
        (const uint8_t*)act, (int32_t*)new_out,
        (unsigned long long*)skipped, (int)C, (int)W, plan);
  }
  return (int)cudaGetLastError();
}
