// Block-culled AOI words and step for Hopper (sm_90a): the dense
// predicate of aoi_step.cu, skipping every (row tile, bit plane) step
// whose widened x windows are disjoint.  One source, two kernels:
//
//   * words (STEP = false) replaces goworld_tpu/ops/aoi_grid.py
//     aoi_words_culled (Pallas body _culled_kernel);
//   * step  (STEP = true)  replaces goworld_tpu/ops/aoi_grid.py
//     aoi_step_culled (Pallas body _culled_step_kernel): the same words
//     fused with chg = new ^ prev.
//
// Plain versions they are held to bit for bit:
// goworld_tpu_torch/ops/aoi_grid.py aoi_words_culled_plain /
// aoi_step_culled_plain (the dense words of aoi_dense.py).
//
// What it computes, for every space s, observer row i and word w
// (W = C / 32, the caller's slot order -- x-sorted for the cull to bite):
//   new[s, i, w] bit k  <=>  j = k*W + w satisfies
//       |x_j - x_i| <= r_i  &&  |z_j - z_i| <= r_i  &&  act_i && act_j
//       && i != j
// in IEEE float32 (sub -> abs -> compare), built without fast math.
//
// The cull only ever admits: a block of TR rows and TW words evaluates
// plane k unless
//     min over the plane's candidate columns of x  >  row_hi + m   or
//     max over the plane's candidate columns of x  <  row_lo - m
// with row_lo = min(x_i - r_i), row_hi = max(x_i + r_i) over the block's
// active rows with finite x_i and r_i, column bounds over active columns
// with finite x_j, and the margin m = 1e-3 + 1e-5 * max(|x_i| + |r_i|)
// over the same rows.  A hit needs fl(|x_j - x_i|) <= r_i, so x_j lies
// within r_i (1 + 2^-24) of x_i; the rounding of the bounds and of the
// widening is at most a few 2^-24 (|x_i| + r_i), far below m.  Rows that
// can hit nothing (NaN x or r, an infinite x with a finite r, inactive)
// stay out of the bounds, so a NaN never poisons them -- the JAX cull
// table's global margin max(radius) turns NaN on one NaN radius and drops
// every block.  An active row with r = +inf can hit infinite columns too,
// so its block evaluates every plane.  Every admitted pair is then
// re-checked by the exact predicate, activity as masks: the words equal
// the dense definition at any tile size.
//
// What bounds it: at BASELINE's `million` (S = 64, C = 16384) and
// `zipf100k` (S = 1, C = 131072) shapes one [S, C, W] word array is
// 2 GiB.  The step reads prev and writes new and chg (6 GiB, 1.92 ms at
// 3.35 TB/s); the words kernel writes new only (2 GiB, 0.64 ms).  The
// pair tests are the admitted fraction of 17.2 G (about 2-3 % on sorted
// inputs), so bytes bound both.  On the H100 a fill plus a copy of the
// same arrays take 2.06 ms in two passes; one pass that reads prev and
// writes both outputs, as the step must, is slower (its reads and writes
// mix, and a tile touches 128-byte pieces of 64 rows), and the step now
// runs at about the speed of such a pass with its vote left out
// (PERF.md section 6).
//
// What the design does about that:
//   * the persistent walk of aoi_tile.cuh (the grid is what fits on the
//     card, gw_aoi_culled_occupancy; ops/aoi_grid.py culled_plan chooses
//     the row tiles per unit): a unit's 32 planes x TW columns of x and z
//     are staged in shared memory once, and its 32 plane bounds are
//     reduced once (one warp shuffle reduction per plane), for all its
//     tiles;
//   * the next tile's rows (one register per lane) and, in the step, its
//     prev words (cp.async into the tile's three-slot ring, 16 bytes a
//     thread where rows are aligned) are in flight while the current
//     tile votes and stores, so prev holds no registers;
//   * the cull is decided per (64-row tile, 32-word group, plane) from
//     data the block holds anyway: the row reach reduced across lanes
//     (one row a lane), one barrier per tile (the reach is double-
//     buffered by tile parity, and the barrier also makes the ring
//     readable), then every warp reduces the block's reach and votes the
//     32 plane flags into one word itself (no cull table in device
//     memory, no pre-pass, no host sync);
//   * a tile with no plane to test writes new = 0 and chg = prev straight
//     from the ring, 16 bytes a store where rows are aligned; otherwise
//     only the voted planes are visited (a loop over the set bits,
//     uniform across the block, so no warp diverges) and the rows are
//     spread to registers only then;
//   * new (and chg) are written for every word, culled or not; offsets
//     are 64-bit;
//   * each block adds its count of culled planes to one device counter
//     (one atomicAdd per block), so the culled fraction is a device
//     scalar with no sync.
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

// A tile with no plane to test: new = 0 and, in the step, chg = prev from
// the ring, 4-word chunks (copy_prev's) as one 16-byte store where `vec`.
template <bool STEP>
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
      if constexpr (STEP)
        *reinterpret_cast<uint4*>(chg_out + o) =
            *reinterpret_cast<const uint4*>(&pv[rr][c4]);
    } else {
      for (int e = 0; e < 4 && w0 + e < W; ++e) {
        new_out[o + e] = 0;
        if constexpr (STEP) chg_out[o + e] = (int32_t)pv[rr][c4 + e];
      }
    }
  }
}

// at most 64 registers, so 4 blocks share an SM
template <bool STEP>
__global__ void __launch_bounds__(TW * TY, 4)
aoi_culled_kernel(const float* __restrict__ x, const float* __restrict__ z,
                  const float* __restrict__ r,
                  const uint8_t* __restrict__ act,
                  const int32_t* __restrict__ prev,
                  int32_t* __restrict__ new_out,
                  int32_t* __restrict__ chg_out,
                  unsigned long long* __restrict__ skipped, int C, int W,
                  const Plan plan) {
  __shared__ Cols cols;
  __shared__ __align__(16) PrevSlot ring[STEP ? SLOTS : 1];
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
  const bool vec = rows_aligned16(new_out, W) &&
                   (!STEP || (rows_aligned16(prev, W) &&
                              rows_aligned16(chg_out, W)));
  if constexpr (STEP) {
    copy_prev(ring[0], prev, (int64_t)cur.s * C, cur.t * TR, C, W, cur.g,
              vec);
    cp_async_commit();
  }
  int staged = -1, slot = 0, par = 0;
  int culled = 0;  // thread (0, 0): culled planes of the block's tiles
  for (;;) {
    const int64_t base = (int64_t)cur.s * C;
    const int row0 = cur.t * TR;
    const int w = cur.g * TW + tx;
    if (cur.u != staged) {  // uniform across the block
      stage_cols(cols, x, z, act, base, W, w);
      // each plane's x bounds over its active columns with a finite x
      // (read by the votes after this tile's barrier)
      for (int k = ty; k < PLANES; k += TY) {
        const float xv = cols.xs[k][tx];
        const bool in = ((cols.act_plane[k] >> tx) & 1u) && isfinite(xv);
        const float lo = warp_min(in ? xv : inf);
        const float hi = warp_max(in ? xv : -inf);
        if (tx == 0) {
          col_lo[k] = lo;
          col_hi[k] = hi;
        }
      }
      staged = cur.u;
    }
    RowFetch fn = f;
    Cursor nxt = cur;
    nxt.next(plan);
    const bool more = nxt.ok(plan);
    if (more) {  // the next tile's rows (and prev), in flight from here
      fn = fetch_rows(x, z, r, act, nullptr, (int64_t)nxt.s * C, nxt.t * TR,
                      C);
      if constexpr (STEP)
        copy_prev(ring[(slot + 1) % SLOTS], prev, (int64_t)nxt.s * C,
                  nxt.t * TR, C, W, nxt.g, vec);
    }
    if constexpr (STEP) cp_async_commit();

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
    if constexpr (STEP) cp_async_wait_prior();
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
      store_rows<STEP ? Emit::kChg : Emit::kWords>(
          cols, rows, acc, ring[slot], plan, C, base, row0, C, W, w, new_out,
          chg_out, nullptr);
    } else {
      store_culled<STEP>(ring[slot], base, row0, C, W, cur.g, vec, new_out,
                         chg_out);
    }
    if (!more) break;
    cur = nxt;
    f = fn;
    if constexpr (STEP) slot = (slot + 1) % SLOTS;
    par ^= 1;
  }
  if (tx == 0 && ty == 0 && culled)
    atomicAdd(skipped, (unsigned long long)culled);
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
                   blocks_per_sm, aoi_culled_kernel<true>, TW * TY, 0)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   blocks_per_sm, aoi_culled_kernel<false>, TW * TY, 0);
  return (int)e;
}

// x, z, r: float32 [S, C]; act: uint8 (torch.bool) [S, C]; prev, chg_out:
// int32 [S, C, C / 32] for the step, both null for the words kernel;
// new_out: int32 [S, C, C / 32], no output aliasing prev; skipped: one
// uint64 the kernel adds its culled (row tile, word group, plane) steps
// to (the caller zeroes it).  All contiguous on one device.  grid and
// tiles are the plan of ops/aoi_grid.py culled_plan (blocks, row tiles
// per unit).  Launches on `stream` and returns cudaGetLastError() (0 =
// launched).  *tiles receives the number of (row tile, word group,
// plane) steps of the launch.
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
      !make_plan(plan, S, C, W, grid, tiles_per_unit))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (prev) {
    aoi_culled_kernel<true><<<(unsigned)grid, dim3(TW, TY), 0, st>>>(
        (const float*)x, (const float*)z, (const float*)r,
        (const uint8_t*)act, (const int32_t*)prev, (int32_t*)new_out,
        (int32_t*)chg_out, (unsigned long long*)skipped, (int)C, (int)W,
        plan);
  } else {
    aoi_culled_kernel<false><<<(unsigned)grid, dim3(TW, TY), 0, st>>>(
        (const float*)x, (const float*)z, (const float*)r,
        (const uint8_t*)act, nullptr, (int32_t*)new_out, nullptr,
        (unsigned long long*)skipped, (int)C, (int)W, plan);
  }
  return (int)cudaGetLastError();
}
