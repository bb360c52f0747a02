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
// inputs), so bytes bound both.
//
// What the design does about that (measured on the H100: the first
// design spent its time issuing per-word instructions, not moving bytes):
//   * the tile of aoi_tile.cuh, shared with aoi_step.cu: a thread owns one
//     word column and RPT observer rows, the block stages its 32 planes x
//     TW columns of x and z in shared memory once, and activity and
//     self-exclusion are one AND per word;
//   * the cull is decided inside the block from data it stages anyway:
//     one warp shuffle reduction per plane for the column bounds, one
//     per-warp reduction for the row reach, and warp 0 votes the 32
//     plane flags into one word (no cull table in device memory, no
//     pre-pass, no host sync);
//   * only the needed planes are visited (a loop over the set bits of
//     that word, uniform across the block, so no warp diverges), and the
//     self bit's word and plane are carried from row to row without a
//     division;
//   * the words kernel walks RT row tiles per block with the staged
//     columns (amortizing the staging); the step prefetches its prev
//     words before the cull decision, so their latency overlaps it (one
//     tile per block keeps it within 64 registers);
//   * new (and chg) are written for every word, culled or not, coalesced
//     along w; offsets are 64-bit;
//   * each block adds its count of culled planes to one device counter
//     (one atomicAdd per block), so the culled fraction is a device
//     scalar with no sync.
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

// at most 64 registers, so 4 blocks share an SM (at 70 the words kernel
// ran 30% slower on the path)
template <bool STEP, int RT>
__global__ void __launch_bounds__(TW * TY, 4)
aoi_culled_kernel(const float* __restrict__ x, const float* __restrict__ z,
                  const float* __restrict__ r,
                  const uint8_t* __restrict__ act,
                  const int32_t* __restrict__ prev,
                  int32_t* __restrict__ new_out,
                  int32_t* __restrict__ chg_out,
                  unsigned long long* __restrict__ skipped, int C, int W) {
  __shared__ Cols cols;
  __shared__ float col_lo[PLANES], col_hi[PLANES];
  __shared__ float part_lo[TY], part_hi[TY], part_mag[TY];
  __shared__ int part_all[TY];
  __shared__ uint32_t need_s;

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int w = blockIdx.x * TW + tx;
  const int64_t base = (int64_t)blockIdx.z * C;
  const float inf = __int_as_float(0x7f800000);

  stage_cols(cols, x, z, act, base, W, w);
  // each plane's x bounds over its active columns with a finite x (read
  // by warp 0's vote after the tile loop's first __syncthreads)
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

  int culled = 0;  // thread (0, 0): culled planes of the block's tiles
  for (int t = 0; t < RT; ++t) {
    const int row0 = (blockIdx.y * RT + t) * TR;
    if (row0 >= C) break;  // uniform across the block
    uint32_t pv[RPT] = {};
    // prefetch prev: its latency overlaps the cull decision
    if constexpr (STEP) load_prev(pv, prev, base, row0, C, W, w);
    Rows rows;
    load_rows(rows, x, z, r, act, base, row0, C);

    // the row tile's reach over its active rows with finite x and r
    float lo = inf, hi = -inf, mag = 0.f;
    bool all = false;
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const bool a = (rows.act >> q) & 1u;
      const float xi = rows.x[q], ri = rows.r[q];
      if (a && isfinite(xi) && isfinite(ri)) {
        lo = fminf(lo, xi - ri);
        hi = fmaxf(hi, xi + ri);
        mag = fmaxf(mag, fabsf(xi) + fabsf(ri));
      }
      all |= a && ri == inf;
    }
    if (tx == 0) {  // every lane of a warp holds the same rows
      part_lo[ty] = lo;
      part_hi[ty] = hi;
      part_mag[ty] = mag;
      part_all[ty] = all;
    }
    __syncthreads();

    if (ty == 0) {  // warp 0: lane k decides plane k
      float blo = inf, bhi = -inf, bmag = 0.f;
      bool ball = false;
#pragma unroll
      for (int u = 0; u < TY; ++u) {
        blo = fminf(blo, part_lo[u]);
        bhi = fmaxf(bhi, part_hi[u]);
        bmag = fmaxf(bmag, part_mag[u]);
        ball |= part_all[u] != 0;
      }
      const float m = 1e-3f + 1e-5f * bmag;
      const bool need =
          ball || (col_lo[tx] <= bhi + m && col_hi[tx] >= blo - m);
      const uint32_t mask = __ballot_sync(FULL, need);
      if (tx == 0) {
        need_s = mask;
        culled += PLANES - __popc(mask);
      }
    }
    __syncthreads();

    uint32_t acc[RPT];
    test_planes<true>(cols, rows, need_s, acc);
    store_rows<STEP ? Emit::kChg : Emit::kWords>(
        cols, rows, acc, pv, SelfSquare(row0, W), base, row0, C, W, w,
        new_out, chg_out, nullptr);
    __syncthreads();  // the next tile reuses part_* and need_s
  }
  if (tx == 0 && ty == 0 && culled)
    atomicAdd(skipped, (unsigned long long)culled);
}

// row tiles per block: the words kernel amortizes its staging over
// several; the step keeps one (its prefetched prev would push a
// multi-tile loop past 64 registers)
constexpr int RT_WORDS = 4;
constexpr int RT_STEP = 1;

}  // namespace

// x, z, r: float32 [S, C]; act: uint8 (torch.bool) [S, C]; prev, chg_out:
// int32 [S, C, C / 32] for the step, both null for the words kernel;
// new_out: int32 [S, C, C / 32]; skipped: one uint64 the kernel adds its
// culled (row tile, plane) steps to (the caller zeroes it).  All
// contiguous on one device.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).  *tiles receives the number of
// (row tile, plane) steps of the launch.
extern "C" int gw_aoi_culled(const void* x, const void* z, const void* r,
                             const void* act, const void* prev,
                             void* new_out, void* chg_out, void* skipped,
                             int64_t S, int64_t C, int64_t* tiles,
                             void* stream) {
  const int64_t W = C / 32;
  const int64_t row_tiles = (C + TR - 1) / TR;
  const int rt = prev ? RT_STEP : RT_WORDS;
  const dim3 block(TW, TY);
  const dim3 grid((unsigned)((W + TW - 1) / TW),
                  (unsigned)((row_tiles + rt - 1) / rt), (unsigned)S);
  *tiles = (int64_t)grid.x * row_tiles * S * PLANES;
  if (S <= 0 || C <= 0) return 0;
  if (C % 32 != 0 || S > 65535 || C > (1 << 30) || grid.y > 65535 ||
      (prev == nullptr) != (chg_out == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (prev) {
    aoi_culled_kernel<true, RT_STEP><<<grid, block, 0, st>>>(
        (const float*)x, (const float*)z, (const float*)r,
        (const uint8_t*)act, (const int32_t*)prev, (int32_t*)new_out,
        (int32_t*)chg_out, (unsigned long long*)skipped, (int)C, (int)W);
  } else {
    aoi_culled_kernel<false, RT_WORDS><<<grid, block, 0, st>>>(
        (const float*)x, (const float*)z, (const float*)r,
        (const uint8_t*)act, nullptr, (int32_t*)new_out, nullptr,
        (unsigned long long*)skipped, (int)C, (int)W);
  }
  return (int)cudaGetLastError();
}
