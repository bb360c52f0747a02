// The AOI predicate's block tile and the persistent walk, shared by
// aoi_step.cu (dense square and rectangular step) and aoi_grid.cu
// (block-culled step): the launch plan and its unit walk, the staging of
// 32 candidate planes, the observer rows, the asynchronous copy of prev,
// the pair test and the masked, coalesced store.  The culled words pass
// (aoi_grid.cu) takes the plan, the staging and the pair test.  One copy,
// so the kernels cannot drift apart.
//
// Layout (block TW x TY threads): a thread owns one word column w and RPT
// consecutive observer rows i = row0 + ty*RPT + q of a TR-row tile; the
// block stages the candidates j = k*W + w (k = 0..31) of its TW word
// columns in shared memory once per work unit, so each (x_j, z_j) read
// from shared memory serves RPT rows from registers.  For each row and
// word:
//   bit k  <=>  |xc_j - x_i| <= r_i  &&  |zc_j - z_i| <= r_i
//               && act_i && actc_j && g_i != j
// in IEEE float32 (sub -> abs -> compare); activity and self-exclusion are
// masks applied once per word, never folded into the positions.  Build
// without fast math: its flush-to-zero would make |subnormal| <= 0 true
// where IEEE says false.  Offsets into [S, R, W] arrays are 64-bit.
//
// The walk: a work unit is (space s, word group g of TW words, a run of
// up to `tiles` row tiles), numbered with g fastest.  Block b takes units
// b, b + gridDim.x, ... (the grid is what fits on the card at once) and
// walks their tiles in order; the next tile's rows (one register per
// lane) and prev words (cp.async, 16 bytes a thread, into a three-slot
// ring in shared memory) are in flight while the current tile computes.
// A thread reads prev words that other threads copied, so each tile
// waits for its own copies, then passes one barrier before the ring is
// read; the slot a tile refills was last read two tiles before, ahead of
// the barrier the refilling thread has passed since.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace aoi_tile {

constexpr int TW = 32;   // words per block (threadIdx.x)
constexpr int TY = 8;    // row groups per block (threadIdx.y)
constexpr int RPT = 8;   // observer rows per thread
constexpr int TR = TY * RPT;  // observer rows per tile
constexpr int PLANES = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int64_t MAX_UNITS = int64_t(1) << 30;  // u + gridDim.x fits int

// The launch plan: ops/aoi_cuda.py step_plan chooses the grid and
// `tiles`; make_plan derives the rest and checks it.
struct Plan {
  int row_tiles;  // ceil(R / TR)
  int groups;     // ceil(W / TW)
  int runs;       // ceil(row_tiles / tiles): runs per (space, group)
  int tiles;      // row tiles per unit (the last run of a group may hold fewer)
  int units;      // S * runs * groups
  unsigned div_m;  // n / W = (umulhi(div_m, n) + n) >> div_l for n < 2^31
  int div_l;       // (Granlund-Montgomery: l = ceil(log2 W),
                   //  m = floor(2^32 (2^l - W) / W) + 1)
};

inline bool make_plan(Plan& p, int64_t S, int64_t R, int64_t W,
                      int64_t grid, int64_t tiles) {
  const int64_t row_tiles = (R + TR - 1) / TR;
  const int64_t groups = (W + TW - 1) / TW;
  if (S < 1 || R < 1 || W < 1 || W > (1 << 25) || tiles < 1 ||
      tiles > row_tiles)
    return false;
  const int64_t runs = (row_tiles + tiles - 1) / tiles;
  const int64_t units = S * runs * groups;
  if (units > MAX_UNITS || grid < 1 || grid > units) return false;
  int l = 0;
  while ((int64_t(1) << l) < W) ++l;
  const uint64_t m = ((uint64_t(1) << 32) * ((uint64_t(1) << l) - W)) / W + 1;
  p = {(int)row_tiles, (int)groups, (int)runs, (int)tiles, (int)units,
       (unsigned)m, l};
  return true;
}

// n / W for 0 <= n < 2^31 (the sum below stays under 2^32)
__device__ __forceinline__ int div_w(const Plan& p, int n) {
  return (int)((__umulhi(p.div_m, (unsigned)n) + (unsigned)n) >> p.div_l);
}

// A position of the block's walk: unit u (word group fastest, then run,
// then space) and its row tile t in [t, t_end).
struct Cursor {
  int u, s, g, t, t_end;
  __device__ __forceinline__ void enter(const Plan& p, int unit) {
    u = unit;
    if (u >= p.units) return;
    g = u % p.groups;
    const int v = u / p.groups;
    s = v / p.runs;
    t = (v % p.runs) * p.tiles;
    t_end = min(t + p.tiles, p.row_tiles);
  }
  __device__ __forceinline__ bool ok(const Plan& p) const {
    return u < p.units;
  }
  __device__ __forceinline__ void next(const Plan& p) {
    if (++t == t_end) enter(p, u + (int)gridDim.x);
  }
};

// The block's candidate tile in shared memory (8.3 KB).
struct Cols {
  float xs[PLANES][TW];
  float zs[PLANES][TW];
  uint32_t act_plane[PLANES];  // bit t: column (k, w0 + t) is active
  uint32_t actw[TW];           // bit k: column (k, w0 + t) is active
};

// Stage the columns j = k*W + w of the block's word columns from the
// [S, C] candidate arrays at col_base (warp ty takes planes ty, ty + TY,
// ...; a word column past W stages as inactive).  Starts and ends
// synchronized, so the previous unit's columns are no longer read.
__device__ __forceinline__ void stage_cols(Cols& c,
                                           const float* __restrict__ xc,
                                           const float* __restrict__ zc,
                                           const uint8_t* __restrict__ actc,
                                           int64_t col_base, int W, int w) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  __syncthreads();
  for (int k = ty; k < PLANES; k += TY) {
    float xv = 0.f, zv = 0.f;
    bool a = false;
    if (w < W) {
      const int64_t j = col_base + (int64_t)k * W + w;
      xv = xc[j];
      zv = zc[j];
      a = actc[j] != 0;
    }
    c.xs[k][tx] = xv;
    c.zs[k][tx] = zv;
    const uint32_t am = __ballot_sync(FULL, a);
    if (tx == 0) c.act_plane[k] = am;
  }
  __syncthreads();
  if (ty == 0) {  // warp 0 transposes the activity into one word per column
    uint32_t m = 0;
#pragma unroll
    for (int k = 0; k < PLANES; ++k) m |= ((c.act_plane[k] >> tx) & 1u) << k;
    c.actw[tx] = m;
  }
  __syncthreads();
}

// The next tile's rows in flight: lane l holds field l / RPT (x, z, r as
// bits, act) of the warp's row l % RPT, and lanes below RPT the row's
// global id (row_ids[i], or i itself in square mode).
struct RowFetch {
  uint32_t v;
  int id;
};

__device__ __forceinline__ RowFetch fetch_rows(
    const float* __restrict__ x, const float* __restrict__ z,
    const float* __restrict__ r, const uint8_t* __restrict__ act,
    const int32_t* __restrict__ row_ids, int64_t row_base, int row0, int R) {
  const int lane = threadIdx.x, f = lane / RPT;
  const int i = row0 + (int)threadIdx.y * RPT + lane % RPT;
  // a row past R never stores; a NaN radius keeps its tests false
  RowFetch o{f == 2 ? 0x7fc00000u : 0u, -1};
  if (i < R) {
    const int64_t at = row_base + i;
    if (f == 3)
      o.v = act[at];
    else
      o.v = __float_as_uint((f == 0 ? x : f == 1 ? z : r)[at]);
    if (f == 0) o.id = row_ids ? row_ids[at] : i;
  }
  return o;
}

// The thread's RPT observer rows, spread from the warp's fetch.
struct Rows {
  float x[RPT], z[RPT], r[RPT];
  uint32_t act;  // bit q: row q exists and is active
  int id;        // lane q < RPT: row q's global id
};

__device__ __forceinline__ void take_rows(Rows& rw, const RowFetch& f) {
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    rw.x[q] = __uint_as_float(__shfl_sync(FULL, f.v, q));
    rw.z[q] = __uint_as_float(__shfl_sync(FULL, f.v, RPT + q));
    rw.r[q] = __uint_as_float(__shfl_sync(FULL, f.v, 2 * RPT + q));
  }
  rw.act = __ballot_sync(FULL, f.v != 0u) >> (3 * RPT);
  rw.id = f.id;
}

// cp.async of 16 (aligned) or 4 bytes from global into shared memory.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group of this thread is in flight
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One slot of the prev ring: the tile's [TR][TW] prev words.
using PrevSlot = uint32_t[TR][TW];
constexpr int SLOTS = 3;

// Word rows of a [.., W] int32 array start 16-byte aligned: 4-word chunks
// move as one vector (every space capacity, a multiple of 128, gives it).
__device__ __forceinline__ bool rows_aligned16(const void* p, int W) {
  return W % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The tile's 4-word chunks: thread tid = ty * TW + tx takes chunk
// tid % CHUNKS of rows tid / CHUNKS and tid / CHUNKS + CH_ROWS.
constexpr int CHUNKS = TW / 4;
constexpr int CH_ROWS = TW * TY / CHUNKS;  // rows per pass (32)

// Start the copy of the tile's prev words into `slot` (words past R or W
// are neither copied nor read): 16 bytes a chunk where `vec`, else 4 a
// word.  Readable by every thread after cp_async_wait_prior and a barrier.
__device__ __forceinline__ void copy_prev(PrevSlot& slot,
                                          const int32_t* __restrict__ prev,
                                          int64_t row_base, int row0, int R,
                                          int W, int g, bool vec) {
  const int tid = threadIdx.y * TW + threadIdx.x;
  const int c4 = (tid % CHUNKS) * 4, w0 = g * TW + c4;
  if (w0 >= W) return;
#pragma unroll
  for (int rr = tid / CHUNKS; rr < TR; rr += CH_ROWS) {
    if (row0 + rr >= R) break;
    const int32_t* src = prev + (row_base + row0 + rr) * (int64_t)W + w0;
    if (vec) {
      cp_async16(&slot[rr][c4], src);
    } else {
      for (int e = 0; e < 4 && w0 + e < W; ++e)
        cp_async4(&slot[rr][c4 + e], src + e);
    }
  }
}

// One pair test: acc |= bit where |xj - xi| <= ri && |zj - zi| <= ri, in
// IEEE float32 (sub -> abs -> compare; no .ftz, so a subnormal difference
// stays nonzero, and a NaN compares false).  Written in PTX so that it
// compiles to five instructions: two FADD, two FSETP with |.| as an
// operand modifier (the second ANDs into the first's predicate) and one
// predicated integer add or OR.  Written in C++, the && compiled to a
// select chain whose predicates spilled into register bits: the dense chg
// kernel grew from 2520 to 3496 SASS instructions (cuobjdump -sass,
// sm_90a), about 4 more a pair.
__device__ __forceinline__ void pair_test(uint32_t& acc, float xj, float zj,
                                          float xi, float zi, float ri,
                                          uint32_t bit) {
  asm("{\n\t.reg .f32 d;\n\t.reg .pred p;\n\t"
      "sub.rn.f32 d, %1, %3;\n\t"
      "abs.f32 d, d;\n\t"
      "setp.le.f32 p, d, %5;\n\t"
      "sub.rn.f32 d, %2, %4;\n\t"
      "abs.f32 d, d;\n\t"
      "setp.le.and.f32 p, d, %5, p;\n\t"
      "@p or.b32 %0, %0, %6;\n\t}"
      : "+r"(acc)
      : "f"(xj), "f"(zj), "f"(xi), "f"(zi), "f"(ri), "r"(bit));
}

// acc[q] bit k: the pair test of row q against plane k, for the planes set
// in `need` (CULL) or all 32 (unrolled, every bit an immediate).
template <bool CULL>
__device__ __forceinline__ void test_planes(const Cols& c, const Rows& rw,
                                            uint32_t need, uint32_t* acc) {
  const int tx = threadIdx.x;
#pragma unroll
  for (int q = 0; q < RPT; ++q) acc[q] = 0u;
  if constexpr (CULL) {
    for (uint32_t nm = need; nm; nm &= nm - 1) {  // uniform across the block
      const int k = __ffs(nm) - 1;
      const float xj = c.xs[k][tx];
      const float zj = c.zs[k][tx];
#pragma unroll
      for (int q = 0; q < RPT; ++q)
        pair_test(acc[q], xj, zj, rw.x[q], rw.z[q], rw.r[q], 1u << k);
    }
  } else {
#pragma unroll
    for (int k = 0; k < PLANES; ++k) {
      const float xj = c.xs[k][tx];
      const float zj = c.zs[k][tx];
#pragma unroll
      for (int q = 0; q < RPT; ++q)
        pair_test(acc[q], xj, zj, rw.x[q], rw.z[q], rw.r[q], 1u << k);
    }
  }
}

// What the masked store writes beside new: chg = new ^ prev (out1), or
// enter = new & ~prev (out1) and leave = prev & ~new (out2), prev read
// back from the thread's ring slot.
enum class Emit { kChg, kEntlv };

// Write new and the words of mode E for the thread's rows below R,
// coalesced along w.  Every word is written, zero where nothing was
// tested.  Outputs may not alias prev.  The space's row masks (chg mode):
// where `staged` is false new is prev and chg zero; where `emit` is false
// chg is zero (new stays the tested words).
template <Emit E>
__device__ __forceinline__ void store_rows(const Cols& c, const Rows& rw,
                                           const uint32_t* acc,
                                           const PrevSlot& pv,
                                           const Plan& plan, int C,
                                           int64_t row_base, int row0, int R,
                                           int W, int w,
                                           int32_t* __restrict__ new_out,
                                           int32_t* __restrict__ out1,
                                           int32_t* __restrict__ out2,
                                           bool staged = true,
                                           bool emit = true) {
  const uint32_t am = c.actw[threadIdx.x];
  const int i0 = row0 + (int)threadIdx.y * RPT;
  int64_t o = (row_base + i0) * (int64_t)W + w;
  // lane q < RPT: row q's own column j = k*W + w' as w' * 32 + k; an id
  // outside [0, C) excludes nothing
  int own = -1;
  if (rw.id >= 0 && rw.id < C) {
    const int k = div_w(plan, rw.id);
    own = (rw.id - k * W) * PLANES + k;
  }
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int self = __shfl_sync(FULL, own, q);  // every lane takes part
    if (w < W && i0 + q < R) {
      const uint32_t keep = w == (self >> 5) ? ~(1u << (self & 31)) : FULL;
      const uint32_t v = ((rw.act >> q) & 1u) ? (acc[q] & am & keep) : 0u;
      const uint32_t p = pv[threadIdx.y * RPT + q][threadIdx.x];
      if constexpr (E == Emit::kChg) {
        new_out[o] = (int32_t)(staged ? v : p);
        out1[o] = staged && emit ? (int32_t)(v ^ p) : 0;
      }
      if constexpr (E == Emit::kEntlv) {
        new_out[o] = (int32_t)v;
        out1[o] = (int32_t)(v & ~p);
        out2[o] = (int32_t)(p & ~v);
      }
    }
    o += W;
  }
}

}  // namespace aoi_tile
