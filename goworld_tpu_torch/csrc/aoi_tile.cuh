// The AOI predicate's block tile, shared by aoi_step.cu (dense square and
// rectangular step) and aoi_grid.cu (block-culled words and step): the
// staging of 32 candidate planes, the observer rows, the pair test and the
// masked, coalesced store.  One copy, so the kernels cannot drift apart.
//
// Layout (block TW x TY threads): a thread owns one word column w and RPT
// observer rows i = row0 + ty + q*TY; the block stages the candidates
// j = k*W + w (k = 0..31) of its TW word columns in shared memory once, so
// each (x_j, z_j) read from shared memory serves RPT rows from registers.
// For each row and word:
//   bit k  <=>  |xc_j - x_i| <= r_i  &&  |zc_j - z_i| <= r_i
//               && act_i && actc_j && g_i != j
// in IEEE float32 (sub -> abs -> compare); activity and self-exclusion are
// masks applied once per word, never folded into the positions.  Build
// without fast math: its flush-to-zero would make |subnormal| <= 0 true
// where IEEE says false.  Offsets into [S, R, W] arrays are 64-bit.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace aoi_tile {

constexpr int TW = 32;   // words per block (threadIdx.x)
constexpr int TY = 8;    // row groups per block (threadIdx.y)
constexpr int RPT = 8;   // observer rows per thread
constexpr int TR = TY * RPT;  // observer rows per block
constexpr int PLANES = 32;
constexpr unsigned FULL = 0xffffffffu;

// The block's candidate tile in shared memory (8.3 KB).
struct Cols {
  float xs[PLANES][TW];
  float zs[PLANES][TW];
  uint32_t act_plane[PLANES];  // bit t: column (k, w0 + t) is active
  uint32_t actw[TW];           // bit k: column (k, w0 + t) is active
};

// Stage the columns j = k*W + w of the block's word columns from the
// [S, C] candidate arrays at col_base (warp ty takes planes ty, ty + TY,
// ...; a word column past W stages as inactive).  Ends synchronized.
__device__ __forceinline__ void stage_cols(Cols& c,
                                           const float* __restrict__ xc,
                                           const float* __restrict__ zc,
                                           const uint8_t* __restrict__ actc,
                                           int64_t col_base, int W, int w) {
  const int tx = threadIdx.x, ty = threadIdx.y;
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

// The thread's RPT observer rows of [S, R] arrays at row_base.
struct Rows {
  float x[RPT], z[RPT], r[RPT];
  uint32_t act;  // bit q: row row0 + ty + q*TY exists and is active
};

__device__ __forceinline__ void load_rows(Rows& rw,
                                          const float* __restrict__ x,
                                          const float* __restrict__ z,
                                          const float* __restrict__ r,
                                          const uint8_t* __restrict__ act,
                                          int64_t row_base, int row0, int R) {
  rw.act = 0u;
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int i = row0 + threadIdx.y + q * TY;
    const bool ok = i < R;
    rw.x[q] = ok ? x[row_base + i] : 0.f;
    rw.z[q] = ok ? z[row_base + i] : 0.f;
    // a row past R never stores; NaN keeps its tests false
    rw.r[q] = ok ? r[row_base + i] : __int_as_float(0x7fc00000);
    rw.act |= ((ok && act[row_base + i] != 0) ? 1u : 0u) << q;
  }
}

// acc[q] bit k: the pair test of row q against plane k, for the planes set
// in `need` (CULL) or all 32 (unrolled, every shift an immediate).
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
      const uint32_t bit = 1u << k;
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const bool hit = (fabsf(xj - rw.x[q]) <= rw.r[q]) &&
                         (fabsf(zj - rw.z[q]) <= rw.r[q]);
        acc[q] |= hit ? bit : 0u;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < PLANES; ++k) {
      const float xj = c.xs[k][tx];
      const float zj = c.zs[k][tx];
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const bool hit = (fabsf(xj - rw.x[q]) <= rw.r[q]) &&
                         (fabsf(zj - rw.z[q]) <= rw.r[q]);
        acc[q] |= (hit ? 1u : 0u) << k;
      }
    }
  }
}

// Self-exclusion when g_i = i (square): row i's own column sits in word
// i % W, plane i / W, carried from row to row without a division.  keep()
// is called for the thread's rows in order, q = 0, 1, ...
struct SelfSquare {
  int ws, ks;
  __device__ SelfSquare(int row0, int W)
      : ws(row0 % W + (int)threadIdx.y), ks(row0 / W) {}
  __device__ __forceinline__ uint32_t keep(int64_t, int w, int W) {
    while (ws >= W) {
      ws -= W;
      ++ks;
    }
    const uint32_t m = w == ws ? ~(1u << ks) : FULL;
    ws += TY;
    return m;
  }
};

// Self-exclusion by global id: g_i = ids[s, i]; an id outside [0, C)
// excludes nothing.
struct SelfIds {
  const int32_t* __restrict__ ids;
  int C;
  __device__ __forceinline__ uint32_t keep(int64_t row, int w, int W) const {
    const int g = ids[row];
    return (g >= 0 && g < C && w == g % W) ? ~(1u << (g / W)) : FULL;
  }
};

// The thread's prev words of its rows (0 past R or W), for the diff words.
__device__ __forceinline__ void load_prev(uint32_t* pv,
                                          const int32_t* __restrict__ prev,
                                          int64_t row_base, int row0, int R,
                                          int W, int w) {
  int64_t o = (row_base + row0 + threadIdx.y) * (int64_t)W + w;
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    pv[q] = (w < W && row0 + (int)threadIdx.y + q * TY < R)
                ? (uint32_t)prev[o] : 0u;
    o += (int64_t)TY * W;
  }
}

// What the masked store writes beside new: nothing (the words kernel),
// chg = new ^ prev (out1), or enter = new & ~prev (out1) and leave =
// prev & ~new (out2), all from the prev words already in registers.
enum class Emit { kWords, kChg, kEntlv };

// Write new and the words of mode E for the thread's rows below R,
// coalesced along w.  Every word is written, zero where nothing was tested.
template <Emit E, class Self>
__device__ __forceinline__ void store_rows(const Cols& c, const Rows& rw,
                                           const uint32_t* acc,
                                           const uint32_t* pv, Self self,
                                           int64_t row_base, int row0, int R,
                                           int W, int w,
                                           int32_t* __restrict__ new_out,
                                           int32_t* __restrict__ out1,
                                           int32_t* __restrict__ out2) {
  if (w >= W) return;
  const uint32_t am = c.actw[threadIdx.x];
  const int64_t row = row_base + row0 + threadIdx.y;
  int64_t o = row * (int64_t)W + w;
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    // rows rise with q: once one is past R, so are the rest
    if (row0 + (int)threadIdx.y + q * TY < R) {
      const uint32_t keep = self.keep(row + q * TY, w, W);
      const uint32_t v = ((rw.act >> q) & 1u) ? (acc[q] & am & keep) : 0u;
      new_out[o] = (int32_t)v;
      if constexpr (E == Emit::kChg) out1[o] = (int32_t)(v ^ pv[q]);
      if constexpr (E == Emit::kEntlv) {
        out1[o] = (int32_t)(v & ~pv[q]);
        out2[o] = (int32_t)(pv[q] & ~v);
      }
    }
    o += (int64_t)TY * W;
  }
}

}  // namespace aoi_tile
