// AOI neighbor step for Hopper (sm_90a): predicate -> planar bit pack ->
// diff against the previous tick, one launch for every space of a bucket.
//
// Replaces: goworld_tpu/ops/aoi_pallas.py aoi_step_pallas (square mode,
// emit="chg"; Pallas bodies _aoi_kernel / _aoi_kernel_slicepack /
// _aoi_kernel_planewise).  Plain version it is held to bit for bit:
// goworld_tpu_torch/ops/aoi_dense.py aoi_step_chg_dense.
//
// What it computes, for every space s, observer row i and word w:
//   new[s, i, w] bit k  <=>  j = k*W + w satisfies
//       |x_j - x_i| <= r_i  &&  |z_j - z_i| <= r_i  &&  act_i && act_j && i != j
//   chg[s, i, w] = new[s, i, w] ^ prev[s, i, w]
// in IEEE float32 (sub -> abs -> compare).  Built without fast math: its
// flush-to-zero would make |subnormal| <= 0 true where IEEE says false.
//
// What bounds it: at the main path's shape (S = 8, C = 16384, W = 512) it
// moves 805 MB (prev in, new and chg out: 0.24 ms at 3.35 TB/s) and makes
// 2.1 G pair tests (two subtracts, two abs, two compares each: 0.19 ms at
// the 67 TFLOP/s f32 peak).  By those peaks bytes bound it; but none of
// the pair test's operations is an FMA (the peak counts an FMA as two)
// and each pair also costs a predicated integer OR, so in practice the
// issue rate of the pair tests is the limit (about 0.5 ms).
//
// What the design does about that:
//   * a thread owns one word column w and RPT observer rows, so each
//     candidate (x_j, z_j) read from shared memory serves RPT rows from
//     registers, and the 32-plane loop is unrolled so every shift is an
//     immediate;
//   * the block stages its 32 planes x TW columns of x and z in shared
//     memory once (8 KB) and folds act_j into one mask word per column,
//     so activity and self-exclusion cost one AND per word, not per pair
//     (they are masks, exactly as in the plain version -- no +inf/-1
//     folding, which diverges from it when a radius is +inf);
//   * prev reads and new/chg writes are coalesced along w (a warp covers
//     32 consecutive words of one row); offsets are 64-bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;   // words per block (threadIdx.x)
constexpr int TY = 8;    // row groups per block (threadIdx.y)
constexpr int RPT = 8;   // observer rows per thread
constexpr int TR = TY * RPT;  // observer rows per block
constexpr int PLANES = 32;

__global__ void __launch_bounds__(TW * TY)
aoi_step_chg_kernel(const float* __restrict__ x, const float* __restrict__ z,
                    const float* __restrict__ r,
                    const uint8_t* __restrict__ act,
                    const int32_t* __restrict__ prev,
                    int32_t* __restrict__ new_out,
                    int32_t* __restrict__ chg_out, int C, int W) {
  __shared__ float xs[PLANES][TW];
  __shared__ float zs[PLANES][TW];
  __shared__ uint32_t actw[TW];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int w0 = blockIdx.x * TW;
  const int row0 = blockIdx.y * TR;
  const int64_t s = blockIdx.z;
  const int64_t in_base = s * C;
  const int w = w0 + tx;

  // stage the tile's candidate columns j = k*W + w, k = 0..31
  for (int k = ty; k < PLANES; k += TY) {
    float xv = 0.f, zv = 0.f;
    if (w < W) {
      const int64_t j = in_base + (int64_t)k * W + w;
      xv = x[j];
      zv = z[j];
    }
    xs[k][tx] = xv;
    zs[k][tx] = zv;
  }
  if (ty == 0) {
    uint32_t m = 0;
    if (w < W) {
      for (int k = 0; k < PLANES; ++k)
        m |= (act[in_base + (int64_t)k * W + w] ? 1u : 0u) << k;
    }
    actw[tx] = m;
  }
  __syncthreads();

  float xi[RPT], zi[RPT], ri[RPT];
  uint32_t acc[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int i = row0 + ty + q * TY;
    const bool ok = i < C;
    xi[q] = ok ? x[in_base + i] : 0.f;
    zi[q] = ok ? z[in_base + i] : 0.f;
    // a row past C never stores; NaN keeps its tests false
    ri[q] = ok ? r[in_base + i] : __int_as_float(0x7fc00000);
    acc[q] = 0u;
  }

#pragma unroll
  for (int k = 0; k < PLANES; ++k) {
    const float xj = xs[k][tx];
    const float zj = zs[k][tx];
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const bool hit = (fabsf(xj - xi[q]) <= ri[q]) &&
                       (fabsf(zj - zi[q]) <= ri[q]);
      acc[q] |= (hit ? 1u : 0u) << k;
    }
  }

  if (w >= W) return;
  const uint32_t am = actw[tx];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int i = row0 + ty + q * TY;
    if (i >= C) continue;
    uint32_t v = act[in_base + i] ? (acc[q] & am) : 0u;
    if (w == i % W) v &= ~(1u << (i / W));  // self: j == i
    const int64_t o = (in_base + i) * (int64_t)W + w;
    const uint32_t p = (uint32_t)prev[o];
    new_out[o] = (int32_t)v;
    chg_out[o] = (int32_t)(v ^ p);
  }
}

}  // namespace

// x, z, r: float32 [S, C]; act: uint8 (torch.bool) [S, C];
// prev, new_out, chg_out: int32 [S, C, W], all contiguous on one device.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int gw_aoi_step_chg(const void* x, const void* z, const void* r,
                               const void* act, const void* prev,
                               void* new_out, void* chg_out, int64_t S,
                               int64_t C, int64_t W, void* stream) {
  if (S <= 0 || C <= 0) return 0;
  if (W * 32 != C || S > 65535 || C > (1 << 30))
    return (int)cudaErrorInvalidValue;
  const dim3 block(TW, TY);
  const dim3 grid((unsigned)((W + TW - 1) / TW), (unsigned)((C + TR - 1) / TR),
                  (unsigned)S);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  aoi_step_chg_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)z, (const float*)r, (const uint8_t*)act,
      (const int32_t*)prev, (int32_t*)new_out, (int32_t*)chg_out, (int)C,
      (int)W);
  return (int)cudaGetLastError();
}
