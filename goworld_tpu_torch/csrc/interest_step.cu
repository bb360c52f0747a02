// Interest-policy stack step for Hopper (sm_90a): radius AND team mask AND
// tier hysteresis AND line of sight, packed to planar words, both planes in
// one launch per stack step per space.
//
// Replaces: goworld_tpu/interest/device.py _get_step/eval_step, the jitted
// XLA program over goworld_tpu/ops/interest_kernels.step_masks (not a
// Pallas kernel).  Plain version it is held to bit for bit:
// goworld_tpu_torch/ops/interest_kernels.step_words with xp=torch.
//
// What it computes, for every observer row i < C and word w < W = C / 32,
// bit b <-> column j = b*W + w (float32, IEEE, in this order):
//   gate  = act_i && act_j && i != j  [&& (vis_i & team_j) != 0]
//   dx    = |x_j - x_i|, dz = |z_j - z_i|
//   base  = gate && dx <= r_i && dz <= r_i
//   near  = gate && (max(dx,dz) <= rn || (prev_near && max(dx,dz) <= rf))
//           with rn = r_i * near_frac, rf = rn * hysteresis   [tier only]
//   full step:  final = base && (near || clear)  (tier + LOS)
//                       base && clear  (LOS)  |  base  (no LOS)
//   off step:   final = near ? base : prev_final (tier only; no sample)
// where clear = no dyadic midpoint of segment i->j lands in a grid cell
// <= 0: a point is a chain of (a + b) * 0.5, its cell
// clip(floor((p - origin) * inv_cell), 0, n - 1), NaN to cell 0 (the JAX
// jitted step's answer; fmaxf drops the NaN).  max(dx,dz) <= t is written
// dx <= t && dz <= t: fmaxf would drop a NaN the reference keeps.  Every
// add, sub and mul is an __f*_rn intrinsic, which nvcc never contracts
// into an FMA (the build keeps its default -fmad=true and never uses fast
// math: flush-to-zero would change subnormal pairs).
//
// What bounds it: at C = 16384 the four word planes (prev_final and
// prev_near in, final and near out) move C*C/2 bytes, 128 MiB: 0.04 ms at
// 3.35 TB/s.  The C*C = 268M pair tests cost about 20 instructions each
// without a sample, so instruction issue bounds it (chip_smoke.py reads
// the SASS per pair); a LOS sample costs about 15 more and runs only for a
// pair whose base bit is set and whose near bit is not (final is decided
// otherwise), a small fraction of the pairs at a game's densities.
//
// The design (first version; simple and right before fast):
//   * a block of 32 x 8 threads owns one 32-word group and 64 rows; lane x
//     owns word w = group*32 + x, so a warp's loads and stores are
//     coalesced along w;
//   * the group's 1024 columns (x, z, act, team of j = b*W + w) are staged
//     in shared memory once and serve all 64 rows; a row's scalars are one
//     broadcast load per warp;
//   * the 32-bit loop is unrolled with the policy mix and the cadence as
//     template parameters, so a bit is an immediate and dead policies cost
//     nothing; the LOS depth (1-4) is a template parameter of the sampler,
//     so its points stay in registers;
//   * the distance field is staged in shared memory when it fits (at most
//     8192 cells; the bench field is 40 x 40), else read through the
//     read-only cache.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 32;        // words per block (lanes)
constexpr int TY = 8;         // row lanes per block
constexpr int RPB = 64;       // rows per block
constexpr int COLS = TW * 32; // staged columns per block
constexpr int GRID_SMEM_CELLS = 8192;

enum Flags { TEAM = 1, TIER = 2, LOS = 4, FULL = 8 };

struct Field {
  const float* g;  // grid (shared or global)
  int nx, nz;
  float ox, oz, inv, xmax, zmax;
};

__device__ __forceinline__ int cell(float p, float o, float inv, float top) {
  float f = floorf(__fmul_rn(__fsub_rn(p, o), inv));
  // fmaxf returns the other operand for a NaN: NaN -> 0, -inf -> 0
  return static_cast<int>(fminf(fmaxf(f, 0.0f), top));
}

__device__ __forceinline__ bool blocked(float px, float pz, const Field& f) {
  int ix = cell(px, f.ox, f.inv, f.xmax);
  int iz = cell(pz, f.oz, f.inv, f.zmax);
  return f.g[iz * f.nx + ix] <= 0.0f;
}

template <int DEPTH>
__device__ __forceinline__ bool clear_at(float ax, float az, float bx,
                                         float bz, const Field& f) {
  constexpr int N = 1 << DEPTH;
  float px[N + 1], pz[N + 1];
  px[0] = ax; pz[0] = az; px[N] = bx; pz[N] = bz;
  bool hit = false;
#pragma unroll
  for (int s = N >> 1; s >= 1; s >>= 1) {
#pragma unroll
    for (int k = s; k < N; k += 2 * s) {
      px[k] = __fmul_rn(__fadd_rn(px[k - s], px[k + s]), 0.5f);
      pz[k] = __fmul_rn(__fadd_rn(pz[k - s], pz[k + s]), 0.5f);
      hit = hit || blocked(px[k], pz[k], f);
    }
  }
  return !hit;
}

__device__ __noinline__ bool los_clear(float ax, float az, float bx,
                                       float bz, int depth, Field f) {
  switch (depth) {
    case 1: return clear_at<1>(ax, az, bx, bz, f);
    case 2: return clear_at<2>(ax, az, bx, bz, f);
    case 3: return clear_at<3>(ax, az, bx, bz, f);
    default: return clear_at<4>(ax, az, bx, bz, f);
  }
}

template <bool HAS_TEAM, bool HAS_TIER, bool HAS_LOS, bool IS_FULL>
__global__ void __launch_bounds__(TW * TY)
interest_step_kernel(const float* __restrict__ x, const float* __restrict__ z,
                     const float* __restrict__ r,
                     const uint8_t* __restrict__ act,
                     const int32_t* __restrict__ team,
                     const int32_t* __restrict__ vis,
                     const int32_t* __restrict__ prev_final,
                     const int32_t* __restrict__ prev_near,
                     const float* __restrict__ grid,
                     int32_t* __restrict__ final_out,
                     int32_t* __restrict__ near_out, int64_t c,
                     float near_frac, float hysteresis, Field field,
                     int depth, int stage_grid) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sz = sx + COLS;
  int32_t* steam = reinterpret_cast<int32_t*>(sz + COLS);
  float* sgrid = reinterpret_cast<float*>(steam + COLS);
  uint8_t* sact = reinterpret_cast<uint8_t*>(
      sgrid + (stage_grid ? field.nx * field.nz : 0));
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TW + tx;
  const int64_t W = c / 32;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * TW;
  for (int e = tid; e < COLS; e += TW * TY) {
    const int b = e / TW, t = e % TW;
    const int64_t ww = w0 + t;
    if (ww < W) {
      const int64_t j = b * W + ww;
      sx[e] = x[j];
      sz[e] = z[j];
      sact[e] = act[j];
      if (HAS_TEAM) steam[e] = team[j];
    }
  }
  if (HAS_LOS && IS_FULL) {
    if (stage_grid) {
      const int n = field.nx * field.nz;
      for (int e = tid; e < n; e += TW * TY) sgrid[e] = grid[e];
      field.g = sgrid;
    } else {
      field.g = grid;
    }
  }
  __syncthreads();
  const int64_t w = w0 + tx;
  if (w >= W) return;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * RPB;
  const int64_t row1 = row0 + RPB < c ? row0 + RPB : c;
#pragma unroll 1
  for (int64_t i = row0 + ty; i < row1; i += TY) {
    const float xi = x[i], zi = z[i], ri = r[i];
    const bool ai = act[i] != 0;
    const int32_t vi = HAS_TEAM ? vis[i] : 0;
    const float rn = __fmul_rn(ri, near_frac);
    const float rf = __fmul_rn(rn, hysteresis);
    const int64_t at = i * W + w;
    const uint32_t pn = HAS_TIER ? static_cast<uint32_t>(prev_near[at]) : 0u;
    const uint32_t pf =
        IS_FULL ? 0u : static_cast<uint32_t>(prev_final[at]);
    // the row's own column, if it lies in this lane's word
    const int self_b = (i % W == w) ? static_cast<int>(i / W) : -1;
    uint32_t fo = 0u, no = 0u;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const int e = b * TW + tx;
      const float dx = fabsf(__fsub_rn(sx[e], xi));
      const float dz = fabsf(__fsub_rn(sz[e], zi));
      bool gate = ai && sact[e] != 0 && b != self_b;
      if (HAS_TEAM) gate = gate && (vi & steam[e]) != 0;
      const bool base = gate && dx <= ri && dz <= ri;
      bool near = false;
      if (HAS_TIER) {
        near = gate && ((dx <= rn && dz <= rn) ||
                        (((pn >> b) & 1u) && dx <= rf && dz <= rf));
      }
      bool fin;
      if (IS_FULL) {
        if (HAS_LOS) {
          fin = base && (near || los_clear(xi, zi, sx[e], sz[e], depth,
                                           field));
        } else {
          fin = base;
        }
      } else {
        fin = near ? base : (((pf >> b) & 1u) != 0u);
      }
      fo |= static_cast<uint32_t>(fin) << b;
      no |= static_cast<uint32_t>(near) << b;
    }
    final_out[at] = static_cast<int32_t>(fo);
    near_out[at] = static_cast<int32_t>(no);
  }
}

template <bool A, bool B, bool C, bool D>
cudaError_t launch(dim3 blocks, size_t smem, cudaStream_t stream,
                   const float* x, const float* z, const float* r,
                   const uint8_t* act, const int32_t* team,
                   const int32_t* vis, const int32_t* pf, const int32_t* pn,
                   const float* g, int32_t* fo, int32_t* no, int64_t c,
                   float near_frac, float hysteresis, Field f, int depth,
                   int stage_grid) {
  // at most 13,312 bytes of columns and 32 KiB of field: under the 48 KiB
  // a block takes without an opt-in
  interest_step_kernel<A, B, C, D><<<blocks, dim3(TW, TY), smem, stream>>>(
      x, z, r, act, team, vis, pf, pn, g, fo, no, c, near_frac, hysteresis,
      f, depth, stage_grid);
  return cudaGetLastError();
}

}  // namespace

// One stack step.  flags: 1 team, 2 tier, 4 LOS, 8 full step.  An off
// step (no 8) needs the tier (2) and samples nothing; the LOS needs a grid
// of nz x nx cells.  Returns the launch's CUDA error (0 on success).
extern "C" int gw_interest_step(
    const float* x, const float* z, const float* r, const uint8_t* act,
    const int32_t* team, const int32_t* vis, const int32_t* prev_final,
    const int32_t* prev_near, const float* grid, int32_t* final_out,
    int32_t* near_out, int64_t c, int flags, float near_frac,
    float hysteresis, float origin_x, float origin_z, float inv_cell,
    int nz, int nx, int depth, void* stream) {
  if (c <= 0 || c % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool team_on = flags & TEAM, tier = flags & TIER,
             los = flags & LOS, full = flags & FULL;
  if ((!full && !tier) || (los && (grid == nullptr || nz < 1 || nx < 1 ||
                                   depth < 1 || depth > 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t W = c / 32;
  dim3 blocks(static_cast<unsigned>((W + TW - 1) / TW),
              static_cast<unsigned>((c + RPB - 1) / RPB));
  if (blocks.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  const bool sampling = los && full;
  const int stage_grid =
      sampling && static_cast<int64_t>(nz) * nx <= GRID_SMEM_CELLS;
  size_t smem = COLS * (sizeof(float) * 2 + sizeof(int32_t) + 1) +
                (stage_grid ? sizeof(float) * nz * nx : 0);
  Field f{grid, nx, nz, origin_x, origin_z, inv_cell,
          static_cast<float>(nx - 1), static_cast<float>(nz - 1)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GW_ARGS blocks, smem, s, x, z, r, act, team, vis, prev_final, prev_near, \
    grid, final_out, near_out, c, near_frac, hysteresis, f, depth,        \
    stage_grid
  cudaError_t e;
  if (!full) {
    e = team_on ? launch<true, true, false, false>(GW_ARGS)
                : launch<false, true, false, false>(GW_ARGS);
  } else if (team_on) {
    e = tier ? (los ? launch<true, true, true, true>(GW_ARGS)
                    : launch<true, true, false, true>(GW_ARGS))
             : (los ? launch<true, false, true, true>(GW_ARGS)
                    : launch<true, false, false, true>(GW_ARGS));
  } else {
    e = tier ? (los ? launch<false, true, true, true>(GW_ARGS)
                    : launch<false, true, false, true>(GW_ARGS))
             : (los ? launch<false, false, true, true>(GW_ARGS)
                    : launch<false, false, false, true>(GW_ARGS));
  }
#undef GW_ARGS
  return static_cast<int>(e);
}
