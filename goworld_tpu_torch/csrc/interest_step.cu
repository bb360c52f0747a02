// Interest-policy stack step for Hopper (sm_90a): radius AND team mask AND
// tier hysteresis AND line of sight over device-resident word planes.  One
// launch a stack step a space updates both planes in place and appends
// every word it changed to a changed-word list, one list a plane.
//
// Replaces: goworld_tpu/interest/device.py _get_step/eval_step, the jitted
// XLA program over goworld_tpu/ops/interest_kernels.step_masks (not a
// Pallas kernel), and the host diff of goworld_tpu/interest/policy.py
// (np.nonzero over new ^ prev).  Plain version it is held to bit for bit:
// goworld_tpu_torch/ops/interest_cuda.interest_step_plain
// (interest_kernels.step_words with xp=torch, then torch.nonzero of the
// change and an in-place copy).
//
// What it computes, for every observer row i < C and word w < W = C / 32,
// bit b <-> column j = b*W + w (float32, IEEE, in this order):
//   gate  = act_i && act_j && i != j  [&& (vis_i & team_j) != 0]
//   d     = max(|x_j - x_i|, |z_j - z_i|), NaN if either is NaN
//   base  = gate && d <= r_i
//   near  = gate && (d <= rn || (prev_near && d <= rf))
//           with rn = r_i * near_frac, rf = rn * hysteresis   [tier only]
//   full step:  final = base && (near || clear)  (tier + LOS)
//                       base && clear  (LOS)  |  base  (no LOS)
//   off step:   final = near ? base : prev_final (tier only; no sample)
// where clear = no dyadic midpoint of segment i->j lands in a grid cell
// <= 0: a point is a chain of (a + b) * 0.5, its cell
// clip(floor((p - origin) * inv_cell), 0, n - 1), NaN to cell 0 (the JAX
// jitted step's answer; fmaxf drops the NaN).  d <= t is the reference's
// dx <= t && dz <= t: max.NaN keeps a NaN that fmaxf would drop.  Every
// add, sub and mul is round-to-nearest (__f*_rn, or .rn in the PTX), which
// nvcc never contracts into an FMA; the build never uses fast math
// (flush-to-zero would change subnormal pairs).  Then for each plane:
//   chg = new ^ prev; if chg != 0: the word is stored in place and
//   (flat index i*W + w, new word) appended to the plane's list.
// counts[0] / counts[1] end as the number of changed words of final /
// near; entries past `cap` are dropped (the host then fetches the whole
// plane: a counted overflow).
//
// What bounds it: at C = 16384 the two planes it must read to find the
// change are C*C/4 bytes, 64 MiB: 0.02 ms at 3.35 TB/s; a steady step
// writes only its few thousand changed words.  The gated pairs' f32
// compares take less than that at phase 18b's occupancy.  Instruction
// issue is what a pair costs (chip_smoke.py reads the SASS a pair).
//
// The design:
//   * a block of 32 x 4 threads owns one 32-word group and 128 rows; lane
//     x owns word w = group*32 + x, so a warp's plane loads and stores are
//     coalesced along w, and the 4 warps walk the rows in turn;
//   * the group's 1024 columns are staged in shared memory once, then each
//     lane holds its 32 columns' x and z in registers across all rows: a
//     pair test reads no memory;
//   * activity, self and team are word masks built once per (row, word),
//     and a row whose gate word is 0 in every lane skips its 32 pair
//     tests;
//   * a pair is two subtracts and a NaN-keeping max in PTX, then one
//     compare and one predicated OR a threshold (radius; the tier's two);
//     the hysteresis and the cadence are word operations;
//   * the LOS sampler stays out of line and runs only for the set bits of
//     base & ~near (a full step), reading the column from shared memory;
//     the distance field sits in shared memory when it fits;
//   * the epilogue stores only changed words and appends them with one
//     warp ballot and one atomic a warp and plane.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 32;   // words per block (lanes)
constexpr int TY = 4;    // warps per block
constexpr int RB = 128;  // rows per block
constexpr int GRID_SMEM_CELLS = 4096;
constexpr unsigned FULLMASK = 0xffffffffu;

enum Flags { TEAM = 1, TIER = 2, LOS = 4, FULL = 8 };

struct Field {
  const float* g;  // grid (shared or global)
  int nx, nz;
  float ox, oz, inv, xmax, zmax;
};

struct Step {
  const float* x;
  const float* z;
  const float* r;
  const uint8_t* act;
  const int32_t* team;
  const int32_t* vis;
  int32_t* fin;   // [C, W], updated in place
  int32_t* near;  // [C, W], updated in place
  int2* fin_list;   // [cap] (flat index, new word)
  int2* near_list;  // [cap]
  int32_t* counts;  // [2], zero at launch
  int cap;
  int c, W;
  float near_frac, hysteresis;
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

// The pair's Chebyshev distance max(|xj - xi|, |zj - zi|), NaN when either
// difference is NaN (max.NaN; fmaxf would return the other operand), each
// subtract round-to-nearest, no flush-to-zero.
__device__ __forceinline__ float cheb(float xj, float zj, float xi,
                                      float zi) {
  float d;
  asm("{\n\t.reg .f32 a, b;\n\t"
      "sub.rn.f32 a, %1, %3;\n\t"
      "sub.rn.f32 b, %2, %4;\n\t"
      "abs.f32 a, a;\n\t"
      "abs.f32 b, b;\n\t"
      "max.NaN.f32 %0, a, b;\n\t}"
      : "=f"(d)
      : "f"(xj), "f"(zj), "f"(xi), "f"(zi));
  return d;
}

// acc |= bit where d <= t (false for a NaN): one FSETP and one predicated
// LOP3 (a C++ && chain compiles to selects: see aoi_tile.cuh pair_test).
__device__ __forceinline__ void set_le(uint32_t& acc, float d, float t,
                                       uint32_t bit) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.le.f32 p, %1, %2;\n\t"
      "@p or.b32 %0, %0, %3;\n\t}"
      : "+r"(acc)
      : "f"(d), "f"(t), "r"(bit));
}

// Append (at, v) to `list` where `on`, one atomic a warp.  Every lane of
// the warp calls it.
__device__ __forceinline__ void append(int2* list, int32_t* count, bool on,
                                       int at, uint32_t v, int cap) {
  const uint32_t m = __ballot_sync(FULLMASK, on);
  if (m == 0u) return;
  const int lane = threadIdx.x;
  const int leader = __ffs(m) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(m));
  base = __shfl_sync(FULLMASK, base, leader);
  const int pos = base + __popc(m & ((1u << lane) - 1u));
  if (on && pos < cap) list[pos] = make_int2(at, static_cast<int>(v));
}

template <bool HAS_TEAM, bool HAS_TIER, bool HAS_LOS, bool IS_FULL>
__global__ void __launch_bounds__(TW * TY, 4)
interest_step_kernel(Step a, Field field, int depth, int stage_grid) {
  __shared__ float sx[32][TW], sz[32][TW];
  __shared__ uint32_t steam[HAS_TEAM ? 32 : 1][TW];
  __shared__ uint32_t sact[32];  // bit t: column (k, group*32 + t) active
  __shared__ float rx[RB], rz[RB], rr[RB];
  __shared__ uint32_t rv[RB];
  __shared__ int rs[RB];  // the row's own column as w * 32 + b
  __shared__ uint8_t ra[RB];
  extern __shared__ float sgrid[];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TW + tx;
  const int W = a.W;
  const int w = static_cast<int>(blockIdx.x) * TW + tx;
  const int row0 = static_cast<int>(blockIdx.y) * RB;
  for (int k = ty; k < 32; k += TY) {
    float xv = 0.0f, zv = 0.0f;
    uint32_t tv = 0u;
    bool on = false;
    if (w < W) {
      const int j = k * W + w;
      xv = a.x[j];
      zv = a.z[j];
      on = a.act[j] != 0;
      if (HAS_TEAM) tv = static_cast<uint32_t>(a.team[j]);
    }
    sx[k][tx] = xv;
    sz[k][tx] = zv;
    if constexpr (HAS_TEAM) steam[k][tx] = tv;
    const uint32_t m = __ballot_sync(FULLMASK, on);
    if (tx == 0) sact[k] = m;
  }
  for (int e = tid; e < RB; e += TW * TY) {
    const int i = row0 + e;
    const bool in = i < a.c;
    rx[e] = in ? a.x[i] : 0.0f;
    rz[e] = in ? a.z[i] : 0.0f;
    rr[e] = in ? a.r[i] : 0.0f;
    rv[e] = (HAS_TEAM && in) ? static_cast<uint32_t>(a.vis[i]) : 0u;
    ra[e] = in ? a.act[i] : 0;
    rs[e] = in ? (i % W) * 32 + i / W : -1;
  }
  if (HAS_LOS && IS_FULL) {
    if (stage_grid) {
      const int n = field.nx * field.nz;
      for (int e = tid; e < n; e += TW * TY) sgrid[e] = field.g[e];
      field.g = sgrid;
    }
  }
  __syncthreads();
  // the lane's 32 columns, and its word masks
  float xj[32], zj[32];
  uint32_t am = 0u;
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    xj[b] = sx[b][tx];
    zj[b] = sz[b][tx];
    am |= ((sact[b] >> tx) & 1u) << b;
  }
  const int nrows = min(RB, a.c - row0);
  const bool lane_in = w < W;
#pragma unroll 1
  for (int q = ty; q < nrows; q += TY) {
    const int at = (row0 + q) * W + w;
    const uint32_t pf = lane_in ? static_cast<uint32_t>(a.fin[at]) : 0u;
    const uint32_t pn = lane_in ? static_cast<uint32_t>(a.near[at]) : 0u;
    uint32_t fo = IS_FULL ? 0u : pf, no = 0u;
    if (ra[q]) {  // warp-uniform from here to the epilogue
      uint32_t gate = am;
      const int self = rs[q];
      if (w == (self >> 5)) gate &= ~(1u << (self & 31));
      if constexpr (HAS_TEAM) {
        const uint32_t v = rv[q];
        uint32_t m = 0u;
#pragma unroll
        for (int b = 0; b < 32; ++b)
          m |= ((steam[b][tx] & v) != 0u ? 1u : 0u) << b;
        gate &= m;
      }
      if (__any_sync(FULLMASK, gate != 0u)) {
        const float xi = rx[q], zi = rz[q], ri = rr[q];
        uint32_t base = 0u, na = 0u, nb = 0u;
        if (HAS_TIER) {
          const float rn = __fmul_rn(ri, a.near_frac);
          const float rf = __fmul_rn(rn, a.hysteresis);
#pragma unroll
          for (int b = 0; b < 32; ++b) {
            const float d = cheb(xj[b], zj[b], xi, zi);
            set_le(base, d, ri, 1u << b);
            set_le(na, d, rn, 1u << b);
            set_le(nb, d, rf, 1u << b);
          }
          no = gate & (na | (pn & nb));
        } else {
#pragma unroll
          for (int b = 0; b < 32; ++b)
            set_le(base, cheb(xj[b], zj[b], xi, zi), ri, 1u << b);
        }
        base &= gate;
        if (IS_FULL) {
          if (HAS_LOS) {
            for (uint32_t cand = HAS_TIER ? base & ~no : base; cand;
                 cand &= cand - 1u) {
              const int b = __ffs(cand) - 1;
              if (!los_clear(xi, zi, sx[b][tx], sz[b][tx], depth, field))
                base &= ~(1u << b);
            }
          }
          fo = base;
        } else {
          fo = (no & base) | (~no & pf);
        }
      }
    }
    const uint32_t cf = fo ^ pf, cn = no ^ pn;
    if (cf) a.fin[at] = static_cast<int32_t>(fo);
    if (cn) a.near[at] = static_cast<int32_t>(no);
    append(a.fin_list, a.counts, cf != 0u, at, fo, a.cap);
    append(a.near_list, a.counts + 1, cn != 0u, at, no, a.cap);
  }
}

template <bool A, bool B, bool C, bool D>
cudaError_t launch(dim3 blocks, size_t smem, cudaStream_t stream,
                   const Step& s, const Field& f, int depth, int stage_grid) {
  // about 15 KB of static shared memory and at most 16 KB of field: under
  // the 48 KB a block takes without an opt-in
  interest_step_kernel<A, B, C, D><<<blocks, dim3(TW, TY), smem, stream>>>(
      s, f, depth, stage_grid);
  return cudaGetLastError();
}

}  // namespace

// One stack step over the planes `fin` and `near_w` ([c, c/32] int32, in
// place).  flags: 1 team, 2 tier, 4 LOS, 8 full step.  An off step (no 8)
// needs the tier (2) and samples nothing; the LOS needs a grid of nz x nx
// cells.  The changed words of each plane go to fin_list / near_list
// ([cap] pairs of int32) and their numbers to counts[0..1], which this
// zeroes first.  Returns the first CUDA error (0 on success).
extern "C" int gw_interest_step(
    const float* x, const float* z, const float* r, const uint8_t* act,
    const int32_t* team, const int32_t* vis, int32_t* fin, int32_t* near_w,
    const float* grid, int32_t* fin_list, int32_t* near_list,
    int32_t* counts, int64_t cap, int64_t c, int flags, float near_frac,
    float hysteresis, float origin_x, float origin_z, float inv_cell,
    int nz, int nx, int depth, void* stream) {
  if (c <= 0 || c % 32 != 0 || c * (c / 32) > INT32_MAX || cap < 0 ||
      cap > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool team_on = flags & TEAM, tier = flags & TIER,
             los = flags & LOS, full = flags & FULL;
  if ((!full && !tier) || (los && (grid == nullptr || nz < 1 || nx < 1 ||
                                   depth < 1 || depth > 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int W = static_cast<int>(c / 32);
  dim3 blocks(static_cast<unsigned>((W + TW - 1) / TW),
              static_cast<unsigned>((c + RB - 1) / RB));
  if (blocks.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(counts, 0, 2 * sizeof(int32_t), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool sampling = los && full;
  const int stage_grid =
      sampling && static_cast<int64_t>(nz) * nx <= GRID_SMEM_CELLS;
  const size_t smem = stage_grid ? sizeof(float) * nz * nx : 0;
  Field f{grid, nx, nz, origin_x, origin_z, inv_cell,
          static_cast<float>(nx - 1), static_cast<float>(nz - 1)};
  Step st{x, z, r, act, team, vis, fin, near_w,
          reinterpret_cast<int2*>(fin_list),
          reinterpret_cast<int2*>(near_list), counts,
          static_cast<int>(cap), static_cast<int>(c), W, near_frac,
          hysteresis};
#define GW_ARGS blocks, smem, s, st, f, depth, stage_grid
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
