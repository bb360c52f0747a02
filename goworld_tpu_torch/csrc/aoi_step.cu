// AOI neighbor step for Hopper (sm_90a): predicate -> planar bit pack ->
// diff against the previous tick, one launch for every space of a bucket.
//
// Replaces: goworld_tpu/ops/aoi_pallas.py aoi_step_pallas in both output
// modes, square and rectangular (Pallas bodies _aoi_kernel /
// _aoi_kernel_slicepack / _aoi_kernel_planewise, chosen there by W; one
// design here for every W).  Plain versions it is held to bit for bit:
// goworld_tpu_torch/ops/aoi_dense.py aoi_step_chg_dense (emit="chg") and
// aoi_step_entlv_dense (emit="entlv", the Pallas default).
//
// What it computes, for every space s, observer row i < R and word w:
//   new[s, i, w] bit k  <=>  j = k*W + w satisfies
//       |xc_j - x_i| <= r_i  &&  |zc_j - z_i| <= r_i  &&  act_i && actc_j
//       && g_i != j
//   chg   = new ^ prev                      (emit="chg")
//   and, given the per-space row masks stg and sub (chg mode, the fused
//   tick's): new = prev and chg = 0 where stg[s] = 0, chg = 0 where
//   sub[s] = 0
//   enter = new & ~prev, leave = prev & ~new (emit="entlv")
// in IEEE float32 (sub -> abs -> compare), with W = C / 32.  Square mode
// is the call with the candidates equal to the rows (xc = x, R = C) and
// g_i = i; rectangular mode evaluates a block of R observers against all
// C candidates and g_i = row_ids[s, i] is the observer's global column
// (an id outside [0, C) excludes nothing).  Built without fast math: its
// flush-to-zero would make |subnormal| <= 0 true where IEEE says false.
//
// What bounds it: at the engine path's shape (S = 8, C = 16384, W = 512)
// the chg mode moves 805 MB (prev in, new and chg out: 0.24 ms at 3.35
// TB/s) and makes 2.1 G pair tests; the rectangular zipfshare block
// (R = 16384, C = 131072, W = 4096) has the same byte and pair counts.
// The entlv mode writes one word array more: 1.07 GB (0.32 ms) at
// 8 x 16384 and 8.59 GB (2.56 ms) at the `million` shape 64 x 16384
// (17.2 G pair tests).  Beside the bytes, the pair tests bound it by
// instruction issue: each pair compiles to two FADD, two FSETP (|.| an
// operand modifier, the second ANDing into the first's predicate) and one
// predicated add that sets the bit (pair_test in aoi_tile.cuh), and the
// two x/z reads from shared memory serve RPT = 8 pairs: 5.25 instructions
// a pair, 0.34 ms at 8 x 16384 and 2.70 ms at 64 x 16384 for 132 SMs
// issuing 128 lanes a clock at 1.98 GHz.  The first design (one short
// block per 64 x 32 tile) issued about 15.7 SASS instructions a pair (its
// kernel, 4024 instructions, runs 256 pairs a thread once): its C++ pair
// test compiled to a select chain whose predicates spilled into register
// bits; without its pair loop it ran in 0.29 of its 1.23 ms at 8 x 16384,
// and moving its prev load ahead of the loop saved nothing, so issue,
// not latency, held it.  Tensor cores do not apply: the
// predicate compares exact float32 differences and has no product, and
// wgmma cannot reproduce it bit for bit.
//
// What the design does about that:
//   * the pair test in PTX, five instructions;
//   * persistent blocks: the grid is what fits on the card at once
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count, read
//     by gw_aoi_step_occupancy; ops/aoi_cuda.py step_plan chooses the
//     grid and the row tiles per unit, so that the units number at least
//     ~8x the grid), and each block walks work units of aoi_tile.cuh:
//     (space, 32-word group, a run of row tiles);
//   * a unit's 32 candidate planes (x, z and one activity word per
//     column) are staged in shared memory once and serve all its tiles;
//   * the next tile's observer rows (one register per lane, spread by
//     warp shuffles) and its prev words (cp.async into a three-slot ring
//     in shared memory, 16 bytes a thread where rows are 16-byte aligned,
//     4 a word otherwise) are in flight while the current tile computes;
//     prev holds no registers through the pair loop, and one barrier a
//     tile makes the ring readable;
//   * a thread owns one word column w and RPT consecutive rows, so each
//     (x_j, z_j) read from shared memory serves RPT rows from registers,
//     and the 32-plane loop is unrolled so every bit is an immediate;
//   * activity and self-exclusion are masks applied once per word (no
//     +inf/-1 folding, which diverges from the plain version when a
//     radius is +inf); a row's own column (w, k) is computed by one lane
//     per row, dividing by W with a multiply (Plan's magic numbers), and
//     shuffled to the store;
//   * ragged row counts (R not a multiple of 64) and word counts (W not a
//     multiple of 32) are masks, not padding;
//   * the output writes are coalesced along w (a warp covers 32
//     consecutive words of one row), 4 bytes a thread; offsets are
//     64-bit;
//   * the output mode is a template parameter of the tile's store;
//   * the fused tick's row masks (stg / sub) select a second chg kernel
//     (template parameter MASKED) that reads them once a work unit and
//     applies them in the store: the unmasked kernels are the code they
//     were.  A branch around the pair loop for an unstaged space (to skip
//     its tests) made every launch slower (0.564 ms at 8 x 16384, where
//     this code runs 0.528-0.535): the compiler stopped scheduling the
//     next tile's fetches into the loop.
// Measured by chip_smoke.py (CUDA events) on an H100 80GB HBM3 at 700 W:
// 0.535 ms at 8 x 16384 (chg), 4.09 / 4.21 ms at 64 x 16384 (chg /
// entlv), 0.533 ms for the 16384 x 131072 rect block.  Its cuobjdump
// count of the unrolled pair region, first to last FSETP, is about 6.0
// instructions a pair (chg) and 6.1 (entlv): the compiler schedules the
// next tile's row fetch and copies in between.  The first design with
// only this pair test swapped in ran 1.9-2.2x slower at those shapes:
// the walk, the staging once per unit and the ring earn the rest.  The
// masked kernel: 0.543 ms at 8 x 16384 against the unmasked 0.529 in
// the same run, 4.22 against 4.10 at 64 x 16384 (5.27 SASS a pair).
// Outputs may not alias prev.
#include "aoi_tile.cuh"

namespace {

using namespace aoi_tile;

// MASKED: the chg kernel under the row masks stg / sub (either may be
// null); the unmasked kernels never read them.
template <Emit E, bool MASKED>
__global__ void __launch_bounds__(TW * TY, 3)
aoi_step_kernel(const float* __restrict__ x, const float* __restrict__ z,
                const float* __restrict__ r, const uint8_t* __restrict__ act,
                const float* __restrict__ xc, const float* __restrict__ zc,
                const uint8_t* __restrict__ actc,
                const int32_t* __restrict__ row_ids,
                const int32_t* __restrict__ prev,
                int32_t* __restrict__ new_out, int32_t* __restrict__ out1,
                int32_t* __restrict__ out2, int R, int C, int W,
                const Plan plan, const int32_t* __restrict__ stg,
                const int32_t* __restrict__ sub) {
  __shared__ Cols cols;
  __shared__ __align__(16) PrevSlot ring[SLOTS];

  Cursor cur;
  cur.enter(plan, blockIdx.x);
  if (!cur.ok(plan)) return;  // the whole block
  RowFetch f = fetch_rows(x, z, r, act, row_ids, (int64_t)cur.s * R,
                          cur.t * TR, R);
  const bool vec = rows_aligned16(prev, W);
  copy_prev(ring[0], prev, (int64_t)cur.s * R, cur.t * TR, R, W, cur.g, vec);
  cp_async_commit();
  int staged = -1, slot = 0;
  bool keep = true, emit = true;  // the unit's space's row masks
  for (;;) {
    const int64_t row_base = (int64_t)cur.s * R;
    const int row0 = cur.t * TR;
    const int w = cur.g * TW + threadIdx.x;
    if (cur.u != staged) {  // uniform across the block
      stage_cols(cols, xc, zc, actc, (int64_t)cur.s * C, W, w);
      staged = cur.u;
      if constexpr (MASKED) {  // once a unit, uniform across the block
        keep = !stg || stg[cur.s] != 0;
        emit = !sub || sub[cur.s] != 0;
      }
    }
    Rows rows;
    take_rows(rows, f);
    Cursor nxt = cur;
    nxt.next(plan);
    const bool more = nxt.ok(plan);
    if (more) {  // the next tile's rows and prev, in flight from here
      f = fetch_rows(x, z, r, act, row_ids, (int64_t)nxt.s * R,
                     nxt.t * TR, R);
      copy_prev(ring[(slot + 1) % SLOTS], prev, (int64_t)nxt.s * R,
                nxt.t * TR, R, W, nxt.g, vec);
    }
    cp_async_commit();
    uint32_t acc[RPT];
    test_planes<false>(cols, rows, FULL, acc);
    cp_async_wait_prior();  // this thread's copies of this tile landed
    __syncthreads();        // and every other thread's
    store_rows<E>(cols, rows, acc, ring[slot], plan, C, row_base, row0, R, W,
                  w, new_out, out1, out2, keep, emit);
    if (!more) break;
    cur = nxt;
    slot = (slot + 1) % SLOTS;
  }
}

template <Emit E>
int launch(const void* x, const void* z, const void* r, const void* act,
           const void* xc, const void* zc, const void* actc,
           const void* row_ids, const void* prev, void* new_out, void* out1,
           void* out2, int64_t S, int64_t R, int64_t C, void* stream,
           int64_t grid, int64_t tiles, const void* stg, const void* sub) {
  if (S <= 0 || R <= 0 || C <= 0) return 0;
  Plan plan;
  if (C % 32 != 0 || C > (1 << 30) || R > (1 << 30) ||
      (!row_ids && R != C) || !make_plan(plan, S, R, C / 32, grid, tiles))
    return (int)cudaErrorInvalidValue;
  auto kernel = (stg || sub) ? aoi_step_kernel<E, true>
                             : aoi_step_kernel<E, false>;
  kernel<<<(unsigned)grid, dim3(TW, TY), 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)z, (const float*)r, (const uint8_t*)act,
      (const float*)xc, (const float*)zc, (const uint8_t*)actc,
      (const int32_t*)row_ids, (const int32_t*)prev, (int32_t*)new_out,
      (int32_t*)out1, (int32_t*)out2, (int)R, (int)C, (int)(C / 32), plan,
      (const int32_t*)stg, (const int32_t*)sub);
  return (int)cudaGetLastError();
}

}  // namespace

// The persistent grid's inputs for one kernel (kind 1: entlv; 2: chg
// under row masks; else chg, square and rectangular mode) on the current
// device: its SM count and how many blocks of the kernel fit on one SM.
// Returns a CUDA error code (0 = read).
extern "C" int gw_aoi_step_occupancy(int kind, int* n_sms,
                                     int* blocks_per_sm) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = kind == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        blocks_per_sm, aoi_step_kernel<Emit::kEntlv, false>,
                        TW * TY, 0)
        : kind == 2 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          blocks_per_sm, aoi_step_kernel<Emit::kChg, true>,
                          TW * TY, 0)
                    : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          blocks_per_sm, aoi_step_kernel<Emit::kChg, false>,
                          TW * TY, 0);
  return (int)e;
}

// Rows x, z, r: float32 [S, R]; act: uint8 (torch.bool) [S, R];
// candidates xc, zc: float32 [S, C]; actc: uint8 [S, C]; row_ids: int32
// [S, R] or null (square mode: then the candidates must be the rows and
// R == C); prev and every output: int32 [S, R, C / 32], no output
// aliasing prev; all contiguous on one device.  grid and tiles are the
// plan of ops/aoi_cuda.py step_plan (blocks, row tiles per unit).  Each
// entry launches on `stream` and returns cudaGetLastError() (0 =
// launched).

// emit="chg": new and chg = new ^ prev.  stg and sub: int32 [S] row masks
// or null (all ones): a space with stg 0 keeps prev as new and has chg 0;
// a space with sub 0 has chg 0.  Given either, the masked kernel runs.  The fused
// tick (ops/fused.py) passes its static staged-row and subscription masks.
extern "C" int gw_aoi_step_chg(const void* x, const void* z, const void* r,
                               const void* act, const void* xc,
                               const void* zc, const void* actc,
                               const void* row_ids, const void* prev,
                               void* new_out, void* chg_out, int64_t S,
                               int64_t R, int64_t C, void* stream,
                               int64_t grid, int64_t tiles, const void* stg,
                               const void* sub) {
  return launch<Emit::kChg>(x, z, r, act, xc, zc, actc, row_ids, prev,
                            new_out, chg_out, nullptr, S, R, C, stream, grid,
                            tiles, stg, sub);
}

// emit="entlv": new, enter = new & ~prev and leave = prev & ~new.
extern "C" int gw_aoi_step_entlv(const void* x, const void* z, const void* r,
                                 const void* act, const void* xc,
                                 const void* zc, const void* actc,
                                 const void* row_ids, const void* prev,
                                 void* new_out, void* enter_out,
                                 void* leave_out, int64_t S, int64_t R,
                                 int64_t C, void* stream, int64_t grid,
                                 int64_t tiles) {
  return launch<Emit::kEntlv>(x, z, r, act, xc, zc, actc, row_ids, prev,
                              new_out, enter_out, leave_out, S, R, C, stream,
                              grid, tiles, nullptr, nullptr);
}
