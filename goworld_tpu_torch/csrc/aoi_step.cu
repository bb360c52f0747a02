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
// TB/s) and makes 2.1 G pair tests (two subtracts, two abs, two compares
// each: 0.19 ms at the 67 TFLOP/s f32 peak); the rectangular zipfshare
// block (R = 16384, C = 131072, W = 4096) has the same byte and pair
// counts.  The entlv mode writes one word array more: 4 x S*C*W*4 bytes,
// 1.07 GB (0.32 ms) at 8 x 16384 and 8.59 GB (2.56 ms) at the `million`
// shape 64 x 16384.  By those peaks bytes bound it; but none of the pair
// test's operations is an FMA (the peak counts an FMA as two) and each
// pair also costs a predicated integer OR, so in practice the instruction
// throughput of the pair tests is the limit (about 0.5 ms at 8 x 16384).
//
// What the design does about that: the tile of aoi_tile.cuh (shared with
// the culled kernels of aoi_grid.cu):
//   * a thread owns one word column w and RPT observer rows, so each
//     candidate (x_j, z_j) read from shared memory serves RPT rows from
//     registers, and the 32-plane loop is unrolled so every shift is an
//     immediate;
//   * the block stages its 32 planes x TW columns of x and z in shared
//     memory once (8 KB) and folds act_j into one mask word per column,
//     so activity and self-exclusion cost one AND per word, not per pair
//     (they are masks, exactly as in the plain version -- no +inf/-1
//     folding, which diverges from it when a radius is +inf);
//   * ragged row counts (R not a multiple of the block's rows) and word
//     counts (W not a multiple of TW) are masks, not padding;
//   * prev reads and the output writes are coalesced along w (a warp
//     covers 32 consecutive words of one row); offsets are 64-bit;
//   * the output mode is a template parameter of the tile's store: the
//     entlv words come from the prev already held in registers, and the
//     chg instantiation compiles to the same code as before the mode
//     existed (its register count is checked in the build log).
#include "aoi_tile.cuh"

namespace {

using namespace aoi_tile;

template <Emit E>
__global__ void __launch_bounds__(TW * TY)
aoi_step_kernel(const float* __restrict__ x, const float* __restrict__ z,
                const float* __restrict__ r, const uint8_t* __restrict__ act,
                const float* __restrict__ xc, const float* __restrict__ zc,
                const uint8_t* __restrict__ actc,
                const int32_t* __restrict__ row_ids,
                const int32_t* __restrict__ prev,
                int32_t* __restrict__ new_out, int32_t* __restrict__ out1,
                int32_t* __restrict__ out2, int R, int C, int W) {
  __shared__ Cols cols;
  const int w = blockIdx.x * TW + threadIdx.x;
  const int row0 = blockIdx.y * TR;
  const int64_t s = blockIdx.z;
  const int64_t row_base = s * R;

  stage_cols(cols, xc, zc, actc, s * C, W, w);
  Rows rows;
  load_rows(rows, x, z, r, act, row_base, row0, R);
  uint32_t acc[RPT], pv[RPT];
  test_planes<false>(cols, rows, FULL, acc);
  load_prev(pv, prev, row_base, row0, R, W, w);
  if (row_ids)
    store_rows<E>(cols, rows, acc, pv, SelfIds{row_ids, C}, row_base, row0,
                  R, W, w, new_out, out1, out2);
  else
    store_rows<E>(cols, rows, acc, pv, SelfSquare(row0, W), row_base, row0,
                  R, W, w, new_out, out1, out2);
}

template <Emit E>
int launch(const void* x, const void* z, const void* r, const void* act,
           const void* xc, const void* zc, const void* actc,
           const void* row_ids, const void* prev, void* new_out, void* out1,
           void* out2, int64_t S, int64_t R, int64_t C, void* stream) {
  if (S <= 0 || R <= 0 || C <= 0) return 0;
  if (C % 32 != 0 || S > 65535 || C > (1 << 30) || R > (1 << 30) ||
      (!row_ids && R != C))
    return (int)cudaErrorInvalidValue;
  const int64_t W = C / 32;
  const dim3 block(TW, TY);
  const dim3 grid((unsigned)((W + TW - 1) / TW), (unsigned)((R + TR - 1) / TR),
                  (unsigned)S);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  aoi_step_kernel<E><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)z, (const float*)r, (const uint8_t*)act,
      (const float*)xc, (const float*)zc, (const uint8_t*)actc,
      (const int32_t*)row_ids, (const int32_t*)prev, (int32_t*)new_out,
      (int32_t*)out1, (int32_t*)out2, (int)R, (int)C, (int)W);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows x, z, r: float32 [S, R]; act: uint8 (torch.bool) [S, R];
// candidates xc, zc: float32 [S, C]; actc: uint8 [S, C]; row_ids: int32
// [S, R] or null (square mode: then the candidates must be the rows and
// R == C); prev and every output: int32 [S, R, C / 32]; all contiguous on
// one device.  Each entry launches on `stream` and returns
// cudaGetLastError() (0 = launched).

// emit="chg": new and chg = new ^ prev.
extern "C" int gw_aoi_step_chg(const void* x, const void* z, const void* r,
                               const void* act, const void* xc,
                               const void* zc, const void* actc,
                               const void* row_ids, const void* prev,
                               void* new_out, void* chg_out, int64_t S,
                               int64_t R, int64_t C, void* stream) {
  return launch<Emit::kChg>(x, z, r, act, xc, zc, actc, row_ids, prev,
                            new_out, chg_out, nullptr, S, R, C, stream);
}

// emit="entlv": new, enter = new & ~prev and leave = prev & ~new.
extern "C" int gw_aoi_step_entlv(const void* x, const void* z, const void* r,
                                 const void* act, const void* xc,
                                 const void* zc, const void* actc,
                                 const void* row_ids, const void* prev,
                                 void* new_out, void* enter_out,
                                 void* leave_out, int64_t S, int64_t R,
                                 int64_t C, void* stream) {
  return launch<Emit::kEntlv>(x, z, r, act, xc, zc, actc, row_ids, prev,
                              new_out, enter_out, leave_out, S, R, C, stream);
}
