// The delta scatter for Hopper (sm_90a): one staged packet of changed
// positions into the device-resident x/z planes, in place.  Nothing waits
// for the host: the entry launches on the caller's stream, never
// synchronises, allocates or copies to the host, and its launch shape is
// a function of the packet's length alone (a CUDA graph can hold it).
//
// gw_scatter_packet replaces the jitted XLA program
// goworld_tpu/ops/aoi_stage.py:84 delta_scatter (mode="drop", :99-100),
// jitted and donated at :118 apply_packet (:129).  For a packet int32
// [4, n] -- rows, cols, and the x and z values as their 32-bit patterns
// -- and the planes dx, dz ([S, C] of 32-bit words, row-major) it sets
//
//   dx[r, c] = x bits, dz[r, c] = z bits   for every entry k,
//
// where r = rows[k] + S if rows[k] < 0 else rows[k] (likewise c with C),
// the reference's index normalisation; an entry whose r or c is still
// outside [0, S) x [0, C) is dropped (mode="drop").  The values move as
// bit patterns, never as float arithmetic, so NaN payloads, -0.0 and
// subnormals land bit for bit.  Repeated entries carry identical bits
// (the padding contract of ops/aoi_stage.pad_packet), so the order in
// which they land does not matter.  Plain version it is held to bit for
// bit: goworld_tpu_torch/ops/aoi_stage.py scatter_packet_plain (two
// index_put_ under the same mask).
//
//   Bound: it must read the packet once and write two words an entry (24
//   bytes an entry: 0.00006 ms at an 8192-entry packet at 3.35 TB/s), far
//   below one launch (about 0.001 ms of device time inside a CUDA graph).
//   So it is one launch of a thread an entry (grid-stride past the
//   plan's blocks), its four packet words read as coalesced 4-byte
//   loads, both planes written by the same thread.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

typedef long long i64;

constexpr int THREADS = 256;      // ops/stage_cuda.py THREADS
constexpr int MAX_BLOCKS = 1024;  // ops/stage_cuda.py MAX_BLOCKS

__global__ void __launch_bounds__(THREADS)
    scatter_packet(const int32_t* __restrict__ pkt, i64 n, i64 s, i64 c,
                   uint32_t* __restrict__ dx, uint32_t* __restrict__ dz) {
  const i64 step = static_cast<i64>(gridDim.x) * THREADS;
  for (i64 k = static_cast<i64>(blockIdx.x) * THREADS + threadIdx.x; k < n;
       k += step) {
    i64 r = pkt[k], col = pkt[n + k];
    if (r < 0) r += s;
    if (col < 0) col += c;
    if (r < 0 || r >= s || col < 0 || col >= c) continue;  // dropped
    const i64 at = r * c + col;
    dx[at] = static_cast<uint32_t>(pkt[2 * n + k]);
    dz[at] = static_cast<uint32_t>(pkt[3 * n + k]);
  }
}

}  // namespace

// The entry takes the launch plan of goworld_tpu_torch/ops/stage_cuda.py
// (blocks: a pure function of n), launches on `stream` and returns
// cudaGetLastError() (0 = launched), cudaErrorInvalidValue on a bad plan.
//
// pkt: int32 [4, n]; dx, dz: 32-bit words [s, c], contiguous.
extern "C" int gw_scatter_packet(const int32_t* pkt, int64_t n, int64_t s,
                                 int64_t c, int64_t blocks, void* dx,
                                 void* dz, void* stream) {
  if (n < 0 || s < 0 || c < 0 || blocks < 1 || blocks > MAX_BLOCKS)
    return static_cast<int>(cudaErrorInvalidValue);
  scatter_packet<<<static_cast<unsigned>(blocks), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      pkt, n, s, c, static_cast<uint32_t*>(dx), static_cast<uint32_t*>(dz));
  return static_cast<int>(cudaGetLastError());
}
