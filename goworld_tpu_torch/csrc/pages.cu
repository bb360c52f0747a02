// The page allocator for Hopper (sm_90a): the paged storage's allocate-and-
// compact pass over one change grid.  Nothing waits for the host: the
// entry launches on the caller's stream, never synchronises, allocates or
// copies to the host, and its launch shape is a function of the shapes
// alone (a CUDA graph can hold it).
//
// gw_allocate_pages replaces the jitted XLA program
// goworld_tpu/ops/aoi_pages.py:79 allocate_pages (jitted standalone at
// :161 paged_extract and inside the engine's fused paged step).  For int32
// words chg, new of nw words, split into n_bins = ceil(nw / bw) bins of bw
// words (the last one ragged), and a free list of n_pages page ids:
//
//   cnt[b]  = the nonzero words of bin b (tested != 0: bit 31 counts);
//   need[b] = ceil(cnt[b] / 64) pages;
//   the grant: bins in ascending order of need, ties by bin id, fit while
//     the running total of need is at most n_pages; a bin of need 0 never
//     fits; the rest with need > 0 spill;
//   granted bins take consecutive page ranks in bin order (rank0[b], the
//     exclusive sum of the granted needs), and the k-th nonzero word of a
//     granted bin lands at entry rank0[b] * 64 + k of the pools: pool_g
//     its flat index, pool_c its chg word, pool_n its new word; every other
//     entry is -1 / 0 / 0;
//   page_tab[i] = free[i] for i < n_used, else -1; free_next[i] =
//     free[(i + n_used) % n_pages] (a buffer apart from free);
//   spill_bins: the first sw spilled bin ids ascending, -1 past them;
//   scalars = (n_used, n_spill, nonzero words of the granted bins, all
//     nonzero words), int32.
//
// Plain version it is held to element for element:
// goworld_tpu_torch/ops/aoi_pages.py allocate_pages_plain (a stable
// argsort, cumsums and three scatters over padded int64 grids).
//
//   Bound: it must read chg once (4 * nw bytes: 268 MB at phase 17's 8 x
//   16384 x 512 words), new at the granted nonzero words, write the three
//   pools once (3 * 256 * n_pages bytes: 101 MB at 131,072 pages) and
//   read free and write page_tab and free_next (12 * n_pages): about
//   0.11 ms at 3.35 TB/s.  Three kernels behind the pools' memsets:
//
//   page_count  a warp a bin (grid-stride), four 16-byte loads a lane in
//               flight: cnt[b].
//   page_grant  one block.  need only takes the values 0 .. ceil(bw / 64)
//               (the classes), so the stable argsort is a counting sort:
//               a histogram of the classes, and its exclusive prefix of
//               pages (prefix_v = the pages of every class below v).  The
//               classes below the boundary class v* fit whole, those
//               above not at all, and in v* the first k* by bin id fit,
//               k* = (n_pages - prefix_v*) / v*: v* is the least class v
//               >= 1 with bins and prefix_v + v * hist_v > n_pages.  This
//               is cumsum(need[order]) <= n_pages exactly, ties included.
//               Then one walk over the bins, 1024 at a time, ranks the
//               bins of v*, the granted pages and the spills (block
//               scans with a carry): rank0 (-1: not granted), spill_bins,
//               the scalars.
//   page_write  a warp a granted bin (the others skip: the grant is read
//               on the device, no host sync): it reads the bin's chg
//               again, ranks its nonzero words in flat order by a warp
//               scan and writes them and their new words to their pages;
//               the blocks past the bins write page_tab and free_next.
//
// No scratch carries from one launch to the next: cnt and rank0 are
// written whole before they are read, and the histogram lives in the
// grant block's shared memory, zeroed by that block.  So back-to-back
// launches on one scratch, and graph replays, each start clean.  The
// second read of the granted bins' chg (the write pass) is the design's
// known excess over the bound: a one-bit-a-word summary from the count
// pass would spare it.
//
// Arithmetic follows the port's int32 tensors: words are tested as
// unsigned bits, the scalars narrow to int32 as the plain sums do.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

typedef long long i64;

constexpr int THREADS = 256;  // page_count, page_write
constexpr int WARPS = THREADS / 32;
constexpr int GRANT_THREADS = 1024;
constexpr int PAGE_WORDS = 64;       // ops/pages_cuda.py PAGE_WORDS
constexpr int MAX_CLASSES = 8193;    // ops/pages_cuda.py MAX_CLASSES
constexpr int UNROLL = 4;            // 16-byte loads a lane in flight
constexpr int SPAN = 4 * 32 * UNROLL;  // words a warp step covers
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ i64 imin(i64 a, i64 b) { return a < b ? a : b; }

template <typename T>
__device__ __forceinline__ T warp_inclusive(T v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T u = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// Exclusive prefix of v over the block in thread order; *total gets the
// block's sum.  Every thread calls it (it synchronises the block).
template <typename T>
__device__ T block_exclusive(T v, T* total) {
  __shared__ T part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const T inc = warp_inclusive(v);
  __syncthreads();  // part[] is free: every thread read the last call's
  if (lane == 31) part[warp] = inc;
  __syncthreads();
  if (warp == 0) part[lane] = warp_inclusive(lane < nwarps ? part[lane] : T(0));
  __syncthreads();
  *total = part[nwarps - 1];
  return (warp == 0 ? T(0) : part[warp - 1]) + inc - v;
}

// Words i .. i+3 of p (0 at and past end) as unsigned bits; VEC: p is
// 16-byte aligned and i a multiple of 4, so a whole group is one load.
template <bool VEC>
__device__ __forceinline__ void load4(const int32_t* __restrict__ p, i64 i,
                                      i64 end, uint32_t (&v)[4]) {
  if (VEC && i + 3 < end) {
    const int4 q = *reinterpret_cast<const int4*>(p + i);
    v[0] = static_cast<uint32_t>(q.x);
    v[1] = static_cast<uint32_t>(q.y);
    v[2] = static_cast<uint32_t>(q.z);
    v[3] = static_cast<uint32_t>(q.w);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = i + q < end ? static_cast<uint32_t>(p[i + q]) : 0u;
  }
}

// cnt[b] = the nonzero words of bin b, a warp a bin.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    page_count(const int32_t* __restrict__ chg, i64 nw, i64 bw, i64 n_bins,
               int32_t* __restrict__ cnt) {
  const int lane = threadIdx.x & 31;
  const i64 nwarps = static_cast<i64>(gridDim.x) * WARPS;
  for (i64 b = static_cast<i64>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
       b < n_bins; b += nwarps) {
    const i64 lo = b * bw, hi = imin(lo + bw, nw);
    unsigned c = 0;
    for (i64 i = lo + 4 * lane; i < hi; i += SPAN) {
      uint32_t v[UNROLL][4];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) load4<VEC>(chg, i + 128 * u, hi, v[u]);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int q = 0; q < 4; ++q) c += v[u][q] != 0u;
    }
    c = __reduce_add_sync(FULL, c);
    if (lane == 0) cnt[b] = static_cast<int32_t>(c);
  }
}

// The grant, in one block of GRANT_THREADS: rank0[b] (the bin's first
// page rank, -1 when it is not granted), spill_bins [sw] and scalars [4].
__global__ void __launch_bounds__(GRANT_THREADS)
    page_grant(const int32_t* __restrict__ cnt, i64 n_bins, i64 n_pages,
               int n_classes, i64 sw, int32_t* __restrict__ rank0,
               int32_t* __restrict__ spill_bins,
               int32_t* __restrict__ scalars) {
  __shared__ int hist[MAX_CLASSES];
  __shared__ int s_vstar;
  __shared__ i64 s_kstar;
  const int t = threadIdx.x, lane = t & 31;
  for (int v = t; v < n_classes; v += GRANT_THREADS) hist[v] = 0;
  if (t == 0) {
    s_vstar = n_classes;  // none: every class fits whole
    s_kstar = 0;
  }
  __syncthreads();
  // the histogram of the classes, one shared atomic a class a warp
  for (i64 base = 0; base < n_bins; base += GRANT_THREADS) {
    const i64 b = base + t;
    const int need = b < n_bins ? (cnt[b] + PAGE_WORDS - 1) / PAGE_WORDS : -1;
    const unsigned same = __match_any_sync(FULL, need);
    if (need >= 0 && lane == __ffs(same) - 1)
      atomicAdd(&hist[need], __popc(same));
  }
  __syncthreads();
  // the boundary class: the least v >= 1 with bins whose pages, on top of
  // every class below it, pass n_pages
  i64 carry = 0;
  for (int base = 0; base < n_classes; base += GRANT_THREADS) {
    const int v = base + t;
    const int h = v < n_classes ? hist[v] : 0;
    const i64 pages = static_cast<i64>(v) * h;
    i64 tot;
    const i64 pre = carry + block_exclusive(pages, &tot);
    if (v >= 1 && h > 0 && pre + pages > n_pages) atomicMin(&s_vstar, v);
    __syncthreads();
    const int vs = s_vstar;
    if (v < n_classes && v == vs) s_kstar = (n_pages - pre) / v;  // pre <= n_pages
    __syncthreads();
    if (vs < n_classes) break;  // the same in every thread
    carry += tot;
  }
  const int vs = s_vstar;
  const i64 ks = s_kstar;
  // the bins in id order: v*'s ranks, then page ranks and spill ranks
  i64 eq_carry = 0, used = 0, spilled = 0, fit_words = 0, all_words = 0;
  for (i64 base = 0; base < n_bins; base += GRANT_THREADS) {
    const i64 b = base + t;
    const int c = b < n_bins ? cnt[b] : 0;
    const int need = (c + PAGE_WORDS - 1) / PAGE_WORDS;
    const bool eq = b < n_bins && need == vs;
    i64 eq_tot;
    const i64 eq_rank = eq_carry + block_exclusive<i64>(eq, &eq_tot);
    const bool fit = need > 0 && (need < vs || (eq && eq_rank < ks));
    const bool spill = need > 0 && !fit;
    // granted pages (< 2^23 a chunk) above, spills below
    const i64 packed = (static_cast<i64>(fit ? need : 0) << 32) | spill;
    i64 p_tot;
    const i64 p_ex = block_exclusive(packed, &p_tot);
    if (b < n_bins)
      rank0[b] = fit ? static_cast<int32_t>(used + (p_ex >> 32)) : -1;
    const i64 s_rank = spilled + (p_ex & 0xffffffffLL);
    if (spill && s_rank < sw) spill_bins[s_rank] = static_cast<int32_t>(b);
    if (fit) fit_words += c;
    all_words += c;
    eq_carry += eq_tot;
    used += p_tot >> 32;
    spilled += p_tot & 0xffffffffLL;
  }
  for (i64 i = spilled + t; i < sw; i += GRANT_THREADS) spill_bins[i] = -1;
  i64 fit_tot, all_tot;
  block_exclusive(fit_words, &fit_tot);
  block_exclusive(all_words, &all_tot);
  if (t == 0) {
    scalars[0] = static_cast<int32_t>(used);
    scalars[1] = static_cast<int32_t>(spilled);
    scalars[2] = static_cast<int32_t>(fit_tot);
    scalars[3] = static_cast<int32_t>(all_tot);
  }
}

// Blocks [0, bin_blocks): a warp a granted bin, its nonzero words to their
// pages.  The blocks after them: page_tab and free_next, n_used read from
// scalars[0] (the grant's).
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    page_write(const int32_t* __restrict__ chg, const int32_t* __restrict__ nv,
               i64 nw, i64 bw, i64 n_bins, const int32_t* __restrict__ rank0,
               int bin_blocks, const int32_t* __restrict__ free_list,
               i64 n_pages, const int32_t* __restrict__ scalars,
               int32_t* __restrict__ pool_g, int32_t* __restrict__ pool_c,
               int32_t* __restrict__ pool_n, int32_t* __restrict__ page_tab,
               int32_t* __restrict__ free_next) {
  if (static_cast<int>(blockIdx.x) >= bin_blocks) {
    const i64 n_used = scalars[0];
    const i64 step = static_cast<i64>(gridDim.x - bin_blocks) * THREADS;
    for (i64 i = static_cast<i64>(blockIdx.x - bin_blocks) * THREADS +
                 threadIdx.x;
         i < n_pages; i += step) {
      page_tab[i] = i < n_used ? free_list[i] : -1;
      const i64 j = i + n_used;
      free_next[i] = free_list[j < n_pages ? j : j - n_pages];
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const i64 nwarps = static_cast<i64>(bin_blocks) * WARPS;
  for (i64 b = static_cast<i64>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
       b < n_bins; b += nwarps) {
    const int r0 = rank0[b];
    if (r0 < 0) continue;  // not granted: the same in the whole warp
    const i64 lo = b * bw, hi = imin(lo + bw, nw);
    i64 dst = static_cast<i64>(r0) * PAGE_WORDS;
    for (i64 base = lo; base < hi; base += SPAN) {
      const i64 i = base + 4 * lane;
      uint32_t v[UNROLL][4];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) load4<VEC>(chg, i + 128 * u, hi, v[u]);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        int c = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) c += v[u][q] != 0u;
        const int inc = warp_inclusive(c);
        i64 d = dst + inc - c;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (v[u][q] != 0u) {
            const i64 g = i + 128 * u + q;
            pool_g[d] = static_cast<int32_t>(g);
            pool_c[d] = static_cast<int32_t>(v[u][q]);
            pool_n[d] = nv[g];
            ++d;
          }
        }
        dst += __shfl_sync(FULL, inc, 31);
      }
    }
  }
}

inline int err(cudaError_t e) { return static_cast<int>(e); }

// cudaMemsetAsync on the stream, then cudaGetLastError().
inline cudaError_t fill(void* p, int byte, i64 bytes, cudaStream_t s) {
  if (bytes == 0) return cudaSuccess;
  const cudaError_t e =
      cudaMemsetAsync(p, byte, static_cast<size_t>(bytes), s);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// The entry takes the launch plan of goworld_tpu_torch/ops/pages_cuda.py
// (a pure function of the shapes), its scratch from the wrapper
// (torch.empty: the graph's pool inside a capture), launches on `stream`
// and returns cudaGetLastError() after each launch or memset (0 =
// launched), cudaErrorInvalidValue on a bad plan.
//
// chg, nv: int32 [nw]; free_list: int32 [n_pages]; pools: int32 [n_pages,
// 64]; page_tab, free_next: int32 [n_pages] (free_next apart from
// free_list); spill_bins: int32 [sw]; scalars: int32 [4]; scratch: int32
// [2 * n_bins]: the counts, then the ranks.  vec: chg 16-byte aligned and
// bw % 4 == 0.  Memsets pool_g to -1 and pool_c, pool_n to 0 (one memset
// where they lie next to each other), then the three kernels.
extern "C" int gw_allocate_pages(
    const int32_t* chg, const int32_t* nv, const int32_t* free_list,
    int64_t nw, int64_t bw, int64_t n_bins, int64_t n_pages, int64_t n_classes,
    int64_t sw, int64_t blocks, int64_t rot_blocks, int vec, int32_t* pool_g,
    int32_t* pool_c, int32_t* pool_n, int32_t* page_tab, int32_t* free_next,
    int32_t* spill_bins, int32_t* scalars, int32_t* scratch, void* stream) {
  if (nw < 0 || bw < 1 || n_bins != (nw + bw - 1) / bw ||
      n_bins * bw > INT32_MAX || n_pages < 0 ||
      n_classes != (bw + PAGE_WORDS - 1) / PAGE_WORDS + 1 ||
      n_classes > MAX_CLASSES || sw < 0 || sw > n_bins || blocks < 1 ||
      blocks > (1 << 20) || rot_blocks < 1 || rot_blocks > (1 << 20))
    return err(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const i64 pool_bytes = 4 * PAGE_WORDS * n_pages;
  cudaError_t e = fill(pool_g, 0xFF, pool_bytes, s);
  if (e != cudaSuccess) return err(e);
  if (reinterpret_cast<char*>(pool_n) ==
      reinterpret_cast<char*>(pool_c) + pool_bytes) {
    e = fill(pool_c, 0, 2 * pool_bytes, s);
  } else if ((e = fill(pool_c, 0, pool_bytes, s)) == cudaSuccess) {
    e = fill(pool_n, 0, pool_bytes, s);
  }
  if (e != cudaSuccess) return err(e);
  int32_t* cnt = scratch;
  int32_t* rank0 = scratch + n_bins;
  const unsigned nb = static_cast<unsigned>(blocks);
  if (vec)
    page_count<true><<<nb, THREADS, 0, s>>>(chg, nw, bw, n_bins, cnt);
  else
    page_count<false><<<nb, THREADS, 0, s>>>(chg, nw, bw, n_bins, cnt);
  if ((e = cudaGetLastError()) != cudaSuccess) return err(e);
  page_grant<<<1, GRANT_THREADS, 0, s>>>(cnt, n_bins, n_pages,
                                         static_cast<int>(n_classes), sw,
                                         rank0, spill_bins, scalars);
  if ((e = cudaGetLastError()) != cudaSuccess) return err(e);
  const unsigned grid = static_cast<unsigned>(blocks + rot_blocks);
  const int bb = static_cast<int>(blocks);
  if (vec)
    page_write<true><<<grid, THREADS, 0, s>>>(
        chg, nv, nw, bw, n_bins, rank0, bb, free_list, n_pages, scalars,
        pool_g, pool_c, pool_n, page_tab, free_next);
  else
    page_write<false><<<grid, THREADS, 0, s>>>(
        chg, nv, nw, bw, n_bins, rank0, bb, free_list, n_pages, scalars,
        pool_g, pool_c, pool_n, page_tab, free_next);
  return err(cudaGetLastError());
}
