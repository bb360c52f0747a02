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
//   0.11 ms at 3.35 TB/s.  So chg is read once, and no step runs in one
//   block.  Three kernels behind the pools' memsets:
//
//   page_count  a warp a bin (grid-stride), four 16-byte loads a lane in
//               flight: cnt[b], and a summary of the bin, one bit for each
//               group of four words that holds a nonzero word (a ballot
//               per 32 groups; bw / 128 summary words a bin, 2.1 MB at
//               phase 17).  need only takes the values 0 .. ceil(bw / 64)
//               (the classes), so the stable argsort is a counting sort:
//               each bin of need > 0 adds one to its class in its rank
//               tile's histogram (a global atomic; the histograms are
//               zeroed by a memset before the kernel).
//   page_rank   a block a rank tile of RANK_THREADS * items consecutive
//               bins, all tiles at once.  Each block sums the tiles'
//               histograms into the classes' and finds the boundary: the
//               classes below the boundary class v* fit whole, those
//               above not at all, and in v* the first k* bins by id fit,
//               k* = (n_pages - prefix_v*) / v*, where prefix_v is the
//               pages of every class below v and v* is the least class v
//               >= 1 with bins and prefix_v + v * hist_v > n_pages (this
//               is cumsum(need[order]) <= n_pages exactly, ties
//               included).  The bins before the tile then hold eqP bins
//               of v*, AP pages of the classes below and SP bins above,
//               summed from the earlier tiles' histograms; so the tile's
//               first page rank is AP + v* * min(eqP, k*) and its first
//               spill rank SP + max(eqP - k*, 0), with no scan across
//               blocks.  Block scans inside the tile give rank0 (-1: not
//               granted) and spill_bins; block 0 writes n_used, n_spill
//               and spill_bins' -1 tail, each tile its granted and all
//               words.
//   page_write  a warp a granted bin (the others skip: the grant is read
//               on the device, no host sync).  A sparse bin reads its
//               summary, a word a lane, loads only the flagged groups of
//               chg and new (a lane's first group in one round trip, kept
//               in registers; its later ones one after another), ranks
//               their nonzero words by a warp scan and writes them to
//               their pages.  A dense bin, whose nonzero words a summary
//               word (cnt / sum_words) reach the steps of a whole reread
//               (bw / SPAN), reads its chg again whole in 16-byte loads:
//               its lanes' serial group loads would take longer
//               (scripts/torch_pages_dense.py times both: bins of 512
//               words are dense from 5 words on, bins of 4096 from 256,
//               6.25%).
//               The blocks past the bins write page_tab and free_next,
//               and the first of them scalars[2] and [3].
//
//   Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): 0.158 ms of
//   device time at phase 17's shapes against 0.234 for the earlier
//   design with one grant block and a second read of chg (0.035 and
//   0.069 ms of it); the count pass is most of it, 0.096-0.101 ms for the
//   268 MB read.
//
// No scratch carries from one launch to the next: cnt, the summary, rank0
// and the tiles' word sums are written whole before they are read, and
// the tiles' histograms are zeroed by a memset on the stream inside the
// entry (inside a CUDA graph that memset is a node of the graph).  So
// back-to-back launches on one scratch, and graph replays, each start
// clean.
//
// Arithmetic follows the port's int32 tensors: words are tested as
// unsigned bits, the scalars narrow to int32 as the plain sums do.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int THREADS = 256;  // page_count, page_write
constexpr int WARPS = THREADS / 32;
constexpr int RANK_THREADS = 1024;  // page_rank: a thread a bin (x items)
constexpr int PAGE_WORDS = 64;       // ops/pages_cuda.py PAGE_WORDS
constexpr int MAX_CLASSES = 8193;    // ops/pages_cuda.py MAX_CLASSES
constexpr int MAX_TILES = 1024;      // ops/pages_cuda.py MAX_TILES
constexpr int GROUP_WORDS = 4;       // words a summary bit covers
constexpr int SUM_SPAN = 32 * GROUP_WORDS;  // words a summary word covers
constexpr int UNROLL = 4;            // 16-byte loads a lane in flight
constexpr int SPAN = 4 * 32 * UNROLL;  // words a warp step covers
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ i64 imin(i64 a, i64 b) { return a < b ? a : b; }
__device__ __forceinline__ i64 imax(i64 a, i64 b) { return a > b ? a : b; }

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

template <typename T>
__device__ __forceinline__ T block_sum(T v) {
  T total;
  block_exclusive(v, &total);
  return total;
}

// Two counts in one scan: each half's sum over the block stays below
// 2^32 (pages and bins of one grid, words of one grid), so no carry
// crosses from the low half into the high one.
__device__ __forceinline__ u64 pack(i64 hi, i64 lo) {
  return static_cast<u64>(hi) << 32 | static_cast<u64>(lo);
}
__device__ __forceinline__ i64 hi32(u64 v) { return static_cast<i64>(v >> 32); }
__device__ __forceinline__ i64 lo32(u64 v) {
  return static_cast<i64>(v & 0xffffffffull);
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

__device__ __forceinline__ int nonzero4(const uint32_t (&v)[4]) {
  return (v[0] != 0u) + (v[1] != 0u) + (v[2] != 0u) + (v[3] != 0u);
}

// The nonzero words v of the group at g0, with their new words n, to the
// pools from entry d on; returns the next entry.
__device__ __forceinline__ i64 put4(i64 g0, const uint32_t (&v)[4],
                                    const uint32_t (&n)[4], i64 d,
                                    int32_t* __restrict__ pool_g,
                                    int32_t* __restrict__ pool_c,
                                    int32_t* __restrict__ pool_n) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (v[q] != 0u) {
      pool_g[d] = static_cast<int32_t>(g0 + q);
      pool_c[d] = static_cast<int32_t>(v[q]);
      pool_n[d] = static_cast<int32_t>(n[q]);
      ++d;
    }
  }
  return d;
}

// cnt[b] = the nonzero words of bin b, a warp a bin; summary[b * sum_words
// + j] bit k = group 32 j + k of the bin (its words 4 (32 j + k) .. + 3)
// holds a nonzero word; hist[(b / tile) * n_classes + need] += 1 for need
// > 0.  A warp step covers groups 128 s + 32 u + lane: summary word 4 s +
// u is the ballot of load u.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    page_count(const int32_t* __restrict__ chg, i64 nw, i64 bw, i64 n_bins,
               i64 sum_words, i64 tile, int n_classes,
               int32_t* __restrict__ cnt, uint32_t* __restrict__ summary,
               int32_t* __restrict__ hist) {
  const int lane = threadIdx.x & 31;
  const i64 nwarps = static_cast<i64>(gridDim.x) * WARPS;
  for (i64 b = static_cast<i64>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
       b < n_bins; b += nwarps) {
    const i64 lo = b * bw, hi = imin(lo + bw, nw);
    uint32_t* sum = summary + b * sum_words;
    unsigned c = 0;
    i64 j = 0;
    // the loop is the same in the whole warp (the ballots)
    for (i64 base = lo; base < hi; base += SPAN, j += UNROLL) {
      const i64 i = base + 4 * lane;
      uint32_t v[UNROLL][4];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) load4<VEC>(chg, i + 128 * u, hi, v[u]);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int n = nonzero4(v[u]);
        c += n;
        const unsigned bits = __ballot_sync(FULL, n != 0);
        if (lane == u && j + u < sum_words) sum[j + u] = bits;
      }
    }
    // a ragged last bin's summary words past its last step
    for (j += lane; j < sum_words; j += 32) sum[j] = 0u;
    c = __reduce_add_sync(FULL, c);
    if (lane == 0) {
      cnt[b] = static_cast<int32_t>(c);
      const int need = static_cast<int>((c + PAGE_WORDS - 1) / PAGE_WORDS);
      if (need > 0) atomicAdd(&hist[(b / tile) * n_classes + need], 1);
    }
  }
}

// A block a rank tile of RANK_THREADS * items bins (thread t its items
// consecutive bins from t * items): rank0 (-1: not granted), spill_bins,
// the tile's granted and all words (tile_words[2 t], [2 t + 1]); block 0
// also scalars[0], [1] and spill_bins' -1 tail.
__global__ void __launch_bounds__(RANK_THREADS)
    page_rank(const int32_t* __restrict__ cnt, i64 n_bins, i64 n_pages,
              int n_classes, i64 items, i64 tiles, i64 sw,
              const int32_t* __restrict__ hist, int32_t* __restrict__ rank0,
              int32_t* __restrict__ spill_bins,
              int32_t* __restrict__ tile_words,
              int32_t* __restrict__ scalars) {
  __shared__ int s_vstar;
  __shared__ i64 s_pre, s_bins_below;
  const int t = threadIdx.x;
  const i64 tile = blockIdx.x;
  if (t == 0) {
    s_vstar = n_classes;  // none: every class fits whole
    s_pre = 0;
    s_bins_below = 0;
  }
  // the classes' histogram and the boundary class: the least v >= 1 with
  // bins whose pages, on top of every class below it, pass n_pages
  i64 pages_all = 0, bins_all = 0;
  for (int base = 0; base < n_classes; base += RANK_THREADS) {
    const int v = base + t;
    i64 h = 0;
    if (v >= 1 && v < n_classes)
      for (i64 u = 0; u < tiles; ++u) h += hist[u * n_classes + v];
    const i64 pages = static_cast<i64>(v) * h;
    u64 tot;
    const u64 ex = block_exclusive(pack(pages, h), &tot);
    const i64 pre = pages_all + hi32(ex);
    if (h > 0 && pre + pages > n_pages) atomicMin(&s_vstar, v);
    __syncthreads();
    if (v < n_classes && v == s_vstar) {  // one thread over the chunks
      s_pre = pre;  // <= n_pages: the classes below it fit
      s_bins_below = bins_all + lo32(ex);
    }
    pages_all += hi32(tot);
    bins_all += lo32(tot);
  }
  __syncthreads();
  const int vs = s_vstar;
  const bool cut = vs < n_classes;
  const i64 ks = cut ? (n_pages - s_pre) / vs : 0;
  // the bins before this tile: eqP of class v*, AP pages of the classes
  // below it, SP bins of the classes above it
  i64 eqp = 0, ap = 0, sp = 0;
  for (i64 i = t; i < tile * n_classes; i += RANK_THREADS) {
    const int v = static_cast<int>(i % n_classes);
    const i64 h = hist[i];
    if (v == vs) eqp += h;
    else if (v < vs) ap += static_cast<i64>(v) * h;
    else sp += h;
  }
  const u64 eq_sp = block_sum(pack(eqp, sp));
  eqp = hi32(eq_sp);
  sp = lo32(eq_sp);
  ap = block_sum(ap);
  const i64 b0 = (tile * RANK_THREADS + t) * items;
  const i64 b1 = imin(b0 + items, n_bins);
  // this thread's bins of v*, ranked over the tile
  i64 e = 0;
  for (i64 b = b0; b < b1; ++b)
    e += (cnt[b] + PAGE_WORDS - 1) / PAGE_WORDS == vs;
  i64 e_tot;
  const i64 er0 = eqp + block_exclusive(e, &e_tot);
  // granted pages, spills and words
  i64 pg = 0, spn = 0, fw = 0, aw = 0;
  for (i64 b = b0, er = er0; b < b1; ++b) {
    const int c = cnt[b];
    const int need = (c + PAGE_WORDS - 1) / PAGE_WORDS;
    const bool eq = need == vs;
    const bool fit = need > 0 && (need < vs || (eq && er < ks));
    er += eq;
    pg += fit ? need : 0;
    spn += need > 0 && !fit;
    fw += fit ? c : 0;
    aw += c;
  }
  u64 ps_tot;
  const u64 ps = block_exclusive(pack(pg, spn), &ps_tot);
  i64 p = ap + vs * imin(eqp, ks) + hi32(ps);
  i64 s = sp + imax(eqp - ks, 0) + lo32(ps);
  for (i64 b = b0, er = er0; b < b1; ++b) {
    const int need = (cnt[b] + PAGE_WORDS - 1) / PAGE_WORDS;
    const bool eq = need == vs;
    const bool fit = need > 0 && (need < vs || (eq && er < ks));
    er += eq;
    rank0[b] = fit ? static_cast<int32_t>(p) : -1;
    if (fit) p += need;
    if (need > 0 && !fit) {
      if (s < sw) spill_bins[s] = static_cast<int32_t>(b);
      ++s;
    }
  }
  const u64 words = block_sum(pack(fw, aw));
  if (t == 0) {
    tile_words[2 * tile] = static_cast<int32_t>(hi32(words));
    tile_words[2 * tile + 1] = static_cast<int32_t>(lo32(words));
  }
  if (tile == 0) {
    // n_used: every class below v* and its first k* bins; n_spill: the
    // bins of need > 0 that do not fit
    const i64 n_used = cut ? s_pre + vs * ks : pages_all;
    const i64 n_spill = cut ? bins_all - s_bins_below - ks : 0;
    if (t == 0) {
      scalars[0] = static_cast<int32_t>(n_used);
      scalars[1] = static_cast<int32_t>(n_spill);
    }
    for (i64 i = n_spill + t; i < sw; i += RANK_THREADS) spill_bins[i] = -1;
  }
}

// Blocks [0, bin_blocks): a warp a granted bin, its nonzero words to their
// pages.  The blocks after them: page_tab and free_next, n_used read from
// scalars[0] (page_rank's); the first of them scalars[2], [3].
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    page_write(const int32_t* __restrict__ chg, const int32_t* __restrict__ nv,
               i64 nw, i64 bw, i64 n_bins, i64 sum_words,
               const int32_t* __restrict__ cnt,
               const uint32_t* __restrict__ summary,
               const int32_t* __restrict__ rank0, int bin_blocks,
               const int32_t* __restrict__ free_list, i64 n_pages,
               i64 tiles, const int32_t* __restrict__ tile_words,
               int32_t* __restrict__ scalars, int32_t* __restrict__ pool_g,
               int32_t* __restrict__ pool_c, int32_t* __restrict__ pool_n,
               int32_t* __restrict__ page_tab,
               int32_t* __restrict__ free_next) {
  if (static_cast<int>(blockIdx.x) >= bin_blocks) {
    if (static_cast<int>(blockIdx.x) == bin_blocks) {
      i64 fw = 0, aw = 0;
      for (i64 u = threadIdx.x; u < tiles; u += THREADS) {
        fw += tile_words[2 * u];
        aw += tile_words[2 * u + 1];
      }
      fw = block_sum(fw);
      aw = block_sum(aw);
      if (threadIdx.x == 0) {
        scalars[2] = static_cast<int32_t>(fw);
        scalars[3] = static_cast<int32_t>(aw);
      }
    }
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
    // dense: a lane's expected flagged groups (cnt / sum_words), each
    // loaded one after another, reach the steps of a whole reread (bw /
    // SPAN): chg whole
    if (static_cast<i64>(cnt[b]) * SPAN >= bw * sum_words) {
      for (i64 base = lo; base < hi; base += SPAN) {
        const i64 i = base + 4 * lane;
        uint32_t v[UNROLL][4];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          load4<VEC>(chg, i + 128 * u, hi, v[u]);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int c = nonzero4(v[u]);
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
      continue;
    }
    // sparse: summary word j0 + lane of the bin, its flagged groups.  The
    // lane's first group comes in with its new words (one round trip) and
    // stays in registers; a lane's later groups (rare in a sparse bin)
    // are read again when they are written.
    const uint32_t* sum = summary + b * sum_words;
    for (i64 j0 = 0; j0 < sum_words; j0 += 32) {
      const i64 j = j0 + lane;
      uint32_t m = j < sum_words ? sum[j] : 0u;
      const i64 at = lo + j * SUM_SPAN;  // the summary word's first word
      i64 g1 = at;
      uint32_t c1[4] = {0u, 0u, 0u, 0u}, n1[4] = {0u, 0u, 0u, 0u};
      if (m) {
        g1 = at + GROUP_WORDS * (__ffs(static_cast<int>(m)) - 1);
        load4<VEC>(chg, g1, hi, c1);
        load4<VEC>(nv, g1, hi, n1);
        m &= m - 1;
      }
      int c = nonzero4(c1);
      for (uint32_t r = m; r; r &= r - 1) {
        uint32_t v[4];
        load4<VEC>(chg, at + GROUP_WORDS * (__ffs(static_cast<int>(r)) - 1),
                   hi, v);
        c += nonzero4(v);
      }
      const int inc = warp_inclusive(c);
      i64 d = put4(g1, c1, n1, dst + inc - c, pool_g, pool_c, pool_n);
      for (uint32_t r = m; r; r &= r - 1) {
        const i64 g0 = at + GROUP_WORDS * (__ffs(static_cast<int>(r)) - 1);
        uint32_t v[4], n[4];
        load4<VEC>(chg, g0, hi, v);
        load4<VEC>(nv, g0, hi, n);
        d = put4(g0, v, n, d, pool_g, pool_c, pool_n);
      }
      dst += __shfl_sync(FULL, inc, 31);
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
// [2 * n_bins + n_bins * sum_words + tiles * n_classes + 2 * tiles]: the
// counts, the ranks, the summaries, the tiles' histograms and the tiles'
// word sums.  vec: chg and nv 16-byte aligned and bw % 4 == 0.  Memsets
// pool_g to -1 and pool_c, pool_n to 0 (a memset each: pools that lie
// next to each other may still be two allocations, and one memset may not
// cross from one into the next) and the histograms to 0, then the three
// kernels.
extern "C" int gw_allocate_pages(
    const int32_t* chg, const int32_t* nv, const int32_t* free_list,
    int64_t nw, int64_t bw, int64_t n_bins, int64_t n_pages, int64_t n_classes,
    int64_t sw, int64_t blocks, int64_t rot_blocks, int64_t sum_words,
    int64_t items, int64_t tiles, int vec, int32_t* pool_g, int32_t* pool_c,
    int32_t* pool_n, int32_t* page_tab, int32_t* free_next,
    int32_t* spill_bins, int32_t* scalars, int32_t* scratch, void* stream) {
  const i64 tile = RANK_THREADS * items;
  if (nw < 0 || bw < 1 || n_bins != (nw + bw - 1) / bw ||
      n_bins * bw > INT32_MAX || n_pages < 0 ||
      n_classes != (bw + PAGE_WORDS - 1) / PAGE_WORDS + 1 ||
      n_classes > MAX_CLASSES || sw < 0 || sw > n_bins || blocks < 1 ||
      blocks > (1 << 20) || rot_blocks < 1 || rot_blocks > (1 << 20) ||
      sum_words != (bw + SUM_SPAN - 1) / SUM_SPAN || items < 1 ||
      tiles > MAX_TILES ||
      tiles != (n_bins > 0 ? (n_bins + tile - 1) / tile : 1))
    return err(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const i64 pool_bytes = 4 * PAGE_WORDS * n_pages;
  int32_t* cnt = scratch;
  int32_t* rank0 = cnt + n_bins;
  uint32_t* summary = reinterpret_cast<uint32_t*>(rank0 + n_bins);
  int32_t* hist = reinterpret_cast<int32_t*>(summary + n_bins * sum_words);
  int32_t* tile_words = hist + tiles * n_classes;
  cudaError_t e = fill(pool_g, 0xFF, pool_bytes, s);
  if (e == cudaSuccess) e = fill(pool_c, 0, pool_bytes, s);
  if (e == cudaSuccess) e = fill(pool_n, 0, pool_bytes, s);
  if (e == cudaSuccess) e = fill(hist, 0, 4 * tiles * n_classes, s);
  if (e != cudaSuccess) return err(e);
  const unsigned nb = static_cast<unsigned>(blocks);
  const int nc = static_cast<int>(n_classes);
  if (vec)
    page_count<true><<<nb, THREADS, 0, s>>>(chg, nw, bw, n_bins, sum_words,
                                            tile, nc, cnt, summary, hist);
  else
    page_count<false><<<nb, THREADS, 0, s>>>(chg, nw, bw, n_bins, sum_words,
                                             tile, nc, cnt, summary, hist);
  if ((e = cudaGetLastError()) != cudaSuccess) return err(e);
  page_rank<<<static_cast<unsigned>(tiles), RANK_THREADS, 0, s>>>(
      cnt, n_bins, n_pages, nc, items, tiles, sw, hist, rank0, spill_bins,
      tile_words, scalars);
  if ((e = cudaGetLastError()) != cudaSuccess) return err(e);
  const unsigned grid = static_cast<unsigned>(blocks + rot_blocks);
  const int bb = static_cast<int>(blocks);
  if (vec)
    page_write<true><<<grid, THREADS, 0, s>>>(
        chg, nv, nw, bw, n_bins, sum_words, cnt, summary, rank0, bb,
        free_list, n_pages, tiles, tile_words, scalars, pool_g, pool_c,
        pool_n, page_tab, free_next);
  else
    page_write<false><<<grid, THREADS, 0, s>>>(
        chg, nv, nw, bw, n_bins, sum_words, cnt, summary, rank0, bb,
        free_list, n_pages, tiles, tile_words, scalars, pool_g, pool_c,
        pool_n, page_tab, free_next);
  return err(cudaGetLastError());
}
