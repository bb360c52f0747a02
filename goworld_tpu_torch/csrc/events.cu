// Event compaction for Hopper (sm_90a): the classified AOI diff into event
// triples, and the giant-capacity path's row-stream codec.  The order of
// every output is the reference's and nothing waits for the host: the
// kernels launch on the caller's stream, never synchronise, allocate or
// copy to the host, and every launch shape is a function of the shapes
// and caps alone (a CUDA graph can hold them).
//
// gw_extract_triples replaces the jitted XLA program
// goworld_tpu/ops/events.py:385 extract_triples with its count
// (events.py:43 popcount_total).  For int32 words chg, new of n words
// (flat word g, observer row g / W, W = capacity / 32) it writes the
// triples (g / W, k*W + g % W, bit k of new[g]) of the set bits k of chg,
// in (g, k) ascending order, the first `cap` of them, (-1, -1, -1) past
// the real triples, and count = the exact number of set bits (int64; it
// may exceed cap: the caller's counted overflow).  Plain version it is
// held to element for element: goworld_tpu_torch/ops/events.py
// extract_triples_plain.
//   Bound: it must read chg once (n * 4 bytes: 268 MB, 0.08 ms at 3.35
//   TB/s at the engine path's 8 x 16384 x 512) and write 12 bytes a
//   kept triple; `new` is read only at the changed words.  So it is a
//   single pass (tri_pass), Merrill and Garland's decoupled look-back as
//   CUB's DeviceSelect does it: a block takes a tile of TRI_TILE words by
//   an atomic ticket, loads it once (eight 16-byte loads a thread, all in
//   flight), popcounts it and publishes the tile's count in its status
//   word; warp 0 then sums the earlier tiles' status words, 32 at a time,
//   back to the nearest published prefix, and publishes the tile's own
//   prefix.  The look-back waits on the slowest earlier tile still
//   loading, so a tile holds its SM for most of its life waiting; the
//   block spends that wait making its triples at their ranks inside the
//   tile (staged in shared memory), and only copies them out once its
//   place is known.  A thread keeps the first two of its nonzero words
//   in registers and reads a third or later one again (from L2) when it
//   makes its triples.  The tile with the last ticket writes count; the
//   -1 rows come from a memset of tri before the kernel.
//
// gw_extract_chunks replaces events.py:66 extract_chunks: the words as
// rows of `lanes`; the first max_chunks dirty rows ascending (csel, 0
// fill) with their true nonzero counts (ccnt, 0 fill) and, in each, the
// first kk nonzero words in lane order (vals, 0 fill), their lanes (-1
// fill) and aux at the same slots (0 fill); n_dirty and max_ccnt exact
// over all rows.  Plain version: events.py extract_chunks_plain.
//   Bound: it must read every word once (2.15 GB at `million`, 0.64 ms).
//   The count pass reads each row once (one warp a row, 16-byte loads)
//   and keeps the per-row count (4 bytes a row); the select pass scans
//   only those counts, and the gather pass reads only the kept rows (a
//   warp a row: one ballot per 32 lanes ranks the nonzero words).
//
// gw_encode_row_stream replaces events.py:141 encode_row_stream over the
// chunk rows (vals, new_vals, widx [mr, k], rsel, rcnt [mr]): the row
// byte, the inline bit positions and word offsets of the first two
// slots, the escaped rows (first max_gaps, -1 fill, n_esc exact) and the
// exception triples (first max_exc, row-major over the valid slots, -1 /
// 0 fill, exc_n exact).  base_row is rsel[0], a view the wrapper takes.
// Plain version: events.py encode_row_stream_plain.
//   Bound: it must read the valid slots of vals (new and widx where an
//   inline slot or an exception needs them) and rsel, rcnt once, and
//   write the stream: 0.001-0.005 ms at the giant path's caps, below the
//   time of one launch.  So it is one launch (enc_pass) that reads the
//   rows once: a tile of ENC_TILE rows, ENC_RPT neighbouring rows a
//   thread, its rows' words and then the first two slots of its rows in
//   flight at once (only those two decide a row's count: every later
//   valid slot is an exception); one block exclusive ranks the tile's
//   escapes and exceptions, and the same look-back as the triples places
//   the tile, both counts in one status word.  The lists' fills are
//   memsets before the kernel, merged where the lists lie next to each
//   other (the wrapper allocates them so: two memsets with the status
//   words); the tile with the last ticket writes the two scalars.
//
// The status words and the ticket are zeroed by a memset on the stream
// just before each single-pass kernel, inside the entry.  Inside a CUDA
// graph that memset is a node of the graph, so every replay starts from
// zero, although its scratch is the same memory as the last replay's and
// holds that replay's statuses; outside a graph the scratch from
// torch.empty holds whatever the allocator last put there.  A kernel
// cannot clear its own statuses: no block knows when the last look-back
// that reads them is over.
//
// Arithmetic follows the port's int32 tensors: differences and products
// wrap (computed unsigned), narrowing to int32 or a byte truncates, and
// bits come from unsigned words (the int32 >> is arithmetic).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int THREADS = 256;  // every kernel but the scans
constexpr int WARPS = THREADS / 32;
constexpr int SCAN_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

// the single-pass tiles (ops/events_cuda.py TRI_TILE, ENC_TILE)
constexpr int TRI_STEPS = 8;                           // 16-byte loads a thread
constexpr int TRI_TILE = TRI_STEPS * 4 * THREADS;      // 8192 words
constexpr int TRI_STAGE = 1024;                        // triples staged a tile
constexpr int ENC_RPT = 2;                             // rows a thread
constexpr int ENC_TILE = ENC_RPT * THREADS;            // 512 rows

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

// The largest v of the block (v >= 0), in every thread.
__device__ i64 block_max(i64 v) {
  __shared__ i64 part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = imax(v, __shfl_down_sync(FULL, v, d));
  __syncthreads();
  if (lane == 0) part[warp] = v;
  __syncthreads();
  i64 m = part[0];
  for (int i = 1; i < nwarps; ++i) m = imax(m, part[i]);
  return m;
}

// One block per array a of n counts: offs[a*n + i] = sum of the counts
// before i, totals[a] = their sum.
__global__ void __launch_bounds__(SCAN_THREADS)
    scan_counts(const i64* __restrict__ in, i64* __restrict__ offs,
                i64* __restrict__ totals, int n) {
  const i64* src = in + static_cast<i64>(blockIdx.x) * n;
  i64* dst = offs + static_cast<i64>(blockIdx.x) * n;
  i64 carry = 0;
  for (int base = 0; base < n; base += SCAN_THREADS) {
    const int i = base + threadIdx.x;
    const i64 v = i < n ? src[i] : 0;
    i64 tot;
    const i64 ex = block_exclusive(v, &tot);
    if (i < n) dst[i] = carry + ex;
    carry += tot;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// *out = the largest of n values (all >= 0).
__global__ void __launch_bounds__(SCAN_THREADS)
    max_counts(const i64* __restrict__ in, i64* __restrict__ out, int n) {
  i64 m = 0;
  for (int i = threadIdx.x; i < n; i += SCAN_THREADS) m = imax(m, in[i]);
  m = block_max(m);
  if (threadIdx.x == 0) *out = m;
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

// ---- the single pass: tiles by ticket, ranked by decoupled look-back ------


// A tile's status word: value << 2 | flag.  Flag 0 (the memset's zero):
// nothing published yet; ST_AGG: the value is the tile's own count;
// ST_PRE: the count of every tile up to and including it.
constexpr u64 ST_AGG = 1, ST_PRE = 2;

__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(u64* p, u64 v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void publish(u64* status, i64 t, u64 value,
                                        u64 flag) {
  st_release(status + t, (value << 2) | flag);
}

// The block's tile (every thread calls it, once).  Tickets go out in the
// order blocks start, so every tile a look-back waits on belongs to a
// block that runs or is done, never to one still waiting for an SM.
__device__ __forceinline__ i64 take_ticket(u64* ticket) {
  __shared__ i64 t;
  if (threadIdx.x == 0) t = static_cast<i64>(atomicAdd(ticket, 1ull));
  __syncthreads();
  return t;
}

// One whole warp of tile t > 0, the tile's own value published: the sum
// of the values of tiles [0, t), from their status words, 32 at a time
// nearest first, down to the nearest published prefix.  It waits only on
// the words nearer than that prefix; their tiles publish their own values
// before they look back, so the wait ends.
__device__ u64 look_back(const u64* status, i64 t) {
  const int lane = threadIdx.x & 31;
  u64 excl = 0;
  for (i64 top = t - 1;; top -= 32) {
    const i64 p = top - lane;
    u64 s = p >= 0 ? ld_acquire(status + p) : ST_PRE;  // before tile 0: 0
    int stop;  // the nearest prefix's lane, or 32
    for (;;) {
      const unsigned pre = __ballot_sync(FULL, (s & 3u) == ST_PRE);
      stop = pre != 0u ? __ffs(pre) - 1 : 32;
      const bool wait = lane < stop && (s & 3u) == 0;
      if (!__any_sync(FULL, wait)) break;
      if (wait) s = ld_acquire(status + p);
    }
    u64 v = lane <= stop ? s >> 2 : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
    excl += v;
    if (stop < 32) return excl;
  }
}

// Every thread of tile t's block, the tile's own value agg published: the
// sum of the values of the tiles before it (0 for tile 0), found by warp
// 0, which then publishes the tile's prefix.  Synchronises the block.
__device__ u64 place(u64* status, i64 t, u64 agg) {
  __shared__ u64 s_excl;
  if (threadIdx.x < 32) {
    const u64 excl = t == 0 ? 0 : look_back(status, t);
    if (threadIdx.x == 0) {
      if (t > 0) publish(status, t, excl + agg, ST_PRE);
      s_excl = excl;
    }
  }
  __syncthreads();
  return s_excl;
}

// ---- extract_triples ------------------------------------------------------

// Tile t (by ticket) of TRI_TILE words: word 4 * (j * THREADS + thread) + q
// of the tile is v[j][q] (16-byte loads, neighbouring threads on
// neighbouring addresses, every step in flight at once).  Two block
// exclusives over the steps' counts, packed four to a 64-bit word at 16
// bits apiece (a step's block total is at most 256 * 4 * 32 = 2^15), rank
// every word inside the tile in word order.  The words stay in registers
// only while they are counted: a thread keeps a mask of its nonzero words
// and the first two of them, and new at those two; a third or later
// nonzero word of a thread (none at phase 4's density, chip_smoke.py
// counts them) is read again, from L2, when its triples are made.  Once
// the tile's count is published, every thread makes its triples at their
// ranks inside the tile while warp 0 waits for the tile's place: the
// first TRI_STAGE go to shared memory and then out at the place with
// coalesced stores; a denser tile writes the rest from the threads.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 6)
    tri_pass(const int32_t* __restrict__ chg, const int32_t* __restrict__ nw,
             i64 n, i64 w, i64 cap, i64 tiles, int32_t* __restrict__ tri,
             i64* __restrict__ count, u64* __restrict__ status) {
  static_assert(TRI_STEPS == 8, "two packs of four steps");
  __shared__ int32_t staged[3 * TRI_STAGE];
  const i64 t = take_ticket(status + tiles);
  const i64 base = t * TRI_TILE;
  const i64 end = imin(base + TRI_TILE, n);
  uint32_t v[TRI_STEPS][4];
#pragma unroll
  for (int j = 0; j < TRI_STEPS; ++j)
    load4<VEC>(chg, base + 4 * (j * THREADS + threadIdx.x), end, v[j]);
  u64 packed[2] = {0, 0};
  uint32_t mask = 0, s0 = 0, s1 = 0;
  int kept = 0, p0 = 0, p1 = 0;
#pragma unroll
  for (int j = 0; j < TRI_STEPS; ++j) {
    packed[j / 4] |= static_cast<u64>(__popc(v[j][0]) + __popc(v[j][1]) +
                                      __popc(v[j][2]) + __popc(v[j][3]))
                     << (16 * (j % 4));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (v[j][q] != 0u) {
        mask |= 1u << (4 * j + q);
        if (kept == 0) {
          s0 = v[j][q];
          p0 = 4 * j + q;
        } else if (kept == 1) {
          s1 = v[j][q];
          p1 = 4 * j + q;
        }
        ++kept;
      }
    }
  }
  // new at the first two changed words, in flight through the count
  const i64 g0 = base + 4 * ((p0 >> 2) * THREADS + threadIdx.x) + (p0 & 3);
  const i64 g1 = base + 4 * ((p1 >> 2) * THREADS + threadIdx.x) + (p1 & 3);
  const uint32_t n0 = kept > 0 ? static_cast<uint32_t>(__ldg(nw + g0)) : 0u;
  const uint32_t n1 = kept > 1 ? static_cast<uint32_t>(__ldg(nw + g1)) : 0u;
  u64 ex[2], tot[2];
  i64 agg = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ex[h] = block_exclusive(packed[h], &tot[h]);
#pragma unroll
    for (int f = 0; f < 64; f += 16) agg += (tot[h] >> f) & 0xFFFFu;
  }
  if (threadIdx.x == 0) publish(status, t, agg, t == 0 ? ST_PRE : ST_AGG);
  // The thread's triples at in-tile rank o: staged while o < TRI_STAGE
  // (direct = false), or, once the place excl is known, written to
  // tri[excl + o] for TRI_STAGE <= o < cap - excl (direct = true).
  auto make = [&](bool direct, i64 excl) {
    i64 rank = 0;  // the step's first rank inside the tile
    int seen = 0;  // the thread's nonzero words before this one
#pragma unroll 1
    for (int j = 0; j < TRI_STEPS; ++j) {
      const int f = 16 * (j % 4);
      const u64 exj = j < 4 ? ex[0] : ex[1], totj = j < 4 ? tot[0] : tot[1];
      i64 r = rank + static_cast<i64>((exj >> f) & 0xFFFFu);
      rank += static_cast<i64>((totj >> f) & 0xFFFFu);
      if (((mask >> (4 * j)) & 0xFu) == 0u) continue;
      const i64 i = base + 4 * (j * THREADS + threadIdx.x);
      for (int q = 0; q < 4; ++q) {
        if (((mask >> (4 * j + q)) & 1u) == 0u) continue;
        const i64 g = i + q;
        uint32_t bits = seen == 0   ? s0
                        : seen == 1 ? s1
                                    : static_cast<uint32_t>(chg[g]);
        const uint32_t nv = seen == 0   ? n0
                            : seen == 1 ? n1
                                        : static_cast<uint32_t>(nw[g]);
        ++seen;
        const int pc = __popc(bits);
        if (direct ? r + pc > TRI_STAGE && excl + r < cap : r < TRI_STAGE) {
          const i64 obs = g / w;
          const i64 col = g - obs * w;
          for (i64 o = r; bits != 0u; ++o) {
            const int k = __ffs(bits) - 1;
            bits &= bits - 1u;
            int32_t* out;
            if (direct) {
              if (o < TRI_STAGE) continue;
              if (excl + o >= cap) break;
              out = tri + 3 * (excl + o);
            } else {
              if (o >= TRI_STAGE) break;
              out = staged + 3 * o;
            }
            out[0] = static_cast<int32_t>(obs);
            out[1] = static_cast<int32_t>(k * w + col);
            out[2] = static_cast<int32_t>((nv >> k) & 1u);
          }
        }
        r += pc;
      }
    }
  };
  if (mask != 0u) make(false, 0);
  const i64 excl = static_cast<i64>(place(status, t, agg));
  if (threadIdx.x == 0 && t == tiles - 1) *count = excl + agg;
  if (excl >= cap) return;  // the whole block
  const i64 lim = 3 * imin(imin(agg, TRI_STAGE), cap - excl);
  for (i64 i = threadIdx.x; i < lim; i += THREADS) tri[3 * excl + i] = staged[i];
  if (agg > TRI_STAGE && mask != 0u) make(true, excl);
}

// ---- extract_chunks -------------------------------------------------------

// Block b: rows [b*span, (b+1)*span), one warp a row: row_cnt[r] = the
// row's nonzero words; dirty[b] = its dirty rows, mx[b] = its largest
// count.  VEC: words 16-byte aligned and lanes % 4 == 0.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    chunk_count(const int32_t* __restrict__ words, i64 nc, int lanes,
                i64 span, int32_t* __restrict__ row_cnt,
                i64* __restrict__ dirty, i64* __restrict__ mx) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const i64 start = static_cast<i64>(blockIdx.x) * span;
  const i64 end = imin(start + span, nc);
  i64 nd = 0, m = 0;
  for (i64 r = start + warp; r < end; r += WARPS) {
    const int32_t* row = words + r * lanes;
    int c = 0;
    if (VEC) {
      const int4* row4 = reinterpret_cast<const int4*>(row);
      for (int q = lane; q < lanes / 4; q += 32) {
        const int4 x = row4[q];
        c += (x.x != 0) + (x.y != 0) + (x.z != 0) + (x.w != 0);
      }
    } else {
      for (int q = lane; q < lanes; q += 32) c += row[q] != 0;
    }
    c = __reduce_add_sync(FULL, c);
    if (lane == 0) {
      row_cnt[r] = c;
      nd += c > 0;
      m = imax(m, c);
    }
  }
  i64 tot;
  block_exclusive(nd, &tot);
  m = block_max(m);
  if (threadIdx.x == 0) {
    dirty[blockIdx.x] = tot;
    mx[blockIdx.x] = m;
  }
}

// Block b ranks its dirty rows from offs[b] on: rank < cap gets
// csel[rank] = the row, ccnt[rank] = its count.
__global__ void __launch_bounds__(THREADS)
    chunk_select(const int32_t* __restrict__ row_cnt, i64 nc, i64 span,
                 i64 cap, const i64* __restrict__ offs,
                 int32_t* __restrict__ csel, int32_t* __restrict__ ccnt) {
  i64 off = offs[blockIdx.x];
  if (off >= cap) return;
  const i64 start = static_cast<i64>(blockIdx.x) * span;
  const i64 end = imin(start + span, nc);
  for (i64 t = start; t < end; t += THREADS) {
    const i64 r = t + threadIdx.x;
    const int c = r < end ? row_cnt[r] : 0;
    i64 tot;
    const i64 rank = off + block_exclusive(static_cast<i64>(c > 0), &tot);
    if (c > 0 && rank < cap) {
      csel[rank] = static_cast<int32_t>(r);
      ccnt[rank] = c;
    }
    off += tot;
    if (off >= cap) break;
  }
}

// One warp an output chunk c < cap: a kept chunk (c < min(n_dirty, cap))
// gathers the first kk nonzero words of row csel[c] in lane order; the
// rest of its slots, and every slot of a chunk past the kept ones, take
// the fills (vals 0, lane -1, aux 0; csel and ccnt 0 past the kept).
// Block 0 also narrows the two exact scalars to int32.
__global__ void __launch_bounds__(THREADS)
    chunk_gather(const int32_t* __restrict__ words,
                 const int32_t* __restrict__ aux, int lanes, i64 cap, int kk,
                 const i64* __restrict__ totals, int32_t* __restrict__ csel,
                 int32_t* __restrict__ ccnt, int32_t* __restrict__ vals,
                 int32_t* __restrict__ aux_vals,
                 int32_t* __restrict__ lane_out,
                 int32_t* __restrict__ scalars) {
  const int lane = threadIdx.x & 31;
  const i64 kept = imin(totals[0], cap);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    scalars[0] = static_cast<int32_t>(totals[0]);
    scalars[1] = static_cast<int32_t>(totals[1]);
  }
  const i64 step = static_cast<i64>(gridDim.x) * WARPS;
  for (i64 c = static_cast<i64>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
       c < cap; c += step) {
    int32_t* v = vals + c * kk;
    int32_t* l = lane_out + c * kk;
    int32_t* a = aux_vals != nullptr ? aux_vals + c * kk : nullptr;
    int filled = 0;
    if (c < kept) {
      const i64 r = csel[c];
      const int32_t* row = words + r * lanes;
      int base = 0;
      for (int p = 0; p < lanes && base < kk; p += 32) {
        const int q = p + lane;
        const int32_t x = q < lanes ? row[q] : 0;
        const unsigned m = __ballot_sync(FULL, x != 0);
        const int pos = base + __popc(m & ((1u << lane) - 1u));
        if (x != 0 && pos < kk) {
          v[pos] = x;
          l[pos] = q;
          if (a != nullptr) a[pos] = aux[r * lanes + q];
        }
        base += __popc(m);
      }
      filled = base < kk ? base : kk;
    } else if (lane == 0) {
      csel[c] = 0;
      ccnt[c] = 0;
    }
    for (int s = filled + lane; s < kk; s += 32) {
      v[s] = 0;
      l[s] = -1;
      if (a != nullptr) a[s] = 0;
    }
  }
}

// ---- encode_row_stream ----------------------------------------------------

struct Rows {
  const int32_t* vals;  // [mr, k]
  const int32_t* nv;    // [mr, k]
  const int32_t* widx;  // [mr, k]
  const int32_t* rsel;  // [mr]
  const int32_t* rcnt;  // [mr]
  i64 mr;
  int k;
  int w;
};

__device__ __forceinline__ int row_valid(int rc, int k) {
  return rc <= 0 ? 0 : (rc < k ? rc : k);
}

// A tile's two counts in one status value: the escapes at bit 31, the
// exceptions below it (each total < 2^31: mr * k <= INT32_MAX).
constexpr int ESC_SHIFT = 31;
constexpr u64 EXC_MASK = (1ull << ESC_SHIFT) - 1u;

// Tile t (by ticket) of ENC_TILE rows, ENC_RPT neighbouring rows a thread
// (rows in thread order, so one block exclusive over the threads' counts
// ranks the tile's escapes and exceptions in row-major order).  Only a
// row's first two slots decide its count (every valid slot past them is
// an exception), so the tile's row words, then those two slots of its
// rows, are loaded at once: two round trips.  The kept escapes and the
// exceptions in the first two slots go out from registers once the
// look-back has placed the tile; a later slot is read when it is written.
__global__ void __launch_bounds__(THREADS)
    enc_pass(Rows e, int ns, int woff16, i64 max_gaps, i64 max_exc,
             i64 tiles, uint8_t* __restrict__ rowb,
             uint8_t* __restrict__ bitpos, void* __restrict__ woff,
             int32_t* __restrict__ esc_rows, int32_t* __restrict__ exc_gidx,
             int32_t* __restrict__ exc_chg, int32_t* __restrict__ exc_new,
             int32_t* __restrict__ scalars, u64* __restrict__ status) {
  const i64 t = take_ticket(status + tiles);
  const i64 r0 = t * ENC_TILE + static_cast<i64>(threadIdx.x) * ENC_RPT;
  int nvalid[ENC_RPT];
  uint32_t cur[ENC_RPT];
  bool esc[ENC_RPT];
  {
    int rc[ENC_RPT];
#pragma unroll
    for (int j = 0; j < ENC_RPT; ++j) {
      const bool in = r0 + j < e.mr;
      rc[j] = in ? __ldg(e.rcnt + r0 + j) : 0;
      cur[j] = in ? static_cast<uint32_t>(__ldg(e.rsel + r0 + j)) : 0u;
    }
    uint32_t prv = r0 < e.mr ? static_cast<uint32_t>(
                                   __ldg(e.rsel + (r0 == 0 ? 0 : r0 - 1)))
                             : 0u;
#pragma unroll
    for (int j = 0; j < ENC_RPT; ++j) {
      const i64 r = r0 + j;
      nvalid[j] = row_valid(rc[j], e.k);
      const int rd = static_cast<int>(cur[j] - prv);
      prv = cur[j];
      esc[j] = rc[j] > 0 && rd >= 63;
      if (r < e.mr) {
        const int nv2 = (rc[j] < 1 ? 1 : (rc[j] > 2 ? 2 : rc[j])) - 1;
        rowb[r] = rc[j] > 0 ? static_cast<uint8_t>(
                                  ((esc[j] ? 63 : rd) | (nv2 << 6)) & 0xFF)
                            : static_cast<uint8_t>(0);
      }
    }
  }
  uint32_t x[ENC_RPT][2], nx[ENC_RPT][2];
  int32_t wi[ENC_RPT][2];
#pragma unroll
  for (int j = 0; j < ENC_RPT; ++j)
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const i64 at = (r0 + j) * e.k + s;
      const bool valid = s < nvalid[j];
      x[j][s] = valid ? static_cast<uint32_t>(__ldg(e.vals + at)) : 0u;
      nx[j][s] = valid ? static_cast<uint32_t>(__ldg(e.nv + at)) : 0u;
      wi[j][s] = valid ? __ldg(e.widx + at) : 0;
    }
  u64 mine = 0;  // the thread's escapes << ESC_SHIFT | exceptions
#pragma unroll
  for (int j = 0; j < ENC_RPT; ++j) {
    const i64 r = r0 + j;
    int nexc = nvalid[j] > 2 ? nvalid[j] - 2 : 0;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const bool valid = s < nvalid[j];
      nexc += valid && __popc(x[j][s]) > 1;
      if (r < e.mr && s < ns) {
        uint8_t bp = 255;
        if (valid && __popc(x[j][s]) == 1) {
          const int ctz = __ffs(x[j][s]) - 1;
          bp = static_cast<uint8_t>(ctz | (((nx[j][s] >> ctz) & 1u) << 5));
        }
        bitpos[r * ns + s] = bp;
        const uint32_t wo = static_cast<uint32_t>(wi[j][s]);
        if (woff16)
          static_cast<uint16_t*>(woff)[r * ns + s] = static_cast<uint16_t>(wo);
        else
          static_cast<uint8_t*>(woff)[r * ns + s] = static_cast<uint8_t>(wo);
      }
    }
    mine += (static_cast<u64>(esc[j]) << ESC_SHIFT) + static_cast<u64>(nexc);
  }
  u64 agg;
  const u64 ahead = block_exclusive(mine, &agg);
  if (threadIdx.x == 0) publish(status, t, agg, t == 0 ? ST_PRE : ST_AGG);
  const u64 excl = place(status, t, agg);
  if (threadIdx.x == 0 && t == tiles - 1) {
    scalars[0] = static_cast<int32_t>((excl + agg) >> ESC_SHIFT);
    scalars[1] = static_cast<int32_t>((excl + agg) & EXC_MASK);
  }
  i64 oe = static_cast<i64>((excl + ahead) >> ESC_SHIFT);
  i64 ox = static_cast<i64>((excl + ahead) & EXC_MASK);
#pragma unroll
  for (int j = 0; j < ENC_RPT; ++j) {
    const i64 r = r0 + j;
    if (esc[j]) {
      if (oe < max_gaps) esc_rows[oe] = static_cast<int32_t>(cur[j]);
      ++oe;
    }
    const uint32_t rowbase = cur[j] * static_cast<uint32_t>(e.w);
    for (int s = 0; s < nvalid[j] && ox < max_exc; ++s) {
      uint32_t v, nv;
      int32_t w_;
      if (s < 2) {
        if (__popc(s == 0 ? x[j][0] : x[j][1]) <= 1) continue;
        v = s == 0 ? x[j][0] : x[j][1];
        nv = s == 0 ? nx[j][0] : nx[j][1];
        w_ = s == 0 ? wi[j][0] : wi[j][1];
      } else {
        const i64 at = r * e.k + s;
        v = static_cast<uint32_t>(__ldg(e.vals + at));
        nv = static_cast<uint32_t>(__ldg(e.nv + at));
        w_ = __ldg(e.widx + at);
      }
      exc_gidx[ox] = static_cast<int32_t>(
          rowbase + static_cast<uint32_t>(w_ > 0 ? w_ : 0));
      exc_chg[ox] = static_cast<int32_t>(v);
      exc_new[ox] = static_cast<int32_t>(nv);
      ++ox;
    }
  }
}

// The floor under every entry: one launch of an empty kernel.
__global__ void empty_kernel() {}

inline int err(cudaError_t e) { return static_cast<int>(e); }

inline bool plan_ok(i64 units, i64 span, i64 blocks, i64 tile) {
  return span >= tile && span % tile == 0 && blocks >= 1 &&
         blocks <= (1 << 20) && (blocks - 1) * span < (units > 0 ? units : 1) &&
         blocks * span >= units;
}

// A single pass's plan: the compiled tile, and one block a tile of the
// units (one tile for none).
inline bool tiles_ok(i64 units, i64 tile, i64 want, i64 tiles) {
  return tile == want && tiles >= 1 && tiles <= INT32_MAX &&
         tiles == (units > 0 ? (units + tile - 1) / tile : 1);
}

// cudaMemsetAsync on the stream, then cudaGetLastError().
inline cudaError_t fill(void* p, int byte, i64 bytes, cudaStream_t s) {
  const cudaError_t e =
      cudaMemsetAsync(p, byte, static_cast<size_t>(bytes), s);
  return e != cudaSuccess ? e : cudaGetLastError();
}

struct Fill {
  void* p;
  int byte;
  i64 bytes;
};

// The fills in order, one memset for each run of neighbours in memory
// with the same byte (a memset is a node of its own in a graph).
inline cudaError_t fill_runs(const Fill* f, int n, cudaStream_t s) {
  for (int i = 0; i < n;) {
    i64 bytes = f[i].bytes;
    int j = i + 1;
    while (j < n && f[j].byte == f[i].byte &&
           static_cast<char*>(f[j].p) == static_cast<char*>(f[i].p) + bytes)
      bytes += f[j++].bytes;
    const cudaError_t e = fill(f[i].p, f[i].byte, bytes, s);
    if (e != cudaSuccess) return e;
    i = j;
  }
  return cudaSuccess;
}

}  // namespace

// Every entry takes the launch plan of goworld_tpu_torch/ops/events_cuda.py
// (pure functions of the shapes and caps), its scratch from the wrapper
// (torch.empty: the graph's pool inside a capture), launches on `stream`
// and returns cudaGetLastError() after each launch or memset (0 =
// launched), cudaErrorInvalidValue on a bad plan.

// chg, nw: int32 [n]; tri: int32 [cap, 3]; count: int64 [1]; scratch:
// int64 [tiles + 1]: a status word a tile, then the ticket.  vec: chg is
// 16-byte aligned.  Memsets tri to -1 and the scratch to 0, then one
// kernel.
extern "C" int gw_extract_triples(const int32_t* chg, const int32_t* nw,
                                  int64_t n, int64_t w, int64_t cap,
                                  int64_t tile, int64_t tiles, int vec,
                                  int32_t* tri, int64_t* count,
                                  int64_t* scratch, void* stream) {
  if (n < 0 || w < 1 || cap < 1 || !tiles_ok(n, tile, TRI_TILE, tiles))
    return err(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* status = reinterpret_cast<u64*>(scratch);
  i64* total = reinterpret_cast<i64*>(count);
  cudaError_t e = fill(tri, 0xFF, 12 * cap, s);
  if (e != cudaSuccess) return err(e);
  if ((e = fill(status, 0, 8 * (tiles + 1), s)) != cudaSuccess) return err(e);
  const unsigned nb = static_cast<unsigned>(tiles);
  if (vec)
    tri_pass<true><<<nb, THREADS, 0, s>>>(chg, nw, n, w, cap, tiles, tri,
                                          total, status);
  else
    tri_pass<false><<<nb, THREADS, 0, s>>>(chg, nw, n, w, cap, tiles, tri,
                                           total, status);
  return err(cudaGetLastError());
}

// words: int32 [nc, lanes]; aux: the same (read where aux_vals is not
// null); outputs vals, aux_vals (null: no aux), lane: int32 [cap, kk]; csel, ccnt: int32
// [cap]; scalars: int32 [2] = (n_dirty, max_ccnt); row_cnt: int32
// [max(nc, 1)]; scratch: int64 [3 * blocks + 2].  vec: words 16-byte
// aligned and lanes % 4 == 0.
extern "C" int gw_extract_chunks(const int32_t* words, const int32_t* aux,
                                 int64_t nc, int64_t lanes, int64_t cap,
                                 int64_t kk, int64_t span, int64_t blocks,
                                 int64_t gather_blocks, int vec,
                                 int32_t* vals, int32_t* aux_vals,
                                 int32_t* lane, int32_t* csel, int32_t* ccnt,
                                 int32_t* scalars, int32_t* row_cnt,
                                 int64_t* scratch, void* stream) {
  if (nc < 0 || lanes < 1 || lanes > (1 << 20) || cap < 1 || kk < 1 ||
      kk > lanes || gather_blocks < 1 || !plan_ok(nc, span, blocks, THREADS))
    return err(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  i64* dirty = reinterpret_cast<i64*>(scratch);
  i64* mx = dirty + blocks;
  i64* offs = mx + blocks;
  i64* totals = offs + blocks;  // n_dirty, max_ccnt
  const unsigned nb = static_cast<unsigned>(blocks);
  const int ln = static_cast<int>(lanes);
  if (vec)
    chunk_count<true><<<nb, THREADS, 0, s>>>(words, nc, ln, span, row_cnt,
                                             dirty, mx);
  else
    chunk_count<false><<<nb, THREADS, 0, s>>>(words, nc, ln, span, row_cnt,
                                              dirty, mx);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return err(e);
  scan_counts<<<1, SCAN_THREADS, 0, s>>>(dirty, offs, totals,
                                         static_cast<int>(blocks));
  if ((e = cudaGetLastError()) != cudaSuccess) return err(e);
  max_counts<<<1, SCAN_THREADS, 0, s>>>(mx, totals + 1,
                                        static_cast<int>(blocks));
  if ((e = cudaGetLastError()) != cudaSuccess) return err(e);
  chunk_select<<<nb, THREADS, 0, s>>>(row_cnt, nc, span, cap, offs, csel,
                                      ccnt);
  if ((e = cudaGetLastError()) != cudaSuccess) return err(e);
  chunk_gather<<<static_cast<unsigned>(gather_blocks), THREADS, 0, s>>>(
      words, aux, ln, cap, static_cast<int>(kk), totals, csel, ccnt, vals,
      aux_vals, lane, scalars);
  return err(cudaGetLastError());
}

// vals, nv, widx: int32 [mr, k]; rsel, rcnt: int32 [mr]; rowb: uint8
// [mr]; bitpos: uint8 [mr, ns]; woff: uint8 (woff16 = 0) or uint16
// [mr, ns], ns = min(k, 2); esc_rows: int32 [max_gaps]; exc_gidx,
// exc_chg, exc_new: int32 [max_exc]; scalars: int32 [2] = (n_esc,
// exc_n); scratch: int64 [tiles + 1]: a status word a tile (its escapes
// and exceptions), then the ticket.  mr * k <= INT32_MAX.  Memsets the
// four lists to their fills and the scratch to 0, then one kernel.
extern "C" int gw_encode_row_stream(
    const int32_t* vals, const int32_t* nv, const int32_t* widx,
    const int32_t* rsel, const int32_t* rcnt, int64_t mr, int64_t k,
    int64_t w, int64_t max_gaps, int64_t max_exc, int64_t tile,
    int64_t tiles, int woff16, uint8_t* rowb, uint8_t* bitpos, void* woff,
    int32_t* esc_rows, int32_t* exc_gidx, int32_t* exc_chg,
    int32_t* exc_new, int32_t* scalars, int64_t* scratch, void* stream) {
  if (mr < 1 || k < 1 || k > (1 << 20) || mr * k > INT32_MAX || w < 1 ||
      w > INT32_MAX || max_gaps < 1 || max_exc < 1 ||
      !tiles_ok(mr, tile, ENC_TILE, tiles))
    return err(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* status = reinterpret_cast<u64*>(scratch);
  const Fill fills[] = {{status, 0, 8 * (tiles + 1)},
                        {exc_chg, 0, 4 * max_exc},
                        {exc_new, 0, 4 * max_exc},
                        {esc_rows, 0xFF, 4 * max_gaps},
                        {exc_gidx, 0xFF, 4 * max_exc}};
  cudaError_t er = fill_runs(fills, 5, s);
  if (er != cudaSuccess) return err(er);
  const Rows e{vals, nv, widx, rsel, rcnt, mr, static_cast<int>(k),
               static_cast<int>(w)};
  const int ns = k < 2 ? static_cast<int>(k) : 2;
  enc_pass<<<static_cast<unsigned>(tiles), THREADS, 0, s>>>(
      e, ns, woff16, max_gaps, max_exc, tiles, rowb, bitpos, woff, esc_rows,
      exc_gidx, exc_chg, exc_new, scalars, status);
  return err(cudaGetLastError());
}

// One empty kernel on `stream`: the launch floor the entries are read
// against (chip_smoke.py's launch_floor_ms).
extern "C" int gw_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return err(cudaGetLastError());
}
