// Event compaction for Hopper (sm_90a): the classified AOI diff into event
// triples, and the giant-capacity path's row-stream codec.  Three entries,
// each a count pass, a scan of the per-block counts and a write pass, so
// the order of every output is the reference's and nothing waits for the
// host: the kernels launch on the caller's stream, never synchronise,
// allocate or copy to the host, and every launch shape is a function of
// the shapes and caps alone (a CUDA graph can hold them).
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
//   kept triple; `new` is read only at the changed words.  The design
//   reads chg twice (count, then write), the write pass only in blocks
//   that hold a kept triple.  A block's words are ranked by an exclusive
//   prefix of their popcounts (warp shuffles, then across warps), four
//   words a thread from one 16-byte load; bits go out ascending.
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
//   Bound: it must read the valid slots of vals (and new at the inline
//   slots, widx at the shipped ones) and rsel, rcnt once, and write the
//   stream: about 0.01 ms at the path's caps.  One thread a row counts
//   its escape and exceptions and writes its inline bytes; the write
//   pass ranks rows by an exclusive prefix of those counts.
//
// Arithmetic follows the port's int32 tensors: differences and products
// wrap (computed unsigned), narrowing to int32 or a byte truncates, and
// bits come from unsigned words (the int32 >> is arithmetic).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

typedef long long i64;

constexpr int THREADS = 256;  // every kernel but the scans
constexpr int WARPS = THREADS / 32;
constexpr int SCAN_THREADS = 1024;
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

// ---- extract_triples ------------------------------------------------------

// Block b: the set bits of words [b*span, (b+1)*span) into sums[b].
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    tri_count(const int32_t* __restrict__ chg, i64 n, i64 span,
              i64* __restrict__ sums) {
  const i64 start = static_cast<i64>(blockIdx.x) * span;
  const i64 end = imin(start + span, n);
  i64 s = 0;
  for (i64 i = start + 4 * threadIdx.x; i < end; i += 4 * THREADS) {
    uint32_t v[4];
    load4<VEC>(chg, i, end, v);
    s += __popc(v[0]) + __popc(v[1]) + __popc(v[2]) + __popc(v[3]);
  }
  i64 tot;
  block_exclusive(s, &tot);
  if (threadIdx.x == 0) sums[blockIdx.x] = tot;
}

// Block b writes its triples from rank offs[b] on, while the rank is
// below cap, a tile of 4 * THREADS words at a time.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    tri_write(const int32_t* __restrict__ chg, const int32_t* __restrict__ nw,
              i64 n, i64 span, i64 w, i64 cap, const i64* __restrict__ sums,
              const i64* __restrict__ offs, int32_t* __restrict__ tri) {
  i64 off = offs[blockIdx.x];
  if (off >= cap || sums[blockIdx.x] == 0) return;  // the whole block
  const i64 start = static_cast<i64>(blockIdx.x) * span;
  const i64 end = imin(start + span, n);
  for (i64 t = start; t < end; t += 4 * THREADS) {
    const i64 i = t + 4 * threadIdx.x;
    uint32_t v[4];
    load4<VEC>(chg, i, end, v);
    const int s = __popc(v[0]) + __popc(v[1]) + __popc(v[2]) + __popc(v[3]);
    i64 tot;
    i64 rank = off + block_exclusive(static_cast<i64>(s), &tot);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t bits = v[q];
      if (bits != 0u && rank < cap) {
        const i64 g = i + q;
        const uint32_t nv = static_cast<uint32_t>(nw[g]);
        const i64 obs = g / w;
        const i64 col = g - obs * w;
        for (i64 r = rank; bits != 0u && r < cap; ++r) {
          const int k = __ffs(bits) - 1;
          int32_t* o = tri + 3 * r;
          o[0] = static_cast<int32_t>(obs);
          o[1] = static_cast<int32_t>(k * w + col);
          o[2] = static_cast<int32_t>((nv >> k) & 1u);
          bits &= bits - 1u;
        }
      }
      rank += __popc(v[q]);
    }
    off += tot;
    if (off >= cap) break;  // tot is the block's: every thread leaves
  }
}

// Rows [min(*total, cap), cap) of tri to -1.
__global__ void __launch_bounds__(THREADS)
    tri_fill(const i64* __restrict__ total, i64 cap,
             int32_t* __restrict__ tri) {
  const i64 step = static_cast<i64>(gridDim.x) * THREADS;
  for (i64 r = imin(*total, cap) + static_cast<i64>(blockIdx.x) * THREADS +
               threadIdx.x;
       r < cap; r += step) {
    tri[3 * r] = -1;
    tri[3 * r + 1] = -1;
    tri[3 * r + 2] = -1;
  }
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

// Row r's valid slots, its escape flag and its exception count.
__device__ __forceinline__ int row_valid(const Rows& e, i64 r) {
  const int rc = e.rcnt[r];
  return rc <= 0 ? 0 : (rc < e.k ? rc : e.k);
}

__device__ __forceinline__ int row_delta(const Rows& e, i64 r) {
  const uint32_t cur = static_cast<uint32_t>(e.rsel[r]);
  const uint32_t prev = static_cast<uint32_t>(e.rsel[r == 0 ? 0 : r - 1]);
  return static_cast<int>(cur - prev);
}

__device__ __forceinline__ bool is_exc(const Rows& e, i64 r, int s) {
  return s >= 2 || __popc(static_cast<uint32_t>(e.vals[r * e.k + s])) > 1;
}

__device__ __forceinline__ void row_counts(const Rows& e, i64 r, int* esc,
                                           int* nexc) {
  const int nvalid = row_valid(e, r);
  *esc = e.rcnt[r] > 0 && row_delta(e, r) >= 63;
  int x = nvalid > 2 ? nvalid - 2 : 0;  // slots past the inline two
  for (int s = 0; s < nvalid && s < 2; ++s) x += is_exc(e, r, s);
  *nexc = x;
}

// Block b: rows [b*span, (b+1)*span), a thread a row: the row byte, the
// inline slots (ns = min(k, 2) of them), and its escape and exception
// counts summed into sums[b] and sums[nb + b].
__global__ void __launch_bounds__(THREADS)
    enc_count(Rows e, i64 span, int nb, int ns, int woff16,
              uint8_t* __restrict__ rowb, uint8_t* __restrict__ bitpos,
              void* __restrict__ woff, i64* __restrict__ sums) {
  const i64 start = static_cast<i64>(blockIdx.x) * span;
  const i64 end = imin(start + span, e.mr);
  i64 n_esc = 0, n_exc = 0;
  for (i64 r = start + threadIdx.x; r < end; r += THREADS) {
    const int rc = e.rcnt[r];
    const int nvalid = row_valid(e, r);
    const int rd = row_delta(e, r);
    const bool has = rc > 0, esc = has && rd >= 63;
    const int nv2 = (rc < 1 ? 1 : (rc > 2 ? 2 : rc)) - 1;
    rowb[r] = has ? static_cast<uint8_t>(((esc ? 63 : rd) | (nv2 << 6)) &
                                         0xFF)
                  : static_cast<uint8_t>(0);
    for (int s = 0; s < ns; ++s) {
      const bool valid = s < nvalid;
      const uint32_t x = static_cast<uint32_t>(e.vals[r * e.k + s]);
      uint8_t bp = 255;
      if (valid && __popc(x) == 1) {
        const int ctz = __ffs(x) - 1;
        const uint32_t ent =
            (static_cast<uint32_t>(e.nv[r * e.k + s]) >> ctz) & 1u;
        bp = static_cast<uint8_t>(ctz | (ent << 5));
      }
      bitpos[r * ns + s] = bp;
      const uint32_t wo = valid ? static_cast<uint32_t>(e.widx[r * e.k + s])
                                : 0u;
      if (woff16)
        static_cast<uint16_t*>(woff)[r * ns + s] = static_cast<uint16_t>(wo);
      else
        static_cast<uint8_t*>(woff)[r * ns + s] = static_cast<uint8_t>(wo);
    }
    int esc_i, nexc;
    row_counts(e, r, &esc_i, &nexc);
    n_esc += esc_i;
    n_exc += nexc;
  }
  i64 tot_e, tot_x;
  block_exclusive(n_esc, &tot_e);
  block_exclusive(n_exc, &tot_x);
  if (threadIdx.x == 0) {
    sums[blockIdx.x] = tot_e;
    sums[nb + blockIdx.x] = tot_x;
  }
}

// Block b ranks its escaped rows from offs[b] and its exceptions from
// offs[nb + b] on, writing those below their caps.
__global__ void __launch_bounds__(THREADS)
    enc_write(Rows e, i64 span, int nb, i64 max_gaps, i64 max_exc,
              const i64* __restrict__ offs, int32_t* __restrict__ esc_rows,
              int32_t* __restrict__ exc_gidx, int32_t* __restrict__ exc_chg,
              int32_t* __restrict__ exc_new) {
  i64 off_e = offs[blockIdx.x], off_x = offs[nb + blockIdx.x];
  if (off_e >= max_gaps && off_x >= max_exc) return;
  const i64 start = static_cast<i64>(blockIdx.x) * span;
  const i64 end = imin(start + span, e.mr);
  for (i64 t = start; t < end; t += THREADS) {
    const i64 r = t + threadIdx.x;
    int esc = 0, nexc = 0;
    if (r < end) row_counts(e, r, &esc, &nexc);
    i64 tot_e, tot_x;
    const i64 re = off_e + block_exclusive(static_cast<i64>(esc), &tot_e);
    i64 rx = off_x + block_exclusive(static_cast<i64>(nexc), &tot_x);
    if (esc && re < max_gaps) esc_rows[re] = e.rsel[r];
    if (nexc > 0 && rx < max_exc) {
      const int nvalid = row_valid(e, r);
      const uint32_t rowbase =
          static_cast<uint32_t>(e.rsel[r]) * static_cast<uint32_t>(e.w);
      for (int s = 0; s < nvalid && rx < max_exc; ++s) {
        if (!is_exc(e, r, s)) continue;
        const int32_t wi = e.widx[r * e.k + s];
        exc_gidx[rx] = static_cast<int32_t>(
            rowbase + static_cast<uint32_t>(wi > 0 ? wi : 0));
        exc_chg[rx] = e.vals[r * e.k + s];
        exc_new[rx] = e.nv[r * e.k + s];
        ++rx;
      }
    }
    off_e += tot_e;
    off_x += tot_x;
    if (off_e >= max_gaps && off_x >= max_exc) break;
  }
}

// The lists' tails past the kept entries (-1 / 0) and the two exact
// scalars narrowed to int32.
__global__ void __launch_bounds__(THREADS)
    enc_fill(const i64* __restrict__ totals, i64 max_gaps, i64 max_exc,
             int32_t* __restrict__ esc_rows, int32_t* __restrict__ exc_gidx,
             int32_t* __restrict__ exc_chg, int32_t* __restrict__ exc_new,
             int32_t* __restrict__ scalars) {
  const i64 tid = static_cast<i64>(blockIdx.x) * THREADS + threadIdx.x;
  const i64 step = static_cast<i64>(gridDim.x) * THREADS;
  if (tid == 0) {
    scalars[0] = static_cast<int32_t>(totals[0]);
    scalars[1] = static_cast<int32_t>(totals[1]);
  }
  for (i64 i = imin(totals[0], max_gaps) + tid; i < max_gaps; i += step)
    esc_rows[i] = -1;
  for (i64 i = imin(totals[1], max_exc) + tid; i < max_exc; i += step) {
    exc_gidx[i] = -1;
    exc_chg[i] = 0;
    exc_new[i] = 0;
  }
}

inline int err(cudaError_t e) { return static_cast<int>(e); }

inline bool plan_ok(i64 units, i64 span, i64 blocks, i64 tile) {
  return span >= tile && span % tile == 0 && blocks >= 1 &&
         blocks <= (1 << 20) && (blocks - 1) * span < (units > 0 ? units : 1) &&
         blocks * span >= units;
}

}  // namespace

// Every entry takes the launch plan of goworld_tpu_torch/ops/events_cuda.py
// (span, blocks, fill blocks: pure functions of the shapes and caps), its
// scratch from the wrapper (torch.empty: the graph's pool inside a
// capture), launches on `stream` and returns cudaGetLastError() after
// each launch (0 = launched), cudaErrorInvalidValue on a bad plan.

// chg, nw: int32 [n]; tri: int32 [cap, 3]; count: int64 [1];
// scratch: int64 [2 * blocks].  vec: chg is 16-byte aligned.
extern "C" int gw_extract_triples(const int32_t* chg, const int32_t* nw,
                                  int64_t n, int64_t w, int64_t cap,
                                  int64_t span, int64_t blocks,
                                  int64_t fill_blocks, int vec, int32_t* tri,
                                  int64_t* count, int64_t* scratch,
                                  void* stream) {
  if (n < 0 || w < 1 || cap < 1 || fill_blocks < 1 ||
      !plan_ok(n, span, blocks, 4 * THREADS))
    return err(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  i64* sums = reinterpret_cast<i64*>(scratch);
  i64* offs = sums + blocks;
  i64* total = reinterpret_cast<i64*>(count);
  const unsigned nb = static_cast<unsigned>(blocks);
  if (vec)
    tri_count<true><<<nb, THREADS, 0, s>>>(chg, n, span, sums);
  else
    tri_count<false><<<nb, THREADS, 0, s>>>(chg, n, span, sums);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return err(e);
  scan_counts<<<1, SCAN_THREADS, 0, s>>>(sums, offs, total,
                                         static_cast<int>(blocks));
  if ((e = cudaGetLastError()) != cudaSuccess) return err(e);
  if (vec)
    tri_write<true><<<nb, THREADS, 0, s>>>(chg, nw, n, span, w, cap, sums,
                                           offs, tri);
  else
    tri_write<false><<<nb, THREADS, 0, s>>>(chg, nw, n, span, w, cap, sums,
                                            offs, tri);
  if ((e = cudaGetLastError()) != cudaSuccess) return err(e);
  tri_fill<<<static_cast<unsigned>(fill_blocks), THREADS, 0, s>>>(total, cap,
                                                                  tri);
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
// exc_n); scratch: int64 [4 * blocks + 2].
extern "C" int gw_encode_row_stream(
    const int32_t* vals, const int32_t* nv, const int32_t* widx,
    const int32_t* rsel, const int32_t* rcnt, int64_t mr, int64_t k,
    int64_t w, int64_t max_gaps, int64_t max_exc, int64_t span,
    int64_t blocks, int64_t fill_blocks, int woff16, uint8_t* rowb,
    uint8_t* bitpos, void* woff, int32_t* esc_rows, int32_t* exc_gidx,
    int32_t* exc_chg, int32_t* exc_new, int32_t* scalars, int64_t* scratch,
    void* stream) {
  if (mr < 1 || k < 1 || k > (1 << 20) || w < 1 || w > INT32_MAX ||
      max_gaps < 1 || max_exc < 1 || fill_blocks < 1 ||
      !plan_ok(mr, span, blocks, THREADS))
    return err(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  i64* sums = reinterpret_cast<i64*>(scratch);  // [2][blocks]
  i64* offs = sums + 2 * blocks;                // [2][blocks]
  i64* totals = offs + 2 * blocks;              // n_esc, exc_n
  const Rows e{vals, nv, widx, rsel, rcnt, mr, static_cast<int>(k),
               static_cast<int>(w)};
  const unsigned nb = static_cast<unsigned>(blocks);
  const int nbi = static_cast<int>(blocks);
  const int ns = k < 2 ? static_cast<int>(k) : 2;
  enc_count<<<nb, THREADS, 0, s>>>(e, span, nbi, ns, woff16, rowb, bitpos,
                                   woff, sums);
  cudaError_t er = cudaGetLastError();
  if (er != cudaSuccess) return err(er);
  scan_counts<<<2, SCAN_THREADS, 0, s>>>(sums, offs, totals, nbi);
  if ((er = cudaGetLastError()) != cudaSuccess) return err(er);
  enc_write<<<nb, THREADS, 0, s>>>(e, span, nbi, max_gaps, max_exc, offs,
                                   esc_rows, exc_gidx, exc_chg, exc_new);
  if ((er = cudaGetLastError()) != cudaSuccess) return err(er);
  enc_fill<<<static_cast<unsigned>(fill_blocks), THREADS, 0, s>>>(
      totals, max_gaps, max_exc, esc_rows, exc_gidx, exc_chg, exc_new,
      scalars);
  return err(cudaGetLastError());
}
