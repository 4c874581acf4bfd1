// The shared core of the session step (session_step.cu, record mode) and
// the session merge (session_merge.cu, segment mode): the chain
// assignment of hstream_tpu/engine/lattice.py:1298-1324
// _session_chain_slots, with the retire-and-shift of the arena in front
// (:1341-1346) and the arena fold and empty-slot fix-up behind it
// (:1350-1367, :1474-1498).
//
// The m = cap + nb entries are the old arena's slots followed by the
// batch's records (or segments). Entry i has a code, a start and an end:
//  * an arena slot is live when its code is a key code and t1 > close_cut
//    (compared BEFORE the shift); a live slot's times shift by -delta,
//    every other slot becomes the sentinel;
//  * a record is [ts, ts] under its code when its valid flag is set,
//    else the sentinel; a segment is [t0, t1] under its code.
// Codes outside [0, 2^22) count as the sentinel; the host's codes are
// below 2^22 (it compacts them there).
//
// Stages, all on the caller's stream, no host sync:
// 1. sort: an LSD radix sort, written here, of 64-bit keys (code << 32 |
//    start ^ 2^31) with each entry's index, 8 bits a pass, 7 passes (the
//    code needs 23 bits, the biased start 32). A pass is a histogram per
//    tile of 2048 entries, a scan per digit over the tiles, and a stable
//    scatter that ranks a tile's entries with __match_any_sync per warp.
//    The order among equal (code, start) does not matter: of a run of
//    equal starts only the first can break a chain (the others start at
//    or before the running end), and the chain's end is their max.
// 2. the segmented running max of `end` over the sorted entries, reset
//    at each code change: a block scan of (flag, max) pairs with the
//    reference's combine (fa | fb, fb ? mb : max(ma, mb)), which is
//    associative, then each block folds the totals of the blocks before
//    it as its carry (as decode.cu's prefix sum does).
// 3. breaks: a code change, or start > (running end before it) + gap in
//    the reference's int32 wrap-around arithmetic; chain ids are the
//    inclusive count of breaks minus one (a block count plus the carry
//    of the blocks before). An entry's slot is its chain id, or cap
//    (dropped) for the sentinel; it is written back to the entry's own
//    index (dest).
// 4. the fold into the fresh arena (the other of two preallocated
//    arenas): every plane is set to its identity, each surviving arena
//    row (and, in segment mode, each segment row) is folded into its
//    slot with atomics (min code and t0, max t1, add counts, sums and
//    histogram bins, min/max floats, max HLL registers); zero bins and
//    zero registers are skipped, which leaves the sums unchanged.
//    After the record scatter (session_step.cu) or the segment fold,
//    empty slots get t0 = t1 = 0.
//
// Bound on the H100: bytes. The fold writes the whole fresh arena and
// reads the old one (for BASELINE config 4 a 2^17 x 512 int32 histogram
// of 256 MiB each way); the sort moves 12 B per entry and pass.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>

#include "hs_kernels.h"
#include "record.cuh"

namespace hs {
namespace sess {
namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kScanBlock = 1024;
constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortItems = 8;
constexpr int kSortTile = kSortThreads * kSortItems;
constexpr int kDigits = 256;
constexpr int kSortPasses = 7;
constexpr int kFoldBlock = 256;

struct Run {
    int f;  // a code change at or before this entry (within the span)
    int m;  // the running max of end since the last code change
};

__device__ __forceinline__ Run comb(Run a, Run b) {
    return Run{a.f | b.f, b.f ? b.m : max(a.m, b.m)};
}

__device__ __forceinline__ int wrap_add(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
    return (int)((unsigned)a - (unsigned)b);
}

// where the scratch buffer's parts lie
struct Scratch {
    unsigned long long *keys[2];
    uint32_t *idx[2];
    int32_t *end;       // [m] per entry
    int32_t *runmax;    // [m] per sorted position
    int32_t *nbrk;      // [m] per sorted position: breaks so far in block
    int32_t *dest;      // [m] per entry: its slot, cap = dropped
    uint32_t *hist;     // [256, sort tiles]
    uint32_t *dtot;     // [256] per digit
    Run *agg;           // [scan blocks]
    int32_t *aggn;      // [scan blocks]
};

inline int64_t align256(int64_t b) { return (b + 255) & ~(int64_t)255; }

inline int64_t layout(int32_t cap, int32_t nb, char *base, Scratch *s) {
    const int64_t m = (int64_t)cap + nb;
    const int64_t tiles = (m + kSortTile - 1) / kSortTile;
    const int64_t blocks = (m + kScanBlock - 1) / kScanBlock;
    const int64_t sizes[] = {m * 8, m * 8, m * 4, m * 4, m * 4, m * 4,
                             m * 4, m * 4, kDigits * tiles * 4, kDigits * 4,
                             blocks * 8, blocks * 4};
    int64_t off = 0;
    void *at[12];
    for (int i = 0; i < 12; ++i) {
        at[i] = base == nullptr ? nullptr : base + off;
        off += align256(sizes[i] > 0 ? sizes[i] : 1);
    }
    if (s != nullptr) {
        s->keys[0] = (unsigned long long *)at[0];
        s->keys[1] = (unsigned long long *)at[1];
        s->idx[0] = (uint32_t *)at[2];
        s->idx[1] = (uint32_t *)at[3];
        s->end = (int32_t *)at[4];
        s->runmax = (int32_t *)at[5];
        s->nbrk = (int32_t *)at[6];
        s->dest = (int32_t *)at[7];
        s->hist = (uint32_t *)at[8];
        s->dtot = (uint32_t *)at[9];
        s->agg = (Run *)at[10];
        s->aggn = (int32_t *)at[11];
    }
    return off;
}

// entry i's code (the sentinel where it is not live), start and end
__device__ __forceinline__ void entry(const HsSessionArgs &a, int i, int &c,
                                      int &s, int &e) {
    if (i < a.cap) {
        const int code = a.code[i];
        const bool alive = code >= 0 && code < HS_SESSION_SENT &&
                           a.t1[i] > a.close_cut;
        c = alive ? code : HS_SESSION_SENT;
        s = alive ? wrap_sub(a.t0[i], a.delta) : 0;
        e = alive ? wrap_sub(a.t1[i], a.delta) : 0;
    } else {
        const int j = i - a.cap;
        const int code = a.b_code[j];
        const bool ok = code >= 0 && code < HS_SESSION_SENT &&
                        (a.b_flags == nullptr || (a.b_flags[j] & 1));
        c = ok ? code : HS_SESSION_SENT;
        s = a.b_t0[j];
        e = a.b_t1[j];
    }
}

// inclusive block-wide sum scan (blockDim.x a multiple of 32); `total`
// gets the block's sum on every thread
template <typename T>
__device__ T block_scan_add(T v, T *warp_tot, T &total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    for (int d = 1; d < 32; d <<= 1) {
        T o = __shfl_up_sync(kFull, v, d);
        if (lane >= d) v += o;
    }
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    if (warp == 0) {
        T t = lane < nw ? warp_tot[lane] : T(0);
        for (int d = 1; d < 32; d <<= 1) {
            T o = __shfl_up_sync(kFull, t, d);
            if (lane >= d) t += o;
        }
        if (lane < nw) warp_tot[lane] = t;
    }
    __syncthreads();
    T out = warp ? v + warp_tot[warp - 1] : v;
    total = warp_tot[nw - 1];
    __syncthreads();
    return out;
}

__device__ __forceinline__ Run shfl_up_run(Run v, int d) {
    return Run{__shfl_up_sync(kFull, v.f, d), __shfl_up_sync(kFull, v.m, d)};
}

// inclusive block-wide scan of Runs in thread order
__device__ Run block_scan_run(Run v, Run *warp_tot, Run &total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    for (int d = 1; d < 32; d <<= 1) {
        Run o = shfl_up_run(v, d);
        if (lane >= d) v = comb(o, v);
    }
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    if (warp == 0) {
        Run t = lane < nw ? warp_tot[lane] : Run{0, INT_MIN};
        for (int d = 1; d < 32; d <<= 1) {
            Run o = shfl_up_run(t, d);
            if (lane >= d) t = comb(o, t);
        }
        if (lane < nw) warp_tot[lane] = t;
    }
    __syncthreads();
    Run out = warp ? comb(warp_tot[warp - 1], v) : v;
    total = warp_tot[nw - 1];
    __syncthreads();
    return out;
}

// ---- 1. keys and the radix sort ---------------------------------------

__global__ void prep_kernel(const __grid_constant__ HsSessionArgs a,
                            Scratch s, int m) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    int c, st, e;
    entry(a, i, c, st, e);
    s.keys[0][i] = ((unsigned long long)(uint32_t)c << 32) |
                   (unsigned long long)((uint32_t)st ^ 0x80000000u);
    s.idx[0][i] = (uint32_t)i;
    s.end[i] = e;
}

__global__ void __launch_bounds__(kSortThreads)
radix_hist(const unsigned long long *keys, int m, int shift, uint32_t *hist,
           int tiles) {
    __shared__ uint32_t cnt[kDigits];
    for (int d = threadIdx.x; d < kDigits; d += kSortThreads) cnt[d] = 0;
    __syncthreads();
    const int64_t base = (int64_t)blockIdx.x * kSortTile;
    for (int k = 0; k < kSortItems; ++k) {
        const int64_t e = base + k * kSortThreads + threadIdx.x;
        if (e < m) atomicAdd(&cnt[(keys[e] >> shift) & 0xFF], 1u);
    }
    __syncthreads();
    for (int d = threadIdx.x; d < kDigits; d += kSortThreads)
        hist[(int64_t)d * tiles + blockIdx.x] = cnt[d];
}

// per digit (one block each): exclusive scan of its count over the tiles
__global__ void __launch_bounds__(kScanBlock)
radix_digit_scan(uint32_t *hist, uint32_t *dtot, int tiles) {
    __shared__ uint32_t warp_tot[32];
    uint32_t *h = hist + (int64_t)blockIdx.x * tiles;
    uint32_t carry = 0;
    for (int base = 0; base < tiles; base += kScanBlock) {
        const int i = base + threadIdx.x;
        const uint32_t x = i < tiles ? h[i] : 0u;
        uint32_t tot;
        const uint32_t incl = block_scan_add<uint32_t>(x, warp_tot, tot);
        if (i < tiles) h[i] = carry + incl - x;
        carry += tot;
    }
    if (threadIdx.x == 0) dtot[blockIdx.x] = carry;
}

// stable scatter of one tile: entry e goes to (entries of smaller digits)
// + (its digit's entries in earlier tiles) + (in earlier warps of this
// tile) + (earlier in its warp)
__global__ void __launch_bounds__(kSortThreads)
radix_scatter(const unsigned long long *kin, const uint32_t *vin,
              unsigned long long *kout, uint32_t *vout, int m, int shift,
              const uint32_t *hist, const uint32_t *dtot, int tiles) {
    static_assert(kSortThreads == kDigits, "one digit per thread");
    __shared__ uint32_t s_base[kDigits];
    __shared__ uint32_t s_cnt[kSortWarps][kDigits];
    __shared__ uint32_t warp_tot[32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    {
        const uint32_t t = dtot[threadIdx.x];
        uint32_t tot;
        const uint32_t incl = block_scan_add<uint32_t>(t, warp_tot, tot);
        s_base[threadIdx.x] =
            incl - t + hist[(int64_t)threadIdx.x * tiles + blockIdx.x];
    }
    for (int d = threadIdx.x; d < kSortWarps * kDigits; d += kSortThreads)
        (&s_cnt[0][0])[d] = 0;
    __syncthreads();
    const int64_t wbase =
        (int64_t)blockIdx.x * kSortTile + (int64_t)warp * 32 * kSortItems;
    const unsigned lt = (1u << lane) - 1u;
    unsigned long long key[kSortItems];
    uint32_t val[kSortItems];
    uint32_t rank[kSortItems];
#pragma unroll
    for (int r = 0; r < kSortItems; ++r) {
        const int64_t e = wbase + r * 32 + lane;
        const bool in = e < m;
        key[r] = in ? kin[e] : 0ull;
        val[r] = in ? vin[e] : 0u;
        const int d = in ? (int)((key[r] >> shift) & 0xFF) : kDigits;
        const unsigned peers = __match_any_sync(kFull, d);
        const uint32_t seen = in ? s_cnt[warp][d] : 0u;
        rank[r] = seen + __popc(peers & lt);
        __syncwarp();
        if (in && lane == __ffs(peers) - 1)
            s_cnt[warp][d] = seen + __popc(peers);
        __syncwarp();
    }
    __syncthreads();
    {
        const int d = threadIdx.x;
        uint32_t run = 0;
        for (int w = 0; w < kSortWarps; ++w) {
            const uint32_t c = s_cnt[w][d];
            s_cnt[w][d] = run;
            run += c;
        }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kSortItems; ++r) {
        const int64_t e = wbase + r * 32 + lane;
        if (e < m) {
            const int d = (int)((key[r] >> shift) & 0xFF);
            const uint32_t pos = s_base[d] + s_cnt[warp][d] + rank[r];
            kout[pos] = key[r];
            vout[pos] = val[r];
        }
    }
}

// ---- 2-3. the segmented scan and the chain ids --------------------------

__device__ __forceinline__ int code_of(unsigned long long key) {
    return (int)(key >> 32);
}

__device__ __forceinline__ int start_of(unsigned long long key) {
    return (int)((uint32_t)key ^ 0x80000000u);
}

__device__ __forceinline__ Run run_at(const unsigned long long *keys,
                                      const uint32_t *idx, const int32_t *end,
                                      int64_t p, int m) {
    if (p >= m) return Run{0, INT_MIN};
    const int nr = p == 0 || code_of(keys[p]) != code_of(keys[p - 1]);
    return Run{nr, end[idx[p]]};
}

__global__ void __launch_bounds__(kScanBlock)
scan_runs(const unsigned long long *keys, const uint32_t *idx,
          const int32_t *end, int m, Run *agg) {
    __shared__ Run warp_tot[32];
    const int64_t p = (int64_t)blockIdx.x * kScanBlock + threadIdx.x;
    Run tot;
    block_scan_run(run_at(keys, idx, end, p, m), warp_tot, tot);
    if (threadIdx.x == 0) agg[blockIdx.x] = tot;
}

__global__ void __launch_bounds__(kScanBlock)
scan_runmax(const unsigned long long *keys, const uint32_t *idx,
            const int32_t *end, int m, const Run *agg, int32_t *runmax) {
    __shared__ Run warp_tot[32];
    Run carry{0, INT_MIN};
    for (int base = 0; base < (int)blockIdx.x; base += kScanBlock) {
        const int j = base + threadIdx.x;
        Run tot;
        block_scan_run(j < (int)blockIdx.x ? agg[j] : Run{0, INT_MIN},
                       warp_tot, tot);
        carry = comb(carry, tot);
    }
    const int64_t p = (int64_t)blockIdx.x * kScanBlock + threadIdx.x;
    Run tot;
    const Run incl = block_scan_run(run_at(keys, idx, end, p, m), warp_tot,
                                    tot);
    if (p < m) runmax[p] = comb(carry, incl).m;
}

__global__ void __launch_bounds__(kScanBlock)
scan_breaks(const unsigned long long *keys, const int32_t *runmax, int m,
            int gap, int32_t *nbrk, int32_t *aggn) {
    __shared__ int32_t warp_tot[32];
    const int64_t p = (int64_t)blockIdx.x * kScanBlock + threadIdx.x;
    int brk = 0;
    if (p < m) {
        const unsigned long long k = keys[p];
        brk = p == 0 || code_of(k) != code_of(keys[p - 1]) ||
              start_of(k) > wrap_add(runmax[p - 1], gap);
    }
    int32_t tot;
    const int32_t incl = block_scan_add<int32_t>(brk, warp_tot, tot);
    if (p < m) nbrk[p] = incl;
    if (threadIdx.x == 0) aggn[blockIdx.x] = tot;
}

__global__ void __launch_bounds__(kScanBlock)
scan_dest(const unsigned long long *keys, const uint32_t *idx,
          const int32_t *nbrk, const int32_t *aggn, int m, int cap,
          int32_t *dest) {
    __shared__ int32_t warp_tot[32];
    int32_t carry = 0;
    for (int base = 0; base < (int)blockIdx.x; base += kScanBlock) {
        const int j = base + threadIdx.x;
        int32_t tot;
        block_scan_add<int32_t>(j < (int)blockIdx.x ? aggn[j] : 0, warp_tot,
                                tot);
        carry += tot;
    }
    const int64_t p = (int64_t)blockIdx.x * kScanBlock + threadIdx.x;
    if (p < m) {
        const bool live = code_of(keys[p]) < HS_SESSION_SENT;
        dest[idx[p]] = live ? carry + nbrk[p] - 1 : cap;
    }
}

// ---- 4. the fold into the fresh arena ----------------------------------

__device__ __forceinline__ uint32_t identity_bits(int kind) {
    if (kind == HS_AGG_MIN) return 0x7F800000u;  // +inf
    if (kind == HS_AGG_MAX) return 0xFF800000u;  // -inf
    return 0u;
}

// blockIdx.y == 0: code, t0, t1; 1 + q: plane q (and its _n)
__global__ void init_kernel(const __grid_constant__ HsSessionArgs a) {
    const int64_t step = (int64_t)gridDim.x * blockDim.x;
    const int64_t i0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (blockIdx.y == 0) {
        for (int64_t i = i0; i < a.cap; i += step) {
            a.out_code[i] = HS_SESSION_SENT;
            a.out_t0[i] = INT_MAX;
            a.out_t1[i] = HS_SESSION_NEG;
        }
        return;
    }
    const HsSessPlane &p = a.p[blockIdx.y - 1];
    const int64_t words = p.kind == HS_AGG_HLL
                              ? (int64_t)a.cap * p.width / 4
                              : (int64_t)a.cap * p.width;
    const uint32_t fill = identity_bits(p.kind);
    for (int64_t i = i0; i < words; i += step) ((uint32_t *)p.out)[i] = fill;
    if (p.out_n != nullptr)
        for (int64_t i = i0; i < a.cap; i += step) p.out_n[i] = 0;
}

// fold row `row` of a plane (the old arena's or the segments') into slot d
__device__ __forceinline__ void fold_row(const HsSessPlane &p,
                                         const void *src,
                                         const int32_t *src_n, int64_t row,
                                         int64_t d, int lane) {
    switch (p.kind) {
    case HS_AGG_HLL: {
        const int words = p.width >> 2;
        const uint32_t *s = (const uint32_t *)src + row * words;
        int8_t *o = (int8_t *)p.out + d * p.width;
        for (int w = lane; w < words; w += 32) {
            const uint32_t x = s[w];
            if (x == 0u) continue;
            for (int b = 0; b < 4; ++b) {
                const int r = (int)(int8_t)((x >> (8 * b)) & 0xFFu);
                if (r > 0) atomic_max_i8(o + 4 * w + b, r);
            }
        }
        return;
    }
    case HS_AGG_QUANT: {
        const int32_t *s = (const int32_t *)src + row * p.width;
        int32_t *o = (int32_t *)p.out + d * p.width;
        for (int b = lane; b < p.width; b += 32) {
            const int32_t h = s[b];
            if (h != 0) atomicAdd(o + b, h);
        }
        return;
    }
    default:
        break;
    }
    if (lane != 0) return;
    switch (p.kind) {
    case HS_AGG_COUNT_ALL:
    case HS_AGG_COUNT: {
        const int32_t v = ((const int32_t *)src)[row];
        if (v != 0) atomicAdd((int32_t *)p.out + d, v);
        break;
    }
    case HS_AGG_SUM:
        atomicAdd((float *)p.out + d, ((const float *)src)[row]);
        break;
    case HS_AGG_AVG: {
        atomicAdd((float *)p.out + d, ((const float *)src)[row]);
        const int32_t n = src_n[row];
        if (n != 0) atomicAdd(p.out_n + d, n);
        break;
    }
    case HS_AGG_MIN:
        atomic_min_float((float *)p.out + d, ((const float *)src)[row]);
        break;
    case HS_AGG_MAX:
        atomic_max_float((float *)p.out + d, ((const float *)src)[row]);
        break;
    default:
        break;
    }
}

// one warp per row: the old arena's rows (kSeg false) or the segments'
template <bool kSeg>
__global__ void __launch_bounds__(kFoldBlock)
fold_rows(const __grid_constant__ HsSessionArgs a, const int32_t *dest) {
    const int64_t row =
        ((int64_t)blockIdx.x * kFoldBlock + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (row >= (kSeg ? a.nb : a.cap)) return;
    const int i = (int)(kSeg ? a.cap + row : row);
    const int64_t d = dest[i];
    if (d >= a.cap) return;
    if (lane == 0) {
        int c, s, e;
        entry(a, i, c, s, e);
        atomicMin(a.out_code + d, c);
        atomicMin(a.out_t0 + d, s);
        atomicMax(a.out_t1 + d, e);
    }
    for (int q = 0; q < a.n_planes; ++q) {
        const HsSessPlane &p = a.p[q];
        fold_row(p, kSeg ? p.seg : p.src, kSeg ? p.seg_n : p.src_n, row, d,
                 lane);
    }
}

__global__ void fixup_kernel(int32_t *code, int32_t *t0, int32_t *t1,
                             int cap) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < cap && code[i] >= HS_SESSION_SENT) {
        t0[i] = 0;
        t1[i] = 0;
    }
}

inline unsigned blocks_for(int64_t n, int per) {
    return (unsigned)((n + per - 1) / per);
}

// stages 1-3, then the init and the old arena's fold of stage 4; the
// caller adds its batch and then fixup()
inline cudaError_t core(const HsSessionArgs &a, Scratch &s,
                        cudaStream_t st) {
    const int m = a.cap + a.nb;
    if (a.scratch == nullptr || a.n_planes > HS_MAX_AGGS || a.cap < 0 ||
        a.nb < 0 || m == 0)
        return cudaErrorInvalidValue;
    layout(a.cap, a.nb, (char *)a.scratch, &s);
    const int tiles = (int)blocks_for(m, kSortTile);
    const int blocks = (int)blocks_for(m, kScanBlock);
    prep_kernel<<<blocks_for(m, 256), 256, 0, st>>>(a, s, m);
    for (int pass = 0; pass < kSortPasses; ++pass) {
        const int in = pass & 1, shift = 8 * pass;
        radix_hist<<<tiles, kSortThreads, 0, st>>>(s.keys[in], m, shift,
                                                    s.hist, tiles);
        radix_digit_scan<<<kDigits, kScanBlock, 0, st>>>(s.hist, s.dtot,
                                                         tiles);
        radix_scatter<<<tiles, kSortThreads, 0, st>>>(
            s.keys[in], s.idx[in], s.keys[in ^ 1], s.idx[in ^ 1], m, shift,
            s.hist, s.dtot, tiles);
    }
    const unsigned long long *keys = s.keys[kSortPasses & 1];
    const uint32_t *idx = s.idx[kSortPasses & 1];
    scan_runs<<<blocks, kScanBlock, 0, st>>>(keys, idx, s.end, m, s.agg);
    scan_runmax<<<blocks, kScanBlock, 0, st>>>(keys, idx, s.end, m, s.agg,
                                               s.runmax);
    scan_breaks<<<blocks, kScanBlock, 0, st>>>(keys, s.runmax, m, a.gap,
                                               s.nbrk, s.aggn);
    scan_dest<<<blocks, kScanBlock, 0, st>>>(keys, idx, s.nbrk, s.aggn, m,
                                             a.cap, s.dest);
    int64_t most = a.cap;
    for (int q = 0; q < a.n_planes; ++q)
        most = std::max(most, (int64_t)a.cap * a.p[q].width);
    dim3 grid(std::min(blocks_for(most, 256), 132u * 16u), 1 + a.n_planes);
    init_kernel<<<grid, 256, 0, st>>>(a);
    if (a.cap > 0)
        fold_rows<false><<<blocks_for((int64_t)a.cap * 32, kFoldBlock),
                           kFoldBlock, 0, st>>>(a, s.dest);
    return cudaGetLastError();
}

inline cudaError_t fixup(const HsSessionArgs &a, cudaStream_t st) {
    if (a.cap > 0)
        fixup_kernel<<<blocks_for(a.cap, 256), 256, 0, st>>>(
            a.out_code, a.out_t0, a.out_t1, a.cap);
    return cudaGetLastError();
}

}  // namespace
}  // namespace sess
}  // namespace hs
