// The interval join's shared core: (code, ts) keys and searches, block
// scans, and the probe that the pack and feed modes of join_probe.cu
// share; join_insert.cu takes the keys and the warp search, and
// join_evict.cu the warp scan and the int32 wrap.
//
// The probe replaces hstream_tpu/engine/lattice.py:884-936 (_join_bounds
// and _join_match_arrays), which rank the batch's lower and upper query
// keys among the store entries with one tagged 3-key sort and expand
// the spans with a cumsum and a searchsorted. Here the store is known to
// be sorted by (code, ts) (every program that writes it keeps it so) and
// so is the batch (the host lexsorts it and pads it with (sentinel, 0)),
// so each valid record's bounds are counts:
//   lo = #entries with (code, ts) <  (qcode, max(ts - within, cutoff))
//   hi = #entries with (code, ts) <= (qcode, ts + within)
// (the tag 0 / tag 2 tie-breaks of the reference's sort), with ts -+
// within wrapping as int32 like jnp; cnt = max(hi - lo, 0). The matches
// come out in record order, then store order: match j belongs to record
// searchsorted(ccnt, j, 'right') (clipped to the last record), ccnt the
// inclusive scan of cnt.
//
// Bound on the H100: bytes. A probe reads the batch once and writes the
// match columns once (and lo, cnt, ccnt); the store's search paths are
// the keys of the store windows the tiles read.
//
// What held the first design back: two binary searches of the whole
// store per record (~22 dependent loads each), a binary search of ccnt
// for every one of the match_cap output positions, and four launches.
// Design (Green, McColl and Bader's merge path, 2012; moderngpu's
// load-balancing search):
//  * probe_window_kernel: each tile of 256 consecutive sorted records
//    gets its store window, from its first valid record's lower key to
//    its last one's upper key, by two warp searches (32 probes a step),
//    every tile's at once, so no tile waits out its searches in turn.
//  * probe_bounds_kernel: a tile a block (taken in order from a
//    ticket). Where its window holds at most window_cap entries the block
//    stages their keys in shared memory, each as one 64-bit number (one
//    load and one compare a search step), while it loads its records;
//    the records search there, else in that window of global memory; a
//    thread's two consecutive records each start from the bounds of the
//    one before (a few steps forward, then a binary search of the rest).
//    Where ts -+ within wraps int32 in the tile (the lower key is then
//    not monotone) or within < 0, the records search the whole store, as
//    before. The counts are scanned in the same launch: the block scan,
//    then the tile's offset, the sum of the counts its predecessors
//    published (lookback.cuh). It writes, per expansion tile, the first
//    record ending at or past its start (each record knows where it
//    ends in the merged sequence below); the last tile writes the total.
//  * probe_expand_kernel: the matches by a load-balancing search. The
//    merged sequence of the record ends (ccnt) and the match positions
//    0 .. min(total, match_cap) - 1, a record's end placed before match
//    j when ccnt <= j, is cut into tiles of 2048 items; a tile starts
//    from its split without a search, stages its slice of ccnt in shared
//    memory, and each thread walks 8 items of it, so every match finds
//    its record without a global search, and a record with many matches
//    spreads over tiles like any other. The matches' records go through
//    shared memory, so consecutive threads write consecutive positions.
//    Every block first writes its share of the positions past the
//    matches as the reference's clip (the last record, store entry 0,
//    not valid).
//
// Device functions in this header are `inline` (it is included by more
// than one translation unit); kernels have internal linkage.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>

#include "hs_kernels.h"
#include "lookback.cuh"

namespace hsjoin {

using hs::look_back;

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a - (uint32_t)b);
}

// (c, t) < (qc, qt), or <= with `inclusive`
__device__ __forceinline__ bool key_before(int32_t c, int32_t t, int32_t qc,
                                           int32_t qt, bool inclusive) {
    return c < qc || (c == qc && (inclusive ? t <= qt : t < qt));
}

// the batch entry j's key: padding and codes at or above the sentinel
// are keyed as the sentinel (the reference's bvalid mask)
__device__ __forceinline__ int32_t batch_code(const int32_t *bcode,
                                              int32_t j, int32_t n) {
    const int32_t c = bcode[j];
    return (j < n && c < HS_JOIN_SENT) ? c : HS_JOIN_SENT;
}

__device__ __forceinline__ uint32_t warp_incl_scan(uint32_t v) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const uint32_t u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
    }
    return v;
}

// inclusive scan over the block (all threads call it; blockDim.x a
// multiple of 32); *total gets the block's sum. smem: 32 words.
__device__ inline uint32_t block_incl_scan(uint32_t v, uint32_t *smem,
                                           uint32_t *total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    uint32_t x = warp_incl_scan(v);
    if (lane == 31) smem[warp] = x;
    __syncthreads();
    if (warp == 0) {
        uint32_t s = lane < nw ? smem[lane] : 0u;
        s = warp_incl_scan(s);
        if (lane < nw) smem[lane] = s;
    }
    __syncthreads();
    if (warp > 0) x += smem[warp - 1];
    *total = smem[nw - 1];
    __syncthreads();
    return x;
}



// the first index in [lo, hi) where pred is false, pred being true on a
// prefix of the range: one warp, 32 probes a step (all lanes call it;
// every lane gets the result)
template <class P>
__device__ __forceinline__ int64_t warp_partition(int64_t lo, int64_t hi,
                                                  P pred) {
    const int lane = threadIdx.x & 31;
    while (hi - lo > 32) {
        const int64_t probe = lo + (hi - lo) * (lane + 1) / 33;
        const unsigned m = __ballot_sync(0xFFFFFFFFu, pred(probe));
        const int k = __popc(m);  // the trues are a prefix of the probes
        const int64_t plo = __shfl_sync(0xFFFFFFFFu, probe, max(k - 1, 0));
        const int64_t phi = __shfl_sync(0xFFFFFFFFu, probe, min(k, 31));
        if (k > 0) lo = plo + 1;
        if (k < 32) hi = phi;
    }
    const int64_t probe = lo + lane;
    const unsigned m =
        __ballot_sync(0xFFFFFFFFu, probe < hi && pred(probe));
    return lo + __popc(m);
}

// ---- the probe ----------------------------------------------------------

// probe branches (HsJoinProbeArgs.branch): the store window staged in
// shared memory where it fits, else searched in global memory
// (HS_PROBE_AUTO); always the window in global memory; always the whole
// store (a tile where ts -+ within wraps takes this one)
constexpr int kBoundsThreads = 128;
constexpr int kBoundsPer = 2;
constexpr int kBoundsTile = kBoundsThreads * kBoundsPer;  // 256 records
constexpr int kWindowMin = 2048;  // store entries a tile stages (16 KB)
constexpr int kWindowMax = 8192;  // ... where the tiles are few (64 KB)
constexpr int kWindowTiles = 4;  // tiles a window_kernel block takes

// the store entries a tile stages: as many as leave room for every tile
// on the card at once (~200 KB of an SM's shared memory between the
// tiles it holds), from kWindowMin to kWindowMax. A small batch's few
// tiles take wider windows: its records each match more entries.
inline int32_t window_cap(int32_t tiles, int sms) {
    const int64_t per_sm = ((int64_t)tiles + sms - 1) / sms;
    const int64_t room = 200 * 1024 / std::max(per_sm, (int64_t)1) / 8;
    return (int32_t)std::min((int64_t)kWindowMax,
                             std::max((int64_t)kWindowMin,
                                      room & ~(int64_t)1023));
}
constexpr int kExpThreads = 256;
constexpr int kExpPer = 8;
constexpr int kExpTile = kExpThreads * kExpPer;  // 2048 merged items

// the probe's scratch, carved out of HsJoinProbeArgs.scratch
struct ProbeScratch {
    int32_t *lo;                  // [bcap]
    int32_t *cnt;                 // [bcap]
    int32_t *ccnt;                // [bcap] inclusive scan of cnt
    uint32_t *ticket;             // the bounds tiles' order
    uint64_t *status;             // [tiles] look-back words
    int32_t *window;              // [2 * tiles]: each tile's store window
    int32_t *split;               // [merge tiles + 1]: the first record
                                  // whose end is at or past t * kExpTile
    int32_t merge_tiles;          // expansion tiles at most
    int32_t *total;               // the match total (the last word)
};

__host__ __device__ inline int32_t bounds_tiles(int32_t bcap) {
    return (bcap + kBoundsTile - 1) / kBoundsTile;
}

// the expansion's tiles at most: min(total, match_cap) + n <= match_cap
// + bcap items
inline int32_t merge_tiles(int32_t bcap, int32_t match_cap) {
    return (int32_t)(((int64_t)match_cap + bcap + kExpTile - 1) / kExpTile);
}

// words: lo, cnt, ccnt, the ticket, padding to 8 bytes, the status
// words, the windows, the splits, then the total
inline size_t probe_scratch_words(int32_t bcap, int32_t match_cap) {
    const size_t head = 3 * (size_t)bcap + 1;
    return ((head + 1) & ~(size_t)1) + 4 * (size_t)bounds_tiles(bcap) +
           (size_t)merge_tiles(bcap, match_cap) + 1 + 1;
}

inline ProbeScratch probe_scratch(void *p, int32_t bcap, int32_t match_cap) {
    int32_t *w = (int32_t *)p;
    ProbeScratch s;
    s.lo = w;
    s.cnt = w + bcap;
    s.ccnt = w + 2 * (size_t)bcap;
    s.ticket = (uint32_t *)(w + 3 * (size_t)bcap);
    const size_t head = 3 * (size_t)bcap + 1;
    s.status = (uint64_t *)(w + ((head + 1) & ~(size_t)1));
    s.window = (int32_t *)(s.status + bounds_tiles(bcap));
    s.split = s.window + 2 * (size_t)bounds_tiles(bcap);
    s.merge_tiles = merge_tiles(bcap, match_cap);
    s.total = w + probe_scratch_words(bcap, match_cap) - 1;
    return s;
}

// store entries in [lo, hi) before (qc, qt), the keys at code/ts
// (global or shared memory), by binary search
__device__ __forceinline__ int32_t count_in(const int32_t *code,
                                            const int32_t *ts, int32_t lo,
                                            int32_t hi, int32_t qc,
                                            int32_t qt, bool inclusive) {
    while (lo < hi) {
        const int32_t mid = lo + ((hi - lo) >> 1);
        if (key_before(code[mid], ts[mid], qc, qt, inclusive)) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// a (code, ts) key as one unsigned 64-bit number in the same order (the
// code is non-negative; ts's sign bit flipped)
__device__ __forceinline__ uint64_t key64(int32_t code, int32_t ts) {
    return ((uint64_t)(uint32_t)code << 32) |
           (uint32_t)((uint32_t)ts ^ 0x80000000u);
}

// keys in [lo, hi) below q, of keys sorted ascending (a binary search
// with one 8-byte load and one compare a step)
__device__ __forceinline__ int32_t keys_below(const uint64_t *key,
                                              int32_t lo, int32_t hi,
                                              uint64_t q) {
    while (lo < hi) {
        const int32_t mid = lo + ((hi - lo) >> 1);
        const bool below = key[mid] < q;
        lo = below ? mid + 1 : lo;
        hi = below ? hi : mid;
    }
    return lo;
}

// as keys_below, the answer known to be at or past `from`
__device__ __forceinline__ int32_t keys_below_from(const uint64_t *key,
                                                   int32_t from, int32_t hi,
                                                   uint64_t q) {
    for (int k = 0; k < 4 && from < hi; ++k, ++from)
        if (key[from] >= q) return from;
    return keys_below(key, from, hi, q);
}

// as count_in, the answer known to be at or past `from`: a few steps
// forward from there (a record's bound from the one before it: the
// sorted records' bounds only grow), then a binary search of the rest
__device__ __forceinline__ int32_t count_from(const int32_t *code,
                                              const int32_t *ts, int32_t from,
                                              int32_t hi, int32_t qc,
                                              int32_t qt, bool inclusive) {
    for (int k = 0; k < 4 && from < hi; ++k, ++from)
        if (!key_before(code[from], ts[from], qc, qt, inclusive)) return from;
    return count_in(code, ts, from, hi, qc, qt, inclusive);
}

namespace {

// tile t's valid record nearest its first (`last`: its last) record, or
// -1: one warp, 32 records a step
__device__ __forceinline__ int32_t tile_end(const HsJoinProbeArgs &a,
                                            int32_t t, bool last) {
    const int lane = threadIdx.x & 31;
    const int32_t t0 = t * kBoundsTile;
    const int32_t t1 = min(t0 + kBoundsTile, a.bcap);
    for (int32_t c = 0; c < t1 - t0; c += 32) {
        const int32_t j = last ? t1 - 1 - c - lane : t0 + c + lane;
        const bool v = j >= t0 && j < a.n && a.batch[j] < HS_JOIN_SENT;
        const unsigned m = __ballot_sync(0xFFFFFFFFu, v);
        if (m) return last ? t1 - 1 - c - (__ffs(m) - 1)
                           : t0 + c + __ffs(m) - 1;
    }
    return -1;
}

// each tile's store window, before the bounds: warp 2k of a block the
// entries before tile t's first valid record's lower key, warp 2k + 1
// those up to its last one's upper key (32 probes a step, all tiles at
// once); [0, 0) for a tile without a valid record. It also zeroes the
// bounds kernel's ticket and each tile's look-back status word.
__global__ void __launch_bounds__(64 * kWindowTiles)
probe_window_kernel(const __grid_constant__ HsJoinProbeArgs a,
                    ProbeScratch s) {
    const int w = threadIdx.x >> 5;
    const int32_t t = blockIdx.x * kWindowTiles + (w >> 1);
    if (t >= bounds_tiles(a.bcap)) return;
    const bool upper = w & 1;
    if (threadIdx.x == 0 && blockIdx.x == 0) *s.ticket = 0u;
    if (!upper && (threadIdx.x & 31) == 0) s.status[t] = 0ull;
    const int32_t j = tile_end(a, t, upper);
    int32_t end = 0;
    if (j >= 0) {
        const int32_t qc = a.batch[j], ts = a.batch[a.bcap + j];
        const int32_t qt = upper ? wrap_add(ts, a.within)
                                 : max(wrap_sub(ts, a.within), a.cutoff);
        end = (int32_t)warp_partition(0, a.cap, [&](int64_t i) {
            return key_before(a.o_code[i], a.o_ts[i], qc, qt, upper);
        });
    }
    if ((threadIdx.x & 31) == 0) s.window[2 * t + upper] = end;
}

__global__ void __launch_bounds__(kBoundsThreads)
probe_bounds_kernel(const __grid_constant__ HsJoinProbeArgs a,
                    ProbeScratch s, int32_t window_cap) {
    extern __shared__ uint64_t s_key[];  // [window_cap] the window's keys
    __shared__ uint32_t s_scan[32];
    __shared__ long long s_look[32];
    __shared__ int s_tile;
    if (threadIdx.x == 0) s_tile = (int)atomicAdd(s.ticket, 1u);
    __syncthreads();
    const int tile = s_tile;
    const int32_t j0 = tile * kBoundsTile + threadIdx.x * kBoundsPer;
    // the window first, so its staging overlaps the records' loads (it
    // is not used where a key wraps)
    const int32_t w0 = s.window[2 * tile];
    const int32_t w1 = max(w0, s.window[2 * tile + 1]);
    const bool fits = a.branch == HS_PROBE_AUTO && w1 - w0 <= window_cap;
    if (fits) {
#pragma unroll 4
        for (int32_t i = threadIdx.x; i < w1 - w0; i += kBoundsThreads)
            s_key[i] = key64(a.o_code[w0 + i], a.o_ts[w0 + i]);
    }
    int32_t qc[kBoundsPer], lts[kBoundsPer], hts[kBoundsPer];
    bool valid[kBoundsPer];
    bool wraps = false, any = false;
#pragma unroll
    for (int k = 0; k < kBoundsPer; ++k) {
        const int32_t j = j0 + k;
        qc[k] = j < a.bcap ? a.batch[j] : HS_JOIN_SENT;
        const int32_t t = j < a.bcap ? a.batch[a.bcap + j] : 0;
        valid[k] = j < a.n && qc[k] < HS_JOIN_SENT;
        any |= valid[k];
        const int64_t lw = (int64_t)t - a.within, hw = (int64_t)t + a.within;
        wraps |= valid[k] && (lw < INT_MIN || lw > INT_MAX ||
                              hw < INT_MIN || hw > INT_MAX);
        lts[k] = max(wrap_sub(t, a.within), a.cutoff);
        hts[k] = wrap_add(t, a.within);
    }
    // the whole store where a key wraps (not monotone) or within < 0;
    // the barriers also complete the staging
    const bool whole = __syncthreads_or(wraps) || a.within < 0 ||
                       a.branch == HS_PROBE_WHOLE;
    const bool last = __syncthreads_or(any);  // a valid record
    const int32_t wl = whole ? 0 : w0, wh = whole ? a.cap : w1;
    const bool staged = !whole && last && fits;
    // a thread's records are consecutive and sorted: outside the whole
    // store branch each bound starts from the one before it
    int32_t lo_at = staged ? 0 : wl, hi_at = lo_at;
    const int32_t end = staged ? wh - wl : wh;
    bool first_rec = true;
    int32_t cnt[kBoundsPer];
    uint32_t mine = 0;
#pragma unroll
    for (int k = 0; k < kBoundsPer; ++k) {
        int32_t l = 0;
        cnt[k] = 0;
        if (valid[k]) {
            int32_t h;
            if (whole) {
                l = count_in(a.o_code, a.o_ts, 0, a.cap, qc[k], lts[k],
                             false);
                h = count_in(a.o_code, a.o_ts, 0, a.cap, qc[k], hts[k],
                             true);
            } else if (staged) {
                // keys below (qc, lts), and below (qc, hts) + 1
                const uint64_t ql = key64(qc[k], lts[k]);
                const uint64_t qh = key64(qc[k], hts[k]) + 1;
                lo_at = first_rec ? keys_below(s_key, lo_at, end, ql)
                                  : keys_below_from(s_key, lo_at, end, ql);
                hi_at = first_rec ? keys_below(s_key, hi_at, end, qh)
                                  : keys_below_from(s_key, hi_at, end, qh);
                l = wl + lo_at;
                h = wl + hi_at;
            } else {
                lo_at = first_rec
                    ? count_in(a.o_code, a.o_ts, lo_at, end, qc[k], lts[k],
                               false)
                    : count_from(a.o_code, a.o_ts, lo_at, end, qc[k],
                                 lts[k], false);
                hi_at = first_rec
                    ? count_in(a.o_code, a.o_ts, hi_at, end, qc[k], hts[k],
                               true)
                    : count_from(a.o_code, a.o_ts, hi_at, end, qc[k],
                                 hts[k], true);
                l = lo_at;
                h = hi_at;
            }
            first_rec = false;
            cnt[k] = max(h - l, 0);
        }
        if (j0 + k < a.bcap) {
            s.lo[j0 + k] = l;
            s.cnt[j0 + k] = cnt[k];
        }
        mine += (uint32_t)cnt[k];
    }
    uint32_t tot;
    const uint32_t incl = block_incl_scan(mine, s_scan, &tot);
    const long long off = look_back(s.status, tile, tot, s_look);
    uint32_t run = (uint32_t)off + incl - mine;
    // the expansion's splits: record j ends at e = j + ccnt[j] of the
    // merged sequence (record ends and matches), so it is the first
    // record ending at or past every tile boundary in (e - 1 - cnt, e]
    const int64_t nrec = min(a.n, a.bcap);
#pragma unroll
    for (int k = 0; k < kBoundsPer; ++k) {
        run += (uint32_t)cnt[k];
        const int32_t j = j0 + k;
        if (j < a.bcap) s.ccnt[j] = (int32_t)run;
        if (j < nrec) {
            const int64_t e = j + (int64_t)run, ep = e - 1 - cnt[k];
            for (int64_t t = ep < 0 ? 0 : ep / kExpTile + 1;
                 t <= e / kExpTile && t <= s.merge_tiles; ++t)
                s.split[t] = j;
        }
    }
    if (tile == (int)gridDim.x - 1) {  // the boundaries past record n
        const int64_t total = off + tot;
        if (threadIdx.x == 0) *s.total = (int32_t)total;
        const int64_t e = nrec - 1 + total;
        for (int64_t t = (e < 0 ? 0 : e / kExpTile + 1) + threadIdx.x;
             t <= s.merge_tiles; t += kBoundsThreads)
            s.split[t] = (int32_t)nrec;
    }
}

// the matches: tile b of the merged sequence (record ends, matches),
// after the block's share of the positions past the matches (the
// reference's clip), which every block writes first, a grid's stride
// apart. Emit is the mode's writer: emit(a, j, matched, record, store
// entry, total).
template <class Emit>
__global__ void __launch_bounds__(kExpThreads)
probe_expand_kernel(const __grid_constant__ HsJoinProbeArgs a,
                    ProbeScratch s, Emit emit) {
    __shared__ int32_t s_end[kExpTile];
    __shared__ int32_t s_rec[kExpTile];
    const int32_t total = *s.total;
    const int64_t mc = min((int64_t)total, (int64_t)a.match_cap);
    for (int64_t p = mc + (int64_t)blockIdx.x * kExpThreads + threadIdx.x;
         p < a.match_cap; p += (int64_t)gridDim.x * kExpThreads)
        emit(a, (int32_t)p, false, a.bcap - 1, 0, total);
    // the records past n (padding) hold no match: the merged sequence
    // stops at record n's end
    const int64_t nrec = min(a.n, a.bcap);
    const int64_t len = mc + nrec;
    const int64_t d0 = (int64_t)blockIdx.x * kExpTile;
    if (d0 >= len) return;
    const int64_t d1 = min(d0 + kExpTile, len);
    // record ends before diagonal d: the first record ending at or past
    // d (the bounds kernel's split), at least d - mc (the matches stop at
    // mc) and at most min(d, nrec)
    auto ends_before = [&](int64_t d, int64_t split) {
        return min(max(split, d - mc), min(d, nrec));
    };
    const int64_t r0 = ends_before(d0, s.split[blockIdx.x]);
    const int64_t r1 = d1 == len ? nrec
                                 : ends_before(d1, s.split[blockIdx.x + 1]);
    const int64_t m0 = d0 - r0, m1 = d1 - r1;
    const int na = (int)(r1 - r0), nb = (int)(m1 - m0);
    if (nb == 0) return;  // record ends only
    for (int i = threadIdx.x; i < na; i += kExpThreads)
        s_end[i] = s.ccnt[r0 + i];
    __syncthreads();
    const int dd = threadIdx.x * kExpPer;
    if (dd < na + nb) {
        // this thread's split of the tile: ends i before local diagonal dd
        int lo = max(0, dd - nb), hi = min(dd, na);
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (s_end[mid] <= m0 + (dd - 1 - mid)) lo = mid + 1;
            else hi = mid;
        }
        int i = lo, m = dd - lo;
        for (int k = 0; k < kExpPer && i + m < na + nb; ++k) {
            if (i < na && (m >= nb || s_end[i] <= m0 + m)) {
                ++i;  // record r0 + i - 1 ends here
                continue;
            }
            s_rec[m++] = (int32_t)(r0 + i);
        }
    }
    __syncthreads();
    for (int m = threadIdx.x; m < nb; m += kExpThreads) {
        const int32_t r = s_rec[m];
        const int32_t o = s.lo[r] + (int32_t)(m0 + m - (s.ccnt[r] - s.cnt[r]));
        emit(a, (int32_t)(m0 + m), true, r, min(max(o, 0), a.cap - 1),
             total);
    }
}

}  // namespace

}  // namespace hsjoin
