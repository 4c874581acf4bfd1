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
// What bounded the first design (BASELINE config 4: 2^17 slots with a
// 512-bin histogram, 2^20 records; 0.685 ms): an LSD radix sort of 64-bit
// keys (code << 32 | start ^ 2^31) in 7 passes of three launches each
// (histogram, digit scan, scatter), slower than torch.sort of the same
// keys although the keys fit the 50 MB L2, so launches and passes bound
// it; and the fresh arena (268 MB) written twice, by an identity fill and
// then by per-bin atomics of every live old row.
//
// Stages, all on the caller's stream, no host sync:
// 1. sort, narrowed and one-sweep:
//    * sort_range_kernel reduces the live entries' largest code and
//      smallest and largest start into per-block partials, and zeroes
//      the sort's histograms, tile status words and counters and the
//      per-slot feed counts;
//    * sort_keys_kernel reduces the partials (each block alike), builds
//      keys (code' << sbits) | (start - min start), where code' is the
//      code and the sentinel becomes the largest live code + 1 with start
//      bits 0, and sbits the width of the live starts' span (so the order
//      is the old key's signed (code, start) order, sentinels last, also
//      for starts on both sides of the int32 wrap); it counts the digits
//      of every 8-bit position of the key width (a warp's equal digits,
//      found with nine ballots, add once) into one global histogram per
//      position, and
//      marks the positions past the width as one bucket;
//    * sort_pass_kernel, launched for all 7 positions a 55-bit key can
//      have: a position whose histogram holds all m keys in one bucket
//      does nothing (a stable pass over one bucket is the identity), so a
//      device-side count of the passes that ran says which buffer holds
//      the keys. A running pass is one sweep: each block takes the next
//      tile of 4096 entries (16 a thread, in registers) by an atomic
//      counter, ranks them stably per warp (ballots, as above),
//      publishes its digit counts, finds its tiles' offsets by decoupled
//      look-back over the earlier tiles' status words (count and flag in
//      one word, 16 read at once: the resident tiles publish together,
//      so a walk can be long), and scatters through shared memory so
//      that each digit's run is written contiguously. A key's rank in
//      its warp rides in the key's unused top 9 bits, so three blocks fit
//      an SM and a pass over config 4's 288 tiles runs in one wave.
//      2 + 7 launches instead of 22, and the keys are read once a pass.
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
//    index (dest), and each slot counts the old arena rows it receives.
// 4. the fresh arena (the other of two preallocated arenas), written
//    once: init_copy_kernel gives each slot that exactly one old row
//    feeds that row (vectorised plain stores of the row folded into the
//    identities: sums 0 + x, MIN/MAX as the sign-split atomics leave
//    them, HLL registers max(r, 0), t1 max(t1, -2^30)) and each other
//    slot its identities; fold_shared_rows then folds, with atomics, only
//    the old rows of slots that several feed (min code and t0, max t1, add
//    counts, sums and histogram bins, min/max floats, max HLL registers;
//    zero bins and registers are skipped). After the record scatter
//    (session_step.cu) or the segment fold, empty slots get t0 = t1 = 0.
//
// Bound on the H100 now: bytes, the fresh arena written once and the live
// old rows read once (for config 4 a 2^17 x 512 int32 histogram, 256 MiB
// each way at most; init_copy_kernel moves them at ~2.6 TB/s); the sort's
// 12 B an entry a pass stay in the L2. Of config 4's step (0.485 ms
// against 0.685, PERF.md) the sort takes 0.17 ms (torch.sort of the same
// keys 0.18): ~24 µs a pass that runs (the tiles' look-back) and 0.044 ms
// for the keys and their histograms (~4.6 M shared-memory increments).
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
constexpr int kSortItems = 16;
constexpr int kSortTile = kSortThreads * kSortItems;
constexpr int kDigits = 256;
constexpr int kSortPasses = 7;       // 8-bit digits of a key of <= 55 bits
constexpr int kRangeBlocks = 1024;   // partials of sort_range_kernel
constexpr int kKeysThreads = 1024;   // sort_keys_kernel: a tile a block
constexpr int kKeyBits = 55;         // a key's width at most
constexpr unsigned long long kKeyMask = (1ull << kKeyBits) - 1;
constexpr int kFoldBlock = 256;
constexpr uint32_t kFlagAgg = 1u << 30;      // status: the tile's count
constexpr uint32_t kFlagPrefix = 2u << 30;   // status: inclusive prefix
constexpr uint32_t kCountMask = (1u << 30) - 1;
constexpr int kLookback = 16;                // status words read at once

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

// the sort's key format, written by sort_keys_kernel block 0, and the
// buffer the sorted keys end in, written by the last sort_pass_kernel
struct Meta {
    int32_t sbits;      // start bits of a key
    int32_t min_start;  // the live entries' smallest start
    int32_t sent;       // code' of the sentinel: largest live code + 1
    int32_t final_buf;  // 0 / 1: keys[final_buf] and idx[final_buf]
};

// where the scratch buffer's parts lie
struct Scratch {
    unsigned long long *keys[2];
    uint32_t *idx[2];
    int32_t *end;       // [m] per entry
    int32_t *runmax;    // [m] per sorted position
    int32_t *nbrk;      // [m] per sorted position: breaks so far in block
    int32_t *dest;      // [m] per entry: its slot, cap = dropped
    int4 *part;         // [kRangeBlocks] max code, min / max start
    Meta *meta;
    uint32_t *ghist;    // [kSortPasses, 256]      } zeroed by
    uint32_t *status;   // [kSortPasses, tiles, 256] } sort_range_kernel,
    uint32_t *tilectr;  // [kSortPasses]           } one span
    int32_t *feeds;     // [cap] old rows per slot }
    Run *agg;           // [scan blocks]
    int32_t *aggn;      // [scan blocks]
    int64_t zero_words; // 4-byte words from ghist to the end of feeds
};

inline int64_t align256(int64_t b) { return (b + 255) & ~(int64_t)255; }

inline int64_t layout(int32_t cap, int32_t nb, char *base, Scratch *s) {
    const int64_t m = (int64_t)cap + nb;
    const int64_t tiles = (m + kSortTile - 1) / kSortTile;
    const int64_t blocks = (m + kScanBlock - 1) / kScanBlock;
    constexpr int kParts = 14;
    const int64_t sizes[kParts] = {
        m * 8, m * 8, m * 4, m * 4, m * 4, m * 4, m * 4, m * 4,
        kRangeBlocks * 16, (int64_t)sizeof(Meta),
        kSortPasses * kDigits * 4, kSortPasses * tiles * kDigits * 4,
        kSortPasses * 4, (int64_t)cap * 4};
    int64_t off = 0;
    int64_t at[kParts + 2];
    for (int i = 0; i < kParts; ++i) {
        at[i] = off;
        off += align256(sizes[i] > 0 ? sizes[i] : 1);
    }
    const int64_t zero_end = off;
    at[kParts] = off;
    off += align256(blocks * 8);
    at[kParts + 1] = off;
    off += align256(blocks * 4);
    if (s != nullptr) {
        auto p = [&](int i) { return (void *)(base + at[i]); };
        s->keys[0] = (unsigned long long *)p(0);
        s->keys[1] = (unsigned long long *)p(1);
        s->idx[0] = (uint32_t *)p(2);
        s->idx[1] = (uint32_t *)p(3);
        s->end = (int32_t *)p(4);
        s->runmax = (int32_t *)p(5);
        s->nbrk = (int32_t *)p(6);
        s->dest = (int32_t *)p(7);
        s->part = (int4 *)p(8);
        s->meta = (Meta *)p(9);
        s->ghist = (uint32_t *)p(10);
        s->status = (uint32_t *)p(11);
        s->tilectr = (uint32_t *)p(12);
        s->feeds = (int32_t *)p(13);
        s->agg = (Run *)p(kParts);
        s->aggn = (int32_t *)p(kParts + 1);
        s->zero_words = (zero_end - at[10]) / 4;
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

// block-wide max code, min start, max start (x, y, z) over the threads
__device__ int4 block_range(int4 v, int4 *warp_part) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    for (int d = 16; d > 0; d >>= 1) {
        v.x = max(v.x, __shfl_down_sync(kFull, v.x, d));
        v.y = min(v.y, __shfl_down_sync(kFull, v.y, d));
        v.z = max(v.z, __shfl_down_sync(kFull, v.z, d));
    }
    if (lane == 0) warp_part[warp] = v;
    __syncthreads();
    int4 r = warp_part[0];
    for (int w = 1; w < nw; ++w) {
        const int4 o = warp_part[w];
        r.x = max(r.x, o.x);
        r.y = min(r.y, o.y);
        r.z = max(r.z, o.z);
    }
    __syncthreads();
    return r;
}

__device__ __forceinline__ int4 no_range() {
    return make_int4(-1, INT_MAX, INT_MIN, 0);
}

// ---- 1. the narrowed keys and the one-sweep radix sort ----------------

// the lanes of the warp whose digit d (0..255, or kDigits for a lane
// with no entry) equals this lane's: nine ballots, one a bit, which is
// cheaper than __match_any_sync
__device__ __forceinline__ unsigned match_digit(int d) {
    unsigned m = kFull;
#pragma unroll
    for (int b = 0; b < 9; ++b) {
        const unsigned bb = __ballot_sync(kFull, (d >> b) & 1);
        m &= ((d >> b) & 1) ? bb : ~bb;
    }
    return m;
}

__global__ void __launch_bounds__(256)
sort_range_kernel(const __grid_constant__ HsSessionArgs a, Scratch s,
                  int m) {
    __shared__ int4 warp_part[8];  // 256 threads
    const int64_t step = (int64_t)gridDim.x * blockDim.x;
    const int64_t i0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    uint4 *z = (uint4 *)s.ghist;
    for (int64_t w = i0; w < s.zero_words / 4; w += step)
        z[w] = make_uint4(0u, 0u, 0u, 0u);
    int4 r = no_range();
    for (int64_t i = i0; i < m; i += step) {
        int c, st, e;
        entry(a, (int)i, c, st, e);
        if (c < HS_SESSION_SENT) {
            r.x = max(r.x, c);
            r.y = min(r.y, st);
            r.z = max(r.z, st);
        }
    }
    r = block_range(r, warp_part);
    if (threadIdx.x == 0) s.part[blockIdx.x] = r;
}

__device__ __forceinline__ int bit_width(uint32_t x) {
    return x == 0u ? 0 : 32 - __clz((int)x);
}

__device__ __forceinline__ unsigned long long make_key(int c, int st,
                                                       const Meta &k) {
    if (c >= HS_SESSION_SENT)
        return (unsigned long long)(uint32_t)k.sent << k.sbits;
    return ((unsigned long long)(uint32_t)c << k.sbits) |
           (unsigned long long)((uint32_t)st - (uint32_t)k.min_start);
}

__global__ void __launch_bounds__(kKeysThreads)
sort_keys_kernel(const __grid_constant__ HsSessionArgs a, Scratch s, int m,
                 int n_parts) {
    __shared__ int4 warp_part[kKeysThreads / 32];
    __shared__ uint32_t cnt[kSortPasses][kDigits];
    const int lane = threadIdx.x & 31;
    int4 r = no_range();
    for (int p = threadIdx.x; p < n_parts; p += kKeysThreads) {
        const int4 o = s.part[p];
        r.x = max(r.x, o.x);
        r.y = min(r.y, o.y);
        r.z = max(r.z, o.z);
    }
    r = block_range(r, warp_part);
    Meta k;
    k.sent = r.x + 1;
    k.min_start = r.x < 0 ? 0 : r.y;
    k.sbits = r.x < 0 ? 0
                      : bit_width((uint32_t)r.z - (uint32_t)r.y);
    k.final_buf = 0;
    const int width = bit_width((uint32_t)k.sent) + k.sbits;
    const int npos = (width + 7) / 8;
    if (blockIdx.x == 0) {
        if (threadIdx.x == 0) *s.meta = k;
        // the positions past the key width: all m keys in bucket 0
        if (threadIdx.x >= npos && threadIdx.x < kSortPasses)
            s.ghist[threadIdx.x * kDigits] = (uint32_t)m;
    }
    for (int d = threadIdx.x; d < kSortPasses * kDigits; d += kKeysThreads)
        (&cnt[0][0])[d] = 0u;
    __syncthreads();
    const int64_t base = (int64_t)blockIdx.x * kSortTile;
    for (int it = 0; it < kSortTile / kKeysThreads; ++it) {
        const int64_t i = base + it * kKeysThreads + threadIdx.x;
        const bool in = i < m;
        unsigned long long key = 0ull;
        if (in) {
            int c, st, e;
            entry(a, (int)i, c, st, e);
            key = make_key(c, st, k);
            s.keys[0][i] = key;
            s.idx[0][i] = (uint32_t)i;
            s.end[i] = e;
        }
        for (int p = 0; p < npos; ++p) {
            const int d = in ? (int)((key >> (8 * p)) & 0xFF) : kDigits;
            const unsigned peers = match_digit(d);
            if (in && lane == __ffs(peers) - 1)
                atomicAdd(&cnt[p][d], (uint32_t)__popc(peers));
        }
    }
    __syncthreads();
    // each block starts at its own bin, so that the blocks' atomics on
    // one bin do not arrive together
    const int nd = npos * kDigits;
    const int rot = nd > 0 ? (int)((blockIdx.x * 131ll) % nd) : 0;
    for (int i = threadIdx.x; i < nd; i += kKeysThreads) {
        const int d = i + rot < nd ? i + rot : i + rot - nd;
        const uint32_t c = (&cnt[0][0])[d];
        if (c != 0u) atomicAdd(&s.ghist[d], c);
    }
}

__device__ __forceinline__ uint32_t load_volatile(const uint32_t *p) {
    return *(const volatile uint32_t *)p;
}

__device__ __forceinline__ void store_volatile(uint32_t *p, uint32_t v) {
    *(volatile uint32_t *)p = v;
}

struct PassSmem {
    unsigned long long keys[kSortTile];
    uint32_t idx[kSortTile];
    uint32_t wcnt[kSortWarps][kDigits];  // per warp, then warp offsets
    uint32_t lstart[kDigits];            // the tile's first of a digit
    uint32_t gofs[kDigits];              // output position - local one
    uint32_t warp_tot[32];
    int tile;
};

constexpr size_t kPassSmem = sizeof(PassSmem);

// one stable pass of the LSD sort over digit position `pass`
__global__ void __launch_bounds__(kSortThreads, 3)
sort_pass_kernel(Scratch s, int m, int pass, int tiles) {
    static_assert(kSortThreads == kDigits, "one digit per thread");
    extern __shared__ unsigned char smem_raw[];
    PassSmem &sh = *(PassSmem *)smem_raw;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const uint32_t *hist = s.ghist + pass * kDigits;
    // which buffer holds the keys: one flip per earlier pass that ran
    int src = 0;
    bool run = false;
    for (int q = 0; q <= pass; ++q) {
        const bool one = __syncthreads_or(s.ghist[q * kDigits + tid] ==
                                          (uint32_t)m);
        if (q < pass)
            src ^= one ? 0 : 1;
        else
            run = !one;
    }
    if (pass == kSortPasses - 1 && blockIdx.x == 0 && tid == 0)
        s.meta->final_buf = src ^ (run ? 1 : 0);
    if (!run) return;
    if (tid == 0) sh.tile = (int)atomicAdd(&s.tilectr[pass], 1u);
    const unsigned long long *kin = s.keys[src];
    const uint32_t *vin = s.idx[src];
    unsigned long long *kout = s.keys[src ^ 1];
    uint32_t *vout = s.idx[src ^ 1];
    const int shift = 8 * pass;
    // this digit's first position over all m keys
    uint32_t tot;
    const uint32_t h = hist[tid];
    const uint32_t gbase = block_scan_add<uint32_t>(h, sh.warp_tot, tot) - h;
    for (int d = tid; d < kSortWarps * kDigits; d += kSortThreads)
        (&sh.wcnt[0][0])[d] = 0u;
    __syncthreads();
    const int tile = sh.tile;
    const int64_t tbase = (int64_t)tile * kSortTile;
    const int64_t wbase = tbase + (int64_t)warp * 32 * kSortItems;
    const unsigned lt = (1u << lane) - 1u;
    // each key with its rank in the warp's 512 entries in bits 55..63
    unsigned long long key[kSortItems];
    uint32_t val[kSortItems];
#pragma unroll
    for (int r = 0; r < kSortItems; ++r) {
        const int64_t e = wbase + r * 32 + lane;
        const bool in = e < m;
        key[r] = in ? kin[e] : 0ull;
        val[r] = in ? vin[e] : 0u;
        const int d = in ? (int)((key[r] >> shift) & 0xFF) : kDigits;
        const unsigned peers = match_digit(d);
        const uint32_t seen = in ? sh.wcnt[warp][d] : 0u;
        key[r] |= (unsigned long long)(seen + __popc(peers & lt))
                  << kKeyBits;
        __syncwarp();
        if (in && lane == __ffs(peers) - 1)
            sh.wcnt[warp][d] = seen + __popc(peers);
        __syncwarp();
    }
    __syncthreads();
    // per digit (thread tid): the tile's count, the warps' offsets
    uint32_t cnt = 0;
    for (int w = 0; w < kSortWarps; ++w) {
        const uint32_t c = sh.wcnt[w][tid];
        sh.wcnt[w][tid] = cnt;
        cnt += c;
    }
    uint32_t *status = s.status + (int64_t)pass * tiles * kDigits;
    if (tile == 0) {
        store_volatile(&status[tid], kFlagPrefix | cnt);
    } else {
        store_volatile(&status[(int64_t)tile * kDigits + tid],
                       kFlagAgg | cnt);
    }
    // decoupled look-back: the earlier tiles' count of this digit. The
    // resident tiles publish their counts at about the same moment, so
    // the walk back to a prefix can be long: read kLookback status words
    // at once, then take them in order up to a prefix or to a word not
    // yet published (read again from there)
    uint32_t excl = 0;
    for (int t = tile - 1; t >= 0;) {
        uint32_t v[kLookback];
#pragma unroll
        for (int u = 0; u < kLookback; ++u)
            v[u] = t - u >= 0 ? load_volatile(
                                    &status[(int64_t)(t - u) * kDigits + tid])
                              : kFlagPrefix;
        int u = 0;
        bool done = false;
#pragma unroll
        for (int k = 0; k < kLookback; ++k) {
            if (done || u < k) break;
            const uint32_t flag = v[k] & ~kCountMask;
            if (flag == 0u) break;  // not published yet
            excl += v[k] & kCountMask;
            done = flag == kFlagPrefix;
            u = k + 1;
        }
        if (done) break;
        t -= u;
    }
    if (tile > 0)
        store_volatile(&status[(int64_t)tile * kDigits + tid],
                       kFlagPrefix | (excl + cnt));
    // the tile's digit starts, and each digit's output offset
    const uint32_t lstart = block_scan_add<uint32_t>(cnt, sh.warp_tot, tot)
                            - cnt;
    sh.lstart[tid] = lstart;
    sh.gofs[tid] = gbase + excl - lstart;
    __syncthreads();
    // exchange through shared memory into the tile's sorted order, so
    // that each digit's run is written out contiguously
#pragma unroll
    for (int r = 0; r < kSortItems; ++r) {
        if (wbase + r * 32 + lane < m) {
            const unsigned long long k = key[r] & kKeyMask;
            const int d = (int)((k >> shift) & 0xFF);
            const uint32_t lp = sh.lstart[d] + sh.wcnt[warp][d] +
                                (uint32_t)(key[r] >> kKeyBits);
            sh.keys[lp] = k;
            sh.idx[lp] = val[r];
        }
    }
    __syncthreads();
    const int n_tile = (int)min((int64_t)kSortTile, (int64_t)m - tbase);
    for (int j = tid; j < n_tile; j += kSortThreads) {
        const unsigned long long k = sh.keys[j];
        const int d = (int)((k >> shift) & 0xFF);
        const uint32_t pos = sh.gofs[d] + (uint32_t)j;
        kout[pos] = k;
        vout[pos] = sh.idx[j];
    }
}

// ---- 2-3. the segmented scan and the chain ids --------------------------

__device__ __forceinline__ int code_of(unsigned long long key,
                                       const Meta &k) {
    return (int)(key >> k.sbits);
}

__device__ __forceinline__ int start_of(unsigned long long key,
                                        const Meta &k) {
    const uint32_t off =
        k.sbits == 0 ? 0u
                     : (uint32_t)(key & ((1ull << k.sbits) - 1ull));
    return (int)(off + (uint32_t)k.min_start);
}

__device__ __forceinline__ Run run_at(const unsigned long long *keys,
                                      const uint32_t *idx, const int32_t *end,
                                      int64_t p, int m, const Meta &k) {
    if (p >= m) return Run{0, INT_MIN};
    const int nr =
        p == 0 || code_of(keys[p], k) != code_of(keys[p - 1], k);
    return Run{nr, end[idx[p]]};
}

__global__ void __launch_bounds__(kScanBlock)
scan_runs(Scratch s, int m) {
    __shared__ Run warp_tot[32];
    const Meta k = *s.meta;
    const int64_t p = (int64_t)blockIdx.x * kScanBlock + threadIdx.x;
    Run tot;
    block_scan_run(run_at(s.keys[k.final_buf], s.idx[k.final_buf], s.end, p,
                          m, k),
                   warp_tot, tot);
    if (threadIdx.x == 0) s.agg[blockIdx.x] = tot;
}

__global__ void __launch_bounds__(kScanBlock)
scan_runmax(Scratch s, int m) {
    __shared__ Run warp_tot[32];
    const Meta k = *s.meta;
    Run carry{0, INT_MIN};
    for (int base = 0; base < (int)blockIdx.x; base += kScanBlock) {
        const int j = base + threadIdx.x;
        Run tot;
        block_scan_run(j < (int)blockIdx.x ? s.agg[j] : Run{0, INT_MIN},
                       warp_tot, tot);
        carry = comb(carry, tot);
    }
    const int64_t p = (int64_t)blockIdx.x * kScanBlock + threadIdx.x;
    Run tot;
    const Run incl = block_scan_run(
        run_at(s.keys[k.final_buf], s.idx[k.final_buf], s.end, p, m, k),
        warp_tot, tot);
    if (p < m) s.runmax[p] = comb(carry, incl).m;
}

__global__ void __launch_bounds__(kScanBlock)
scan_breaks(Scratch s, int m, int gap) {
    __shared__ int32_t warp_tot[32];
    const Meta k = *s.meta;
    const unsigned long long *keys = s.keys[k.final_buf];
    const int64_t p = (int64_t)blockIdx.x * kScanBlock + threadIdx.x;
    int brk = 0;
    if (p < m) {
        const unsigned long long key = keys[p];
        brk = p == 0 || code_of(key, k) != code_of(keys[p - 1], k) ||
              start_of(key, k) > wrap_add(s.runmax[p - 1], gap);
    }
    int32_t tot;
    const int32_t incl = block_scan_add<int32_t>(brk, warp_tot, tot);
    if (p < m) s.nbrk[p] = incl;
    if (threadIdx.x == 0) s.aggn[blockIdx.x] = tot;
}

// each entry's slot; each slot counts the old arena rows it receives
__global__ void __launch_bounds__(kScanBlock)
scan_dest(Scratch s, int m, int cap) {
    __shared__ int32_t warp_tot[32];
    const Meta k = *s.meta;
    int32_t carry = 0;
    for (int base = 0; base < (int)blockIdx.x; base += kScanBlock) {
        const int j = base + threadIdx.x;
        int32_t tot;
        block_scan_add<int32_t>(j < (int)blockIdx.x ? s.aggn[j] : 0,
                                warp_tot, tot);
        carry += tot;
    }
    const int64_t p = (int64_t)blockIdx.x * kScanBlock + threadIdx.x;
    if (p < m) {
        const bool live = code_of(s.keys[k.final_buf][p], k) < k.sent;
        const uint32_t i = s.idx[k.final_buf][p];
        const int32_t d = live ? carry + s.nbrk[p] - 1 : cap;
        s.dest[i] = d;
        if (d < cap && (int)i < cap) atomicAdd(&s.feeds[d], 1);
    }
}

// ---- 4. the fresh arena ----------------------------------------------

__device__ __forceinline__ uint32_t identity_bits(int kind) {
    if (kind == HS_AGG_MIN) return 0x7F800000u;  // +inf
    if (kind == HS_AGG_MAX) return 0xFF800000u;  // -inf
    return 0u;
}

// the 32-bit word a plane's identity folded with `x` (one word of an old
// row) gives, as the atomics of fold_row would leave it
__device__ __forceinline__ uint32_t fold_word(int kind, uint32_t x) {
    switch (kind) {
    case HS_AGG_SUM:
    case HS_AGG_AVG:
        return __float_as_uint(__fadd_rn(0.0f, __uint_as_float(x)));
    case HS_AGG_MIN:
        return min_float_bits(0x7F800000u, x);
    case HS_AGG_MAX:
        return max_float_bits(0xFF800000u, x);
    case HS_AGG_HLL:
        return __vmaxs4(x, 0u);  // each register max(r, 0)
    default:  // counts, histogram bins: 0 + x
        return x;
    }
}

// words of one row of plane p (an HLL row is width bytes)
__device__ __forceinline__ int row_words(const HsSessPlane &p) {
    return p.kind == HS_AGG_HLL ? p.width >> 2 : p.width;
}

// one warp: slot `row` gets its identities (init) and/or old row `row`
// is copied into slot d (copy); lanes stride the row's words, four at a
// time where the row is 16-byte aligned
__device__ __forceinline__ void plane_row(const HsSessPlane &p, int64_t row,
                                          bool init, int64_t d, bool copy,
                                          int lane) {
    const int words = row_words(p);
    const uint32_t id = identity_bits(p.kind);
    uint32_t *out = (uint32_t *)p.out;
    const uint32_t *src = (const uint32_t *)p.src;
    const bool vec = (words & 3) == 0 && (((uintptr_t)out | (uintptr_t)src)
                                          & 15) == 0;
    if (vec) {
        // four 16-byte loads in flight a lane before their stores
        const int w4 = words >> 2;
        uint4 *o4 = (uint4 *)out;
        const uint4 *s4 = (const uint4 *)src;
        for (int w0 = lane; w0 < w4; w0 += 128) {
            uint4 x[4];
#pragma unroll
            for (int u = 0; u < 4; ++u)
                if (copy && w0 + 32 * u < w4) x[u] = s4[row * w4 + w0 + 32 * u];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int w = w0 + 32 * u;
                if (w >= w4) break;
                if (init) o4[row * w4 + w] = make_uint4(id, id, id, id);
                if (copy)
                    o4[d * w4 + w] = make_uint4(
                        fold_word(p.kind, x[u].x), fold_word(p.kind, x[u].y),
                        fold_word(p.kind, x[u].z), fold_word(p.kind, x[u].w));
            }
        }
    } else {
        for (int w = lane; w < words; w += 32) {
            if (init) out[row * words + w] = id;
            if (copy)
                out[d * words + w] = fold_word(p.kind, src[row * words + w]);
        }
    }
    if (p.out_n != nullptr && lane == 0) {
        if (init) p.out_n[row] = 0;
        if (copy) p.out_n[d] = p.src_n[row];
    }
}

// one warp per slot `row`: its identities unless exactly one old row
// feeds it, and old row `row` copied into its slot when that slot is fed
// by it alone; the two write disjoint slots, so no order is needed
__global__ void __launch_bounds__(kFoldBlock)
init_copy_kernel(const __grid_constant__ HsSessionArgs a, Scratch s) {
    const int64_t row =
        ((int64_t)blockIdx.x * kFoldBlock + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (row >= a.cap) return;
    const bool init = s.feeds[row] != 1;
    const int64_t d = s.dest[row];
    const bool copy = d < a.cap && s.feeds[d] == 1;
    if (lane == 0) {
        if (init) {
            a.out_code[row] = HS_SESSION_SENT;
            a.out_t0[row] = INT_MAX;
            a.out_t1[row] = HS_SESSION_NEG;
        }
        if (copy) {
            int c, st, e;
            entry(a, (int)row, c, st, e);
            a.out_code[d] = c;
            a.out_t0[d] = st;
            a.out_t1[d] = max(e, HS_SESSION_NEG);
        }
    }
    if (!init && !copy) return;
    for (int q = 0; q < a.n_planes; ++q)
        plane_row(a.p[q], row, init, d, copy, lane);
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

// fold one row (entry i: an old arena row or a segment) into its slot
// d with atomics, one warp
__device__ __forceinline__ void fold_entry(const HsSessionArgs &a, bool seg,
                                           int64_t row, int i, int64_t d,
                                           int lane) {
    if (lane == 0) {
        int c, st, e;
        entry(a, i, c, st, e);
        atomicMin(a.out_code + d, c);
        atomicMin(a.out_t0 + d, st);
        atomicMax(a.out_t1 + d, e);
    }
    for (int q = 0; q < a.n_planes; ++q) {
        const HsSessPlane &p = a.p[q];
        fold_row(p, seg ? p.seg : p.src, seg ? p.seg_n : p.src_n, row, d,
                 lane);
    }
}

// the old arena's rows whose slot several rows feed (the rest were
// copied by init_copy_kernel): each lane checks one row, then the warp
// folds the few it found one after another
__global__ void __launch_bounds__(kFoldBlock)
fold_shared_rows(const __grid_constant__ HsSessionArgs a, Scratch s) {
    const int64_t row = (int64_t)blockIdx.x * kFoldBlock + threadIdx.x;
    const int lane = threadIdx.x & 31;
    const int64_t d = row < a.cap ? s.dest[row] : a.cap;
    unsigned todo = __ballot_sync(kFull, d < a.cap && s.feeds[d] > 1);
    while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const int64_t r = __shfl_sync(kFull, row, src);
        const int64_t dr = __shfl_sync(kFull, d, src);
        fold_entry(a, false, r, (int)r, dr, lane);
    }
}

// the segments' rows (segment mode), one warp per row
__global__ void __launch_bounds__(kFoldBlock)
fold_segments(const __grid_constant__ HsSessionArgs a, Scratch s) {
    const int64_t row =
        ((int64_t)blockIdx.x * kFoldBlock + threadIdx.x) >> 5;
    if (row >= a.nb) return;
    const int i = (int)(a.cap + row);
    const int64_t d = s.dest[i];
    if (d < a.cap) fold_entry(a, true, row, i, d, threadIdx.x & 31);
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

// stages 1-3, then the fresh arena's single write and the fold of the
// old rows that share a slot; the caller adds its batch and then fixup()
inline cudaError_t core(const HsSessionArgs &a, Scratch &s,
                        cudaStream_t st) {
    const int64_t m = (int64_t)a.cap + a.nb;
    if (a.scratch == nullptr || a.n_planes > HS_MAX_AGGS || a.cap < 0 ||
        a.nb < 0 || m == 0 || m > (int64_t)kCountMask)
        return cudaErrorInvalidValue;
    layout(a.cap, a.nb, (char *)a.scratch, &s);
    static bool granted = false;
    if (!granted) {
        cudaError_t err = cudaFuncSetAttribute(
            sort_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)kPassSmem);
        if (err != cudaSuccess) return err;
        granted = true;
    }
    const int tiles = (int)blocks_for(m, kSortTile);
    const int blocks = (int)blocks_for(m, kScanBlock);
    const int parts = (int)std::min<int64_t>(kRangeBlocks,
                                             blocks_for(m, 256 * 2));
    sort_range_kernel<<<parts, 256, 0, st>>>(a, s, (int)m);
    sort_keys_kernel<<<tiles, kKeysThreads, 0, st>>>(a, s, (int)m, parts);
    for (int pass = 0; pass < kSortPasses; ++pass)
        sort_pass_kernel<<<tiles, kSortThreads, kPassSmem, st>>>(
            s, (int)m, pass, tiles);
    scan_runs<<<blocks, kScanBlock, 0, st>>>(s, (int)m);
    scan_runmax<<<blocks, kScanBlock, 0, st>>>(s, (int)m);
    scan_breaks<<<blocks, kScanBlock, 0, st>>>(s, (int)m, a.gap);
    scan_dest<<<blocks, kScanBlock, 0, st>>>(s, (int)m, a.cap);
    if (a.cap > 0) {
        const unsigned rows = blocks_for((int64_t)a.cap * 32, kFoldBlock);
        init_copy_kernel<<<rows, kFoldBlock, 0, st>>>(a, s);
        fold_shared_rows<<<blocks_for(a.cap, kFoldBlock), kFoldBlock, 0,
                           st>>>(a, s);
    }
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
