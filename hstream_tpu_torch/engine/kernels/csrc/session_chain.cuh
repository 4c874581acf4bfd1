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
//    The reference sorts by (code, start, end); the keys hold (code,
//    start). The order among equal (code, start) does not matter while
//    every end is at or past its start and end + gap stays within int32:
//    of a run of equal starts only the first can break a chain (the
//    others start at or before the running end), and the chain's end is
//    their max. Where an entry breaks that (an end within `gap` of
//    2^31 - 1, where the break test's running end + gap wraps), the keys
//    kernels set a flag on the card and sort_ties_kernel puts each run of
//    equal keys in order of (end, index) before the scans; with the flag
//    clear it returns at once (one launch, no host sync).
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
//
// The key shards of a mesh (core_group; hstream_tpu/parallel/lattice.py
// :669-714 ShardedSessionLattice._build_step / _build_merge). What bounded
// the first sharded design (4 shards of 2^15 slots, 2^20 records: step
// 1.029 ms, merge 0.744, PERF.md): one launch sequence a shard, each over
// its arena AND the whole batch, the records another shard owns keyed as
// the sentinel, so each record was keyed, sorted by all seven passes,
// scanned and visited once a shard (4.33 M keys sorted where one sort of
// the 1.18 M entries would do), in ~17 launches a shard. Now one sequence
// a card covers a table of the shards whose arenas lie there
// (HsSessGroupArgs):
//  * the entries are the table's arenas, shard by shard (row i of shard
//    i / cap), then the batch once; an entry's shard is code mod S;
//  * the sort code of an owned entry is (g << qbits) | code div S, g the
//    shard's place in the table: a bijection of the code within a table,
//    below 2^23, so a key still fits 55 bits; a shard's chains are then
//    contiguous and in its own (code, start) order, a chain never spans
//    a code change, and a shard's slot is its chain id less the chains
//    of the shards before it (counted by scan_breaks at each shard's last
//    entry in a scan block); a chain at or past cap within its shard is
//    dropped, as the per-shard launch dropped it;
//  * group_keys_kernel writes only the live entries' keys (an arena row
//    alive after the retire, a valid record or segment that a shard of
//    the table owns), compacted through one counter of live entries that
//    stays on the card: the launches are sized for all entries and the
//    blocks past the live count return, with no host sync;
//  * dest stays a shard's local slot (cap = dropped): init_copy, the
//    folds and the record scatter find the shard's planes from an arena
//    row's index or a record's code.
// A table takes at most HS_SESS_GROUP shards and HS_SESS_GROUP_PTRS plane
// pointers by value (hs_kernels.h: 14 shards of a 64-aggregate query);
// the host launches more in groups. At the shapes above the step now
// takes 0.544 ms and the merge 0.433 (PERF.md, GD): one sort of the live
// entries (~0.24 ms with its keys and passes) and the arena write (init
// ~0.15) lead. A single arena keeps core(), whose kernels take the
// templates' false branches.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>

#include "device.cuh"
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
    int32_t npos;       // a table's key: its 8-bit digit positions
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
    uint32_t *tilectr;  // [kSortPasses], then the  } one span
                        // tie flag (tie_flag)     }
    int32_t *feeds;     // [rows] old rows per slot }
    int32_t *chains;    // [n_group] a table's     } zeroed too
    uint32_t *nlive;    // a table's live entries  }
    Run *agg;           // [scan blocks]
    int32_t *aggn;      // [scan blocks]
    int64_t zero_words; // 4-byte words from ghist to the end of feeds
};

// a table's kernels take it, the scratch and two ints by value
static_assert(sizeof(HsSessGroupArgs) + sizeof(Scratch) + 16 <=
                  HS_MAX_PARAM_BYTES,
              "a table launch's parameters");

inline int64_t align256(int64_t b) { return (b + 255) & ~(int64_t)255; }

// rows: the arena rows (cap, or a table's n_group * cap); n_group 0 for
// one arena
inline int64_t layout(int64_t rows, int32_t nb, int32_t n_group, char *base,
                      Scratch *s) {
    const int64_t m = rows + nb;
    const int64_t tiles = (m + kSortTile - 1) / kSortTile;
    const int64_t blocks = (m + kScanBlock - 1) / kScanBlock;
    constexpr int kParts = 15;
    const int64_t sizes[kParts] = {
        m * 8, m * 8, m * 4, m * 4, m * 4, m * 4, m * 4, m * 4,
        kRangeBlocks * 16, (int64_t)sizeof(Meta),
        kSortPasses * kDigits * 4, kSortPasses * tiles * kDigits * 4,
        (kSortPasses + 1) * 4, rows * 4, n_group > 0 ? (n_group + 1) * 4 : 0};
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
        s->chains = (int32_t *)p(14);
        s->nlive = (uint32_t *)(s->chains + n_group);
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

// the sort's range kernel reads an entry through one of these: whether
// it is live, and then its sort code, start and end
__device__ __forceinline__ bool live_entry(const HsSessionArgs &a, int i,
                                           int &c, int &s, int &e) {
    entry(a, i, c, s, e);
    return c < HS_SESSION_SENT;
}

// the table place of a live batch entry's shard (-1: another table's)
__device__ __forceinline__ int group_of(const HsSessGroupArgs &a, int code) {
    return a.pos[code % a.n_shards];
}

// a table's entry i: the arenas' rows (row r of shard g at g * cap + r),
// then the batch; live as entry() has it and, for a batch entry, owned
// by a shard of the table. c is the sort code (g << qbits) | code div S
// (codes are >= 0 here, so / and % are the floor's)
__device__ __forceinline__ bool live_entry(const HsSessGroupArgs &a, int i,
                                           int &c, int &s, int &e) {
    const int rows = a.n_group * a.cap;
    if (i < rows) {
        const int g = i / a.cap, r = i - g * a.cap;
        const HsSessShard &h = a.sh[g];
        const int code = h.code[r];
        if (code < 0 || code >= HS_SESSION_SENT || h.t1[r] <= a.close_cut)
            return false;
        c = (g << a.qbits) | (code / a.n_shards);
        s = wrap_sub(h.t0[r], a.delta);
        e = wrap_sub(h.t1[r], a.delta);
        return true;
    }
    const int j = i - rows;
    const int code = a.b_code[j];
    if (code < 0 || code >= HS_SESSION_SENT ||
        (a.b_flags != nullptr && !(a.b_flags[j] & 1)))
        return false;
    const int g = group_of(a, code);
    if (g < 0) return false;
    c = (g << a.qbits) | (code / a.n_shards);
    s = a.b_t0[j];
    e = a.b_t1[j];
    return true;
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

// the tie flag: set by the keys kernels where a live entry could make the
// order of equal (code, start) entries matter (sort_ties_kernel)
__device__ __forceinline__ uint32_t *tie_flag(const Scratch &s) {
    return s.tilectr + kSortPasses;
}

// an entry for which the order among equal (code, start) can change the
// chains: its end before its start, or its end + gap past int32 (the
// running end it sets then wraps in the break test); with neither on any
// live entry, every entry of a run of equal (code, start) joins the
// chain of the run's first, whatever their order (sort_ties_kernel)
__device__ __forceinline__ bool tie_risk(int st, int e, int gap) {
    return gap < 0 || e < st || (long long)e + gap > (long long)INT_MAX;
}

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

template <class A>
__global__ void __launch_bounds__(256)
sort_range_kernel(const __grid_constant__ A a, Scratch s, int m) {
    __shared__ int4 warp_part[8];  // 256 threads
    const int64_t step = (int64_t)gridDim.x * blockDim.x;
    const int64_t i0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    uint4 *z = (uint4 *)s.ghist;
    for (int64_t w = i0; w < s.zero_words / 4; w += step)
        z[w] = make_uint4(0u, 0u, 0u, 0u);
    int4 r = no_range();
    for (int64_t i = i0; i < m; i += step) {
        int c, st, e;
        if (live_entry(a, (int)i, c, st, e)) {
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
    k.npos = npos;
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
            if (c < HS_SESSION_SENT && tie_risk(st, e, a.gap))
                atomicOr(tie_flag(s), 1u);
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

// a table's keys (core_group): as sort_keys_kernel, but only the live
// entries are keyed, compacted to the front of keys[0] / idx[0] (a block
// takes its place by one atomic on the live count, each warp's live lanes
// of an item write consecutive places; the order among a sort's input
// keys does not matter), a dead entry's slot is set to cap here, and the
// key is (sort code << sbits) | (start - min start): no sentinel, so its
// width is that of the largest live sort code
__global__ void __launch_bounds__(kKeysThreads)
group_keys_kernel(const __grid_constant__ HsSessGroupArgs a, Scratch s,
                  int m, int n_parts) {
    constexpr int kItems = kSortTile / kKeysThreads;
    __shared__ int4 warp_part[kKeysThreads / 32];
    __shared__ uint32_t cnt[kSortPasses][kDigits];
    __shared__ uint32_t warp_tot[32];
    __shared__ uint32_t at0;
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
    k.sent = 0;  // no sentinel key
    k.min_start = r.x < 0 ? 0 : r.y;
    k.sbits = r.x < 0 ? 0 : bit_width((uint32_t)r.z - (uint32_t)r.y);
    k.final_buf = 0;
    const int width = r.x < 0 ? 0 : bit_width((uint32_t)r.x) + k.sbits;
    const int npos = (width + 7) / 8;
    k.npos = npos;
    if (blockIdx.x == 0 && threadIdx.x == 0) *s.meta = k;
    for (int d = threadIdx.x; d < kSortPasses * kDigits; d += kKeysThreads)
        (&cnt[0][0])[d] = 0u;
    const int64_t base = (int64_t)blockIdx.x * kSortTile;
    unsigned long long key[kItems];
    bool live[kItems];
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
        const int64_t i = base + it * kKeysThreads + threadIdx.x;
        int c = 0, st = 0, e = 0;
        live[it] = i < m && live_entry(a, (int)i, c, st, e);
        key[it] = 0ull;
        if (live[it]) {
            if (tie_risk(st, e, a.gap)) atomicOr(tie_flag(s), 1u);
            key[it] = ((unsigned long long)(uint32_t)c << k.sbits) |
                      (unsigned long long)((uint32_t)st -
                                           (uint32_t)k.min_start);
            s.end[i] = e;
        } else if (i < m) {
            s.dest[i] = a.cap;
        }
    }
    const int warp = threadIdx.x >> 5;
    unsigned bal[kItems];
    uint32_t n_warp = 0;
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
        bal[it] = __ballot_sync(kFull, live[it]);
        n_warp += (uint32_t)__popc(bal[it]);
    }
    if (lane == 0) warp_tot[warp] = n_warp;
    __syncthreads();
    if (threadIdx.x == 0) {
        uint32_t t = 0;
        for (int w = 0; w < kKeysThreads / 32; ++w) {
            const uint32_t c = warp_tot[w];
            warp_tot[w] = t;
            t += c;
        }
        at0 = t > 0u ? atomicAdd(s.nlive, t) : 0u;
    }
    __syncthreads();
    uint32_t at = at0 + warp_tot[warp];
    const unsigned lt = (1u << lane) - 1u;
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
        if (live[it]) {
            const uint32_t p = at + (uint32_t)__popc(bal[it] & lt);
            s.keys[0][p] = key[it];
            s.idx[0][p] = (uint32_t)(base + it * kKeysThreads + threadIdx.x);
        }
        at += (uint32_t)__popc(bal[it]);
    }
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
        for (int p = 0; p < npos; ++p) {
            const int d =
                live[it] ? (int)((key[it] >> (8 * p)) & 0xFF) : kDigits;
            const unsigned peers = match_digit(d);
            if (live[it] && lane == __ffs(peers) - 1)
                atomicAdd(&cnt[p][d], (uint32_t)__popc(peers));
        }
    }
    __syncthreads();
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

// one stable pass of the LSD sort over digit position `pass`. kLive (a
// table, core_group): the keys are the live count's, read from the card;
// `m` and `tiles` are the launch's bound, the positions past the key's
// npos hold one bucket, and a block whose tile is past the count returns
template <bool kLive>
__global__ void __launch_bounds__(kSortThreads, 3)
sort_pass_kernel(Scratch s, int m, int pass, int tiles) {
    static_assert(kSortThreads == kDigits, "one digit per thread");
    extern __shared__ unsigned char smem_raw[];
    PassSmem &sh = *(PassSmem *)smem_raw;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const uint32_t *hist = s.ghist + pass * kDigits;
    int npos = kSortPasses;
    if constexpr (kLive) {
        m = (int)*s.nlive;
        npos = s.meta->npos;
    }
    // which buffer holds the keys: one flip per earlier pass that ran
    int src = 0;
    bool run = false;
    for (int q = 0; q <= pass; ++q) {
        const bool one = (kLive && q >= npos) ||
                         __syncthreads_or(s.ghist[q * kDigits + tid] ==
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
    if (kLive && tbase >= m) return;
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

// ---- 1b. equal (code, start) entries in the reference's order -----------

constexpr int kTieThreads = 256;
constexpr int kTieShort = 16;  // a run this short: one thread sorts it

// the sort value of sorted entry p: its end (signed order), then its
// index, as one unsigned 64-bit number
__device__ __forceinline__ unsigned long long tie_value(const Scratch &s,
                                                        uint32_t i) {
    return ((unsigned long long)((uint32_t)s.end[i] ^ 0x80000000u) << 32) |
           i;
}

// The reference sorts by (code, start, end) (lax.sort, num_keys=3; the
// index breaks the remaining ties, as its CPU sort keeps them), the
// radix sort by (code, start) only. When the keys kernels set the tie
// flag, each run of equal keys is put in order of (end, index) here,
// before the scans: the block of the tile where a run starts takes it,
// a short run by one thread (insertion sort), a longer one by the block
// (a bitonic network over the run's values in the keys buffer the sort
// left free, sorted in place, with the positions past the run taken as
// +infinity, so they never move). With the flag clear (every entry of a
// run joins its first's chain: tie_risk), every block returns at once.
template <bool kLive>
__global__ void __launch_bounds__(kTieThreads)
sort_ties_kernel(Scratch s, int m) {
    __shared__ int s_run[kSortTile];   // runs that start in the tile
    __shared__ int s_long[kSortTile / (kTieShort + 1) + 1];
    __shared__ int s_n, s_nlong, s_end;
    if (*tie_flag(s) == 0u) return;
    if constexpr (kLive) m = (int)*s.nlive;
    const int64_t t0 = (int64_t)blockIdx.x * kSortTile;
    if (t0 >= m) return;
    const int t1 = (int)min((int64_t)m, t0 + kSortTile);
    const Meta k = *s.meta;
    const unsigned long long *keys = s.keys[k.final_buf];
    uint32_t *idx = s.idx[k.final_buf];
    unsigned long long *val = s.keys[k.final_buf ^ 1];
    if (threadIdx.x == 0) s_n = s_nlong = 0;
    __syncthreads();
    // (one arena's sentinels are one run, dropped whatever its order)
    for (int p = (int)t0 + threadIdx.x; p < t1; p += kTieThreads)
        if (p + 1 < m && keys[p + 1] == keys[p] &&
            (p == 0 || keys[p - 1] != keys[p]) &&
            (kLive || (int)(keys[p] >> k.sbits) < k.sent))
            s_run[atomicAdd(&s_n, 1)] = p;
    __syncthreads();
    const int n_runs = s_n;
    for (int r = threadIdx.x; r < n_runs; r += kTieThreads) {
        const int p0 = s_run[r];
        int p1 = p0 + 1;
        while (p1 < m && p1 - p0 <= kTieShort && keys[p1] == keys[p0]) ++p1;
        if (p1 - p0 > kTieShort) {
            s_long[atomicAdd(&s_nlong, 1)] = p0;
            continue;
        }
        for (int a = p0 + 1; a < p1; ++a) {  // insertion sort
            const uint32_t x = idx[a];
            const unsigned long long vx = tie_value(s, x);
            int b = a;
            while (b > p0 && tie_value(s, idx[b - 1]) > vx) {
                idx[b] = idx[b - 1];
                --b;
            }
            idx[b] = x;
        }
    }
    __syncthreads();
    const int n_long = s_nlong;
    for (int r = 0; r < n_long; ++r) {
        const int p0 = s_long[r];
        if (threadIdx.x == 0) s_end = m;
        __syncthreads();
        // the run's end: the first key past p0 that differs
        for (int base = p0 + 1; base < m; base += kTieThreads) {
            const int p = base + threadIdx.x;
            if (p < m && keys[p] != keys[p0]) atomicMin(&s_end, p);
            __syncthreads();
            if (s_end < m) break;
            __syncthreads();
        }
        const int n = s_end - p0;
        unsigned long long *v = val + p0;
        for (int q = threadIdx.x; q < n; q += kTieThreads)
            v[q] = tie_value(s, idx[p0 + q]);
        int pw = 1;
        while (pw < n) pw <<= 1;
        __syncthreads();
        for (int kk = 2; kk <= pw; kk <<= 1) {
            const int h = kk >> 1;
            for (int q = threadIdx.x; q < pw / 2; q += kTieThreads) {
                const int i = (q / h) * kk + (q % h);
                const int j = i ^ (kk - 1);
                if (j < n && v[i] > v[j]) {
                    const unsigned long long x = v[i];
                    v[i] = v[j];
                    v[j] = x;
                }
            }
            __syncthreads();
            for (int d = kk >> 2; d >= 1; d >>= 1) {
                for (int q = threadIdx.x; q < pw / 2; q += kTieThreads) {
                    const int i = (q / d) * 2 * d + (q % d);
                    const int j = i + d;
                    if (j < n && v[i] > v[j]) {
                        const unsigned long long x = v[i];
                        v[i] = v[j];
                        v[j] = x;
                    }
                }
                __syncthreads();
            }
        }
        for (int q = threadIdx.x; q < n; q += kTieThreads)
            idx[p0 + q] = (uint32_t)v[q];
        __syncthreads();
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

// a table's scans (kLive) run over its live count, read from the card;
// the blocks past it return
template <bool kLive>
__device__ __forceinline__ bool past_live(const Scratch &s, int &m) {
    if constexpr (kLive) {
        m = (int)*s.nlive;
        return (int64_t)blockIdx.x * kScanBlock >= m;
    }
    return false;
}

template <bool kLive>
__global__ void __launch_bounds__(kScanBlock)
scan_runs(Scratch s, int m) {
    __shared__ Run warp_tot[32];
    if (past_live<kLive>(s, m)) return;
    const Meta k = *s.meta;
    const int64_t p = (int64_t)blockIdx.x * kScanBlock + threadIdx.x;
    Run tot;
    block_scan_run(run_at(s.keys[k.final_buf], s.idx[k.final_buf], s.end, p,
                          m, k),
                   warp_tot, tot);
    if (threadIdx.x == 0) s.agg[blockIdx.x] = tot;
}

template <bool kLive>
__global__ void __launch_bounds__(kScanBlock)
scan_runmax(Scratch s, int m) {
    __shared__ Run warp_tot[32];
    if (past_live<kLive>(s, m)) return;
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

// kGroup (a table): the breaks of each shard are counted into chains[g]:
// the entry ending a shard's run in the block adds the block's inclusive
// count there, and takes it from the next shard's if that starts in the
// block (a shard's first entry is a break: its code changes)
template <bool kGroup>
__global__ void __launch_bounds__(kScanBlock)
scan_breaks(Scratch s, int m, int gap, int qbits) {
    __shared__ int32_t warp_tot[32];
    if (past_live<kGroup>(s, m)) return;
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
    if constexpr (kGroup) {
        const int64_t last =
            min((int64_t)(blockIdx.x + 1) * kScanBlock, (int64_t)m) - 1;
        if (p <= last) {
            const int g = code_of(keys[p], k) >> qbits;
            const int gn = p < last ? code_of(keys[p + 1], k) >> qbits : g;
            if (p == last || gn != g) {
                atomicAdd(&s.chains[g], incl);
                if (gn != g) atomicAdd(&s.chains[gn], -incl);
            }
        }
    }
}

// each entry's slot; each slot counts the old arena rows it receives.
// kGroup (a table of n_group shards, all entries live): the slot is the
// chain id less the chains of the shards before the entry's, cap past
// the shard's cap; feeds are the shard's (rows g * cap on)
template <bool kGroup>
__global__ void __launch_bounds__(kScanBlock)
scan_dest(Scratch s, int m, int cap, int qbits, int n_group) {
    __shared__ int32_t warp_tot[32];
    __shared__ int32_t first[HS_SESS_GROUP];
    if (past_live<kGroup>(s, m)) return;
    const Meta k = *s.meta;
    if constexpr (kGroup) {
        if (threadIdx.x == 0) {
            int32_t n = 0;
            for (int g = 0; g < n_group; ++g) {
                first[g] = n;
                n += s.chains[g];
            }
        }
        __syncthreads();
    }
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
        const uint32_t i = s.idx[k.final_buf][p];
        if constexpr (kGroup) {
            const int g = code_of(s.keys[k.final_buf][p], k) >> qbits;
            const int32_t c = carry + s.nbrk[p] - 1 - first[g];
            const int32_t d = c < cap ? c : cap;
            s.dest[i] = d;
            if (d < cap && (int64_t)i < (int64_t)n_group * cap)
                atomicAdd(&s.feeds[(int64_t)g * cap + d], 1);
        } else {
            const bool live = code_of(s.keys[k.final_buf][p], k) < k.sent;
            const int32_t d = live ? carry + s.nbrk[p] - 1 : cap;
            s.dest[i] = d;
            if (d < cap && (int)i < cap) atomicAdd(&s.feeds[d], 1);
        }
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
        return min_float_bits(0x7F800000u, ftz_bits(x));
    case HS_AGG_MAX:
        return max_float_bits(0xFF800000u, ftz_bits(x));
    case HS_AGG_HLL:
        return __vmaxs4(x, 0u);  // each register max(r, 0)
    default:  // counts, histogram bins: 0 + x
        return x;
    }
}

// a table's plane q of shard g, with the fields of HsSessPlane that the
// fresh arena's writers read
struct PlaneView {
    int32_t kind;
    int32_t width;
    const void *src;
    const int32_t *src_n;
    void *out;
    int32_t *out_n;
};

__device__ __forceinline__ PlaneView view(const HsSessGroupArgs &a, int g,
                                          int q) {
    const HsSessPlanePtrs &p = a.pp[g * a.n_planes + q];
    return PlaneView{a.d[q].kind, a.d[q].width, p.src, p.src_n, p.out,
                     p.out_n};
}

// words of one row of plane p (an HLL row is width bytes)
template <class P>
__device__ __forceinline__ int row_words(const P &p) {
    return p.kind == HS_AGG_HLL ? p.width >> 2 : p.width;
}

// one warp: slot `row` gets its identities (init) and/or old row `row`
// is copied into slot d (copy); lanes stride the row's words, four at a
// time where the row is 16-byte aligned
template <class P>
__device__ __forceinline__ void plane_row(const P &p, int64_t row,
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
template <class P>
__device__ __forceinline__ void fold_row(const P &p,
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
        atomic_min_float((float *)p.out + d, ftz(((const float *)src)[row]));
        break;
    case HS_AGG_MAX:
        atomic_max_float((float *)p.out + d, ftz(((const float *)src)[row]));
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

// ---- 4 for a table: row r of shard g is entry g * cap + r ---------------

// init_copy_kernel over every shard's slots; an old row is copied into
// the fresh arena of its own shard. At most 64 registers (four blocks an
// SM): the table's pointers cost registers that init_copy_kernel reads
// from its parameters, and at 66 the copy ran 8 % slower (PERF.md, GD)
__global__ void __launch_bounds__(kFoldBlock, 4)
group_init_copy_kernel(const __grid_constant__ HsSessGroupArgs a,
                       Scratch s) {
    const int64_t row =
        ((int64_t)blockIdx.x * kFoldBlock + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (row >= (int64_t)a.n_group * a.cap) return;
    const int g = (int)(row / a.cap);
    const int64_t r = row - (int64_t)g * a.cap;
    const int32_t *feeds = s.feeds + (int64_t)g * a.cap;
    const bool init = feeds[r] != 1;
    const int64_t d = s.dest[row];
    const bool copy = d < a.cap && feeds[d] == 1;
    const HsSessShard &h = a.sh[g];
    if (lane == 0) {
        if (init) {
            h.out_code[r] = HS_SESSION_SENT;
            h.out_t0[r] = INT_MAX;
            h.out_t1[r] = HS_SESSION_NEG;
        }
        if (copy) {
            h.out_code[d] = h.code[r];
            h.out_t0[d] = wrap_sub(h.t0[r], a.delta);
            h.out_t1[d] = max(wrap_sub(h.t1[r], a.delta), HS_SESSION_NEG);
        }
    }
    if (!init && !copy) return;
    for (int q = 0; q < a.n_planes; ++q)
        plane_row(view(a, g, q), r, init, d, copy, lane);
}

// fold_shared_rows over every shard's old rows
__global__ void __launch_bounds__(kFoldBlock)
group_fold_shared_rows(const __grid_constant__ HsSessGroupArgs a,
                       Scratch s) {
    const int64_t rows = (int64_t)a.n_group * a.cap;
    const int64_t row = (int64_t)blockIdx.x * kFoldBlock + threadIdx.x;
    const int lane = threadIdx.x & 31;
    const int64_t d = row < rows ? s.dest[row] : a.cap;
    unsigned todo = __ballot_sync(
        kFull, d < a.cap && s.feeds[row - row % a.cap + d] > 1);
    while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const int64_t rr = __shfl_sync(kFull, row, src);
        const int64_t dr = __shfl_sync(kFull, d, src);
        const int g = (int)(rr / a.cap);
        const int64_t r = rr - (int64_t)g * a.cap;
        const HsSessShard &h = a.sh[g];
        if (lane == 0) {
            atomicMin(h.out_code + dr, h.code[r]);
            atomicMin(h.out_t0 + dr, wrap_sub(h.t0[r], a.delta));
            atomicMax(h.out_t1 + dr, wrap_sub(h.t1[r], a.delta));
        }
        for (int q = 0; q < a.n_planes; ++q) {
            const PlaneView p = view(a, g, q);
            fold_row(p, p.src, p.src_n, r, dr, lane);
        }
    }
}

// fold_segments for a table: a segment folds into its shard's arena
__global__ void __launch_bounds__(kFoldBlock)
group_fold_segments(const __grid_constant__ HsSessGroupArgs a, Scratch s) {
    const int64_t row =
        ((int64_t)blockIdx.x * kFoldBlock + threadIdx.x) >> 5;
    if (row >= a.nb) return;
    const int64_t d = s.dest[(int64_t)a.n_group * a.cap + row];
    if (d >= a.cap) return;
    const int lane = threadIdx.x & 31;
    const int code = a.b_code[row];
    const int g = group_of(a, code);
    const HsSessShard &h = a.sh[g];
    if (lane == 0) {
        atomicMin(h.out_code + d, code);
        atomicMin(h.out_t0 + d, a.b_t0[row]);
        atomicMax(h.out_t1 + d, a.b_t1[row]);
    }
    for (int q = 0; q < a.n_planes; ++q)
        fold_row(view(a, g, q), a.d[q].seg, a.d[q].seg_n, row, d, lane);
}

__global__ void group_fixup_kernel(const __grid_constant__ HsSessGroupArgs a) {
    const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= (int64_t)a.n_group * a.cap) return;
    const int g = (int)(row / a.cap);
    const int64_t r = row - (int64_t)g * a.cap;
    const HsSessShard &h = a.sh[g];
    if (h.out_code[r] >= HS_SESSION_SENT) {
        h.out_t0[r] = 0;
        h.out_t1[r] = 0;
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
    layout(a.cap, a.nb, 0, (char *)a.scratch, &s);
    static std::atomic<uint64_t> granted{0};
    cudaError_t err =
        hs::allow_smem(granted, sort_pass_kernel<false>, (int)kPassSmem);
    if (err != cudaSuccess) return err;
    const int tiles = (int)blocks_for(m, kSortTile);
    const int blocks = (int)blocks_for(m, kScanBlock);
    const int parts = (int)std::min<int64_t>(kRangeBlocks,
                                             blocks_for(m, 256 * 2));
    sort_range_kernel<<<parts, 256, 0, st>>>(a, s, (int)m);
    sort_keys_kernel<<<tiles, kKeysThreads, 0, st>>>(a, s, (int)m, parts);
    for (int pass = 0; pass < kSortPasses; ++pass)
        sort_pass_kernel<false><<<tiles, kSortThreads, kPassSmem, st>>>(
            s, (int)m, pass, tiles);
    sort_ties_kernel<false><<<tiles, kTieThreads, 0, st>>>(s, (int)m);
    scan_runs<false><<<blocks, kScanBlock, 0, st>>>(s, (int)m);
    scan_runmax<false><<<blocks, kScanBlock, 0, st>>>(s, (int)m);
    scan_breaks<false><<<blocks, kScanBlock, 0, st>>>(s, (int)m, a.gap, 0);
    scan_dest<false><<<blocks, kScanBlock, 0, st>>>(s, (int)m, a.cap, 0, 0);
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

// bits of code div S for codes below 2^22 (the sort code's low part)
inline int qbits_for(int n_shards) {
    int b = 0;
    for (int q = (HS_SESSION_SENT - 1) / n_shards; q > 0; q >>= 1) ++b;
    return b;
}

// a table's arguments as the kernels index them: the shard count within
// the owner table, the table within its arrays, every place named once
inline bool group_ok(const HsSessGroupArgs &a) {
    if (a.scratch == nullptr || a.n_planes < 0 ||
        a.n_planes > HS_MAX_AGGS || a.cap < 0 || a.nb < 0 ||
        a.n_shards < 1 || a.n_shards > HS_SESS_MAX_SHARDS ||
        a.n_group < 1 || a.n_group > HS_SESS_GROUP ||
        a.n_group > a.n_shards ||
        a.n_group * a.n_planes > HS_SESS_GROUP_PTRS ||
        a.qbits != qbits_for(a.n_shards))
        return false;
    unsigned named = 0;  // a bit a table place
    for (int sh = 0; sh < a.n_shards; ++sh) {
        const int g = a.pos[sh];
        if (g < -1 || g >= a.n_group || (g >= 0 && ((named >> g) & 1u)))
            return false;
        if (g >= 0) named |= 1u << g;
    }
    return named == (1u << a.n_group) - 1u;
}

// stages 1-3 and the fresh arenas' single write for a table of key shards
// (the header's note); the caller adds its batch and then group_fixup()
inline cudaError_t core_group(const HsSessGroupArgs &a, Scratch &s,
                              cudaStream_t st) {
    const int64_t rows = (int64_t)a.n_group * a.cap;
    const int64_t m = rows + a.nb;
    if (!group_ok(a) || m == 0 || m > (int64_t)kCountMask)
        return cudaErrorInvalidValue;
    layout(rows, a.nb, a.n_group, (char *)a.scratch, &s);
    static std::atomic<uint64_t> granted{0};
    cudaError_t err =
        hs::allow_smem(granted, sort_pass_kernel<true>, (int)kPassSmem);
    if (err != cudaSuccess) return err;
    const int tiles = (int)blocks_for(m, kSortTile);
    const int blocks = (int)blocks_for(m, kScanBlock);
    const int parts = (int)std::min<int64_t>(kRangeBlocks,
                                             blocks_for(m, 256 * 2));
    sort_range_kernel<<<parts, 256, 0, st>>>(a, s, (int)m);
    group_keys_kernel<<<tiles, kKeysThreads, 0, st>>>(a, s, (int)m, parts);
    for (int pass = 0; pass < kSortPasses; ++pass)
        sort_pass_kernel<true><<<tiles, kSortThreads, kPassSmem, st>>>(
            s, (int)m, pass, tiles);
    sort_ties_kernel<true><<<tiles, kTieThreads, 0, st>>>(s, (int)m);
    scan_runs<true><<<blocks, kScanBlock, 0, st>>>(s, (int)m);
    scan_runmax<true><<<blocks, kScanBlock, 0, st>>>(s, (int)m);
    scan_breaks<true><<<blocks, kScanBlock, 0, st>>>(s, (int)m, a.gap,
                                                     a.qbits);
    scan_dest<true><<<blocks, kScanBlock, 0, st>>>(s, (int)m, a.cap, a.qbits,
                                                   a.n_group);
    if (rows > 0) {
        group_init_copy_kernel<<<blocks_for(rows * 32, kFoldBlock),
                                 kFoldBlock, 0, st>>>(a, s);
        group_fold_shared_rows<<<blocks_for(rows, kFoldBlock), kFoldBlock,
                                 0, st>>>(a, s);
    }
    return cudaGetLastError();
}

inline cudaError_t group_fixup(const HsSessGroupArgs &a, cudaStream_t st) {
    const int64_t rows = (int64_t)a.n_group * a.cap;
    if (rows > 0)
        group_fixup_kernel<<<blocks_for(rows, 256), 256, 0, st>>>(a);
    return cudaGetLastError();
}

}  // namespace
}  // namespace sess
}  // namespace hs
