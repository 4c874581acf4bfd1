// Interval-join eviction and epoch rebase, both sides in one call.
//
// Replaces hstream_tpu/engine/lattice.py:1131-1162 join_evict: per side,
// an entry survives iff code < sentinel and ts >= cutoff, with ts - delta
// (int32 wrap; delta 0 outside a rebase, < 0 for a rebase down); a dead
// entry becomes (sentinel, 0); one stable 2-key sort of (code, ts)
// reorders flags and columns to match; the live counts come back as
// int32 [2]. Key-sharded stores (hstream_tpu/parallel/lattice.py:441-467)
// launch it once a shard, each writing its row of live counts [n_shards,
// 2] (parallel/lattice.py).
//
// That sort is a stable compaction here, for two reasons:
//   * the live entries are a subsequence of a store sorted by (code, ts),
//     so they are already in sorted order, and shifting every one of
//     them by the same -delta keeps that order (the host keeps relative
//     times far from the int32 edge, so the shift does not wrap);
//   * every dead entry has the same key (sentinel, 0), above any live
//     one, so the stable sort keeps them in their own order after the
//     live ones.
// So live entry i goes to the number of live entries before it, and dead
// entry i to n_live + the number of dead entries before it, flags and
// columns moved with their entry. tests/test_torch_join_lattice.py holds
// the plain compaction against the plain sort, and a numpy model of the
// tiles below against both.
//
// Bound on the H100: bytes (both stores read once and written once).
//
// What held the first design back: three launches (a count per tile, a
// scan of the tile totals by one block per side walking them in turn,
// the move), code and ts read twice, one entry a thread.
//
// Design: one launch (after a memset of its status words). Tiles of
// 2048 entries, 256 threads of 8 entries, striped so that a warp's lanes
// read and write 32 consecutive entries (128 bytes a warp and array:
// full sectors, and a warp's live entries of a round land on consecutive
// places of the output). Blocks take tiles of both sides from a ticket:
//   1. a tile reads code and ts, takes each round's live lanes by
//      ballot, loads their flags, counts them per (round, warp),
//      publishes its count and sums its predecessors' (the single-pass
//      look-back, lookback.cuh), then writes its live entries with their
//      flags and columns; it keeps its ballots and its live prefix in
//      the scratch, published eight tiles at a time behind one fence;
//      the side's last tile publishes the side's live total;
//   2. once the tickets run out, each block takes tiles by its index,
//      waits for the side's total and the tile's own record, and writes
//      the tile's dead entries from its ballots: (sentinel, 0) and their
//      flags and columns.
// A block waits in (1) only on tiles of lower tickets and in (2) only
// once every ticket is taken, by blocks that are running, so no block
// waits on one that may not be resident. What holds it at ~1.7x its
// bound (PERF.md, runs CA-CK): a block's tiles run one after another,
// each waiting on its loads, then on its predecessors' counts; and the
// dead entries' flags share sectors with the live ones', so (2) reads
// most of the flags' sectors again. Counting every tile first and
// moving live and dead entries together after, or counting a block's
// next tile while its current one waits, each reading the live entries
// twice, were slower still.

#include <cuda_runtime.h>

#include "device.cuh"
#include "join_core.cuh"

namespace {

constexpr int kThreads = HS_JOIN_EVICT_THREADS;
constexpr int kPer = HS_JOIN_EVICT_PER;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = kThreads * kPer;   // entries a tile
constexpr int kWords = kPer * kWarps;     // ballots a tile
constexpr int kBlocksPerSm = 4;
constexpr int kDoneBatch = 8;  // tiles a block publishes behind one fence

// the scratch: [ticket, pad] [2 totals] [2 x tiles look-back words]
// [2 x tiles done words] (all zeroed before the launch) [2 x tiles x
// kWords ballots]
struct Scratch {
    unsigned *ticket;
    unsigned long long *total;  // hs::kAgg | a side's live count
    uint64_t *status;
    unsigned *done;             // 1 + the tile's live prefix
    uint32_t *ballot;
};

__host__ __device__ inline int tiles_of(int32_t cap) {
    return (int)((cap + (int64_t)kTileN - 1) / kTileN);
}

__host__ __device__ inline Scratch scratch_of(void *p, int tiles) {
    Scratch s;
    s.ticket = (unsigned *)p;
    s.total = (unsigned long long *)p + 1;
    s.status = (uint64_t *)(s.total + 2);
    s.done = (unsigned *)(s.status + 2 * tiles);
    s.ballot = s.done + 2 * tiles;
    return s;
}

__host__ inline size_t zeroed_bytes(int tiles) {
    return (size_t)(3 + 2 * tiles) * 8 + (size_t)2 * tiles * 4;
}

__device__ __forceinline__ uint32_t lanes_below(int lane) {
    return (1u << lane) - 1u;
}

// exclusive scan, in place, of the kWords per-(round, warp) counts in
// shared memory, by warp 0 (kWords / 32 a lane); returns the tile's
// total to all
__device__ __forceinline__ uint32_t scan_words(uint32_t *cnt, uint32_t *tot) {
    constexpr int kEach = kWords / 32;
    static_assert(kWords % 32 == 0, "whole counts a lane");
    const int lane = threadIdx.x & 31;
    __syncthreads();
    if (threadIdx.x < 32) {
        uint32_t v[kEach], sum = 0;
#pragma unroll
        for (int e = 0; e < kEach; ++e) sum += v[e] = cnt[lane * kEach + e];
        const uint32_t incl = hsjoin::warp_incl_scan(sum);
        uint32_t run = incl - sum;
#pragma unroll
        for (int e = 0; e < kEach; ++e) {
            cnt[lane * kEach + e] = run;
            run += v[e];
        }
        if (lane == 31) *tot = incl;
    }
    __syncthreads();
    return *tot;
}

// a thread's entries of one round set (lanes of `take`), one 4-byte
// array of the store: every load issued before the first store, so they
// are in flight together (the arrays may alias for the compiler)
__device__ __forceinline__ void load_set(const int32_t *src, int64_t t0,
                                         const uint32_t (&take)[kPer],
                                         int lane, int32_t (&v)[kPer]) {
#pragma unroll
    for (int r = 0; r < kPer; ++r)
        v[r] = (take[r] >> lane) & 1u ? src[t0 + r * kThreads] : 0;
}

// the place of a thread's entry of round r among those of `take`: first
// + the (round, warp) scan in cnt + the lanes below
__device__ __forceinline__ int32_t place(int64_t first, const uint32_t *cnt,
                                         uint32_t take, int r, int lane) {
    return (int32_t)first + cnt[r * kWarps + (threadIdx.x >> 5)] +
           __popc(take & lanes_below(lane));
}

// the columns of the entries of `take`, each to its place
__device__ __forceinline__ void move_cols(const HsJoinEvictSide &s,
                                          int32_t cap, int64_t t0,
                                          const uint32_t (&take)[kPer],
                                          int64_t first, const uint32_t *cnt,
                                          int lane) {
    for (int c = 0; c < s.n_cols; ++c) {
        int32_t v[kPer];
        load_set(s.cols + (int64_t)c * cap, t0, take, lane, v);
#pragma unroll
        for (int r = 0; r < kPer; ++r)
            if ((take[r] >> lane) & 1u)
                s.out_cols[(int64_t)c * cap +
                           place(first, cnt, take[r], r, lane)] = v[r];
    }
}

// publish the records of a block's last n tiles for (2): their ballots
// (written by each warp's lane 0) made visible first, then each tile's
// done word, 1 + its live prefix
__device__ __forceinline__ void publish_done(const Scratch &sc,
                                             const int *tile,
                                             const unsigned *doff, int n) {
    if ((threadIdx.x & 31) == 0) __threadfence();
    __syncthreads();
    if ((int)threadIdx.x < n) atomicExch(&sc.done[tile[threadIdx.x]],
                                         doff[threadIdx.x]);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
evict_kernel(const __grid_constant__ HsJoinEvictArgs a) {
    __shared__ uint32_t s_cnt[kWords];
    __shared__ long long s_look[32];
    __shared__ uint32_t s_tot;
    __shared__ int s_ticket;
    __shared__ long long s_first;
    __shared__ int s_done[kDoneBatch];
    __shared__ unsigned s_doff[kDoneBatch];
    const int tiles = tiles_of(a.cap);
    const Scratch sc = scratch_of(a.scratch, tiles);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

    // 1. the live entries, tile by tile in ticket order
    int n_done = 0;  // tiles whose record for (2) is not yet published
    for (;;) {
        if (threadIdx.x == 0) s_ticket = (int)atomicAdd(sc.ticket, 1u);
        __syncthreads();
        const int ticket = s_ticket;
        if (ticket >= 2 * tiles) break;
        const int side = ticket & 1, tile = ticket >> 1;
        const HsJoinEvictSide &s = a.s[side];
        const int64_t t0 = (int64_t)tile * kTileN + threadIdx.x;
        int32_t code[kPer], ts[kPer];
        uint32_t live[kPer];
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
            const bool in = t0 + r * kThreads < a.cap;
            code[r] = in ? s.code[t0 + r * kThreads] : HS_JOIN_SENT;
            ts[r] = in ? s.ts[t0 + r * kThreads] : 0;
        }
#pragma unroll
        for (int r = 0; r < kPer; ++r)
            live[r] = __ballot_sync(0xFFFFFFFFu, code[r] < HS_JOIN_SENT &&
                                                     ts[r] >= a.cutoff);
        int32_t flags[kPer];  // in flight through the scans
        load_set(s.flags, t0, live, lane, flags);
        if (lane == 0) {
            uint32_t *ballot =
                sc.ballot + ((size_t)side * tiles + tile) * kWords;
#pragma unroll
            for (int r = 0; r < kPer; ++r) {
                ballot[r * kWarps + warp] = live[r];
                s_cnt[r * kWarps + warp] = __popc(live[r]);
            }
        }
        const uint32_t count = scan_words(s_cnt, &s_tot);
        const long long off = hs::look_back(
            sc.status + (size_t)side * tiles, tile, count, s_look);
        if (threadIdx.x == 0) {
            s_done[n_done] = side * tiles + tile;
            s_doff[n_done] = (unsigned)(off + 1);
            if (tile == tiles - 1) {
                a.n_out[side] = (int32_t)(off + count);
                atomicExch(&sc.total[side],
                           hs::kAgg | (unsigned long long)(off + count));
            }
        }
        ++n_done;
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
            if (!((live[r] >> lane) & 1u)) continue;
            const int32_t pos = place(off, s_cnt, live[r], r, lane);
            s.out_code[pos] = code[r];
            s.out_ts[pos] = hsjoin::wrap_sub(ts[r], a.delta);
            s.out_flags[pos] = flags[r];
        }
        move_cols(s, a.cap, t0, live, off, s_cnt, lane);
        if (n_done == kDoneBatch) {
            publish_done(sc, s_done, s_doff, n_done);
            n_done = 0;
        }
        __syncthreads();  // s_cnt and s_ticket
    }
    publish_done(sc, s_done, s_doff, n_done);

    // 2. the dead entries, once the side's live total is known
    for (int u = blockIdx.x; u < 2 * tiles; u += gridDim.x) {
        const int side = u & 1, tile = u >> 1;
        const HsJoinEvictSide &s = a.s[side];
        if (threadIdx.x == 0) {
            unsigned long long tot;
            while (((tot = *(volatile unsigned long long *)&sc.total[side])
                    >> 62) == 0)
                __nanosleep(64);
            unsigned d;
            while ((d = *(volatile unsigned *)&sc.done[(size_t)side * tiles +
                                                       tile]) == 0)
                __nanosleep(64);
            __threadfence();
            // the dead entries before the tile: all before it less the
            // live, after the side's live ones
            s_first = (long long)(tot & hs::kVal) +
                      (long long)tile * kTileN - (d - 1);
        }
        __syncthreads();
        const int64_t base = (int64_t)tile * kTileN;
        const uint32_t w = lane < kPer
            ? __ldcg(sc.ballot + ((size_t)side * tiles + tile) * kWords +
                     lane * kWarps + warp)
            : 0u;
        uint32_t dead[kPer];
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
            const int64_t i0 = base + r * kThreads + warp * 32;
            const int64_t in = min(max(a.cap - i0, (int64_t)0), (int64_t)32);
            const uint32_t present = in == 32 ? 0xFFFFFFFFu
                                              : (1u << in) - 1u;
            dead[r] = present & ~__shfl_sync(0xFFFFFFFFu, w, r);
            if (lane == 0) s_cnt[r * kWarps + warp] = __popc(dead[r]);
        }
        const int64_t t0 = base + threadIdx.x;
        int32_t flags[kPer];
        load_set(s.flags, t0, dead, lane, flags);
        scan_words(s_cnt, &s_tot);
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
            if (!((dead[r] >> lane) & 1u)) continue;
            const int32_t pos = place(s_first, s_cnt, dead[r], r, lane);
            s.out_code[pos] = HS_JOIN_SENT;
            s.out_ts[pos] = 0;
            s.out_flags[pos] = flags[r];
        }
        move_cols(s, a.cap, t0, dead, s_first, s_cnt, lane);
        __syncthreads();  // s_cnt and s_first of the next tile
    }
}

}  // namespace

extern "C" int64_t hs_join_evict_scratch_bytes(int32_t cap) {
    const int tiles = tiles_of(cap);
    return (int64_t)zeroed_bytes(tiles) +
           (int64_t)2 * tiles * kWords * (int64_t)sizeof(uint32_t);
}

extern "C" int hs_join_evict(const HsJoinEvictArgs *args, void *stream) {
    const HsJoinEvictArgs &a = *args;
    cudaStream_t st = (cudaStream_t)stream;
    if (a.cap <= 0 || a.s[0].n_cols < 0 || a.s[1].n_cols < 0 ||
        a.s[0].n_cols > HS_JOIN_MAX_COLS || a.s[1].n_cols > HS_JOIN_MAX_COLS)
        return (int)cudaErrorInvalidValue;
    const int tiles = tiles_of(a.cap);
    int sms = 0;
    cudaError_t err = hs::current_sms(&sms);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemsetAsync(a.scratch, 0, zeroed_bytes(tiles), st);
    if (err != cudaSuccess) return (int)err;
    const int blocks = std::min(2 * tiles, sms * kBlocksPerSm);
    evict_kernel<<<blocks, kThreads, 0, st>>>(a);
    return (int)cudaGetLastError();
}
