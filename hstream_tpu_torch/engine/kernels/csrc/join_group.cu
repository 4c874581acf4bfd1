// The key-sharded join's grouping: a batch's valid records sorted once by
// the table place of their owner, for the table launches of the probe
// (join_probe.cu hs_join_probe_table) and the insert (join_insert.cu
// hs_join_insert_table) on one card.
//
// Replaces, in hstream_tpu/parallel/lattice.py:394-439 and :470-528,
// the `owned` masks of the key-sharded probe and insert (code mod
// n_shards == shard, the floor's), which every shard applies to the
// whole batch; and, of the first sharded design, the ownership test
// inside every shard's probe kernels and the compaction of the owned
// records that every shard's insert ran (two launches a shard, each
// reading the batch).
//
// A counting sort by place, stable, in two launches: group_count_kernel
// counts each block's records of each place (a warp's equal places add
// once, __match_any_sync), then group_scatter_kernel gives each group its
// first place (the groups in table order, each starting at a multiple of
// kGroupTile, so that no probe tile spans two stores), each block its
// offset in each group (the counts of the blocks before it), and each
// record its rank among its block's records of its place, taken item by
// item (1024 records) in batch order (its rank among its warp's equal
// places, then one warp scan a group over the block's (item, warp)
// runs); records whose owner is not in the
// table are dropped. Each group is then the records its shard owns, in
// batch order: sorted by (code, ts), as the batch is.
//
// Bound on the H100: bytes, the codes read twice (once a launch), the
// times once, and the index, code and ts written a record (2^20
// records: 24 MB, ~7 us at 3.35 TB/s).

#include <cuda_runtime.h>

#include "join_core.cuh"

namespace {

using hsjoin::kGroupBlock;
using hsjoin::kGroupItems;
using hsjoin::kGroupThreads;

constexpr unsigned kFull = 0xFFFFFFFFu;

// the table place of a record's owner from its code (the sentinel for a
// record past n), -1 where the record is not valid or its owner is not
// in the table
__device__ __forceinline__ int place_of(const HsJoinGroupArgs &a,
                                        int32_t c) {
    if (c >= HS_JOIN_SENT) return -1;
    int32_t r = c % a.n_shards;
    if (r < 0) r += a.n_shards;
    return a.pos[r];
}

// the codes of a thread's records (item by item), every load issued
// before any is used
__device__ __forceinline__ void load_codes(const HsJoinGroupArgs &a,
                                           int32_t (&c)[kGroupItems]) {
#pragma unroll
    for (int it = 0; it < kGroupItems; ++it) {
        const int64_t j = (int64_t)blockIdx.x * kGroupBlock +
                          it * kGroupThreads + threadIdx.x;
        c[it] = j < a.n ? a.batch[j] : HS_JOIN_SENT;
    }
}

__global__ void __launch_bounds__(kGroupThreads)
group_count_kernel(const __grid_constant__ HsJoinGroupArgs a) {
    __shared__ int32_t s_cnt[HS_JOIN_GROUP];
    const hsjoin::Grouping gr =
        hsjoin::grouping(a.grouping, a.bcap, a.n_group);
    if (threadIdx.x < HS_JOIN_GROUP) s_cnt[threadIdx.x] = 0;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    int32_t code[kGroupItems];
    load_codes(a, code);
#pragma unroll
    for (int it = 0; it < kGroupItems; ++it) {
        const int g = place_of(a, code[it]);
        const unsigned peers = __match_any_sync(kFull, g);
        if (g >= 0 && lane == __ffs(peers) - 1)
            atomicAdd(&s_cnt[g], __popc(peers));
    }
    __syncthreads();
    if (threadIdx.x < a.n_group)
        gr.blocks[(int64_t)blockIdx.x * a.n_group + threadIdx.x] =
            s_cnt[threadIdx.x];
}

__global__ void __launch_bounds__(kGroupThreads)
group_scatter_kernel(const __grid_constant__ HsJoinGroupArgs a,
                     int32_t blocks) {
    constexpr int kWarps = kGroupThreads / 32;
    constexpr int kRuns = kGroupItems * kWarps;  // (item, warp), in order
    __shared__ int32_t s_tot[HS_JOIN_GROUP], s_run[HS_JOIN_GROUP];
    __shared__ int32_t s_cnt[HS_JOIN_GROUP][kRuns];
    const hsjoin::Grouping gr =
        hsjoin::grouping(a.grouping, a.bcap, a.n_group);
    const int G = a.n_group;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // the records' codes and times first: their loads overlap the
    // offsets' sums below
    int32_t code[kGroupItems], ts[kGroupItems];
    load_codes(a, code);
#pragma unroll
    for (int it = 0; it < kGroupItems; ++it) {
        const int64_t j = (int64_t)blockIdx.x * kGroupBlock +
                          it * kGroupThreads + threadIdx.x;
        ts[it] = j < a.n ? a.batch[a.bcap + j] : 0;
    }
    if (threadIdx.x < HS_JOIN_GROUP) {
        s_tot[threadIdx.x] = 0;
        s_run[threadIdx.x] = 0;
    }
    for (int q = threadIdx.x; q < G * kRuns; q += kGroupThreads)
        (&s_cnt[0][0])[q] = 0;
    __syncthreads();
    // each group's records in all blocks, and in the blocks before this
    for (int64_t e = threadIdx.x; e < (int64_t)blocks * G;
         e += kGroupThreads) {
        const int32_t c = gr.blocks[e];
        const int g = (int)(e % G);
        if (c != 0) {
            atomicAdd(&s_tot[g], c);
            if (e / G < blockIdx.x) atomicAdd(&s_run[g], c);
        }
    }
    // each warp's records of each group, item by item
    int g[kGroupItems];
    unsigned peers[kGroupItems];
#pragma unroll
    for (int it = 0; it < kGroupItems; ++it) {
        g[it] = place_of(a, code[it]);
        peers[it] = __match_any_sync(kFull, g[it]);
        if (g[it] >= 0 && lane == __ffs(peers[it]) - 1)
            s_cnt[g[it]][it * kWarps + warp] = __popc(peers[it]);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        int32_t at = 0;
        for (int q = 0; q < G; ++q) {
            if (blockIdx.x == 0) {
                gr.base[q] = at;
                gr.count[q] = s_tot[q];
            }
            s_run[q] += at;
            at += (s_tot[q] + hsjoin::kGroupTile - 1) /
                  hsjoin::kGroupTile * hsjoin::kGroupTile;
        }
        if (blockIdx.x == 0) gr.base[G] = at;
    }
    __syncthreads();
    // per group (warp q), the exclusive offsets of the block's (item,
    // warp) runs in record order from the group's place: four runs a
    // lane, then a warp scan of the lanes' sums
    static_assert(kRuns == 4 * 32, "four runs a lane");
    if (warp < G) {
        int32_t v[4], sum = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            v[k] = s_cnt[warp][4 * lane + k];
            sum += v[k];
        }
        int32_t at = s_run[warp] +
                     (int32_t)hsjoin::warp_incl_scan((uint32_t)sum) - sum;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            s_cnt[warp][4 * lane + k] = at;
            at += v[k];
        }
    }
    __syncthreads();
    const unsigned lt = (1u << lane) - 1u;
#pragma unroll
    for (int it = 0; it < kGroupItems; ++it) {
        if (g[it] < 0) continue;
        const int64_t j = (int64_t)blockIdx.x * kGroupBlock +
                          it * kGroupThreads + threadIdx.x;
        const int32_t at = s_cnt[g[it]][it * kWarps + warp] +
                           __popc(peers[it] & lt);
        gr.idx[at] = (int32_t)j;
        gr.code[at] = code[it];
        gr.ts[at] = ts[it];
    }
}

}  // namespace

extern "C" int64_t hs_join_group_bytes(int32_t bcap, int32_t n_group) {
    return hsjoin::grouping_words(bcap, n_group) * (int64_t)sizeof(int32_t);
}

extern "C" int hs_join_group(const HsJoinGroupArgs *args, void *stream) {
    const HsJoinGroupArgs &a = *args;
    if (a.bcap < 1 || a.n < 0 || a.n > a.bcap || a.n_shards < 1 ||
        a.n_shards > HS_JOIN_MAX_SHARDS || a.n_group < 1 ||
        a.n_group > HS_JOIN_GROUP || a.n_group > a.n_shards ||
        a.grouping == nullptr)
        return (int)cudaErrorInvalidValue;
    unsigned named = 0;  // each place named by one shard
    for (int s = 0; s < a.n_shards; ++s) {
        const int g = a.pos[s];
        if (g < -1 || g >= a.n_group || (g >= 0 && ((named >> g) & 1u)))
            return (int)cudaErrorInvalidValue;
        if (g >= 0) named |= 1u << g;
    }
    if (named != (1u << a.n_group) - 1u) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int32_t blocks = hsjoin::group_blocks(a.bcap);
    group_count_kernel<<<blocks, kGroupThreads, 0, st>>>(a);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    group_scatter_kernel<<<blocks, kGroupThreads, 0, st>>>(a, blocks);
    return (int)cudaGetLastError();
}
