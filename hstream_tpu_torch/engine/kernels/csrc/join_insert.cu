// Interval-join insert: merge the (code, ts)-sorted batch into the
// sorted store, writing the other of the side's two stores.
//
// Replaces hstream_tpu/engine/lattice.py:962-981 _join_insert (the
// insert half of join_probe_insert and join_probe_insert_step): one
// stable 2-key sort of the concatenation store ++ batch (the batch's
// padding and codes at or above the sentinel keyed as the sentinel),
// its first `cap` entries kept, flags and columns moved with their
// entry.
//
// Both inputs are already sorted by (code, ts): the store because every
// program that writes it keeps it so, the batch because the host sorts
// it (np.lexsort) and pads it with (sentinel, 0). So this is a stable
// merge of two sorted runs, the store's entry first on equal keys, which
// is exactly the stable sort's order of store ++ batch, sentinels
// included; places at or past `cap` are dropped (the host grows or
// evicts before that can drop a live entry).
//
// Bound on the H100: bytes (the store and the batch read once, the
// store written once). Two launches: the splits, the merge.
//
// What held the first design back: every store entry binary-searched
// the batch and every batch entry the store (~22 dependent loads each),
// then scattered its entry to its place. Design: a merge path (Green,
// McColl and Bader, 2012). Each block owns 2048 consecutive output
// places below `cap`. split_kernel first finds where every block's first
// place splits the two runs, a warp search each (32 probes a step,
// join_core.cuh), all at once, so no block waits out its own searches;
// the block stages its two key runs in shared memory, each thread finds
// its own split of them and merges 8 places, the places' sources go
// through shared memory, and consecutive threads write consecutive
// places of code, ts, flags and every column.
//
// A key shard of a mesh (n_shards > 1) inserts only the records it owns
// (code mod n_shards == shard; hstream_tpu/parallel/lattice.py:394-439
// and :470-528, _join_insert with `owned`). Its batch run is then the
// owned records, a subsequence of the sorted batch and so sorted: two
// launches compact their indices (a count per block of 1024 records,
// then each block's prefix from the counts before it and a block scan)
// and the merge reads the batch through them, the places past the owned
// count keyed (sentinel, INT_MAX), after every store sentinel. Where the
// reference keeps an unowned record as a dead (sentinel, ts) entry, this
// drops it: the two stores agree on every live entry, and on every entry
// where the batch's times are >= 0, as the join executor's rebase keeps
// them. The template's false branch is the single-card merge as before.

#include <cuda_runtime.h>

#include "join_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;
constexpr int kTile = kThreads * kPer;  // output places a block
constexpr int32_t kFromBatch = 1 << 30;  // a source index from the batch
constexpr int kOwnBlock = 1024;          // records a compaction block

// store entry i goes before batch entry j: the store first on equal keys
__device__ __forceinline__ bool store_first(int32_t sc, int32_t st,
                                            int32_t bc, int32_t bt) {
    return hsjoin::key_before(sc, st, bc, bt, true);
}

// the batch run the merge reads: the whole batch (single card), or the
// owned records through their compacted indices (a key shard)
template <bool kOwn>
struct BatchRun {
    const int32_t *code, *ts;
    const int32_t *idx;  // kOwn: the owned records' columns, in order
    int32_t n;           // records in the run (kOwn: owned ones)

    __device__ __forceinline__ BatchRun(const HsJoinInsertArgs &a,
                                        const int32_t *own) {
        code = a.batch;
        ts = a.batch + a.bcap;
        idx = own;
        n = kOwn ? own[a.bcap] : a.n;
    }
    __device__ __forceinline__ int32_t key_code(int32_t x) const {
        if (!kOwn) return hsjoin::batch_code(code, x, n);
        return x < n ? code[idx[x]] : HS_JOIN_SENT;
    }
    __device__ __forceinline__ int32_t key_ts(int32_t x) const {
        if (!kOwn) return ts[x];
        return x < n ? ts[idx[x]] : INT_MAX;
    }
    __device__ __forceinline__ int32_t column(int32_t x) const {
        return kOwn ? idx[x] : x;
    }
};

__device__ __forceinline__ bool owns(const HsJoinInsertArgs &a, int32_t j) {
    if (j >= a.n) return false;
    const int32_t c = a.batch[j];
    return c < HS_JOIN_SENT && hsjoin::owned(c, a.n_shards, a.shard);
}

// owned records of each block of kOwnBlock
__global__ void __launch_bounds__(kOwnBlock)
own_count_kernel(const __grid_constant__ HsJoinInsertArgs a,
                 int32_t *counts) {
    const int32_t j = blockIdx.x * kOwnBlock + threadIdx.x;
    const int c = __syncthreads_count(owns(a, j));
    if (threadIdx.x == 0) counts[blockIdx.x] = c;
}

// the owned records' indices in order: own[0 .. n_owned), and n_owned at
// own[bcap]; a block's first place is the sum of the counts before it
__global__ void __launch_bounds__(kOwnBlock)
own_compact_kernel(const __grid_constant__ HsJoinInsertArgs a,
                   const int32_t *counts, int32_t *own) {
    __shared__ int32_t s_warp[kOwnBlock / 32];
    __shared__ int32_t s_base;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int32_t part = 0;
    for (int32_t b = threadIdx.x; b < (int32_t)blockIdx.x; b += kOwnBlock)
        part += counts[b];
    for (int d = 16; d > 0; d >>= 1)
        part += __shfl_down_sync(0xFFFFFFFFu, part, d);
    if (lane == 0) s_warp[warp] = part;
    __syncthreads();
    if (threadIdx.x == 0) {
        int32_t t = 0;
        for (int w = 0; w < kOwnBlock / 32; ++w) t += s_warp[w];
        s_base = t;
    }
    __syncthreads();
    const int32_t j = blockIdx.x * kOwnBlock + threadIdx.x;
    const bool o = owns(a, j);
    const unsigned m = __ballot_sync(0xFFFFFFFFu, o);
    if (lane == 0) s_warp[warp] = __popc(m);
    __syncthreads();
    int32_t before = s_base;
    for (int w = 0; w < warp; ++w) before += s_warp[w];
    if (o) own[before + __popc(m & ((1u << lane) - 1u))] = j;
    if (blockIdx.x == gridDim.x - 1 && threadIdx.x == kOwnBlock - 1) {
        int32_t total = s_base;
        for (int w = 0; w < kOwnBlock / 32; ++w) total += s_warp[w];
        own[a.bcap] = total;
    }
}

// store entries among the first min(t * kTile, cap) places, for every
// tile boundary t at once, a warp each: i with store[i] before batch[d -
// 1 - i] (32 probes a step)
template <bool kOwn>
__global__ void __launch_bounds__(kThreads)
split_kernel(const __grid_constant__ HsJoinInsertArgs a, int64_t *split,
             int32_t bounds, const int32_t *own) {
    const int32_t t = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
    if (t >= bounds) return;
    const BatchRun<kOwn> b(a, own);
    const int64_t d = min((int64_t)t * kTile, (int64_t)a.cap);
    const int64_t i = hsjoin::warp_partition(
        max((int64_t)0, d - a.bcap), min(d, (int64_t)a.cap),
        [&](int64_t x) {
            const int32_t j = (int32_t)(d - 1 - x);
            return store_first(a.code[x], a.ts[x], b.key_code(j),
                               b.key_ts(j));
        });
    if ((threadIdx.x & 31) == 0) split[t] = i;
}

template <bool kOwn>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const __grid_constant__ HsJoinInsertArgs a,
             const int64_t *split, const int32_t *own) {
    __shared__ int32_t s_acode[kTile], s_ats[kTile];
    __shared__ int32_t s_bcode[kTile], s_bts[kTile];
    __shared__ int32_t s_src[kTile];
    const BatchRun<kOwn> b(a, own);
    const int64_t d0 = (int64_t)blockIdx.x * kTile;
    const int64_t d1 = min(d0 + kTile, (int64_t)a.cap);
    const int64_t i0 = split[blockIdx.x], i1 = split[blockIdx.x + 1];
    const int64_t j0 = d0 - i0;
    const int na = (int)(i1 - i0), nb = (int)((d1 - i1) - j0);
#pragma unroll 4
    for (int k = threadIdx.x; k < na; k += kThreads) {
        s_acode[k] = a.code[i0 + k];
        s_ats[k] = a.ts[i0 + k];
    }
#pragma unroll 4
    for (int k = threadIdx.x; k < nb; k += kThreads) {
        s_bcode[k] = b.key_code((int32_t)(j0 + k));
        s_bts[k] = b.key_ts((int32_t)(j0 + k));
    }
    __syncthreads();
    const int dd = threadIdx.x * kPer;
    if (dd < na + nb) {
        int lo = max(0, dd - nb), hi = min(dd, na);
        while (lo < hi) {  // this thread's split of the staged runs
            const int mid = (lo + hi) >> 1;
            const int jb = dd - 1 - mid;
            if (store_first(s_acode[mid], s_ats[mid], s_bcode[jb],
                            s_bts[jb]))
                lo = mid + 1;
            else
                hi = mid;
        }
        int ia = lo, ib = dd - lo;
        for (int k = 0; k < kPer && dd + k < na + nb; ++k) {
            const bool take_a =
                ia < na && (ib >= nb || store_first(s_acode[ia], s_ats[ia],
                                                    s_bcode[ib], s_bts[ib]));
            s_src[dd + k] = take_a ? ia++ : (kFromBatch | ib++);
        }
    }
    __syncthreads();
    for (int p = threadIdx.x; p < na + nb; p += kThreads) {
        const int src = s_src[p];
        const int64_t pos = d0 + p;
        const bool from_b = (src & kFromBatch) != 0;
        const int k = src & (kFromBatch - 1);
        if (from_b) {
            const int64_t j = b.column((int32_t)(j0 + k));
            a.out_code[pos] = s_bcode[k];
            a.out_ts[pos] = s_bts[k];
            a.out_flags[pos] = a.batch[3 * (size_t)a.bcap + j];
            for (int32_t c = 0; c < a.n_cols; ++c)
                a.out_cols[(size_t)c * a.cap + pos] =
                    a.batch[(4 + (size_t)c) * a.bcap + j];
        } else {
            const int64_t i = i0 + k;
            a.out_code[pos] = s_acode[k];
            a.out_ts[pos] = s_ats[k];
            a.out_flags[pos] = a.flags[i];
            for (int32_t c = 0; c < a.n_cols; ++c)
                a.out_cols[(size_t)c * a.cap + pos] =
                    a.cols[(size_t)c * a.cap + i];
        }
    }
}

}  // namespace

// the merge's splits, then (a key shard) the compaction's block counts
// and the owned indices with their count
extern "C" int64_t hs_join_insert_scratch_bytes(int32_t cap, int32_t bcap) {
    const int64_t blocks = ((int64_t)bcap + kOwnBlock - 1) / kOwnBlock;
    return ((int64_t)(cap + kTile - 1) / kTile + 1) * (int64_t)sizeof(int64_t)
           + (blocks + (int64_t)bcap + 1) * (int64_t)sizeof(int32_t);
}

extern "C" int hs_join_insert(const HsJoinInsertArgs *args, void *stream) {
    const HsJoinInsertArgs &a = *args;
    if (a.cap <= 0 || a.bcap < 0 || a.n_cols < 0 ||
        a.n_cols > HS_JOIN_MAX_COLS || a.n < 0 || a.n > a.bcap ||
        (a.n_shards > 1 && (a.shard < 0 || a.shard >= a.n_shards)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int32_t tiles = (a.cap + kTile - 1) / kTile;
    int64_t *split = (int64_t *)a.scratch;
    const unsigned split_blocks =
        (tiles + 1 + kThreads / 32 - 1) / (kThreads / 32);
    int err;
    if (a.n_shards > 1 && a.bcap > 0) {  // a key shard: its records only
        const int32_t blocks = (a.bcap + kOwnBlock - 1) / kOwnBlock;
        int32_t *counts = (int32_t *)(split + tiles + 1);
        int32_t *own = counts + blocks;
        own_count_kernel<<<blocks, kOwnBlock, 0, st>>>(a, counts);
        own_compact_kernel<<<blocks, kOwnBlock, 0, st>>>(a, counts, own);
        split_kernel<true><<<split_blocks, kThreads, 0, st>>>(
            a, split, tiles + 1, own);
        err = (int)cudaGetLastError();
        if (err != 0) return err;
        merge_kernel<true><<<tiles, kThreads, 0, st>>>(a, split, own);
        return (int)cudaGetLastError();
    }
    split_kernel<false><<<split_blocks, kThreads, 0, st>>>(
        a, split, tiles + 1, nullptr);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    merge_kernel<false><<<tiles, kThreads, 0, st>>>(a, split, nullptr);
    return (int)cudaGetLastError();
}
