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

#include <cuda_runtime.h>

#include "join_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;
constexpr int kTile = kThreads * kPer;  // output places a block
constexpr int32_t kFromBatch = 1 << 30;  // a source index from the batch

// store entry i goes before batch entry j: the store first on equal keys
__device__ __forceinline__ bool store_first(int32_t sc, int32_t st,
                                            int32_t bc, int32_t bt) {
    return hsjoin::key_before(sc, st, bc, bt, true);
}

// store entries among the first min(t * kTile, cap) places, for every
// tile boundary t at once, a warp each: i with store[i] before batch[d -
// 1 - i] (32 probes a step)
__global__ void __launch_bounds__(kThreads)
split_kernel(const __grid_constant__ HsJoinInsertArgs a, int64_t *split,
             int32_t bounds) {
    const int32_t t = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
    if (t >= bounds) return;
    const int32_t *bcode = a.batch;
    const int32_t *bts = a.batch + a.bcap;
    const int64_t d = min((int64_t)t * kTile, (int64_t)a.cap);
    const int64_t i = hsjoin::warp_partition(
        max((int64_t)0, d - a.bcap), min(d, (int64_t)a.cap),
        [&](int64_t x) {
            const int64_t j = d - 1 - x;
            return store_first(a.code[x], a.ts[x],
                               hsjoin::batch_code(bcode, (int32_t)j, a.n),
                               bts[j]);
        });
    if ((threadIdx.x & 31) == 0) split[t] = i;
}

__global__ void __launch_bounds__(kThreads)
merge_kernel(const __grid_constant__ HsJoinInsertArgs a,
             const int64_t *split) {
    __shared__ int32_t s_acode[kTile], s_ats[kTile];
    __shared__ int32_t s_bcode[kTile], s_bts[kTile];
    __shared__ int32_t s_src[kTile];
    const int32_t *bcode = a.batch;
    const int32_t *bts = a.batch + a.bcap;
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
        s_bcode[k] = hsjoin::batch_code(bcode, (int32_t)(j0 + k), a.n);
        s_bts[k] = bts[j0 + k];
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
            const int64_t j = j0 + k;
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

extern "C" int64_t hs_join_insert_scratch_bytes(int32_t cap) {
    return ((int64_t)(cap + kTile - 1) / kTile + 1) * (int64_t)sizeof(int64_t);
}

extern "C" int hs_join_insert(const HsJoinInsertArgs *args, void *stream) {
    const HsJoinInsertArgs &a = *args;
    if (a.cap <= 0 || a.bcap < 0 || a.n_cols < 0 ||
        a.n_cols > HS_JOIN_MAX_COLS || a.n < 0 || a.n > a.bcap)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int32_t tiles = (a.cap + kTile - 1) / kTile;
    int64_t *split = (int64_t *)a.scratch;
    split_kernel<<<(tiles + 1 + kThreads / 32 - 1) / (kThreads / 32),
                   kThreads, 0, st>>>(a, split, tiles + 1);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    merge_kernel<<<tiles, kThreads, 0, st>>>(a, split);
    return (int)cudaGetLastError();
}
