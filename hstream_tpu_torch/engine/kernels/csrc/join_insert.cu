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
// The key shards of a mesh whose stores lie on one card insert in one
// launch sequence over the table of their stores (hs_join_insert_table;
// hstream_tpu/parallel/lattice.py:394-439 and :470-528, _join_insert
// with `owned`): a shard's batch run is its group of the batch's
// grouping (join_group.cu: the valid records it owns, in batch order, so
// sorted), the places past its count keyed (sentinel, INT_MAX), after
// every store sentinel; one split launch finds every tile boundary of
// every shard's store, and the merge's blocks take the output tiles of
// every shard's store. Where the reference keeps an unowned record as a
// dead (sentinel, ts) entry, this drops it: the two stores agree on
// every live entry, and on every entry where the batch's times are >= 0,
// as the join executor's rebase keeps them. The templates' false branch
// is the single-card merge as before.

#include <cuda_runtime.h>

#include "join_core.cuh"

namespace {

using hsjoin::TableArg;

constexpr int kThreads = 256;
constexpr int kPer = 8;
constexpr int kTile = kThreads * kPer;  // output places a block
constexpr int32_t kFromBatch = 1 << 30;  // a source index from the batch

// store entry i goes before batch entry j: the store first on equal keys
__device__ __forceinline__ bool store_first(int32_t sc, int32_t st,
                                            int32_t bc, int32_t bt) {
    return hsjoin::key_before(sc, st, bc, bt, true);
}

// one shard's merge: its store, the store it writes, and its batch run:
// the whole batch (single card), or its group of the grouping (a table)
template <bool kT>
struct Shard {
    const int32_t *code, *ts, *flags, *cols;
    int32_t *out_code, *out_ts, *out_flags, *out_cols;
    const int32_t *bcode, *bts;  // the run's keys: the batch's, or the
                                 // group's own (kT)
    const int32_t *idx;  // kT: the group's records' batch indices
    int32_t n;           // records in the run

    __device__ __forceinline__ Shard(const HsJoinInsertArgs &a,
                                     const TableArg<kT> &tb, int g) {
        if constexpr (kT) {
            const HsJoinTableShard &h = tb.sh[g];
            code = h.code, ts = h.ts, flags = h.flags, cols = h.cols;
            out_code = h.out_code, out_ts = h.out_ts;
            out_flags = h.out_flags, out_cols = h.out_cols;
            const hsjoin::Grouping gr = hsjoin::grouping(
                (int32_t *)tb.grouping, a.bcap, tb.n_group);
            idx = gr.idx + gr.base[g];
            bcode = gr.code + gr.base[g];
            bts = gr.ts + gr.base[g];
            n = gr.count[g];
        } else {
            bcode = a.batch;
            bts = a.batch + a.bcap;
            code = a.code, ts = a.ts, flags = a.flags, cols = a.cols;
            out_code = a.out_code, out_ts = a.out_ts;
            out_flags = a.out_flags, out_cols = a.out_cols;
            idx = nullptr;
            n = a.n;
        }
    }
    __device__ __forceinline__ int32_t key_code(int32_t x) const {
        if (!kT) return hsjoin::batch_code(bcode, x, n);
        return x < n ? bcode[x] : HS_JOIN_SENT;
    }
    __device__ __forceinline__ int32_t key_ts(int32_t x) const {
        if (!kT) return bts[x];
        return x < n ? bts[x] : INT_MAX;
    }
    __device__ __forceinline__ int32_t column(int32_t x) const {
        return kT ? idx[x] : x;
    }
};

// store entries among the first min(t * kTile, cap) places, for every
// tile boundary t of every shard at once (bounds a shard), a warp each:
// i with store[i] before batch[d - 1 - i] (32 probes a step)
template <bool kT>
__global__ void __launch_bounds__(kThreads)
split_kernel(const __grid_constant__ HsJoinInsertArgs a,
             const __grid_constant__ TableArg<kT> tb, int64_t *split,
             int32_t bounds, int32_t n_group) {
    const int32_t w = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
    if (w >= bounds * n_group) return;
    const int g = w / bounds;
    const int32_t t = w - g * bounds;
    const Shard<kT> b(a, tb, g);
    const int64_t d = min((int64_t)t * kTile, (int64_t)a.cap);
    // a table's run past its group is after every store entry, so at
    // most its n records precede place d
    const int64_t run = kT ? (int64_t)b.n : (int64_t)a.bcap;
    const int64_t i = hsjoin::warp_partition(
        max((int64_t)0, d - run), min(d, (int64_t)a.cap),
        [&](int64_t x) {
            const int32_t j = (int32_t)(d - 1 - x);
            return store_first(b.code[x], b.ts[x], b.key_code(j),
                               b.key_ts(j));
        });
    if ((threadIdx.x & 31) == 0) split[w] = i;
}

// block b merges output tile b mod tiles of shard b div tiles
template <bool kT>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const __grid_constant__ HsJoinInsertArgs a,
             const __grid_constant__ TableArg<kT> tb, const int64_t *split,
             int32_t tiles) {
    __shared__ int32_t s_acode[kTile], s_ats[kTile];
    __shared__ int32_t s_bcode[kTile], s_bts[kTile];
    __shared__ int32_t s_src[kTile];
    const int g = (int)(blockIdx.x / tiles);
    const int32_t tile = blockIdx.x - g * tiles;
    const Shard<kT> b(a, tb, g);
    split += (int64_t)g * (tiles + 1);
    const int64_t d0 = (int64_t)tile * kTile;
    const int64_t d1 = min(d0 + kTile, (int64_t)a.cap);
    const int64_t i0 = split[tile], i1 = split[tile + 1];
    const int64_t j0 = d0 - i0;
    const int na = (int)(i1 - i0), nb = (int)((d1 - i1) - j0);
#pragma unroll 4
    for (int k = threadIdx.x; k < na; k += kThreads) {
        s_acode[k] = b.code[i0 + k];
        s_ats[k] = b.ts[i0 + k];
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
            b.out_code[pos] = s_bcode[k];
            b.out_ts[pos] = s_bts[k];
            b.out_flags[pos] = a.batch[3 * (size_t)a.bcap + j];
            for (int32_t c = 0; c < a.n_cols; ++c)
                b.out_cols[(size_t)c * a.cap + pos] =
                    a.batch[(4 + (size_t)c) * a.bcap + j];
        } else {
            const int64_t i = i0 + k;
            b.out_code[pos] = s_acode[k];
            b.out_ts[pos] = s_ats[k];
            b.out_flags[pos] = b.flags[i];
            for (int32_t c = 0; c < a.n_cols; ++c)
                b.out_cols[(size_t)c * a.cap + pos] =
                    b.cols[(size_t)c * a.cap + i];
        }
    }
}

bool insert_args_ok(const HsJoinInsertArgs &a) {
    return !(a.cap <= 0 || a.bcap < 0 || a.n_cols < 0 ||
             a.n_cols > HS_JOIN_MAX_COLS || a.n < 0 || a.n > a.bcap);
}

template <bool kT>
int insert_launch(const HsJoinInsertArgs &a, const TableArg<kT> &tb,
                  int n_group, cudaStream_t st) {
    const int32_t tiles = (a.cap + kTile - 1) / kTile;
    int64_t *split = (int64_t *)a.scratch;
    const int64_t warps = (int64_t)(tiles + 1) * n_group;
    const unsigned split_blocks =
        (unsigned)((warps + kThreads / 32 - 1) / (kThreads / 32));
    split_kernel<kT><<<split_blocks, kThreads, 0, st>>>(a, tb, split,
                                                        tiles + 1, n_group);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    merge_kernel<kT><<<(unsigned)tiles * n_group, kThreads, 0, st>>>(
        a, tb, split, tiles);
    return (int)cudaGetLastError();
}

}  // namespace

// the merge's splits (a table: each shard's)
extern "C" int64_t hs_join_insert_scratch_bytes(int32_t cap, int32_t bcap) {
    (void)bcap;
    return ((int64_t)(cap + kTile - 1) / kTile + 1) * (int64_t)sizeof(int64_t);
}

extern "C" int64_t hs_join_insert_table_scratch_bytes(int32_t cap,
                                                      int32_t n_group) {
    return (int64_t)n_group * hs_join_insert_scratch_bytes(cap, 0);
}

extern "C" int hs_join_insert(const HsJoinInsertArgs *args, void *stream) {
    const HsJoinInsertArgs &a = *args;
    if (!insert_args_ok(a)) return (int)cudaErrorInvalidValue;
    return insert_launch<false>(a, hsjoin::NoTable{}, 1,
                                (cudaStream_t)stream);
}

// the table's insert: the caller grouped the batch for this table
// (hs_join_group); a.code ... a.out_cols are not read, the table's
// shards' stores are
extern "C" int hs_join_insert_table(const HsJoinInsertArgs *args,
                                    const HsJoinTable *table,
                                    void *stream) {
    const HsJoinInsertArgs &a = *args;
    const HsJoinTable &t = *table;
    if (!insert_args_ok(a) || t.n_group < 1 || t.n_group > HS_JOIN_GROUP ||
        t.grouping == nullptr)
        return (int)cudaErrorInvalidValue;
    return insert_launch<true>(a, t, t.n_group, (cudaStream_t)stream);
}
