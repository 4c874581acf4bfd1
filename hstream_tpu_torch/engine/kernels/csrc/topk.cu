// Top-k fold: fold one decoded micro-batch into the TOPK and
// TOPK_DISTINCT planes [K, W, k] (float32, sorted descending, -inf
// padded), in place.
//
// Replaces hstream_tpu/engine/lattice.py:258-301 _topk_step (both
// variants), which sorts the batch by (cell, value), ranks within each
// cell, and merges with the stored plane by concat + re-sort. Top-k of a
// union is a monoid, so folding the records one by one, in any order,
// gives the same plane. It must equal the reference's bit for bit, since
// this is selection, not arithmetic:
//  * order is the total order the reference's sort uses (-0.0 below
//    +0.0), compared as sortable integers, of the value flushed as the
//    reference's compares flush it (a subnormal ranks as the zero of its
//    sign); among values that rank alike the larger bits come first
//    (the reference's sort is not stable there: ROADMAP C);
//  * TOPK keeps the k largest values with repeats, with their own bits;
//  * TOPK_DISTINCT keeps the k largest distinct values, where "distinct"
//    is float == of the flushed values, as the reference's
//    comb[..., 1:] == comb[..., :-1] is: +0.0, -0.0 and the subnormals
//    are one value, kept as the first of them in that order.
// NULL and non-finite inputs do not count (record.cuh). The values are
// stored unflushed: the reference's TOPK keeps a subnormal's bits.
//
// Bound on the H100: bytes of the decoded columns; most records are
// rejected after one read of their cell's k-th value.
//
// Design: one thread per (record, window). A record first reads its
// cell's k-th value without a lock and skips when it is not larger
// (the k-th value only grows, so a stale read only costs a needless
// lock). Otherwise it takes the cell's spin lock (a CAS on an int in a
// [K, W] lock array that starts and ends zeroed), insertion-sorts into
// the k values through volatile accesses, fences, and releases. The
// lock is taken and released inside one branch, which stays safe under
// independent thread scheduling when threads of one warp contend.

#include <cuda_runtime.h>

#include "hs_kernels.h"
#include "record.cuh"

namespace {

constexpr int kBlock = 256;

// the total order of the reference's sort: -0.0 < +0.0
__device__ __forceinline__ int order_key(float v) {
    int b = __float_as_int(v);
    return b >= 0 ? b : b ^ 0x7FFFFFFF;
}

// the fold's order: the flushed value's key, then the bits' own key
__device__ __forceinline__ long long rank_key(float v) {
    return (long long)order_key(hs::ftz(v)) * (1ll << 32) +
           ((uint32_t)order_key(v) ^ 0x80000000u);
}

__device__ void insert(volatile float *vals, int k, float v, bool distinct) {
    const long long key = rank_key(v);
    for (int j = 0; j < k; ++j) {
        const float cur = vals[j];
        if (distinct && hs::ftz(cur) == hs::ftz(v)) {  // keep the first
            if (key > rank_key(cur)) vals[j] = v;
            return;
        }
        if (rank_key(cur) < key) {
            for (int t = k - 1; t > j; --t) vals[t] = vals[t - 1];
            vals[j] = v;
            return;
        }
    }
}

__global__ void __launch_bounds__(kBlock)
topk_kernel(const __grid_constant__ HsScatterArgs a) {
    int64_t tid = (int64_t)blockIdx.x * kBlock + threadIdx.x;
    if (tid >= (int64_t)a.cap * a.n_per) return;
    int i = (int)(tid / a.n_per);
    int j = (int)(tid % a.n_per);
    int start, slot;
    if (!hs::record_window(a, i, j, start, slot)) return;
    int key = a.key[i];
    if (key < 0 || key >= a.n_keys) return;
    const int64_t cell = (int64_t)key * a.n_slots + slot;
    for (int g = 0; g < a.n_aggs; ++g) {
        const HsScatterAgg &ag = a.a[g];
        if (ag.kind != HS_AGG_TOPK && ag.kind != HS_AGG_TOPK_DISTINCT)
            continue;
        float v;
        uint32_t bits;
        if (!hs::agg_input(ag, i, v, bits, false)) continue;
        const int k = ag.width;
        volatile float *vals = (volatile float *)ag.plane + cell * k;
        if (rank_key(v) <= rank_key(vals[k - 1])) continue;
        bool done = false;
        while (!done) {
            if (atomicCAS(&a.locks[cell], 0, 1) == 0) {
                __threadfence();
                insert(vals, k, v, ag.kind == HS_AGG_TOPK_DISTINCT);
                __threadfence();
                atomicExch(&a.locks[cell], 0);
                done = true;
            } else {
                __nanosleep(32);
            }
        }
    }
}

}  // namespace

extern "C" int hs_topk(const HsScatterArgs *args, void *stream) {
    int64_t total = (int64_t)args->cap * args->n_per;
    if (total == 0) return 0;
    unsigned blocks = (unsigned)((total + kBlock - 1) / kBlock);
    topk_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(*args);
    return (int)cudaGetLastError();
}
