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
// Design: a persistent grid; a thread takes groups of four records
// (strided by the block's width, grid-stride; the next group's keys in
// flight while one folds), each column of a group loaded together, and
// each record's windows (one window a record: the last window and its
// slot cached, so the divisions, by host-computed multipliers
// (record.cuh fdiv), run once a window). A value can only
// enter its cell's top k when it ranks above the cell's k-th value,
// which only grows, so any k-th value seen earlier is a valid filter (a
// stale one costs a needless insert, never a wrong plane): the global
// plane's, a plain load. The filter runs over a group from registers;
// the candidates that pass are folded one by one, the lanes of a warp
// with one cell handing their values to one lane (no two lanes of a
// warp spin on one lock), and a TOPK_DISTINCT value whose class the cell
// already holds as high is dropped before the lock. Two modes, chosen on
// the host (lattice.topk_plan):
//  * private (the planes fit in a block's shared memory, k <= 32): a
//    candidate that passes folds into the block's copy of its cell under
//    a shared-memory lock per cell (the cell's lists copied in from the
//    global planes on its first candidate), with a bit mask per cell of
//    the positions that now hold one of this batch's values and a list
//    of the cells changed; a candidate is checked again against the
//    copy's k-th value where that ranks higher. At the end each listed
//    cell (in steady state there are few or none) merges its new values
//    (the block's top k of the copied list and its records, less the
//    copied list) into the global plane, under the global lock of the
//    cell. To spare those locks on a fresh plane, where every block
//    changes every cell, each block first publishes its changed cells'
//    k-th values (a lower bound of the final k-th value) with a 64-bit
//    atomicMax, tagged with the launch's epoch so no launch reads
//    another's, and a new value below the best published bound is
//    dropped without the lock.
//  * global: a candidate that passes its cell's k-th value (a plain
//    load) takes the cell's spin lock (a CAS on an int in a [K, W] lock
//    array that starts and ends zeroed), insertion-sorts into the k
//    values through volatile accesses, fences, and releases.
// The spin locks rely on independent thread scheduling (sm_70 and
// later), which keeps a lock's holder running while threads of its own
// warp spin.

#include <cuda_runtime.h>

#include <atomic>

#include "device.cuh"
#include "hs_kernels.h"
#include "record.cuh"

namespace {

constexpr int kPrivBlock = HS_TOPK_PRIVATE_THREADS;
constexpr int kGlobalBlock = HS_TOPK_GLOBAL_THREADS;
constexpr int kPer = HS_TOPK_PER;      // records a thread's group
constexpr int kMaxSmem = 232448;       // a block's shared memory, H100
constexpr uint32_t kNegInf = 0xFF800000u;
// a private lock word's bits: held; a list of the cell changed (and the
// cell listed); the cell's lists copied in
constexpr int kHeld = 1, kChanged = 2, kLoaded = 4;

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

// the flushed value's key as an unsigned (a bound's 32 low bits)
__device__ __forceinline__ uint32_t bound_key(float v) {
    return (uint32_t)order_key(hs::ftz(v)) ^ 0x80000000u;
}

// insert v into the sorted list vals[k]: -1 when the list is unchanged,
// else the position it took, as j (shifting the rest down) or as
// k + j (replacing the lower-ranked value of its class, TOPK_DISTINCT)
__device__ int insert(volatile float *vals, int k, float v, bool distinct) {
    const long long key = rank_key(v);
    for (int j = 0; j < k; ++j) {
        const float cur = vals[j];
        if (distinct && hs::ftz(cur) == hs::ftz(v)) {  // keep the first
            if (key <= rank_key(cur)) return -1;
            vals[j] = v;
            return k + j;
        }
        if (rank_key(cur) < key) {
            for (int t = k - 1; t > j; --t) vals[t] = vals[t - 1];
            vals[j] = v;
            return j;
        }
    }
    return -1;
}

__host__ __device__ __forceinline__ bool is_topk(const HsScatterAgg &ag) {
    return ag.kind == HS_AGG_TOPK || ag.kind == HS_AGG_TOPK_DISTINCT;
}

// a global plane's cell lock
__device__ __forceinline__ void lock_cell(int *lock) {
    while (atomicCAS(lock, 0, 1) != 0) __nanosleep(32);
    __threadfence();
}

__device__ __forceinline__ void unlock_cell(int *lock) {
    __threadfence();
    atomicExch(lock, 0);
}

// the block-private state in dynamic shared memory: a lock word per
// cell; per aggregate g a mask per cell; the cells this block changed
// and their count; then per aggregate its copy of the plane
// [cells, k_g], each 16-byte aligned (hs_topk's size)
struct Private {
    int *lock;
    uint32_t *mask;   // [n_aggs, cells]
    int *list;        // [cells]: the cells this block changed
    int *count;       // how many
    float *plane;     // the first aggregate's copy
    int cells;

    __device__ float *plane_of(const HsScatterArgs &a, int g) const {
        float *p = plane;
        for (int h = 0; h < g; ++h)
            p += ((size_t)cells * a.a[h].width + 3) & ~(size_t)3;
        return p;
    }
};

// the words before the planes' copies
__host__ __device__ __forceinline__ int64_t head_words(
    const HsScatterArgs &a) {
    const int64_t cells = (int64_t)a.n_keys * a.n_slots;
    return (cells * (2 + a.n_aggs) + 1 + 3) & ~(int64_t)3;
}

__host__ __device__ __forceinline__ int64_t private_words(
    const HsScatterArgs &a) {
    const int64_t cells = (int64_t)a.n_keys * a.n_slots;
    int64_t w = head_words(a);
    for (int g = 0; g < a.n_aggs; ++g)
        w += (cells * a.a[g].width + 3) & ~(int64_t)3;
    return w;
}

// the mask after an insert at `pos` (insert's return) into k values
__device__ __forceinline__ uint32_t mask_after(uint32_t m, int pos, int k) {
    if (pos >= k) return m | (1u << (pos - k));
    const uint32_t below = (1u << pos) - 1u;
    const uint32_t all = k == 32 ? 0xFFFFFFFFu : (1u << k) - 1u;
    return ((m & below) | (1u << pos) | ((m & ~below) << 1)) & all;
}

// fold v into aggregate g's copy of the plane at `cell` under the
// cell's shared lock (private mode; the filter passed): on the cell's
// first candidate every aggregate's list is copied in from the global
// planes; what changed is marked in the cell's mask and, the first time,
// the cell listed
__device__ __forceinline__ void fold_private(const HsScatterArgs &a,
                                             const Private &pr, int g,
                                             int cell, bool distinct,
                                             float v) {
    volatile int *lock = pr.lock + cell;
    const int k = a.a[g].width;
    volatile float *pv = pr.plane_of(a, g) + (size_t)cell * k;
    bool done = false;
    while (!done) {
        const int old = *lock;
        if (!(old & kHeld) &&
            atomicCAS((int *)lock, old, old | kHeld) == old) {
            __threadfence_block();
            int now = old | kLoaded;
            if (!(old & kLoaded)) {
                for (int h = 0; h < a.n_aggs; ++h) {
                    const int kh = a.a[h].width;
                    volatile float *dst =
                        pr.plane_of(a, h) + (size_t)cell * kh;
                    const volatile float *src =
                        (const volatile float *)a.a[h].plane +
                        (int64_t)cell * kh;
                    for (int j = 0; j < kh; ++j) dst[j] = src[j];
                }
            }
            if (rank_key(v) > rank_key(pv[k - 1])) {
                const int pos = insert(pv, k, v, distinct);
                if (pos >= 0) {
                    volatile uint32_t *m =
                        pr.mask + (size_t)g * pr.cells + cell;
                    *m = mask_after(*m, pos, k);
                    if (!(old & kChanged))
                        pr.list[atomicAdd(pr.count, 1)] = cell;
                    now |= kChanged;
                }
            }
            __threadfence_block();
            atomicExch((int *)lock, now);
            done = true;
        } else {
            __nanosleep(16);
        }
    }
}

// fold v into a cell of a global plane, vals[k], under the cell's lock
// (global mode; the filter passed)
__device__ __forceinline__ void fold_global(int *lock,
                                            volatile float *vals, int k,
                                            bool distinct, float v) {
    bool done = false;
    while (!done) {
        if (atomicCAS(lock, 0, 1) == 0) {
            __threadfence();
            insert(vals, k, v, distinct);
            unlock_cell(lock);
            done = true;
        } else {
            __nanosleep(32);
        }
    }
}

// merge the new values of aggregate g's copy at `cell` (mask m, sorted
// descending) into the global plane, past the published bound
__device__ __forceinline__ void merge_cell(const HsScatterArgs &a,
                                           const Private &pr, int g,
                                           int cell, uint32_t m) {
    const HsScatterAgg &ag = a.a[g];
    const int k = ag.width;
    const float *pv = pr.plane_of(a, g) + (size_t)cell * k;
    volatile float *gv = (volatile float *)ag.plane + (int64_t)cell * k;
    const unsigned long long b =
        *(volatile unsigned long long *)&a.bounds[(size_t)g * pr.cells + cell];
    const uint32_t floor_key = (uint32_t)(b >> 32) == a.epoch ? (uint32_t)b
                                                              : 0u;
    const bool distinct = ag.kind == HS_AGG_TOPK_DISTINCT;
    bool locked = false;
    for (; m != 0u; m &= m - 1u) {
        const float v = pv[__ffs(m) - 1];
        // below another block's k-th value, or the global one: so are
        // the rest, which rank lower
        if (bound_key(v) < floor_key || rank_key(v) <= rank_key(gv[k - 1]))
            break;
        if (!locked) {
            lock_cell(&a.locks[cell]);
            locked = true;
            if (rank_key(v) <= rank_key(gv[k - 1])) break;
        }
        insert(gv, k, v, distinct);
    }
    if (locked) unlock_cell(&a.locks[cell]);
}

// a cell past every lattice: the record's windows are a HOP's, found
// one by one
constexpr int kHop = -2;

// aggregate g's raw inputs of records i0 + r * blockDim.x (loads only)
struct Raw {
    uint32_t v[kPer];
    unsigned null;   // a bit per record
};

__device__ __forceinline__ void load_raw(const HsScatterArgs &a, int g,
                                         int64_t i0, Raw &raw) {
    const HsScatterAgg &ag = a.a[g];
    raw.null = 0u;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
        const int64_t i = i0 + (int64_t)r * blockDim.x;
        const bool in = i < a.cap;
        raw.v[r] = !in ? 0u
                       : ag.vtype == HS_T_BOOL
                             ? ((const uint8_t *)ag.values)[i]
                             : ((const uint32_t *)ag.values)[i];
        if (in && ag.nulls != nullptr && ag.nulls[i]) raw.null |= 1u << r;
    }
}

// fold value v of one record into `cell` (>= 0) of aggregate g: a
// TOPK_DISTINCT value whose class the cell holds at a rank as high is
// dropped, then the fold under the cell's lock
template <bool kPriv>
__device__ __forceinline__ void fold_one(const HsScatterArgs &a,
                                         const Private &pr, int g,
                                         bool distinct, int cell, float v) {
    const int k = a.a[g].width;
    const float *gv = (const float *)a.a[g].plane + (int64_t)cell * k;
    if (distinct) {
        const long long key = rank_key(v);
        for (int j = 0; j < k; ++j) {
            const float cur = gv[j];
            if (hs::ftz(cur) != hs::ftz(v)) continue;
            if (key <= rank_key(cur)) return;
            break;
        }
    }
    if (kPriv)
        fold_private(a, pr, g, cell, distinct, v);
    else
        fold_global(&a.locks[cell], (volatile float *)gv, k, distinct, v);
}

// the filter's k-th value of aggregate g at `cell`: the global plane's
// (a plain load: a stale one is only lower) or, once the block copied
// the cell in, its copy's where that ranks higher
template <bool kPriv>
__device__ __forceinline__ long long kth_rank(const HsScatterArgs &a,
                                              const Private &pr, int g,
                                              int cell) {
    const int k = a.a[g].width;
    long long r =
        rank_key(((const float *)a.a[g].plane)[(int64_t)cell * k + k - 1]);
    if (kPriv && (((volatile int *)pr.lock)[cell] & kLoaded)) {
        const long long p = rank_key(
            ((volatile float *)pr.plane_of(a, g))[(size_t)cell * k + k - 1]);
        r = p > r ? p : r;
    }
    return r;
}

// the global plane's k-th values of aggregate g at the group's cells (a
// plain load each: a stale one is only lower), loaded together; -inf
// where there is no cell (a HOP record's windows are filtered later)
__device__ __forceinline__ void load_kth(const HsScatterArgs &a, int g,
                                         const int (&cell)[kPer],
                                         float (&kth)[kPer]) {
    const int k = a.a[g].width;
    const float *plane = (const float *)a.a[g].plane;
#pragma unroll
    for (int r = 0; r < kPer; ++r)
        kth[r] = cell[r] >= 0 ? plane[(int64_t)cell[r] * k + k - 1]
                              : __uint_as_float(kNegInf);
}

// aggregate g over one group of records, their cells (or kHop) and the
// global plane's k-th values there given: its raw inputs loaded
// together. The filter runs over the group unrolled, from registers; the
// few records that pass it are folded one at a time after it, their
// input and cell loaded again (cached), the lanes of a warp with the
// same cell handing their values to one of them, so no two lanes of a
// warp wait on one lock
template <bool kPriv>
__device__ __forceinline__ void fold_agg(const HsScatterArgs &a,
                                         const Private &pr, int g,
                                         int64_t i0,
                                         const int (&cell)[kPer],
                                         const float (&kth)[kPer]) {
    const HsScatterAgg &ag = a.a[g];
    Raw raw;
    load_raw(a, g, i0, raw);
    const bool distinct = ag.kind == HS_AGG_TOPK_DISTINCT;
    unsigned pass = 0u;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
        float v;
        uint32_t bits;
        if (cell[r] == -1 ||
            !hs::input_of(ag.vtype, raw.v[r], (raw.null >> r) & 1u, v,
                          bits, false))
            continue;
        if (rank_key(v) > rank_key(kth[r])) pass |= 1u << r;
    }
    // every lane of the warp takes part in each round (the warp's loop
    // over the groups is uniform), so the warp-wide match and the
    // shuffles within a cell's lanes are always met by all their lanes
    const int lane = threadIdx.x & 31;
    while (__any_sync(0xFFFFFFFFu, pass != 0u)) {
        const bool has = pass != 0u;
        float v = 0.0f;
        int key = -1, t = 0;
        if (has) {
            const int64_t i = i0 + (int64_t)(__ffs(pass) - 1) * blockDim.x;
            pass &= pass - 1u;
            uint32_t bits;
            hs::agg_input(ag, (int)i, v, bits, false);
            key = a.key[i];
            t = a.ts[i];
        }
        for (int j = 0; j < a.n_per; ++j) {
            int slot, c = -1;
            if (has && hs::window_slot(a, t, j, slot))
                c = key * a.n_slots + slot;
            if (c >= 0 && rank_key(v) <= kth_rank<kPriv>(a, pr, g, c))
                c = -1;
            const unsigned peers = __match_any_sync(0xFFFFFFFFu, c);
            if (c < 0) continue;
            for (unsigned m = peers; m != 0u; m &= m - 1u) {
                const float vp = __shfl_sync(peers, v, __ffs(m) - 1);
                if (lane == __ffs(peers) - 1)
                    fold_one<kPriv>(a, pr, g, distinct, c, vp);
            }
        }
    }
}

// a thread's cache of its last record's window (one window a record):
// [lo, lo + advance) as exact integers, and its cell offset (the slot)
// or -1 (late or before the epoch)
struct WindowCache {
    int64_t lo = 0x7FFFFFFFFFFFFFFFll;
    int slot = -1;
};

__device__ __forceinline__ int cached_slot(const HsScatterArgs &a, int t,
                                           WindowCache &wc) {
    if (a.advance <= 0) return 0;
    const int64_t d = (int64_t)t - wc.lo;
    if (d >= 0 && d < a.advance) return wc.slot;
    wc.lo = (int64_t)hs::fdiv(t, a.adv_div) * a.advance;
    if (!hs::window_slot(a, t, 0, wc.slot)) wc.slot = -1;
    return wc.slot;
}

// one group's keys, timestamps and valid flags (loads only)
struct Keys {
    int key[kPer], t[kPer];
    unsigned ok;
};

__device__ __forceinline__ void load_keys(const HsScatterArgs &a, int64_t i0,
                                          Keys &ks) {
    ks.ok = 0u;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
        const int64_t i = i0 + (int64_t)r * blockDim.x;
        const bool in = i < a.cap;
        ks.key[r] = in ? a.key[i] : -1;
        ks.t[r] = in ? a.ts[i] : 0;
        ks.ok |= (unsigned)(in && a.valid[i]) << r;
    }
}

// one group of kPer records, blockDim.x apart from i0, its keys loaded:
// their cells, then each aggregate's inputs
template <bool kPriv>
__device__ __forceinline__ void fold_group(const HsScatterArgs &a,
                                           const Private &pr, int64_t i0,
                                           const Keys &ks, WindowCache &wc) {
    int cell[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
        cell[r] = -1;
        if (!((ks.ok >> r) & 1u) || ks.key[r] < 0 || ks.key[r] >= a.n_keys)
            continue;
        if (a.n_per != 1) {
            cell[r] = kHop;
            continue;
        }
        const int slot = cached_slot(a, ks.t[r], wc);
        if (slot >= 0) cell[r] = ks.key[r] * a.n_slots + slot;
    }
    // the first two aggregates' k-th values loaded together with the
    // first one's inputs, the rest's in turn
    float kth0[kPer], kth1[kPer];
    load_kth(a, 0, cell, kth0);
    if (a.n_aggs > 1) load_kth(a, 1, cell, kth1);
    fold_agg<kPriv>(a, pr, 0, i0, cell, kth0);
    if (a.n_aggs > 1) fold_agg<kPriv>(a, pr, 1, i0, cell, kth1);
    for (int g = 2; g < a.n_aggs; ++g) {
        load_kth(a, g, cell, kth0);
        fold_agg<kPriv>(a, pr, g, i0, cell, kth0);
    }}

template <bool kPriv>
__global__ void __launch_bounds__(kPriv ? kPrivBlock : kGlobalBlock, 1)
topk_kernel(const __grid_constant__ HsScatterArgs a) {
    extern __shared__ int4 smem4[];
    Private pr;
    if (kPriv) {
        pr.cells = a.n_keys * a.n_slots;
        pr.lock = (int *)smem4;
        pr.mask = (uint32_t *)(pr.lock + pr.cells);
        pr.list = (int *)(pr.mask + (size_t)a.n_aggs * pr.cells);
        pr.count = pr.list + pr.cells;
        pr.plane = (float *)pr.lock + head_words(a);
        for (int c = threadIdx.x; c < pr.cells * (1 + a.n_aggs);
             c += blockDim.x)
            pr.lock[c] = 0;   // the locks and the masks
        if (threadIdx.x == 0) *pr.count = 0;
        __syncthreads();
    }
    // the groups, grid-stride; a warp runs its loop as long as any of its
    // lanes has records
    const int64_t stride = (int64_t)gridDim.x * blockDim.x * kPer;
    WindowCache wc;
    int64_t i0 = (int64_t)blockIdx.x * blockDim.x * kPer + threadIdx.x;
    Keys ks;
    load_keys(a, i0, ks);
    while (__any_sync(0xFFFFFFFFu, i0 < a.cap)) {
        Keys next;  // the next group's, in flight while this one folds
        load_keys(a, i0 + stride, next);
        fold_group<kPriv>(a, pr, i0, ks, wc);
        i0 += stride;
        ks = next;
    }
    if (!kPriv) return;
    __syncthreads();
    // the flush, of the cells this block changed (in steady state none):
    // first each one's k-th value as a bound, then its new values, the
    // blocks starting apart in their lists
    const int n = *pr.count;
    if (n == 0) return;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const int c = pr.list[e];
        for (int g = 0; g < a.n_aggs; ++g) {
            const int k = a.a[g].width;
            const float last = pr.plane_of(a, g)[(size_t)c * k + k - 1];
            if (pr.mask[(size_t)g * pr.cells + c] == 0u ||
                __float_as_uint(last) == kNegInf)
                continue;
            atomicMax(
                (unsigned long long *)&a.bounds[(size_t)g * pr.cells + c],
                (unsigned long long)a.epoch << 32 | bound_key(last));
        }
    }
    __syncthreads();
    const int rot = (int)((int64_t)blockIdx.x * n / gridDim.x);
    for (int e0 = threadIdx.x; e0 < n; e0 += blockDim.x) {
        const int c = pr.list[e0 + rot < n ? e0 + rot : e0 + rot - n];
        for (int g = 0; g < a.n_aggs; ++g) {
            const uint32_t m = pr.mask[(size_t)g * pr.cells + c];
            if (m != 0u) merge_cell(a, pr, g, c, m);
        }
    }
}

}  // namespace

extern "C" int hs_topk(const HsScatterArgs *args, void *stream) {
    const HsScatterArgs &a = *args;
    if (a.cap == 0 || a.n_per == 0) return 0;
    if (a.blocks < 1 || a.n_aggs < 1 || a.n_aggs > HS_MAX_AGGS ||
        (a.advance > 0 && (a.adv_div.m == 0u || a.slot_div.m == 0u)))
        return (int)cudaErrorInvalidValue;
    for (int g = 0; g < a.n_aggs; ++g)  // the wrapper passes TOPK only
        if (!is_topk(a.a[g]) || a.a[g].width < 1 ||
            (a.mode == HS_TOPK_PRIVATE && a.a[g].width > 32))
            return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (a.mode == HS_TOPK_GLOBAL) {
        topk_kernel<false><<<a.blocks, kGlobalBlock, 0, st>>>(a);
        return (int)cudaGetLastError();
    }
    if (a.mode != HS_TOPK_PRIVATE || a.bounds == nullptr || a.epoch == 0u)
        return (int)cudaErrorInvalidValue;
    const int64_t bytes = 4 * private_words(a);
    if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
    static std::atomic<uint64_t> granted;
    if (bytes > 48 * 1024) {  // the default limit
        cudaError_t err = hs::allow_smem(granted, topk_kernel<true>,
                                         kMaxSmem);
        if (err != cudaSuccess) return (int)err;
    }
    topk_kernel<true><<<a.blocks, kPrivBlock, (size_t)bytes, st>>>(a);
    return (int)cudaGetLastError();
}
