// Scatter-aggregate: fold one decoded micro-batch into the window-state
// lattice, in place.
//
// Replaces the scatter half of the fused step the JAX package jits
// (hstream_tpu/engine/lattice.py:138-255 build_step_fn, with
// sketches.py:35-86 hash_u32 / clz32 / hll_update_indices and
// sketches.py:130-139 quantile_bin), for COUNT(*), COUNT(col), SUM, AVG,
// MIN, MAX, APPROX_COUNT_DISTINCT and APPROX_QUANTILE. TOPK and
// TOPK_DISTINCT fold in their own kernel (topk.cu).
//
// What bounded the first design (one thread per (record, window), every
// plane update a global atomic): same-address atomics. A headline batch
// puts 2^20 records into ~1000 live cells, so each cell took ~1000
// atomics on `count` and as many on its SUM in one launch, and the L2
// serialises atomics to one address (0.0825 ms against a 0.0047 ms bound
// by bytes; HOP's six windows a record and five planes 0.131 ms).
//
// Design: three modes, chosen on the host from the spec by a plain
// function (lattice.scatter_plan) and passed in HsScatterArgs.
//  * Block-private (HS_SCATTER_PRIVATE), when count, COUNT, SUM, AVG and
//    its _n, MIN and MAX fit a block's shared memory (227 KB less 1 KB):
//    a persistent grid of one or two blocks per SM, each walking a
//    contiguous run of records with private copies of those planes in
//    shared memory, at their identities, indexed by PANE: a record's
//    pane is its key and its latest window's slot, and every record of
//    one latest window start has the same windows, so it updates its
//    pane once with shared-memory atomics, not each of its windows
//    (HOP(60 s, 10 s): once in place of six). A slot's pane start is
//    claimed (CAS) by the block's first record there; a record whose
//    slot another start holds, or whose windows wrap around int32, goes
//    direct, with global atomics per window. The planes are slot-major
//    (slot x K + key): a batch's records share a slot as a rule, and
//    key x W + slot put config 2's on 4 of the 32 banks. At its end the
//    block raises slot_start from its panes and flushes each pane cell a
//    record landed in into each in-range window of its pane: one global
//    atomic per window and plane (and a store of 1 to `touched`), from a
//    start cell rotated per block so that the blocks' atomics on one
//    cell do not arrive together. The SUM identity is -0.0, so a pane
//    that added nothing adds an exact no-op and is skipped.
//  * Cluster (HS_SCATTER_CLUSTER), the same where a record has several
//    windows (HOP), whose panes fan out to several window cells: blocks
//    in clusters of 8, whose blocks reduce their pane cells over
//    distributed shared memory (each block one eighth of the cells, the
//    eight remote words loaded together) before the flush, so a window
//    cell takes ~16 global atomics, not ~130. The grid is capped at the
//    clusters the card holds at once (cudaOccupancyMaxActiveClusters):
//    config 2's 160 KB blocks ran a second wave at 16 clusters.
//  * Global (HS_SCATTER_GLOBAL), when the planes do not fit (the join's
//    inner lattice at K = 2^19): the first design, one thread per
//    (record, window) and every update a global atomic, so that a
//    record's windows run on separate threads (four records a thread,
//    tried first, left HOP's six windows x five planes of atomics in
//    one thread's sequence: config 2 3.5x slower); slot_start reduced in
//    shared memory first (W <= 1024), one lane for the lanes of a warp
//    that share a window start.
// The block-private modes read four records a thread at a time with
// 16-byte loads of key, ts and the f32 / i32 value columns (4-byte loads
// of valid, bool columns and NULL masks) when every column is aligned,
// and derive a record's windows from one division (its latest window
// and slot; the others step down from it) unless int32 wrap-around is
// possible, where the reference's per-window arithmetic runs as written
// (record.cuh).
// HLL registers (K x W x 2^p bytes) and quantile bins (K x W x bins)
// stay global in every mode; the HLL keeps its read-first early-out.
// APPROX_QUANTILE bins a value as the reference does, one float32
// operation at a time; logf is the same libdevice function PyTorch's CUDA
// log calls, so the plain version bins identically on the card.
// MIN/MAX use the sign-split integer trick, exact in any order; integer
// planes, HLL, bins, touched and slot_start are exact. SUM/AVG add in an
// order that changes from run to run (per pane, across a cluster, then
// across blocks), within the float32 order bound 2*n*2^-24*sum|x| per
// cell; not run-to-run stable, as before.
//
// Bound on the H100 now (config 1 0.028 ms, config 2 0.065, the
// changelog 0.049 against bounds of 0.0042, 0.0041 and 0.0063 ms by
// bytes, PERF.md): what
// stays per record, one shared-memory atomic per private plane (about
// one lane-operation a clock on each SM) and, for APPROX_COUNT_DISTINCT
// and APPROX_QUANTILE, one random L2 access per window; then the flush,
// live window cells x planes global atomics per block (per cluster).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>

#include "hs_kernels.h"
#include "record.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kPrivBlock = 512;     // threads, block-private branch
constexpr int kCluster = 8;         // blocks a cluster, block-private branch
constexpr int kGlobalBlock = 256;   // threads, global branch
constexpr int kSmemSlots = 1024;    // global branch: slot_start in smem
// dynamic shared memory a block can have: the card's 227 KB less 1 KB
// kept for the kernel's static shared memory (lattice.SCATTER_SMEM_LIMIT)
constexpr int kMaxSmem = 232448 - 1024;
constexpr uint32_t kNegZero = 0x80000000u;
constexpr uint32_t kPosInf = 0x7F800000u;
constexpr uint32_t kNegInf = 0xFF800000u;

__host__ __device__ inline bool private_kind(int kind) {
    return kind == HS_AGG_COUNT || kind == HS_AGG_SUM ||
           kind == HS_AGG_AVG || kind == HS_AGG_MIN || kind == HS_AGG_MAX;
}

// shared-memory words of the block-private branch: count and each
// private plane ([K, W] each, AVG two), then slot_start [W]
__host__ __device__ inline int64_t private_words(const HsScatterArgs &a) {
    int64_t planes = 1;
    for (int g = 0; g < a.n_aggs; ++g)
        if (private_kind(a.a[g].kind))
            planes += a.a[g].kind == HS_AGG_AVG ? 2 : 1;
    return (int64_t)a.n_keys * a.n_slots * planes + a.n_slots;
}

// a pane cell's word in a private plane: slot-major, so that the
// records of one slot (the rule) hit consecutive banks
__device__ __forceinline__ int64_t pane_cell(const HsScatterArgs &a, int key,
                                             int slot) {
    return (int64_t)slot * a.n_keys + key;
}

__device__ __forceinline__ uint32_t identity_bits(int kind) {
    if (kind == HS_AGG_SUM || kind == HS_AGG_AVG) return kNegZero;
    if (kind == HS_AGG_MIN) return kPosInf;
    if (kind == HS_AGG_MAX) return kNegInf;
    return 0u;
}

// four records' int32 / byte columns from record i0 (n of them valid)
__device__ __forceinline__ void load4(const int32_t *p, int i0, int n,
                                      bool vec, int out[4]) {
    if (vec && n == 4) {
        const int4 x = *(const int4 *)(p + i0);
        out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
        return;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) out[r] = r < n ? p[i0 + r] : 0;
}

__device__ __forceinline__ void load4(const uint8_t *p, int i0, int n,
                                      bool vec, int out[4]) {
    if (vec && n == 4) {
        const uchar4 x = *(const uchar4 *)(p + i0);
        out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
        return;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) out[r] = r < n ? p[i0 + r] : 0;
}

// aggregate ag's inputs for records i0 .. i0 + 3 (hs::input_of)
__device__ __forceinline__ void agg_inputs4(const HsScatterAgg &ag, int i0,
                                            int n, bool vec, float v[4],
                                            uint32_t bits[4], bool ok[4]) {
    int nul[4] = {0, 0, 0, 0};
    if (ag.nulls != nullptr) load4(ag.nulls, i0, n, vec, nul);
    int x[4];
    if (ag.vtype == HS_T_BOOL)
        load4((const uint8_t *)ag.values, i0, n, vec, x);
    else
        load4((const int32_t *)ag.values, i0, n, vec, x);
#pragma unroll
    for (int r = 0; r < 4; ++r)
        ok[r] = hs::input_of(ag.vtype, (uint32_t)x[r], nul[r] != 0, v[r],
                             bits[r]);
}

// a record's windows: the start and slot of its latest window, from
// which window j steps down by j advances and j slots; `exact` when
// int32 wrap-around is possible, where record_window runs per window
struct RecWin {
    int latest;
    int slot0;
    bool exact;
};

__device__ __forceinline__ RecWin rec_win(const HsScatterArgs &a, int t) {
    RecWin w{0, 0, false};
    if (a.advance <= 0) return w;
    int q = t / a.advance, r = t % a.advance;
    if (r < 0) {
        r += a.advance;
        q -= 1;
    }
    const int64_t lo =
        (int64_t)t - r - (int64_t)(a.n_per - 1) * a.advance;
    w.exact = lo < (int64_t)INT_MIN;
    w.latest = (int)((unsigned)t - (unsigned)r);
    w.slot0 = hs::floor_mod(q, a.n_slots);
    return w;
}

// window j of a record: its start and slot, false when late or before
// the epoch (record_window's semantics; `s` is the running slot)
__device__ __forceinline__ bool next_window(const HsScatterArgs &a,
                                            const RecWin &w, int j, int &s,
                                            int &start, int &slot) {
    if (a.advance <= 0) {
        start = 0;
        slot = 0;
        return true;
    }
    start = (int)((unsigned)w.latest - (unsigned)j * (unsigned)a.advance);
    const int end = (int)((unsigned)start + (unsigned)a.size_grace);
    const bool in = !(end <= a.watermark) && start >= 0;
    if (w.exact) {
        slot = in ? hs::floor_mod(hs::floor_div(start, a.advance), a.n_slots)
                  : 0;
        return in;
    }
    slot = s;
    s = s == 0 ? a.n_slots - 1 : s - 1;
    return in;
}

// one record's update of aggregate ag at `cell`, with a global atomic
__device__ __forceinline__ void fold_global(const HsScatterArgs &a,
                                            const HsScatterAgg &ag,
                                            int64_t cell, float v,
                                            uint32_t bits) {
    switch (ag.kind) {
    case HS_AGG_COUNT:
        atomicAdd((int32_t *)ag.plane + cell, 1);
        break;
    case HS_AGG_SUM:
        atomicAdd((float *)ag.plane + cell, v);
        break;
    case HS_AGG_AVG:
        atomicAdd((float *)ag.plane + cell, v);
        atomicAdd(ag.plane_n + cell, 1);
        break;
    case HS_AGG_MIN:
        hs::atomic_min_float((float *)ag.plane + cell, v);
        break;
    case HS_AGG_MAX:
        hs::atomic_max_float((float *)ag.plane + cell, v);
        break;
    case HS_AGG_HLL:
        hs::hll_update((int8_t *)ag.plane + (cell << a.hll_p), bits,
                       a.hll_p);
        break;
    case HS_AGG_QUANT: {
        const int b = hs::quantile_bin(v, a.q_min, a.q_gamma, ag.width);
        atomicAdd((int32_t *)ag.plane + cell * ag.width + b, 1);
        break;
    }
    default:  // TOPK*: topk.cu
        break;
    }
}

// flush pane cell c (its key, pane slot ps and pane start `start0`),
// combined over the blocks of the cluster in `mask` (cnt records; the
// block itself without kCl), into every in-range window of its pane: one
// global atomic per window and plane
template <bool kCl>
__device__ void flush_pane(const HsScatterArgs &a, uint32_t *smem,
                           const int *s_off, const int *s_offn, int64_t c,
                           int64_t key, int ps, int start0, unsigned mask,
                           int cnt) {
    const RecWin w{start0, ps, false};
    int s = ps;
    for (int j = 0; j < a.n_per; ++j) {
        int start, slot;
        if (!next_window(a, w, j, s, start, slot)) continue;
        const int64_t cell = key * a.n_slots + slot;
        atomicAdd(&a.count[cell], cnt);
        if (a.track_touched) a.touched[cell] = 1;
    }
    for (int g = 0; g < a.n_aggs; ++g) {
        const int off = s_off[g];
        if (off < 0) continue;
        const HsScatterAgg &ag = a.a[g];
        // the blocks' words, all loads in flight before they combine
        constexpr int kQ = kCl ? kCluster : 1;
        uint32_t y[kQ], yn[kQ];
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
            const bool in = (mask >> q) & 1u;
            const uint32_t *r = smem;
            if constexpr (kCl) r = cg::this_cluster().map_shared_rank(smem, q);
            y[q] = in ? r[off + c] : identity_bits(ag.kind);
            yn[q] = in && ag.kind == HS_AGG_AVG ? r[s_offn[g] + c] : 0u;
        }
        uint32_t x = identity_bits(ag.kind);
        int nn = 0;
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
            switch (ag.kind) {
            case HS_AGG_COUNT:
                x += y[q];
                break;
            case HS_AGG_SUM:
            case HS_AGG_AVG:
                x = __float_as_uint(
                    __fadd_rn(__uint_as_float(x), __uint_as_float(y[q])));
                nn += (int)yn[q];
                break;
            case HS_AGG_MIN:
                x = hs::min_float_bits(x, y[q]);
                break;
            default:  // HS_AGG_MAX
                x = hs::max_float_bits(x, y[q]);
                break;
            }
        }
        if (x == identity_bits(ag.kind) && nn == 0) continue;
        int sj = ps;
        for (int j = 0; j < a.n_per; ++j) {
            int start, slot;
            if (!next_window(a, w, j, sj, start, slot)) continue;
            const int64_t cell = key * a.n_slots + slot;
            switch (ag.kind) {
            case HS_AGG_COUNT:
                atomicAdd((int32_t *)ag.plane + cell, (int)x);
                break;
            case HS_AGG_SUM:
            case HS_AGG_AVG:
                if (x != kNegZero)
                    atomicAdd((float *)ag.plane + cell, __uint_as_float(x));
                if (nn != 0) atomicAdd(ag.plane_n + cell, nn);
                break;
            case HS_AGG_MIN:
                hs::atomic_min_float((float *)ag.plane + cell,
                                     __uint_as_float(x));
                break;
            default:  // HS_AGG_MAX
                hs::atomic_max_float((float *)ag.plane + cell,
                                     __uint_as_float(x));
                break;
            }
        }
    }
}

// the block-private branch, with the cluster's blocks reducing their
// pane cells together (kCl) or each block flushing its own
template <bool kCl>
__device__ __forceinline__ void scatter_body(const HsScatterArgs &a,
                                             int vec) {
    extern __shared__ uint32_t smem[];
    __shared__ int s_off[HS_MAX_AGGS];   // private plane (word offset), -1
    __shared__ int s_offn[HS_MAX_AGGS];  // AVG's _n plane
    const int64_t kw = (int64_t)a.n_keys * a.n_slots;
    int *s_count = (int *)smem;
    int *s_pane = (int *)smem + private_words(a) - a.n_slots;  // pane starts
    if (threadIdx.x == 0) {
        int64_t off = kw;
        for (int g = 0; g < a.n_aggs; ++g) {
            const int kind = a.a[g].kind;
            s_off[g] = private_kind(kind) ? (int)off : -1;
            off += private_kind(kind) ? kw : 0;
            s_offn[g] = kind == HS_AGG_AVG ? (int)off : -1;
            off += kind == HS_AGG_AVG ? kw : 0;
        }
    }
    for (int64_t c = threadIdx.x; c < kw; c += blockDim.x) s_count[c] = 0;
    __syncthreads();
    for (int g = 0; g < a.n_aggs; ++g) {
        if (s_off[g] < 0) continue;
        const uint32_t id = identity_bits(a.a[g].kind);
        for (int64_t c = threadIdx.x; c < kw; c += blockDim.x)
            smem[s_off[g] + c] = id;
        if (s_offn[g] >= 0)
            for (int64_t c = threadIdx.x; c < kw; c += blockDim.x)
                smem[s_offn[g] + c] = 0u;
    }
    for (int w = threadIdx.x; w < a.n_slots; w += blockDim.x)
        s_pane[w] = HS_EMPTY_START;
    __syncthreads();

    // the block's records, four to a thread, a contiguous run per block
    const int64_t groups = ((int64_t)a.cap + 3) / 4;
    const int64_t per = (groups + gridDim.x - 1) / gridDim.x;
    const int64_t last = min(groups, (int64_t)(blockIdx.x + 1) * per);
    for (int64_t grp = (int64_t)blockIdx.x * per + threadIdx.x; grp < last;
         grp += blockDim.x) {
        const int i0 = (int)(grp * 4);
        const int n = min(4, a.cap - i0);
        int key[4], ts[4], valid[4];
        load4(a.key, i0, n, vec, key);
        load4(a.ts, i0, n, vec, ts);
        load4(a.valid, i0, n, vec, valid);
        RecWin rw[4];
        bool kin[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            valid[r] = r < n && valid[r];
            kin[r] = key[r] >= 0 && key[r] < a.n_keys;
            rw[r] = rec_win(a, ts[r]);
        }
        // a record whose windows do not wrap adds to its pane, the cell
        // of its latest window's slot, once the slot's pane start is its
        // own (s_pane, claimed by the first record of the block that has
        // it); any other record with a window in range goes direct, with
        // global atomics per window. 0 none, 1 pane, 2 direct
        int how[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            how[r] = 0;
            if (valid[r]) {
                int s = rw[r].slot0, start, slot;
                for (int j = 0; j < a.n_per && how[r] == 0; ++j)
                    if (next_window(a, rw[r], j, s, start, slot)) how[r] = 2;
            }
            if (how[r] == 2 && !rw[r].exact) {
                int *pp = &s_pane[rw[r].slot0];
                int cur = *(volatile int *)pp;
                if (cur == HS_EMPTY_START)
                    cur = atomicCAS(pp, HS_EMPTY_START, rw[r].latest);
                if (cur == HS_EMPTY_START || cur == rw[r].latest) how[r] = 1;
            }
            if (how[r] == 1 && kin[r])
                atomicAdd(&s_count[pane_cell(a, key[r], rw[r].slot0)], 1);
            if (how[r] != 2) continue;
            int s = rw[r].slot0;
            for (int j = 0; j < a.n_per; ++j) {
                int start, slot;
                if (!next_window(a, rw[r], j, s, start, slot)) continue;
                atomicMax(&a.slot_start[slot], start);
                if (!kin[r]) continue;
                const int64_t cell = (int64_t)key[r] * a.n_slots + slot;
                atomicAdd(&a.count[cell], 1);
                if (a.track_touched) a.touched[cell] = 1;
            }
        }
        // the aggregates: private planes of pane records into shared
        // memory, everything else with global atomics per window
        for (int g = 0; g < a.n_aggs; ++g) {
            const HsScatterAgg &ag = a.a[g];
            if (ag.kind == HS_AGG_TOPK || ag.kind == HS_AGG_TOPK_DISTINCT ||
                ag.kind == HS_AGG_COUNT_ALL)
                continue;
            float v[4];
            uint32_t bits[4];
            bool ok[4];
            agg_inputs4(ag, i0, n, vec, v, bits, ok);
            const int off = s_off[g];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                if (!(how[r] != 0 && kin[r] && ok[r])) continue;
                if (off >= 0 && how[r] == 1) {
                    const int64_t cell = pane_cell(a, key[r], rw[r].slot0);
                    switch (ag.kind) {
                    case HS_AGG_COUNT:
                        atomicAdd((int *)smem + off + cell, 1);
                        break;
                    case HS_AGG_SUM:
                        atomicAdd((float *)smem + off + cell, v[r]);
                        break;
                    case HS_AGG_AVG:
                        atomicAdd((float *)smem + off + cell, v[r]);
                        atomicAdd((int *)smem + s_offn[g] + cell, 1);
                        break;
                    case HS_AGG_MIN:
                        hs::atomic_min_float((float *)smem + off + cell,
                                             v[r]);
                        break;
                    default:  // HS_AGG_MAX
                        hs::atomic_max_float((float *)smem + off + cell,
                                             v[r]);
                        break;
                    }
                    continue;
                }
                int s = rw[r].slot0;
                for (int j = 0; j < a.n_per; ++j) {
                    int start, slot;
                    if (!next_window(a, rw[r], j, s, start, slot)) continue;
                    fold_global(a, ag, (int64_t)key[r] * a.n_slots + slot,
                                v[r], bits[r]);
                }
            }
        }
    }
    __syncthreads();
    // flush: slot_start from the block's panes; then each pane cell a
    // record landed in, into the in-range windows of its pane. With kCl
    // the cluster's blocks first reduce their pane cells over distributed
    // shared memory, each block one share of the cells
    for (int ps = threadIdx.x; ps < a.n_slots; ps += blockDim.x) {
        const RecWin w{s_pane[ps], ps, false};
        if (w.latest == HS_EMPTY_START) continue;
        int s = ps;
        for (int j = 0; j < a.n_per; ++j) {
            int start, slot;
            if (next_window(a, w, j, s, start, slot))
                atomicMax(&a.slot_start[slot], start);
        }
    }
    int nb = 1, me = 0;
    int64_t n_groups = gridDim.x, group = blockIdx.x;
    if constexpr (kCl) {
        cg::cluster_group cl = cg::this_cluster();
        cl.sync();
        nb = kCluster;  // __cluster_dims__ of scatter_cluster
        me = (int)cl.block_rank();
        n_groups = gridDim.x / nb;
        group = blockIdx.x / nb;
    }
    const int64_t lo = kw * me / nb, hi = kw * (me + 1) / nb;
    // each block (cluster) starts at its own cell of the share, so that
    // their atomics on one window cell do not arrive together
    const int64_t share = hi - lo;
    const int64_t rot = share * group / n_groups;
    for (int64_t i = threadIdx.x; i < share; i += blockDim.x) {
        const int64_t c = lo + (i + rot < share ? i + rot : i + rot - share);
        const int ps = (int)(c / a.n_keys);
        const int64_t key = c - (int64_t)ps * a.n_keys;
        if constexpr (!kCl) {
            if (s_count[c] != 0)
                flush_pane<false>(a, smem, s_off, s_offn, c, key, ps,
                                  s_pane[ps], 1u, s_count[c]);
        } else {
            // the blocks that hold this pane cell under the first pane
            // start seen; a block whose pane start differs flushes its own
            cg::cluster_group cl = cg::this_cluster();
            int cq[kCluster], lq[kCluster];
#pragma unroll
            for (int q = 0; q < kCluster; ++q) {
                cq[q] = cl.map_shared_rank(s_count, q)[c];
                lq[q] = cl.map_shared_rank(s_pane, q)[ps];
            }
            unsigned same = 0;
            int start0 = HS_EMPTY_START, cnt = 0;
#pragma unroll
            for (int q = 0; q < kCluster; ++q) {
                if (cq[q] == 0) continue;
                if (start0 == HS_EMPTY_START) start0 = lq[q];
                if (lq[q] == start0) {
                    same |= 1u << q;
                    cnt += cq[q];
                } else {
                    flush_pane<true>(a, smem, s_off, s_offn, c, key, ps,
                                     lq[q], 1u << q, cq[q]);
                }
            }
            if (same != 0u)
                flush_pane<true>(a, smem, s_off, s_offn, c, key, ps, start0,
                                 same, cnt);
        }
    }
    // no block of a cluster leaves while another reads its planes
    if constexpr (kCl) cg::this_cluster().sync();
}

__global__ void __launch_bounds__(kPrivBlock)
scatter_private(const __grid_constant__ HsScatterArgs a, int vec) {
    scatter_body<false>(a, vec);
}

__global__ void __launch_bounds__(kPrivBlock)
    __cluster_dims__(kCluster, 1, 1)
scatter_cluster(const __grid_constant__ HsScatterArgs a, int vec) {
    scatter_body<true>(a, vec);
}

// the global branch: one thread per (record, window), every update a
// global atomic, as the first design; slot_start reduced in shared
// memory first (W <= kSmemSlots), by one lane for the lanes of a warp
// that share a window start (a start names its slot). A grid-stride
// walk whose lanes step together, so the warp votes stay uniform
__global__ void __launch_bounds__(kGlobalBlock)
scatter_global(const __grid_constant__ HsScatterArgs a, int smem_start) {
    extern __shared__ int s_start[];
    if (smem_start) {
        for (int w = threadIdx.x; w < a.n_slots; w += kGlobalBlock)
            s_start[w] = HS_EMPTY_START;
        __syncthreads();
    }
    const int64_t total = (int64_t)a.cap * a.n_per;
    const int64_t stride = (int64_t)gridDim.x * kGlobalBlock;
    for (int64_t base = (int64_t)blockIdx.x * kGlobalBlock; base < total;
         base += stride) {
        const int64_t tid = base + threadIdx.x;
        int i = 0, start = 0, slot = 0;
        bool in = false;
        if (tid < total) {
            i = (int)(tid / a.n_per);
            in = hs::record_window(a, i, (int)(tid % a.n_per), start, slot);
        }
        const unsigned peers =
            __match_any_sync(0xffffffffu, in ? start : HS_EMPTY_START);
        if (in && (threadIdx.x & 31) == __ffs(peers) - 1) {
            if (smem_start)
                atomicMax(&s_start[slot], start);
            else
                atomicMax(&a.slot_start[slot], start);
        }
        if (!in) continue;
        const int k = a.key[i];
        if (k < 0 || k >= a.n_keys) continue;
        const int64_t cell = (int64_t)k * a.n_slots + slot;
        atomicAdd(&a.count[cell], 1);
        if (a.track_touched) a.touched[cell] = 1;
        for (int g = 0; g < a.n_aggs; ++g) {
            const HsScatterAgg &ag = a.a[g];
            float v;
            uint32_t bits;
            if (ag.kind == HS_AGG_COUNT_ALL || !hs::agg_input(ag, i, v, bits))
                continue;
            fold_global(a, ag, cell, v, bits);
        }
    }
    if (smem_start) {
        __syncthreads();
        for (int w = threadIdx.x; w < a.n_slots; w += kGlobalBlock)
            if (s_start[w] != HS_EMPTY_START)
                atomicMax(&a.slot_start[w], s_start[w]);
    }
}

bool aligned(const void *p, uintptr_t to) {
    return ((uintptr_t)p & (to - 1)) == 0;
}

}  // namespace

extern "C" int hs_scatter(const HsScatterArgs *args, void *stream) {
    const HsScatterArgs &a = *args;
    if (a.cap == 0) return 0;
    if (a.blocks < 1 || a.n_aggs > HS_MAX_AGGS)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (a.mode == HS_SCATTER_GLOBAL) {
        const int smem_start = a.n_slots <= kSmemSlots;
        scatter_global<<<a.blocks, kGlobalBlock,
                         smem_start ? (size_t)a.n_slots * sizeof(int) : 0,
                         st>>>(a, smem_start);
        return (int)cudaGetLastError();
    }
    if (a.mode != HS_SCATTER_PRIVATE && a.mode != HS_SCATTER_CLUSTER)
        return (int)cudaErrorInvalidValue;
    const bool cl = a.mode == HS_SCATTER_CLUSTER;
    const int64_t bytes = private_words(a) * 4;
    if (bytes > kMaxSmem || (cl && a.blocks % kCluster != 0))
        return (int)cudaErrorInvalidValue;
    // the 16-byte (4-byte for byte columns) loads need aligned columns
    bool vec = aligned(a.key, 16) && aligned(a.ts, 16) && aligned(a.valid, 4);
    for (int g = 0; g < a.n_aggs; ++g) {
        const HsScatterAgg &ag = a.a[g];
        vec = vec && aligned(ag.values, ag.vtype == HS_T_BOOL ? 4 : 16) &&
              (ag.nulls == nullptr || aligned(ag.nulls, 4));
    }
    static bool granted[2] = {false, false};
    if (bytes > 48 * 1024 && !granted[cl]) {  // the default limit
        cudaError_t err = cudaFuncSetAttribute(
            cl ? scatter_cluster : scatter_private,
            cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
        if (err != cudaSuccess) return (int)err;
        granted[cl] = true;
    }
    if (cl) {
        // no more clusters than the card holds at once: a second wave
        // would wait for the first one's flush
        static int64_t asked = -1;
        static int fit = 0;
        if (bytes != asked) {
            cudaLaunchConfig_t cfg = {};
            cfg.gridDim = dim3(kCluster);
            cfg.blockDim = dim3(kPrivBlock);
            cfg.dynamicSmemBytes = (size_t)bytes;
            cudaError_t err =
                cudaOccupancyMaxActiveClusters(&fit, scatter_cluster, &cfg);
            if (err != cudaSuccess) return (int)err;
            asked = bytes;
        }
        const int blocks =
            fit > 0 && fit * kCluster < a.blocks ? fit * kCluster : a.blocks;
        scatter_cluster<<<blocks, kPrivBlock, (size_t)bytes, st>>>(a,
                                                                   (int)vec);
    } else {
        scatter_private<<<a.blocks, kPrivBlock, (size_t)bytes, st>>>(
            a, (int)vec);
    }
    return (int)cudaGetLastError();
}
