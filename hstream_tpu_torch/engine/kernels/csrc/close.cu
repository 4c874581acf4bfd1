// Fused window close: finalize the requested slot columns into one packed
// int32 buffer and reset those slots, in one launch.
//
// Replaces the JAX package's close programs:
//   mode 0 (extract+reset): hstream_tpu/engine/lattice.py:624-639
//     build_extract_reset_slots (_extract_slots_packed :606-621,
//     finalize_column :411-436, pack_extract_rows :468-478,
//     _reset_slots_tree :586-603, sketches.py:99-107 hll_estimate);
//   mode 1 (extract only, peek): lattice.py:642-651 build_extract_slots;
//   mode 2 (reset only): lattice.py:654-664 build_reset_slots.
//
// Bound on the H100: bytes. A close reads each requested slot column of
// every plane once (dominated by 1 KiB of HLL registers or 2 KiB of
// quantile bins per key and slot) and writes the packed [P, out_rows, K]
// buffer once; the sketch estimates are 512- and 1024-term reductions
// per (key, slot), a handful of operations per byte. At the main path's
// shapes (one slot of 1024 keys) that is ~1 MiB, below a launch's own
// floor, so the close runs on latency: how many memory round trips a
// key waits out one after another, and how many keys wait at once.
//
// What held the first design back: a block per (slot, 64 keys) gave a
// slot 16 blocks at K = 1024, a warp walked 8 keys one after another,
// and each key's HLL estimate read 1 KiB as 4-byte words; the reset was
// a second sweep after a barrier, 4-byte stores with an integer
// division per element.
//
// Design: every key of every slot at once. The plan
// (engine/lattice.py close_plan) gives a key a warp where the close
// finalizes a sketch (the estimates are warp reductions) or resets a
// cell of 256 bytes or more, else one thread; blocks of HS_CLOSE_THREADS
// hold HS_CLOSE_THREADS / lanes keys of one slot, the grid (key tiles,
// P). A key's lanes load every output row's word first (one load each,
// all in flight: the count, a scalar plane's word, a TOPK value, AVG's
// count), then run the sketch estimates (16-byte loads over 512
// contiguous bytes a warp, finalize.cuh), then finalize and write the
// rows, and then, after a __syncwarp, reset the cell they read: 16-byte
// stores of each plane's identity (HLL registers and quantile bins 0,
// TOPK values -inf, float accumulators `init`), count, touched and
// AVG's count to 0. No barrier and no second sweep. Row 0 of the
// output is the count, row 1 slot_start[slot] broadcast, then each
// aggregate's rows (float32 bits; k rows for TOPK); padding slots (< 0)
// give all-zero rows and reset nothing. slot_start[slot] is read by
// every key tile of an extracting close, so in mode 0 the last tile to
// finish (a per-slot counter: __threadfence + atomicAdd) resets it and
// sets the counter back to 0, so the wrapper's counters stay zero from
// launch to launch; a reset-only close reads nothing, and its first key
// tile resets slot_start. EMIT CHANGES closes run mode 2 alone: the
// changelog already carried the final values.
//
// hs_close_slot is the per-slot close, modes 1 and 2 only, one launch
// each, as the reference keeps two programs:
//   mode 1: lattice.py:529-544 build_extract_slot -> [2 + rows, K], the
//           layout of pack_extract_rows (one slot of the fused buffer);
//   mode 2: lattice.py:547-563 build_reset_slot.
// The slot comes by value in the arguments: no slot vector, no padding
// and no counter; it runs the same kernel over a grid of one slot. A
// fused close of at most HS_CLOSE_INLINE slots (a close cycle's usual
// one or two windows) takes them by value too, so nothing is uploaded.

//
// hs_close_merged / hs_close_slot_merged: the same close over the
// sharded lattice's D partials of every key shard on the card
// (hstream_tpu/parallel/lattice.py:192-293 extract_slot, reset_slot,
// extract_reset_slots, extract_slots, reset_slots), one launch a card
// and close cycle, for any number of data and key shards. A global key
// k belongs to key shard k / Kl; its cell is the merge of the D
// partials' cells (SUM and AVG added in data-shard order, d = 0 first,
// MIN and MAX by fminf / fmaxf, counts as int32, HLL registers by their
// max), finalized into the same packed rows (key columns in global key
// order, as the reference's P(None, None, key) out-spec concatenates
// them), and reset in every partial. slot_start is the max over a key
// shard's partials, reset in each of them by the shard's last tile of
// the slot. Bound:
// bytes, D times the single-card close's reads and resets; at config
// 1's slot (K = 1024 over two key shards, D = 2) ~4.3 MB, below a
// launch and a few dependent loads.
//
// What held the first design back: the partials' plane pointers came
// by value in a 19.5 KB table of at most 16 partials, read at run-time
// indices (constant-cache misses); a key read its D counts and then its
// D slot starts one after another, merged 1 KiB of HLL registers into
// shared memory with 4-byte loads before the estimate read it back,
// read its scalar aggregates by one lane only after that, and reset the
// partials one after another.
//
// Design: B2's close_key over D partials. The partials' plane pointers
// are a table on the card (HsParts.tab, uploaded by the host when they
// change); a block's keys are of one key shard, whose row of the table
// the block stages in shared memory once. A key's lanes issue every
// load of a row group at once (each row's word in the D partials,
// kMergeD = 2 partials at a time, the counts and AVG's counts beside
// them), the HLL estimate's 16-byte loads of the partials' registers
// beside those (the bytewise max taken in registers, hll_merged: nothing
// goes through shared memory; quantile bins are summed into the warp's
// buffer), then merge, finalize and write the rows. A word or vector of
// the cell is read by one lane only (the count by all), so a lane resets
// what it read in every partial as soon as it has merged it (the HLL
// registers before their estimate's reductions, with 16-byte stores);
// count and touched follow one __syncwarp.

#include <cuda_runtime.h>

#include <atomic>

#include "device.cuh"
#include "finalize.cuh"
#include "hs_kernels.h"
#include "merge.cuh"

namespace {

constexpr int kBlock = HS_CLOSE_THREADS;
constexpr int kGroup = 4;   // rows a lane loads before it uses them

__host__ __device__ __forceinline__ bool sketch_kind(int kind) {
    return kind == HS_AGG_HLL || kind == HS_AGG_QUANT;
}

// the aggregate whose rows hold aggregate row r2 (rows 2 + r2 of a cell)
__device__ __forceinline__ int row_agg(const HsFinalize &f, int r2) {
    int g = 0;
    while (g + 1 < f.n_aggs && f.a[g + 1].row <= r2) ++g;
    return g;
}

// the words a row of the cell finalizes from, loaded: w a plane's word
// (TOPK: value j of the cell), n AVG's count; nothing for rows 0 and 1,
// COUNT(*) and the sketches
__device__ __forceinline__ void load_row(const HsFinalize &f, int64_t cell,
                                         int r, bool active, uint32_t &w,
                                         int32_t &n) {
    w = 0u;
    n = 0;
    if (!active || r < 2) return;
    const HsCloseAgg &ag = f.a[row_agg(f, r - 2)];
    const uint32_t *plane = (const uint32_t *)ag.plane;
    if (ag.kind == HS_AGG_TOPK || ag.kind == HS_AGG_TOPK_DISTINCT) {
        w = plane[cell * ag.width + (r - 2 - ag.row)];
    } else if (ag.kind != HS_AGG_COUNT_ALL && !sketch_kind(ag.kind)) {
        w = plane[cell];
        if (ag.kind == HS_AGG_AVG) n = ag.plane_n[cell];
    }
}

// row r of the cell from its loaded words; false for a sketch's row
// (written by the warp's estimate)
__device__ __forceinline__ bool row_value(const HsFinalize &f, int r,
                                          uint32_t w, int32_t n, int cnt,
                                          int s_start, int32_t &v) {
    if (r < 2) {
        v = r == 0 ? cnt : s_start;
        return true;
    }
    const HsCloseAgg &ag = f.a[row_agg(f, r - 2)];
    if (sketch_kind(ag.kind)) return false;
    v = ag.kind == HS_AGG_TOPK || ag.kind == HS_AGG_TOPK_DISTINCT
        ? (int32_t)w : __float_as_int(hs::finalize_loaded(ag.kind, w, n,
                                                          cnt));
    return true;
}

// one cell's `words` 32-bit words at base set to fill by the key's
// lanes: 16-byte stores where the cell is 16-byte aligned
template <int kLanes>
__device__ __forceinline__ void fill_words(uint32_t *base, int words,
                                           uint32_t fill, int lane) {
    if ((words & 3) == 0 && ((uintptr_t)base & 15) == 0) {
        const uint4 f4 = make_uint4(fill, fill, fill, fill);
        uint4 *v = (uint4 *)base;
        for (int i = lane; i < (words >> 2); i += kLanes) v[i] = f4;
    } else {
        for (int i = lane; i < words; i += kLanes) base[i] = fill;
    }
}

// key k of `slot` by its kLanes lanes: extract into out's rows (of K
// values each), then reset the cell
template <int kLanes>
__device__ __forceinline__ void close_key(const HsCloseArgs &a, int slot,
                                          int s_start, int32_t *out, int k,
                                          int lane, bool extract,
                                          bool reset) {
    const HsFinalize &f = a.f;
    const int K = a.n_keys, rows = a.out_rows;
    const int64_t cell = (int64_t)k * a.n_slots + slot;
    if (extract) {
        const int cnt = a.count[cell];
        const int mine = rows > lane ? (rows - lane + kLanes - 1) / kLanes
                                     : 0;
        for (int i0 = 0; i0 < max(mine, 1); i0 += kGroup) {
            uint32_t w[kGroup];
            int32_t n[kGroup];
#pragma unroll
            for (int u = 0; u < kGroup; ++u)
                load_row(f, cell, lane + kLanes * (i0 + u), i0 + u < mine,
                         w[u], n[u]);
            if (kLanes == 32 && i0 == 0) {
                // every lane: the estimates are warp reductions, their
                // loads overlap the rows' loads above
                for (int g = 0; g < f.n_aggs; ++g) {
                    const HsCloseAgg &ag = f.a[g];
                    if (!sketch_kind(ag.kind)) continue;
                    const float v = ag.kind == HS_AGG_HLL
                        ? hs::hll_warp(f, ag, cell, lane)
                        : hs::quant_warp(f, ag, cell, lane);
                    if (lane == 0)
                        out[(int64_t)(2 + ag.row) * K + k] =
                            __float_as_int(v);
                }
            }
#pragma unroll
            for (int u = 0; u < kGroup; ++u) {
                const int r = lane + kLanes * (i0 + u);
                int32_t v;
                if (i0 + u < mine &&
                    row_value(f, r, w[u], n[u], cnt, s_start, v))
                    out[(int64_t)r * K + k] = v;
            }
        }
        if (kLanes > 1) __syncwarp();  // every read of the cell precedes
                                       // its reset
    }
    if (!reset) return;
    if (lane == 0) {
        a.count[cell] = 0;
        a.touched[cell] = 0;
    }
    for (int g = 0; g < f.n_aggs; ++g) {
        const HsCloseAgg &ag = f.a[g];
        if (ag.kind == HS_AGG_COUNT_ALL) continue;
        if (ag.kind == HS_AGG_AVG && lane == 0) ag.plane_n[cell] = 0;
        // HLL: int8 registers as 32-bit words; COUNT(col) and quantile
        // bins take 0, float accumulators and TOPK values `init`
        const int words = ag.kind == HS_AGG_HLL ? ag.plane_width >> 2
                                                : ag.plane_width;
        const uint32_t fill = (ag.kind == HS_AGG_COUNT ||
                               sketch_kind(ag.kind))
            ? 0u : __float_as_uint(ag.init);
        fill_words<kLanes>((uint32_t *)ag.plane + cell * words, words, fill,
                           lane);
    }
}

template <int kLanes>
__global__ void __launch_bounds__(kBlock)
close_kernel(const __grid_constant__ HsCloseArgs a) {
    constexpr int kKeys = kBlock / kLanes;
    const int p = blockIdx.y;
    const int slot = a.slots != nullptr ? a.slots[p] : a.sel[p];
    const bool extract = a.mode != HS_CLOSE_RESET;
    const bool reset = a.mode != HS_CLOSE_EXTRACT;
    const int K = a.n_keys, rows = a.out_rows;
    const int lane = kLanes == 1 ? 0 : threadIdx.x % kLanes;
    const int k = blockIdx.x * kKeys + threadIdx.x / kLanes;
    int32_t *out = extract ? a.out + (int64_t)p * rows * K : nullptr;
    if (slot < 0) {  // padding: zero rows, nothing reset
        if (extract && k < K)
            for (int r = lane; r < rows; r += kLanes)
                out[(int64_t)r * K + k] = 0;
        return;
    }
    const int s_start = extract ? a.slot_start[slot] : 0;
    if (k < K) close_key<kLanes>(a, slot, s_start, out, k, lane, extract,
                                 reset);
    if (!reset) return;
    if (!extract) {  // nothing read slot_start: the first tile resets it
        if (blockIdx.x == 0 && threadIdx.x == 0)
            a.slot_start[slot] = HS_EMPTY_START;
        return;
    }
    __syncthreads();  // the block's reads of slot_start precede its count
    if (threadIdx.x == 0) {
        __threadfence();
        const unsigned prev = atomicAdd(&a.done[p], 1u);
        if (prev == gridDim.x - 1) {  // the slot's last tile
            a.slot_start[slot] = HS_EMPTY_START;
            a.done[p] = 0u;
        }
    }
}

// the arguments the kernel takes: one or 32 lanes a key, and a warp
// wherever a sketch is finalized
bool valid_args(const HsCloseArgs &a) {
    if (a.lanes != 1 && a.lanes != 32) return false;
    if (a.mode == HS_CLOSE_RESET || a.lanes == 32) return true;
    for (int g = 0; g < a.f.n_aggs; ++g)
        if (sketch_kind(a.f.a[g].kind)) return false;
    return true;
}

int launch(const HsCloseArgs &a, unsigned slots, void *stream) {
    const int keys = kBlock / a.lanes;
    int64_t tiles = ((int64_t)a.n_keys + keys - 1) / keys;
    if (tiles < 1) tiles = 1;  // mode 2 resets slot_start with no keys
    const dim3 grid((unsigned)tiles, slots);
    if (a.lanes == 32)
        close_kernel<32><<<grid, kBlock, 0, (cudaStream_t)stream>>>(a);
    else
        close_kernel<1><<<grid, kBlock, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// ---- the close over D partials --------------------------------------

// kStart: row 1's slot_start, merged by max (rows of aggregates merge by
// their kind)
constexpr int kStart = -1;

// what row r of the cell reads and how its D words merge: the plane
// (-1: none; row 0's count and the sketches are read apart), the merge
// kind, the word's index in the plane and the plane's identity
__device__ __forceinline__ void row_plan(const HsFinalize &f, int r,
                                         int slot, int64_t cell,
                                         bool active, int &pi, int &kind,
                                         int64_t &idx, uint32_t &fill) {
    pi = -1;
    kind = HS_AGG_COUNT_ALL;
    idx = cell;
    fill = 0u;
    if (!active || r == 0) return;
    if (r == 1) {
        pi = HS_PART_SLOT_START;
        kind = kStart;
        idx = slot;
        return;
    }
    const int g = row_agg(f, r - 2);
    kind = f.a[g].kind;
    if (kind != HS_AGG_COUNT_ALL && !sketch_kind(kind))
        pi = hs::agg_plane(g);
    if (kind != HS_AGG_COUNT) fill = __float_as_uint(f.a[g].init);
}

// partial d's word x merged into acc (d = 0: the first): slot_start by
// max, COUNT(col) by a wrapping add, float32 sums added in data-shard
// order, MIN and MAX by fminf / fmaxf
__device__ __forceinline__ uint32_t merge_word(int kind, uint32_t acc,
                                               uint32_t x, int d) {
    if (d == 0) return x;
    if (kind == kStart) return (uint32_t)max((int32_t)acc, (int32_t)x);
    if (kind == HS_AGG_COUNT) return acc + x;
    const float a = __uint_as_float(acc), v = __uint_as_float(x);
    return __float_as_uint(kind == HS_AGG_MIN   ? fminf(a, v)
                           : kind == HS_AGG_MAX ? fmaxf(a, v)
                                                : __fadd_rn(a, v));
}

// the sketch rows of the merged cell, by the whole warp: HLL from its
// registers' 16-byte loads (hll_merged, no shared memory), quantiles
// from their bins summed into the warp's buffer
__device__ __forceinline__ void merged_estimates(const HsFinalize &f,
                                                 const hs::Tab &t,
                                                 int64_t cell, int32_t *out,
                                                 int K, int k, int lane,
                                                 void *buf, bool reset) {
    for (int g = 0; g < f.n_aggs; ++g) {
        const HsCloseAgg &ag = f.a[g];
        if (!sketch_kind(ag.kind)) continue;
        float v;
        if (ag.kind == HS_AGG_HLL) {
            v = hs::hll_merged(f, t, hs::agg_plane(g), cell, lane, reset);
        } else {
            hs::merge_bins(t, hs::agg_plane(g), ag.plane_width, cell, buf,
                           lane, reset);
            HsCloseAgg b = ag;
            b.plane = buf;
            v = hs::quant_warp(f, b, 0, lane);
            __syncwarp();   // the buffer is read before the next merge
        }
        if (lane == 0) out[(int64_t)(2 + ag.row) * K + k] = __float_as_int(v);
    }
}

// the cell's reset in every data shard's partial of the staged key
// shard: the scalar words a partial a lane, the wide cells (HLL
// registers, quantile bins) by the key's lanes with 16-byte stores; or
// (!all: an extracting close, whose lanes reset the planes' words as
// they read them) count and touched alone
template <int kLanes>
__device__ __forceinline__ void merged_reset(const HsFinalize &f,
                                             const hs::Tab &t, int64_t cell,
                                             int lane, bool all) {
    for (int d = lane; d < t.n_data; d += kLanes) {
        ((int32_t *)t.plane(d, HS_PART_COUNT))[cell] = 0;
        ((uint8_t *)t.plane(d, HS_PART_TOUCHED))[cell] = 0;
        if (!all) continue;
        for (int g = 0; g < f.n_aggs; ++g) {
            const HsCloseAgg &ag = f.a[g];
            if (ag.kind == HS_AGG_COUNT_ALL || sketch_kind(ag.kind))
                continue;
            const int pi = hs::agg_plane(g);
            ((uint32_t *)t.plane(d, pi))[cell] =
                ag.kind == HS_AGG_COUNT ? 0u : __float_as_uint(ag.init);
            if (ag.kind == HS_AGG_AVG)
                ((int32_t *)t.plane(d, pi + 1))[cell] = 0;
        }
    }
    for (int g = 0; all && g < f.n_aggs; ++g) {
        const HsCloseAgg &ag = f.a[g];
        if (!sketch_kind(ag.kind)) continue;
        const int words = ag.kind == HS_AGG_HLL ? ag.plane_width >> 2
                                                : ag.plane_width;
        for (int d = 0; d < t.n_data; ++d)
            fill_words<kLanes>((uint32_t *)t.plane(d, hs::agg_plane(g)) +
                                   cell * words,
                               words, 0u, lane);
    }
}

// key k (global; its cell `cell` in the staged key shard) of `slot` by
// its kLanes lanes, close_key's order over D partials: every load of a
// row group (each row's word in kMergeD partials at a time, the counts,
// AVG's counts) issued before any is used, the sketch estimates' loads
// beside them, the rows merged, finalized and written; in an extracting
// close each lane resets the words it read once merged, and count and
// touched after one __syncwarp (merged_reset's !all)
template <int kLanes>
__device__ __forceinline__ void merged_close_key(const HsCloseArgs &a,
                                                 const hs::Tab &t, int slot,
                                                 int64_t cell, int32_t *out,
                                                 int k, int lane,
                                                 bool extract, bool reset,
                                                 void *buf) {
    // rows a lane loads at once: a warp's lanes hold a row each (a
    // warp a key: the rows of up to 30 aggregates in one round), a key's
    // one thread four (its registers beside the D partials' words)
    constexpr int kG = kLanes == 32 ? 1 : kGroup;
    const HsFinalize &f = a.f;
    const int K = a.n_keys, rows = a.out_rows, D = t.n_data;
    if (extract) {
        const int mine = rows > lane ? (rows - lane + kLanes - 1) / kLanes
                                     : 0;
        int cnt = 0;
        for (int i0 = 0; i0 < max(mine, 1); i0 += kG) {
            int pi[kG], kind[kG];
            int64_t idx[kG];
            uint32_t w[kG], fill[kG];
            int32_t n[kG];
#pragma unroll
            for (int u = 0; u < kG; ++u) {
                row_plan(f, lane + kLanes * (i0 + u), slot, cell,
                         i0 + u < mine, pi[u], kind[u], idx[u], fill[u]);
                w[u] = 0u;
                n[u] = 0;
            }
            for (int d0 = 0; d0 < D; d0 += hs::kMergeD) {
                uint32_t c[hs::kMergeD], x[kG][hs::kMergeD];
                int32_t nx[kG][hs::kMergeD];
#pragma unroll
                for (int j = 0; j < hs::kMergeD; ++j) {
                    const bool on = d0 + j < D;
                    c[j] = on && i0 == 0
                        ? ((const uint32_t *)t.plane(d0 + j,
                                                     HS_PART_COUNT))[cell]
                        : 0u;
#pragma unroll
                    for (int u = 0; u < kG; ++u) {
                        x[u][j] = on && pi[u] >= 0
                            ? ((const uint32_t *)t.plane(d0 + j, pi[u]))
                                  [idx[u]]
                            : 0u;
                        nx[u][j] = on && kind[u] == HS_AGG_AVG
                            ? ((const int32_t *)t.plane(d0 + j, pi[u] + 1))
                                  [cell]
                            : 0;
                    }
                }
                if (kLanes == 32 && i0 == 0 && d0 == 0)
                    // every lane: the estimates are warp reductions, their
                    // loads overlap the rows' loads above
                    merged_estimates(f, t, cell, out, K, k, lane, buf,
                                     reset);
#pragma unroll
                for (int j = 0; j < hs::kMergeD; ++j) {
                    if (d0 + j >= D) break;
                    cnt += (int)c[j];
#pragma unroll
                    for (int u = 0; u < kG; ++u) {
                        w[u] = merge_word(kind[u], w[u], x[u][j], d0 + j);
                        n[u] += nx[u][j];
                        // the row's words are this lane's alone: reset
                        // once read (slot_start by the shard's last tile)
                        if (!reset || pi[u] < 0 || kind[u] == kStart)
                            continue;
                        ((uint32_t *)t.plane(d0 + j, pi[u]))[idx[u]] =
                            fill[u];
                        if (kind[u] == HS_AGG_AVG)
                            ((int32_t *)t.plane(d0 + j, pi[u] + 1))[cell] =
                                0;
                    }
                }
            }
#pragma unroll
            for (int u = 0; u < kG; ++u) {
                const int r = lane + kLanes * (i0 + u);
                int32_t v;
                if (i0 + u < mine &&
                    row_value(f, r, w[u], n[u], cnt, (int32_t)w[u], v))
                    out[(int64_t)r * K + k] = v;
            }
        }
        if (kLanes > 1) __syncwarp();  // every read of the cell precedes
                                       // its reset
    }
    if (reset) merged_reset<kLanes>(f, t, cell, lane, !extract);
}

// slot_start[slot] of every partial of the staged key shard
__device__ __forceinline__ void reset_starts(const hs::Tab &t, int slot) {
    for (int d = 0; d < t.n_data; ++d)
        ((int32_t *)t.plane(d, HS_PART_SLOT_START))[slot] = HS_EMPTY_START;
}

// the widest quantile cell's bytes, a multiple of 16 (a warp's buffer)
__host__ __device__ inline int quant_buf_bytes(const HsFinalize &f) {
    int most = 0;
    for (int g = 0; g < f.n_aggs; ++g)
        if (f.a[g].kind == HS_AGG_QUANT && 4 * f.a[g].plane_width > most)
            most = 4 * f.a[g].plane_width;
    return (most + 15) & ~15;
}

// blocks of one key shard's key tiles, the grid (n_key x tiles, P): a
// block stages its key shard's plane pointers in shared memory, then
// closes its keys as close_kernel does. slot_start of a key shard's
// partials is read by that shard's tiles alone, so its last tile (a
// counter a slot and key shard) resets them, or in a reset-only close
// its first
template <int kLanes>
__global__ void __launch_bounds__(kBlock, 1)
merged_close_kernel(const __grid_constant__ HsMergedCloseArgs m) {
    extern __shared__ __align__(16) unsigned char s_buf[];
    constexpr int kKeys = kBlock / kLanes;
    const HsCloseArgs &a = m.c;
    const HsParts &P = m.parts;
    const int tiles = (P.local_keys + kKeys - 1) / kKeys;
    const int s = blockIdx.x / tiles;
    const int kl = (blockIdx.x - s * tiles) * kKeys + threadIdx.x / kLanes;
    const int p = blockIdx.y;
    const int slot = a.slots != nullptr ? a.slots[p] : a.sel[p];
    const bool extract = a.mode != HS_CLOSE_RESET;
    const bool reset = a.mode != HS_CLOSE_EXTRACT;
    const int K = a.n_keys, rows = a.out_rows;
    const int lane = kLanes == 1 ? 0 : threadIdx.x % kLanes;
    const int k = s * P.local_keys + kl;
    const bool live = kl < P.local_keys;
    int32_t *out = extract ? a.out + (int64_t)p * rows * K : nullptr;
    if (slot < 0) {  // padding: zero rows, nothing reset
        if (extract && live)
            for (int r = lane; r < rows; r += kLanes)
                out[(int64_t)r * K + k] = 0;
        return;
    }
    const hs::Tab t = hs::stage_tab(P, s, s_buf);
    __syncthreads();
    void *buf = s_buf + hs::tab_bytes(P) +
                (threadIdx.x >> 5) * quant_buf_bytes(a.f);
    if (live)
        merged_close_key<kLanes>(
            a, t, slot, (int64_t)kl * a.n_slots + slot, out, k, lane,
            extract, reset, buf);
    if (!reset) return;
    if (!extract) {  // nothing read slot_start: the first tile resets it
        if (blockIdx.x == s * tiles && threadIdx.x == 0)
            reset_starts(t, slot);
        return;
    }
    __syncthreads();  // the block's reads of slot_start precede its count
    if (threadIdx.x == 0) {
        __threadfence();
        uint32_t *done = a.done + (int64_t)p * P.n_key + s;
        if (atomicAdd(done, 1u) == (unsigned)tiles - 1) {  // the shard's
            reset_starts(t, slot);                         // last tile
            *done = 0u;
        }
    }
}

bool valid_parts(const HsMergedCloseArgs &m) {
    const HsParts &P = m.parts;
    const HsFinalize &f = m.c.f;
    if (P.n_data < 1 || P.n_key < 1 || P.local_keys < 1 ||
        P.tab == nullptr || f.n_aggs > HS_MAX_AGGS ||
        P.n_planes != 3 + 2 * f.n_aggs ||
        (int64_t)P.n_key * P.local_keys != m.c.n_keys || !valid_args(m.c))
        return false;
    for (int g = 0; g < f.n_aggs; ++g)   // TOPK: no elementwise merge
        if (f.a[g].kind == HS_AGG_TOPK || f.a[g].kind == HS_AGG_TOPK_DISTINCT)
            return false;
    return true;
}

int launch_merged(const HsMergedCloseArgs &m, unsigned slots,
                  void *stream) {
    static std::atomic<uint64_t> smem32{0}, smem1{0};
    const HsCloseArgs &a = m.c;
    const int keys = kBlock / a.lanes;
    const int64_t tiles =
        (int64_t)m.parts.n_key *
        (((int64_t)m.parts.local_keys + keys - 1) / keys);
    if (tiles > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)tiles, slots);
    const int smem = hs::tab_bytes(m.parts) +
        (a.lanes == 32 && a.mode != HS_CLOSE_RESET
             ? (kBlock / 32) * quant_buf_bytes(a.f) : 0);
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (a.lanes == 32) {
        if (smem > 48 * 1024) {
            const cudaError_t err =
                hs::allow_smem(smem32, merged_close_kernel<32>, 232448);
            if (err != cudaSuccess) return (int)err;
        }
        merged_close_kernel<32><<<grid, kBlock, smem, s>>>(m);
    } else {
        if (smem > 48 * 1024) {
            const cudaError_t err =
                hs::allow_smem(smem1, merged_close_kernel<1>, 232448);
            if (err != cudaSuccess) return (int)err;
        }
        merged_close_kernel<1><<<grid, kBlock, smem, s>>>(m);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hs_close_merged(const HsMergedCloseArgs *args, void *stream) {
    const HsCloseArgs &a = args->c;
    if (a.n_sel == 0 || a.n_keys == 0) return 0;
    if (!valid_parts(*args) || a.n_sel > 65535 ||
        (a.slots == nullptr && a.n_sel > HS_CLOSE_INLINE) ||
        (a.mode == HS_CLOSE_EXTRACT_RESET && a.done == nullptr))
        return (int)cudaErrorInvalidValue;
    return launch_merged(*args, (unsigned)a.n_sel, stream);
}

extern "C" int hs_close_slot_merged(const HsMergedCloseArgs *args,
                                    void *stream) {
    const HsCloseArgs &a = args->c;
    if (a.mode == HS_CLOSE_EXTRACT_RESET || a.slot < 0 ||
        a.slot >= a.n_slots || !valid_parts(*args))
        return (int)cudaErrorInvalidValue;
    HsMergedCloseArgs m = *args;
    m.c.slots = nullptr;
    m.c.sel[0] = m.c.slot;
    m.c.n_sel = 1;
    return launch_merged(m, 1u, stream);
}

extern "C" int hs_close(const HsCloseArgs *args, void *stream) {
    if (args->n_sel == 0 || args->n_keys == 0) return 0;
    if (!valid_args(*args) || args->n_sel > 65535 ||
        args->f.n_aggs > HS_MAX_AGGS ||
        (args->slots == nullptr && args->n_sel > HS_CLOSE_INLINE) ||
        (args->mode == HS_CLOSE_EXTRACT_RESET && args->done == nullptr))
        return (int)cudaErrorInvalidValue;
    return launch(*args, (unsigned)args->n_sel, stream);
}

extern "C" int hs_close_slot(const HsCloseArgs *args, void *stream) {
    if (args->mode == HS_CLOSE_EXTRACT_RESET || args->slot < 0 ||
        args->slot >= args->n_slots || !valid_args(*args) ||
        args->f.n_aggs > HS_MAX_AGGS)
        return (int)cudaErrorInvalidValue;
    HsCloseArgs a = *args;
    a.slots = nullptr;
    a.sel[0] = a.slot;
    a.n_sel = 1;
    return launch(a, 1u, stream);
}
