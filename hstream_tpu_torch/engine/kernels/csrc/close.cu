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

#include <cuda_runtime.h>

#include "finalize.cuh"
#include "hs_kernels.h"

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

}  // namespace

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
