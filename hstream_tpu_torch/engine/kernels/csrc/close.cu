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
// per (key, slot), a handful of operations per byte.
//
// Design: a block per (slot p, tile of 64 keys), one warp per key
// (finalize.cuh). Row 0 of the output is the count, row 1
// slot_start[slot] broadcast, then each aggregate's rows (float32 bits;
// k rows for TOPK); padding slots (< 0) give all-zero rows and reset
// nothing. The reset runs in the same launch from pre-reset values: each
// block resets only the cells it read, after a barrier, every plane to
// its identity over the plane's whole width (HLL registers and quantile
// bins to 0, TOPK values to -inf). slot_start[slot] is read by every key
// tile of that slot, so only the last tile to finish (a per-slot
// counter, __threadfence + atomicAdd) resets it. EMIT CHANGES closes
// run mode 2 alone: the changelog already carried the final values.
//
// hs_close_slot is the per-slot close, modes 1 and 2 only, one launch
// each, as the reference keeps two programs:
//   mode 1: lattice.py:529-544 build_extract_slot -> [2 + rows, K], the
//           layout of pack_extract_rows (one slot of the fused buffer);
//   mode 2: lattice.py:547-563 build_reset_slot.
// The slot comes by value in the arguments: no slot vector to upload,
// no padding, and no per-slot counter, since mode 2 reads nothing the
// other key tiles reset (block 0 resets slot_start). Its bound is the
// fused close's for one slot: one slot column of every plane read, or
// written, once.

#include <cuda_runtime.h>

#include "finalize.cuh"
#include "hs_kernels.h"

namespace {

constexpr int kBlock = 256;
constexpr int kTile = 64;

// Finalize keys [k0, kend) of `slot` into out (rows of K values).
__device__ __forceinline__ void extract_tile(const HsCloseArgs &a, int slot,
                                             int s_start, int32_t *out,
                                             int k0, int kend) {
    const int K = a.n_keys, W = a.n_slots;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int k = k0 + warp; k < kend; k += kBlock / 32) {
        int64_t cell = (int64_t)k * W + slot;
        int cnt = a.count[cell];
        if (lane == 0) {
            out[k] = cnt;
            out[(int64_t)K + k] = s_start;
        }
        hs::finalize_cell(a.f, cell, cnt, out + (int64_t)2 * K + k, K, lane);
    }
}

// Reset keys [k0, kend) of `slot` in every plane to its identity over the
// plane's whole width (slot_start is the caller's).
__device__ __forceinline__ void reset_tile(const HsCloseArgs &a, int slot,
                                           int k0, int kend) {
    const int W = a.n_slots;
    for (int k = k0 + threadIdx.x; k < kend; k += kBlock) {
        int64_t cell = (int64_t)k * W + slot;
        a.count[cell] = 0;
        a.touched[cell] = 0;
        for (int g = 0; g < a.f.n_aggs; ++g)
            if (a.f.a[g].kind == HS_AGG_AVG) a.f.a[g].plane_n[cell] = 0;
    }
    for (int g = 0; g < a.f.n_aggs; ++g) {
        const HsCloseAgg &ag = a.f.a[g];
        if (ag.kind == HS_AGG_COUNT_ALL) continue;
        if (ag.kind == HS_AGG_HLL) {  // int8 registers, as 32-bit words
            const int words = ag.plane_width >> 2;
            uint32_t *plane = (uint32_t *)ag.plane;
            for (int idx = threadIdx.x; idx < (kend - k0) * words;
                 idx += kBlock) {
                int k = k0 + idx / words;
                plane[((int64_t)k * W + slot) * words + idx % words] = 0u;
            }
            continue;
        }
        // 32-bit planes: float accumulators and TOPK values take `init`,
        // COUNT(col) and quantile bins take 0
        const uint32_t fill = (ag.kind == HS_AGG_COUNT ||
                               ag.kind == HS_AGG_QUANT)
            ? 0u : __float_as_uint(ag.init);
        const int wd = ag.plane_width;
        uint32_t *plane = (uint32_t *)ag.plane;
        for (int idx = threadIdx.x; idx < (kend - k0) * wd; idx += kBlock) {
            int k = k0 + idx / wd;
            plane[((int64_t)k * W + slot) * wd + idx % wd] = fill;
        }
    }
}

__global__ void __launch_bounds__(kBlock)
close_kernel(const __grid_constant__ HsCloseArgs a) {
    const int p = blockIdx.x;
    const int k0 = blockIdx.y * kTile;
    const int kend = min(k0 + kTile, a.n_keys);
    const int rows = a.out_rows;
    const int slot = a.slots[p];
    const int K = a.n_keys;
    const bool extract = a.mode != HS_CLOSE_RESET;
    const bool reset = a.mode != HS_CLOSE_EXTRACT;
    int32_t *out = extract ? a.out + (int64_t)p * rows * K : nullptr;
    if (slot < 0) {
        if (extract)
            for (int r = 0; r < rows; ++r)
                for (int k = k0 + threadIdx.x; k < kend; k += kBlock)
                    out[(int64_t)r * K + k] = 0;
        return;
    }
    __shared__ int s_start;
    if (threadIdx.x == 0) s_start = a.slot_start[slot];
    __syncthreads();

    if (extract) extract_tile(a, slot, s_start, out, k0, kend);
    if (!reset) return;
    __syncthreads();  // every read of this tile precedes its reset
    reset_tile(a, slot, k0, kend);
    if (threadIdx.x == 0) {
        __threadfence();
        unsigned prev = atomicAdd(&a.done[p], 1u);
        if (prev == gridDim.y - 1) a.slot_start[slot] = HS_EMPTY_START;
    }
}

__global__ void __launch_bounds__(kBlock)
close_slot_kernel(const __grid_constant__ HsCloseArgs a) {
    const int k0 = blockIdx.x * kTile;
    const int kend = min(k0 + kTile, a.n_keys);
    if (a.mode == HS_CLOSE_EXTRACT) {
        __shared__ int s_start;
        if (threadIdx.x == 0) s_start = a.slot_start[a.slot];
        __syncthreads();
        extract_tile(a, a.slot, s_start, a.out, k0, kend);
        return;
    }
    reset_tile(a, a.slot, k0, kend);
    if (blockIdx.x == 0 && threadIdx.x == 0)
        a.slot_start[a.slot] = HS_EMPTY_START;
}

}  // namespace

extern "C" int hs_close(const HsCloseArgs *args, void *stream) {
    if (args->n_sel == 0 || args->n_keys == 0) return 0;
    dim3 grid((unsigned)args->n_sel,
              (unsigned)((args->n_keys + kTile - 1) / kTile));
    close_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(*args);
    return (int)cudaGetLastError();
}

extern "C" int hs_close_slot(const HsCloseArgs *args, void *stream) {
    if (args->mode == HS_CLOSE_EXTRACT_RESET || args->slot < 0 ||
        args->slot >= args->n_slots)
        return (int)cudaErrorInvalidValue;
    // at least one block: mode 2 resets slot_start even with no keys
    const int tiles = (args->n_keys + kTile - 1) / kTile;
    const unsigned grid = tiles > 1 ? (unsigned)tiles : 1u;
    close_slot_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(*args);
    return (int)cudaGetLastError();
}
