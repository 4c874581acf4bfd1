// Changelog extract (EMIT CHANGES): every (key, slot) cell touched since
// the last extract, finalized, packed into one int32 buffer, and the
// touched flags cleared, in one wrapper call.
//
// Replaces hstream_tpu/engine/lattice.py:693-720 build_extract_touched
// (with pack_touched_rows :675-683 and finalize_column :411-436). The
// output is the reference's [out_rows, max_out] buffer exactly: [0, 0]
// holds n, the number of touched cells; column j < n holds the j-th
// touched cell in jnp.nonzero's order (row-major over [K, W]: key, then
// slot): row 1 its key, row 2 slot_start of its slot, rows 3+ its
// finalized aggregates. Columns j >= n are jnp.nonzero's fill: key 0,
// start 0 and the finalized values of cell (0, 0). Cells past max_out
// are dropped, as the reference's size=max_out does (n still counts
// them).
//
// Bound on the H100: bytes. The extract reads touched [K, W] once, the
// planes of the touched cells once, and writes the buffer once; the
// sketch estimates are a few operations per byte read.
//
// Design: a stream compaction, then a finalize. Compaction: each block
// owns a chunk of 4096 cells (1024 threads x 4); it scans its flags
// with warp shuffles, writes each touched cell's index at its global
// position, and clears the flags it read. A lattice of one chunk
// (K*W <= 4096; the headline's is 3072) needs no more: its offsets are
// the global ones. A larger lattice first counts each chunk's touched
// cells (touched_count_kernel), and every block sums the counts of the
// chunks before it to find its offset. Finalize: one warp per output
// column, eight per block, spread over the whole card (finalize.cuh),
// since the 512-bin quantile scans are most of the work.

#include <cuda_runtime.h>

#include "finalize.cuh"
#include "hs_kernels.h"

namespace {

constexpr int kThreads = 1024;
constexpr int kPer = 4;
constexpr int kChunk = kThreads * kPer;
constexpr int kFinThreads = 256;

__device__ __forceinline__ long long block_sum(long long v, long long *s) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
    if (lane == 0) s[warp] = v;
    __syncthreads();
    long long t = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += s[w];
    __syncthreads();
    return t;
}

__global__ void __launch_bounds__(kThreads)
touched_count_kernel(const uint8_t *touched, int n_cells, int32_t *counts) {
    __shared__ long long s[32];
    const int64_t base = (int64_t)blockIdx.x * kChunk;
    int c = 0;
    for (int j = 0; j < kPer; ++j) {
        int64_t cell = base + threadIdx.x * kPer + j;
        c += cell < n_cells && touched[cell];
    }
    long long t = block_sum(c, s);
    if (threadIdx.x == 0) counts[blockIdx.x] = (int32_t)t;
}

__global__ void __launch_bounds__(kThreads)
touched_compact_kernel(const __grid_constant__ HsTouchedArgs a) {
    __shared__ long long s[32];
    __shared__ int s_warp[32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_cells = a.n_keys * a.n_slots;
    const int64_t base = (int64_t)blockIdx.x * kChunk;

    long long off = 0, total = 0;
    if (gridDim.x > 1) {  // this chunk's offset, the lattice's total
        long long before = 0, all = 0;
        for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) {
            all += a.block_counts[b];
            if (b < (int)blockIdx.x) before += a.block_counts[b];
        }
        off = block_sum(before, s);
        total = block_sum(all, s);
    }
    int flag[kPer];
    int mine = 0;
    for (int j = 0; j < kPer; ++j) {
        int64_t cell = base + threadIdx.x * kPer + j;
        flag[j] = cell < n_cells && a.touched[cell];
        mine += flag[j];
        if (flag[j]) a.touched[cell] = 0;
    }
    int incl = mine;
    for (int d = 1; d < 32; d <<= 1) {
        int t = __shfl_up_sync(0xFFFFFFFFu, incl, d);
        if (lane >= d) incl += t;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        int v = s_warp[lane];
        int vi = v;
        for (int d = 1; d < 32; d <<= 1) {
            int t = __shfl_up_sync(0xFFFFFFFFu, vi, d);
            if (lane >= d) vi += t;
        }
        s_warp[lane] = vi - v;  // exclusive prefix of the warp totals
        if (gridDim.x == 1 && lane == 31) s[0] = vi;
    }
    __syncthreads();
    if (gridDim.x == 1) total = s[0];
    long long pos = off + s_warp[warp] + incl - mine;
    for (int j = 0; j < kPer; ++j) {
        if (flag[j] && pos < a.max_out)
            a.cells[pos] = (int)(base + threadIdx.x * kPer + j);
        pos += flag[j];
    }
    if (blockIdx.x == 0 && threadIdx.x == 0)
        a.cells[a.max_out] = (int32_t)total;
}

__global__ void __launch_bounds__(kFinThreads)
touched_finalize_kernel(const __grid_constant__ HsTouchedArgs a) {
    const int lane = threadIdx.x & 31;
    const int64_t col = (int64_t)blockIdx.x * (kFinThreads / 32)
                        + (threadIdx.x >> 5);
    const int64_t mo = a.max_out;
    if (col >= mo) return;  // the whole warp
    const int n = a.cells[mo];
    const bool hit = col < n;
    const int cell = hit ? a.cells[col] : 0;  // jnp.nonzero's fill
    if (lane == 0) {
        a.out[col] = col == 0 ? n : 0;
        a.out[mo + col] = hit ? cell / a.n_slots : 0;
        a.out[2 * mo + col] = hit ? a.slot_start[cell % a.n_slots] : 0;
    }
    hs::finalize_cell(a.f, cell, a.count[cell], a.out + 3 * mo + col, mo,
                      lane);
}

}  // namespace

extern "C" int hs_touched_blocks(int32_t n_cells) {
    return (n_cells + kChunk - 1) / kChunk;
}

extern "C" int hs_touched(const HsTouchedArgs *args, void *stream) {
    const int n_cells = args->n_keys * args->n_slots;
    if (n_cells == 0 || args->max_out == 0) return 0;
    const int blocks = hs_touched_blocks(n_cells);
    cudaStream_t s = (cudaStream_t)stream;
    if (blocks > 1) {
        touched_count_kernel<<<blocks, kThreads, 0, s>>>(
            args->touched, n_cells, args->block_counts);
        int err = (int)cudaGetLastError();
        if (err != 0) return err;
    }
    touched_compact_kernel<<<blocks, kThreads, 0, s>>>(*args);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    const int warps = kFinThreads / 32;
    touched_finalize_kernel<<<(args->max_out + warps - 1) / warps,
                              kFinThreads, 0, s>>>(*args);
    return (int)cudaGetLastError();
}
