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
// Bound on the H100: bytes. The flags read once, the set ones cleared,
// the touched cells' planes gathered once, the buffer written once. At
// the join's inner lattice (K = 2^19, W = 3, ~390,000 touched cells of
// 1,572,864 columns) the buffer is ~25 MB of the ~28.5 MB.
//
// What held the first design back (a count, a compaction in which every
// block summed the counts before it, then one warp per output column):
// 31 of 32 lanes idle on a scalar aggregate, ~75 % of the join's columns
// fill that finalized cell (0, 0) again each, 4-byte stores strided by
// max_out, flags read a byte a load.
//
// Design:
//  * staged (K*W > 4096): touched_scan_kernel compacts in one pass over
//    the flags, 16 a thread from one 16-byte load, 4096 a block; each
//    tile's offset is the sum of the counts its predecessors published
//    (lookback.cuh), the tiles taken in order from a ticket. It writes
//    each touched cell's index at its global position (< max_out),
//    clears the flags it found set, and the last tile writes n. One warp
//    of tile 0 finalizes cell (0, 0) into scratch: the fill.
//    touched_finalize_kernel then gives a thread four consecutive
//    columns: for each row it computes the four values (a scalar
//    aggregate, a TOPK value, the key, the start) or copies the fill,
//    and stores them with one 16-byte store (four-byte stores where
//    max_out is not a multiple of 4), so a warp writes 512 consecutive
//    bytes of every row. The HLL and quantile estimates are warp
//    reductions (finalize.cuh): touched_sketch_kernel gives them a warp
//    per touched column, and only those.
//  * one (K*W <= 4096, the changelog's 3072 cells): one launch of a block
//    per 8 columns. Every block loads all the flags (from L2 after the
//    first) and scans them in shared memory; its warps take the fill's
//    aggregates (in blocks that have fill columns) and the sketch rows
//    of its touched columns, and its threads then the other rows, each
//    (aggregate, four columns) a task; the last block to finish (an
//    atomic ticket) clears the flags. A quantile estimate is a few
//    memory round trips long, so the blocks are many and small.
// The status words and the ticket are zeroed by a memset in the same
// stream before the launch.

#include <cuda_runtime.h>

#include <algorithm>

#include "finalize.cuh"
#include "hs_kernels.h"
#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;                       // flags a thread, one uint4
constexpr int kChunk = kThreads * kPer;        // 4096 cells a tile
static_assert(kChunk == HS_TOUCHED_ONE_CELLS, "one launch: a tile");
constexpr int kCols = 4;                       // columns a finalize thread
constexpr int kSketchBlocks = 132 * 8;  // ~8 on each of an H100's SMs
// the set bytes among 16 flag bytes (any non-zero byte is set)
__device__ __forceinline__ unsigned set_mask(uint4 w) {
    const uint32_t x[4] = {w.x, w.y, w.z, w.w};
    unsigned m = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const uint32_t ne = __vcmpne4(x[q], 0u);  // 0xFF per set byte
#pragma unroll
        for (int b = 0; b < 4; ++b)
            m |= ((ne >> (8 * b + 7)) & 1u) << (4 * q + b);
    }
    return m;
}

// this thread's 16 flags (cells base .. base + 15) as a bit mask
__device__ __forceinline__ unsigned load_flags(const uint8_t *touched,
                                               int64_t base, int n_cells,
                                               bool &whole) {
    whole = base + kPer <= n_cells &&
            ((uintptr_t)(touched + base) & 15) == 0;  // a 16-byte load
    if (whole) return set_mask(*(const uint4 *)(touched + base));
    unsigned m = 0;
    for (int b = 0; b < kPer && base + b < n_cells; ++b)
        m |= (touched[base + b] != 0 ? 1u : 0u) << b;
    return m;
}

__device__ __forceinline__ void clear_flags(uint8_t *touched, int64_t base,
                                            int n_cells, unsigned m,
                                            bool whole) {
    if (m == 0) return;
    if (whole) {
        *(uint4 *)(touched + base) = make_uint4(0u, 0u, 0u, 0u);
        return;
    }
    for (int b = 0; b < kPer && base + b < n_cells; ++b)
        if ((m >> b) & 1u) touched[base + b] = 0;
}

// exclusive block scan of v (kThreads threads); *total gets the sum.
// smem: 32 words
__device__ __forceinline__ int block_excl_scan(int v, int *smem,
                                               int *total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(0xFFFFFFFFu, x, d);
        if (lane >= d) x += t;
    }
    if (lane == 31) smem[warp] = x;
    __syncthreads();
    if (warp == 0) {
        const int nw = kThreads / 32;
        int s = lane < nw ? smem[lane] : 0;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int t = __shfl_up_sync(0xFFFFFFFFu, s, d);
            if (lane >= d) s += t;
        }
        if (lane < nw) smem[lane] = s;
    }
    __syncthreads();
    const int before = warp > 0 ? smem[warp - 1] : 0;
    *total = smem[kThreads / 32 - 1];
    __syncthreads();
    return before + x - v;
}

__global__ void __launch_bounds__(kThreads)
touched_scan_kernel(const __grid_constant__ HsTouchedArgs a) {
    __shared__ int s_scan[32];
    __shared__ long long s_look[32];
    __shared__ int s_tile;
    const int n_cells = a.n_keys * a.n_slots;
    if (threadIdx.x == 0) s_tile = (int)atomicAdd(a.ticket, 1u);
    __syncthreads();
    const int tile = s_tile;
    const int64_t base = (int64_t)tile * kChunk + threadIdx.x * kPer;
    bool whole = false;
    const unsigned m = base < n_cells
        ? load_flags(a.touched, base, n_cells, whole) : 0u;
    const int mine = __popc(m);
    int count;
    const int before = block_excl_scan(mine, s_scan, &count);
    const long long off = hs::look_back(a.status, tile, count, s_look);
    long long pos = off + before;
    for (unsigned r = m; r != 0; r &= r - 1, ++pos)
        if (pos < a.max_out)
            a.cells[pos] = (int32_t)(base + __ffs(r) - 1);
    clear_flags(a.touched, base, n_cells, m, whole);
    if (tile == (int)gridDim.x - 1 && threadIdx.x == 0)
        a.cells[a.max_out] = (int32_t)(off + count);
    if (tile == 0 && threadIdx.x >= 32 && threadIdx.x < 64)  // the fill
        hs::finalize_cell(a.f, 0, a.count[0], a.fill + 3, 1,
                          threadIdx.x & 31);
}

__device__ __forceinline__ bool is_sketch(int kind) {
    return kind == HS_AGG_HLL || kind == HS_AGG_QUANT;
}

// the first output row of aggregate g (-1: the key, start and n rows)
__device__ __forceinline__ int row_of(const HsFinalize &f, int g) {
    int row = 3;
    for (int k = 0; k < g; ++k) row += f.a[k].width;
    return g < 0 ? 0 : row;
}

// columns c0 .. c0 + 3 of aggregate g's rows (g = -1: rows 0 to 2), but
// the sketch rows of touched columns: four values a row, one 16-byte
// store where aligned. `cells` the compacted cells (>= nv: the fill),
// `fill` cell (0, 0)'s finalized rows (rows 3+)
__device__ __forceinline__ void finalize_cols(const HsTouchedArgs &a,
                                              const int32_t *cells, int n,
                                              const int32_t *fill,
                                              int64_t c0, int g) {
    const int64_t mo = a.max_out;
    const int nv = (int)min((int64_t)n, mo);
    const bool vec = (mo & 3) == 0 && c0 + kCols <= mo;
    int cell[kCols];
    bool hit[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
        const int64_t c = c0 + q;
        hit[q] = c < nv;
        cell[q] = hit[q] ? cells[c] : 0;
    }
    auto store = [&](int row, const int32_t (&v)[kCols]) {
        int32_t *o = a.out + (int64_t)row * mo + c0;
        if (vec) {
            *(int4 *)o = make_int4(v[0], v[1], v[2], v[3]);
        } else {
            for (int q = 0; q < kCols && c0 + q < mo; ++q) o[q] = v[q];
        }
    };
    int32_t v[kCols];
    if (g < 0) {
#pragma unroll
        for (int q = 0; q < kCols; ++q) v[q] = c0 + q == 0 ? n : 0;
        store(0, v);
#pragma unroll
        for (int q = 0; q < kCols; ++q)
            v[q] = hit[q] ? cell[q] / a.n_slots : 0;
        store(1, v);
#pragma unroll
        for (int q = 0; q < kCols; ++q)
            v[q] = hit[q] ? a.slot_start[cell[q] % a.n_slots] : 0;
        store(2, v);
        return;
    }
    const HsCloseAgg &ag = a.f.a[g];
    const int row = row_of(a.f, g);
    if (ag.kind == HS_AGG_TOPK || ag.kind == HS_AGG_TOPK_DISTINCT) {
        const int32_t *vals = (const int32_t *)ag.plane;
        for (int j = 0; j < ag.width; ++j) {
#pragma unroll
            for (int q = 0; q < kCols; ++q)
                v[q] = hit[q] ? vals[(int64_t)cell[q] * ag.width + j]
                              : fill[row + j];
            store(row + j, v);
        }
    } else if (is_sketch(ag.kind)) {  // touched columns: the sketch tasks
        if (!hit[kCols - 1]) {
            int32_t *o = a.out + (int64_t)row * mo + c0;
            if (vec && !hit[0]) {
                const int32_t x = fill[row];
                *(int4 *)o = make_int4(x, x, x, x);
            } else {
                for (int q = 0; q < kCols && c0 + q < mo; ++q)
                    if (!hit[q]) o[q] = fill[row];
            }
        }
    } else {
#pragma unroll
        for (int q = 0; q < kCols; ++q)
            v[q] = hit[q] ? __float_as_int(hs::finalize_scalar(
                                ag, cell[q], a.count[cell[q]]))
                          : fill[row];
        store(row, v);
    }
}

// the sketch row of aggregate g (HLL or quantile) of one touched cell,
// by one warp
__device__ __forceinline__ void finalize_sketch(const HsTouchedArgs &a,
                                                int g, int cell, int64_t col,
                                                int lane) {
    const HsCloseAgg &ag = a.f.a[g];
    const float v = ag.kind == HS_AGG_HLL ? hs::hll_warp(a.f, ag, cell, lane)
                                          : hs::quant_warp(a.f, ag, cell,
                                                           lane);
    if (lane == 0)
        a.out[(int64_t)row_of(a.f, g) * a.max_out + col] = __float_as_int(v);
}

__global__ void __launch_bounds__(kThreads)
touched_finalize_kernel(const __grid_constant__ HsTouchedArgs a) {
    const int64_t c0 =
        ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kCols;
    if (c0 >= a.max_out) return;
    const int n = a.cells[a.max_out];
    for (int g = -1; g < a.f.n_aggs; ++g)
        finalize_cols(a, a.cells, n, a.fill, c0, g);
}

__global__ void __launch_bounds__(kThreads)
touched_sketch_kernel(const __grid_constant__ HsTouchedArgs a) {
    const int nv = min(a.cells[a.max_out], a.max_out);
    const int lane = threadIdx.x & 31;
    const int64_t warps = (int64_t)gridDim.x * (kThreads / 32);
    for (int64_t col = (int64_t)blockIdx.x * (kThreads / 32) +
                       (threadIdx.x >> 5);
         col < nv; col += warps)
        for (int g = 0; g < a.f.n_aggs; ++g)
            if (is_sketch(a.f.a[g].kind))
                finalize_sketch(a, g, a.cells[col], col, lane);
}

// K*W <= 4096 in one launch, a block per kOneCols columns (384 blocks
// at the changelog's 3072): each block compacts all the flags in shared
// memory; its warps take the fill's aggregates (in blocks with fill
// columns) and the sketch rows of its touched columns, one (aggregate,
// column) a task; then its threads take (aggregate, four columns) tasks,
// so no thread walks the aggregates' gathers one after another; the last
// block to finish clears the flags
constexpr int kOneCols = 8;

__global__ void __launch_bounds__(kThreads)
touched_one_kernel(const __grid_constant__ HsTouchedArgs a) {
    __shared__ int32_t s_cells[kChunk];
    __shared__ int32_t s_fill[HS_TOUCHED_ONE_ROWS];
    __shared__ int s_scan[32];
    __shared__ bool s_last;
    const int n_cells = a.n_keys * a.n_slots;
    const int64_t base = (int64_t)threadIdx.x * kPer;
    bool whole = false;
    const unsigned m = base < n_cells
        ? load_flags(a.touched, base, n_cells, whole) : 0u;
    int n;
    int pos = block_excl_scan(__popc(m), s_scan, &n);
    for (unsigned r = m; r != 0; r &= r - 1, ++pos)
        s_cells[pos] = (int32_t)(base + __ffs(r) - 1);
    __syncthreads();
    const int n_aggs = a.f.n_aggs;
    const int64_t lo = (int64_t)blockIdx.x * kOneCols;
    const int64_t hi = min(lo + kOneCols, (int64_t)a.max_out);
    const int64_t nv = min((int64_t)n, (int64_t)a.max_out);
    const int fills = hi > nv ? n_aggs : 0;  // the block has fill columns
    const int64_t hits = a.has_sketch ? max(min(hi, nv) - lo, (int64_t)0)
                                      : 0;
    const int lane = threadIdx.x & 31;
    for (int64_t task = threadIdx.x >> 5; task < fills + hits * n_aggs;
         task += kThreads / 32) {
        if (task < fills) {
            hs::finalize_agg(a.f, (int)task, 0, a.count[0],
                             s_fill + row_of(a.f, (int)task), 1, lane);
            continue;
        }
        const int64_t k = task - fills;
        const int g = (int)(k % n_aggs);
        const int64_t col = lo + k / n_aggs;
        if (is_sketch(a.f.a[g].kind))
            finalize_sketch(a, g, s_cells[col], col, lane);
    }
    __syncthreads();
    for (int task = threadIdx.x; task < (n_aggs + 1) * (kOneCols / kCols);
         task += kThreads) {
        const int64_t c0 = lo + (int64_t)(task % (kOneCols / kCols)) * kCols;
        if (c0 < hi)
            finalize_cols(a, s_cells, n, s_fill, c0,
                          task / (kOneCols / kCols) - 1);
    }
    __syncthreads();  // every flag of this block read: take a ticket
    if (threadIdx.x == 0) {
        __threadfence();
        s_last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (s_last) clear_flags(a.touched, base, n_cells, m, whole);
}

int blocks_of(int64_t items, int per_block) {
    return (int)((items + per_block - 1) / per_block);
}

// the scratch's words: cells [max_out + 1], the fill [out_rows], the
// ticket, then the status words (64-bit, aligned) of the staged scan
int64_t status_word(int32_t max_out, int32_t out_rows) {
    return ((int64_t)max_out + 1 + out_rows + 1 + 1) & ~1ll;
}

}  // namespace

extern "C" int64_t hs_touched_scratch_bytes(int32_t n_cells,
                                            int32_t max_out,
                                            int32_t out_rows) {
    return (status_word(max_out, out_rows) + 2ll * blocks_of(n_cells, kChunk))
           * (int64_t)sizeof(int32_t);
}

extern "C" int hs_touched(const HsTouchedArgs *args, void *stream) {
    HsTouchedArgs a = *args;
    const int n_cells = a.n_keys * a.n_slots;
    if (n_cells <= 0 || a.max_out <= 0) return 0;
    int32_t *w = (int32_t *)a.scratch;
    a.cells = w;
    a.fill = w + a.max_out + 1;
    a.ticket = (uint32_t *)(a.fill + a.out_rows);
    a.status = (uint64_t *)(w + status_word(a.max_out, a.out_rows));
    cudaStream_t s = (cudaStream_t)stream;
    const int tiles = blocks_of(n_cells, kChunk);
    const int fin = blocks_of(a.max_out, kThreads * kCols);
    int err;
    if (a.mode == HS_TOUCHED_ONE) {
        if (n_cells > HS_TOUCHED_ONE_CELLS || a.out_rows > HS_TOUCHED_ONE_ROWS)
            return (int)cudaErrorInvalidValue;
        err = (int)cudaMemsetAsync(a.ticket, 0, sizeof(uint32_t), s);
        if (err != 0) return err;
        touched_one_kernel<<<blocks_of(a.max_out, kOneCols), kThreads, 0,
                             s>>>(a);
        return (int)cudaGetLastError();
    }
    // the ticket and the status words (the scratch's tail)
    err = (int)cudaMemsetAsync(
        a.ticket, 0, (size_t)((char *)(a.status + tiles) - (char *)a.ticket),
        s);
    if (err != 0) return err;
    touched_scan_kernel<<<tiles, kThreads, 0, s>>>(a);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    touched_finalize_kernel<<<fin, kThreads, 0, s>>>(a);
    err = (int)cudaGetLastError();
    if (err != 0 || !a.has_sketch) return err;
    touched_sketch_kernel<<<std::min(blocks_of(a.max_out, kThreads / 32),
                                     kSketchBlocks),
                            kThreads, 0, s>>>(a);
    return (int)cudaGetLastError();
}
