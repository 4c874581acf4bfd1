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
//
// hs_touched_merged is the sharded lattice's changelog extract
// (hstream_tpu/parallel/lattice.py:297-326 touched_local) over the D
// partials of the key shards of one launch: one buffer [out_rows,
// max_out] a key shard, stacked, as the reference's (key ids global:
// local + s * Kl; the fill's s * Kl, its slot start 0; merged SUMs added
// in data-shard order, d = 0 first). A cell is touched when it is in any
// partial (the OR over the data axis); the flags are cleared in every
// partial.
//
// Bound on the H100: bytes, as B6's, each value merged over D partials
// as it is read. At the push query's shape (Kl = 512, W = 3: 1,536 cells
// a key shard) the buffer is ~64 KB, far below a launch's floor, so the
// launches are the cost; at the join's inner lattice (K = 2^19 over two
// key shards, 786,432 columns a shard, ~390,000 touched) the buffer.
//
// What held the first design back: a memset, a scan and a
// finalize at every shape (three launches' floors where 64 KB moved), and
// a finalize that gave each output column a warp: a scalar aggregate
// written by one lane, 4-byte stores strided by max_out, the fill
// columns likewise (1.57 M warps a call at the join's shape).
//
// Design (each block first stages its key shard's plane pointers in
// shared memory, and loads a value's D partials together):
//  * one launch (HS_TOUCHED_ONE: Kl * W <= 4096 cells, B6's bound): a
//    block per 64 columns of a key shard at the push query's two
//    aggregates (8 where sketches are finalized) ORs and compacts the
//    shard's flags in shared memory and takes a ticket (a per-card word
//    that the launch leaves zero), its warps take (row group, 32
//    columns) tasks, a lane a column (a task of four columns a thread
//    put a block's row groups in one warp, whose lanes then ran three
//    code paths one after another: 9.0 µs against 3.7 on an H100), and
//    the block with the shard's last ticket clears the flags: no memset;
//  * staged (a key shard past 4096 cells): the first design's look-back
//    scan (memset of its status words, tile 0 finalizing the fill), then
//    B6's finalize shape, a thread per four columns and a row at a time,
//    each value merged as it is read, 16-byte stores (4-byte ones where
//    max_out is not a multiple of 4), the fill copied by the same
//    threads; a warp a touched column only for the HLL and quantile rows,
//    merged in shared memory (merge.cuh merge_sketch).
// The single-card kernels above keep their code.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>

#include "device.cuh"
#include "finalize.cuh"
#include "hs_kernels.h"
#include "lookback.cuh"
#include "merge.cuh"

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

// ---- the changelog extract over D partials -----------------------------

// a key shard's words at the head of the staged scratch: cells
// [max_out], n, then the fill [out_rows]
__host__ __device__ __forceinline__ int64_t shard_words(int32_t max_out,
                                                        int32_t out_rows) {
    return (int64_t)max_out + 1 + out_rows;
}

// the ticket's word, after every shard's words; the status words
// (64-bit, aligned) follow it
__host__ __device__ __forceinline__ int64_t merged_status_word(
    int32_t max_out, int32_t out_rows, int32_t n_key) {
    return (n_key * shard_words(max_out, out_rows) + 1 + 1) & ~1ll;
}

// the one launch's columns a block: 8 where its warps finalize sketches
// (a quantile estimate is a few memory round trips long); else 32 for
// each of its warps that one row group (the count, key and start, or an
// aggregate) leaves, so its warps take every row group of its columns in
// one round
__host__ __device__ __forceinline__ int merged_one_cols(
    const HsTouchedArgs &a) {
    if (a.has_sketch) return 8;
    const int per = (kThreads / 32) / (a.f.n_aggs + 1);
    return 32 * (per > 1 ? per : 1);
}

// merge.cuh's merges over a staged table, each partial's value loaded
// before any is combined (the loads in flight together), the float sums
// added in data-shard order, d = 0 first. Kept apart from merge.cuh's
// (which read the table at each use): merge.cuh's made templates over
// both tables took the one launch from 3.65 to 4.00 µs on an H100
__device__ __forceinline__ int tab_count(const hs::Tab &t, int64_t cell) {
    int c = 0;
#pragma unroll 4
    for (int d = 0; d < t.n_data; ++d)
        c += ((const int32_t *)t.plane(d, HS_PART_COUNT))[cell];
    return c;
}

__device__ __forceinline__ int tab_start(const hs::Tab &t, int slot) {
    int v = HS_EMPTY_START;
#pragma unroll 4
    for (int d = 0; d < t.n_data; ++d)
        v = max(v, ((const int32_t *)t.plane(d, HS_PART_SLOT_START))[slot]);
    return v;
}

// aggregate g's (a scalar: not HLL, quantile or TOPK) row of the shard's
// merged cell `cell`, its count merged where the kind reads it
__device__ __forceinline__ int32_t tab_scalar(const hs::Tab &t,
                                              const HsCloseAgg &ag, int g,
                                              int64_t cell) {
    const int kind = ag.kind;
    const bool counted = kind == HS_AGG_COUNT_ALL || kind == HS_AGG_MIN ||
                         kind == HS_AGG_MAX;
    const int cnt = counted ? tab_count(t, cell) : 0;
    const int pi = hs::agg_plane(g);
    uint32_t w = 0u;
    int32_t n = 0;
    if (kind == HS_AGG_COUNT) {
#pragma unroll 4
        for (int d = 0; d < t.n_data; ++d)
            w += ((const uint32_t *)t.plane(d, pi))[cell];
    } else if (kind != HS_AGG_COUNT_ALL) {
        float v = ((const float *)t.plane(0, pi))[cell];
#pragma unroll 4
        for (int d = 1; d < t.n_data; ++d) {
            const float x = ((const float *)t.plane(d, pi))[cell];
            v = kind == HS_AGG_MIN   ? fminf(v, x)
                : kind == HS_AGG_MAX ? fmaxf(v, x)
                                     : __fadd_rn(v, x);
        }
        w = __float_as_uint(v);
        if (kind == HS_AGG_AVG)
#pragma unroll 4
            for (int d = 0; d < t.n_data; ++d)
                n += ((const int32_t *)t.plane(d, pi + 1))[cell];
    }
    return __float_as_int(hs::finalize_loaded(kind, w, n, cnt));
}

// aggregate g's sketch row (HLL or quantile) of the shard's merged cell,
// by one warp: the partials' cells merged into `buf` first (the bytewise
// max of HLL ranks, the sum of bins, as merge.cuh merge_sketch); the
// row's bits on every lane
__device__ __forceinline__ int32_t tab_sketch(const HsFinalize &f,
                                              const hs::Tab &t, int g,
                                              int64_t cell, void *buf,
                                              int lane) {
    const HsCloseAgg &ag = f.a[g];
    const int pi = hs::agg_plane(g);
    const bool hll = ag.kind == HS_AGG_HLL;
    const int words = hll ? ag.plane_width >> 2 : ag.plane_width;
    for (int w = lane; w < words; w += 32) {
        uint32_t v = 0u;
        for (int d = 0; d < t.n_data; ++d) {
            const uint32_t x =
                ((const uint32_t *)t.plane(d, pi))[cell * words + w];
            v = hll ? __vmaxu4(v, x) : v + x;
        }
        ((uint32_t *)buf)[w] = v;
    }
    __syncwarp();
    HsCloseAgg m = ag;
    m.plane = buf;
    const float est = hll ? hs::hll_warp(f, m, 0, lane)
                          : hs::quant_warp(f, m, 0, lane);
    __syncwarp();   // the buffer is read before the next merge
    return __float_as_int(est);
}

// columns c0 .. c0 + 3 of key shard s's rows of aggregate g (g = -1:
// rows 0 to 2), but the sketch rows of touched columns (a warp's each):
// four values a row, each merged over the D partials as it is read, one
// 16-byte store where aligned. `cells` the shard's compacted cells (>=
// nv: the fill), `fill` its merged cell (0, 0)'s rows (the staged
// scan's)
__device__ __forceinline__ void merged_cols(const HsMergedTouchedArgs &m,
                                            const hs::Tab &tab, int s,
                                            const int32_t *cells, int n,
                                            const int32_t *fill, int64_t c0,
                                            int g) {
    const HsTouchedArgs &a = m.t;
    const int64_t mo = a.max_out;
    const int nv = (int)min((int64_t)n, mo);
    const bool vec = (mo & 3) == 0 && c0 + kCols <= mo;
    int32_t *out = a.out + (int64_t)s * a.out_rows * mo;
    int cell[kCols];
    bool hit[kCols];   // a prefix of the four: the touched columns
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
        const int64_t c = c0 + q;
        hit[q] = c < nv;
        cell[q] = hit[q] ? cells[c] : 0;
    }
    auto store = [&](int row, const int32_t (&v)[kCols]) {
        int32_t *o = out + (int64_t)row * mo + c0;
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
            v[q] = (hit[q] ? cell[q] / a.n_slots : 0) +
                   s * m.parts.local_keys;
        store(1, v);
#pragma unroll
        for (int q = 0; q < kCols; ++q)
            v[q] = hit[q] ? tab_start(tab, cell[q] % a.n_slots) : 0;
        store(2, v);
        return;
    }
    const HsCloseAgg &ag = a.f.a[g];
    const int row = 3 + ag.row;
    if (hs::is_sketch_kind(ag.kind)) {   // the fill columns only
        if (hit[kCols - 1]) return;
        int32_t *o = out + (int64_t)row * mo + c0;
        const int32_t x = fill[row];
        if (vec && !hit[0]) {
            *(int4 *)o = make_int4(x, x, x, x);
        } else {
            for (int q = 0; q < kCols && c0 + q < mo; ++q)
                if (!hit[q]) o[q] = x;
        }
        return;
    }
    const int32_t x = fill[row];
#pragma unroll
    for (int q = 0; q < kCols; ++q)
        v[q] = hit[q] ? tab_scalar(tab, ag, g, cell[q]) : x;
    store(row, v);
}

// column c of key shard s's rows of aggregate g (g = -1: rows 0 to 2),
// by one lane (the one launch: a warp's lanes on 32 neighbouring
// columns, each row one 128-byte store), but the sketch rows of touched
// columns (a warp's each); a fill column's scalars are cell 0's
__device__ __forceinline__ void merged_col(const HsMergedTouchedArgs &m,
                                           const hs::Tab &tab, int s,
                                           const int32_t *cells, int n,
                                           const int32_t *fill, int64_t c,
                                           int g) {
    const HsTouchedArgs &a = m.t;
    const int64_t mo = a.max_out;
    const bool hit = c < min((int64_t)n, mo);
    const int cell = hit ? cells[c] : 0;
    int32_t *o = a.out + (int64_t)s * a.out_rows * mo + c;
    if (g < 0) {
        o[0] = c == 0 ? n : 0;
        o[mo] = (hit ? cell / a.n_slots : 0) + s * m.parts.local_keys;
        o[2 * mo] = hit ? tab_start(tab, cell % a.n_slots) : 0;
        return;
    }
    const HsCloseAgg &ag = a.f.a[g];
    const int64_t row = 3 + ag.row;
    if (!hs::is_sketch_kind(ag.kind))
        o[row * mo] = tab_scalar(tab, ag, g, cell);
    else if (!hit)
        o[row * mo] = fill[row];
}

// Kl * W <= 4096 cells a key shard, in one launch: a block per
// merged_one_cols columns of key shard blockIdx.y. Each block stages the
// shard's plane pointers in shared memory while it ORs the shard's flags
// over its partials (a 16-byte load a partial a thread), compacts them
// in shared memory and takes its ticket (the flags read); where the
// query has sketches its warps merge and finalize the fill's and its
// touched columns' sketch rows; its warps then take (row group, 32
// columns) tasks, a lane a column, so no warp runs two row groups' code
// one after the other. The block that took the shard's last ticket
// clears the shard's flags in every partial and sets the ticket back to
// 0, so no memset precedes a launch. One block an SM is enough for its
// registers: ptxas's own target left it 0.15 µs slower on an H100 once
// its flags' pointers came from the partial table.
constexpr int kOneSmemMax = 232448 - 24 * 1024;   // dynamic, past the
                                                  // static arrays

__global__ void __launch_bounds__(kThreads, 1)
merged_one_kernel(const __grid_constant__ HsMergedTouchedArgs m) {
    __shared__ int32_t s_cells[kChunk];
    __shared__ int32_t s_fill[HS_TOUCHED_ONE_ROWS];
    __shared__ int s_scan[32];
    __shared__ bool s_last;
    extern __shared__ __align__(16) unsigned char s_buf[];
    const HsTouchedArgs &a = m.t;
    const HsParts &P = m.parts;
    const int s = blockIdx.y;
    const int n_aggs = a.f.n_aggs;
    const hs::Tab tab = hs::stage_tab(P, s, s_buf);
    const int n_cells = a.n_keys * a.n_slots;
    const int64_t base = (int64_t)threadIdx.x * kPer;
    unsigned mask = 0u;
    if (base < n_cells)
        for (int d = 0; d < P.n_data; ++d) {
            bool whole;
            mask |= load_flags(
                (const uint8_t *)hs::part_plane(P, s, d, HS_PART_TOUCHED),
                base, n_cells, whole);
        }
    int n;
    int pos = block_excl_scan(__popc(mask), s_scan, &n);
    // this block's flags are read: its ticket, answered under the tasks
    unsigned ticket = 0u;
    if (threadIdx.x == 0) ticket = atomicAdd(a.ticket + s, 1u);
    for (unsigned r = mask; r != 0; r &= r - 1, ++pos)
        s_cells[pos] = (int32_t)(base + __ffs(r) - 1);
    __syncthreads();
    const int cols = merged_one_cols(a);
    const int64_t lo = (int64_t)blockIdx.x * cols;
    const int64_t hi = min(lo + cols, (int64_t)a.max_out);
    const int64_t nv = min((int64_t)n, (int64_t)a.max_out);
    if (a.has_sketch) {
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        void *buf = s_buf + hs::tab_bytes(P) +
                    warp * hs::sketch_buf_bytes(a.f);
        const int fills = hi > nv ? n_aggs : 0;   // fill columns here
        const int64_t hits = max(min(hi, nv) - lo, (int64_t)0);
        int32_t *out = a.out + (int64_t)s * a.out_rows * a.max_out;
        for (int64_t task = warp; task < fills + hits * n_aggs;
             task += kThreads / 32) {
            const bool filling = task < fills;
            const int64_t k = filling ? task : task - fills;
            const int g = (int)(filling ? k : k % n_aggs);
            if (!hs::is_sketch_kind(a.f.a[g].kind)) continue;
            const int64_t col = filling ? 0 : lo + k / n_aggs;
            const int32_t v = tab_sketch(a.f, tab, g,
                                         filling ? 0 : s_cells[col], buf,
                                         lane);
            const int row = 3 + a.f.a[g].row;
            if (lane == 0) {
                if (filling) s_fill[row] = v;
                else out[(int64_t)row * a.max_out + col] = v;
            }
        }
        __syncthreads();
    }
    const int lane = threadIdx.x & 31;
    const int chunks = (cols + 31) / 32;
    for (int task = threadIdx.x >> 5; task < (n_aggs + 1) * chunks;
         task += kThreads / 32) {
        const int64_t c = lo + (int64_t)(task % chunks) * 32 + lane;
        if (c < hi)
            merged_col(m, tab, s, s_cells, n, s_fill, c, task / chunks - 1);
    }
    if (threadIdx.x == 0) s_last = ticket == gridDim.x - 1;
    __syncthreads();
    if (!s_last) return;
    if (base < n_cells)
        for (int d = 0; d < P.n_data; ++d) {
            uint8_t *f = (uint8_t *)hs::part_plane(P, s, d, HS_PART_TOUCHED);
            const bool whole = base + kPer <= n_cells &&
                               ((uintptr_t)(f + base) & 15) == 0;
            clear_flags(f, base, n_cells, mask, whole);
        }
    if (threadIdx.x == 0) a.ticket[s] = 0u;
}

// staged (a key shard past 4096 cells): the scan compacts each key
// shard's cells on its own (its tiles take turns from one ticket, key
// shard by key shard, and look back over their own shard's status
// words), clears the flags in every partial, and tile 0 of each shard
// finalizes its merged cell (0, 0), the fill
__global__ void __launch_bounds__(kThreads)
merged_touched_scan_kernel(const __grid_constant__ HsMergedTouchedArgs m) {
    __shared__ int s_scan[32];
    __shared__ long long s_look[32];
    __shared__ int s_tile;
    extern __shared__ __align__(16) unsigned char s_buf[];
    const HsTouchedArgs &a = m.t;
    const HsParts &P = m.parts;
    const int n_cells = a.n_keys * a.n_slots;
    const int tiles = (n_cells + kChunk - 1) / kChunk;
    if (threadIdx.x == 0) s_tile = (int)atomicAdd(a.ticket, 1u);
    __syncthreads();
    const int s = s_tile / tiles, tile = s_tile - s * tiles;
    int32_t *cells = a.cells + s * shard_words(a.max_out, a.out_rows);
    const int64_t base = (int64_t)tile * kChunk + threadIdx.x * kPer;
    unsigned mask = 0u;
    if (base < n_cells)
        for (int d = 0; d < P.n_data; ++d) {
            bool whole;
            mask |= load_flags(
                (const uint8_t *)hs::part_plane(P, s, d, HS_PART_TOUCHED),
                base, n_cells, whole);
        }
    int count;
    const int before = block_excl_scan(__popc(mask), s_scan, &count);
    const long long off =
        hs::look_back(a.status + (int64_t)s * tiles, tile, count, s_look);
    long long pos = off + before;
    for (unsigned r = mask; r != 0; r &= r - 1, ++pos)
        if (pos < a.max_out)
            cells[pos] = (int32_t)(base + __ffs(r) - 1);
    if (base < n_cells)
        for (int d = 0; d < P.n_data; ++d) {
            uint8_t *t = (uint8_t *)hs::part_plane(P, s, d, HS_PART_TOUCHED);
            const bool whole = base + kPer <= n_cells &&
                               ((uintptr_t)(t + base) & 15) == 0;
            clear_flags(t, base, n_cells, mask, whole);
        }
    if (tile == tiles - 1 && threadIdx.x == 0)
        cells[a.max_out] = (int32_t)(off + count);
    if (tile == 0 && threadIdx.x >= 32 && threadIdx.x < 64)  // the fill
        hs::merged_finalize_cell<32>(a.f, P, s, 0,
                                     hs::merged_count(P, s, 0),
                                     cells + a.max_out + 1 + 3, 1,
                                     threadIdx.x & 31, s_buf);
}

// staged: a thread per four columns of key shard blockIdx.y, a row at a
// time (merged_cols), the fill from the scan's
__global__ void __launch_bounds__(kThreads)
merged_finalize_kernel(const __grid_constant__ HsMergedTouchedArgs m) {
    extern __shared__ __align__(16) unsigned char s_buf[];
    const HsTouchedArgs &a = m.t;
    const int s = blockIdx.y;
    const hs::Tab tab = hs::stage_tab(m.parts, s, s_buf);
    __syncthreads();
    const int64_t c0 =
        ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kCols;
    if (c0 >= a.max_out) return;
    const int32_t *cells = a.cells + s * shard_words(a.max_out, a.out_rows);
    const int n = cells[a.max_out];
    for (int g = -1; g < a.f.n_aggs; ++g)
        merged_cols(m, tab, s, cells, n, cells + a.max_out + 1, c0, g);
}

// staged, queries with sketches: a warp per touched column of key shard
// blockIdx.y, each sketch aggregate merged in its warp's buffer of
// shared memory and estimated
__global__ void __launch_bounds__(kThreads)
merged_sketch_kernel(const __grid_constant__ HsMergedTouchedArgs m) {
    extern __shared__ __align__(16) unsigned char s_buf[];
    const HsTouchedArgs &a = m.t;
    const int s = blockIdx.y;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const hs::Tab tab = hs::stage_tab(m.parts, s, s_buf);
    __syncthreads();
    void *buf = s_buf + hs::tab_bytes(m.parts) +
                warp * hs::sketch_buf_bytes(a.f);
    const int32_t *cells = a.cells + s * shard_words(a.max_out, a.out_rows);
    const int nv = min(cells[a.max_out], a.max_out);
    int32_t *out = a.out + (int64_t)s * a.out_rows * a.max_out;
    const int64_t warps = (int64_t)gridDim.x * (kThreads / 32);
    for (int64_t col = (int64_t)blockIdx.x * (kThreads / 32) + warp;
         col < nv; col += warps)
        for (int g = 0; g < a.f.n_aggs; ++g) {
            if (!hs::is_sketch_kind(a.f.a[g].kind)) continue;
            const int32_t v = tab_sketch(a.f, tab, g, cells[col], buf, lane);
            if (lane == 0)
                out[(int64_t)(3 + a.f.a[g].row) * a.max_out + col] = v;
        }
}

}  // namespace

extern "C" int64_t hs_touched_merged_scratch_bytes(int32_t n_cells,
                                                   int32_t max_out,
                                                   int32_t out_rows,
                                                   int32_t n_key) {
    return (merged_status_word(max_out, out_rows, n_key) +
            2ll * n_key * blocks_of(n_cells, kChunk)) *
           (int64_t)sizeof(int32_t);
}

extern "C" int hs_touched_merged(const HsMergedTouchedArgs *args,
                                 void *stream) {
    static std::atomic<uint64_t> one_smem{0}, sketch_smem{0};
    HsMergedTouchedArgs m = *args;
    HsTouchedArgs &a = m.t;
    const HsParts &P = m.parts;
    const int n_cells = a.n_keys * a.n_slots;
    if (n_cells <= 0 || a.max_out <= 0) return 0;
    if (P.n_data < 1 || P.n_key < 1 || P.local_keys != a.n_keys ||
        P.tab == nullptr || a.f.n_aggs > HS_MAX_AGGS ||
        P.n_planes != 3 + 2 * a.f.n_aggs || P.n_key > 65535)
        return (int)cudaErrorInvalidValue;
    a.has_sketch = 0;
    for (int g = 0; g < a.f.n_aggs; ++g) {
        const int kind = a.f.a[g].kind;
        if (kind == HS_AGG_TOPK || kind == HS_AGG_TOPK_DISTINCT)
            return (int)cudaErrorInvalidValue;  // no elementwise merge
        a.has_sketch |= hs::is_sketch_kind(kind) ? 1 : 0;
    }
    // dynamic shared memory: the staged plane table, then (with
    // sketches) a merge buffer a warp
    const int tab = hs::tab_bytes(P);
    const int smem = tab + (a.has_sketch ? (kThreads / 32) *
                                               hs::sketch_buf_bytes(a.f)
                                         : 0);
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err;
    if (a.mode == HS_TOUCHED_ONE) {
        if (n_cells > kChunk || a.out_rows > HS_TOUCHED_ONE_ROWS ||
            a.ticket == nullptr || smem > kOneSmemMax)
            return (int)cudaErrorInvalidValue;
        if (smem > 24 * 1024) {
            err = hs::allow_smem(one_smem, merged_one_kernel, kOneSmemMax);
            if (err != cudaSuccess) return (int)err;
        }
        const dim3 grid(blocks_of(a.max_out, merged_one_cols(a)), P.n_key);
        merged_one_kernel<<<grid, kThreads, smem, st>>>(m);
        return (int)cudaGetLastError();
    }
    if (a.mode != HS_TOUCHED_STAGED || smem > 232448)
        return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        err = hs::allow_smem(sketch_smem, merged_sketch_kernel, 232448);
        if (err != cudaSuccess) return (int)err;
    }
    int32_t *w = (int32_t *)a.scratch;
    a.cells = w;
    a.fill = nullptr;  // each shard's fill follows its cells
    const int64_t sw = merged_status_word(a.max_out, a.out_rows, P.n_key);
    a.ticket = (uint32_t *)(w + P.n_key * shard_words(a.max_out,
                                                      a.out_rows));
    a.status = (uint64_t *)(w + sw);
    const int tiles = blocks_of(n_cells, kChunk);
    int e = (int)cudaMemsetAsync(
        a.ticket, 0,
        (size_t)((char *)(a.status + (int64_t)P.n_key * tiles) -
                 (char *)a.ticket),
        st);
    if (e != 0) return e;
    merged_touched_scan_kernel<<<P.n_key * tiles, kThreads,
                                 hs::sketch_buf_bytes(a.f), st>>>(m);
    e = (int)cudaGetLastError();
    if (e != 0) return e;
    merged_finalize_kernel<<<dim3(blocks_of(a.max_out, kThreads * kCols),
                                  P.n_key),
                             kThreads, tab, st>>>(m);
    e = (int)cudaGetLastError();
    if (e != 0 || !a.has_sketch) return e;
    merged_sketch_kernel<<<dim3(std::min(blocks_of(a.max_out, kThreads / 32),
                                         kSketchBlocks),
                                P.n_key),
                           kThreads, smem, st>>>(m);
    return (int)cudaGetLastError();
}

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
