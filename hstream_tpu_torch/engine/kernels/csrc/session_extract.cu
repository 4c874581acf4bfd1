// Session extract: finalize the arena slots a close cycle (or a peek)
// names into one int32 buffer [1 + n_aggs, P], fetched in one copy.
//
// Replaces hstream_tpu/engine/lattice.py:1504-1550 session_extract_kernel
// (hs_session_extract) and, for a mesh's key-sharded arena,
// hstream_tpu/parallel/lattice.py:716-728 ShardedSessionLattice.extract
// (hs_session_extract_table: [n_shards, 1 + n_aggs, P]). Slots < 0 pad
// the vector to a power of two and extract zeros (row 0: the sentinel
// code).
//
// Bound on the H100: bytes: each named slot's planes read once (a 512-bin
// histogram is 2 KiB, an HLL register set 1 KiB), the buffer written once.
// On the session path (BASELINE config 4) two APPROX_QUANTILEs share one
// histogram (session_lattice.session_plane_names), so the bound reads it
// once for both.
//
// What held the first design back: each APPROX_QUANTILE read its
// histogram on its own, so the shared one was read twice; a lane read
// 16 consecutive bins, so a warp-wide load touched 32 sectors 64 bytes
// apart and a histogram took 16 such loads; and each aggregate waited
// out its own chain of loads. The key-sharded extract first launched
// the single-card kernel once a shard: four launches' floors, four
// argument blocks built, and a warp for every pad (at phase 15a's
// inputs ~26,500 pad warps beside 6,250 named slots).
//
// Design: a warp a slot, eight slots a block. The slot vector comes up
// to its last named slot only (n_live; the pads that round it up to a
// power of two stay on the host), by value in the kernel's parameters
// up to HS_SESS_INLINE slots (the path's ~6,250), so no copy precedes
// the launch; a longer one is uploaded. A pad's warp writes its
// sentinel row and zeros and reads nothing. A slot's lanes first load
// the words of its scalar rows (lane r row r: the code, a COUNT's or
// SUM's word, AVG's sum and count, MIN/MAX), then run the sketches with
// the loads in flight: an HLL estimate (finalize.cuh hll_warp), and
// each histogram once, read with 16-byte loads over 512 contiguous
// bytes a warp, scanned round by round, with every APPROX_QUANTILE that
// shares it answered from the same registers (quant_scan, up to four at
// a time). The finalize follows the session's own rules, which differ
// from the window close's: an empty histogram gives 0.0 (not the top
// bucket's midpoint), a MIN of +inf or a MAX of -inf gives 0.0, HLL is
// rint(estimate) as int32, AVG is sum / max(n, 1) in float32, counts are
// int32, floats are bitcast.
//
// The table (key-sharded): one launch a card over the shards whose
// arenas lie there (HsSessExtractTable: each shard's plane pointers, its
// row, its named prefix; the prefixes concatenated by value where they
// fit beside the pointers, else uploaded once). A shard's warps are a
// warp per entry of its prefix, the same body as above, then a warp per
// 32 pad columns, a lane a column, each row one 128-byte store. The
// host cuts the table's warps into up to 32 pieces of nearly equal
// length, a grid row a piece (its fields read at the block's index):
// on an H100 a warp that first looked its shard up cost 0.5-1.9 µs a
// call, and a grid row a shard launched ~2,300 blocks that exit at once
// where all of a cycle's named slots fall in one shard, as 15a's do. The
// single-card kernel keeps its loop (extract_slot over its own planes).

#include <cuda_runtime.h>

#include <algorithm>

#include "finalize.cuh"
#include "hs_kernels.h"

namespace {

constexpr int kBlock = 256;
constexpr int kMaxQ = 4;   // quantiles of one histogram answered at once

__device__ __forceinline__ bool sketch_kind(int kind) {
    return kind == HS_AGG_HLL || kind == HS_AGG_QUANT;
}

// the planes a slot's rows are read from: the launch's finalize table
// (one arena), or a table shard's pointer words
struct OwnPlanes {
    const HsFinalize &f;
    __device__ __forceinline__ const void *plane(int g) const {
        return f.a[g].plane;
    }
    __device__ __forceinline__ const int32_t *plane_n(int g) const {
        return f.a[g].plane_n;
    }
};

struct ShardPlanes {
    const unsigned long long *p;   // plane, plane_n of each aggregate
    __device__ __forceinline__ const void *plane(int g) const {
        return (const void *)p[2 * g];
    }
    __device__ __forceinline__ const int32_t *plane_n(int g) const {
        return (const int32_t *)p[2 * g + 1];
    }
};

// row r's words: r = 0 the slot's code, else aggregate r - 1's plane
// word (w) and AVG's count (n); nothing for a sketch
template <class Planes>
__device__ __forceinline__ void load_row(const HsFinalize &f,
                                         const Planes &pl,
                                         const int32_t *code, int slot,
                                         int r, bool active, uint32_t &w,
                                         int32_t &n) {
    w = 0u;
    n = 0;
    if (!active) return;
    if (r == 0) {
        w = (uint32_t)code[slot];
        return;
    }
    const HsCloseAgg &ag = f.a[r - 1];
    if (sketch_kind(ag.kind)) return;
    w = ((const uint32_t *)pl.plane(r - 1))[slot];
    if (ag.kind == HS_AGG_AVG) n = pl.plane_n(r - 1)[slot];
}

// row r (> 0) of a scalar aggregate from its words, by the session's rules
__device__ __forceinline__ int32_t row_value(const HsCloseAgg &ag,
                                             uint32_t w, int32_t n) {
    switch (ag.kind) {
    case HS_AGG_COUNT_ALL:
    case HS_AGG_COUNT:
        return (int32_t)w;
    case HS_AGG_AVG:
        return __float_as_int(__fdiv_rn(__uint_as_float(w),
                                        fmaxf(__int2float_rn(n), 1.0f)));
    case HS_AGG_MIN:
    case HS_AGG_MAX: {
        const uint32_t none =
            ag.kind == HS_AGG_MIN ? 0x7F800000u : 0xFF800000u;
        return w == none ? 0 : (int32_t)w;
    }
    default:  // HS_AGG_SUM
        return (int32_t)w;
    }
}

// aggregates who[0..kQ) from one read of histogram h, by the session's
// rule (an empty histogram gives 0.0)
template <int kQ>
__device__ __forceinline__ void answer(const HsFinalize &f,
                                       const int32_t *h, int bins,
                                       const int (&who)[kMaxQ], int32_t *out,
                                       int64_t stride, int lane) {
    float q[kQ];
    int idx[kQ];
#pragma unroll
    for (int t = 0; t < kQ; ++t) q[t] = f.a[who[t]].q;
    const long long total = hs::quant_scan<kQ>(h, bins, lane, q, idx);
    if (lane == 0) {
#pragma unroll
        for (int t = 0; t < kQ; ++t)
            out[(int64_t)(1 + who[t]) * stride] = __float_as_int(
                total > 0 ? hs::quant_mid(f, idx[t]) : 0.0f);
    }
}

// the quantiles that read the histogram of aggregate g (the first of
// them): each from one read of it, up to kMaxQ at a time
template <class Planes>
__device__ __forceinline__ void quantiles(const HsFinalize &f,
                                          const Planes &pl, int g, int slot,
                                          int32_t *out, int64_t stride,
                                          int lane) {
    const void *plane = pl.plane(g);
    const int bins = f.a[g].plane_width;
    const int32_t *h = (const int32_t *)plane + (int64_t)slot * bins;
    for (int h0 = g; h0 < f.n_aggs;) {
        int who[kMaxQ] = {0, 0, 0, 0};
        int nq = 0, next = f.n_aggs;
        for (int j = h0; j < f.n_aggs; ++j) {
            if (f.a[j].kind != HS_AGG_QUANT || pl.plane(j) != plane)
                continue;
            if (nq == kMaxQ) {
                next = j;
                break;
            }
#pragma unroll
            for (int t = 0; t < kMaxQ; ++t)
                if (t == nq) who[t] = j;
            ++nq;
        }
        switch (nq) {
        case 1: answer<1>(f, h, bins, who, out, stride, lane); break;
        case 2: answer<2>(f, h, bins, who, out, stride, lane); break;
        case 3: answer<3>(f, h, bins, who, out, stride, lane); break;
        default: answer<4>(f, h, bins, who, out, stride, lane); break;
        }
        h0 = next;
    }
}

// one slot's rows (its column of out, rows `stride` apart), by a warp
template <class Planes>
__device__ __forceinline__ void extract_slot(const HsFinalize &f,
                                             const Planes &pl,
                                             const int32_t *code, int slot,
                                             int32_t *out, int64_t stride,
                                             int lane) {
    const int rows = 1 + f.n_aggs;
    if (slot < 0) {  // a pad: the sentinel code and zeros
        for (int r = lane; r < rows; r += 32)
            out[(int64_t)r * stride] = r == 0 ? HS_SESSION_SENT : 0;
        return;
    }
    uint32_t w;
    int32_t n;
    load_row(f, pl, code, slot, lane, lane < rows, w, n);
    for (int g = 0; g < f.n_aggs; ++g) {
        const HsCloseAgg &ag = f.a[g];
        if (ag.kind == HS_AGG_HLL) {
            const float est = hs::hll_regs(
                f, (const uint8_t *)pl.plane(g) +
                       (int64_t)slot * (1 << f.hll_p), lane);
            if (lane == 0)
                out[(int64_t)(1 + g) * stride] = (int32_t)rintf(est);
            continue;
        }
        if (ag.kind != HS_AGG_QUANT) continue;
        bool first = true;  // the first quantile of its histogram
        for (int j = 0; j < g && first; ++j)
            first = f.a[j].kind != HS_AGG_QUANT || pl.plane(j) != pl.plane(g);
        if (first) quantiles(f, pl, g, slot, out, stride, lane);
    }
    for (int r = lane; r < rows; r += 32) {
        if (r >= 32) load_row(f, pl, code, slot, r, true, w, n);
        if (r == 0) {
            out[0] = (int32_t)w;
        } else if (!sketch_kind(f.a[r - 1].kind)) {
            out[(int64_t)r * stride] = row_value(f.a[r - 1], w, n);
        }
    }
}

__global__ void __launch_bounds__(kBlock)
extract_kernel(const __grid_constant__ HsSessExtractArgs a) {
    const int64_t p = ((int64_t)blockIdx.x * kBlock + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (p >= a.n_sel) return;  // warp-uniform: one slot per warp
    const int slot = p >= a.n_live ? -1
                     : a.slots != nullptr ? a.slots[p] : a.sel[p];
    extract_slot(a.f, OwnPlanes{a.f}, a.code, slot, a.out + p, a.n_sel,
                 lane);
}

// the table: grid row r is piece r, its warp w its shard's warp j0 + w:
// an entry of the shard's prefix (j < n_live) or 32 of its pad columns;
// the piece's fields read at the block's index, so no warp looks its
// shard up before its loads
__global__ void __launch_bounds__(kBlock)
extract_table_kernel(const __grid_constant__ HsSessExtractTable t) {
    const HsSessXtPiece &pc = t.pc[blockIdx.y];
    const int w = (int)(((int64_t)blockIdx.x * kBlock + threadIdx.x) >> 5);
    if (w >= pc.n_warps) return;  // warp-uniform
    const int j = pc.j0 + w;
    const int lane = threadIdx.x & 31;
    const int64_t stride = t.n_sel;
    if (j >= pc.n_live) {  // pad columns, a lane each
        const int64_t p = pc.n_live + (int64_t)(j - pc.n_live) * 32 + lane;
        if (p < stride)
            for (int r = 0; r <= t.f.n_aggs; ++r)
                pc.out[r * stride + p] = r == 0 ? HS_SESSION_SENT : 0;
        return;
    }
    const int32_t *sel = t.slots != nullptr ? t.slots : t.words;
    const ShardPlanes pl{(const unsigned long long *)t.words +
                         2 * pc.place * t.f.n_aggs};
    extract_slot(t.f, pl, pc.code, sel[pc.sel0 + j], pc.out + j, stride,
                 lane);
}

}  // namespace

extern "C" int hs_session_extract(const HsSessExtractArgs *args,
                                  void *stream) {
    if (args->n_sel == 0) return 0;
    if (args->f.n_aggs > HS_MAX_AGGS || args->n_live < 0 ||
        args->n_live > args->n_sel ||
        (args->slots == nullptr && args->n_live > HS_SESS_INLINE))
        return (int)cudaErrorInvalidValue;
    const int64_t threads = (int64_t)args->n_sel * 32;
    extract_kernel<<<(unsigned)((threads + kBlock - 1) / kBlock), kBlock, 0,
                     (cudaStream_t)stream>>>(*args);
    return (int)cudaGetLastError();
}

extern "C" int hs_session_extract_table(const HsSessExtractTable *t,
                                        void *stream) {
    if (t->n_sel == 0 || t->n_pieces == 0) return 0;
    if (t->n_group < 1 || t->n_group > HS_SESS_XT_SHARDS ||
        t->n_pieces < 0 || t->n_pieces > HS_SESS_XT_PIECES ||
        t->f.n_aggs > HS_MAX_AGGS ||
        4 * t->n_group * t->f.n_aggs > HS_SESS_XT_WORDS)
        return (int)cudaErrorInvalidValue;
    int warps = 0;   // the longest piece's
    for (int r = 0; r < t->n_pieces; ++r) {
        const HsSessXtPiece &pc = t->pc[r];
        const int live = std::min(pc.j0 + pc.n_warps, pc.n_live);
        if (pc.place < 0 || pc.place >= t->n_group || pc.n_live < 0 ||
            pc.n_live > t->n_sel || pc.j0 < 0 || pc.n_warps < 0 ||
            pc.j0 + pc.n_warps >
                pc.n_live + (t->n_sel - pc.n_live + 31) / 32 ||
            (t->slots == nullptr && live > pc.j0 &&
             pc.sel0 + live > HS_SESS_XT_WORDS))
            return (int)cudaErrorInvalidValue;
        warps = std::max(warps, pc.n_warps);
    }
    const dim3 grid((unsigned)((warps * 32 + kBlock - 1) / kBlock),
                    (unsigned)t->n_pieces);
    extract_table_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(*t);
    return (int)cudaGetLastError();
}
