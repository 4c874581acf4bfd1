// Reading a cell of the sharded window lattice: the merge of its D
// partial lattices, one a data shard, as the reference's psum / pmin /
// pmax over the data axis give it (hstream_tpu/parallel/lattice.py:
// 192-199 merged_col, :297-313 touched_local). Shared by the merged
// close (close.cu) and the merged changelog extract (touched.cu).
//
// count, COUNT(col), AVG's count and the quantile bins add as int32;
// SUM's and AVG's float32 sums add in data-shard order, d = 0 first;
// MIN and MAX take fminf / fmaxf; HLL registers (int8 ranks, never
// negative) and slot_start take the max. The plain versions in
// parallel/lattice.py merge in the same order, so a merged float32 sum
// equals theirs bit for bit on the card.
//
// The partials' plane pointers are a table on the card (HsParts.tab),
// read at each use (part_plane) or staged a key shard's row at a time
// in shared memory (stage_tab). The merged changelog extract merges a
// sketch cell (1 KiB of registers or 2 KiB of bins at the default
// sizes) by its warp into a buffer of shared memory, which the
// single-card estimates (finalize.cuh) then read; the merged close
// takes the HLL estimate from the merged registers in registers
// (hll_merged) and sums quantile bins with 16-byte loads (merge_bins).
#pragma once

#include <cuda_runtime.h>

#include "finalize.cuh"
#include "hs_kernels.h"

namespace hs {

__host__ __device__ __forceinline__ bool is_sketch_kind(int kind) {
    return kind == HS_AGG_HLL || kind == HS_AGG_QUANT;
}

// the shared-memory bytes a warp needs to merge the widest sketch cell,
// a multiple of 16 (0 without sketches)
__host__ __device__ inline int sketch_buf_bytes(const HsFinalize &f) {
    int most = 0;
    for (int g = 0; g < f.n_aggs; ++g) {
        const HsCloseAgg &ag = f.a[g];
        if (!is_sketch_kind(ag.kind)) continue;
        const int bytes = ag.kind == HS_AGG_HLL ? ag.plane_width
                                                : 4 * ag.plane_width;
        most = bytes > most ? bytes : most;
    }
    return (most + 15) & ~15;
}

// partial (key shard s, data shard d)'s plane `plane`, read from the
// partial table on the card
__device__ __forceinline__ void *part_plane(const HsParts &P, int s, int d,
                                            int plane) {
    return (void *)P.tab[((int64_t)s * P.n_data + d) * P.n_planes + plane];
}

// A block's key shard s's plane pointers, tab[d * np + i]: a copy of the
// shard's row of the partial table staged in shared memory at the
// block's start (read once, all at a time, while the block issues its
// first loads), or the row on the card where it would take more than
// kTabStageMax bytes (past 48 KB: 683 data shards at one aggregate).
// The block's __syncthreads() must follow stage_tab before a staged
// table is read.
constexpr int kTabStageMax = 48 * 1024;

struct Tab {
    const uint64_t *p;
    int n_data, np;
    __device__ __forceinline__ const void *plane(int d, int i) const {
        return (const void *)p[d * np + i];
    }
};

// the shared memory bytes a block stages its key shard's row in, a
// multiple of 16; 0 where the row stays on the card
__host__ __device__ __forceinline__ int tab_bytes(const HsParts &P) {
    const int64_t bytes =
        ((int64_t)P.n_data * P.n_planes * (int64_t)sizeof(uint64_t) + 15) &
        ~(int64_t)15;
    return bytes <= kTabStageMax ? (int)bytes : 0;
}

__device__ __forceinline__ Tab stage_tab(const HsParts &P, int s,
                                         void *smem) {
    const int n = P.n_data * P.n_planes;
    const uint64_t *row = P.tab + (int64_t)s * n;
    if (tab_bytes(P) == 0) return Tab{row, P.n_data, P.n_planes};
    uint64_t *tab = (uint64_t *)smem;
    for (int i = threadIdx.x; i < n; i += blockDim.x) tab[i] = row[i];
    return Tab{tab, P.n_data, P.n_planes};
}

__device__ __forceinline__ int agg_plane(int g) { return 3 + 2 * g; }

__device__ __forceinline__ int merged_count(const HsParts &P, int s,
                                            int64_t cell) {
    int c = 0;
    for (int d = 0; d < P.n_data; ++d)
        c += ((const int32_t *)part_plane(P, s, d, HS_PART_COUNT))[cell];
    return c;
}

// a scalar aggregate's merged plane word (float32 bits, or COUNT's
// int32) and AVG's merged count
__device__ __forceinline__ void merged_word(const HsParts &P,
                                            const HsCloseAgg &ag, int g,
                                            int s, int64_t cell, uint32_t &w,
                                            int32_t &n) {
    w = 0u;
    n = 0;
    if (ag.kind == HS_AGG_COUNT_ALL) return;
    const int pi = agg_plane(g);
    if (ag.kind == HS_AGG_COUNT) {
        uint32_t c = 0u;
        for (int d = 0; d < P.n_data; ++d)
            c += ((const uint32_t *)part_plane(P, s, d, pi))[cell];
        w = c;
        return;
    }
    float v = ((const float *)part_plane(P, s, 0, pi))[cell];
    for (int d = 1; d < P.n_data; ++d) {
        const float x = ((const float *)part_plane(P, s, d, pi))[cell];
        v = ag.kind == HS_AGG_MIN   ? fminf(v, x)
            : ag.kind == HS_AGG_MAX ? fmaxf(v, x)
                                    : __fadd_rn(v, x);
    }
    w = __float_as_uint(v);
    if (ag.kind == HS_AGG_AVG)
        for (int d = 0; d < P.n_data; ++d)
            n += ((const int32_t *)part_plane(P, s, d, pi + 1))[cell];
}

// aggregate g's sketch cell merged into buf by the whole warp (HLL: the
// bytewise max of the registers, four a word; quantiles: the sum of the
// bins); buf is 16-byte aligned shared memory of sketch_buf_bytes
__device__ inline void merge_sketch(const HsParts &P, const HsCloseAgg &ag,
                                    int g, int s, int64_t cell, void *buf,
                                    int lane) {
    const int pi = agg_plane(g);
    if (ag.kind == HS_AGG_HLL) {
        const int words = ag.plane_width >> 2;   // m = 2^p, p >= 2
        for (int w = lane; w < words; w += 32) {
            uint32_t v = 0u;
            for (int d = 0; d < P.n_data; ++d)
                v = __vmaxu4(v, ((const uint32_t *)part_plane(P, s, d, pi))
                                    [cell * words + w]);
            ((uint32_t *)buf)[w] = v;
        }
    } else {
        const int bins = ag.plane_width;
        for (int b = lane; b < bins; b += 32) {
            uint32_t v = 0u;
            for (int d = 0; d < P.n_data; ++d)
                v += ((const uint32_t *)part_plane(P, s, d, pi))
                    [cell * bins + b];
            ((uint32_t *)buf)[b] = v;
        }
    }
    __syncwarp();
}

// ---- the merged close's sketches, over a staged table (close.cu) ----

// the HyperLogLog estimate from each lane's share of the exact sum of
// 2^(R-r) and of the zero registers (hll_word's), summed over the warp:
// hll_regs' end (finalize.cuh), kept apart, since taking it out of
// hll_regs changed the single-card extract's register allocation (B6's
// one launch 5.9 -> 6.4 µs on an H100). The result on every lane.
__device__ __forceinline__ float hll_value(const HsFinalize &f,
                                           unsigned long long sum,
                                           int zeros) {
    const int m = 1 << f.hll_p;
    const int big_r = 33 - f.hll_p;
    for (int d = 16; d > 0; d >>= 1) {
        sum += __shfl_xor_sync(0xFFFFFFFFu, sum, d);
        zeros += __shfl_xor_sync(0xFFFFFFFFu, zeros, d);
    }
    float fm = (float)m;
    float denom = ldexpf(__ull2float_rn(sum), -big_r);
    float raw = __fdiv_rn(f.hll_am2, denom);
    float lin = __fmul_rn(fm, logf(__fdiv_rn(
        fm, fmaxf(__int2float_rn(zeros), 1.0f))));
    bool use_lin = raw <= 2.5f * fm && zeros > 0;
    return use_lin ? lin : raw;
}

// partials a lane loads before it combines them: 4 took the merged
// close's warp a key past 128 registers into spills (7.1 µs against 5.7
// at config 1's slot over four partials on an H100)
constexpr int kMergeD = 2;

// The HyperLogLog estimate of the merged cell of aggregate plane pi: the
// bytewise max of the D partials' int8 registers (__vmaxs4, the plain
// version's signed max) taken as they are read, each lane's vectors of
// kMergeD partials in flight together (16-byte loads, a warp's 512
// contiguous bytes a partial), summed as hll_regs sums the single-card
// cell; nothing goes through shared memory. With `zero`, each lane sets
// the vectors it read to 0 (the reset of the cell: no other lane reads
// them) as soon as it has merged them. The result on every lane.
__device__ inline float hll_merged(const HsFinalize &f, const Tab &t,
                                   int pi, int64_t cell, int lane,
                                   bool zero) {
    const int m = 1 << f.hll_p;
    const int big_r = 33 - f.hll_p;
    unsigned long long sum = 0;
    int zeros = 0;
    if (m >= 16) {
        const int nv = m >> 4;
        constexpr uint32_t kLow = 0x80808080u;   // -128 a byte: the
                                                  // identity of the max
        for (int w0 = 0; w0 < nv; w0 += 64) {   // two vectors a lane
            uint4 acc[2] = {make_uint4(kLow, kLow, kLow, kLow),
                            make_uint4(kLow, kLow, kLow, kLow)};
            for (int d0 = 0; d0 < t.n_data; d0 += kMergeD) {
                uint4 x[kMergeD][2];
#pragma unroll
                for (int j = 0; j < kMergeD; ++j)
#pragma unroll
                    for (int u = 0; u < 2; ++u) {
                        const int w = w0 + 32 * u + lane;
                        x[j][u] = d0 + j < t.n_data && w < nv
                            ? ((const uint4 *)t.plane(d0 + j, pi))
                                  [cell * nv + w]
                            : make_uint4(0u, 0u, 0u, 0u);
                    }
#pragma unroll
                for (int u = 0; u < 2; ++u) {
#pragma unroll
                    for (int j = 0; j < kMergeD; ++j) {
                        if (d0 + j >= t.n_data) break;
                        acc[u].x = __vmaxs4(acc[u].x, x[j][u].x);
                        acc[u].y = __vmaxs4(acc[u].y, x[j][u].y);
                        acc[u].z = __vmaxs4(acc[u].z, x[j][u].z);
                        acc[u].w = __vmaxs4(acc[u].w, x[j][u].w);
                    }
                }
                if (zero)
#pragma unroll
                    for (int j = 0; j < kMergeD; ++j)
#pragma unroll
                        for (int u = 0; u < 2; ++u) {
                            const int w = w0 + 32 * u + lane;
                            if (d0 + j < t.n_data && w < nv)
                                ((uint4 *)t.plane(d0 + j, pi))
                                    [cell * nv + w] =
                                    make_uint4(0u, 0u, 0u, 0u);
                        }
            }
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                if (w0 + 32 * u + lane >= nv) continue;
                hll_word(acc[u].x, big_r, sum, zeros);
                hll_word(acc[u].y, big_r, sum, zeros);
                hll_word(acc[u].z, big_r, sum, zeros);
                hll_word(acc[u].w, big_r, sum, zeros);
            }
        }
    } else {
        const int words = m >> 2;
        for (int w = lane; w < words; w += 32) {
            uint32_t v = 0x80808080u;
            for (int d = 0; d < t.n_data; ++d) {
                uint32_t *x = (uint32_t *)t.plane(d, pi) + cell * words + w;
                v = __vmaxs4(v, *x);
                if (zero) *x = 0u;
            }
            hll_word(v, big_r, sum, zeros);
        }
    }
    return hll_value(f, sum, zeros);
}

// the merged cell of a quantile plane pi ([.., bins] int32) into buf:
// the sum of the D partials' bins, 16-byte loads of kMergeD partials in
// flight together where the cells are 16-byte aligned; the whole warp,
// buf 16-byte aligned shared memory of 4 * bins bytes. With `zero`, the
// bins each lane read set to 0 once merged (the cell's reset).
__device__ inline void merge_bins(const Tab &t, int pi, int bins,
                                  int64_t cell, void *buf, int lane,
                                  bool zero) {
    const bool vec = (bins & 3) == 0 &&
                     ((uintptr_t)t.plane(0, pi) & 15) == 0;
    if (vec) {
        const int nv = bins >> 2;
        for (int w = lane; w < nv; w += 32) {
            int4 acc = make_int4(0, 0, 0, 0);
            for (int d0 = 0; d0 < t.n_data; d0 += kMergeD) {
                int4 x[kMergeD];
#pragma unroll
                for (int j = 0; j < kMergeD; ++j)
                    x[j] = d0 + j < t.n_data
                        ? ((const int4 *)t.plane(d0 + j, pi))[cell * nv + w]
                        : make_int4(0, 0, 0, 0);
#pragma unroll
                for (int j = 0; j < kMergeD; ++j) {
                    acc.x += x[j].x;
                    acc.y += x[j].y;
                    acc.z += x[j].z;
                    acc.w += x[j].w;
                }
                if (zero)
#pragma unroll
                    for (int j = 0; j < kMergeD; ++j)
                        if (d0 + j < t.n_data)
                            ((int4 *)t.plane(d0 + j, pi))[cell * nv + w] =
                                make_int4(0, 0, 0, 0);
            }
            ((int4 *)buf)[w] = acc;
        }
    } else {
        for (int b = lane; b < bins; b += 32) {
            uint32_t v = 0u;
            for (int d = 0; d < t.n_data; ++d) {
                uint32_t *x = (uint32_t *)t.plane(d, pi) + cell * bins + b;
                v += *x;
                if (zero) *x = 0u;
            }
            ((uint32_t *)buf)[b] = v;
        }
    }
    __syncwarp();
}

// every aggregate's rows of merged cell `cell` of key shard s: the
// aggregates' row r at out[r * stride]; kLanes lanes a cell, which
// share the scalar aggregates; the sketches need a whole warp (kLanes
// 32) and its buffer
template <int kLanes>
__device__ inline void merged_finalize_cell(const HsFinalize &f,
                                            const HsParts &P, int s,
                                            int64_t cell, int cnt,
                                            int32_t *out, int64_t stride,
                                            int lane, void *buf) {
    for (int g = 0; g < f.n_aggs; ++g) {
        const HsCloseAgg &ag = f.a[g];
        if (is_sketch_kind(ag.kind)) {
            if (kLanes != 32) continue;   // refused by the host entries
            merge_sketch(P, ag, g, s, cell, buf, lane);
            HsCloseAgg t = ag;
            t.plane = buf;
            const float v = ag.kind == HS_AGG_HLL ? hll_warp(f, t, 0, lane)
                                                  : quant_warp(f, t, 0, lane);
            if (lane == 0) out[(int64_t)ag.row * stride] = __float_as_int(v);
            __syncwarp();   // the buffer is read before the next merge
            continue;
        }
        if (g % kLanes != lane) continue;
        uint32_t w;
        int32_t n;
        merged_word(P, ag, g, s, cell, w, n);
        out[(int64_t)ag.row * stride] =
            __float_as_int(finalize_loaded(ag.kind, w, n, cnt));
    }
}

}  // namespace hs
