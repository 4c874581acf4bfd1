// Finalizing one (key, slot) cell of the lattice into its output rows:
// shared by the fused close (close.cu), the changelog extract
// (touched.cu) and the session extract (session_extract.cu). The sketch
// estimates are warp reductions: every lane of the warp calls them, and
// a cell's registers or bins are read once, with 16-byte loads that a
// warp issues over 512 contiguous bytes.
//
// The rows follow hstream_tpu/engine/lattice.py:411-465 (finalize_column
// and _agg_out_rows): one float32 row per aggregate, k rows for TOPK and
// TOPK_DISTINCT, written as int32 bits. The arithmetic is the
// reference's float32 arithmetic, one operation at a time, so each value
// equals the plain PyTorch version's (engine/lattice.py, sketches.py) on
// the card bit for bit:
//  * HLL (sketches.py:99-107 hll_estimate): the sum of 2^-r is taken
//    exactly, as the integer sum of 2^(R-r) with R = 33-p, rounded once;
//  * APPROX_QUANTILE (sketches.py:142-155 quantile_estimate): the CDF is
//    an exact integer scan, compared as float32 (the reference's float32
//    cumsum is exact while a cell holds fewer than 2^24 values), then
//    the geometric midpoint of the first bin whose CDF reaches q*total.
#pragma once

#include <cuda_runtime.h>

#include "hs_kernels.h"
#include "record.cuh"

namespace hs {

// a scalar aggregate's value from its plane word `w` (and AVG's count
// `n`), loaded by the caller, and the cell's count
__device__ __forceinline__ float finalize_loaded(int kind, uint32_t w,
                                                 int32_t n, int cnt) {
    switch (kind) {
    case HS_AGG_COUNT_ALL:
        return __int2float_rn(cnt);
    case HS_AGG_COUNT:
        return __int2float_rn((int32_t)w);
    case HS_AGG_AVG:
        return ftz(__fdiv_rn(__uint_as_float(w),
                             fmaxf(__int2float_rn(n), 1.0f)));
    case HS_AGG_MIN:
    case HS_AGG_MAX:
        return cnt > 0 ? __uint_as_float(w) : 0.0f;
    default:  // HS_AGG_SUM
        return __uint_as_float(w);
    }
}

__device__ __forceinline__ float finalize_scalar(const HsCloseAgg &g,
                                                 int64_t cell, int cnt) {
    const uint32_t w = g.kind == HS_AGG_COUNT_ALL
        ? 0u : ((const uint32_t *)g.plane)[cell];
    const int32_t n = g.kind == HS_AGG_AVG ? g.plane_n[cell] : 0;
    return finalize_loaded(g.kind, w, n, cnt);
}

// one 32-bit word of HLL registers (four int8 ranks) into the exact sum
// of 2^(R-r) and the count of zero registers
__device__ __forceinline__ void hll_word(uint32_t x, int big_r,
                                         unsigned long long &sum,
                                         int &zeros) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
        const int r = (int)(int8_t)((x >> (8 * b)) & 0xFFu);
        sum += 1ull << (big_r - r);
        zeros += r == 0;
    }
}

// HyperLogLog estimate of int8 registers regs [m]; the result on every
// lane. Lanes read 16 bytes at a time, neighbouring lanes neighbouring
// vectors (a warp-wide load is 512 contiguous bytes), four loads in
// flight a lane; fewer than 16 registers (p < 4) are read as words.
__device__ inline float hll_regs(const HsFinalize &f, const uint8_t *regs,
                                 int lane) {
    const int m = 1 << f.hll_p;
    const int big_r = 33 - f.hll_p;
    unsigned long long sum = 0;
    int zeros = 0;
    if (m >= 16) {
        const uint4 *v = (const uint4 *)regs;
        const int nv = m >> 4;
        for (int w0 = 0; w0 < nv; w0 += 128) {
            uint4 x[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int w = w0 + 32 * u + lane;
                x[u] = w < nv ? v[w] : make_uint4(0u, 0u, 0u, 0u);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                if (w0 + 32 * u + lane >= nv) continue;
                hll_word(x[u].x, big_r, sum, zeros);
                hll_word(x[u].y, big_r, sum, zeros);
                hll_word(x[u].z, big_r, sum, zeros);
                hll_word(x[u].w, big_r, sum, zeros);
            }
        }
    } else {
        const uint32_t *w32 = (const uint32_t *)regs;
        for (int w = lane; w < (m >> 2); w += 32)
            hll_word(w32[w], big_r, sum, zeros);
    }
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

// the HyperLogLog estimate of aggregate g's cell
__device__ __forceinline__ float hll_warp(const HsFinalize &f,
                                          const HsCloseAgg &g, int64_t cell,
                                          int lane) {
    return hll_regs(f, (const uint8_t *)g.plane + cell * (1 << f.hll_p),
                    lane);
}

// a histogram's rounds of 128 bins: lane l holds bins 128 i + 4 l .. +3
// of round i, so a warp-wide load is 512 contiguous bytes (16-byte loads
// where the bins are 16-byte aligned and a multiple of 4, else scalar
// loads); 0 past the last bin
constexpr int kQuantChunk = 4;   // rounds held in registers: 512 bins

__device__ __forceinline__ void quant_round(const int32_t *h, int bins,
                                            int round, int lane, bool vec,
                                            int (&v)[4]) {
    const int b = round * 128 + lane * 4;
    if (vec) {
        int4 x = make_int4(0, 0, 0, 0);
        if (b < bins) x = *(const int4 *)(h + b);
        v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
    } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = b + j < bins ? h[b + j] : 0;
    }
}

// The histogram h [bins] read once for kQ quantiles: returns the total
// on every lane and, for each q[k], idx[k], the number of bins whose
// CDF is below q[k] * max(total, 1) as float32 (the reference's float32
// cumsum, exact below 2^24 a cell), clamped to [0, bins - 1]: the bin
// the quantile names. The CDF is an exact integer scan, round by round
// (a warp scan of the lanes' four-bin sums and a running carry); up to
// kQuantChunk rounds stay in registers from the first pass, a wider
// histogram is read again. Where the total is at most 2^24 (every CDF
// exact in float32) a bin's test is an integer one, cdf < ceil(target),
// the same answer; kFull: whole rounds, no bin past the last to mask.
// Both at once, with the histogram in registers, is the common case
// (512 bins): there each quantile takes one scan and a ballot.
template <int kQ, bool kFull>
__device__ __forceinline__ long long quant_scan_t(const int32_t *h, int bins,
                                                  int lane, bool vec,
                                                  const float (&q)[kQ],
                                                  int (&idx)[kQ]) {
    const int rounds = (bins + 127) >> 7;
    int v[kQuantChunk][4];
    long long own = 0;
    for (int c = 0; c < rounds; c += kQuantChunk) {
#pragma unroll
        for (int i = 0; i < kQuantChunk; ++i)
            quant_round(h, c + i < rounds ? bins : 0, c + i, lane,
                        kFull || vec, v[i]);
#pragma unroll
        for (int i = 0; i < kQuantChunk; ++i)
            own += (long long)v[i][0] + v[i][1] + v[i][2] + v[i][3];
    }
    long long total = own;
    for (int d = 16; d > 0; d >>= 1)
        total += __shfl_xor_sync(0xFFFFFFFFu, total, d);
    const float tf = fmaxf(__ll2float_rn(total), 1.0f);
    float target[kQ];
    int x0[kQ], below[kQ];
    bool narrow = total >= 0 && total <= (1 << 24);
#pragma unroll
    for (int k = 0; k < kQ; ++k) {
        target[k] = __fmul_rn(q[k], tf);
        narrow = narrow && target[k] <= 1073741824.0f;
        x0[k] = narrow ? (int)ceilf(target[k]) : 0;
        below[k] = 0;
    }
    if (kFull && narrow && rounds <= kQuantChunk) {
        // the histogram in registers and every CDF below 2^24: the CDF
        // rises bin by bin, so the bins below x are those before the
        // first whose CDF reaches it. Find that bin's round from the
        // rounds' totals, its lane from a ballot over one scan of that
        // round, and its place among the lane's four bins.
        int sum[kQuantChunk], end[kQuantChunk];
        int run = 0;
#pragma unroll
        for (int i = 0; i < kQuantChunk; ++i) {
            sum[i] = v[i][0] + v[i][1] + v[i][2] + v[i][3];
            run += (int)__reduce_add_sync(0xFFFFFFFFu, (unsigned)sum[i]);
            end[i] = run;   // rounds past the last hold zeros
        }
#pragma unroll
        for (int k = 0; k < kQ; ++k) {
            const int x = x0[k];
            int r = 0;   // rounds wholly below x
#pragma unroll
            for (int i = 0; i < kQuantChunk; ++i) r += end[i] < x;
            int b = bins;
            if (r < rounds) {
                int start = 0, sr = 0, w0 = 0, w1 = 0, w2 = 0;
#pragma unroll
                for (int i = 0; i < kQuantChunk; ++i) {
                    if (i != r) continue;
                    start = i > 0 ? end[i > 0 ? i - 1 : 0] : 0;
                    sr = sum[i], w0 = v[i][0], w1 = v[i][1], w2 = v[i][2];
                }
                int incl = sr;
                for (int d = 1; d < 32; d <<= 1) {
                    const int t = __shfl_up_sync(0xFFFFFFFFu, incl, d);
                    if (lane >= d) incl += t;
                }
                // lanes whose four bins all lie below x: a prefix, as the
                // round reaches x, shorter than the warp
                const int whole = __popc(__ballot_sync(0xFFFFFFFFu,
                                                       start + incl < x));
                const int c0 = start + incl - sr + w0;
                const int mine = (c0 < x) + (c0 + w1 < x) +
                                 (c0 + w1 + w2 < x);
                b = 128 * r + 4 * whole +
                    __shfl_sync(0xFFFFFFFFu, mine, whole);
            }
            idx[k] = min(max(b, 0), bins - 1);
        }
        return total;
    }
    long long carry = 0;
    for (int c = 0; c < rounds; c += kQuantChunk) {
        if (rounds > kQuantChunk) {
#pragma unroll
            for (int i = 0; i < kQuantChunk; ++i)
                quant_round(h, c + i < rounds ? bins : 0, c + i, lane,
                            kFull || vec, v[i]);
        }
#pragma unroll
        for (int i = 0; i < kQuantChunk; ++i) {
            if (c + i >= rounds) break;
            const int b = (c + i) * 128 + lane * 4;
            if (narrow) {   // every prefix below 2^24: 32-bit and exact
                const int s = v[i][0] + v[i][1] + v[i][2] + v[i][3];
                int incl = s;
                for (int d = 1; d < 32; d <<= 1) {
                    const int t = __shfl_up_sync(0xFFFFFFFFu, incl, d);
                    if (lane >= d) incl += t;
                }
                int cdf = (int)carry + incl - s;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    cdf += v[i][j];
#pragma unroll
                    for (int k = 0; k < kQ; ++k)
                        below[k] += (kFull || b + j < bins) && cdf < x0[k];
                }
                carry += __shfl_sync(0xFFFFFFFFu, incl, 31);
            } else {
                const long long s =
                    (long long)v[i][0] + v[i][1] + v[i][2] + v[i][3];
                long long incl = s;
                for (int d = 1; d < 32; d <<= 1) {
                    const long long t = __shfl_up_sync(0xFFFFFFFFu, incl, d);
                    if (lane >= d) incl += t;
                }
                long long cdf = carry + incl - s;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    cdf += v[i][j];
                    const float fc = __ll2float_rn(cdf);
#pragma unroll
                    for (int k = 0; k < kQ; ++k)
                        below[k] += (kFull || b + j < bins) &&
                                    fc < target[k];
                }
                carry += __shfl_sync(0xFFFFFFFFu, incl, 31);
            }
        }
    }
#pragma unroll
    for (int k = 0; k < kQ; ++k)
        idx[k] = min(max(__reduce_add_sync(0xFFFFFFFFu, below[k]), 0),
                     bins - 1);
    return total;
}

// quant_scan_t with whole rounds where the histogram allows them
template <int kQ>
__device__ __forceinline__ long long quant_scan(const int32_t *h, int bins,
                                                int lane,
                                                const float (&q)[kQ],
                                                int (&idx)[kQ]) {
    const bool vec = (bins & 3) == 0 && ((uintptr_t)h & 15) == 0;
    if (vec && (bins & 127) == 0)
        return quant_scan_t<kQ, true>(h, bins, lane, true, q, idx);
    return quant_scan_t<kQ, false>(h, bins, lane, vec, q, idx);
}

// the geometric midpoint of bin idx (sketches.py quantile_estimate);
// bin 0 (values below min_value) is 0
__device__ __forceinline__ float quant_mid(const HsFinalize &f, int idx) {
    const float log_lo = __fmul_rn(__fsub_rn(__int2float_rn(idx), 1.0f),
                                   f.q_gamma);
    const float mid = __fmul_rn(f.q_min,
                                expf(__fadd_rn(log_lo, f.q_half_gamma)));
    return idx == 0 ? 0.0f : mid;
}

// q-quantile of an int32 histogram [bins]; the result on every lane,
// and the histogram's total in *total_out where that is given
__device__ inline float quant_warp(const HsFinalize &f,
                                   const HsCloseAgg &g, int64_t cell,
                                   int lane, long long *total_out = nullptr) {
    const int bins = g.plane_width;
    const float q[1] = {g.q};
    int idx[1];
    const long long total = quant_scan<1>(
        (const int32_t *)g.plane + cell * bins, bins, lane, q, idx);
    if (total_out != nullptr) *total_out = total;
    return quant_mid(f, idx[0]);
}

// aggregate g's rows of one cell: its row r at out[r * stride]
__device__ inline void finalize_agg(const HsFinalize &f, int g,
                                    int64_t cell, int cnt, int32_t *out,
                                    int64_t stride, int lane) {
    const HsCloseAgg &ag = f.a[g];
    if (ag.kind == HS_AGG_TOPK || ag.kind == HS_AGG_TOPK_DISTINCT) {
        const int32_t *vals = (const int32_t *)ag.plane + cell * ag.width;
        for (int j = lane; j < ag.width; j += 32)
            out[(int64_t)j * stride] = vals[j];
        return;
    }
    float v;
    if (ag.kind == HS_AGG_HLL)
        v = hll_warp(f, ag, cell, lane);
    else if (ag.kind == HS_AGG_QUANT)
        v = quant_warp(f, ag, cell, lane);
    else
        v = finalize_scalar(ag, cell, cnt);
    if (lane == 0) out[0] = __float_as_int(v);
}

// every aggregate's rows of one cell: row r of this column at
// out[r * stride]
__device__ inline void finalize_cell(const HsFinalize &f, int64_t cell,
                                     int cnt, int32_t *out, int64_t stride,
                                     int lane) {
    int row = 0;
    for (int g = 0; g < f.n_aggs; ++g) {
        finalize_agg(f, g, cell, cnt, out + (int64_t)row * stride, stride,
                     lane);
        row += f.a[g].width;
    }
}

}  // namespace hs
