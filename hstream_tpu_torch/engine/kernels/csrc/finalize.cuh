// Finalizing one (key, slot) cell of the lattice into its output rows:
// shared by the fused close (close.cu) and the changelog extract
// (touched.cu). One warp finalizes one cell; every lane of the warp
// calls finalize_cell, since the sketch estimates are warp reductions.
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

__device__ __forceinline__ float finalize_scalar(const HsCloseAgg &g,
                                                 int64_t cell, int cnt) {
    switch (g.kind) {
    case HS_AGG_COUNT_ALL:
        return __int2float_rn(cnt);
    case HS_AGG_COUNT:
        return __int2float_rn(((const int32_t *)g.plane)[cell]);
    case HS_AGG_AVG: {
        float n = __int2float_rn(g.plane_n[cell]);
        return ftz(__fdiv_rn(((const float *)g.plane)[cell], fmaxf(n, 1.0f)));
    }
    case HS_AGG_MIN:
    case HS_AGG_MAX:
        return cnt > 0 ? ((const float *)g.plane)[cell] : 0.0f;
    default:  // HS_AGG_SUM
        return ((const float *)g.plane)[cell];
    }
}

// HyperLogLog estimate of int8 registers [m]; the result on every lane
__device__ inline float hll_warp(const HsFinalize &f, const HsCloseAgg &g,
                                 int64_t cell, int lane) {
    const int m = 1 << f.hll_p;
    const int words = m >> 2;
    const int big_r = 33 - f.hll_p;
    const uint32_t *regs = (const uint32_t *)g.plane + cell * words;
    unsigned long long sum = 0;
    int zeros = 0;
    for (int w = lane; w < words; w += 32) {
        uint32_t x = regs[w];
        for (int b = 0; b < 4; ++b) {
            int r = (int)(int8_t)((x >> (8 * b)) & 0xFFu);
            sum += 1ull << (big_r - r);
            zeros += r == 0;
        }
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

// q-quantile of an int32 histogram [bins]; the result on every lane,
// and the histogram's total in *total_out where that is given
__device__ inline float quant_warp(const HsFinalize &f,
                                   const HsCloseAgg &g, int64_t cell,
                                   int lane, long long *total_out = nullptr) {
    const int bins = g.plane_width;
    const int32_t *h = (const int32_t *)g.plane + cell * bins;
    const int per = (bins + 31) / 32;
    const int b0 = min(lane * per, bins), b1 = min(b0 + per, bins);
    long long own = 0;
    // 16 loads a round in flight together: a lane's bins are a strided
    // run, so one at a time each waits out a memory round trip; up to
    // 16 bins a lane (512 bins) the second pass reads them again from
    // registers
    int32_t v[16];
    for (int c = b0; c < b1; c += 16) {
#pragma unroll
        for (int k = 0; k < 16; ++k) v[k] = c + k < b1 ? h[c + k] : 0;
#pragma unroll
        for (int k = 0; k < 16; ++k) own += v[k];
    }
    long long incl = own;
    for (int d = 1; d < 32; d <<= 1) {
        long long t = __shfl_up_sync(0xFFFFFFFFu, incl, d);
        if (lane >= d) incl += t;
    }
    const long long total = __shfl_sync(0xFFFFFFFFu, incl, 31);
    if (total_out != nullptr) *total_out = total;
    const float target = __fmul_rn(g.q, fmaxf(__ll2float_rn(total), 1.0f));
    long long cdf = incl - own;
    int below = 0;
    if (per <= 16) {
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            cdf += v[k];  // 0 past b1
            below += b0 + k < b1 && __ll2float_rn(cdf) < target;
        }
    } else {
        for (int b = b0; b < b1; ++b) {
            cdf += h[b];
            below += __ll2float_rn(cdf) < target;
        }
    }
    for (int d = 16; d > 0; d >>= 1)
        below += __shfl_xor_sync(0xFFFFFFFFu, below, d);
    const int idx = min(max(below, 0), bins - 1);
    const float log_lo = __fmul_rn(__fsub_rn(__int2float_rn(idx), 1.0f),
                                   f.q_gamma);
    const float mid = __fmul_rn(f.q_min,
                                expf(__fadd_rn(log_lo, f.q_half_gamma)));
    return idx == 0 ? 0.0f : mid;
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
