// Per-(record, window) addressing and per-aggregate input reads shared by
// the scatter-aggregate (scatter.cu) and top-k (topk.cu) kernels, with
// the semantics of hstream_tpu/engine/lattice.py:138-255 build_step_fn:
//  * floor division and modulo (jnp.mod, //), not C's truncation, so a
//    record older than the epoch gets a negative window start and is
//    dropped by `start >= 0` instead of landing in window 0;
//  * a window is late when start + size + grace <= watermark (int32
//    wrap-around arithmetic, as in the reference);
//  * keys outside [0, K) are dropped;
//  * an input counts for its aggregate only when it is not SQL NULL and,
//    for a float32 input, finite (lattice.py:213-222).
// Also the update primitives the scatter (scatter.cu) and the session
// fold (session_chain.cuh, session_step.cu) share: there is no float
// atomic min/max, so MIN/MAX use the sign-split integer trick
// (non-negative floats order like signed ints, negative ones in reverse
// like unsigned ints), which keeps them exact; there is no int8 atomic,
// so an HLL register is raised with a CAS on its aligned 32-bit word;
// the HLL hash (sketches.py:35-86) and the quantile bin
// (sketches.py:130-139).
//
// Subnormals: XLA's CPU backend (and a TPU) flushes the float32 operands
// and results of arithmetic, comparisons and min/max to a zero of their
// sign. The sources are built with --ftz=true, so the card's float
// instructions flush them too; where a float reaches an integer path (the
// sign-split MIN/MAX, the HLL hash's bits, a plain store of a fold) the
// kernels flush it explicitly with ftz / ftz_bits.
#pragma once

#include <cuda_runtime.h>

#include "hs_kernels.h"

namespace hs {

// a float32 subnormal as a zero of its sign, by its bits (independent of
// the compiler's flush mode)
__device__ __forceinline__ uint32_t ftz_bits(uint32_t u) {
    return (u & 0x7F800000u) == 0u ? (u & 0x80000000u) : u;
}

__device__ __forceinline__ float ftz(float x) {
    return __uint_as_float(ftz_bits(__float_as_uint(x)));
}

__device__ __forceinline__ int floor_mod(int a, int b) {
    int r = a % b;
    return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

__device__ __forceinline__ int floor_div(int a, int b) {
    return (a - floor_mod(a, b)) / b;
}

// floor division of a by d > 0 with the host's multiplier (HsDivisor,
// lattice.divisor): for 0 <= x < 2^31, x / d == (x * m) >> shift with
// m = ceil(2^shift / d) and shift = 31 + ceil(log2 d) (Granlund and
// Montgomery 1994, Theorem 4.2; m < 2^32, the product < 2^63); a
// negative a divides as floor(a / d) == ~(~a / d), ~a = -a - 1 >= 0.
// Used by the top-k fold (window_slot) in place of floor_div/floor_mod.
__device__ __forceinline__ int fdiv(int a, const HsDivisor &f) {
    const uint32_t x = (uint32_t)(a ^ (a >> 31));
    const uint32_t q = (uint32_t)(((uint64_t)x * f.m) >> f.shift);
    return a < 0 ? ~(int)q : (int)q;
}

// window j of a record at t: its slot; false when the window is late or
// before the epoch (record_window's semantics, with fdiv)
__device__ __forceinline__ bool window_slot(const HsScatterArgs &a, int t,
                                            int j, int &slot) {
    slot = 0;
    if (a.advance <= 0) return true;
    // t - floor_mod(t, advance), mod 2^32 as the reference wraps it
    const unsigned latest = (unsigned)fdiv(t, a.adv_div) * (unsigned)a.advance;
    const int start = (int)(latest - (unsigned)j * (unsigned)a.advance);
    const int end = (int)((unsigned)start + (unsigned)a.size_grace);
    if (end <= a.watermark || start < 0) return false;
    const int q = fdiv(start, a.adv_div);  // >= 0
    slot = q - fdiv(q, a.slot_div) * a.n_slots;
    return true;
}

// window j of record i: its start and slot; false when the record is
// invalid or the window is late or before the epoch
__device__ __forceinline__ bool record_window(const HsScatterArgs &a, int i,
                                              int j, int &start, int &slot) {
    start = 0;
    slot = 0;
    bool in_range = true;
    if (a.advance > 0) {
        int t = a.ts[i];
        int latest = (int)((unsigned)t - (unsigned)floor_mod(t, a.advance));
        start = (int)((unsigned)latest - (unsigned)j * (unsigned)a.advance);
        int end = (int)((unsigned)start + (unsigned)a.size_grace);
        in_range = !(end <= a.watermark) && start >= 0;
        if (in_range)
            slot = floor_mod(floor_div(start, a.advance), a.n_slots);
    }
    return a.valid[i] && in_range;
}

// an input from its raw 32 bits (a bool column's byte widened): its
// float32 value (v; flushed with `flush`, as every aggregate but TOPK
// takes it), the 32 bits the HLL hash reads (-0.0 and the subnormals,
// which compare equal to 0.0 in the reference, as 0.0), and whether it
// counts (not SQL NULL and, for a float32 input, finite)
__device__ __forceinline__ bool input_of(int vtype, uint32_t raw, bool null,
                                         float &v, uint32_t &bits,
                                         bool flush = true) {
    if (vtype == HS_T_F32) {
        const uint32_t f = ftz_bits(raw);
        v = __uint_as_float(flush ? f : raw);
        bits = (f & 0x7FFFFFFFu) == 0u ? 0u : raw;
        return !null && isfinite(v);
    }
    if (vtype == HS_T_I32) {
        v = __int2float_rn((int)raw);
        bits = raw;
        return !null;
    }
    bits = raw ? 1u : 0u;
    v = (float)bits;
    return !null;
}

// aggregate ag's input for record i (input_of)
__device__ __forceinline__ bool agg_input(const HsScatterAgg &ag, int i,
                                          float &v, uint32_t &bits,
                                          bool flush = true) {
    const bool null = ag.nulls != nullptr && ag.nulls[i];
    const uint32_t raw = ag.vtype == HS_T_BOOL
                             ? ((const uint8_t *)ag.values)[i]
                             : ((const uint32_t *)ag.values)[i];
    return input_of(ag.vtype, raw, null, v, bits, flush);
}

__device__ __forceinline__ void atomic_min_float(float *addr, float v) {
    if (__float_as_int(v) >= 0)
        atomicMin((int *)addr, __float_as_int(v));
    else
        atomicMax((unsigned int *)addr, __float_as_uint(v));
}

__device__ __forceinline__ void atomic_max_float(float *addr, float v) {
    if (__float_as_int(v) >= 0)
        atomicMax((int *)addr, __float_as_int(v));
    else
        atomicMin((unsigned int *)addr, __float_as_uint(v));
}

// what atomic_min_float / atomic_max_float leave in a word holding `cur`
// (as bits), for a fold that writes its result with a plain store
__device__ __forceinline__ uint32_t min_float_bits(uint32_t cur,
                                                   uint32_t v) {
    return (int)v >= 0 ? (uint32_t)min((int)cur, (int)v) : max(cur, v);
}

__device__ __forceinline__ uint32_t max_float_bits(uint32_t cur,
                                                   uint32_t v) {
    return (int)v >= 0 ? (uint32_t)max((int)cur, (int)v) : min(cur, v);
}

// raise one int8 register to `rank` with a CAS on its aligned word
__device__ __forceinline__ void atomic_max_i8(int8_t *addr, int rank) {
    uintptr_t p = (uintptr_t)addr;
    unsigned int *word = (unsigned int *)(p & ~(uintptr_t)3);
    int shift = (int)(p & 3) * 8;
    unsigned int old = *(volatile unsigned int *)word;
    while (true) {
        int cur = (int)(int8_t)((old >> shift) & 0xFFu);
        if (cur >= rank) return;
        unsigned int nw = (old & ~(0xFFu << shift)) |
                          ((unsigned int)(rank & 0xFF) << shift);
        unsigned int seen = atomicCAS(word, old, nw);
        if (seen == old) return;
        old = seen;
    }
}

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
}

// raise the register the 32-bit value `bits` hashes to in one HLL
// register set [2^p] (sketches.py:62-86 hll_update_indices)
__device__ __forceinline__ void hll_update(int8_t *regs, uint32_t bits,
                                           int p) {
    uint32_t h = mix32(bits);
    uint32_t reg = h >> (32 - p);
    uint32_t rest = h << p;
    int rank = min(__clz((int)rest) + 1, 33 - p);
    atomic_max_i8(regs + reg, rank);
}

// sketches.py:130-139 quantile_bin
__device__ __forceinline__ int quantile_bin(float x, float qmin, float gamma,
                                            int bins) {
    float v = fmaxf(x, 0.0f);
    float safe = fmaxf(v, qmin);
    float b = floorf(__fdiv_rn(logf(__fdiv_rn(safe, qmin)), gamma));
    int bi = min(max((int)b + 1, 1), bins - 1);
    return v < qmin ? 0 : bi;
}

}  // namespace hs
