// Wire decode: the bit-packed uint32 wire buffer -> device columns.
//
// Replaces the decode half of the fused step the JAX package jits
// (hstream_tpu/engine/transport.py:143-216 decode_batch / _unpack_stream /
// _bp_decode, traced into lattice.py:388-408 build_step_encoded).
//
// Bound on the H100: bytes. Every value is a shift, a mask and a word
// load shared with its neighbours; the wire (~2.7-5 B/event) is read
// once and each column written once, so the kernel is a streaming copy
// with a few integer ops per value, far below the card's operation rate.
//
// Design: one launch, one pass. A block takes `tiles` tiles of 1024
// values in a row (decode_plan sizes the grid to the card: one wave). A
// thread decodes four consecutive values of every stream of the combo
// (the stream table stays in the kernel's parameter space: the
// arguments are __grid_constant__), from a 64-bit window over the words
// that hold them, and stores four 4-byte values as one 16-byte store and
// four bools (a bool stream, valid) as one 32-bit word. Value i of a
// `bits`-wide stream starts at bit i*bits; the encoder's +1 pad word
// keeps the second word of a value below `cap` in bounds. The one delta
// stream (bpd: nondecreasing timestamps) needs a batch-wide inclusive
// prefix sum base + cumsum(u). With one, a block's first warps (two or
// four, decode_plan's choice by the other columns' count) take it alone:
// they sum the block's deltas, the first publishes the sum in a status
// word of the block's own and adds its predecessors' sums (a decoupled
// look-back, in block order as CUB's single-pass scan takes it: the grid
// is one wave, and a block waits only on blocks launched before it), and
// they scan and store the block's timestamps, 128 a row, while the other
// warps decode every other stream. Sums
// wrap mod 2^32 like the reference's int32 cumsum. The status words live
// in a buffer the wrapper keeps per device and stream, each tagged with
// the launch's epoch (a count the wrapper raises every launch), so no
// launch reads another's and none has to clear them. `dec` decodes as
// float(base + u) * float32(1/scale) with round-to-nearest intrinsics and
// no contraction, bit-identical to the host encoder's round-trip check.

#include <cuda_runtime.h>

#include "hs_kernels.h"

namespace {

constexpr int kThreads = HS_DECODE_THREADS;
constexpr int kPer = HS_DECODE_PER;      // consecutive values a thread
constexpr int kTile = kThreads * kPer;   // values a tile

// values i .. i+3 (lim of them below cap, 1 <= lim) of a `bits`-wide
// stream, through a 64-bit window refilled a word at a time
__device__ __forceinline__ void unpack4(const uint32_t *w, int64_t i,
                                        int bits, int lim,
                                        uint32_t (&u)[kPer]) {
    if (bits == 0) {
#pragma unroll
        for (int k = 0; k < kPer; ++k) u[k] = 0u;
        return;
    }
    const int64_t pos = i * bits;
    const uint32_t *p = w + (pos >> 5);
    const int sh = (int)(pos & 31);
    uint64_t buf = ((uint64_t)p[0] | ((uint64_t)p[1] << 32)) >> sh;
    int have = 64 - sh, next = 2;
    const uint32_t mask = bits == 32 ? 0xFFFFFFFFu : ((1u << bits) - 1u);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        if (k < lim && have < bits) {  // value k reaches the next word
            buf |= (uint64_t)p[next++] << have;
            have += 32;
        }
        u[k] = k < lim ? (uint32_t)buf & mask : 0u;
        buf >>= bits;
        have -= bits;
    }
}

// four bits of a bool stream (i a multiple of 4) as four 0/1 bytes
__device__ __forceinline__ uint32_t bools4(const uint32_t *w, int64_t i) {
    const uint32_t x = (w[i >> 5] >> (i & 31)) & 0xFu;
    return (x & 1u) | ((x & 2u) << 7) | ((x & 4u) << 14) | ((x & 8u) << 21);
}

// (the loops over a thread's four values are unrolled throughout: an
// array indexed at run time would live in local memory)
__device__ __forceinline__ void store4(uint32_t *out, int64_t i, int lim,
                                       const uint32_t (&v)[kPer]) {
    if (lim >= kPer) {
        *(uint4 *)(out + i) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
        for (int k = 0; k < kPer; ++k)
            if (k < lim) out[i + k] = v[k];
    }
}

__device__ __forceinline__ void store4b(uint8_t *out, int64_t i, int lim,
                                        uint32_t b) {
    if (lim >= kPer) {
        *(uint32_t *)(out + i) = b;
    } else {
#pragma unroll
        for (int k = 0; k < kPer; ++k)
            if (k < lim) out[i + k] = (uint8_t)(b >> (8 * k));
    }
}

// how many of values i .. i+3 lie below end
__device__ __forceinline__ int lim_of(int64_t end, int64_t i) {
    const int64_t r = end - i;
    return r >= kPer ? kPer : r > 0 ? (int)r : 0;
}

// every stream but the delta stream, and valid, of values i .. i+lim-1
__device__ __forceinline__ void decode4(const HsDecodeArgs &a, int64_t i,
                                        int lim) {
    for (int s = 0; s < a.n_streams; ++s) {
        const HsStream &st = a.s[s];
        if (s == a.delta_stream || st.out == nullptr) continue;
        const uint32_t *w = a.words + st.word_off;
        uint32_t v[kPer];
        switch (st.enc) {
        case HS_ENC_RAWF:
        case HS_ENC_RAWI:
#pragma unroll
            for (int k = 0; k < kPer; ++k) v[k] = k < lim ? w[i + k] : 0u;
            store4((uint32_t *)st.out, i, lim, v);
            break;
        case HS_ENC_BOOL:
            store4b((uint8_t *)st.out, i, lim, bools4(w, i));
            break;
        case HS_ENC_DEC:
            unpack4(w, i, st.bits, lim, v);
#pragma unroll
            for (int k = 0; k < kPer; ++k)
                v[k] = __float_as_uint(__fmul_rn(
                    __int2float_rn((int32_t)((uint32_t)st.base + v[k])),
                    st.inv_scale));
            store4((uint32_t *)st.out, i, lim, v);
            break;
        default:  // HS_ENC_BP
            unpack4(w, i, st.bits, lim, v);
#pragma unroll
            for (int k = 0; k < kPer; ++k) v[k] += (uint32_t)st.base;
            store4((uint32_t *)st.out, i, lim, v);
        }
    }
    // valid: row < n and its __valid bit
    uint32_t b = 0u;
#pragma unroll
    for (int k = 0; k < kPer; ++k)
        b |= (uint32_t)(i + k < a.n) << (8 * k);
    if (a.valid_stream >= 0)
        b &= bools4(a.words + a.s[a.valid_stream].word_off, i);
    store4b(a.valid_out, i, lim, b);
}

// the sum mod 2^32 of blocks [0, tile)'s published delta sums, the 32
// lanes of one warp calling: a status word holds (epoch << 32) | sum and
// counts only with this launch's epoch. The loads go 32 blocks a lane at
// a time, all in flight, each with a bit in the mask of those still to
// wait on.
__device__ __forceinline__ uint32_t look_back(const uint64_t *status,
                                              int tile, uint32_t epoch) {
    const int lane = threadIdx.x & 31;
    uint32_t v = 0u;
    for (int c = lane; c < tile; c += 32 * 32) {
        const int c1 = min(tile, c + 32 * 32);
        unsigned pending = 0u;
        for (int p = c, r = 0; p < c1; p += 32, ++r) {
            const unsigned long long st =
                *(const volatile unsigned long long *)&status[p];
            if ((uint32_t)(st >> 32) == epoch) v += (uint32_t)st;
            else pending |= 1u << r;
        }
        for (int p = c, r = 0; pending != 0u; p += 32, ++r) {
            if (!((pending >> r) & 1u)) continue;
            unsigned long long st;
            do {
                st = *(const volatile unsigned long long *)&status[p];
            } while ((uint32_t)(st >> 32) != epoch);
            v += (uint32_t)st;
            pending &= ~(1u << r);
        }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
    return v;
}

// the delta stream of the block's values [first, end), by its first
// a.delta_warps warps, each a run of rows of 32 groups of four values: the
// block's sum published, its predecessors' added (look_back, by the
// first warp), then each row scanned across its warp and stored as 32
// consecutive 16-byte stores. Both passes take kBatch rows at a time,
// their loads issued together before any is used; the delta warps meet
// at a named barrier of their own, the other warps never wait on them.
constexpr int kBatch = 4;

__device__ __forceinline__ void delta_rows(const uint32_t *w, int bits,
                                           int64_t row, int64_t end,
                                           uint32_t (&u)[kBatch][kPer]) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
        const int64_t i = row + 4 * (32 * b + lane);
        const int lim = lim_of(end, i);
        if (lim > 0) {
            unpack4(w, i, bits, lim, u[b]);
        } else {
#pragma unroll
            for (int k = 0; k < kPer; ++k) u[b][k] = 0u;
        }
    }
}

__device__ __forceinline__ void delta_warps(const HsDecodeArgs &a,
                                            int64_t first, int64_t end) {
    __shared__ uint32_t s_part[kThreads / 32];
    __shared__ uint32_t s_before;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const HsStream &d = a.s[a.delta_stream];
    const uint32_t *w = a.words + d.word_off;
    // this warp's rows of 128 values
    const int64_t rows = (end - first + 127) / 128;
    const int64_t per = (rows + a.delta_warps - 1) / a.delta_warps;
    const int64_t lo = first + 128 * per * warp;
    const int64_t hi = lo + 128 * per < end ? lo + 128 * per : end;
    uint32_t part = 0u;
    if (d.bits == 1) {  // one-bit deltas: a population count a word
        const int n = (int)((hi - lo + 31) >> 5);
        for (int j = lane; j < n; j += 32) {
            uint32_t x = w[(lo >> 5) + j];
            const int64_t rem = hi - (lo + 32 * (int64_t)j);
            if (rem < 32) x &= (1u << rem) - 1u;
            part += __popc(x);
        }
    } else {
        for (int64_t row = lo; row < hi; row += 128 * kBatch) {
            uint32_t u[kBatch][kPer];
            delta_rows(w, d.bits, row, hi, u);
#pragma unroll
            for (int b = 0; b < kBatch; ++b)
                part += u[b][0] + u[b][1] + u[b][2] + u[b][3];
        }
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
        part += __shfl_xor_sync(0xFFFFFFFFu, part, s);
    if (lane == 0) s_part[warp] = part;
    asm volatile("bar.sync 1, %0;" ::"r"(32 * a.delta_warps));
    uint32_t below = 0u;  // the earlier delta warps' sums
    if (warp == 0) {
        uint32_t total = 0u;
        for (int v = 0; v < a.delta_warps; ++v) total += s_part[v];
        if (lane == 0)
            *(volatile unsigned long long *)&a.status[blockIdx.x] =
                (unsigned long long)a.epoch << 32 | total;
        const uint32_t before = look_back(a.status, blockIdx.x, a.epoch);
        if (lane == 0) s_before = before;
    }
    for (int v = 0; v < warp; ++v) below += s_part[v];
    asm volatile("bar.sync 1, %0;" ::"r"(32 * a.delta_warps));
    uint32_t carry = (uint32_t)d.base + s_before + below;
    for (int64_t row = lo; row < hi; row += 128 * kBatch) {
        uint32_t u[kBatch][kPer];
        delta_rows(w, d.bits, row, hi, u);
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
            const int64_t i = row + 4 * (32 * b + lane);
            u[b][1] += u[b][0];
            u[b][2] += u[b][1];
            u[b][3] += u[b][2];
            uint32_t x = u[b][3];  // the row's inclusive scan of groups
#pragma unroll
            for (int s = 1; s < 32; s <<= 1) {
                const uint32_t o = __shfl_up_sync(0xFFFFFFFFu, x, s);
                if (lane >= s) x += o;
            }
            const uint32_t ahead = carry + x - u[b][3];
#pragma unroll
            for (int k = 0; k < kPer; ++k) u[b][k] += ahead;
            const int lim = lim_of(hi, i);
            if (lim > 0) store4((uint32_t *)d.out, i, lim, u[b]);
            carry += __shfl_sync(0xFFFFFFFFu, x, 31);
        }
    }
}

__global__ void __launch_bounds__(kThreads, 4)
decode_kernel(const __grid_constant__ HsDecodeArgs a) {
    const int64_t first = (int64_t)blockIdx.x * a.tiles * kTile;
    const int64_t last = first + (int64_t)a.tiles * kTile;
    const int64_t end = last < a.cap ? last : (int64_t)a.cap;
    // with a delta stream the first warps take it and the other warps
    // every other stream; without one, every warp decodes
    int lead = 0;
    if (a.delta_stream >= 0) {
        if (threadIdx.x < 32 * a.delta_warps) {
            delta_warps(a, first, end);
            return;
        }
        lead = 32 * a.delta_warps;
    }
    const int64_t step = (int64_t)(kThreads - lead) * kPer;
    for (int64_t i = first + (int64_t)(threadIdx.x - lead) * kPer; i < end;
         i += step)
        decode4(a, i, lim_of(end, i));
}

}  // namespace

extern "C" int hs_decode(const HsDecodeArgs *args, void *stream) {
    const HsDecodeArgs &a = *args;
    if (a.cap == 0) return 0;
    const int64_t tiles = ((int64_t)a.cap + kTile - 1) / kTile;
    if (a.tiles < 1 || (int64_t)a.blocks * a.tiles < tiles ||
        (int64_t)(a.blocks - 1) * a.tiles >= tiles ||
        a.n_streams > HS_MAX_STREAMS ||
        (a.delta_stream >= 0 &&
         (a.status == nullptr || a.epoch == 0u || a.delta_warps < 1 ||
          a.delta_warps >= kThreads / 32)))
        return (int)cudaErrorInvalidValue;
    decode_kernel<<<a.blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

extern "C" const char *hs_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
