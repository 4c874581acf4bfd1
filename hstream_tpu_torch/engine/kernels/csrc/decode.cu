// Wire decode: the bit-packed uint32 wire buffer -> device columns.
//
// Replaces the decode half of the fused step the JAX package jits
// (hstream_tpu/engine/transport.py:143-216 decode_batch / _unpack_stream /
// _bp_decode, traced into lattice.py:388-408 build_step_encoded).
//
// Bound on the H100: bytes. Every value is a shift, a mask and at most
// two word loads; the wire (~2.7-5 B/event) is read once and each
// column written once, so the kernel is a streaming copy with a few
// integer ops per value, far below the card's operation rate.
//
// Design: one thread per value, 1024 values per block, every stream of
// the combo decoded by the same thread (the stream table rides in the
// kernel parameters). Value i of a `bits`-wide stream starts at bit
// i*bits and may straddle two words; the encoder's +1 pad word makes the
// second load safe, and its 32-lane block layout gives the same
// addresses. The one delta stream (bpd: nondecreasing timestamps) needs
// a batch-wide inclusive prefix sum base + cumsum(u): this kernel scans
// within each block and stores the block totals, and a second kernel
// adds each block's prefix (the sum of all earlier block totals, which
// every block reduces for itself). Sums wrap mod 2^32 like the
// reference's int32 cumsum. `dec` decodes as
// float(base + u) * float32(1/scale) with round-to-nearest intrinsics and
// no contraction, bit-identical to the host encoder's round-trip check.

#include <cuda_runtime.h>

#include "hs_kernels.h"

namespace {

constexpr int kBlock = 1024;

__device__ __forceinline__ uint32_t unpack(const uint32_t *w, int64_t i,
                                           int bits) {
    if (bits == 0) return 0u;
    int64_t pos = i * bits;
    int64_t w0 = pos >> 5;
    int sh = (int)(pos & 31);
    uint32_t lo = w[w0] >> sh;
    uint32_t hi = sh ? (w[w0 + 1] << (32 - sh)) : 0u;
    uint32_t mask = bits == 32 ? 0xFFFFFFFFu : ((1u << bits) - 1u);
    return (lo | hi) & mask;
}

// inclusive scan of one value per thread over a 1024-thread block
__device__ __forceinline__ uint32_t block_scan(uint32_t v, uint32_t *warp_tot) {
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int d = 1; d < 32; d <<= 1) {
        uint32_t o = __shfl_up_sync(0xFFFFFFFFu, v, d);
        if (lane >= d) v += o;
    }
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    if (warp == 0) {
        uint32_t t = warp_tot[lane];
        for (int d = 1; d < 32; d <<= 1) {
            uint32_t o = __shfl_up_sync(0xFFFFFFFFu, t, d);
            if (lane >= d) t += o;
        }
        warp_tot[lane] = t;
    }
    __syncthreads();
    return warp ? v + warp_tot[warp - 1] : v;
}

__global__ void __launch_bounds__(kBlock)
decode_kernel(const HsDecodeArgs a) {
    __shared__ uint32_t warp_tot[32];
    int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x;
    bool in = i < a.cap;
    for (int s = 0; s < a.n_streams; ++s) {
        const HsStream st = a.s[s];
        const uint32_t *w = a.words + st.word_off;
        if (s == a.delta_stream) {
            uint32_t u = in ? unpack(w, i, st.bits) : 0u;
            uint32_t incl = block_scan(u, warp_tot);
            if (in) ((uint32_t *)st.out)[i] = incl;
            if (threadIdx.x == kBlock - 1) a.block_sums[blockIdx.x] = incl;
            continue;
        }
        if (!in || st.out == nullptr) continue;
        switch (st.enc) {
        case HS_ENC_RAWF:
        case HS_ENC_RAWI:
            ((uint32_t *)st.out)[i] = w[i];
            break;
        case HS_ENC_BOOL:
            ((uint8_t *)st.out)[i] = unpack(w, i, 1) != 0u;
            break;
        case HS_ENC_DEC: {
            int32_t v = (int32_t)((uint32_t)st.base + unpack(w, i, st.bits));
            ((float *)st.out)[i] = __fmul_rn(__int2float_rn(v), st.inv_scale);
            break;
        }
        default:  // HS_ENC_BP
            ((uint32_t *)st.out)[i] = (uint32_t)st.base + unpack(w, i, st.bits);
        }
    }
    if (in) {
        bool v = i < a.n;
        if (a.valid_stream >= 0) {
            const HsStream st = a.s[a.valid_stream];
            v = v && unpack(a.words + st.word_off, i, 1) != 0u;
        }
        a.valid_out[i] = v;
    }
}

// adds base + (sum of all earlier blocks' totals) to each block's scan
__global__ void __launch_bounds__(kBlock)
delta_fixup_kernel(uint32_t *out, const uint32_t *block_sums, int32_t cap,
                   uint32_t base) {
    __shared__ uint32_t warp_tot[32];
    uint32_t part = 0;
    for (unsigned j = threadIdx.x; j < blockIdx.x; j += kBlock)
        part += block_sums[j];
    for (int d = 16; d > 0; d >>= 1)
        part += __shfl_down_sync(0xFFFFFFFFu, part, d);
    if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = part;
    __syncthreads();
    if (threadIdx.x < 32) {
        uint32_t t = warp_tot[threadIdx.x];
        for (int d = 16; d > 0; d >>= 1)
            t += __shfl_down_sync(0xFFFFFFFFu, t, d);
        if (threadIdx.x == 0) warp_tot[0] = t;
    }
    __syncthreads();
    int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x;
    if (i < cap) out[i] += base + warp_tot[0];
}

}  // namespace

extern "C" int hs_decode(const HsDecodeArgs *args, void *stream) {
    cudaStream_t s = (cudaStream_t)stream;
    unsigned blocks = (unsigned)((args->cap + kBlock - 1) / kBlock);
    decode_kernel<<<blocks, kBlock, 0, s>>>(*args);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || args->delta_stream < 0) return (int)err;
    const HsStream &d = args->s[args->delta_stream];
    delta_fixup_kernel<<<blocks, kBlock, 0, s>>>(
        (uint32_t *)d.out, args->block_sums, args->cap, (uint32_t)d.base);
    return (int)cudaGetLastError();
}

extern "C" const char *hs_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
