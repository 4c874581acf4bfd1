// Session step, record mode: fold one packed micro-batch of raw records
// into the open-session arena, writing the fresh arena (the other of two
// preallocated arenas; the caller swaps them).
//
// Replaces hstream_tpu/engine/lattice.py:1327-1429 session_step_kernel
// (with :1298-1324 _session_chain_slots). The packed batch is the
// reference's int32 transport (lattice.py:305-371): row 0 codes, row 1
// relative ts, row 2 flags (bit 0 valid, bit 1+j the NULL mask of the
// j-th aggregate with an input), rows 3+ the columns (f32 bits, i32, bool
// as 0/1). A computed input arrives as its own column, evaluated first
// by the expression kernel (expr.cu).
//
// What bounded it (BASELINE config 4, 0.685 ms a call): the chain core's
// seven-pass, 22-launch radix sort (0.281 ms, slower than torch.sort of
// the same keys) and the fresh arena written twice, by the init and by
// the atomic fold of every old row (0.279 ms). The core now sorts
// narrowed keys in one sweep per digit that varies and writes the fresh
// arena once (session_chain.cuh); the record scatter below is unchanged.
//
// Bound on the H100 now: bytes, the fresh arena written once and the live
// old rows read once; then one thread per record: per aggregate one
// input read and one atomic (a CAS loop for an HLL register).
//
// Design: the chain core assigns every arena slot and record its slot in
// the fresh arena; this file adds the record scatter, with the
// reference's input rules (lattice.py:1381-1387): an input counts only
// when the record is valid, its NULL bit is clear and, for a float32
// input, it is finite; its value is taken as float32 (an int32 rounds to
// nearest), and the HLL hash reads those float32 bits (-0.0 as 0.0), as
// the reference's `v.astype(float32)` does. MIN/MAX use the sign-split
// integer atomics, HLL the int8 CAS, the quantile bin the window scatter's
// formula (record.cuh). SUM/AVG add with float atomics, so their last
// bits depend on the order the atomics land in.

#include <cuda_runtime.h>

#include "hs_kernels.h"
#include "record.cuh"
#include "session_chain.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
record_scatter(const __grid_constant__ HsSessionArgs a, const int32_t *dest) {
    const int j = blockIdx.x * kBlock + threadIdx.x;
    if (j >= a.nb) return;
    const int64_t d = dest[a.cap + j];
    if (d >= a.cap) return;
    const int ts = a.b_t0[j];
    const int flags = a.b_flags[j];
    atomicMin(a.out_code + d, a.b_code[j]);
    atomicMin(a.out_t0 + d, ts);
    atomicMax(a.out_t1 + d, ts);
    for (int q = 0; q < a.n_planes; ++q) {
        const HsSessPlane &p = a.p[q];
        if (p.kind == HS_AGG_COUNT_ALL) {
            atomicAdd((int32_t *)p.out + d, 1);
            continue;
        }
        if (p.null_bit > 0 && ((flags >> p.null_bit) & 1)) continue;
        HsScatterAgg in{};
        in.vtype = p.vtype;
        in.values = p.values;
        float v;
        uint32_t bits;
        if (!hs::agg_input(in, j, v, bits)) continue;
        switch (p.kind) {
        case HS_AGG_COUNT:
            atomicAdd((int32_t *)p.out + d, 1);
            break;
        case HS_AGG_SUM:
            atomicAdd((float *)p.out + d, v);
            break;
        case HS_AGG_AVG:
            atomicAdd((float *)p.out + d, v);
            atomicAdd(p.out_n + d, 1);
            break;
        case HS_AGG_MIN:
            hs::atomic_min_float((float *)p.out + d, v);
            break;
        case HS_AGG_MAX:
            hs::atomic_max_float((float *)p.out + d, v);
            break;
        case HS_AGG_HLL:
            hs::hll_update((int8_t *)p.out + d * p.width,
                           __float_as_uint(v == 0.0f ? 0.0f : v), a.hll_p);
            break;
        case HS_AGG_QUANT: {
            const int b = hs::quantile_bin(v, a.q_min, a.q_gamma, p.width);
            atomicAdd((int32_t *)p.out + d * p.width + b, 1);
            break;
        }
        default:
            break;
        }
    }
}

}  // namespace

extern "C" int64_t hs_session_scratch_bytes(int32_t cap, int32_t nb) {
    return hs::sess::layout(cap, nb, nullptr, nullptr);
}

extern "C" int hs_session_step(const HsSessionArgs *args, void *stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (args->mode != HS_SESS_RECORD ||
        (args->nb > 0 && args->b_flags == nullptr))
        return (int)cudaErrorInvalidValue;
    hs::sess::Scratch s;
    cudaError_t err = hs::sess::core(*args, s, st);
    if (err != cudaSuccess) return (int)err;
    if (args->nb > 0)
        record_scatter<<<(args->nb + kBlock - 1) / kBlock, kBlock, 0, st>>>(
            *args, s.dest);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)hs::sess::fixup(*args, st);
}
