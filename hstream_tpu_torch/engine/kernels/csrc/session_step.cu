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
// The key shards of a mesh (hstream_tpu/parallel/lattice.py:669-688
// ShardedSessionLattice._build_step; hs_session_step_group): each shard
// folds only the records it owns, as the reference's cleared valid bit
// makes it. What bounded the first sharded design (1.029 ms for 4 shards
// of 2^15 slots and 2^20 records): a launch sequence a shard, each keying,
// sorting and scanning the whole batch with the records of the other
// shards as sentinels, and the scatter visiting them all once a shard. Now
// one sequence a card covers a table of the shards whose arenas lie there
// (session_chain.cuh core_group): each record is keyed once, sorted once
// if a shard of the table owns it and dropped before the sort otherwise,
// and group_record_scatter folds it into its own shard's arena (the shard
// from its code, the slot local to the shard). A single arena keeps
// hs_session_step, whose kernels take the templates' false branches.
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

// record j's input to plane p (a plane of a key shard's arena: p's
// kind, width, null_bit, vtype and values are the query's) folded into
// slot d
template <class P, class A>
__device__ __forceinline__ void fold_record(const A &a, const P &p,
                                            void *out, int32_t *out_n,
                                            int j, int flags, int64_t d) {
    if (p.kind == HS_AGG_COUNT_ALL) {
        atomicAdd((int32_t *)out + d, 1);
        return;
    }
    if (p.null_bit > 0 && ((flags >> p.null_bit) & 1)) return;
    HsScatterAgg in{};
    in.vtype = p.vtype;
    in.values = p.values;
    float v;
    uint32_t bits;
    if (!hs::agg_input(in, j, v, bits)) return;
    switch (p.kind) {
    case HS_AGG_COUNT:
        atomicAdd((int32_t *)out + d, 1);
        break;
    case HS_AGG_SUM:
        atomicAdd((float *)out + d, v);
        break;
    case HS_AGG_AVG:
        atomicAdd((float *)out + d, v);
        atomicAdd(out_n + d, 1);
        break;
    case HS_AGG_MIN:
        hs::atomic_min_float((float *)out + d, v);
        break;
    case HS_AGG_MAX:
        hs::atomic_max_float((float *)out + d, v);
        break;
    case HS_AGG_HLL:
        hs::hll_update((int8_t *)out + d * p.width,
                       __float_as_uint(v == 0.0f ? 0.0f : v), a.hll_p);
        break;
    case HS_AGG_QUANT: {
        const int b = hs::quantile_bin(v, a.q_min, a.q_gamma, p.width);
        atomicAdd((int32_t *)out + d * p.width + b, 1);
        break;
    }
    default:
        break;
    }
}

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
        fold_record(a, p, p.out, p.out_n, j, flags, d);
    }
}

// a table's records, each into the arena of the shard that owns it
__global__ void __launch_bounds__(kBlock)
group_record_scatter(const __grid_constant__ HsSessGroupArgs a,
                     const int32_t *dest) {
    const int j = blockIdx.x * kBlock + threadIdx.x;
    if (j >= a.nb) return;
    const int64_t d = dest[(int64_t)a.n_group * a.cap + j];
    if (d >= a.cap) return;
    const int code = a.b_code[j];
    const int g = hs::sess::group_of(a, code);
    const HsSessShard &h = a.sh[g];
    const int ts = a.b_t0[j];
    const int flags = a.b_flags[j];
    atomicMin(h.out_code + d, code);
    atomicMin(h.out_t0 + d, ts);
    atomicMax(h.out_t1 + d, ts);
    const HsSessPlanePtrs *pp = a.pp + g * a.n_planes;
    for (int q = 0; q < a.n_planes; ++q)
        fold_record(a, a.d[q], pp[q].out, pp[q].out_n, j, flags, d);
}

}  // namespace

extern "C" int64_t hs_session_scratch_bytes(int32_t cap, int32_t nb) {
    return hs::sess::layout(cap, nb, 0, nullptr, nullptr);
}

extern "C" int64_t hs_session_group_scratch_bytes(int32_t n_group,
                                                  int32_t cap, int32_t nb) {
    return hs::sess::layout((int64_t)n_group * cap, nb, n_group, nullptr,
                            nullptr);
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

extern "C" int hs_session_step_group(const HsSessGroupArgs *args,
                                     void *stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (args->mode != HS_SESS_RECORD ||
        (args->nb > 0 && args->b_flags == nullptr))
        return (int)cudaErrorInvalidValue;
    hs::sess::Scratch s;
    cudaError_t err = hs::sess::core_group(*args, s, st);
    if (err != cudaSuccess) return (int)err;
    if (args->nb > 0)
        group_record_scatter<<<(args->nb + kBlock - 1) / kBlock, kBlock, 0,
                               st>>>(*args, s.dest);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)hs::sess::group_fixup(*args, st);
}
