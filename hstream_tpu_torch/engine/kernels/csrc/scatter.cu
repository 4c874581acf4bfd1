// Scatter-aggregate: fold one decoded micro-batch into the window-state
// lattice, in place.
//
// Replaces the scatter half of the fused step the JAX package jits
// (hstream_tpu/engine/lattice.py:138-255 build_step_fn, with
// sketches.py:35-86 hash_u32 / clz32 / hll_update_indices and
// sketches.py:130-139 quantile_bin), for COUNT(*), COUNT(col), SUM, AVG,
// MIN, MAX, APPROX_COUNT_DISTINCT and APPROX_QUANTILE. TOPK and
// TOPK_DISTINCT fold in their own kernel (topk.cu).
//
// Bound on the H100: bytes of the decoded columns (13 B/record for the
// headline query) plus atomics. The state (3 MiB of HLL registers and
// 12 KiB planes at K=1024, W=3) stays in the 50 MB L2, so the atomics are
// L2 atomics; the few-tens of integer operations per record for the hash
// are far below the card's operation rate.
//
// Design: one thread per (record, window), with the reference's window,
// late, key-range and input-validity semantics and the update
// primitives below (record.cuh).
// APPROX_QUANTILE bins a value as the reference does, one float32
// operation at a time (max(v, 0), max(., min), / min, logf, / gamma,
// floor, +1, clip; values below min_value go to bin 0) and adds 1 to its
// int32 bin; logf is the same libdevice function PyTorch's CUDA log
// calls, so the plain version bins identically on the card.
// There is no float atomic min/max: MIN/MAX use the sign-split integer
// trick (non-negative floats order like signed ints, negative ones in
// reverse like unsigned ints), which keeps them exact. There is no int8
// atomic: HLL registers stay int8 [K, W, m] (so state carries across
// unchanged) and a CAS on the aligned 32-bit word raises only the target
// byte. slot_start takes an atomicMax from every record into W addresses,
// the contention hot spot: each block first reduces into shared memory,
// then issues one global atomic per slot (W <= 1024; wider lattices use
// global atomics directly). SUM/AVG use float atomicAdd, so their last
// bits depend on the order the atomics land in.

#include <cuda_runtime.h>

#include "hs_kernels.h"
#include "record.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kSmemSlots = 1024;

__global__ void __launch_bounds__(kBlock)
scatter_kernel(const __grid_constant__ HsScatterArgs a, int use_smem) {
    extern __shared__ int s_start[];
    if (use_smem) {
        for (int w = threadIdx.x; w < a.n_slots; w += kBlock)
            s_start[w] = HS_EMPTY_START;
        __syncthreads();
    }
    int64_t tid = (int64_t)blockIdx.x * kBlock + threadIdx.x;
    int64_t total = (int64_t)a.cap * a.n_per;
    if (tid < total) {
        int i = (int)(tid / a.n_per);
        int j = (int)(tid % a.n_per);
        int start, slot;
        if (hs::record_window(a, i, j, start, slot)) {
            if (use_smem)
                atomicMax(&s_start[slot], start);
            else
                atomicMax(&a.slot_start[slot], start);
            int k = a.key[i];
            if (k >= 0 && k < a.n_keys) {
                int64_t cell = (int64_t)k * a.n_slots + slot;
                atomicAdd(&a.count[cell], 1);
                if (a.track_touched) a.touched[cell] = 1;
                for (int g = 0; g < a.n_aggs; ++g) {
                    const HsScatterAgg &ag = a.a[g];
                    float v;
                    uint32_t bits;
                    if (!hs::agg_input(ag, i, v, bits)) continue;
                    switch (ag.kind) {
                    case HS_AGG_COUNT:
                        atomicAdd((int32_t *)ag.plane + cell, 1);
                        break;
                    case HS_AGG_SUM:
                        atomicAdd((float *)ag.plane + cell, v);
                        break;
                    case HS_AGG_AVG:
                        atomicAdd((float *)ag.plane + cell, v);
                        atomicAdd(ag.plane_n + cell, 1);
                        break;
                    case HS_AGG_MIN:
                        hs::atomic_min_float((float *)ag.plane + cell, v);
                        break;
                    case HS_AGG_MAX:
                        hs::atomic_max_float((float *)ag.plane + cell, v);
                        break;
                    case HS_AGG_HLL:
                        hs::hll_update((int8_t *)ag.plane + (cell << a.hll_p),
                                       bits, a.hll_p);
                        break;
                    case HS_AGG_QUANT: {
                        int b = hs::quantile_bin(v, a.q_min, a.q_gamma,
                                                 ag.width);
                        atomicAdd((int32_t *)ag.plane + cell * ag.width + b,
                                  1);
                        break;
                    }
                    default:  // TOPK*: topk.cu
                        break;
                    }
                }
            }
        }
    }
    if (use_smem) {
        __syncthreads();
        for (int w = threadIdx.x; w < a.n_slots; w += kBlock)
            if (s_start[w] != HS_EMPTY_START)
                atomicMax(&a.slot_start[w], s_start[w]);
    }
}

}  // namespace

extern "C" int hs_scatter(const HsScatterArgs *args, void *stream) {
    int64_t total = (int64_t)args->cap * args->n_per;
    if (total == 0) return 0;
    int use_smem = args->n_slots <= kSmemSlots;
    size_t smem = use_smem ? (size_t)args->n_slots * sizeof(int) : 0;
    unsigned blocks = (unsigned)((total + kBlock - 1) / kBlock);
    scatter_kernel<<<blocks, kBlock, smem, (cudaStream_t)stream>>>(
        *args, use_smem);
    return (int)cudaGetLastError();
}
