// Session extract: finalize the arena slots a close cycle (or a peek)
// names into one int32 buffer [1 + n_aggs, P], fetched in one copy.
//
// Replaces hstream_tpu/engine/lattice.py:1504-1550 session_extract_kernel.
// Slots < 0 pad the vector to a power of two and extract zeros (row 0:
// the sentinel code).
//
// Bound on the H100: bytes: each named slot's planes read once (a 512-bin
// histogram is 2 KiB, an HLL register set 1 KiB), the buffer written once.
//
// Design: one warp per slot. Row 0 is the slot's code, which the host
// holds against its interval mirror. The finalize reuses finalize.cuh's
// warp estimates (the exact integer HLL sum, the integer CDF scan of the
// quantile) with the session's own rules, which differ from the window
// close's: an empty histogram gives 0.0 (not the top bucket's midpoint),
// a MIN of +inf or a MAX of -inf gives 0.0, HLL is rint(estimate) as
// int32, AVG is sum / max(n, 1) in float32, counts are int32, floats are
// bitcast.

#include <cuda_runtime.h>

#include "finalize.cuh"
#include "hs_kernels.h"

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
extract_kernel(const __grid_constant__ HsSessExtractArgs a) {
    const int64_t p = ((int64_t)blockIdx.x * kBlock + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (p >= a.n_sel) return;
    const int slot = a.slots[p];
    const bool ok = slot >= 0;  // warp-uniform: one slot per warp
    int32_t *out = a.out + p;
    const int64_t stride = a.n_sel;
    if (lane == 0) out[0] = ok ? a.code[slot] : HS_SESSION_SENT;
    for (int g = 0; g < a.f.n_aggs; ++g) {
        const HsCloseAgg &ag = a.f.a[g];
        int32_t r = 0;
        if (ok) {
            switch (ag.kind) {
            case HS_AGG_COUNT_ALL:
            case HS_AGG_COUNT:
                r = ((const int32_t *)ag.plane)[slot];
                break;
            case HS_AGG_AVG: {
                const float n = __int2float_rn(ag.plane_n[slot]);
                r = __float_as_int(__fdiv_rn(((const float *)ag.plane)[slot],
                                             fmaxf(n, 1.0f)));
                break;
            }
            case HS_AGG_MIN:
            case HS_AGG_MAX: {
                const float v = ((const float *)ag.plane)[slot];
                const float none = __int_as_float(
                    ag.kind == HS_AGG_MIN ? 0x7F800000 : (int)0xFF800000u);
                r = __float_as_int(v == none ? 0.0f : v);
                break;
            }
            case HS_AGG_HLL:
                r = (int32_t)rintf(hs::hll_warp(a.f, ag, slot, lane));
                break;
            case HS_AGG_QUANT: {
                long long total = 0;
                const float est = hs::quant_warp(a.f, ag, slot, lane, &total);
                r = __float_as_int(total > 0 ? est : 0.0f);
                break;
            }
            default:  // HS_AGG_SUM
                r = __float_as_int(((const float *)ag.plane)[slot]);
            }
        }
        if (lane == 0) out[(int64_t)(1 + g) * stride] = r;
    }
}

}  // namespace

extern "C" int hs_session_extract(const HsSessExtractArgs *args,
                                  void *stream) {
    if (args->n_sel == 0) return 0;
    const int64_t threads = (int64_t)args->n_sel * 32;
    extract_kernel<<<(unsigned)((threads + kBlock - 1) / kBlock), kBlock, 0,
                     (cudaStream_t)stream>>>(*args);
    return (int)cudaGetLastError();
}
