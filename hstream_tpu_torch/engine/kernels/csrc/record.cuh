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
#pragma once

#include <cuda_runtime.h>

#include "hs_kernels.h"

namespace hs {

__device__ __forceinline__ int floor_mod(int a, int b) {
    int r = a % b;
    return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

__device__ __forceinline__ int floor_div(int a, int b) {
    return (a - floor_mod(a, b)) / b;
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

// aggregate ag's input for record i as float32 (v) and as the 32 bits
// the HLL hash reads (-0.0 canonicalized to 0.0); false when it does not
// count (NULL, or a non-finite float)
__device__ __forceinline__ bool agg_input(const HsScatterAgg &ag, int i,
                                          float &v, uint32_t &bits) {
    if (ag.nulls != nullptr && ag.nulls[i]) return false;
    if (ag.vtype == HS_T_F32) {
        v = ((const float *)ag.values)[i];
        bits = __float_as_uint(v == 0.0f ? 0.0f : v);
        return isfinite(v);
    }
    if (ag.vtype == HS_T_I32) {
        int x = ((const int *)ag.values)[i];
        v = __int2float_rn(x);
        bits = (uint32_t)x;
        return true;
    }
    bits = ((const uint8_t *)ag.values)[i] ? 1u : 0u;
    v = (float)bits;
    return true;
}

}  // namespace hs
