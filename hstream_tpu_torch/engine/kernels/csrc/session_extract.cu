// Session extract: finalize the arena slots a close cycle (or a peek)
// names into one int32 buffer [1 + n_aggs, P], fetched in one copy.
//
// Replaces hstream_tpu/engine/lattice.py:1504-1550 session_extract_kernel.
// Slots < 0 pad the vector to a power of two and extract zeros (row 0:
// the sentinel code). A mesh's key-sharded arena (hstream_tpu/parallel/
// lattice.py:716-728) launches it once a shard, each into its row of an
// [n_shards, 1 + n_aggs, P] buffer (parallel/lattice.py).
//
// Bound on the H100: bytes: each named slot's planes read once (a 512-bin
// histogram is 2 KiB, an HLL register set 1 KiB), the buffer written once.
// On the session path (BASELINE config 4) two APPROX_QUANTILEs share one
// histogram (session_lattice.session_plane_names), so the bound reads it
// once for both.
//
// What held the first design back: each APPROX_QUANTILE read its
// histogram on its own, so the shared one was read twice; a lane read
// 16 consecutive bins, so a warp-wide load touched 32 sectors 64 bytes
// apart and a histogram took 16 such loads; and each aggregate waited
// out its own chain of loads.
//
// Design: a warp a slot, eight slots a block. The slot vector comes up
// to its last named slot only (n_live; the pads that round it up to a
// power of two stay on the host), by value in the kernel's parameters
// up to HS_SESS_INLINE slots (the path's ~6,250), so no copy precedes
// the launch; a longer one is uploaded. A pad's warp writes its
// sentinel row and zeros and reads nothing. A slot's lanes first load
// the words of its scalar rows (lane r row r: the code, a COUNT's or
// SUM's word, AVG's sum and count, MIN/MAX), then run the sketches with
// the loads in flight: an HLL estimate (finalize.cuh hll_warp), and
// each histogram once, read with 16-byte loads over 512 contiguous
// bytes a warp, scanned round by round, with every APPROX_QUANTILE that
// shares it answered from the same registers (quant_scan, up to four at
// a time). The finalize follows the session's own rules, which differ
// from the window close's: an empty histogram gives 0.0 (not the top
// bucket's midpoint), a MIN of +inf or a MAX of -inf gives 0.0, HLL is
// rint(estimate) as int32, AVG is sum / max(n, 1) in float32, counts are
// int32, floats are bitcast.

#include <cuda_runtime.h>

#include "finalize.cuh"
#include "hs_kernels.h"

namespace {

constexpr int kBlock = 256;
constexpr int kMaxQ = 4;   // quantiles of one histogram answered at once

__device__ __forceinline__ bool sketch_kind(int kind) {
    return kind == HS_AGG_HLL || kind == HS_AGG_QUANT;
}

// row r's words: r = 0 the slot's code, else aggregate r - 1's plane
// word (w) and AVG's count (n); nothing for a sketch
__device__ __forceinline__ void load_row(const HsSessExtractArgs &a,
                                         int slot, int r, bool active,
                                         uint32_t &w, int32_t &n) {
    w = 0u;
    n = 0;
    if (!active) return;
    if (r == 0) {
        w = (uint32_t)a.code[slot];
        return;
    }
    const HsCloseAgg &ag = a.f.a[r - 1];
    if (sketch_kind(ag.kind)) return;
    w = ((const uint32_t *)ag.plane)[slot];
    if (ag.kind == HS_AGG_AVG) n = ag.plane_n[slot];
}

// row r (> 0) of a scalar aggregate from its words, by the session's rules
__device__ __forceinline__ int32_t row_value(const HsCloseAgg &ag,
                                             uint32_t w, int32_t n) {
    switch (ag.kind) {
    case HS_AGG_COUNT_ALL:
    case HS_AGG_COUNT:
        return (int32_t)w;
    case HS_AGG_AVG:
        return __float_as_int(__fdiv_rn(__uint_as_float(w),
                                        fmaxf(__int2float_rn(n), 1.0f)));
    case HS_AGG_MIN:
    case HS_AGG_MAX: {
        const uint32_t none =
            ag.kind == HS_AGG_MIN ? 0x7F800000u : 0xFF800000u;
        return w == none ? 0 : (int32_t)w;
    }
    default:  // HS_AGG_SUM
        return (int32_t)w;
    }
}

// aggregates who[0..kQ) from one read of histogram h, by the session's
// rule (an empty histogram gives 0.0)
template <int kQ>
__device__ __forceinline__ void answer(const HsFinalize &f,
                                       const int32_t *h, int bins,
                                       const int (&who)[kMaxQ], int32_t *out,
                                       int64_t stride, int lane) {
    float q[kQ];
    int idx[kQ];
#pragma unroll
    for (int t = 0; t < kQ; ++t) q[t] = f.a[who[t]].q;
    const long long total = hs::quant_scan<kQ>(h, bins, lane, q, idx);
    if (lane == 0) {
#pragma unroll
        for (int t = 0; t < kQ; ++t)
            out[(int64_t)(1 + who[t]) * stride] = __float_as_int(
                total > 0 ? hs::quant_mid(f, idx[t]) : 0.0f);
    }
}

// the quantiles that read the histogram of aggregate g (the first of
// them): each from one read of it, up to kMaxQ at a time
__device__ __forceinline__ void quantiles(const HsSessExtractArgs &a, int g,
                                          int slot, int32_t *out,
                                          int64_t stride, int lane) {
    const HsFinalize &f = a.f;
    const void *plane = f.a[g].plane;
    const int bins = f.a[g].plane_width;
    const int32_t *h = (const int32_t *)plane + (int64_t)slot * bins;
    for (int h0 = g; h0 < f.n_aggs;) {
        int who[kMaxQ] = {0, 0, 0, 0};
        int nq = 0, next = f.n_aggs;
        for (int j = h0; j < f.n_aggs; ++j) {
            if (f.a[j].kind != HS_AGG_QUANT || f.a[j].plane != plane)
                continue;
            if (nq == kMaxQ) {
                next = j;
                break;
            }
#pragma unroll
            for (int t = 0; t < kMaxQ; ++t)
                if (t == nq) who[t] = j;
            ++nq;
        }
        switch (nq) {
        case 1: answer<1>(f, h, bins, who, out, stride, lane); break;
        case 2: answer<2>(f, h, bins, who, out, stride, lane); break;
        case 3: answer<3>(f, h, bins, who, out, stride, lane); break;
        default: answer<4>(f, h, bins, who, out, stride, lane); break;
        }
        h0 = next;
    }
}

__global__ void __launch_bounds__(kBlock)
extract_kernel(const __grid_constant__ HsSessExtractArgs a) {
    const int64_t p = ((int64_t)blockIdx.x * kBlock + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (p >= a.n_sel) return;  // warp-uniform: one slot per warp
    const HsFinalize &f = a.f;
    const int slot = p >= a.n_live ? -1
                     : a.slots != nullptr ? a.slots[p] : a.sel[p];
    const int rows = 1 + f.n_aggs;
    const int64_t stride = a.n_sel;
    int32_t *out = a.out + p;
    if (slot < 0) {  // a pad: the sentinel code and zeros
        for (int r = lane; r < rows; r += 32)
            out[(int64_t)r * stride] = r == 0 ? HS_SESSION_SENT : 0;
        return;
    }
    uint32_t w;
    int32_t n;
    load_row(a, slot, lane, lane < rows, w, n);
    for (int g = 0; g < f.n_aggs; ++g) {
        const HsCloseAgg &ag = f.a[g];
        if (ag.kind == HS_AGG_HLL) {
            const float est = hs::hll_warp(f, ag, slot, lane);
            if (lane == 0)
                out[(int64_t)(1 + g) * stride] = (int32_t)rintf(est);
            continue;
        }
        if (ag.kind != HS_AGG_QUANT) continue;
        bool first = true;  // the first quantile of its histogram
        for (int j = 0; j < g && first; ++j)
            first = f.a[j].kind != HS_AGG_QUANT || f.a[j].plane != ag.plane;
        if (first) quantiles(a, g, slot, out, stride, lane);
    }
    for (int r = lane; r < rows; r += 32) {
        if (r >= 32) load_row(a, slot, r, true, w, n);
        if (r == 0) {
            out[0] = (int32_t)w;
        } else if (!sketch_kind(f.a[r - 1].kind)) {
            out[(int64_t)r * stride] = row_value(f.a[r - 1], w, n);
        }
    }
}

}  // namespace

extern "C" int hs_session_extract(const HsSessExtractArgs *args,
                                  void *stream) {
    if (args->n_sel == 0) return 0;
    if (args->f.n_aggs > HS_MAX_AGGS || args->n_live < 0 ||
        args->n_live > args->n_sel ||
        (args->slots == nullptr && args->n_live > HS_SESS_INLINE))
        return (int)cudaErrorInvalidValue;
    const int64_t threads = (int64_t)args->n_sel * 32;
    extract_kernel<<<(unsigned)((threads + kBlock - 1) / kBlock), kBlock, 0,
                     (cudaStream_t)stream>>>(*args);
    return (int)cudaGetLastError();
}
