// Fused window close: finalize the requested slot columns into one packed
// int32 buffer and reset those slots, in one launch.
//
// Replaces the JAX package's close programs:
//   mode 0 (extract+reset): hstream_tpu/engine/lattice.py:624-639
//     build_extract_reset_slots (_extract_slots_packed :606-621,
//     finalize_column :411-436, pack_extract_rows :468-478,
//     _reset_slots_tree :586-603, sketches.py:99-107 hll_estimate);
//   mode 1 (extract only, peek): lattice.py:642-651 build_extract_slots;
//   mode 2 (reset only): lattice.py:654-664 build_reset_slots.
//
// Bound on the H100: bytes. A close reads each requested slot column of
// every plane once (dominated by 1 KiB of HLL registers per key and
// slot) and writes the packed [P, 2+rows, K] buffer once; the HLL
// estimate is a 1024-term reduction per (key, slot), a handful of
// integer operations per byte.
//
// Design: a block per (slot p, tile of 64 keys). Row 0 of the output is
// the count, row 1 slot_start[slot] broadcast, then one row per
// aggregate (float32 bits); padding slots (< 0) give all-zero rows and
// reset nothing. Each HLL estimate is one warp's reduction of the
// register word loads; the sum of 2^-r is taken exactly, as the integer
// sum of 2^(R-r) (R = 33-p) rounded once to float32, so it does not
// depend on reduction order and equals the plain version's bit for bit. The reset runs in the same
// launch from pre-reset values: each block resets only the cells it
// read, after a barrier. slot_start[slot] is read by every key tile of
// that slot, so only the last tile to finish (a per-slot counter,
// __threadfence + atomicAdd) resets it.

#include <cuda_runtime.h>

#include "hs_kernels.h"

namespace {

constexpr int kBlock = 256;
constexpr int kTile = 64;

__device__ float finalize(const HsCloseAgg &g, int64_t cell, int cnt) {
    switch (g.kind) {
    case HS_AGG_COUNT_ALL:
        return __int2float_rn(cnt);
    case HS_AGG_AVG: {
        float n = __int2float_rn(g.plane_n[cell]);
        return __fdiv_rn(((const float *)g.plane)[cell], fmaxf(n, 1.0f));
    }
    case HS_AGG_MIN:
    case HS_AGG_MAX:
        return cnt > 0 ? ((const float *)g.plane)[cell] : 0.0f;
    default:  // HS_AGG_SUM
        return ((const float *)g.plane)[cell];
    }
}

__global__ void __launch_bounds__(kBlock)
close_kernel(const HsCloseArgs a) {
    const int p = blockIdx.x;
    const int k0 = blockIdx.y * kTile;
    const int kend = min(k0 + kTile, a.n_keys);
    const int rows = 2 + a.n_aggs;
    const int slot = a.slots[p];
    const int K = a.n_keys, W = a.n_slots;
    const bool extract = a.mode != HS_CLOSE_RESET;
    const bool reset = a.mode != HS_CLOSE_EXTRACT;
    int32_t *out = extract ? a.out + (int64_t)p * rows * K : nullptr;
    if (slot < 0) {
        if (extract)
            for (int r = 0; r < rows; ++r)
                for (int k = k0 + threadIdx.x; k < kend; k += kBlock)
                    out[(int64_t)r * K + k] = 0;
        return;
    }
    const int m = 1 << a.hll_p;
    const int words = m >> 2;  // registers per (key, slot) as 32-bit words
    const int big_r = 33 - a.hll_p;
    __shared__ int s_start;
    if (threadIdx.x == 0) s_start = a.slot_start[slot];
    __syncthreads();

    if (extract) {
        for (int k = k0 + threadIdx.x; k < kend; k += kBlock) {
            int64_t cell = (int64_t)k * W + slot;
            int cnt = a.count[cell];
            out[k] = cnt;
            out[(int64_t)K + k] = s_start;
            for (int g = 0; g < a.n_aggs; ++g)
                if (a.a[g].kind != HS_AGG_HLL)
                    out[(int64_t)(2 + g) * K + k] =
                        __float_as_int(finalize(a.a[g], cell, cnt));
        }
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        for (int g = 0; g < a.n_aggs; ++g) {
            if (a.a[g].kind != HS_AGG_HLL) continue;
            const uint32_t *plane = (const uint32_t *)a.a[g].plane;
            for (int k = k0 + warp; k < kend; k += kBlock / 32) {
                const uint32_t *regs =
                    plane + ((int64_t)k * W + slot) * words;
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
                    sum += __shfl_down_sync(0xFFFFFFFFu, sum, d);
                    zeros += __shfl_down_sync(0xFFFFFFFFu, zeros, d);
                }
                if (lane == 0) {
                    // the reference's float32 arithmetic, one op at a time
                    float fm = (float)m;
                    float denom = ldexpf(__ull2float_rn(sum), -big_r);
                    float raw = __fdiv_rn(a.hll_am2, denom);
                    float lin = __fmul_rn(fm, logf(__fdiv_rn(
                        fm, fmaxf(__int2float_rn(zeros), 1.0f))));
                    bool use_lin = raw <= 2.5f * fm && zeros > 0;
                    out[(int64_t)(2 + g) * K + k] =
                        __float_as_int(use_lin ? lin : raw);
                }
            }
        }
    }
    if (!reset) return;
    __syncthreads();  // every read of this tile precedes its reset
    for (int k = k0 + threadIdx.x; k < kend; k += kBlock) {
        int64_t cell = (int64_t)k * W + slot;
        a.count[cell] = 0;
        a.touched[cell] = 0;
        for (int g = 0; g < a.n_aggs; ++g) {
            const HsCloseAgg &ag = a.a[g];
            if (ag.kind == HS_AGG_COUNT_ALL || ag.kind == HS_AGG_HLL) continue;
            ((float *)ag.plane)[cell] = ag.init;
            if (ag.kind == HS_AGG_AVG) ag.plane_n[cell] = 0;
        }
    }
    for (int g = 0; g < a.n_aggs; ++g) {
        if (a.a[g].kind != HS_AGG_HLL) continue;
        uint32_t *plane = (uint32_t *)a.a[g].plane;
        int n = (kend - k0) * words;
        for (int idx = threadIdx.x; idx < n; idx += kBlock) {
            int k = k0 + idx / words;
            plane[((int64_t)k * W + slot) * words + idx % words] = 0u;
        }
    }
    if (threadIdx.x == 0) {
        __threadfence();
        unsigned prev = atomicAdd(&a.done[p], 1u);
        if (prev == gridDim.y - 1) a.slot_start[slot] = HS_EMPTY_START;
    }
}

}  // namespace

extern "C" int hs_close(const HsCloseArgs *args, void *stream) {
    if (args->n_sel == 0 || args->n_keys == 0) return 0;
    dim3 grid((unsigned)args->n_sel,
              (unsigned)((args->n_keys + kTile - 1) / kTile));
    close_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(*args);
    return (int)cudaGetLastError();
}
