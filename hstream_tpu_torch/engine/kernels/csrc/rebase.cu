// Rebase: shift device-relative window starts by -delta where a slot is
// occupied, after the host re-anchored the query's epoch.
//
// Replaces hstream_tpu/engine/lattice.py:1571-1578 `rebase`. W elements
// (3 for the headline query, 8 for HOP(60s,10s)): 24-64 bytes, ~1e-8 ms
// of the card's memory time, so what bounds it is the launch itself,
// which nothing inside a kernel can beat. The design makes it the
// cheapest launch there is: blocks of one warp, two slots a lane (a block
// takes 64 slots; more slots take more blocks), the delta by value, no
// rounding up to a 256-thread block. One slot a thread in the same block
// measured 7 % slower (0.00113-0.00114 ms against 0.00106 at W = 3 and 8
// on an H100 SXM, ab.py remap), the 256-thread launch 0.00108. What the rebase takes
// over an empty launch is one load's round trip before its store: a slot
// must be read to know whether it is occupied.

#include <cuda_runtime.h>

#include "hs_kernels.h"

namespace {

constexpr int kLanes = 32;
constexpr int kPerLane = 2;

__global__ void __launch_bounds__(kLanes)
rebase_kernel(int32_t *__restrict__ slot_start, int32_t n_slots,
              int32_t delta) {
    const int base = blockIdx.x * (kLanes * kPerLane) + threadIdx.x;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
        const int w = base + j * kLanes;
        if (w < n_slots) {
            const int32_t s = slot_start[w];
            if (s != HS_EMPTY_START)
                slot_start[w] = (int32_t)((uint32_t)s - (uint32_t)delta);
        }
    }
}

// Not on any path of the engine: an empty launch of the same shape, the
// floor that the rebase's time is measured against.
__global__ void __launch_bounds__(kLanes) empty_kernel() {}

}  // namespace

extern "C" int hs_rebase(int32_t *slot_start, int32_t n_slots, int32_t delta,
                         void *stream) {
    if (n_slots == 0) return 0;
    const int blocks = (n_slots + kLanes * kPerLane - 1) / (kLanes * kPerLane);
    rebase_kernel<<<blocks, kLanes, 0, (cudaStream_t)stream>>>(
        slot_start, n_slots, delta);
    return (int)cudaGetLastError();
}

// Times the launch floor only (the kernels' check and the A/B script).
extern "C" int hs_empty(void *stream) {
    empty_kernel<<<1, kLanes, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
