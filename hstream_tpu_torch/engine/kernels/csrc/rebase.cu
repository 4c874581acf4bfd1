// Rebase: shift device-relative window starts by -delta where a slot is
// occupied, after the host re-anchored the query's epoch.
//
// Replaces hstream_tpu/engine/lattice.py:1571-1578 `rebase`. W elements
// (3 for the headline query): bound by launch latency, not by the card's
// bytes or operations. One thread per slot.

#include <cuda_runtime.h>

#include "hs_kernels.h"

namespace {

__global__ void rebase_kernel(int32_t *slot_start, int32_t n_slots,
                              int32_t delta) {
    int w = blockIdx.x * blockDim.x + threadIdx.x;
    if (w < n_slots && slot_start[w] != HS_EMPTY_START)
        slot_start[w] = (int32_t)((uint32_t)slot_start[w] - (uint32_t)delta);
}

}  // namespace

extern "C" int hs_rebase(int32_t *slot_start, int32_t n_slots, int32_t delta,
                         void *stream) {
    if (n_slots == 0) return 0;
    rebase_kernel<<<(n_slots + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        slot_start, n_slots, delta);
    return (int)cudaGetLastError();
}
