// Session remap: compact the arena's key codes through an order-
// preserving lookup table, in place.
//
// Replaces hstream_tpu/engine/lattice.py:1553-1568 session_remap_kernel:
// code < lcap ? lut[clip(code, 0, lcap - 1)] : code, so codes at or
// above lcap (the sentinel among them) pass through, and the arena stays
// sorted by (code, t0). The host maps the codes of keys without a live
// session to the sentinel, so the remap also evicts.
//
// Bound on the H100: bytes (the code plane read and written once, the
// table gathered); for a 2^17-slot arena a few microseconds, near launch
// latency. One thread per slot.

#include <cuda_runtime.h>

#include "hs_kernels.h"

namespace {

__global__ void remap_kernel(int32_t *code, int32_t cap, const int32_t *lut,
                             int32_t lcap) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= cap) return;
    const int c = code[i];
    if (c < lcap) code[i] = lut[min(max(c, 0), lcap - 1)];
}

}  // namespace

extern "C" int hs_session_remap(int32_t *code, int32_t cap,
                                const int32_t *lut, int32_t lcap,
                                void *stream) {
    if (cap == 0) return 0;
    if (lcap <= 0) return (int)cudaErrorInvalidValue;
    remap_kernel<<<(cap + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        code, cap, lut, lcap);
    return (int)cudaGetLastError();
}
