// Session remap: compact the arena's key codes through an order-
// preserving lookup table, in place.
//
// Replaces hstream_tpu/engine/lattice.py:1553-1568 session_remap_kernel:
// code < lcap ? lut[clip(code, 0, lcap - 1)] : code, so codes at or
// above lcap (the sentinel among them) pass through, and the arena stays
// sorted by (code, t0). The host maps the codes of keys without a live
// session to the sentinel, so the remap also evicts.
//
// With sent_above set it is also the interval join's code remap
// (hstream_tpu/engine/join.py:2092-2108 _remap_device_codes, eager jnp
// there): a code at or above lcap becomes the sentinel 2^22 instead of
// passing through. The join's table is a dense remap in sorted order, so
// the store stays sorted by (code, ts) either way.
//
// Bound on the H100: bytes (the code plane read and written once, the
// table gathered); for a 2^17-slot arena a few microseconds, near launch
// latency. One thread per slot.

#include <cuda_runtime.h>

#include "hs_kernels.h"

namespace {

__global__ void remap_kernel(int32_t *code, int32_t cap, const int32_t *lut,
                             int32_t lcap, int32_t sent_above) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= cap) return;
    const int c = code[i];
    if (c < lcap) code[i] = lut[min(max(c, 0), lcap - 1)];
    else if (sent_above) code[i] = HS_JOIN_SENT;
}

}  // namespace

extern "C" int hs_session_remap(int32_t *code, int32_t cap,
                                const int32_t *lut, int32_t lcap,
                                int32_t sent_above, void *stream) {
    if (cap == 0) return 0;
    if (lcap <= 0) return (int)cudaErrorInvalidValue;
    remap_kernel<<<(cap + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        code, cap, lut, lcap, sent_above);
    return (int)cudaGetLastError();
}
