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
// Bound on the H100: bytes. The code plane is read once and written once
// (8 bytes a code), the table gathered through the read-only path; for
// the session arena's 2^17 codes that is ~1 MiB, below a launch's floor,
// for the join store's ~2^21 a side ~16 MiB, ~5 us at 3.35 TB/s. The
// first design ran one thread a code with scalar loads and a 256-thread
// block per 256 codes. This one takes four codes a thread through one
// 16-byte load and store where the plane's base allows (the few codes
// before the first 16-byte boundary and after the last whole quad are
// scalar lanes), with a grid sized to the card (its SMs times the blocks
// it keeps resident) and a grid-stride loop past that, so a 2^21 plane
// runs in one wave with several quads in flight a thread.

#include <cuda_runtime.h>

#include "device.cuh"
#include "hs_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2048 resident threads an SM

__device__ __forceinline__ int32_t remap_one(int32_t c,
                                             const int32_t *__restrict__ lut,
                                             int32_t lcap,
                                             int32_t sent_above) {
    if (c < lcap) return __ldg(lut + max(c, 0));
    return sent_above ? HS_JOIN_SENT : c;
}

// head: scalar codes before the first 16-byte boundary; n4: whole quads
// after them; the codes past head + 4 * n4 are the scalar tail
__global__ void __launch_bounds__(kThreads)
remap_kernel(int32_t *__restrict__ code, int32_t cap,
             const int32_t *__restrict__ lut, int32_t lcap,
             int32_t sent_above, int32_t head, int32_t n4) {
    const int tid = blockIdx.x * blockDim.x + threadIdx.x;
    const int stride = gridDim.x * blockDim.x;
    int4 *quads = reinterpret_cast<int4 *>(code + head);
    for (int q = tid; q < n4; q += stride) {
        int4 v = quads[q];
        v.x = remap_one(v.x, lut, lcap, sent_above);
        v.y = remap_one(v.y, lut, lcap, sent_above);
        v.z = remap_one(v.z, lut, lcap, sent_above);
        v.w = remap_one(v.w, lut, lcap, sent_above);
        quads[q] = v;
    }
    // at most 3 head and 3 tail codes: the first threads take them
    const int tail0 = head + 4 * n4;
    if (tid < head) code[tid] = remap_one(code[tid], lut, lcap, sent_above);
    if (tid < cap - tail0)
        code[tail0 + tid] =
            remap_one(code[tail0 + tid], lut, lcap, sent_above);
}

}  // namespace

extern "C" int hs_session_remap(int32_t *code, int32_t cap,
                                const int32_t *lut, int32_t lcap,
                                int32_t sent_above, void *stream) {
    if (cap == 0) return 0;
    if (lcap <= 0) return (int)cudaErrorInvalidValue;
    const uintptr_t mis = reinterpret_cast<uintptr_t>(code) & 15u;
    // an int32 plane is 4-byte aligned: 0..3 codes to the next boundary
    int32_t head = mis == 0 ? 0 : (int32_t)((16u - mis) >> 2);
    if (head > cap) head = cap;
    const int32_t n4 = (cap - head) >> 2;
    int sms = 0;
    cudaError_t err = hs::current_sms(&sms);
    if (err != cudaSuccess) return (int)err;
    const int64_t need = ((int64_t)n4 + kThreads - 1) / kThreads;
    int64_t blocks = (int64_t)sms * kBlocksPerSm;
    if (need < blocks) blocks = need;
    if (blocks < 1) blocks = 1;  // a plane of fewer than 4 codes
    remap_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        code, cap, lut, lcap, sent_above, head, n4);
    return (int)cudaGetLastError();
}
