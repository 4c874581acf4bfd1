// Packed-transport unpack: the flag bits and bool rows of one packed
// int32 micro-batch [3 + n_cols, cap] as the one-byte columns the window
// step's kernels read (expr.cu, scatter.cu, topk.cu).
//
// Replaces the decode half of hstream_tpu/engine/lattice.py:374-385
// build_step_packed, unpack_batch_device (:354-371):
//   valid          = (flags & 1) != 0
//   a bool column  = row != 0
//   NULL mask j    = ((flags >> (1 + j)) & 1) != 0, j counted over the
//                    aggregates that have a mask (the reference's
//                    numbering, which the host packer's does not match
//                    when a maskless aggregate comes first; kept as is)
// Key ids, times, f32 and i32 rows are views of the buffer in the
// wrapper (engine/lattice.py unpack): nothing here copies them.
//
// Bound on the H100: bytes. Per record the flags word and each bool row's
// word are read once and one byte per output column written; a handful
// of integer operations. One thread per record, neighbouring threads on
// neighbouring words, so every row is read in coalesced 128-byte lines.

#include <cuda_runtime.h>

#include "hs_kernels.h"

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
unpack_kernel(const __grid_constant__ HsUnpackArgs a) {
    const int64_t cap = a.cap;
    for (int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x; i < cap;
         i += (int64_t)gridDim.x * kBlock) {
        const int32_t flags = a.packed[2 * cap + i];
        a.valid[i] = (uint8_t)(flags & 1);
        for (int b = 0; b < a.n_bool; ++b)
            a.bool_out[b][i] =
                (uint8_t)(a.packed[(int64_t)a.bool_row[b] * cap + i] != 0);
        for (int j = 0; j < a.n_null; ++j)
            a.null_out[j][i] = (uint8_t)((flags >> (1 + j)) & 1);
    }
}

}  // namespace

extern "C" int hs_unpack(const HsUnpackArgs *args, void *stream) {
    if (args->cap == 0) return 0;
    int64_t blocks = ((int64_t)args->cap + kBlock - 1) / kBlock;
    if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride past that
    unpack_kernel<<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(
        *args);
    return (int)cudaGetLastError();
}
