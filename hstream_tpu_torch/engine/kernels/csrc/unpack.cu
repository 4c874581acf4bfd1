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
// The sharded step (parallel/lattice.py unpack_block) unpacks one data
// shard's block of the batch: `packed` points at the block's first
// record, `pitch` is the whole batch's row length (rows stay where they
// are, no copy of the block), and the kernel also writes the block's key
// column once for each key shard on the card, shifted into that shard's
// local range (key - key_sub[j]; hstream_tpu/parallel/lattice.py:177-183
// step_local's kid). Keys outside a shard's range are left to the
// scatter, which folds nothing for them but their slot starts.
//
// Bound on the H100: bytes. Per record the flags word and each bool row's
// word are read once and one byte per output column written; a handful
// of integer operations. One thread per record, neighbouring threads on
// neighbouring words, so every row is read in coalesced 128-byte lines.

#include <cuda_runtime.h>

#include "hs_kernels.h"

namespace {

constexpr int kBlock = 256;

// kBlockOut: the sharded step's launch (a row pitch and key columns);
// the single-card unpack runs the loop without either
template <bool kBlockOut>
__global__ void __launch_bounds__(kBlock)
unpack_kernel(const __grid_constant__ HsUnpackArgs a) {
    const int64_t cap = a.cap;
    const int64_t pitch = kBlockOut ? a.pitch : cap;
    for (int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x; i < cap;
         i += (int64_t)gridDim.x * kBlock) {
        const int32_t flags = a.packed[2 * pitch + i];
        a.valid[i] = (uint8_t)(flags & 1);
        for (int b = 0; b < a.n_bool; ++b)
            a.bool_out[b][i] =
                (uint8_t)(a.packed[(int64_t)a.bool_row[b] * pitch + i] != 0);
        for (int j = 0; j < a.n_null; ++j)
            a.null_out[j][i] = (uint8_t)((flags >> (1 + j)) & 1);
        if (kBlockOut) {
            const int32_t key = a.packed[i];
            for (int j = 0; j < a.n_key_out; ++j)
                a.key_out[j * cap + i] = (int32_t)((uint32_t)key -
                                                   (uint32_t)a.key_sub[j]);
        }
    }
}

}  // namespace

extern "C" int hs_unpack(const HsUnpackArgs *args, void *stream) {
    if (args->cap == 0) return 0;
    if (args->n_key_out < 0 || args->n_key_out > HS_UNPACK_KEYS ||
        (args->n_key_out > 0 && args->key_out == nullptr) ||
        (args->pitch > 0 && args->pitch < args->cap))
        return (int)cudaErrorInvalidValue;
    int64_t blocks = ((int64_t)args->cap + kBlock - 1) / kBlock;
    if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride past that
    if (args->n_key_out > 0 || args->pitch > 0) {
        HsUnpackArgs a = *args;
        if (a.pitch <= 0) a.pitch = a.cap;
        unpack_kernel<true><<<(unsigned)blocks, kBlock, 0,
                              (cudaStream_t)stream>>>(a);
    } else {
        unpack_kernel<false><<<(unsigned)blocks, kBlock, 0,
                               (cudaStream_t)stream>>>(*args);
    }
    return (int)cudaGetLastError();
}
