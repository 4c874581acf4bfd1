// Interval-join insert: merge the (code, ts)-sorted batch into the
// sorted store, writing the other of the side's two stores.
//
// Replaces hstream_tpu/engine/lattice.py:962-981 _join_insert (the
// insert half of join_probe_insert and join_probe_insert_step): one
// stable 2-key sort of the concatenation store ++ batch (the batch's
// padding and codes at or above the sentinel keyed as the sentinel),
// its first `cap` entries kept, flags and columns moved with their
// entry.
//
// Both inputs are already sorted by (code, ts): the store because every
// program that writes it keeps it so, the batch because the host sorts
// it (np.lexsort) and pads it with (sentinel, 0). So this is a merge, not
// a sort: a stable merge of two sorted runs puts
//   store entry i at i + #(batch entries with key <  its key)
//   batch entry j at j + #(store entries with key <= its key)
// (equal keys: the store's first, then the batch's, each in its own
// order), which is exactly the stable sort's order of store ++ batch,
// sentinels included. One thread per entry, two binary searches' worth
// of work each; an entry whose place is at or past `cap` is dropped
// (the host grows or evicts before that can drop a live entry).
//
// Bound on the H100: bytes (store and batch read once, the store
// written once). One launch.

#include <cuda_runtime.h>

#include "join_core.cuh"

namespace {

__global__ void merge_kernel(HsJoinInsertArgs a) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (int64_t)a.cap + a.bcap) return;
    const int32_t *bcode = a.batch;
    const int32_t *bts = a.batch + a.bcap;
    int64_t pos;
    int32_t code, ts, flags;
    const int32_t *col;
    size_t stride;
    int32_t idx;
    if (t < a.cap) {
        idx = (int32_t)t;
        code = a.code[idx];
        ts = a.ts[idx];
        pos = idx + hsjoin::count_batch_before(bcode, bts, a.bcap, a.n,
                                               code, ts, false);
        if (pos >= a.cap) return;
        flags = a.flags[idx];
        col = a.cols;
        stride = (size_t)a.cap;
    } else {
        idx = (int32_t)(t - a.cap);
        code = hsjoin::batch_code(bcode, idx, a.n);
        ts = bts[idx];
        pos = idx + hsjoin::count_before(a.code, a.ts, a.cap, code, ts,
                                         true);
        if (pos >= a.cap) return;
        flags = a.batch[3 * (size_t)a.bcap + idx];
        col = a.batch + 4 * (size_t)a.bcap;
        stride = (size_t)a.bcap;
    }
    a.out_code[pos] = code;
    a.out_ts[pos] = ts;
    a.out_flags[pos] = flags;
    for (int32_t c = 0; c < a.n_cols; ++c)
        a.out_cols[(size_t)c * a.cap + pos] = col[c * stride + idx];
}

}  // namespace

extern "C" int hs_join_insert(const HsJoinInsertArgs *args, void *stream) {
    const HsJoinInsertArgs a = *args;
    if (a.cap <= 0 || a.bcap < 0 || a.n_cols < 0 ||
        a.n_cols > HS_JOIN_MAX_COLS)
        return (int)cudaErrorInvalidValue;
    const int64_t total = (int64_t)a.cap + a.bcap;
    merge_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                   (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
