// Routing of a key-sharded join's match feed to the inner lattice's
// partials, the fused sharded step's middle (parallel/lattice.py
// ShardedJoinLattice.probe_insert_step).
//
// Replaces, in hstream_tpu/parallel/lattice.py:470-528 join_step_local,
// the lines after the probe: the all_gather of the key shards' match
// segments (here they are already one buffer: shard s's feed launch
// writes its segment at offset s * match_cap, so the gather is
// addressing), and the routing of entry i to inner partial (d, k):
//   kid_l = kid - k * Kl           (a key outside [0, Kl) folds nothing
//                                   but its slot starts in the scatter)
//   valid & (i mod n_data == d)    (the reference's dmine)
// The scatter (scatter.cu) then runs once per partial on these columns.
//
// Bound on the H100: bytes; per entry one key and one valid byte read,
// n_key keys and n_data bytes written. One thread per entry.

#include <cuda_runtime.h>

#include "hs_kernels.h"

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
route_kernel(const __grid_constant__ HsJoinRouteArgs a) {
    const int32_t i = blockIdx.x * kBlock + threadIdx.x;
    if (i >= a.m) return;
    const int32_t kid = a.kid[i];
    for (int32_t k = 0; k < a.n_key; ++k)
        a.keys[(size_t)k * a.m + i] =
            (int32_t)((uint32_t)kid - (uint32_t)(k * a.local_keys));
    const uint8_t v = a.valid[i];
    const int32_t mine = i % a.n_data;
    for (int32_t d = 0; d < a.n_data; ++d)
        a.valid_out[(size_t)d * a.m + i] = (v != 0 && d == mine) ? 1 : 0;
}

}  // namespace

extern "C" int hs_join_route(const HsJoinRouteArgs *args, void *stream) {
    const HsJoinRouteArgs &a = *args;
    if (a.m < 0 || a.n_data < 1 || a.n_key < 1 || a.local_keys < 1)
        return (int)cudaErrorInvalidValue;
    if (a.m == 0) return 0;
    route_kernel<<<(a.m + kBlock - 1) / kBlock, kBlock, 0,
                   (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
