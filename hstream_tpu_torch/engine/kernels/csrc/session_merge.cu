// Session merge, segment mode: merge the batch's pre-reduced session
// segments into the open-session arena, writing the fresh arena (the
// other of two preallocated arenas; the caller swaps them).
//
// Replaces hstream_tpu/engine/lattice.py:1432-1501 session_merge_kernel.
// The host reduces the batch's rows into per-segment planes (its
// gap-chains, so the pre-merge is exact) in the arena's layout.
//
// A key shard of a mesh (n_shards > 1; hstream_tpu/parallel/lattice.py
// :690-714 ShardedSessionLattice._build_merge) merges only the segments
// it owns, the others keyed as the sentinel in the chain core (as the
// reference rewrites their codes), so their slot is cap and the fold
// skips them.
//
// Bound on the H100: bytes: the chain core's sort, scan and single write
// of the fresh arena (session_chain.cuh, shared with the step and
// redesigned with it: narrowed one-sweep sort, single-fed slots copied
// with plain stores) over cap + nb entries, then each segment row read
// once and folded into its slot.
//
// Design: the chain core, then one warp per segment row with the row
// merges of the reference (:1474-1498): MIN/MAX min/max, HLL registers
// max, counts, sums and histogram bins add (zero bins and registers are
// skipped). SUM/AVG add with float atomics, so their last bits depend on
// the order the atomics land in.

#include <cuda_runtime.h>

#include "hs_kernels.h"
#include "session_chain.cuh"

extern "C" int hs_session_merge(const HsSessionArgs *args, void *stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (args->mode != HS_SESS_SEGMENT ||
        (args->nb > 0 && args->b_t1 == nullptr))
        return (int)cudaErrorInvalidValue;
    hs::sess::Scratch s;
    cudaError_t err = hs::sess::core(*args, s, st);
    if (err != cudaSuccess) return (int)err;
    if (args->nb > 0)
        hs::sess::fold_segments
            <<<hs::sess::blocks_for((int64_t)args->nb * 32,
                                    hs::sess::kFoldBlock),
               hs::sess::kFoldBlock, 0, st>>>(*args, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)hs::sess::fixup(*args, st);
}
