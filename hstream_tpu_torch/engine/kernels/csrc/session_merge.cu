// Session merge, segment mode: merge the batch's pre-reduced session
// segments into the open-session arena, writing the fresh arena (the
// other of two preallocated arenas; the caller swaps them).
//
// Replaces hstream_tpu/engine/lattice.py:1432-1501 session_merge_kernel.
// The host reduces the batch's rows into per-segment planes (its
// gap-chains, so the pre-merge is exact) in the arena's layout.
//
// The key shards of a mesh (hstream_tpu/parallel/lattice.py:690-714
// ShardedSessionLattice._build_merge; hs_session_merge_group): each shard
// merges only the segments it owns, as the reference's rewritten codes
// make it. What bounded the first sharded design (0.744 ms for 4 shards of
// 2^15 slots and 50,000 segments): a launch sequence of ~17 launches a
// shard, each keying, sorting and scanning every segment, so the merge was
// bound by its launches. Now one sequence a card covers a table of the
// shards whose arenas lie there (session_chain.cuh core_group): a segment
// is sorted once if a shard of the table owns it, dropped before the sort
// otherwise, and group_fold_segments folds it into its own shard's arena.
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

extern "C" int hs_session_merge_group(const HsSessGroupArgs *args,
                                      void *stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (args->mode != HS_SESS_SEGMENT ||
        (args->nb > 0 && args->b_t1 == nullptr))
        return (int)cudaErrorInvalidValue;
    hs::sess::Scratch s;
    cudaError_t err = hs::sess::core_group(*args, s, st);
    if (err != cudaSuccess) return (int)err;
    if (args->nb > 0)
        hs::sess::group_fold_segments
            <<<hs::sess::blocks_for((int64_t)args->nb * 32,
                                    hs::sess::kFoldBlock),
               hs::sess::kFoldBlock, 0, st>>>(*args, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)hs::sess::group_fixup(*args, st);
}
