// Interval-join eviction and epoch rebase, both sides in one call.
//
// Replaces hstream_tpu/engine/lattice.py:1131-1162 join_evict: per side,
// an entry survives iff code < sentinel and ts >= cutoff, with ts - delta
// (int32 wrap; delta 0 outside a rebase, < 0 for a rebase down); a dead
// entry becomes (sentinel, 0); one stable 2-key sort of (code, ts)
// reorders flags and columns to match; the live counts come back as
// int32 [2].
//
// That sort is a stable compaction here, for two reasons:
//   * the live entries are a subsequence of a store sorted by (code, ts),
//     so they are already in sorted order, and shifting every one of
//     them by the same -delta keeps that order (the host keeps relative
//     times far from the int32 edge, so the shift does not wrap);
//   * every dead entry has the same key (sentinel, 0), above any live
//     one, so the stable sort keeps them in their own order after the
//     live ones.
// So live entry i goes to the number of live entries before it, and dead
// entry i to n_live + the number of dead entries before it: a prefix sum
// of `alive` (tiles of 1024 scanned per block, the tile totals by one
// block per side with a running carry), flags and columns moved with
// their entry. tests/test_torch_join_lattice.py holds the plain
// compaction against the plain sort.
//
// Bound on the H100: bytes (both stores read once and written once).
// Launches: a count per tile, the tile scan, the move; each over both
// sides (grid y = side).

#include <cuda_runtime.h>

#include "join_core.cuh"

namespace {

__device__ __forceinline__ bool alive(const HsJoinEvictSide &s, int32_t i,
                                      int32_t cutoff) {
    return s.code[i] < HS_JOIN_SENT && s.ts[i] >= cutoff;
}

__global__ void count_kernel(HsJoinEvictArgs a, int32_t tiles,
                             int32_t *tsum) {
    __shared__ uint32_t smem[32];
    const HsJoinEvictSide &s = a.s[blockIdx.y];
    const int32_t i = blockIdx.x * hsjoin::kTile + threadIdx.x;
    const uint32_t v = (i < a.cap && alive(s, i, a.cutoff)) ? 1u : 0u;
    uint32_t tot;
    hsjoin::block_incl_scan(v, smem, &tot);
    if (threadIdx.x == 0)
        tsum[(size_t)blockIdx.y * tiles + blockIdx.x] = (int32_t)tot;
}

__global__ void move_kernel(HsJoinEvictArgs a, int32_t tiles,
                            const int32_t *tsum) {
    __shared__ uint32_t smem[32];
    const HsJoinEvictSide &s = a.s[blockIdx.y];
    const int32_t i = blockIdx.x * hsjoin::kTile + threadIdx.x;
    const bool live = i < a.cap && alive(s, i, a.cutoff);
    uint32_t tot;
    const uint32_t incl =
        hsjoin::block_incl_scan(live ? 1u : 0u, smem, &tot);
    if (i >= a.cap) return;
    const int32_t before = (int32_t)(incl - (live ? 1u : 0u))
        + tsum[(size_t)blockIdx.y * tiles + blockIdx.x];
    const int32_t n_live = a.n_out[blockIdx.y];
    const int32_t pos = live ? before : n_live + (i - before);
    s.out_code[pos] = live ? s.code[i] : HS_JOIN_SENT;
    s.out_ts[pos] = live ? hsjoin::wrap_sub(s.ts[i], a.delta) : 0;
    s.out_flags[pos] = s.flags[i];
    for (int32_t c = 0; c < s.n_cols; ++c)
        s.out_cols[(size_t)c * a.cap + pos] = s.cols[(size_t)c * a.cap + i];
}

}  // namespace

extern "C" int64_t hs_join_evict_scratch_bytes(int32_t cap) {
    const int32_t tiles = (cap + hsjoin::kTile - 1) / hsjoin::kTile;
    return (int64_t)2 * tiles * (int64_t)sizeof(int32_t);
}

extern "C" int hs_join_evict(const HsJoinEvictArgs *args, void *stream) {
    const HsJoinEvictArgs a = *args;
    cudaStream_t st = (cudaStream_t)stream;
    if (a.cap <= 0 || a.s[0].n_cols < 0 || a.s[1].n_cols < 0 ||
        a.s[0].n_cols > HS_JOIN_MAX_COLS || a.s[1].n_cols > HS_JOIN_MAX_COLS)
        return (int)cudaErrorInvalidValue;
    const int32_t tiles = (a.cap + hsjoin::kTile - 1) / hsjoin::kTile;
    int32_t *tsum = (int32_t *)a.scratch;
    const dim3 grid(tiles, 2);
    count_kernel<<<grid, hsjoin::kTile, 0, st>>>(a, tiles, tsum);
    hsjoin::scan_tiles_kernel<<<2, hsjoin::kTile, 0, st>>>(tsum, tiles,
                                                          a.n_out);
    move_kernel<<<grid, hsjoin::kTile, 0, st>>>(a, tiles, tsum);
    return (int)cudaGetLastError();
}
