// Interval-join probe: the batch against the other side's sorted store,
// in two modes.
//
// Replaces, in hstream_tpu/engine/lattice.py:
//   * pack (HS_JOIN_PACK): _join_probe (:939-959), the probe half of
//     join_probe_insert (:984-998) and all of join_probe_only
//     (:1001-1013). The packed match buffer int32 [5 + nm + no,
//     match_cap]: row 0 zero but [0] = the true match total (it may
//     exceed match_cap; the host then re-probes wider), row 1 the inner
//     key id, row 2 the joined ts = max of the pair, rows 3/4 both
//     sides' flags, then the probing side's and the stored side's
//     columns; columns past min(total, match_cap) are zero.
//   * feed (HS_JOIN_FEED): _join_match_feed (:1016-1079), the probe half
//     of join_probe_insert_step (:1082-1128). The inner window step's
//     inputs written straight into scratch columns of width match_cap:
//     key id, ts = joined ts + ts_off (int32 wrap), valid with the
//     filter-NULL records masked out, each inner column resolved from
//     "m" (the batch), "o" (the store), or "both" / "both_o" (left-side
//     precedence by the present bit: the batch, or the store, is the SQL
//     left side), bool columns as != 0, and each __null_a{i} mask as the
//     OR of its referenced null bits. As in the reference, a column past
//     the matches reads the clipped last record and store entry 0 (its
//     valid bit is clear). The wrapper then runs the window step
//     (expr.cu, scatter.cu, topk.cu) on these columns: matches never
//     leave the card.
//
// Both modes share join_core.cuh's bounds (two binary searches per
// record), the tiled scan of the match counts and the per-match binary
// search of that scan: no sort. Matches come out ordered by batch
// record, then by store order, as the reference's.
//
// Bound on the H100: bytes (the batch read once, the match columns
// written once; the store's search paths mostly hit L2). Launches: the
// bounds, the tile scan, the count scan, the expansion.

#include <cuda_runtime.h>

#include "join_core.cuh"

namespace {

__device__ __forceinline__ int32_t mcol(const HsJoinProbeArgs &a, int32_t c,
                                        int32_t rec) {
    return a.batch[(size_t)(4 + c) * a.bcap + rec];
}

__device__ __forceinline__ int32_t ocol(const HsJoinProbeArgs &a, int32_t c,
                                        int32_t oidx) {
    return a.o_cols[(size_t)c * a.cap + oidx];
}

// the joined ts: max of the pair, 0 past the matches
__device__ __forceinline__ int32_t joined_ts(const HsJoinProbeArgs &a,
                                             bool mvalid, int32_t rec,
                                             int32_t oidx) {
    return mvalid ? max(a.batch[a.bcap + rec], a.o_ts[oidx]) : 0;
}

__global__ void pack_kernel(HsJoinProbeArgs a, const int32_t *lo,
                            const int32_t *cnt, const int32_t *ccnt,
                            const int32_t *total_p) {
    const int32_t j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= a.match_cap) return;
    const int32_t total = *total_p;
    int32_t rec, oidx;
    const bool mv =
        hsjoin::match_of(a, lo, cnt, ccnt, total, j, &rec, &oidx);
    const size_t w = (size_t)a.match_cap;
    int32_t *out = a.packed;
    out[j] = j == 0 ? total : 0;
    out[w + j] = mv ? a.batch[2 * a.bcap + rec] : 0;
    out[2 * w + j] = joined_ts(a, mv, rec, oidx);
    out[3 * w + j] = mv ? a.batch[3 * a.bcap + rec] : 0;
    out[4 * w + j] = mv ? a.o_flags[oidx] : 0;
    for (int32_t c = 0; c < a.n_cols_mine; ++c)
        out[(5 + c) * w + j] = mv ? mcol(a, c, rec) : 0;
    for (int32_t c = 0; c < a.n_cols_other; ++c)
        out[(5 + a.n_cols_mine + c) * w + j] = mv ? ocol(a, c, oidx) : 0;
}

// the SQL left side's present bit of a "both" / "both_o" reference
__device__ __forceinline__ bool left_present(const HsJoinRef &r,
                                             int32_t mflags,
                                             int32_t oflags) {
    if (r.src == HS_JOIN_BOTH) return (mflags >> (2 * r.jm + 1)) & 1;
    return (oflags >> (2 * r.jo + 1)) & 1;
}

__device__ __forceinline__ bool null_bit(const HsJoinRef &r, int32_t mflags,
                                         int32_t oflags) {
    const bool mnull = r.jm >= 0 && ((mflags >> (2 * r.jm)) & 1);
    const bool onull = r.jo >= 0 && ((oflags >> (2 * r.jo)) & 1);
    if (r.src == HS_JOIN_M) return mnull;
    if (r.src == HS_JOIN_O) return onull;
    const bool lp = left_present(r, mflags, oflags);
    return r.src == HS_JOIN_BOTH ? (lp ? mnull : onull)
                                 : (lp ? onull : mnull);
}

__device__ __forceinline__ int32_t raw_value(const HsJoinProbeArgs &a,
                                             const HsJoinRef &r, int32_t rec,
                                             int32_t oidx, int32_t mflags,
                                             int32_t oflags) {
    const int32_t mv = r.jm >= 0 ? mcol(a, r.jm, rec) : 0;
    const int32_t ov = r.jo >= 0 ? ocol(a, r.jo, oidx) : 0;
    if (r.src == HS_JOIN_M) return mv;
    if (r.src == HS_JOIN_O) return ov;
    const bool lp = left_present(r, mflags, oflags);
    return r.src == HS_JOIN_BOTH ? (lp ? mv : ov) : (lp ? ov : mv);
}

__global__ void feed_kernel(HsJoinProbeArgs a, const int32_t *lo,
                            const int32_t *cnt, const int32_t *ccnt,
                            const int32_t *total_p) {
    const int32_t j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= a.match_cap) return;
    int32_t rec, oidx;
    const bool mv =
        hsjoin::match_of(a, lo, cnt, ccnt, *total_p, j, &rec, &oidx);
    // the reference gathers flags and columns at the clipped record and
    // at store entry 0 past the matches, unmasked
    const int32_t mflags = a.batch[3 * a.bcap + rec];
    const int32_t oflags = a.o_flags[oidx];
    a.kid[j] = mv ? a.batch[2 * a.bcap + rec] : 0;
    a.ts[j] = hsjoin::wrap_add(joined_ts(a, mv, rec, oidx), a.ts_off);
    bool valid = mv;
    for (int32_t k = 0; k < a.filter_count; ++k)
        valid = valid && !null_bit(a.refs[a.filter_first + k], mflags,
                                   oflags);
    a.valid[j] = valid ? 1 : 0;
    for (int32_t f = 0; f < a.n_feed; ++f) {
        const HsJoinFeedCol &fc = a.feed[f];
        const int32_t raw = raw_value(a, fc.ref, rec, oidx, mflags, oflags);
        if (fc.tag == HS_JOIN_BOOL)
            ((uint8_t *)fc.out)[j] = raw != 0 ? 1 : 0;
        else
            ((int32_t *)fc.out)[j] = raw;  // f32 bits or int32
    }
    for (int32_t q = 0; q < a.n_nulls; ++q) {
        const HsJoinNull &nl = a.nulls[q];
        bool m = false;
        for (int32_t k = 0; k < nl.count; ++k)
            m = m || null_bit(a.refs[nl.first + k], mflags, oflags);
        nl.out[j] = m ? 1 : 0;
    }
}

}  // namespace

extern "C" int64_t hs_join_probe_scratch_bytes(int32_t bcap) {
    return (int64_t)(hsjoin::probe_scratch_words(bcap) * sizeof(int32_t));
}

extern "C" int hs_join_probe(const HsJoinProbeArgs *args, void *stream) {
    const HsJoinProbeArgs a = *args;
    cudaStream_t s = (cudaStream_t)stream;
    if (a.bcap <= 0 || a.cap <= 0 || a.match_cap <= 0 ||
        a.n_cols_mine < 0 || a.n_cols_mine > HS_JOIN_MAX_COLS ||
        a.n_cols_other < 0 || a.n_cols_other > HS_JOIN_MAX_COLS ||
        a.n_feed < 0 || a.n_feed > HS_JOIN_MAX_FEED || a.n_nulls < 0 ||
        a.n_nulls > HS_JOIN_MAX_NULLS)
        return (int)cudaErrorInvalidValue;
    const int32_t tiles = (a.bcap + hsjoin::kTile - 1) / hsjoin::kTile;
    int32_t *lo = (int32_t *)a.scratch;
    int32_t *cnt = lo + a.bcap;
    int32_t *ccnt = cnt + a.bcap;
    int32_t *tsum = ccnt + a.bcap;
    int32_t *total = tsum + tiles;
    hsjoin::bounds_kernel<<<tiles, hsjoin::kTile, 0, s>>>(a, lo, cnt, tsum);
    hsjoin::scan_tiles_kernel<<<1, hsjoin::kTile, 0, s>>>(tsum, tiles, total);
    hsjoin::ccnt_kernel<<<tiles, hsjoin::kTile, 0, s>>>(a.bcap, cnt, tsum, ccnt);
    const int32_t blocks = (a.match_cap + 255) / 256;
    if (a.mode == HS_JOIN_PACK)
        pack_kernel<<<blocks, 256, 0, s>>>(a, lo, cnt, ccnt, total);
    else
        feed_kernel<<<blocks, 256, 0, s>>>(a, lo, cnt, ccnt, total);
    return (int)cudaGetLastError();
}
