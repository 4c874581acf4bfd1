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
//     columns; columns past min(total, match_cap) are zero. Its rows lie
//     `pitch` apart: a key shard of a mesh writes its columns of the
//     mesh's [rows, n_shards * match_cap] buffer (parallel/lattice.py).
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
// The key shards of a mesh whose stores lie on one card (hs_join_probe_
// table; hstream_tpu/parallel/lattice.py:394-439 probe_insert /
// probe_only, :470-528 probe_insert_step) probe in one launch sequence
// over the table of their stores: the batch's valid records grouped
// once by owner (join_group.cu), each group searching only its own
// shard's store, each shard's matches written from its own first column
// (pack: shard s's columns [s * match_cap, ...) of the mesh's [rows,
// n_shards * match_cap] buffer, its header at the first) or feed entry
// (shard s's segment of one feed: the reference's all_gather is
// addressing), its total exact. One store takes the template's false
// branch, today's code.

// Both modes share join_core.cuh's probe: the bounds per tile of sorted
// records against a staged store window, the count scan by a decoupled
// look-back in the same launch, and the expansion by a load-balancing
// search, with this file's writers. Matches come out ordered by batch
// record, then by store order, as the reference's.
//
// Bound on the H100: bytes (the batch read once, the match columns
// written once; the store's search paths are the windows the tiles
// read). Launches: the tiles' store windows (which also zero the scan's
// ticket and status words), the bounds and scan, the expansion; a
// table's grouping (join_group.cu) before them, shared with the insert.

#include <cuda_runtime.h>

#include "device.cuh"
#include "join_core.cuh"

namespace {

__device__ __forceinline__ int32_t mcol(const HsJoinProbeArgs &a, int32_t c,
                                        int32_t rec) {
    return a.batch[(size_t)(4 + c) * a.bcap + rec];
}

using hsjoin::StoreView;

__device__ __forceinline__ int32_t ocol(const HsJoinProbeArgs &a,
                                        const StoreView &o, int32_t c,
                                        int32_t oidx) {
    return o.cols[(size_t)c * a.cap + oidx];
}

// the joined ts: max of the pair, 0 past the matches
__device__ __forceinline__ int32_t joined_ts(const HsJoinProbeArgs &a,
                                             const StoreView &o,
                                             bool mvalid, int32_t rec,
                                             int32_t oidx) {
    return mvalid ? max(a.batch[a.bcap + rec], o.ts[oidx]) : 0;
}

// pack mode's writer: match j's columns of the packed buffer, from
// column `at` on
struct PackEmit {
    __device__ __forceinline__ void operator()(const HsJoinProbeArgs &a,
                                               const StoreView &o,
                                               int64_t at, int32_t j,
                                               bool mv, int32_t rec,
                                               int32_t oidx,
                                               int32_t total) const {
        const size_t w = (size_t)a.pitch;
        int32_t *out = a.packed + at;
        out[j] = j == 0 ? total : 0;
        out[w + j] = mv ? a.batch[2 * a.bcap + rec] : 0;
        out[2 * w + j] = joined_ts(a, o, mv, rec, oidx);
        out[3 * w + j] = mv ? a.batch[3 * a.bcap + rec] : 0;
        out[4 * w + j] = mv ? o.flags[oidx] : 0;
        for (int32_t c = 0; c < a.n_cols_mine; ++c)
            out[(5 + c) * w + j] = mv ? mcol(a, c, rec) : 0;
        for (int32_t c = 0; c < a.n_cols_other; ++c)
            out[(5 + a.n_cols_mine + c) * w + j] =
                mv ? ocol(a, o, c, oidx) : 0;
    }
};

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
                                             const StoreView &o,
                                             const HsJoinRef &r, int32_t rec,
                                             int32_t oidx, int32_t mflags,
                                             int32_t oflags) {
    const int32_t mv = r.jm >= 0 ? mcol(a, r.jm, rec) : 0;
    const int32_t ov = r.jo >= 0 ? ocol(a, o, r.jo, oidx) : 0;
    if (r.src == HS_JOIN_M) return mv;
    if (r.src == HS_JOIN_O) return ov;
    const bool lp = left_present(r, mflags, oflags);
    return r.src == HS_JOIN_BOTH ? (lp ? mv : ov) : (lp ? ov : mv);
}

// feed mode's writer: match j's inner-step inputs, at entry at + j
struct FeedEmit {
    __device__ __forceinline__ void operator()(const HsJoinProbeArgs &a,
                                               const StoreView &o,
                                               int64_t at, int32_t jj,
                                               bool mv, int32_t rec,
                                               int32_t oidx, int32_t) const {
        // the reference gathers flags and columns at the clipped record
        // and at store entry 0 past the matches, unmasked; the flags only
        // where a column, mask or filter reads them
        const int64_t j = at + jj;
        const bool flags = a.n_feed + a.n_nulls + a.filter_count > 0;
        const int32_t mflags = flags ? a.batch[3 * a.bcap + rec] : 0;
        const int32_t oflags = flags ? o.flags[oidx] : 0;
        a.kid[j] = mv ? a.batch[2 * a.bcap + rec] : 0;
        a.ts[j] = hsjoin::wrap_add(joined_ts(a, o, mv, rec, oidx), a.ts_off);
        bool valid = mv;
        for (int32_t k = 0; k < a.filter_count; ++k)
            valid = valid && !null_bit(a.refs[a.filter_first + k], mflags,
                                       oflags);
        a.valid[j] = valid ? 1 : 0;
        for (int32_t f = 0; f < a.n_feed; ++f) {
            const HsJoinFeedCol &fc = a.feed[f];
            const int32_t raw =
                raw_value(a, o, fc.ref, rec, oidx, mflags, oflags);
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
};

}  // namespace

extern "C" int64_t hs_join_probe_scratch_bytes(int32_t bcap,
                                               int32_t match_cap) {
    return (int64_t)(hsjoin::probe_scratch_words(bcap, match_cap) *
                     sizeof(int32_t));
}

extern "C" int64_t hs_join_probe_table_scratch_bytes(int32_t bcap,
                                                     int32_t match_cap,
                                                     int32_t n_group) {
    return (int64_t)(hsjoin::probe_scratch_words(bcap, match_cap, n_group) *
                     sizeof(int32_t));
}

namespace {

bool probe_args_ok(const HsJoinProbeArgs &a) {
    return !(a.bcap <= 0 || a.cap <= 0 || a.match_cap <= 0 ||
             a.n_cols_mine < 0 || a.n_cols_mine > HS_JOIN_MAX_COLS ||
             a.n_cols_other < 0 || a.n_cols_other > HS_JOIN_MAX_COLS ||
             a.n_feed < 0 || a.n_feed > HS_JOIN_MAX_FEED || a.n_nulls < 0 ||
             a.n_nulls > HS_JOIN_MAX_NULLS ||
             (a.mode == HS_JOIN_PACK && a.pitch < a.match_cap) ||
             a.branch < HS_PROBE_AUTO || a.branch > HS_PROBE_WHOLE);
}

// the three launches over `places` record places (a table's grouping's,
// or the batch's), the expansion over n_group groups
template <bool kT>
int probe_launch(const HsJoinProbeArgs &a, const hsjoin::TableArg<kT> &tb,
                 const hsjoin::ProbeScratch &s, int64_t places, int n_group,
                 cudaStream_t st) {
    const int32_t tiles = hsjoin::bounds_tiles(places);
    hsjoin::probe_window_kernel<kT><<<
        (tiles + hsjoin::kWindowTiles - 1) / hsjoin::kWindowTiles,
        64 * hsjoin::kWindowTiles, 0, st>>>(a, tb, s);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    int sms = 0;
    err = (int)hs::current_sms(&sms);
    if (err != 0) return err;
    const int32_t window = hsjoin::window_cap(tiles, sms);
    const size_t smem = (size_t)window * sizeof(uint64_t);
    // the window and the kernel's static words may pass the default
    // 48 KB together even where the window alone does not
    const int max_smem = hsjoin::kWindowMax * (int)sizeof(uint64_t);
    static std::atomic<uint64_t> granted{0};
    err = (int)hs::allow_smem(granted, hsjoin::probe_bounds_kernel<kT>,
                              max_smem);
    if (err != 0) return err;
    hsjoin::probe_bounds_kernel<kT>
        <<<tiles, hsjoin::kBoundsThreads, smem, st>>>(a, tb, s, window);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    // the merge tiles cover min(total, match_cap) + n items at most
    const dim3 merge((unsigned)s.merge_tiles, (unsigned)n_group);
    if (a.mode == HS_JOIN_PACK)
        hsjoin::probe_expand_kernel<kT, PackEmit>
            <<<merge, hsjoin::kExpThreads, 0, st>>>(a, tb, s, PackEmit{});
    else
        hsjoin::probe_expand_kernel<kT, FeedEmit>
            <<<merge, hsjoin::kExpThreads, 0, st>>>(a, tb, s, FeedEmit{});
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hs_join_probe(const HsJoinProbeArgs *args, void *stream) {
    const HsJoinProbeArgs &a = *args;
    if (!probe_args_ok(a)) return (int)cudaErrorInvalidValue;
    const hsjoin::ProbeScratch s =
        hsjoin::probe_scratch(a.scratch, a.bcap, a.match_cap);
    return probe_launch<false>(a, hsjoin::NoTable{}, s, a.bcap, 1,
                               (cudaStream_t)stream);
}

// the table's probe: the caller grouped the batch for this table
// (hs_join_group); a.o_* are not read, a.packed / a.kid, a.ts, a.valid
// and the feed's columns are the buffers every shard writes from its
// `at` on
extern "C" int hs_join_probe_table(const HsJoinProbeArgs *args,
                                   const HsJoinTable *table, void *stream) {
    const HsJoinProbeArgs &a = *args;
    const HsJoinTable &t = *table;
    if (!probe_args_ok(a) || t.n_group < 1 || t.n_group > HS_JOIN_GROUP ||
        t.grouping == nullptr)
        return (int)cudaErrorInvalidValue;
    for (int g = 0; g < t.n_group; ++g)
        if (t.sh[g].at < 0 || t.sh[g].at % a.match_cap != 0)
            return (int)cudaErrorInvalidValue;
    const hsjoin::ProbeScratch s =
        hsjoin::probe_scratch(a.scratch, a.bcap, a.match_cap, t.n_group);
    return probe_launch<true>(a, t, s,
                              hsjoin::group_places(a.bcap, t.n_group),
                              t.n_group, (cudaStream_t)stream);
}
