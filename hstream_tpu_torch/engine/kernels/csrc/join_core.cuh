// The interval join's shared core: (code, ts) binary searches, the block
// scans with carries, and the probe's bounds and match expansion, which
// the pack and feed modes of join_probe.cu share.
//
// The reference (hstream_tpu/engine/lattice.py:884-936, _join_bounds and
// _join_match_arrays) ranks the batch's lower and upper query keys among
// the store entries with one tagged 3-key sort, then expands the spans
// with a cumsum and a searchsorted. Here the store is known to be sorted
// by (code, ts) (every program that writes it keeps it so), so each
// valid record finds its two bounds with two binary searches:
//   lo = #entries with (code, ts) <  (qcode, max(ts - within, cutoff))
//   hi = #entries with (code, ts) <= (qcode, ts + within)
// (the tag 0 / tag 2 tie-breaks of the reference's sort), with ts -+
// within wrapping as int32 like jnp. The counts are scanned in tiles of
// 1024 (a block scan per tile, the tile totals scanned by one block with
// a running carry, the carries added back), and each match j finds its
// record with a binary search of the inclusive scan,
// searchsorted(ccnt, j, 'right'), clipped to the last record.
//
// Bound on the H100: bytes. A probe reads the batch once and writes the
// match columns once; the searches touch log2(cap) store entries per
// record, mostly from L2.
//
// Device functions in this header are `inline` (it is included by more
// than one translation unit).

#pragma once

#include <cuda_runtime.h>

#include "hs_kernels.h"

namespace hsjoin {

constexpr int kTile = 1024;  // elements per scan tile = threads per block

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a - (uint32_t)b);
}

// (c, t) < (qc, qt), or <= with `inclusive`
__device__ __forceinline__ bool key_before(int32_t c, int32_t t, int32_t qc,
                                           int32_t qt, bool inclusive) {
    return c < qc || (c == qc && (inclusive ? t <= qt : t < qt));
}

// number of store entries before (qc, qt): the store is sorted by (code, ts)
__device__ inline int32_t count_before(const int32_t *code,
                                       const int32_t *ts, int32_t len,
                                       int32_t qc, int32_t qt,
                                       bool inclusive) {
    int32_t lo = 0, hi = len;
    while (lo < hi) {
        const int32_t mid = lo + ((hi - lo) >> 1);
        if (key_before(code[mid], ts[mid], qc, qt, inclusive)) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// the batch entry j's key: padding and codes at or above the sentinel
// are keyed as the sentinel (the reference's bvalid mask)
__device__ __forceinline__ int32_t batch_code(const int32_t *bcode,
                                              int32_t j, int32_t n) {
    const int32_t c = bcode[j];
    return (j < n && c < HS_JOIN_SENT) ? c : HS_JOIN_SENT;
}

// number of batch entries before (qc, qt), the batch being sorted by its
// keys (batch_code, ts)
__device__ inline int32_t count_batch_before(const int32_t *bcode,
                                             const int32_t *bts,
                                             int32_t bcap, int32_t n,
                                             int32_t qc, int32_t qt,
                                             bool inclusive) {
    int32_t lo = 0, hi = bcap;
    while (lo < hi) {
        const int32_t mid = lo + ((hi - lo) >> 1);
        if (key_before(batch_code(bcode, mid, n), bts[mid], qc, qt,
                       inclusive))
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo;
}

__device__ __forceinline__ uint32_t warp_incl_scan(uint32_t v) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const uint32_t u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
    }
    return v;
}

// inclusive scan over the block (all threads call it; blockDim.x a
// multiple of 32); *total gets the block's sum. smem: 32 words.
__device__ inline uint32_t block_incl_scan(uint32_t v, uint32_t *smem,
                                           uint32_t *total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    uint32_t x = warp_incl_scan(v);
    if (lane == 31) smem[warp] = x;
    __syncthreads();
    if (warp == 0) {
        uint32_t s = lane < nw ? smem[lane] : 0u;
        s = warp_incl_scan(s);
        if (lane < nw) smem[lane] = s;
    }
    __syncthreads();
    if (warp > 0) x += smem[warp - 1];
    *total = smem[nw - 1];
    __syncthreads();
    return x;
}

namespace {

// exclusive scan, in place, of the tile totals of segment blockIdx.x
// (tsum + blockIdx.x * ntiles); the segment's grand total goes to
// total[blockIdx.x]. One block per segment walks its tiles in chunks of
// blockDim.x with a running carry. (Kernels here have internal linkage:
// each translation unit that includes the header has its own.)
__global__ void scan_tiles_kernel(int32_t *tsum, int32_t ntiles,
                                  int32_t *total) {
    __shared__ uint32_t smem[32];
    int32_t *seg = tsum + (size_t)blockIdx.x * ntiles;
    uint32_t carry = 0;
    for (int32_t base = 0; base < ntiles; base += blockDim.x) {
        const int32_t i = base + threadIdx.x;
        const uint32_t v = i < ntiles ? (uint32_t)seg[i] : 0u;
        uint32_t tot;
        const uint32_t x = block_incl_scan(v, smem, &tot);
        if (i < ntiles) seg[i] = (int32_t)(carry + x - v);
        carry += tot;
    }
    if (threadIdx.x == 0) total[blockIdx.x] = (int32_t)carry;
}

// per record (kTile threads a block): lo[j], cnt[j] and each tile's count
__global__ void bounds_kernel(HsJoinProbeArgs a, int32_t *lo, int32_t *cnt,
                              int32_t *tsum) {
    __shared__ uint32_t smem[32];
    const int32_t j = blockIdx.x * kTile + threadIdx.x;
    int32_t c = 0;
    if (j < a.bcap) {
        const int32_t qc = a.batch[j];
        const int32_t t = a.batch[a.bcap + j];
        int32_t l = 0;
        if (j < a.n && qc < HS_JOIN_SENT) {
            const int32_t lts = max(wrap_sub(t, a.within), a.cutoff);
            const int32_t hts = wrap_add(t, a.within);
            l = count_before(a.o_code, a.o_ts, a.cap, qc, lts, false);
            const int32_t h = count_before(a.o_code, a.o_ts, a.cap, qc, hts,
                                           true);
            c = max(h - l, 0);
        }
        lo[j] = l;
        cnt[j] = c;
    }
    uint32_t tot;
    block_incl_scan((uint32_t)c, smem, &tot);
    if (threadIdx.x == 0) tsum[blockIdx.x] = (int32_t)tot;
}

// per record (kTile threads a block): the inclusive scan of cnt, the
// tile's carry from the scanned tile totals added
__global__ void ccnt_kernel(int32_t bcap, const int32_t *cnt,
                            const int32_t *tsum, int32_t *ccnt) {
    __shared__ uint32_t smem[32];
    const int32_t j = blockIdx.x * kTile + threadIdx.x;
    const uint32_t v = j < bcap ? (uint32_t)cnt[j] : 0u;
    uint32_t tot;
    const uint32_t x = block_incl_scan(v, smem, &tot);
    if (j < bcap) ccnt[j] = (int32_t)(x + (uint32_t)tsum[blockIdx.x]);
}

}  // namespace

// the match j's record (clipped like the reference's) and store index
// (0 when j is past min(total, match_cap)); returns whether j is a match
__device__ inline bool match_of(const HsJoinProbeArgs &a,
                                const int32_t *lo, const int32_t *cnt,
                                const int32_t *ccnt, int32_t total,
                                int32_t j, int32_t *rec, int32_t *oidx) {
    // searchsorted(ccnt, j, 'right'): the first record with ccnt > j
    int32_t l = 0, h = a.bcap;
    while (l < h) {
        const int32_t mid = l + ((h - l) >> 1);
        if (ccnt[mid] <= j) l = mid + 1;
        else h = mid;
    }
    const int32_t r = min(l, a.bcap - 1);
    *rec = r;
    const bool mvalid = j < min(total, a.match_cap);
    int32_t o = 0;
    if (mvalid) {
        const int32_t start = ccnt[r] - cnt[r];
        o = lo[r] + (j - start);
        o = min(max(o, 0), a.cap - 1);
    }
    *oidx = o;
    return mvalid;
}

// scratch of a probe: lo, cnt, ccnt [bcap], the tile totals, the total
inline size_t probe_scratch_words(int32_t bcap) {
    const int32_t tiles = (bcap + kTile - 1) / kTile;
    return 3 * (size_t)bcap + (size_t)tiles + 1;
}

}  // namespace hsjoin
