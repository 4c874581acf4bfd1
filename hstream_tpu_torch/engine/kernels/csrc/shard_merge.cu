// Snapshot merge of the sharded window lattice: each plane's D partials
// reduced elementwise into the canonical single-card plane, key shards
// side by side in global key order, every plane of a capture in one
// launch.
//
// Replaces hstream_tpu/engine/snapshot.py:258-283 _merge_partials (the
// jnp.sum / min / max / any over the leading data axis). The merge kind
// is the plane's monoid (engine/lattice.py plane_merge_kinds): int32 and
// float32 sums (float32 in data-shard order, d = 0 first, as the merged
// close adds them), float32 min and max, int32 max (slot_start), int8
// max (HLL registers) and the bool any of `touched` (a max of 0/1
// bytes). TOPK planes have no elementwise merge and are refused on the
// host before this is reached.
//
// Bound on the H100: bytes. Each partial's plane read once, the
// canonical plane written once: 9.4 MB for config 1's capture over
// four partials (K = 1024, W = 3, 1 KiB of HLL registers a cell).
//
// What held the first design back: a launch a plane (five for
// config 1's capture, five launch floors), each thread an element in a
// grid-stride loop, so the int8 HLL plane and the bool flags (~9 of the
// 9.4 MB) moved one byte a thread, each thread looping ~17 times.
//
// Design: one launch a capture over a table of segments on the card
// (HsMergeSeg, built by the host and uploaded again only when a
// pointer or a size changed), a segment a (plane, key shard) and
// slot_start one of key shard 0. The blocks are given to the segments
// by their bytes, HS_MERGE_CHUNKS 16-byte chunks a block, so the HLL
// plane's blocks do not wait behind the small planes'. A thread takes
// HS_MERGE_PER chunks: it loads its chunks of kD partials at once
// (their pointers from the partial table, HsParts.tab), merges each
// 32-bit word (int8 registers by __vmaxs4, the flags by __vmaxu4, int32
// by a wrapping add or a max, float32 by __fadd_rn in data-shard order
// or fminf / fmaxf) and writes 16-byte stores. A segment's tail past a
// multiple of 16 bytes, and a segment whose output is not 16-byte
// aligned (a key shard's flags of Kl * W bytes, not a multiple of 16),
// go element by element.

#include <cuda_runtime.h>

#include "hs_kernels.h"
#include "merge.cuh"

namespace {

constexpr int kBlock = HS_MERGE_THREADS;
constexpr int kPer = HS_MERGE_PER;
constexpr int kD = 4;   // partials a thread loads before it combines them

// one 32-bit word of partial d merged into acc: four int8 (HLL) or four
// bool bytes, or one int32 or float32 element
template <int kType, int kKind>
__device__ __forceinline__ uint32_t merge_word(uint32_t acc, uint32_t x) {
    if (kType == HS_MERGE_I8) return __vmaxs4(acc, x);
    if (kType == HS_MERGE_U8) return __vmaxu4(acc, x);
    if (kType == HS_MERGE_I32)   // slot_start by max, counts by a
        return kKind == HS_MERGE_MAX   // wrapping add, as XLA's
            ? (uint32_t)max((int)acc, (int)x) : acc + x;
    const float a = __uint_as_float(acc), v = __uint_as_float(x);
    return __float_as_uint(kKind == HS_MERGE_MIN   ? fminf(a, v)
                           : kKind == HS_MERGE_MAX ? fmaxf(a, v)
                                                   : __fadd_rn(a, v));
}

template <int kType, int kKind>
__device__ __forceinline__ uint4 merge_vec(uint4 acc, uint4 x) {
    return make_uint4(merge_word<kType, kKind>(acc.x, x.x),
                      merge_word<kType, kKind>(acc.y, x.y),
                      merge_word<kType, kKind>(acc.z, x.z),
                      merge_word<kType, kKind>(acc.w, x.w));
}

// bytes [lo, hi) of the segment, element by element (a byte element in
// a word's low byte: the merges of the others leave it alone)
template <int kType, int kKind>
__device__ void merge_elems(const HsParts &P, const HsMergeSeg &sg,
                            char *out, int64_t lo, int64_t hi) {
    constexpr int kSize =
        kType == HS_MERGE_I32 || kType == HS_MERGE_F32 ? 4 : 1;
    for (int64_t b = lo; b < hi; b += kSize) {
        uint32_t acc = 0u;
        for (int d = 0; d < P.n_data; ++d) {
            const char *src =
                (const char *)hs::part_plane(P, sg.shard, d, sg.plane) + b;
            const uint32_t x = kSize == 4 ? *(const uint32_t *)src
                                          : (uint32_t)*(const uint8_t *)src;
            acc = d == 0 ? x : merge_word<kType, kKind>(acc, x);
        }
        if (kSize == 4) *(uint32_t *)(out + b) = acc;
        else out[b] = (char)(acc & 0xFFu);
    }
}

// the block's chunks of its segment
template <int kType, int kKind>
__device__ __forceinline__ void merge_seg(const HsShardMergeArgs &a,
                                          const HsMergeSeg &sg) {
    const HsParts &P = a.parts;
    const int D = P.n_data;
    const int64_t first =
        ((int64_t)(blockIdx.x - sg.block0) * HS_MERGE_CHUNKS + threadIdx.x) *
        16;
    char *out = (char *)a.out[sg.plane] + sg.out_off;
    if (!sg.vec) {
        for (int i = 0; i < kPer; ++i) {
            const int64_t off = first + (int64_t)i * kBlock * 16;
            if (off < sg.bytes)
                merge_elems<kType, kKind>(P, sg, out, off,
                                          min(off + 16, sg.bytes));
        }
        return;
    }
    uint4 acc[kPer];
    for (int d0 = 0; d0 < D; d0 += kD) {
        uint4 x[kD][kPer];
#pragma unroll
        for (int j = 0; j < kD; ++j) {
            const char *src = d0 + j < D
                ? (const char *)hs::part_plane(P, sg.shard, d0 + j, sg.plane)
                : nullptr;
#pragma unroll
            for (int i = 0; i < kPer; ++i) {
                const int64_t off = first + (int64_t)i * kBlock * 16;
                x[j][i] = src != nullptr && off + 16 <= sg.bytes
                    ? *(const uint4 *)(src + off)
                    : make_uint4(0u, 0u, 0u, 0u);
            }
        }
#pragma unroll
        for (int j = 0; j < kD; ++j) {
            if (d0 + j >= D) break;
#pragma unroll
            for (int i = 0; i < kPer; ++i)
                acc[i] = d0 + j == 0 ? x[j][i]
                                     : merge_vec<kType, kKind>(acc[i],
                                                               x[j][i]);
        }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
        const int64_t off = first + (int64_t)i * kBlock * 16;
        if (off + 16 <= sg.bytes)
            *(uint4 *)(out + off) = acc[i];
        else if (off < sg.bytes)   // the tail, past a multiple of 16
            merge_elems<kType, kKind>(P, sg, out, off, sg.bytes);
    }
}

__global__ void __launch_bounds__(kBlock)
shard_merge_kernel(const __grid_constant__ HsShardMergeArgs a) {
    const HsMergeSeg sg = a.seg[a.block_seg[blockIdx.x]];
    switch (sg.dtype * 3 + sg.kind) {
    case HS_MERGE_I32 * 3 + HS_MERGE_SUM:
        merge_seg<HS_MERGE_I32, HS_MERGE_SUM>(a, sg);
        break;
    case HS_MERGE_I32 * 3 + HS_MERGE_MAX:
        merge_seg<HS_MERGE_I32, HS_MERGE_MAX>(a, sg);
        break;
    case HS_MERGE_F32 * 3 + HS_MERGE_SUM:
        merge_seg<HS_MERGE_F32, HS_MERGE_SUM>(a, sg);
        break;
    case HS_MERGE_F32 * 3 + HS_MERGE_MIN:
        merge_seg<HS_MERGE_F32, HS_MERGE_MIN>(a, sg);
        break;
    case HS_MERGE_F32 * 3 + HS_MERGE_MAX:
        merge_seg<HS_MERGE_F32, HS_MERGE_MAX>(a, sg);
        break;
    case HS_MERGE_I8 * 3 + HS_MERGE_MAX:
        merge_seg<HS_MERGE_I8, HS_MERGE_MAX>(a, sg);
        break;
    case HS_MERGE_U8 * 3 + HS_MERGE_MAX:
        merge_seg<HS_MERGE_U8, HS_MERGE_MAX>(a, sg);
        break;
    default:   // no plane merges so (the host refuses it)
        break;
    }
}

}  // namespace

extern "C" int hs_shard_merge(const HsShardMergeArgs *args, void *stream) {
    const HsShardMergeArgs &a = *args;
    const HsParts &P = a.parts;
    if (a.n_seg == 0 || a.n_blocks == 0) return 0;
    if (a.n_seg < 0 || a.n_blocks < 0 || a.seg == nullptr ||
        a.block_seg == nullptr || P.tab == nullptr || P.n_data < 1 ||
        P.n_key < 1 || P.n_planes < 3 || P.n_planes > HS_MERGE_PLANES)
        return (int)cudaErrorInvalidValue;
    shard_merge_kernel<<<(unsigned)a.n_blocks, kBlock, 0,
                         (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
