// The tile offsets of a single-pass scan, shared by the touched
// extract's compaction (touched.cu) and the join probe's count scan
// (join_core.cuh): tiles take their index in launch order from a ticket
// and publish their count in a 64-bit status word (a flag bit, 62 value
// bits); a tile's exclusive prefix is the sum of its predecessors'
// counts. The status words start zeroed (a memset or a kernel before
// the launch, in the same stream).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace hs {

constexpr unsigned long long kAgg = 1ull << 62;    // status: count known
constexpr unsigned long long kVal = (1ull << 62) - 1;

// the exclusive prefix of tile `tile`, every thread of the block calling
// (blockDim.x a multiple of 32; s: 32 words of shared memory): publish
// the tile's count, then sum every predecessor's, blockDim.x status
// words a round with their loads in flight together, waiting only on
// counts not yet published. No chain of inclusive prefixes: the tiles
// of a wave finish at about the same time. The rounds go 32 at a time,
// so each has a bit of its own in the mask of those still to wait on.
__device__ inline long long look_back(uint64_t *status64, int tile,
                                      long long count, long long *s) {
    unsigned long long *status = (unsigned long long *)status64;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int step = blockDim.x;
    if (t == 0)
        atomicExch(&status[tile], kAgg | (unsigned long long)count);
    long long v = 0;
    for (int c = t; c < tile; c += 32 * step) {
        const int c1 = min(tile, c + 32 * step);
        unsigned pending = 0;  // rounds whose count was not yet published
#pragma unroll 4
        for (int p = c, r = 0; p < c1; p += step, ++r) {
            const unsigned long long st =
                *(volatile unsigned long long *)&status[p];
            if ((st >> 62) != 0) v += (long long)(st & kVal);
            else pending |= 1u << r;
        }
        for (int p = c, r = 0; pending != 0; p += step, ++r) {
            if (!((pending >> r) & 1u)) continue;
            unsigned long long st;
            do {
                st = *(volatile unsigned long long *)&status[p];
            } while ((st >> 62) == 0);
            v += (long long)(st & kVal);
            pending &= ~(1u << r);
        }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
        v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
    if (lane == 0) s[warp] = v;
    __syncthreads();
    long long excl = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) excl += s[w];
    __syncthreads();
    return excl;
}

}  // namespace hs
