// Session remap: compact the arena's key codes through an order-
// preserving lookup table, in place.
//
// Replaces hstream_tpu/engine/lattice.py:1553-1568 session_remap_kernel:
// code < lcap ? lut[clip(code, 0, lcap - 1)] : code, so codes at or
// above lcap (the sentinel among them) pass through, and the arena stays
// sorted by (code, t0). The host maps the codes of keys without a live
// session to the sentinel, so the remap also evicts. A mesh's key-sharded
// arena (hstream_tpu/parallel/lattice.py:730-743) launches it once a
// shard through one residue-preserving table.
//
// With sent_above set it is also the interval join's code remap
// (hstream_tpu/engine/join.py:2092-2108 _remap_device_codes, eager jnp
// there): a code at or above lcap becomes the sentinel 2^22 instead of
// passing through. The join's table is a dense remap in sorted order, so
// the store stays sorted by (code, ts) either way.
//
// Bound on the H100: bytes. The code plane is read once and written once
// (8 bytes a code), the table gathered through the read-only path; for
// the session arena's 2^17 codes that is ~1 MiB, below a launch's floor,
// for the join store's ~2^21 a side ~16 MiB, ~5 us at 3.35 TB/s. The
// first design ran one thread a code with scalar loads and a 256-thread
// block per 256 codes. This one takes four codes a thread through one
// 16-byte load and store where the plane's base allows (the few codes
// before the first 16-byte boundary and after the last whole quad are
// scalar lanes), with a grid sized to the card (its SMs times the blocks
// it keeps resident) and a grid-stride loop past that, so a 2^21 plane
// runs in one wave with several quads in flight a thread.
//
// hs_session_remap_table is the key-sharded arena's remap: one launch a
// card over a table of that card's shards' code planes, all through the
// one table. It replaces the launch a shard (a launch costs ~0.87 us of
// floor, so four shards of 2^15 codes took four floors for ~1 MiB). The
// table lives on the card (cached by the planes' addresses, as the
// merged kernels' partial table is), so any number of shards rides in
// one launch; a row holds a plane's address, its cap, its head (the
// codes before its first 16-byte boundary) and its first quad in one
// flat index space of every shard's quads. A block stages the quads'
// prefix in shared memory (read from the table where it does not fit)
// and finds each quad's shard there; the head and tail codes take eight
// lanes a shard.

#include <cuda_runtime.h>

#include "device.cuh"
#include "hs_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2048 resident threads an SM
// the table launch's quad prefixes staged in shared memory up to here
// (6,143 shards; the default dynamic limit needs no opt-in)
constexpr size_t kStagedBytes = 48 * 1024;

__device__ __forceinline__ int32_t remap_one(int32_t c,
                                             const int32_t *__restrict__ lut,
                                             int32_t lcap,
                                             int32_t sent_above) {
    if (c < lcap) return __ldg(lut + max(c, 0));
    return sent_above ? HS_JOIN_SENT : c;
}

// head: scalar codes before the first 16-byte boundary; n4: whole quads
// after them; the codes past head + 4 * n4 are the scalar tail
__global__ void __launch_bounds__(kThreads)
remap_kernel(int32_t *__restrict__ code, int32_t cap,
             const int32_t *__restrict__ lut, int32_t lcap,
             int32_t sent_above, int32_t head, int32_t n4) {
    const int tid = blockIdx.x * blockDim.x + threadIdx.x;
    const int stride = gridDim.x * blockDim.x;
    int4 *quads = reinterpret_cast<int4 *>(code + head);
    for (int q = tid; q < n4; q += stride) {
        int4 v = quads[q];
        v.x = remap_one(v.x, lut, lcap, sent_above);
        v.y = remap_one(v.y, lut, lcap, sent_above);
        v.z = remap_one(v.z, lut, lcap, sent_above);
        v.w = remap_one(v.w, lut, lcap, sent_above);
        quads[q] = v;
    }
    // at most 3 head and 3 tail codes: the first threads take them
    const int tail0 = head + 4 * n4;
    if (tid < head) code[tid] = remap_one(code[tid], lut, lcap, sent_above);
    if (tid < cap - tail0)
        code[tail0 + tid] =
            remap_one(code[tail0 + tid], lut, lcap, sent_above);
}

// a shard's scalar codes: lanes 0-3 its head, 4-7 its tail
__device__ __forceinline__ void remap_lanes(const int64_t *__restrict__ row,
                                            int32_t lane, int64_t n4,
                                            const int32_t *__restrict__ lut,
                                            int32_t lcap) {
    int32_t *code = reinterpret_cast<int32_t *>(row[HS_REMAP_ADDR]);
    const int32_t cap = (int32_t)row[HS_REMAP_CAP];
    const int32_t head = (int32_t)row[HS_REMAP_HEAD];
    const int32_t at = lane < 4 ? lane
                                : head + 4 * (int32_t)n4 + (lane - 4);
    if (lane < 4 ? lane < head : at < cap)
        code[at] = remap_one(code[at], lut, lcap, 0);
}

// the shard whose quads hold flat quad q: the last s with q0[s] <= q
template <bool kStaged>
__device__ __forceinline__ int32_t shard_of(const int64_t *__restrict__ q0,
                                            const int64_t *__restrict__ tab,
                                            int32_t n, int64_t q) {
    int32_t lo = 0, hi = n - 1;
    while (lo < hi) {
        const int32_t mid = (lo + hi + 1) >> 1;
        const int64_t v = kStaged ? q0[mid]
                                  : __ldg(tab + mid * HS_REMAP_WORDS +
                                          HS_REMAP_Q0);
        if (v <= q) lo = mid; else hi = mid - 1;
    }
    return lo;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
remap_table_kernel(const int64_t *__restrict__ tab, int32_t n,
                   const int32_t *__restrict__ lut, int32_t lcap,
                   int64_t total) {
    extern __shared__ int64_t q0[];  // n + 1 prefixes when staged
    if (kStaged) {
        for (int32_t i = threadIdx.x; i < n; i += blockDim.x)
            q0[i] = tab[i * HS_REMAP_WORDS + HS_REMAP_Q0];
        if (threadIdx.x == 0) q0[n] = total;
        __syncthreads();
    }
    const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    auto prefix = [&](int32_t s) {
        return s == n ? total
               : kStaged ? q0[s]
                         : __ldg(tab + s * HS_REMAP_WORDS + HS_REMAP_Q0);
    };
    for (int64_t t = tid; t < 8 * (int64_t)n; t += stride) {
        const int32_t s = (int32_t)(t >> 3);
        remap_lanes(tab + s * HS_REMAP_WORDS, (int32_t)(t & 7),
                    prefix(s + 1) - prefix(s), lut, lcap);
    }
    if (tid >= total) return;
    // a thread's quads rise, so its shard only moves forward
    int32_t s = shard_of<kStaged>(q0, tab, n, tid);
    int64_t begin = prefix(s), end = prefix(s + 1);
    for (int64_t q = tid; q < total; q += stride) {
        while (q >= end) {
            begin = end;
            end = prefix(++s + 1);
        }
        const int64_t *row = tab + s * HS_REMAP_WORDS;
        int4 *quads = reinterpret_cast<int4 *>(
            reinterpret_cast<int32_t *>(row[HS_REMAP_ADDR]) +
            row[HS_REMAP_HEAD]);
        const int64_t i = q - begin;
        int4 v = quads[i];
        v.x = remap_one(v.x, lut, lcap, 0);
        v.y = remap_one(v.y, lut, lcap, 0);
        v.z = remap_one(v.z, lut, lcap, 0);
        v.w = remap_one(v.w, lut, lcap, 0);
        quads[i] = v;
    }
}

}  // namespace

extern "C" int hs_session_remap(int32_t *code, int32_t cap,
                                const int32_t *lut, int32_t lcap,
                                int32_t sent_above, void *stream) {
    if (cap == 0) return 0;
    if (lcap <= 0) return (int)cudaErrorInvalidValue;
    const uintptr_t mis = reinterpret_cast<uintptr_t>(code) & 15u;
    // an int32 plane is 4-byte aligned: 0..3 codes to the next boundary
    int32_t head = mis == 0 ? 0 : (int32_t)((16u - mis) >> 2);
    if (head > cap) head = cap;
    const int32_t n4 = (cap - head) >> 2;
    int sms = 0;
    cudaError_t err = hs::current_sms(&sms);
    if (err != cudaSuccess) return (int)err;
    const int64_t need = ((int64_t)n4 + kThreads - 1) / kThreads;
    int64_t blocks = (int64_t)sms * kBlocksPerSm;
    if (need < blocks) blocks = need;
    if (blocks < 1) blocks = 1;  // a plane of fewer than 4 codes
    remap_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        code, cap, lut, lcap, sent_above, head, n4);
    return (int)cudaGetLastError();
}

// tab: n rows of HS_REMAP_WORDS int64 words on the card (address, cap,
// head, first quad); total: the quads of every row
extern "C" int hs_session_remap_table(const int64_t *tab, int32_t n,
                                      const int32_t *lut, int32_t lcap,
                                      int64_t total, void *stream) {
    if (n <= 0) return 0;
    if (lcap <= 0 || total < 0) return (int)cudaErrorInvalidValue;
    int sms = 0;
    cudaError_t err = hs::current_sms(&sms);
    if (err != cudaSuccess) return (int)err;
    // every shard's eight scalar lanes, and the quads in one wave
    int64_t need = (total + kThreads - 1) / kThreads;
    const int64_t lanes = (8 * (int64_t)n + kThreads - 1) / kThreads;
    if (lanes > need) need = lanes;
    int64_t blocks = (int64_t)sms * kBlocksPerSm;
    if (need < blocks) blocks = need;
    if (blocks < 1) blocks = 1;
    const size_t smem = sizeof(int64_t) * ((size_t)n + 1);
    cudaStream_t s = (cudaStream_t)stream;
    if (smem <= kStagedBytes)
        remap_table_kernel<true><<<(int)blocks, kThreads, smem, s>>>(
            tab, n, lut, lcap, total);
    else
        remap_table_kernel<false><<<(int)blocks, kThreads, 0, s>>>(
            tab, n, lut, lcap, total);
    return (int)cudaGetLastError();
}
