// Per-card state of the host entries: what a launch reads of the current
// card (its SM count) and what it sets on it (a kernel's dynamic shared
// memory limit) is kept per device, so a process that drives several
// cards sizes and launches each one's kernels for that card. The caches
// are atomics: two threads that race set the same value twice.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace hs {

constexpr int kMaxDevices = 64;  // cards past this one are asked each call

// the current card's SM count
inline cudaError_t current_sms(int *sms) {
    static std::atomic<int> cache[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) {
        *sms = cache[dev].load(std::memory_order_relaxed);
        if (*sms > 0) return cudaSuccess;
    }
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess && dev < kMaxDevices)
        cache[dev].store(*sms, std::memory_order_relaxed);
    return err;
}

// raise `kernel`'s dynamic shared memory limit to `bytes` on the current
// card, once a card: `done` is the call site's mask of cards done
template <class K>
inline cudaError_t allow_smem(std::atomic<uint64_t> &done, K kernel,
                              int bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const uint64_t bit = dev < kMaxDevices ? 1ull << dev : 0ull;
    if (bit != 0 && (done.load(std::memory_order_acquire) & bit))
        return cudaSuccess;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
    return err;
}

}  // namespace hs
