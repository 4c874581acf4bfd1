// Native columnar wire-encode kernels for the bit-packed transport
// (engine/transport.py). The Python planner decides encodings; these
// loops do the heavy per-element passes: streaming bit-pack, delta
// pack, bool pack, and decimal quantize+verify — each a single pass.
//
// Reference parallel: the reference's ingest hot path is native too
// (hstream-store cbits append/batch path, hs_writer.cpp); SURVEY §7
// calls for "C++ ingest, columnar staging" so the host never stalls
// the device. Build: engine/codec_native.py (g++ -O3, no deps). A copy of
// hstream_tpu/engine/cpp/encode.cpp: the wire bytes must stay identical.

#include <cstdint>
#include <cstring>
#include <cmath>

extern "C" {

// ---- streaming bit-pack: out words = (cap*bits+31)/32 + 1 ------------------

static inline void pack_stream(const uint64_t *u, int64_t n, int bits,
                               uint32_t *out, int64_t nw) {
    std::memset(out, 0, nw * sizeof(uint32_t));
    uint64_t acc = 0;
    int fill = 0;
    uint32_t *w = out;
    for (int64_t i = 0; i < n; ++i) {
        acc |= u[i] << fill;
        fill += bits;
        if (fill >= 32) {
            *w++ = (uint32_t)acc;
            acc >>= 32;
            fill -= 32;
        }
    }
    if (fill > 0) *w++ = (uint32_t)acc;
}

// pack (v[i] - base) at `bits` bits each; v int64
void enc_pack_i64(const int64_t *v, int64_t n, int64_t base, int bits,
                  uint32_t *out, int64_t nw) {
    std::memset(out, 0, nw * sizeof(uint32_t));
    uint64_t acc = 0;
    int fill = 0;
    uint32_t *w = out;
    for (int64_t i = 0; i < n; ++i) {
        acc |= (uint64_t)(v[i] - base) << fill;
        fill += bits;
        if (fill >= 32) { *w++ = (uint32_t)acc; acc >>= 32; fill -= 32; }
    }
    if (fill > 0) *w++ = (uint32_t)acc;
}

void enc_pack_i32(const int32_t *v, int64_t n, int64_t base, int bits,
                  uint32_t *out, int64_t nw) {
    std::memset(out, 0, nw * sizeof(uint32_t));
    uint64_t acc = 0;
    int fill = 0;
    uint32_t *w = out;
    for (int64_t i = 0; i < n; ++i) {
        acc |= (uint64_t)(int64_t)(v[i] - base) << fill;
        fill += bits;
        if (fill >= 32) { *w++ = (uint32_t)acc; acc >>= 32; fill -= 32; }
    }
    if (fill > 0) *w++ = (uint32_t)acc;
}

// pack first differences (d[0] = 0) of a nondecreasing int64 stream
void enc_pack_diff_i64(const int64_t *v, int64_t n, int bits,
                       uint32_t *out, int64_t nw) {
    std::memset(out, 0, nw * sizeof(uint32_t));
    uint64_t acc = 0;
    int fill = 0;
    uint32_t *w = out;
    int64_t prev = n > 0 ? v[0] : 0;
    for (int64_t i = 0; i < n; ++i) {
        acc |= (uint64_t)(v[i] - prev) << fill;
        prev = v[i];
        fill += bits;
        if (fill >= 32) { *w++ = (uint32_t)acc; acc >>= 32; fill -= 32; }
    }
    if (fill > 0) *w++ = (uint32_t)acc;
}

void enc_pack_bool(const uint8_t *v, int64_t n, uint32_t *out, int64_t nw) {
    std::memset(out, 0, nw * sizeof(uint32_t));
    for (int64_t i = 0; i < n; ++i)
        if (v[i]) out[i >> 5] |= (uint32_t)1 << (i & 31);
}

// ---- stats (single pass, no intermediate arrays) ---------------------------

void enc_minmax_i64(const int64_t *v, int64_t n, int64_t *out_min,
                    int64_t *out_max) {
    int64_t lo = n ? v[0] : 0, hi = n ? v[0] : 0;
    for (int64_t i = 1; i < n; ++i) {
        if (v[i] < lo) lo = v[i];
        if (v[i] > hi) hi = v[i];
    }
    *out_min = lo;
    *out_max = hi;
}

void enc_minmax_i32(const int32_t *v, int64_t n, int64_t *out_min,
                    int64_t *out_max) {
    int32_t lo = n ? v[0] : 0, hi = n ? v[0] : 0;
    for (int64_t i = 1; i < n; ++i) {
        if (v[i] < lo) lo = v[i];
        if (v[i] > hi) hi = v[i];
    }
    *out_min = lo;
    *out_max = hi;
}

// nondecreasing check + max first-difference (for delta planning)
// returns 1 if nondecreasing, 0 otherwise
int32_t enc_diff_stats_i64(const int64_t *v, int64_t n, int64_t *out_dmax) {
    int64_t dmax = 0;
    for (int64_t i = 1; i < n; ++i) {
        int64_t d = v[i] - v[i - 1];
        if (d < 0) { *out_dmax = 0; return 0; }
        if (d > dmax) dmax = d;
    }
    *out_dmax = dmax;
    return 1;
}

// ---- decimal quantize + bit-exact verify (one pass) ------------------------
//
// q[i] = rint(v[i] * scale); fails (returns 0) on |q| > max_q or when
// (float)q * inv_scale != v[i] (the exact device-decode round trip).
// On success fills q (int32) and min/max.
int32_t enc_quantize_f32(const float *v, int64_t n, float scale,
                         float inv_scale, int64_t max_q, int32_t *q_out,
                         int64_t *out_min, int64_t *out_max) {
    int64_t lo = INT64_MAX, hi = INT64_MIN;
    for (int64_t i = 0; i < n; ++i) {
        float qf = std::nearbyintf(v[i] * scale);
        if (!(std::fabs(qf) <= (float)max_q)) return 0;  // NaN/inf too
        int32_t q = (int32_t)qf;
        if ((float)q * inv_scale != v[i]) return 0;
        q_out[i] = q;
        if (q < lo) lo = q;
        if (q > hi) hi = q;
    }
    *out_min = n ? lo : 0;
    *out_max = n ? hi : 0;
    return 1;
}

}  // extern "C"
