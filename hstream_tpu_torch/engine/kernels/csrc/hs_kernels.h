// The C interface of the port's Hopper kernels (bound from Python with
// ctypes in engine/kernels/binding.py, which mirrors these structs field
// for field). Each entry point enqueues its kernel(s) on the given CUDA
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so a launch the card refuses is reported at once.
#pragma once

#include <cstdint>

#define HS_MAX_STREAMS 16
#define HS_MAX_AGGS 16

// wire encodings (engine/transport.py ENC_*)
enum { HS_ENC_BP = 0, HS_ENC_BPD = 1, HS_ENC_BOOL = 2, HS_ENC_DEC = 3,
       HS_ENC_RAWF = 4, HS_ENC_RAWI = 5 };

// aggregate kinds the scatter and close kernels take
enum { HS_AGG_COUNT_ALL = 0, HS_AGG_SUM = 1, HS_AGG_AVG = 2, HS_AGG_MIN = 3,
       HS_AGG_MAX = 4, HS_AGG_HLL = 5 };

// decoded column types: float32, int32, bool (one byte)
enum { HS_T_F32 = 0, HS_T_I32 = 1, HS_T_BOOL = 2 };

// close modes
enum { HS_CLOSE_EXTRACT_RESET = 0, HS_CLOSE_EXTRACT = 1, HS_CLOSE_RESET = 2 };

#define HS_EMPTY_START (-2147483647 - 1)

struct HsStream {
    int64_t word_off;   // first word of this stream in the wire buffer
    int32_t enc;        // HS_ENC_*
    int32_t bits;       // bp/bpd/dec width (bool1: 1)
    int32_t base;       // per-batch integer base
    float inv_scale;    // dec: float32(1/scale), passed from the host
    void *out;          // [cap] int32 / float32 / uint8, NULL = not kept
};

struct HsDecodeArgs {
    const uint32_t *words;
    int32_t cap;
    int32_t n;
    int32_t n_streams;
    int32_t valid_stream;  // index of the __valid stream, -1 = none
    int32_t delta_stream;  // index of the (single) bpd stream, -1 = none
    uint8_t *valid_out;    // [cap]: row < n and its __valid bit
    uint32_t *block_sums;  // [cap / 1024 rounded up] scratch for bpd
    HsStream s[HS_MAX_STREAMS];
};

struct HsScatterAgg {
    int32_t kind;          // HS_AGG_SUM..HS_AGG_HLL
    int32_t vtype;         // HS_T_* of the input column
    const void *values;    // [cap]
    void *plane;           // [K, W] float32, or [K, W, m] int8 for HLL
    int32_t *plane_n;      // AVG: [K, W] non-null count, else NULL
};

struct HsScatterArgs {
    const int32_t *key;
    const int32_t *ts;
    const uint8_t *valid;
    int32_t cap;
    int32_t n_keys;        // K
    int32_t n_slots;       // W
    int32_t n_per;         // windows per record
    int32_t advance;       // ms; 0 = windowless (every record in slot 0)
    int32_t size_grace;    // size + grace, ms
    int32_t watermark;     // relative ms, -1 = none yet
    int32_t track_touched;
    int32_t hll_p;         // HLL precision p (m = 2^p)
    int32_t *count;        // [K, W]
    int32_t *slot_start;   // [W]
    uint8_t *touched;      // [K, W]
    int32_t n_aggs;
    HsScatterAgg a[HS_MAX_AGGS];
};

struct HsCloseAgg {
    int32_t kind;          // HS_AGG_*
    void *plane;           // as in HsScatterAgg; NULL for COUNT(*)
    int32_t *plane_n;      // AVG only
    float init;            // reset value of the plane
};

struct HsCloseArgs {
    int32_t n_keys;
    int32_t n_slots;
    int32_t n_sel;         // P, the padded slot vector's length
    int32_t mode;          // HS_CLOSE_*
    int32_t hll_p;
    float hll_am2;         // float32(alpha(m) * m * m), from the host
    const int32_t *slots;  // [P], < 0 = padding
    int32_t *count;
    int32_t *slot_start;
    uint8_t *touched;
    int32_t *out;          // [P, 2 + n_aggs, K]; NULL in reset-only mode
    uint32_t *done;        // [P] zeroed: key tiles finished per slot
    int32_t n_aggs;
    HsCloseAgg a[HS_MAX_AGGS];
};

extern "C" {
int hs_decode(const HsDecodeArgs *args, void *stream);
int hs_scatter(const HsScatterArgs *args, void *stream);
int hs_close(const HsCloseArgs *args, void *stream);
int hs_rebase(int32_t *slot_start, int32_t n_slots, int32_t delta,
              void *stream);
const char *hs_error_string(int err);
}
