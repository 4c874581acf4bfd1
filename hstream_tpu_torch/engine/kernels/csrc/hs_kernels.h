// The C interface of the port's Hopper kernels (bound from Python with
// ctypes in engine/kernels/binding.py, which mirrors these structs field
// for field). Each entry point enqueues its kernel(s) on the given CUDA
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so a launch the card refuses is reported at once.
#pragma once

#include <cstdint>

// What one query may take on the card, refused at query creation past
// these on every device (engine/lattice.py check_device_caps): its
// aggregates, and the distinct input columns its WHERE and aggregate
// inputs read. A wire batch carries at most key, ts and __valid, a
// stream a column and a NULL stream an aggregate. The argument blocks
// that hold these arrays pass 4 KB, which kernel parameters take from
// CUDA 12.1 on Hopper (up to 32,764 bytes; static_asserts below).
#define HS_MAX_AGGS 64
#define HS_MAX_COLS 64
#define HS_MAX_STREAMS (3 + HS_MAX_COLS + HS_MAX_AGGS)
#define HS_MAX_PARAM_BYTES 32764

// wire encodings (engine/transport.py ENC_*)
enum { HS_ENC_BP = 0, HS_ENC_BPD = 1, HS_ENC_BOOL = 2, HS_ENC_DEC = 3,
       HS_ENC_RAWF = 4, HS_ENC_RAWI = 5 };

// aggregate kinds the scatter, top-k, close and touched kernels take
enum { HS_AGG_COUNT_ALL = 0, HS_AGG_SUM = 1, HS_AGG_AVG = 2, HS_AGG_MIN = 3,
       HS_AGG_MAX = 4, HS_AGG_HLL = 5, HS_AGG_COUNT = 6, HS_AGG_QUANT = 7,
       HS_AGG_TOPK = 8, HS_AGG_TOPK_DISTINCT = 9 };

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

// the wire decode's blocks: HS_DECODE_THREADS threads, HS_DECODE_PER
// consecutive values a thread, so tiles of 1024 values
#define HS_DECODE_THREADS 256
#define HS_DECODE_PER 4

struct HsDecodeArgs {
    const uint32_t *words;
    int32_t cap;
    int32_t n;
    int32_t n_streams;
    int32_t valid_stream;  // index of the __valid stream, -1 = none
    int32_t delta_stream;  // index of the (single) bpd stream, -1 = none
    int32_t blocks;        // grid size (transport.decode_plan)
    int32_t tiles;         // tiles of 1024 values a block
    int32_t delta_warps;   // bpd: the warps a block gives the delta stream
    uint8_t *valid_out;    // [cap]: row < n and its __valid bit
    uint64_t *status;      // bpd: [blocks] look-back words, zeroed when
                           // made; a launch reads its own epoch's only
    uint32_t epoch;        // bpd: this launch's tag, rising
    HsStream s[HS_MAX_STREAMS];
};

// ---- expression interpreter (expr.cu) ----------------------------------

// one argument block's tables; a program set past them takes further
// blocks, launched one after another (engine/expr.py launch_plan)
#define HS_EXPR_MAX_COLS HS_MAX_COLS
#define HS_EXPR_MAX_PROGS 17
#define HS_EXPR_MAX_OPS 256     // instructions of all programs together
#define HS_EXPR_MAX_SLOTS 15    // spill slots a program may use
#define HS_EXPR_THREADS 128     // the kernel's blocks
#define HS_EXPR_PER 8           // consecutive records a thread

// opcodes (engine/expr.py OP_*); values are 32-bit words: float32 bits,
// int32, or a bool as 0/1
enum {
    HS_OP_COL = 0, HS_OP_LIT, HS_OP_B2I, HS_OP_B2F, HS_OP_I2F,
    HS_OP_ADD_I, HS_OP_ADD_F, HS_OP_SUB_I, HS_OP_SUB_F, HS_OP_MUL_I,
    HS_OP_MUL_F, HS_OP_DIV_F, HS_OP_MOD_I, HS_OP_MOD_F,
    HS_OP_OR_B, HS_OP_AND_B, HS_OP_OR_I, HS_OP_AND_I,
    HS_OP_EQ_I, HS_OP_NE_I, HS_OP_LT_I, HS_OP_LE_I, HS_OP_GT_I, HS_OP_GE_I,
    HS_OP_EQ_F, HS_OP_NE_F, HS_OP_LT_F, HS_OP_LE_F, HS_OP_GT_F, HS_OP_GE_F,
    HS_OP_NOT_B, HS_OP_NOT_I, HS_OP_NEG_I, HS_OP_NEG_F, HS_OP_ABS_I,
    HS_OP_ABS_F,
    // a number times a bool: the number where the bool is true, else 0
    // (+0.0), as XLA computes it (select(pred, x, 0)); L: the bool is
    // the left operand
    HS_OP_SEL_L, HS_OP_SEL_R,
    // jnp's unaries on float32 (an int or bool operand is converted
    // first, or left alone where jnp keeps its type); ROUND is half to
    // even, SIGN keeps -0.0 and NaN, SIGN_I is the int32 sign
    HS_OP_CEIL_F, HS_OP_FLOOR_F, HS_OP_ROUND_F, HS_OP_SIGN_I, HS_OP_SIGN_F,
    HS_OP_SQRT_F, HS_OP_SIN_F, HS_OP_COS_F, HS_OP_TAN_F, HS_OP_ASIN_F,
    HS_OP_ACOS_F, HS_OP_ATAN_F, HS_OP_SINH_F, HS_OP_COSH_F, HS_OP_TANH_F,
    HS_OP_ASINH_F, HS_OP_ACOSH_F, HS_OP_ATANH_F, HS_OP_LOG_F, HS_OP_LOG2_F,
    HS_OP_LOG10_F, HS_OP_EXP_F,
    // the register form's own: the accumulator takes the operand; the
    // accumulator goes to spill slot `arg`
    HS_OP_LOAD, HS_OP_SPILL
};

// where an instruction's operand comes from
enum { HS_SRC_NONE = 0, HS_SRC_COL = 1, HS_SRC_LIT = 2, HS_SRC_SLOT = 3 };

// one instruction of the register form (engine/expr.py lower): the
// accumulator a record takes `op` (a unary in place, a binary with the
// operand as its right side, or as its left with swap); `op` packs
//   bits 0-7 the opcode, 8-15 HS_SRC_*, 16-23 the operand's conversion
//   (0, HS_OP_B2I, HS_OP_B2F or HS_OP_I2F), bit 24 swap
struct HsExprOp {
    int32_t op;
    int32_t arg;           // COL: column index; LIT: its 32 bits; SLOT
};

struct HsExprProg {
    int32_t first;         // index of its first instruction in ops
    int32_t n_ops;         // its instructions
    int32_t out_type;      // HS_T_* of the result
    int32_t where;         // 1: AND the result into valid, out unused
    void *out;             // [n] column of out_type
};

struct HsExprArgs {
    int32_t n;
    int32_t n_cols;
    int32_t n_progs;
    int32_t n_slots;       // spill slots the programs need, at most
                           // HS_EXPR_MAX_SLOTS
    int32_t col_type[HS_EXPR_MAX_COLS];
    const void *cols[HS_EXPR_MAX_COLS];
    uint8_t *valid;        // [n]
    HsExprProg progs[HS_EXPR_MAX_PROGS];
    HsExprOp ops[HS_EXPR_MAX_OPS];
};

// ---- scatter-aggregate (scatter.cu) and top-k fold (topk.cu) -----------

// scatter modes, chosen on the host from the spec (lattice.scatter_plan):
// each block folds into private copies of the [K, W] planes in shared
// memory and flushes them once (CLUSTER: the 8 blocks of a cluster reduce
// theirs together first), or every update is a global atomic
enum { HS_SCATTER_GLOBAL = 0, HS_SCATTER_PRIVATE = 1,
       HS_SCATTER_CLUSTER = 2 };

// top-k modes (lattice.topk_plan): each block folds into a copy of the
// [K, W, k] planes in shared memory and merges what changed into the
// global planes once; or every candidate takes its cell's lock on the
// global planes
enum { HS_TOPK_GLOBAL = 0, HS_TOPK_PRIVATE = 1 };
#define HS_TOPK_PRIVATE_THREADS 1024
#define HS_TOPK_GLOBAL_THREADS 256
#define HS_TOPK_PER 4          // records a thread takes at a time

// floor division by d > 0 with a multiplier computed on the host
// (lattice.divisor, record.cuh hs::fdiv)
struct HsDivisor {
    uint32_t m;            // ceil(2^shift / d)
    int32_t shift;         // 31 + ceil(log2 d)
};

struct HsScatterAgg {
    int32_t kind;          // HS_AGG_*
    int32_t vtype;         // HS_T_* of the input column
    const void *values;    // [cap]
    const uint8_t *nulls;  // [cap] 1 = SQL NULL input, NULL = none
    void *plane;           // [K, W] f32 / i32 (COUNT), [K, W, m] int8
                           // (HLL), [K, W, bins] i32 (QUANT),
                           // [K, W, k] f32 (TOPK*)
    int32_t *plane_n;      // AVG: [K, W] non-null count, else NULL
    int32_t width;         // values per cell: m, bins, k, or 1
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
    float q_min;           // quantile bins: float32(min_value)
    float q_gamma;         // float32(gamma_log)
    int32_t *count;        // [K, W]
    int32_t *slot_start;   // [W]
    uint8_t *touched;      // [K, W]
    int32_t *locks;        // top-k: [K, W] zeroed, left zeroed
    uint64_t *bounds;      // top-k private: [n_aggs, K, W], zeroed when
                           // made; a launch reads its own epoch's only
    uint32_t epoch;        // top-k private: this launch's tag, rising
    int32_t mode;          // scatter: HS_SCATTER_*; top-k: HS_TOPK_*
    int32_t blocks;        // grid size
    HsDivisor adv_div;     // top-k: floor division by advance (> 0)
    HsDivisor slot_div;    // top-k: by n_slots
    int32_t n_aggs;
    HsScatterAgg a[HS_MAX_AGGS];
};

// ---- finalize (close.cu, touched.cu) -----------------------------------

struct HsCloseAgg {
    int32_t kind;          // HS_AGG_*
    int32_t width;         // output rows (k for TOPK*, else 1) ...
    int32_t plane_width;   // ... and plane values per cell
    float init;            // reset value of the plane
    float q;               // APPROX_QUANTILE: float32(quantile)
    int32_t row;           // its first row among the aggregates' rows
    void *plane;           // as in HsScatterAgg; NULL for COUNT(*)
    int32_t *plane_n;      // AVG only
};

struct HsFinalize {
    int32_t hll_p;
    float hll_am2;         // float32(alpha(m) * m * m), from the host
    float q_min;           // float32(min_value)
    float q_gamma;         // float32(gamma_log)
    float q_half_gamma;    // float32(0.5 * gamma_log)
    int32_t n_aggs;
    HsCloseAgg a[HS_MAX_AGGS];
};

// the close's lanes a key (lattice.close_plan): a warp where the close
// finalizes a sketch (the estimates are warp reductions) or resets a
// wide cell, else one; HS_CLOSE_THREADS / lanes keys a block
#define HS_CLOSE_THREADS 256
#define HS_CLOSE_INLINE 16     // slots a close passes by value (no upload)

struct HsCloseArgs {
    int32_t n_keys;
    int32_t n_slots;
    int32_t n_sel;         // P, the padded slot vector's length
    int32_t mode;          // HS_CLOSE_*
    int32_t out_rows;      // 2 + sum of the aggregates' widths
    int32_t slot;          // hs_close_slot: the one slot (slots unused)
    int32_t lanes;         // 1 or 32 lanes a key
    int32_t sel[HS_CLOSE_INLINE];  // the slots when `slots` is NULL
    const int32_t *slots;  // [P], < 0 = padding; NULL: P <= 16 in `sel`
    int32_t *count;
    int32_t *slot_start;
    uint8_t *touched;
    int32_t *out;          // [P, out_rows, K]; NULL in reset-only mode
                           // (hs_close_slot: [out_rows, K])
    uint32_t *done;        // [P], zero: key tiles finished per slot of an
                           // extract-and-reset close, which leaves it zero
    HsFinalize f;
};

// ---- packed-transport unpack (unpack.cu) --------------------------------

struct HsUnpackArgs {
    const int32_t *packed;  // [3 + n_cols, cap]: key, ts, flags, columns
    int32_t cap;
    int32_t n_bool;         // bool columns to widen
    int32_t n_null;         // NULL masks: bits 1 .. n_null of the flags
    uint8_t *valid;         // [cap]
    int32_t bool_row[HS_MAX_COLS];   // packed row of each bool column
    uint8_t *bool_out[HS_MAX_COLS];  // [cap] each
    uint8_t *null_out[HS_MAX_AGGS];  // [cap] each
};

// touched extract modes: a scan, a finalize (and a sketch pass), or one
// launch for a lattice of at most HS_TOUCHED_ONE_CELLS cells and
// HS_TOUCHED_ONE_ROWS output rows
enum { HS_TOUCHED_STAGED = 0, HS_TOUCHED_ONE = 1 };
#define HS_TOUCHED_ONE_CELLS 4096
#define HS_TOUCHED_ONE_ROWS 512

struct HsTouchedArgs {
    int32_t n_keys;
    int32_t n_slots;
    int32_t max_out;
    int32_t out_rows;      // 3 + sum of the aggregates' widths
    int32_t mode;          // HS_TOUCHED_*
    int32_t has_sketch;    // an HLL or quantile aggregate
    int32_t *count;
    int32_t *slot_start;
    uint8_t *touched;      // [K, W], cleared
    int32_t *out;          // [out_rows, max_out]
    void *scratch;         // hs_touched_scratch_bytes(n_cells, max_out,
                           // out_rows) bytes, which hs_touched carves:
    int32_t *cells;        //   the compacted cells [max_out], then n
    int32_t *fill;         //   [out_rows]: cell (0, 0) finalized
    uint32_t *ticket;      //   the scan's tile order
    uint64_t *status;      //   [tiles] the scan's tile counts
    HsFinalize f;
};

// ---- session windows (session_chain.cuh and the four session_*.cu) -----

#define HS_SESSION_SENT (1 << 22)      // code of an empty or evicted slot
#define HS_SESSION_NEG (-(1 << 30))    // the scan's "minus infinity"

// one arena plane: the fold of the step (record mode) and the merge
// (segment mode) updates it from the old arena's rows and from the
// batch's records or segments
struct HsSessPlane {
    int32_t kind;          // HS_AGG_* of the aggregate that owns it
    int32_t width;         // values per slot: 1, m (HLL) or bins (QUANT)
    const void *src;       // old arena [cap, width]: i32 / f32 / int8
    const int32_t *src_n;  // AVG: the old arena's _n plane, else NULL
    void *out;             // fresh arena [cap, width]
    int32_t *out_n;        // AVG
    const void *seg;       // segment mode: the segments' plane [nb, width]
    const int32_t *seg_n;  // segment mode, AVG
    int32_t vtype;         // record mode: HS_T_* of `values`
    int32_t null_bit;      // record mode: flag bit of its NULL mask, 0 none
    const void *values;    // record mode: the input column [nb]
};

enum { HS_SESS_RECORD = 0, HS_SESS_SEGMENT = 1 };

struct HsSessionArgs {
    int32_t cap;           // arena slots
    int32_t nb;            // batch records (record mode) or segments
    int32_t mode;          // HS_SESS_*
    int32_t gap;           // ms
    int32_t close_cut;     // retire arena entries with t1 <= close_cut
    int32_t delta;         // then shift live arena times by -delta
    int32_t hll_p;
    float q_min;           // float32(min_value)
    float q_gamma;         // float32(gamma_log)
    const int32_t *code;   // old arena [cap]
    const int32_t *t0;
    const int32_t *t1;
    const int32_t *b_code; // record: packed rows 0 (codes), 1 (ts), 1,
    const int32_t *b_t0;   // 2 (flags); segment: the segments' code, t0,
    const int32_t *b_t1;   // t1 and NULL
    const int32_t *b_flags;
    int32_t *out_code;     // fresh arena [cap]
    int32_t *out_t0;
    int32_t *out_t1;
    void *scratch;         // hs_session_scratch_bytes(cap, nb) bytes
    int32_t n_planes;
    HsSessPlane p[HS_MAX_AGGS];
};

// slots a session extract takes by value, in the kernel's parameters
// (the argument block stays within HS_MAX_PARAM_BYTES)
#define HS_SESS_INLINE 7424

struct HsSessExtractArgs {
    int32_t cap;
    int32_t n_sel;         // P, the padded slot vector's length
    int32_t n_live;        // the named prefix; entries past it are pads
    const int32_t *slots;  // [n_live], < 0 = padding; NULL: in `sel`
    const int32_t *code;   // arena [cap]
    int32_t *out;          // [1 + n_aggs, P]
    HsFinalize f;          // a[g].plane: the arena plane agg g reads
    int32_t sel[HS_SESS_INLINE];  // the named prefix when `slots` is NULL
};

// ---- the interval join (join_core.cuh and the three join_*.cu) --------

#define HS_JOIN_SENT (1 << 22)         // code of an empty or evicted slot
#define HS_JOIN_MAX_COLS 14            // columns per side (2 flag bits each)
#define HS_JOIN_MAX_FEED 16            // inner-step columns the feed writes
#define HS_JOIN_MAX_NULLS 16           // __null_a{i} masks the feed writes
#define HS_JOIN_MAX_REFS 64            // column references of masks + filter

enum { HS_JOIN_PACK = 0, HS_JOIN_FEED = 1 };            // probe modes
// probe branches: the store window of a tile of records staged in shared
// memory where it fits (else searched in global memory); always searched
// in global memory; always the whole store (join_core.cuh)
enum { HS_PROBE_AUTO = 0, HS_PROBE_WINDOW = 1, HS_PROBE_WHOLE = 2 };
enum { HS_JOIN_M = 0, HS_JOIN_O = 1, HS_JOIN_BOTH = 2,  // feed sources
       HS_JOIN_BOTH_O = 3 };
enum { HS_JOIN_F32 = 0, HS_JOIN_I32 = 1, HS_JOIN_BOOL = 2 };  // feed tags

// one column reference of the feed: which side holds it and its index in
// the probing side's layout (jm) and the probed store's (jo), -1 = none
struct HsJoinRef {
    int32_t src;           // HS_JOIN_M / _O / _BOTH / _BOTH_O
    int32_t jm;
    int32_t jo;
};

// one inner-step column the feed resolves
struct HsJoinFeedCol {
    HsJoinRef ref;
    int32_t tag;           // HS_JOIN_F32 / _I32 / _BOOL
    void *out;             // [match_cap]: f32 bits / int32 / bool bytes
};

// one aggregate's NULL mask: the OR of refs[first .. first + count)
struct HsJoinNull {
    int32_t first;
    int32_t count;
    uint8_t *out;          // [match_cap] bool
};

struct HsJoinProbeArgs {
    int32_t cap;           // probed store slots
    int32_t bcap;          // batch columns
    int32_t n;             // records in the batch (the rest is padding)
    int32_t within;        // ms
    int32_t cutoff;        // entries with ts < cutoff are invisible
    int32_t match_cap;     // match columns written
    int32_t mode;          // HS_JOIN_PACK / HS_JOIN_FEED
    int32_t branch;        // HS_PROBE_*
    int32_t n_cols_mine;   // probing side's stored columns
    int32_t n_cols_other;  // probed store's stored columns
    const int32_t *batch;  // [4 + n_cols_mine, bcap]: code, ts, kid, flags,
                           // cols; sorted by (code, ts)
    const int32_t *o_code; // probed store [cap], sorted by (code, ts)
    const int32_t *o_ts;
    const int32_t *o_flags;
    const int32_t *o_cols; // [n_cols_other, cap]
    int32_t *packed;       // pack: [5 + n_cols_mine + n_cols_other, match_cap]
    int32_t ts_off;        // feed: added to the joined ts (int32 wrap)
    int32_t *kid;          // feed: [match_cap]
    int32_t *ts;
    uint8_t *valid;
    int32_t n_feed;
    HsJoinFeedCol feed[HS_JOIN_MAX_FEED];
    int32_t n_nulls;
    HsJoinNull nulls[HS_JOIN_MAX_NULLS];
    int32_t filter_first;  // filter-NULL refs: refs[first .. first + count)
    int32_t filter_count;
    HsJoinRef refs[HS_JOIN_MAX_REFS];
    void *scratch;         // hs_join_probe_scratch_bytes(bcap, match_cap)
};

struct HsJoinInsertArgs {
    int32_t cap;           // store slots (in and out)
    int32_t bcap;
    int32_t n;
    int32_t n_cols;
    const int32_t *code;   // the store [cap], sorted by (code, ts)
    const int32_t *ts;
    const int32_t *flags;
    const int32_t *cols;   // [n_cols, cap]
    const int32_t *batch;  // [4 + n_cols, bcap], sorted by (code, ts)
    int32_t *out_code;     // the other store [cap]
    int32_t *out_ts;
    int32_t *out_flags;
    int32_t *out_cols;
    void *scratch;         // hs_join_insert_scratch_bytes(cap) bytes
};

struct HsJoinEvictSide {
    int32_t n_cols;
    const int32_t *code;   // [cap], sorted by (code, ts)
    const int32_t *ts;
    const int32_t *flags;
    const int32_t *cols;   // [n_cols, cap]
    int32_t *out_code;
    int32_t *out_ts;
    int32_t *out_flags;
    int32_t *out_cols;
};

// the eviction's tiles (join_evict.cu): HS_JOIN_EVICT_THREADS threads,
// HS_JOIN_EVICT_PER entries a thread, entry r * THREADS + t of a tile
// to thread t (a warp's 32 lanes on 32 consecutive entries)
#define HS_JOIN_EVICT_THREADS 256
#define HS_JOIN_EVICT_PER 8

struct HsJoinEvictArgs {
    int32_t cap;           // slots of each side
    int32_t cutoff;        // live: code < SENT and ts >= cutoff
    int32_t delta;         // survivors' ts -= delta (int32 wrap)
    HsJoinEvictSide s[2];  // left, right
    int32_t *n_out;        // [2] live counts
    void *scratch;         // hs_join_evict_scratch_bytes(cap) bytes
};

// every argument block passed by value fits Hopper's kernel parameters
static_assert(sizeof(HsDecodeArgs) <= HS_MAX_PARAM_BYTES, "HsDecodeArgs");
static_assert(sizeof(HsExprArgs) <= HS_MAX_PARAM_BYTES, "HsExprArgs");
static_assert(sizeof(HsScatterArgs) <= HS_MAX_PARAM_BYTES, "HsScatterArgs");
static_assert(sizeof(HsCloseArgs) <= HS_MAX_PARAM_BYTES, "HsCloseArgs");
static_assert(sizeof(HsUnpackArgs) <= HS_MAX_PARAM_BYTES, "HsUnpackArgs");
static_assert(sizeof(HsTouchedArgs) <= HS_MAX_PARAM_BYTES, "HsTouchedArgs");
static_assert(sizeof(HsSessionArgs) <= HS_MAX_PARAM_BYTES, "HsSessionArgs");
static_assert(sizeof(HsSessExtractArgs) <= HS_MAX_PARAM_BYTES,
              "HsSessExtractArgs");
static_assert(sizeof(HsJoinProbeArgs) <= HS_MAX_PARAM_BYTES,
              "HsJoinProbeArgs");

extern "C" {
int hs_decode(const HsDecodeArgs *args, void *stream);
int hs_expr(const HsExprArgs *args, void *stream);
int hs_scatter(const HsScatterArgs *args, void *stream);
int hs_topk(const HsScatterArgs *args, void *stream);
int hs_close(const HsCloseArgs *args, void *stream);
int hs_close_slot(const HsCloseArgs *args, void *stream);
int hs_unpack(const HsUnpackArgs *args, void *stream);
int hs_touched(const HsTouchedArgs *args, void *stream);
int64_t hs_touched_scratch_bytes(int32_t n_cells, int32_t max_out,
                                 int32_t out_rows);
int hs_rebase(int32_t *slot_start, int32_t n_slots, int32_t delta,
              void *stream);
int hs_empty(void *stream);
int64_t hs_session_scratch_bytes(int32_t cap, int32_t nb);
int hs_session_step(const HsSessionArgs *args, void *stream);
int hs_session_merge(const HsSessionArgs *args, void *stream);
int hs_session_extract(const HsSessExtractArgs *args, void *stream);
int hs_session_remap(int32_t *code, int32_t cap, const int32_t *lut,
                     int32_t lcap, int32_t sent_above, void *stream);
int64_t hs_join_probe_scratch_bytes(int32_t bcap, int32_t match_cap);
int64_t hs_join_evict_scratch_bytes(int32_t cap);
int hs_join_probe(const HsJoinProbeArgs *args, void *stream);
int64_t hs_join_insert_scratch_bytes(int32_t cap);
int hs_join_insert(const HsJoinInsertArgs *args, void *stream);
int hs_join_evict(const HsJoinEvictArgs *args, void *stream);
const char *hs_error_string(int err);
}
