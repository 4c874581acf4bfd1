// Expression interpreter: evaluate the WHERE predicate and the computed
// aggregate inputs of a query over one decoded micro-batch.
//
// Replaces the filter and value functions the JAX package traces into
// its step (hstream_tpu/engine/lattice.py:169-173 filter_fn and
// :203-210 value fns, built by hstream_tpu/engine/expr.py:122-183
// compile_device). engine/expr.py lowers each expression into a postfix
// program with every type conversion explicit (jnp's promotion rules
// resolved on the host), then into the register form this kernel runs
// (expr.py lower): an accumulator a record, each instruction's operand
// a column, a literal or a spill slot, so SQL's left-deep expressions
// need no stack at all and a deeper right-hand side spills to slots in
// shared memory (at most HS_EXPR_MAX_SLOTS; the host orders the sides
// so that the side needing more slots goes first).
//
// Bound on the H100: bytes. Each record reads its input columns once and
// writes each computed column (and the valid byte) once; a program is at
// most 64 ops, a few operations per byte.
//
// What held the first design back: its stack was an array indexed at
// run time, so every push and pop went to local memory; one record a
// thread paid an op fetch and a ~60-way dispatch per op and record; each
// WHERE program read and wrote `valid` a byte at a time; and sinf, cosf
// and tanf inlined their large-argument reduction, whose array gave the
// kernel a stack frame.
//
// Design: HS_EXPR_PER (8) consecutive records a thread in blocks of
// HS_EXPR_THREADS (128), the accumulator and the operand in registers
// (arrays indexed only by unrolled loops), one op fetch and dispatch for
// all of them; 16-byte loads and stores of 32-bit columns, one 32-bit
// word of four bools or valid bytes (scalar accesses where a pointer is
// not aligned or the batch ends); `valid` loaded with the first
// operands, the WHERE results ANDed into it in registers and it written
// once. A column that several programs read is loaded by each (an L1
// hit): keeping it in registers cost occupancy, which is what this
// kernel runs on (64 registers, PERF.md runs CC-CE). Every program of
// the launch runs in the same thread (the programs ride in the kernel
// parameters, so every thread reads the same op at the same time: no
// divergence). SIN, COS and TAN run out of line (trig_f): the kernel
// keeps a 32-byte frame for that call (ptxas), which only trig programs
// touch, where the first design's stack and reduction array took 96
// bytes. Semantics follow jnp on float32 / int32 / bool exactly:
//  * int32 arithmetic wraps;
//  * `%` is floored (jnp.mod); an int divisor of 0 is taken as 1, as
//    jnp.remainder does, so x % 0 = 0; a float `%` is fmodf plus the
//    divisor where the signs differ;
//  * `/` is IEEE float32 division (__fdiv_rn), after int -> float;
//  * comparisons with NaN are false except `<>`;
//  * a number times a bool is the number or 0, as XLA rewrites it
//    (select), so NaN * false is 0, not NaN;
//  * the unaries (jnp's _NUM_UNARY, hstream_tpu/engine/expr.py:70-79):
//    ROUND is rintf (half to even, as jnp.round), not roundf; SIGN keeps
//    -0.0 and NaN; SQRT is the correctly rounded __fsqrt_rn; the rest
//    are CUDA's full-precision float functions (sinf, expf, ...), the
//    ones PyTorch's own CUDA kernels call, within a few ULP of XLA's.
// Built with --fmad=false and without --use_fast_math, so no multiply
// and add contract into an FMA and sinf stays sinf (not __sinf): the
// plain PyTorch version gives the same bits, or within the stated ULP
// bound of each unary. Subnormals flush where XLA's CPU backend flushes
// them (expr.ftz in the plain version): the operands of the float
// arithmetic, comparisons and unaries, and their results; NEG and ABS
// are bit operations there and keep them, as does jnp.remainder's
// select of an unflushed remainder; SIN, TAN, ATAN and TANH return a
// subnormal operand as it is, and ASIN flushes below 2^-125. The
// sources are built with --ftz=true; the flushes here are explicit all
// the same (by the bits, record.cuh), so they do not depend on how
// libdevice picks its variants.

#include <cuda_runtime.h>

#include "device.cuh"
#include "hs_kernels.h"
#include "record.cuh"

namespace {

constexpr int kBlock = HS_EXPR_THREADS;
constexpr int kPer = HS_EXPR_PER;
static_assert(kPer % 4 == 0 && kPer <= 32, "whole 16-byte vectors, a mask");

using Vals = uint32_t[kPer];

#define EACH _Pragma("unroll") for (int r = 0; r < kPer; ++r)

__device__ __forceinline__ float asf(uint32_t u) { return __uint_as_float(u); }
__device__ __forceinline__ uint32_t fb(float f) { return __float_as_uint(f); }

__device__ __forceinline__ uint32_t mod_i(uint32_t xu, uint32_t bu) {
    int x = (int)xu, b = (int)bu;
    if (b == 0) b = 1;
    int r = b == -1 ? 0 : x % b;  // INT_MIN % -1 traps in hardware
    if (r != 0 && ((r < 0) != (b < 0))) r += b;
    return (uint32_t)r;
}

using hs::ftz;

constexpr float kFltMin = 1.17549435e-38f;  // the smallest normal float32

// jnp.remainder as XLA's CPU backend computes it: rem of the flushed
// operands, exact and unflushed (in double; the conversion back is exact,
// written without .ftz; a dividend smaller than the divisor comes back as
// it is), then the floored correction on flushed values
__device__ __forceinline__ uint32_t mod_f(uint32_t xu, uint32_t bu) {
    const float fx = ftz(asf(xu)), fbv = ftz(asf(bu));
    float r;
    if (fabsf(fx) < fabsf(fbv)) {
        r = asf(xu);
    } else {
        const double d = fmod((double)fx, (double)fbv);
        asm("cvt.rn.f32.f64 %0, %1;" : "=f"(r) : "d"(d));
        if (d != d) r = __uint_as_float(0x7FC00000u);  // NaN: one pattern
    }
    const float fr = ftz(r);
    if (fr != 0.0f && ((fr < 0.0f) != (fbv < 0.0f)))
        return fb(ftz(__fadd_rn(fr, fbv)));
    return fb(r);
}

// a transcendental's result: flushed, but SIN, TAN, ATAN and TANH pass a
// subnormal operand through (XLA returns a tiny x as it is)
__device__ __forceinline__ uint32_t tiny_or(uint32_t xu, float r) {
    return (xu & 0x7F800000u) == 0u ? xu : fb(ftz(r));
}

// SIN, COS and TAN out of line: their large-argument reduction (an
// array indexed at run time) stays out of every other program's path
__device__ __noinline__ uint32_t trig_f(int op, uint32_t xu) {
    const float x = ftz(asf(xu));
    if (op == HS_OP_COS_F) return fb(ftz(cosf(x)));
    return tiny_or(xu, op == HS_OP_SIN_F ? sinf(x) : tanf(x));
}

template <class F>
__device__ __forceinline__ void each(Vals &v, F f) {
    EACH v[r] = f(v[r]);
}

// an operand's conversion (B2I: a bool is already 0/1)
__device__ __forceinline__ void convert(int cvt, Vals &v) {
    if (cvt == HS_OP_B2F)
        each(v, [](uint32_t x) { return fb(x ? 1.0f : 0.0f); });
    else if (cvt == HS_OP_I2F)
        each(v, [](uint32_t x) { return fb(__int2float_rn((int)x)); });
}

// a unary or a conversion, in place; false for a binary op
__device__ __forceinline__ bool unary(int op, Vals &v) {
    switch (op) {
    case HS_OP_B2I:
    case HS_OP_B2F:
    case HS_OP_I2F: convert(op, v); return true;
    case HS_OP_NOT_B: each(v, [](uint32_t x) { return x ^ 1u; }); return true;
    case HS_OP_NOT_I: each(v, [](uint32_t x) { return ~x; }); return true;
    case HS_OP_NEG_I: each(v, [](uint32_t x) { return 0u - x; }); return true;
    // float negate and abs flip and clear the sign bit, as XLA and
    // PyTorch's CPU do (a subnormal is kept); a NaN as PyTorch's CUDA
    // kernels give it (-a, fabsf)
    case HS_OP_NEG_F:
        each(v, [](uint32_t x) {
            return isnan(asf(x)) ? fb(-asf(x)) : x ^ 0x80000000u;
        });
        return true;
    case HS_OP_ABS_I:
        each(v, [](uint32_t x) { return (int)x < 0 ? 0u - x : x; });
        return true;
    case HS_OP_ABS_F:
        each(v, [](uint32_t x) {
            return isnan(asf(x)) ? fb(fabsf(asf(x))) : x & 0x7FFFFFFFu;
        });
        return true;
    case HS_OP_CEIL_F:
        each(v, [](uint32_t x) { return fb(ceilf(ftz(asf(x)))); });
        return true;
    case HS_OP_FLOOR_F:
        each(v, [](uint32_t x) { return fb(floorf(ftz(asf(x)))); });
        return true;
    case HS_OP_ROUND_F:
        each(v, [](uint32_t x) { return fb(rintf(ftz(asf(x)))); });
        return true;
    case HS_OP_SIGN_I:
        each(v, [](uint32_t x) {
            return (uint32_t)(((int)x > 0) - ((int)x < 0));
        });
        return true;
    case HS_OP_SIGN_F:
        each(v, [](uint32_t x) {
            const float f = ftz(asf(x));
            return f > 0.0f ? fb(1.0f) : f < 0.0f ? fb(-1.0f) : fb(f);
        });
        return true;
    case HS_OP_SQRT_F:
        each(v, [](uint32_t x) { return fb(__fsqrt_rn(ftz(asf(x)))); });
        return true;
    case HS_OP_SIN_F:
    case HS_OP_COS_F:
    case HS_OP_TAN_F:
        EACH v[r] = trig_f(op, v[r]);
        return true;
    case HS_OP_ASIN_F:  // XLA's asin halves x first
        each(v, [](uint32_t x) {
            const float f = ftz(asf(x));
            return fabsf(f) < 2.0f * kFltMin ? (x & 0x80000000u)
                                             : fb(ftz(asinf(f)));
        });
        return true;
    case HS_OP_ACOS_F:
        each(v, [](uint32_t x) { return fb(ftz(acosf(ftz(asf(x))))); });
        return true;
    case HS_OP_ATAN_F:
        each(v, [](uint32_t x) { return tiny_or(x, atanf(ftz(asf(x)))); });
        return true;
    case HS_OP_SINH_F:
        each(v, [](uint32_t x) { return fb(ftz(sinhf(ftz(asf(x))))); });
        return true;
    case HS_OP_COSH_F:
        each(v, [](uint32_t x) { return fb(ftz(coshf(ftz(asf(x))))); });
        return true;
    case HS_OP_TANH_F:
        each(v, [](uint32_t x) { return tiny_or(x, tanhf(ftz(asf(x)))); });
        return true;
    case HS_OP_ASINH_F:
        each(v, [](uint32_t x) { return fb(ftz(asinhf(ftz(asf(x))))); });
        return true;
    case HS_OP_ACOSH_F:
        each(v, [](uint32_t x) { return fb(ftz(acoshf(ftz(asf(x))))); });
        return true;
    case HS_OP_ATANH_F:
        each(v, [](uint32_t x) { return fb(ftz(atanhf(ftz(asf(x))))); });
        return true;
    case HS_OP_LOG_F:
        each(v, [](uint32_t x) { return fb(ftz(logf(ftz(asf(x))))); });
        return true;
    case HS_OP_LOG2_F:
        each(v, [](uint32_t x) { return fb(ftz(log2f(ftz(asf(x))))); });
        return true;
    case HS_OP_LOG10_F:
        each(v, [](uint32_t x) { return fb(ftz(log10f(ftz(asf(x))))); });
        return true;
    case HS_OP_EXP_F:
        each(v, [](uint32_t x) { return fb(ftz(expf(ftz(asf(x))))); });
        return true;
    default: return false;
    }
}

// l = f(l, b), or f(b, l) with swap (uniform: a select, no copy)
template <class F>
__device__ __forceinline__ void each2(Vals &l, const Vals &b, bool swap,
                                      F f) {
    EACH {
        const uint32_t x = swap ? b[r] : l[r], y = swap ? l[r] : b[r];
        l[r] = f(x, y);
    }
}

#define INT2(expr) each2(l, b, swap, [](uint32_t x, uint32_t y) { \
    const int xi = (int)x, yi = (int)y; (void)xi; (void)yi; return (expr); })
#define FLT2(expr) each2(l, b, swap, [](uint32_t x, uint32_t y) { \
    const float xf = ftz(asf(x)), yf = ftz(asf(y)); return (expr); })

// l = l op b, or b op l with swap
__device__ __forceinline__ void binary(int op, Vals &l, const Vals &b,
                                       bool swap) {
    switch (op) {
    case HS_OP_ADD_I: INT2(x + y); break;
    case HS_OP_ADD_F: FLT2(fb(ftz(__fadd_rn(xf, yf)))); break;
    case HS_OP_SUB_I: INT2(x - y); break;
    case HS_OP_SUB_F: FLT2(fb(ftz(__fsub_rn(xf, yf)))); break;
    case HS_OP_MUL_I: INT2(x * y); break;
    case HS_OP_MUL_F: FLT2(fb(ftz(__fmul_rn(xf, yf)))); break;
    case HS_OP_DIV_F: FLT2(fb(ftz(__fdiv_rn(xf, yf)))); break;
    case HS_OP_MOD_I: INT2(mod_i(x, y)); break;
    case HS_OP_MOD_F: INT2(mod_f(x, y)); break;
    case HS_OP_OR_B: INT2((uint32_t)((x | y) != 0u)); break;
    case HS_OP_AND_B: INT2((uint32_t)((x & y) != 0u)); break;
    case HS_OP_OR_I: INT2(x | y); break;
    case HS_OP_AND_I: INT2(x & y); break;
    case HS_OP_EQ_I: INT2((uint32_t)(xi == yi)); break;
    case HS_OP_NE_I: INT2((uint32_t)(xi != yi)); break;
    case HS_OP_LT_I: INT2((uint32_t)(xi < yi)); break;
    case HS_OP_LE_I: INT2((uint32_t)(xi <= yi)); break;
    case HS_OP_GT_I: INT2((uint32_t)(xi > yi)); break;
    case HS_OP_GE_I: INT2((uint32_t)(xi >= yi)); break;
    case HS_OP_EQ_F: FLT2((uint32_t)(xf == yf)); break;
    case HS_OP_NE_F: FLT2((uint32_t)(xf != yf)); break;
    case HS_OP_LT_F: FLT2((uint32_t)(xf < yf)); break;
    case HS_OP_LE_F: FLT2((uint32_t)(xf <= yf)); break;
    case HS_OP_GT_F: FLT2((uint32_t)(xf > yf)); break;
    case HS_OP_GE_F: FLT2((uint32_t)(xf >= yf)); break;
    case HS_OP_SEL_L: INT2(x ? y : 0u); break;
    case HS_OP_SEL_R: INT2(y ? x : 0u); break;
    default: break;
    }
}

#undef INT2
#undef FLT2

__device__ __forceinline__ bool aligned(const void *p, unsigned bytes) {
    return ((uintptr_t)p & (bytes - 1)) == 0;
}

// records base .. base + cnt - 1 of column k (0 past cnt)
__device__ __forceinline__ void load_col(const HsExprArgs &a, int k,
                                         int64_t base, int cnt, Vals &v) {
    if (a.col_type[k] == HS_T_BOOL) {
        const uint8_t *p = (const uint8_t *)a.cols[k] + base;
        if (cnt == kPer && aligned(p, 4)) {
#pragma unroll
            for (int q = 0; q < kPer / 4; ++q) {
                const uint32_t w = ((const uint32_t *)p)[q];
#pragma unroll
                for (int r = 0; r < 4; ++r)
                    v[4 * q + r] = ((w >> (8 * r)) & 0xFFu) != 0u;
            }
        } else {
            EACH v[r] = r < cnt && p[r] != 0;
        }
        return;
    }
    const uint32_t *p = (const uint32_t *)a.cols[k] + base;
    if (cnt == kPer && aligned(p, 16)) {
#pragma unroll
        for (int q = 0; q < kPer / 4; ++q) {
            const uint4 w = ((const uint4 *)p)[q];
            v[4 * q] = w.x, v[4 * q + 1] = w.y, v[4 * q + 2] = w.z,
            v[4 * q + 3] = w.w;
        }
    } else {
        EACH v[r] = r < cnt ? p[r] : 0u;
    }
}

__device__ __forceinline__ void store_out(const HsExprProg &pr, int64_t base,
                                          int cnt, const Vals &v) {
    if (pr.out_type == HS_T_BOOL) {
        uint8_t *p = (uint8_t *)pr.out + base;
        if (cnt == kPer && aligned(p, 4)) {
#pragma unroll
            for (int q = 0; q < kPer / 4; ++q) {
                uint32_t w = 0;
#pragma unroll
                for (int r = 0; r < 4; ++r)
                    w |= (uint32_t)(v[4 * q + r] != 0u) << (8 * r);
                ((uint32_t *)p)[q] = w;
            }
        } else {
            EACH if (r < cnt) p[r] = v[r] != 0u;
        }
        return;
    }
    uint32_t *p = (uint32_t *)pr.out + base;
    if (cnt == kPer && aligned(p, 16)) {
#pragma unroll
        for (int q = 0; q < kPer / 4; ++q)
            ((uint4 *)p)[q] = make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                                         v[4 * q + 3]);
    } else {
        EACH if (r < cnt) p[r] = v[r];
    }
}

// bit r: valid[base + r] is set
__device__ __forceinline__ unsigned load_valid(const uint8_t *valid,
                                               int64_t base, int cnt) {
    const uint8_t *p = valid + base;
    unsigned bits = 0;
    if (cnt == kPer && aligned(p, 4)) {
#pragma unroll
        for (int q = 0; q < kPer / 4; ++q) {
            const uint32_t w = ((const uint32_t *)p)[q];
#pragma unroll
            for (int r = 0; r < 4; ++r)
                bits |= (unsigned)(((w >> (8 * r)) & 0xFFu) != 0u)
                        << (4 * q + r);
        }
    } else {
        EACH bits |= (unsigned)(r < cnt && p[r] != 0) << r;
    }
    return bits;
}

// valid[base + r] = bit r of keep
__device__ __forceinline__ void store_valid(uint8_t *valid, int64_t base,
                                            int cnt, unsigned keep) {
    uint8_t *p = valid + base;
    if (cnt == kPer && aligned(p, 4)) {
#pragma unroll
        for (int q = 0; q < kPer / 4; ++q) {
            uint32_t w = 0;
#pragma unroll
            for (int r = 0; r < 4; ++r)
                w |= ((keep >> (4 * q + r)) & 1u) << (8 * r);
            ((uint32_t *)p)[q] = w;
        }
    } else {
        EACH if (r < cnt) p[r] = (keep >> r) & 1u;
    }
}

__global__ void __launch_bounds__(kBlock)
expr_kernel(const __grid_constant__ HsExprArgs a) {
    // spill slots: [slot][record][thread], so a warp's accesses hit
    // consecutive banks
    extern __shared__ uint32_t s_slot[];
    const int64_t base = ((int64_t)blockIdx.x * kBlock + threadIdx.x) * kPer;
    if (base >= a.n) return;
    const int cnt = (int)min((int64_t)kPer, (int64_t)a.n - base);
    // valid's bits, loaded with the first operands: ANDed with each WHERE
    // program's results and stored once
    bool where = false;
    for (int p = 0; p < a.n_progs; ++p) where |= a.progs[p].where != 0;
    unsigned keep = where ? load_valid(a.valid, base, cnt) : 0u;
    for (int p = 0; p < a.n_progs; ++p) {
        const HsExprProg &pr = a.progs[p];
        Vals acc;
        for (int o = pr.first; o < pr.first + pr.n_ops; ++o) {
            const int code = a.ops[o].op, arg = a.ops[o].arg;
            const int op = code & 0xFF, src = (code >> 8) & 0xFF;
            if (op == HS_OP_SPILL) {
                EACH s_slot[(arg * kPer + r) * kBlock + threadIdx.x] = acc[r];
                continue;
            }
            Vals b;
            if (src == HS_SRC_COL) {
                load_col(a, arg, base, cnt, b);
            } else if (src == HS_SRC_LIT) {
                EACH b[r] = (uint32_t)arg;
            } else if (src == HS_SRC_SLOT) {
                EACH b[r] = s_slot[(arg * kPer + r) * kBlock + threadIdx.x];
            }
            convert((code >> 16) & 0xFF, b);
            if (op == HS_OP_LOAD) {
                EACH acc[r] = b[r];
            } else if (!unary(op, acc)) {
                binary(op, acc, b, (code >> 24) & 1);
            }
        }
        if (pr.where) {
            EACH if (acc[r] == 0u) keep &= ~(1u << r);
        } else {
            store_out(pr, base, cnt, acc);
        }
    }
    if (where) store_valid(a.valid, base, cnt, keep);
}

}  // namespace

extern "C" int hs_expr(const HsExprArgs *args, void *stream) {
    if (args->n == 0 || args->n_progs == 0) return 0;
    if (args->n < 0 || args->n_slots < 0 ||
        args->n_slots > HS_EXPR_MAX_SLOTS)
        return (int)cudaErrorInvalidValue;
    constexpr int kSlotBytes = kPer * kBlock * sizeof(uint32_t);
    static std::atomic<uint64_t> smem_set{0};
    const int err = (int)hs::allow_smem(smem_set, expr_kernel,
                                        HS_EXPR_MAX_SLOTS * kSlotBytes);
    if (err != 0) return err;
    const int64_t per_block = (int64_t)kBlock * kPer;
    const unsigned blocks = (unsigned)((args->n + per_block - 1) / per_block);
    expr_kernel<<<blocks, kBlock, (size_t)args->n_slots * kSlotBytes,
                  (cudaStream_t)stream>>>(*args);
    return (int)cudaGetLastError();
}
