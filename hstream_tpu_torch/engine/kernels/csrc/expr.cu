// Expression interpreter: evaluate the WHERE predicate and the computed
// aggregate inputs of a query over one decoded micro-batch.
//
// Replaces the filter and value functions the JAX package traces into
// its step (hstream_tpu/engine/lattice.py:169-173 filter_fn and
// :203-210 value fns, built by hstream_tpu/engine/expr.py:122-183
// compile_device). engine/expr.py lowers each expression into a postfix
// program over 32-bit stack words with every type conversion explicit
// (jnp's promotion rules resolved on the host), so this kernel only
// runs the ops it is given.
//
// Bound on the H100: bytes. Each record reads its input columns once and
// writes each computed column (and the valid byte) once; a program is at
// most 64 ops, a few operations per byte.
//
// Design: one thread per record, every program of the launch run by the
// same thread (the programs ride in the kernel parameters, so every
// thread of the card reads the same op at the same time: no divergence).
// The stack lives in registers or local memory. Semantics follow jnp on
// float32 / int32 / bool exactly:
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

#include "hs_kernels.h"
#include "record.cuh"

namespace {

constexpr int kBlock = 256;

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

// a transcendental unary: flushed operand and result; SIN, TAN, ATAN and
// TANH pass a subnormal operand through (XLA returns a tiny x as it is)
__device__ __forceinline__ uint32_t unary_f(int op, uint32_t xu) {
    const float x = ftz(asf(xu));
    float r;
    switch (op) {
    case HS_OP_SIN_F: r = sinf(x); break;
    case HS_OP_COS_F: r = cosf(x); break;
    case HS_OP_TAN_F: r = tanf(x); break;
    case HS_OP_ASIN_F:  // XLA's asin halves x first
        r = fabsf(x) < 2.0f * kFltMin ? __uint_as_float(xu & 0x80000000u)
                                      : asinf(x);
        break;
    case HS_OP_ACOS_F: r = acosf(x); break;
    case HS_OP_ATAN_F: r = atanf(x); break;
    case HS_OP_SINH_F: r = sinhf(x); break;
    case HS_OP_COSH_F: r = coshf(x); break;
    case HS_OP_TANH_F: r = tanhf(x); break;
    case HS_OP_ASINH_F: r = asinhf(x); break;
    case HS_OP_ACOSH_F: r = acoshf(x); break;
    case HS_OP_ATANH_F: r = atanhf(x); break;
    case HS_OP_LOG_F: r = logf(x); break;
    case HS_OP_LOG2_F: r = log2f(x); break;
    case HS_OP_LOG10_F: r = log10f(x); break;
    default: r = expf(x); break;  // HS_OP_EXP_F
    }
    const bool tiny_identity = op == HS_OP_SIN_F || op == HS_OP_TAN_F ||
                               op == HS_OP_ATAN_F || op == HS_OP_TANH_F;
    if (tiny_identity && (xu & 0x7F800000u) == 0u) return xu;
    return fb(ftz(r));
}

__global__ void __launch_bounds__(kBlock)
expr_kernel(const __grid_constant__ HsExprArgs a) {
    const int i = blockIdx.x * kBlock + threadIdx.x;
    if (i >= a.n) return;
    for (int p = 0; p < a.n_progs; ++p) {
        const HsExprProg &pr = a.progs[p];
        uint32_t st[HS_EXPR_MAX_DEPTH];
        int sp = 0;
        for (int o = pr.first; o < pr.first + pr.n_ops; ++o) {
            const int op = a.ops[o].op;
            const int arg = a.ops[o].arg;
            if (op == HS_OP_COL) {
                const void *c = a.cols[arg];
                st[sp++] = a.col_type[arg] == HS_T_BOOL
                    ? (uint32_t)(((const uint8_t *)c)[i] != 0)
                    : ((const uint32_t *)c)[i];
                continue;
            }
            if (op == HS_OP_LIT) {
                st[sp++] = (uint32_t)arg;
                continue;
            }
            uint32_t &x = st[sp - 1];
            switch (op) {  // unary ops and conversions, in place
            case HS_OP_B2I: continue;  // a bool is already 0/1
            case HS_OP_B2F: x = fb(x ? 1.0f : 0.0f); continue;
            case HS_OP_I2F: x = fb(__int2float_rn((int)x)); continue;
            case HS_OP_NOT_B: x ^= 1u; continue;
            case HS_OP_NOT_I: x = ~x; continue;
            case HS_OP_NEG_I: x = 0u - x; continue;
            // float negate and abs flip and clear the sign bit, as
            // XLA and PyTorch's CPU do (a subnormal is kept); a NaN as
            // PyTorch's CUDA kernels give it (-a, fabsf)
            case HS_OP_NEG_F:
                x = isnan(asf(x)) ? fb(-asf(x)) : x ^ 0x80000000u;
                continue;
            case HS_OP_ABS_I: x = (int)x < 0 ? 0u - x : x; continue;
            case HS_OP_ABS_F:
                x = isnan(asf(x)) ? fb(fabsf(asf(x))) : x & 0x7FFFFFFFu;
                continue;
            case HS_OP_CEIL_F: x = fb(ceilf(ftz(asf(x)))); continue;
            case HS_OP_FLOOR_F: x = fb(floorf(ftz(asf(x)))); continue;
            case HS_OP_ROUND_F: x = fb(rintf(ftz(asf(x)))); continue;
            case HS_OP_SIGN_I: x = (uint32_t)(((int)x > 0) - ((int)x < 0));
                continue;
            case HS_OP_SIGN_F: {
                const float v = ftz(asf(x));
                x = v > 0.0f ? fb(1.0f) : v < 0.0f ? fb(-1.0f) : fb(v);
                continue;
            }
            case HS_OP_SQRT_F: x = fb(__fsqrt_rn(ftz(asf(x)))); continue;
            default:
                if (op >= HS_OP_SIN_F && op <= HS_OP_EXP_F) {
                    x = unary_f(op, x);
                    continue;
                }
                break;
            }
            const uint32_t b = st[--sp];
            uint32_t &l = st[sp - 1];
            const int li = (int)l, bi = (int)b;
            const float lf = ftz(asf(l)), bf = ftz(asf(b));
            switch (op) {
            case HS_OP_ADD_I: l = l + b; break;
            case HS_OP_ADD_F: l = fb(ftz(__fadd_rn(lf, bf))); break;
            case HS_OP_SUB_I: l = l - b; break;
            case HS_OP_SUB_F: l = fb(ftz(__fsub_rn(lf, bf))); break;
            case HS_OP_MUL_I: l = l * b; break;
            case HS_OP_MUL_F: l = fb(ftz(__fmul_rn(lf, bf))); break;
            case HS_OP_DIV_F: l = fb(ftz(__fdiv_rn(lf, bf))); break;
            case HS_OP_MOD_I: l = mod_i(l, b); break;
            case HS_OP_MOD_F: l = mod_f(l, b); break;
            case HS_OP_OR_B: l = (l | b) != 0u; break;
            case HS_OP_AND_B: l = (l & b) != 0u; break;
            case HS_OP_OR_I: l = l | b; break;
            case HS_OP_AND_I: l = l & b; break;
            case HS_OP_EQ_I: l = li == bi; break;
            case HS_OP_NE_I: l = li != bi; break;
            case HS_OP_LT_I: l = li < bi; break;
            case HS_OP_LE_I: l = li <= bi; break;
            case HS_OP_GT_I: l = li > bi; break;
            case HS_OP_GE_I: l = li >= bi; break;
            case HS_OP_EQ_F: l = lf == bf; break;
            case HS_OP_NE_F: l = lf != bf; break;
            case HS_OP_LT_F: l = lf < bf; break;
            case HS_OP_LE_F: l = lf <= bf; break;
            case HS_OP_GT_F: l = lf > bf; break;
            case HS_OP_GE_F: l = lf >= bf; break;
            case HS_OP_SEL_L: l = l ? b : 0u; break;
            case HS_OP_SEL_R: l = b ? l : 0u; break;
            default: break;
            }
        }
        const uint32_t r = st[0];
        if (pr.where)
            a.valid[i] = a.valid[i] && r != 0u;
        else if (pr.out_type == HS_T_BOOL)
            ((uint8_t *)pr.out)[i] = r != 0u;
        else
            ((uint32_t *)pr.out)[i] = r;
    }
}

}  // namespace

extern "C" int hs_expr(const HsExprArgs *args, void *stream) {
    if (args->n == 0 || args->n_progs == 0) return 0;
    unsigned blocks = (unsigned)((args->n + kBlock - 1) / kBlock);
    expr_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(*args);
    return (int)cudaGetLastError();
}
