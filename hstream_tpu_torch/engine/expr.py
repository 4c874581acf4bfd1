"""Scalar expressions: one AST, two evaluators (the port of
hstream_tpu/engine/expr.py).

The reference interprets scalar expressions over Aeson JSON values per
record (hstream-sql Internal/Codegen.hs:76-250, op enums AST.hs:87-105).
Here the same AST is evaluated two ways:

  * `compile_device(expr, schema)` lowers it into a DeviceProgram, a
    postfix program over 32-bit words for WHERE masks and computed
    aggregate inputs, with jnp's type rules resolved at compile time into
    explicit conversions (the reference traces jnp code into its step,
    expr.py:122-183); `lower(prog)` turns that into the register form the
    expression kernel (kernels/csrc/expr.cu) runs: an accumulator a
    record, each instruction's operand a column, a literal or a spill
    slot. `DeviceProgram.__call__` is the plain PyTorch version that runs
    the postfix ops, `run_lowered` the one that runs the register form;
    `eval_programs` is the kernel's wrapper;
  * `eval_host(expr, row)` and its columnwise twin `eval_host_vec` run on
    the host for HAVING and SELECT projections over emitted aggregate
    rows, which are tiny compared to the ingest stream.

`encode_strings` rewrites string literals to dictionary ids.
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, NamedTuple, Sequence

import torch

from hstream_tpu_torch.common.errors import SQLCodegenError
from hstream_tpu_torch.common.tracing import compile_site
from hstream_tpu_torch.engine.kernels import binding as kb
from hstream_tpu_torch.engine.types import ColumnType, Schema, StringDictionary


# ---- AST -------------------------------------------------------------------

class Expr:
    pass


@dataclass(frozen=True)
class Col(Expr):
    name: str
    stream: str | None = None  # qualified `stream.field` references


@dataclass(frozen=True)
class Lit(Expr):
    value: Any  # int | float | str | bool | None


@dataclass(frozen=True)
class BinOp(Expr):
    op: str  # + - * / % = <> < <= > >= AND OR
    left: Expr
    right: Expr


@dataclass(frozen=True)
class UnOp(Expr):
    op: str  # NOT NEG SIN COS ... STRLEN TO_UPPER ...
    operand: Expr


def columns_of(e: Expr) -> set[str]:
    if isinstance(e, Col):
        return {e.name}
    if isinstance(e, BinOp):
        return columns_of(e.left) | columns_of(e.right)
    if isinstance(e, UnOp):
        return columns_of(e.operand)
    return set()


# ---- device compilation ----------------------------------------------------

def _is_string_expr(e: Expr, schema: Schema) -> bool:
    if isinstance(e, Col):
        return schema.has(e.name) and schema.type_of(e.name) == ColumnType.STRING
    if isinstance(e, Lit):
        return isinstance(e.value, str)
    return False


def encode_strings(expr: Expr, schema: Schema,
                   dicts: Mapping[str, StringDictionary]) -> Expr:
    """Rewrite string-vs-column comparisons into dictionary-id comparisons.

    Encoding the literal inserts it into the column's dictionary, so later
    record values of the same string map to the same id. The resulting
    expression is fully hashable and dictionary-free, which lets compiled
    step functions be shared across executors (lru_cache in lattice.py)."""
    if isinstance(expr, BinOp):
        if expr.op in ("=", "<>") and (_is_string_expr(expr.left, schema)
                                       or _is_string_expr(expr.right, schema)):
            col_e, lit_e = ((expr.left, expr.right)
                            if isinstance(expr.right, Lit)
                            else (expr.right, expr.left))
            if not isinstance(col_e, Col) or not isinstance(lit_e, Lit):
                raise SQLCodegenError(
                    "device string comparison must be column vs literal")
            lit_id = dicts[col_e.name].encode(str(lit_e.value))
            return BinOp(expr.op, col_e, Lit(lit_id))
        return BinOp(expr.op, encode_strings(expr.left, schema, dicts),
                     encode_strings(expr.right, schema, dicts))
    if isinstance(expr, UnOp):
        return UnOp(expr.op, encode_strings(expr.operand, schema, dicts))
    return expr


# opcodes of the expression kernel (HS_OP_* in kernels/csrc/hs_kernels.h)
(OP_COL, OP_LIT, OP_B2I, OP_B2F, OP_I2F,
 OP_ADD_I, OP_ADD_F, OP_SUB_I, OP_SUB_F, OP_MUL_I, OP_MUL_F, OP_DIV_F,
 OP_MOD_I, OP_MOD_F, OP_OR_B, OP_AND_B, OP_OR_I, OP_AND_I,
 OP_EQ_I, OP_NE_I, OP_LT_I, OP_LE_I, OP_GT_I, OP_GE_I,
 OP_EQ_F, OP_NE_F, OP_LT_F, OP_LE_F, OP_GT_F, OP_GE_F,
 OP_NOT_B, OP_NOT_I, OP_NEG_I, OP_NEG_F, OP_ABS_I, OP_ABS_F,
 OP_SEL_L, OP_SEL_R,
 OP_CEIL_F, OP_FLOOR_F, OP_ROUND_F, OP_SIGN_I, OP_SIGN_F, OP_SQRT_F,
 OP_SIN_F, OP_COS_F, OP_TAN_F, OP_ASIN_F, OP_ACOS_F, OP_ATAN_F,
 OP_SINH_F, OP_COSH_F, OP_TANH_F, OP_ASINH_F, OP_ACOSH_F, OP_ATANH_F,
 OP_LOG_F, OP_LOG2_F, OP_LOG10_F, OP_EXP_F) = range(60)
_BINARY = frozenset(range(OP_ADD_I, OP_GE_F + 1)) | {OP_SEL_L, OP_SEL_R}

_COL_DTYPE = {ColumnType.FLOAT: "f32", ColumnType.INT: "i32",
              ColumnType.BOOL: "bool", ColumnType.STRING: "i32"}
_TORCH = {"f32": torch.float32, "i32": torch.int32, "bool": torch.bool}
_CMP = {"=": (OP_EQ_I, OP_EQ_F), "<>": (OP_NE_I, OP_NE_F),
        "<": (OP_LT_I, OP_LT_F), "<=": (OP_LE_I, OP_LE_F),
        ">": (OP_GT_I, OP_GT_F), ">=": (OP_GE_I, OP_GE_F)}
_ARITH = {"+": (OP_ADD_I, OP_ADD_F), "-": (OP_SUB_I, OP_SUB_F),
          "*": (OP_MUL_I, OP_MUL_F), "%": (OP_MOD_I, OP_MOD_F)}
# the reference's device unaries beyond NEG/ABS (hstream_tpu/engine/
# expr.py:70-79 _NUM_UNARY) with jnp's result types: CEIL, FLOOR and
# ROUND keep an int32 operand as it is (and CEIL/FLOOR a bool), SIGN of
# an int32 is int32, the rest convert an int32 or bool operand to f32
_KEEP_INT = {"CEIL": OP_CEIL_F, "FLOOR": OP_FLOOR_F, "ROUND": OP_ROUND_F,
             "SIGN": OP_SIGN_F}
_FLOAT_UNARY = {
    "SQRT": OP_SQRT_F, "SIN": OP_SIN_F, "COS": OP_COS_F, "TAN": OP_TAN_F,
    "ASIN": OP_ASIN_F, "ACOS": OP_ACOS_F, "ATAN": OP_ATAN_F,
    "SINH": OP_SINH_F, "COSH": OP_COSH_F, "TANH": OP_TANH_F,
    "ASINH": OP_ASINH_F, "ACOSH": OP_ACOSH_F, "ATANH": OP_ATANH_F,
    "LOG": OP_LOG_F, "LOG2": OP_LOG2_F, "LOG10": OP_LOG10_F,
    "EXP": OP_EXP_F}


@dataclass(frozen=True)
class DeviceProgram:
    """A postfix program over a record's columns: `ops` are (opcode, arg)
    pairs, arg the index into `cols` for OP_COL and the literal's 32 bits
    for OP_LIT; `dtype` ("f32" | "i32" | "bool") is the result's type,
    jnp's for the same expression."""

    ops: tuple[tuple[int, int], ...]
    types: tuple[str, ...]  # the type each op leaves on top of the stack
    cols: tuple[str, ...]
    dtype: str
    has_unary: bool = field(default=False, compare=False)  # runs B1b'

    def __call__(self, cols: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The plain PyTorch version: the same ops, one tensor op each."""
        return _run_plain(self, cols)


def _lit(v: Any) -> tuple[int, int, str]:
    if isinstance(v, str):
        raise SQLCodegenError(
            "string literal not pre-encoded (see encode_strings)")
    if v is None:
        raise SQLCodegenError("NULL literal unsupported on device")
    if isinstance(v, bool):
        return OP_LIT, int(v), "bool"
    if isinstance(v, float):
        return OP_LIT, struct.unpack("<i", struct.pack("<f", v))[0], "f32"
    if isinstance(v, int):
        if not -(1 << 31) <= v < (1 << 31):
            raise SQLCodegenError(f"integer literal {v} exceeds int32")
        return OP_LIT, int(v), "i32"
    raise SQLCodegenError(f"literal {v!r} unsupported on device")


Op = tuple[int, int, str]  # (opcode, arg, the type it leaves on top)


def _cvt(src: str, dst: str) -> list[Op]:
    if src == dst:
        return []
    return [({("bool", "i32"): OP_B2I, ("bool", "f32"): OP_B2F,
              ("i32", "f32"): OP_I2F}[(src, dst)], 0, dst)]


def _promote(a: str, b: str) -> str:
    return "f32" if "f32" in (a, b) else "i32"


def compile_device(expr: Expr, schema: Schema) -> DeviceProgram:
    """Lower `expr` into a DeviceProgram. String literals must be
    pre-encoded via encode_strings. Types follow jnp on float32 / int32 /
    bool: int32 arithmetic stays int32 and wraps, int with float gives
    float32, `/` always gives float32, `%` is floored, bool `+`/`*` are
    OR/AND, a number times a bool is the number or 0 (XLA's select, so
    NaN * false is 0), AND/OR/NOT on ints are bitwise, the unaries
    follow jnp's result types (_KEEP_INT, _FLOAT_UNARY). Raises
    SQLCodegenError for what the reference refuses (host-only ops, NULL
    literals, `-` of two bools, float operands of AND/OR/NOT, ROUND and
    SIGN of a bool: jnp raises when the reference's step is traced)."""
    cols: list[str] = []

    def col_index(name: str) -> int:
        if name not in cols:
            cols.append(name)
        return cols.index(name)

    def build(e: Expr) -> tuple[list[Op], str]:
        if isinstance(e, Col):
            if schema is None or not schema.has(e.name):
                raise SQLCodegenError(f"unknown column {e.name}")
            t = _COL_DTYPE[schema.type_of(e.name)]
            return [(OP_COL, col_index(e.name), t)], t
        if isinstance(e, Lit):
            op = _lit(e.value)
            return [op], op[2]
        if isinstance(e, BinOp):
            op = e.op
            lops, lt = build(e.left)
            rops, rt = build(e.right)

            def both(t: str, code: int, out: str) -> tuple[list[Op], str]:
                return (lops + _cvt(lt, t) + rops + _cvt(rt, t)
                        + [(code, 0, out)]), out

            if op in ("+", "*") and lt == rt == "bool":
                return both("bool", OP_OR_B if op == "+" else OP_AND_B,
                            "bool")
            if op == "*" and "bool" in (lt, rt):
                # XLA rewrites x * convert(b) into select(b, x, 0)
                t = rt if lt == "bool" else lt
                return lops + rops + [(OP_SEL_L if lt == "bool"
                                       else OP_SEL_R, 0, t)], t
            if op in _ARITH:
                if op == "-" and lt == rt == "bool":
                    raise SQLCodegenError("`-` of two booleans")
                t = _promote(lt, rt)
                return both(t, _ARITH[op][t == "f32"], t)
            if op == "/":
                return both("f32", OP_DIV_F, "f32")
            if op in _CMP:
                t = _promote(lt, rt)
                return both(t, _CMP[op][t == "f32"], "bool")
            if op in ("AND", "OR"):
                if "f32" in (lt, rt):
                    raise SQLCodegenError(f"{op} of a float operand")
                if lt == rt == "bool":
                    return both("bool", OP_AND_B if op == "AND"
                                else OP_OR_B, "bool")
                return both("i32", OP_AND_I if op == "AND" else OP_OR_I,
                            "i32")
            raise SQLCodegenError(f"unsupported device op {op}")
        if isinstance(e, UnOp):
            ops, t = build(e.operand)
            if e.op == "NOT":
                if t == "f32":
                    raise SQLCodegenError("NOT of a float operand")
                return ops + [(OP_NOT_B if t == "bool" else OP_NOT_I, 0, t)], t
            if e.op == "NEG":
                if t == "bool":
                    raise SQLCodegenError("NEG of a boolean")
                return ops + [(OP_NEG_F if t == "f32" else OP_NEG_I, 0, t)], t
            if e.op == "ABS":
                if t == "bool":
                    return ops, t
                return ops + [(OP_ABS_F if t == "f32" else OP_ABS_I, 0, t)], t
            if e.op in _KEEP_INT:
                if t == "bool":
                    if e.op in ("ROUND", "SIGN"):
                        raise SQLCodegenError(f"{e.op} of a boolean")
                    return ops, t
                if t == "i32":
                    if e.op == "SIGN":
                        return ops + [(OP_SIGN_I, 0, t)], t
                    return ops, t
                return ops + [(_KEEP_INT[e.op], 0, t)], t
            if e.op in _FLOAT_UNARY:
                return (ops + _cvt(t, "f32")
                        + [(_FLOAT_UNARY[e.op], 0, "f32")]), "f32"
            raise SQLCodegenError(f"op {e.op} is host-only")
        raise SQLCodegenError(f"unknown expr {e!r}")

    ops, dtype = build(expr)
    prog = DeviceProgram(ops=tuple((c, a) for c, a, _ in ops),
                         types=tuple(t for _, _, t in ops),
                         cols=tuple(cols), dtype=dtype,
                         has_unary=any(c >= OP_CEIL_F for c, _, _ in ops))
    # the kernel's one limit on a program: its register form's spill
    # slots (a tree of 2^(MAX_SLOTS + 2) leaves or more, balanced);
    # refused here, on every device, where the reference traces it
    slots = lower(prog).slots
    if slots > MAX_SLOTS:
        raise SQLCodegenError(
            f"expression needs {slots} spill slots, the device has "
            f"{MAX_SLOTS}")
    return prog


# ---- the plain version of the expression kernel -----------------------------

_M32 = 0xFFFFFFFF
_FLT_MIN = 2.0 ** -126  # the smallest normal float32


def ftz(x: torch.Tensor) -> torch.Tensor:
    """float32 subnormals flushed to a zero of their sign, as XLA's CPU
    backend (and a TPU) flushes the operands and results of float
    arithmetic, comparisons, min/max and the unaries; other dtypes pass
    through. The kernels flush the same values (built with --ftz=true;
    explicitly where a float's bits are read)."""
    if x.dtype != torch.float32:
        return x
    return torch.where(x.abs() < _FLT_MIN, x * 0.0, x)


def is_subnormal(x: torch.Tensor) -> torch.Tensor:
    return (x != 0) & (x.abs() < _FLT_MIN)


def _wrap(x: torch.Tensor) -> torch.Tensor:
    """int64 values taken mod 2^32 -> int32 (int32 wrap-around)."""
    x = x & _M32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _int_op(code: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = a.long(), b.long()
    if code == OP_ADD_I:
        return _wrap(a + b)
    if code == OP_SUB_I:
        return _wrap(a - b)
    if code == OP_MUL_I:
        return _wrap(a * b)
    if code == OP_MOD_I:  # floored; a divisor of 0 is taken as 1
        return _wrap(torch.remainder(a, torch.where(b == 0, 1, b)))
    if code == OP_AND_I:
        return _wrap(a & b)
    return _wrap(a | b)   # OP_OR_I


def _float_op(code: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A float binary op with XLA's CPU subnormal flush: operands and
    result flushed, but for jnp.remainder's (OP_MOD_F) select, which
    passes a subnormal remainder (or a dividend smaller than the divisor)
    through unflushed."""
    fa, fb = ftz(a), ftz(b)
    if code == OP_ADD_F:
        return ftz(fa + fb)
    if code == OP_SUB_F:
        return ftz(fa - fb)
    if code == OP_MUL_F:
        return ftz(fa * fb)
    if code == OP_DIV_F:
        return ftz(fa / fb)
    # OP_MOD_F, as jnp.remainder: XLA's rem on flushed operands, exact
    # and unflushed (taken in float64, where fmod is exact; a dividend
    # smaller than the divisor comes back as it is; a NaN as the quiet
    # NaN, the kernel's too), then the floored correction on flushed
    # values
    rem = torch.fmod(fa.double(), fb.double()).float()
    rem = torch.where(torch.isnan(rem), float("nan"), rem)  # one NaN
    r = torch.where(fa.abs() < fb.abs(), a, rem)
    fr = ftz(r)
    return torch.where((fr != 0) & ((fr < 0) != (fb < 0)), ftz(fr + fb), r)


_CMP_FN = {OP_EQ_I: torch.eq, OP_NE_I: torch.ne, OP_LT_I: torch.lt,
           OP_LE_I: torch.le, OP_GT_I: torch.gt, OP_GE_I: torch.ge}


_UNARY_FN = {
    OP_CEIL_F: torch.ceil, OP_FLOOR_F: torch.floor,
    OP_ROUND_F: torch.round,  # half to even, as jnp.round
    OP_SIN_F: torch.sin, OP_COS_F: torch.cos, OP_TAN_F: torch.tan,
    OP_ASIN_F: torch.asin, OP_ACOS_F: torch.acos, OP_ATAN_F: torch.atan,
    OP_SINH_F: torch.sinh, OP_COSH_F: torch.cosh, OP_TANH_F: torch.tanh,
    OP_ASINH_F: torch.asinh, OP_ACOSH_F: torch.acosh,
    OP_ATANH_F: torch.atanh, OP_LOG_F: torch.log, OP_LOG2_F: torch.log2,
    OP_LOG10_F: torch.log10, OP_EXP_F: torch.exp}


# XLA's SIN, TAN, ATAN and TANH return a tiny operand as it is, so a
# subnormal one passes through them unflushed
_TINY_IDENTITY = frozenset({OP_SIN_F, OP_TAN_F, OP_ATAN_F, OP_TANH_F})


def _unary_plain(code: int, x: torch.Tensor) -> torch.Tensor:
    if code == OP_SIGN_I:
        return (x > 0).int() - (x < 0).int()
    fx = ftz(x)
    if code == OP_SQRT_F:
        # in float64, rounded once: correctly rounded, as XLA's and
        # the kernel's sqrt are (PyTorch's vectorized CPU sqrt is not)
        return fx.double().sqrt().float()
    if code == OP_SIGN_F:  # jnp.sign: -0.0 stays -0.0, NaN stays NaN
        return torch.where(fx > 0, 1.0, torch.where(fx < 0, -1.0, fx))
    r = ftz(_UNARY_FN[code](fx))
    if code == OP_ASIN_F:  # XLA's asin halves x first: flushed below 2^-125
        return torch.where(fx.abs() < 2 * _FLT_MIN, fx * 0.0, r)
    return torch.where(is_subnormal(x), x, r) \
        if code in _TINY_IDENTITY else r


def _lit_tensor(bits: int, t: str, dev) -> torch.Tensor:
    lit = torch.tensor(bits, dtype=torch.int32, device=dev)
    return (lit.view(torch.float32) if t == "f32"
            else lit != 0 if t == "bool" else lit)


def _unary(code: int, x: torch.Tensor) -> torch.Tensor:
    """A conversion or unary op of the plain versions."""
    if code >= OP_CEIL_F:
        return _unary_plain(code, x)
    if code == OP_B2I:
        return x.to(torch.int32)
    if code in (OP_B2F, OP_I2F):
        return x.to(torch.float32)
    if code in (OP_NOT_B, OP_NOT_I):
        return ~x
    if code == OP_NEG_I:
        return _wrap(-x.long())
    if code == OP_NEG_F:
        return -x
    if code == OP_ABS_I:
        return _wrap(x.long().abs())
    return x.abs()   # OP_ABS_F


def _binary(code: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A binary op of the plain versions, a its left operand."""
    if code == OP_SEL_L:
        return torch.where(a, b, torch.zeros_like(b))
    if code == OP_SEL_R:
        return torch.where(b, a, torch.zeros_like(a))
    if code in (OP_OR_B, OP_AND_B):
        return a | b if code == OP_OR_B else a & b
    if code in _CMP_FN:
        return _CMP_FN[code](a, b)
    if OP_EQ_F <= code <= OP_GE_F:
        return _CMP_FN[code - (OP_EQ_F - OP_EQ_I)](ftz(a), ftz(b))
    if code in (OP_ADD_F, OP_SUB_F, OP_MUL_F, OP_DIV_F, OP_MOD_F):
        return _float_op(code, a, b)
    return _int_op(code, a, b)


def _run_plain(prog: DeviceProgram, cols: Mapping[str, torch.Tensor]
               ) -> torch.Tensor:
    ref = cols[prog.cols[0]] if prog.cols else next(iter(cols.values()))
    dev, n = ref.device, ref.shape[0]
    st: list[torch.Tensor] = []
    for (code, arg), t in zip(prog.ops, prog.types):
        if code == OP_COL:
            st.append(cols[prog.cols[arg]])
        elif code == OP_LIT:
            st.append(_lit_tensor(arg, t, dev))
        elif code in _BINARY:
            b = st.pop()
            st.append(_binary(code, st.pop(), b))
        else:
            st.append(_unary(code, st.pop()))
    return st[0].expand(n).contiguous()


# ---- the register form the kernel runs --------------------------------------

# the register form's own opcodes (HS_OP_LOAD, HS_OP_SPILL) and operand
# sources (HS_SRC_*), kernels/csrc/hs_kernels.h
OP_LOAD, OP_SPILL = 60, 61
SRC_NONE, SRC_COL, SRC_LIT, SRC_SLOT = range(4)
MAX_SLOTS = kb.EXPR_MAX_SLOTS   # spill slots in shared memory
_CVT = frozenset({OP_B2I, OP_B2F, OP_I2F})


class Ins(NamedTuple):
    """One instruction of the register form: the accumulator takes `op`
    (OP_LOAD: the operand; OP_SPILL: it goes to slot `arg`; a unary or a
    conversion in place; a binary with the operand as its right side, or
    its left with `swap`)."""

    op: int
    src: int = SRC_NONE   # where the operand comes from
    arg: int = 0          # column index, literal bits or slot
    cvt: int = 0          # 0 or OP_B2I / OP_B2F / OP_I2F on the operand
    swap: bool = False
    t: str = ""           # the operand's type before cvt

    def word(self) -> int:
        """The kernel's packed op word (HsExprOp.op)."""
        return self.op | self.src << 8 | self.cvt << 16 | int(self.swap) << 24


class Lowered(NamedTuple):
    ins: tuple[Ins, ...]
    slots: int   # spill slots it needs (compile_device refuses > MAX_SLOTS)


@functools.lru_cache(maxsize=512)
@compile_site("expr.lower")
def lower(prog: DeviceProgram) -> Lowered:
    """The postfix program in the register form the kernel runs. A leaf
    (a column or a literal, with at most one conversion) is an operand
    in place; a binary op whose sides are both computed runs first the
    side that needs more slots (Sethi and Ullman's order), keeps it in a
    spill slot and names it as the operand, so the slots never exceed the
    postfix stack's depth less one. Every op keeps its operands' order
    and its arithmetic, so the result is the postfix program's bit for
    bit. The tree is kept as indices into the postfix ops (children
    before parents), so a program of any size lowers in time linear in
    its ops and its depth. A miss counts as one compile
    (common/tracing.RetraceGuard) and one row of the compiled-program
    inventory."""
    kids: list[tuple[int, ...]] = []
    stack: list[int] = []
    for i, (code, _arg) in enumerate(prog.ops):
        if code in (OP_COL, OP_LIT):
            kids.append(())
        elif code in _BINARY:
            b = stack.pop()
            kids.append((stack.pop(), b))
        else:
            kids.append((stack.pop(),))
        stack.append(i)
    (root,) = stack

    def leaf(i: int) -> Ins | None:
        code, arg = prog.ops[i]
        if code in (OP_COL, OP_LIT):
            return Ins(OP_LOAD, SRC_COL if code == OP_COL else SRC_LIT, arg,
                       t=prog.types[i])
        if code in _CVT and not kids[kids[i][0]]:
            return leaf(kids[i][0])._replace(cvt=code)
        return None

    operand = [leaf(i) for i in range(len(kids))]
    need = [0] * len(kids)       # spill slots a node needs
    for i, k in enumerate(kids):  # postfix: children first
        if operand[i] is not None:
            continue
        if len(k) == 1:
            need[i] = need[k[0]]
            continue
        l, r = k
        if operand[r] is not None:
            need[i] = need[l]
        elif operand[l] is not None:
            need[i] = need[r]
        else:
            first, second = (r, l) if need[r] >= need[l] else (l, r)
            need[i] = max(need[first], 1 + need[second])

    out: list[Ins] = []

    def gen(i: int, s: int) -> None:
        if operand[i] is not None:
            out.append(operand[i])
            return
        code = prog.ops[i][0]
        if len(kids[i]) == 1:
            gen(kids[i][0], s)
            out.append(Ins(code))
            return
        l, r = kids[i]
        if operand[r] is not None:
            gen(l, s)
            out.append(operand[r]._replace(op=code))
        elif operand[l] is not None:
            gen(r, s)
            out.append(operand[l]._replace(op=code, swap=True))
        else:
            swap = need[r] < need[l]   # the left side first
            first, second = (l, r) if swap else (r, l)
            gen(first, s)
            out.append(Ins(OP_SPILL, arg=s))
            gen(second, s + 1)
            out.append(Ins(code, SRC_SLOT, s, swap=swap,
                           t=prog.types[first]))

    gen(root, 0)
    return Lowered(tuple(out), need[root])


def run_lowered(prog: DeviceProgram, cols: Mapping[str, torch.Tensor]
                ) -> torch.Tensor:
    """The plain PyTorch version of the register form (`lower(prog)`):
    an accumulator, operands and spill slots, one tensor op an
    instruction, as the kernel runs it. Equal to `prog(cols)` bit for
    bit (tests/test_torch_expr_plan.py)."""
    ref = cols[prog.cols[0]] if prog.cols else next(iter(cols.values()))
    dev, n = ref.device, ref.shape[0]
    low = lower(prog)
    slots: list[torch.Tensor | None] = [None] * low.slots
    acc: torch.Tensor | None = None
    for ins in low.ins:
        if ins.op == OP_SPILL:
            slots[ins.arg] = acc
            continue
        x = (cols[prog.cols[ins.arg]] if ins.src == SRC_COL
             else _lit_tensor(ins.arg, ins.t, dev) if ins.src == SRC_LIT
             else slots[ins.arg] if ins.src == SRC_SLOT else None)
        if ins.cvt:
            x = _unary(ins.cvt, x)
        if ins.op == OP_LOAD:
            acc = x
        elif x is None:
            acc = _unary(ins.op, acc)
        else:
            acc = _binary(ins.op, *((x, acc) if ins.swap else (acc, x)))
    return acc.expand(n).contiguous()


def eval_programs(progs: Sequence[tuple[DeviceProgram, str | None]],
                  cols: dict[str, torch.Tensor], valid: torch.Tensor) -> None:
    """Run a step's programs over one decoded batch, in place: a program
    paired with a name adds that computed column to `cols`; the one
    paired with None is the WHERE mask, ANDed into `valid`. The
    expression kernel on the card, one launch for a program set that
    fits one argument block (launch_plan), one per block past it; the
    plain versions for a batch on the CPU."""
    if not progs:
        return
    if valid.device.type == "cpu":
        for prog, name in progs:
            r = prog(cols)
            if name is None:
                valid.logical_and_(r)
            else:
                cols[name] = r
        return
    plan = launch_plan(tuple(progs))
    _expr_cuda(plan, progs, cols, valid)
    eval_programs.launches += len(plan.blocks)
    eval_programs.unary_launches += sum(b.unary for b in plan.blocks)


eval_programs.launches = 0  # kernel launches (one a block of the plan)
eval_programs.unary_launches = 0  # of those, launches that ran a unary


class LaunchBlock(NamedTuple):
    progs: tuple[tuple[DeviceProgram, str | None], ...]   # its pieces
    args: bytes     # the HsExprArgs block but its pointers and n
    cols: tuple[tuple[str, torch.dtype], ...]   # the column table
    outs: tuple[tuple[int, str, torch.dtype], ...]   # (program, name, dtype)
    unary: bool     # a program of the block runs a unary (B1b')


class LaunchPlan(NamedTuple):
    """A program set's argument blocks, launched in order on one stream.
    A set within one block's tables (EXPR_MAX_PROGS programs,
    EXPR_MAX_OPS instructions, EXPR_MAX_COLS columns) is one block, one
    launch. Past them, programs go into further blocks, and a program
    past a block by itself is cut into pieces: a subtree runs as a
    program of its own into a temporary column (`temps`), which the rest
    reads as an operand. A value crosses a cut as the 32-bit word (or
    bool byte) the register would hold, so the result is the same bits."""

    blocks: tuple[LaunchBlock, ...]
    temps: frozenset[str]


_TEMP = "__expr_t"   # prefix of the temporary columns between pieces


def _fits(n_ins: int, n_cols: int) -> bool:
    return n_ins <= kb.EXPR_MAX_OPS and n_cols <= kb.EXPR_MAX_COLS


def split_program(prog: DeviceProgram, name: str | None, first_temp: int = 0
                  ) -> list[tuple[DeviceProgram, str | None]]:
    """`prog` as pieces that each fit one argument block, in the order
    they must run: each but the last writes a temporary column
    (`__expr_t{k}`, k from first_temp) that later pieces read; the last
    is the program's own (named `name`). A program that fits is itself.
    The cut is greedy from the leaves up: where a node's subtree grows
    past the block, its largest computed children become pieces."""
    if _fits(len(lower(prog).ins), len(prog.cols)):
        return [(prog, name)]
    # the tree: [code, arg, type, kids, size]; a column's arg is its name
    nodes: list[list] = []
    for (code, arg), t in zip(prog.ops, prog.types):
        if code == OP_COL:
            nodes.append([code, prog.cols[arg], t, [], None])
        elif code == OP_LIT:
            nodes.append([code, arg, t, [], None])
        elif code in _BINARY:
            b = nodes.pop()
            nodes.append([code, arg, t, [nodes.pop(), b], None])
        else:
            nodes.append([code, arg, t, [nodes.pop()], None])
    (root,) = nodes
    pieces: list[tuple[DeviceProgram, str | None]] = []

    def is_operand(n) -> bool:
        return not n[3] or (n[0] in _CVT and not n[3][0][3])

    def size(n) -> tuple[int, frozenset]:
        """(register-form instructions, columns) of n's subtree as it
        stands, from its children's: lower()'s count, a leaf operand
        folded into its op, a computed right side spilled."""
        if is_operand(n):
            leaf = n[3][0] if n[3] else n
            return 1, frozenset([leaf[1]] if leaf[0] == OP_COL else [])
        kids = n[3]
        cols = frozenset().union(*(k[4][1] for k in kids))
        if len(kids) == 1:
            return kids[0][4][0] + 1, cols
        l, r = kids
        if is_operand(r):
            return l[4][0] + 1, cols
        if is_operand(l):
            return r[4][0] + 1, cols
        return l[4][0] + r[4][0] + 2, cols

    def postfix(n, ops, types, cols) -> None:
        for k in n[3]:
            postfix(k, ops, types, cols)
        code, arg, t = n[:3]
        if code == OP_COL:
            if arg not in cols:
                cols.append(arg)
            arg = cols.index(arg)
        ops.append((code, arg))
        types.append(t)

    def program(n) -> DeviceProgram:
        ops, types, cols = [], [], []
        postfix(n, ops, types, cols)
        return DeviceProgram(ops=tuple(ops), types=tuple(types),
                             cols=tuple(cols), dtype=n[2],
                             has_unary=any(c >= OP_CEIL_F for c, _ in ops))

    def fit(n) -> None:
        """Cut n's subtree (children first) until it fits a block."""
        for k in n[3]:
            fit(k)
        n[4] = size(n)
        while not _fits(n[4][0], len(n[4][1])):
            k = max((k for k in n[3] if not is_operand(k)),
                    key=lambda k: k[4][0] + len(k[4][1]))
            temp = f"{_TEMP}{first_temp + len(pieces)}"
            pieces.append((program(k), temp))
            k[:] = [OP_COL, temp, k[2], [], (1, frozenset([temp]))]
            n[4] = size(n)

    fit(root)
    return pieces + [(program(root), name)]


@functools.lru_cache(maxsize=64)
@compile_site("expr.launch_plan")
def launch_plan(progs: tuple[tuple[DeviceProgram, str | None], ...]
                ) -> LaunchPlan:
    """The kernel's argument blocks for a program set, built once: the
    programs' register forms (split_program's pieces past one block),
    each put into the first block whose tables still take it (first fit,
    in order) and that comes no earlier than the blocks writing the
    temporary columns it reads, at the end of that block; each block's
    columns numbered in one table. The programs are independent (WHERE
    programs AND into `valid`), so their order across blocks changes no
    bit. A launch copies a block and fills in n and the pointers. A miss
    counts as one compile (common/tracing.RetraceGuard) and one row of
    the compiled-program inventory."""
    pieces: list[tuple[DeviceProgram, str | None]] = []
    for prog, name in progs:
        if name is None and prog.dtype != "bool":
            raise ValueError("a WHERE program must give bool")
        pieces.extend(split_program(prog, name, len(pieces)))
    temps = frozenset(n for _, n in pieces
                      if n is not None and n.startswith(_TEMP))
    packed: list[list] = []        # per block: [pieces, instructions, table]
    block_of: dict[str, int] = {}  # a temporary column -> its writer's block
    for prog, name in pieces:
        n_ins = len(lower(prog).ins)
        cols = list(dict.fromkeys((prog.cols[i.arg], _TORCH[i.t])
                                  for i in lower(prog).ins
                                  if i.src == SRC_COL))
        first = max((block_of[c] for c, _ in cols if c in block_of),
                    default=0)
        for b in range(first, len(packed)):
            blk, ins, table = packed[b]
            more = [c for c in cols if c not in table]
            if len(blk) < kb.EXPR_MAX_PROGS and \
                    _fits(ins + n_ins, len(table) + len(more)):
                break
        else:
            b = len(packed)
            packed.append([[], 0, []])
        blk, ins, table = packed[b]
        assert _fits(ins + n_ins, len(table)), "a piece larger than a block"
        blk.append((prog, name))
        packed[b][1] = ins + n_ins
        table.extend(c for c in cols if c not in table)
        if name in temps:
            block_of[name] = b
    return LaunchPlan(tuple(_block(blk) for blk, _, _ in packed), temps)


def _block(pieces: Sequence[tuple[DeviceProgram, str | None]]
           ) -> LaunchBlock:
    """One argument block: the pieces' register forms packed in order,
    their columns numbered in one table."""
    args = kb.ExprArgs()
    args.n_progs = len(pieces)
    table: list[tuple[str, torch.dtype]] = []
    outs: list[tuple[int, str, torch.dtype]] = []
    first = 0
    for p, (prog, name) in enumerate(pieces):
        low = lower(prog)
        for i, ins in enumerate(low.ins):
            if ins.src == SRC_COL:
                entry = (prog.cols[ins.arg], _TORCH[ins.t])
                if entry not in table:
                    args.col_type[len(table)] = kb.VTYPES[entry[1]]
                    table.append(entry)
                ins = ins._replace(arg=table.index(entry))
            args.ops[first + i].op = ins.word()
            args.ops[first + i].arg = ins.arg
        pr = args.progs[p]
        pr.first, pr.n_ops = first, len(low.ins)
        pr.out_type = kb.VTYPES[_TORCH[prog.dtype]]
        if name is None:
            pr.where = 1
        else:
            outs.append((p, name, _TORCH[prog.dtype]))
        args.n_slots = max(args.n_slots, low.slots)
        first += len(low.ins)
    args.n_cols = len(table)
    return LaunchBlock(tuple(pieces), bytes(args), tuple(table), tuple(outs),
                       any(prog.has_unary for prog, _ in pieces))


def _expr_cuda(plan: LaunchPlan, progs, cols: dict[str, torch.Tensor],
               valid: torch.Tensor) -> None:
    n = valid.shape[0]
    work = dict(cols)
    stream = kb.stream_of(valid)
    for blk in plan.blocks:
        args = kb.ExprArgs.from_buffer_copy(blk.args)
        args.n = n
        args.valid = kb.ptr(valid)
        for k, (c, dtype) in enumerate(blk.cols):
            col = work[c]
            if col.dtype != dtype or col.shape[0] != n:
                raise ValueError(
                    f"expression: column {c} is not {dtype} [{n}]")
            args.cols[k] = kb.ptr(col)
        for p, name, dtype in blk.outs:
            work[name] = torch.empty(n, dtype=dtype, device=valid.device)
            args.progs[p].out = work[name].data_ptr()
        kb.check(kb.lib().hs_expr(ctypes.byref(args), stream), "expression")
    cols.update((name, work[name]) for _, name in progs if name is not None)


# ---- host interpreter ------------------------------------------------------

_HOST_UNARY: dict[str, Callable[[Any], Any]] = {
    "NEG": lambda x: -x,
    "NOT": lambda x: not x,
    "ABS": abs,
    "CEIL": lambda x: math.ceil(x),
    "FLOOR": lambda x: math.floor(x),
    "ROUND": lambda x: round(x),
    "SQRT": math.sqrt,
    "SIGN": lambda x: (x > 0) - (x < 0),
    "SIN": math.sin, "COS": math.cos, "TAN": math.tan,
    "ASIN": math.asin, "ACOS": math.acos, "ATAN": math.atan,
    "SINH": math.sinh, "COSH": math.cosh, "TANH": math.tanh,
    "ASINH": math.asinh, "ACOSH": math.acosh, "ATANH": math.atanh,
    "LOG": math.log, "LOG2": math.log2, "LOG10": math.log10, "EXP": math.exp,
    "IS_INT": lambda x: isinstance(x, int) and not isinstance(x, bool),
    "IS_FLOAT": lambda x: isinstance(x, float),
    "IS_NUM": lambda x: isinstance(x, (int, float)) and not isinstance(x, bool),
    "IS_BOOL": lambda x: isinstance(x, bool),
    "IS_STR": lambda x: isinstance(x, str),
    "IS_ARRAY": lambda x: isinstance(x, list),
    "TO_STR": str,
    "TO_UPPER": lambda x: str(x).upper(),
    "TO_LOWER": lambda x: str(x).lower(),
    "TRIM": lambda x: str(x).strip(),
    "LTRIM": lambda x: str(x).lstrip(),
    "RTRIM": lambda x: str(x).rstrip(),
    "REVERSE": lambda x: x[::-1],
    "STRLEN": len,
    "ARR_DISTINCT": lambda x: list(dict.fromkeys(x)),
    "ARR_LENGTH": len,
    "ARR_MAX": max,
    "ARR_MIN": min,
    "ARR_SORT": sorted,
    "ARR_SUM": sum,
    "IFNULL_CHECK": lambda x: x,  # placeholder; IFNULL handled as BinOp
}


def eval_host_vec(expr: Expr, cols: Mapping[str, Any]) -> Any:
    """Columnwise twin of eval_host over numpy arrays: evaluates HAVING
    and SELECT projections for a whole emitted batch in one pass instead
    of one interpreter walk per row (the window-close and changelog
    emission paths).

    The numeric/boolean/comparison core and the numeric unaries map to
    native numpy ufuncs; every remaining scalar op from the host
    interpreter — string builtins, type predicates, array ops, IFNULL —
    evaluates through a frompyfunc broadcast of the SAME host function,
    so joined projections over string/array columns stay columnar with
    semantics identical to the per-row interpreter. Only NULL literals
    (and genuinely unknown ops) still raise SQLCodegenError for the
    per-row fallback."""
    import numpy as np

    if isinstance(expr, Col):
        key = f"{expr.stream}.{expr.name}" if expr.stream else expr.name
        if key in cols:
            return cols[key]
        v = cols.get(expr.name)
        if v is None:
            raise SQLCodegenError(f"column {expr.name} not columnar")
        return v
    if isinstance(expr, Lit):
        if expr.value is None:
            raise SQLCodegenError("NULL literal: per-row fallback")
        return expr.value
    if isinstance(expr, BinOp):
        op = expr.op
        if op == "IFNULL":
            l = eval_host_vec(expr.left, cols)
            r = eval_host_vec(expr.right, cols)
            if np.ndim(l) == 0:
                return r if l is None else l
            la = np.asarray(l)
            if la.dtype != object:
                return la  # typed arrays cannot hold SQL NULLs
            mask = np.frompyfunc(lambda x: x is None, 1, 1)(
                la).astype(bool)
            if not mask.any():
                return la
            return np.where(mask, r, la)
        l = eval_host_vec(expr.left, cols)
        r = eval_host_vec(expr.right, cols)
        if op == "AND":
            return np.logical_and(l, r)
        if op == "OR":
            return np.logical_or(l, r)
        if op == "+":
            return l + r
        if op == "-":
            return l - r
        if op == "*":
            return l * r
        if op == "/":
            return l / r
        if op == "%":
            return l % r
        if op == "=":
            return l == r
        if op == "<>":
            return l != r
        if op == "<":
            return l < r
        if op == "<=":
            return l <= r
        if op == ">":
            return l > r
        if op == ">=":
            return l >= r
        if op == "ARR_CONTAINS":
            return np.frompyfunc(lambda a, b: b in a, 2, 1)(
                l, r).astype(bool)
        if op == "ARR_JOIN":
            return np.frompyfunc(
                lambda a, b: str(b).join(str(x) for x in a), 2, 1)(l, r)
        raise SQLCodegenError(f"op {op}: per-row fallback")
    if isinstance(expr, UnOp):
        op = expr.op
        v = eval_host_vec(expr.operand, cols)
        if op == "NOT":
            return np.logical_not(v)
        if op == "NEG":
            return -np.asarray(v)
        vec = {"ABS": np.abs, "CEIL": np.ceil, "FLOOR": np.floor,
               "ROUND": np.round, "SQRT": np.sqrt, "SIGN": np.sign,
               "SIN": np.sin, "COS": np.cos, "TAN": np.tan,
               "ASIN": np.arcsin, "ACOS": np.arccos, "ATAN": np.arctan,
               "SINH": np.sinh, "COSH": np.cosh, "TANH": np.tanh,
               "ASINH": np.arcsinh, "ACOSH": np.arccosh,
               "ATANH": np.arctanh, "LOG": np.log, "LOG2": np.log2,
               "LOG10": np.log10, "EXP": np.exp}.get(op)
        if vec is not None:
            arr = np.asarray(v)
            if arr.dtype != object:
                return vec(arr)
            # object column (e.g. ints mixed with NULL-bearing rows):
            # broadcast the exact host scalar through frompyfunc
        host_fn = _HOST_UNARY.get(op)
        if host_fn is None:
            raise SQLCodegenError(f"op {op}: per-row fallback")
        if np.ndim(v) == 0:
            return host_fn(v)
        out = np.frompyfunc(host_fn, 1, 1)(np.asarray(v, object))
        if op.startswith("IS_"):
            return out.astype(bool)
        return out
    raise SQLCodegenError(f"unknown expr {expr!r}")


def eval_host(expr: Expr, row: Mapping[str, Any]) -> Any:
    if isinstance(expr, Col):
        key = f"{expr.stream}.{expr.name}" if expr.stream else expr.name
        if key in row:
            return row[key]
        return row.get(expr.name)
    if isinstance(expr, Lit):
        return expr.value
    if isinstance(expr, BinOp):
        op = expr.op
        if op == "AND":
            return bool(eval_host(expr.left, row)) and bool(eval_host(expr.right, row))
        if op == "OR":
            return bool(eval_host(expr.left, row)) or bool(eval_host(expr.right, row))
        if op == "IFNULL":
            v = eval_host(expr.left, row)
            return eval_host(expr.right, row) if v is None else v
        l, r = eval_host(expr.left, row), eval_host(expr.right, row)
        if op == "+":
            return l + r
        if op == "-":
            return l - r
        if op == "*":
            return l * r
        if op == "/":
            return l / r
        if op == "%":
            return l % r
        if op == "=":
            return l == r
        if op == "<>":
            return l != r
        if op == "<":
            return l < r
        if op == "<=":
            return l <= r
        if op == ">":
            return l > r
        if op == ">=":
            return l >= r
        if op == "ARR_CONTAINS":
            return r in l
        if op == "ARR_JOIN":
            return str(r).join(str(x) for x in l)
        raise SQLCodegenError(f"unsupported host op {op}")
    if isinstance(expr, UnOp):
        fn = _HOST_UNARY.get(expr.op)
        if fn is None:
            raise SQLCodegenError(f"unsupported host op {expr.op}")
        return fn(eval_host(expr.operand, row))
    raise SQLCodegenError(f"unknown expr {expr!r}")
