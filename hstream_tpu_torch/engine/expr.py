"""Scalar expressions: one AST, two evaluators (the port of
hstream_tpu/engine/expr.py).

The reference interprets scalar expressions over Aeson JSON values per
record (hstream-sql Internal/Codegen.hs:76-250, op enums AST.hs:87-105).
Here the same AST is evaluated two ways:

  * `compile_device(expr, schema)` lowers it into a DeviceProgram, a
    postfix program over 32-bit stack words that the expression kernel
    (kernels/csrc/expr.cu) runs per record for WHERE masks and computed
    aggregate inputs, with jnp's type rules resolved at compile time into
    explicit conversions (the reference traces jnp code into its step,
    expr.py:122-183). `DeviceProgram.__call__` is the plain PyTorch
    version that runs the same ops; `eval_programs` is the kernel's
    wrapper;
  * `eval_host(expr, row)` and its columnwise twin `eval_host_vec` run on
    the host for HAVING and SELECT projections over emitted aggregate
    rows, which are tiny compared to the ingest stream.

`encode_strings` rewrites string literals to dictionary ids.
"""

from __future__ import annotations

import ctypes
import math
import struct
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Sequence

import torch

from hstream_tpu_torch.common.errors import SQLCodegenError
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

MAX_OPS = 64     # per program
MAX_DEPTH = 16   # stack slots (HS_EXPR_MAX_DEPTH)

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
    if len(ops) > MAX_OPS:
        raise SQLCodegenError(
            f"expression of {len(ops)} ops exceeds the device's {MAX_OPS}")
    depth = peak = 0
    for code, _, _ in ops:
        depth += 1 if code in (OP_COL, OP_LIT) else \
            -1 if code in _BINARY else 0
        peak = max(peak, depth)
    if peak > MAX_DEPTH:
        raise SQLCodegenError(
            f"expression needs {peak} stack slots, the device has "
            f"{MAX_DEPTH}")
    return DeviceProgram(ops=tuple((c, a) for c, a, _ in ops),
                         types=tuple(t for _, _, t in ops),
                         cols=tuple(cols), dtype=dtype,
                         has_unary=any(c >= OP_CEIL_F for c, _, _ in ops))


# ---- the plain version of the expression kernel -----------------------------

_M32 = 0xFFFFFFFF


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
    if code == OP_ADD_F:
        return a + b
    if code == OP_SUB_F:
        return a - b
    if code == OP_MUL_F:
        return a * b
    if code == OP_DIV_F:
        return a / b
    r = torch.fmod(a, b)  # OP_MOD_F, as jnp.remainder
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


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


def _unary_plain(code: int, x: torch.Tensor) -> torch.Tensor:
    if code == OP_SQRT_F:
        # in float64, rounded once: correctly rounded, as XLA's and
        # the kernel's sqrt are (PyTorch's vectorized CPU sqrt is not)
        return x.double().sqrt().float()
    if code == OP_SIGN_I:
        return (x > 0).int() - (x < 0).int()
    if code == OP_SIGN_F:  # jnp.sign: -0.0 stays -0.0, NaN stays NaN
        return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x))
    return _UNARY_FN[code](x)


def _run_plain(prog: DeviceProgram, cols: Mapping[str, torch.Tensor]
               ) -> torch.Tensor:
    ref = cols[prog.cols[0]] if prog.cols else next(iter(cols.values()))
    dev, n = ref.device, ref.shape[0]
    st: list[torch.Tensor] = []
    for (code, arg), t in zip(prog.ops, prog.types):
        if code == OP_COL:
            st.append(cols[prog.cols[arg]])
            continue
        if code == OP_LIT:
            lit = torch.tensor(arg, dtype=torch.int32, device=dev)
            st.append(lit.view(torch.float32) if t == "f32"
                      else lit != 0 if t == "bool" else lit)
            continue
        if code >= OP_CEIL_F:
            st.append(_unary_plain(code, st.pop()))
            continue
        if code in (OP_B2I, OP_B2F, OP_I2F, OP_NOT_B, OP_NOT_I, OP_NEG_I,
                    OP_NEG_F, OP_ABS_I, OP_ABS_F):
            x = st.pop()
            if code == OP_B2I:
                x = x.to(torch.int32)
            elif code in (OP_B2F, OP_I2F):
                x = x.to(torch.float32)
            elif code == OP_NOT_B:
                x = ~x
            elif code == OP_NOT_I:
                x = ~x
            elif code == OP_NEG_I:
                x = _wrap(-x.long())
            elif code == OP_NEG_F:
                x = -x
            elif code == OP_ABS_I:
                x = _wrap(x.long().abs())
            else:
                x = x.abs()
            st.append(x)
            continue
        b, a = st.pop(), st.pop()
        if code == OP_SEL_L:
            st.append(torch.where(a, b, torch.zeros_like(b)))
        elif code == OP_SEL_R:
            st.append(torch.where(b, a, torch.zeros_like(a)))
        elif code in (OP_OR_B, OP_AND_B):
            st.append(a | b if code == OP_OR_B else a & b)
        elif code in _CMP_FN:
            st.append(_CMP_FN[code](a, b))
        elif OP_EQ_F <= code <= OP_GE_F:
            st.append(_CMP_FN[code - (OP_EQ_F - OP_EQ_I)](a, b))
        elif code in (OP_ADD_F, OP_SUB_F, OP_MUL_F, OP_DIV_F, OP_MOD_F):
            st.append(_float_op(code, a, b))
        else:
            st.append(_int_op(code, a, b))
    return st[0].expand(n).contiguous()


def eval_programs(progs: Sequence[tuple[DeviceProgram, str | None]],
                  cols: dict[str, torch.Tensor], valid: torch.Tensor) -> None:
    """Run a step's programs over one decoded batch, in place: a program
    paired with a name adds that computed column to `cols`; the one
    paired with None is the WHERE mask, ANDed into `valid`. The
    expression kernel on the card, one launch for all programs; the
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
    _expr_cuda(progs, cols, valid)
    eval_programs.launches += 1
    if any(prog.has_unary for prog, _ in progs):
        eval_programs.unary_launches += 1


eval_programs.launches = 0  # wrapper calls that launched the kernel
eval_programs.unary_launches = 0  # of those, launches that ran a unary


def _expr_cuda(progs, cols: dict[str, torch.Tensor],
               valid: torch.Tensor) -> None:
    n = valid.shape[0]
    if len(progs) > kb.EXPR_MAX_PROGS:
        raise ValueError(f"more than {kb.EXPR_MAX_PROGS} programs")
    args = kb.ExprArgs()
    args.n, args.n_progs = n, len(progs)
    args.valid = kb.ptr(valid)
    table: list[str] = []
    outs: dict[str, torch.Tensor] = {}
    first = 0
    for p, (prog, name) in enumerate(progs):
        if first + len(prog.ops) > kb.EXPR_MAX_OPS:
            raise ValueError(f"more than {kb.EXPR_MAX_OPS} ops in a launch")
        for i, ((code, arg), t) in enumerate(zip(prog.ops, prog.types)):
            if code == OP_COL:
                c = prog.cols[arg]
                if c not in table:
                    col = cols[c]
                    if col.dtype != _TORCH[t] or col.shape[0] != n:
                        raise ValueError(f"expression: column {c} is not "
                                         f"{t} [{n}]")
                    if len(table) == kb.EXPR_MAX_COLS:
                        raise ValueError(
                            f"more than {kb.EXPR_MAX_COLS} columns")
                    args.cols[len(table)] = kb.ptr(col)
                    args.col_type[len(table)] = kb.VTYPES[col.dtype]
                    table.append(c)
                arg = table.index(c)
            args.ops[first + i].op, args.ops[first + i].arg = code, arg
        pr = args.progs[p]
        pr.first, pr.n_ops = first, len(prog.ops)
        pr.out_type = kb.VTYPES[_TORCH[prog.dtype]]
        if name is None:
            if prog.dtype != "bool":
                raise ValueError("a WHERE program must give bool")
            pr.where = 1
        else:
            out = torch.empty(n, dtype=_TORCH[prog.dtype],
                              device=valid.device)
            pr.out = out.data_ptr()
            outs[name] = out
        first += len(prog.ops)
    args.n_cols = len(table)
    kb.check(kb.lib().hs_expr(ctypes.byref(args), kb.stream_of(valid)),
             "expression")
    cols.update(outs)


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
