"""Scalar expressions (a copy of hstream_tpu/engine/expr.py without its
device compiler, which is ROADMAP A6: `compile_device` raises).

The reference interprets scalar expressions over Aeson JSON values per
record (hstream-sql Internal/Codegen.hs:76-250, op enums AST.hs:87-105).
Here the AST is evaluated on the host by `eval_host(expr, row)` and its
columnwise twin `eval_host_vec`, used for HAVING and SELECT projections
over emitted aggregate rows, which are tiny compared to the ingest
stream. `encode_strings` rewrites string literals to dictionary ids.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Mapping

from hstream_tpu_torch.common.errors import NotPortedError, SQLCodegenError
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


def compile_device(expr: Expr, schema: Schema):
    """Device evaluation of WHERE predicates and computed aggregate
    inputs is not ported yet: the lattice step reads bare columns."""
    raise NotPortedError("device expression evaluation (WHERE, computed "
                         "aggregate inputs)", "A6")


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
