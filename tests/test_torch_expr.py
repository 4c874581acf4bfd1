"""Parity of the port's device expressions (expr.compile_device and the
plain version of the expression kernel) with hstream_tpu's traced jnp
functions.

Each expression is built in both packages and run over the same columns,
made from a numpy seed with the awkward values mixed in: NaN, +-inf,
-0.0, subnormals, INT_MIN / INT_MAX, zero and negative divisors. Where
jnp refuses an expression (a TypeError at trace time, or the reference's
SQLCodegenError), the port refuses it at compile time with
SQLCodegenError. Otherwise the result has jnp's dtype, and its values
are exact for integer, boolean and comparison results and within rel
1e-6 for float arithmetic (XLA on the CPU may contract a multiply and an
add). The CUDA kernel is held against the plain version bit for bit by
chip_smoke.py on the card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hstream_tpu.common.errors import SQLCodegenError as JSQLCodegenError
from hstream_tpu.engine import expr as je
from hstream_tpu.engine.types import ColumnType as JType
from hstream_tpu.engine.types import Schema as JSchema
from hstream_tpu_torch.common.errors import NotPortedError, SQLCodegenError
from hstream_tpu_torch.engine import expr as te
from hstream_tpu_torch.engine.types import ColumnType, Schema

N = 2048
JSCHEMA = JSchema.of(f=JType.FLOAT, g=JType.FLOAT, i=JType.INT,
                     j=JType.INT, b=JType.BOOL, c=JType.BOOL,
                     s=JType.STRING)
TSCHEMA = Schema.of(f=ColumnType.FLOAT, g=ColumnType.FLOAT,
                    i=ColumnType.INT, j=ColumnType.INT, b=ColumnType.BOOL,
                    c=ColumnType.BOOL, s=ColumnType.STRING)


def columns(seed: int = 7) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    f = rng.normal(0, 100, N).astype(np.float32)
    f[::7] = np.rint(f[::7])
    f[::101] = np.nan
    f[1::103] = np.inf
    f[2::107] = -np.inf
    f[3::109] = -0.0
    f[4::113] = 0.0
    f[5::127] = 1e30
    g = rng.normal(0, 3, N).astype(np.float32)
    g[::11] = 0.0
    g[1::13] = -0.0
    g[2::17] = np.nan
    g[3::19] = np.inf
    g[4::23] = -np.rint(g[4::23])
    i = rng.integers(-(1 << 31), 1 << 31, N).astype(np.int32)
    i[::5] = rng.integers(-10, 10, i[::5].shape[0])
    i[1::29] = -(1 << 31)
    i[2::31] = (1 << 31) - 1
    j = rng.integers(-5, 6, N).astype(np.int32)
    j[::37] = -(1 << 31)
    j[1::41] = (1 << 31) - 1
    return dict(f=f, g=g, i=i, j=j,
                b=rng.integers(0, 2, N).astype(np.bool_),
                c=rng.integers(0, 2, N).astype(np.bool_),
                s=rng.integers(0, 4, N).astype(np.int32))


OPS = ("+", "-", "*", "/", "%", "=", "<>", "<", "<=", ">", ">=", "AND",
       "OR")
PAIRS = ("f g", "i j", "i f", "f j", "b i", "f b", "b c", "i 3", "f 2.5",
         "7 j", "b True", "-7 i", "g -3.0")


def _operand(m, tok: str):
    if tok in ("True", "False"):
        return m.Lit(tok == "True")
    if tok.lstrip("-").replace(".", "").isdigit():
        return m.Lit(float(tok) if "." in tok else int(tok))
    return m.Col(tok)


def binary_cases():
    return [(op, pair) for pair in PAIRS for op in OPS]


UNARY = [("NOT", "b"), ("NOT", "i"), ("NOT", "f"), ("NEG", "i"),
         ("NEG", "f"), ("NEG", "b"), ("ABS", "i"), ("ABS", "f"),
         ("ABS", "b")]


def compound(m):
    """Nested expressions: the changelog's computed input, int wrap,
    chained comparisons, and a column-free constant."""
    f, g, i, j = (m.Col(x) for x in "fgij")
    return {
        "temp*1.8+32": m.BinOp("+", m.BinOp("*", f, m.Lit(1.8)), m.Lit(32)),
        "i*65536": m.BinOp("*", i, m.Lit(65536)),
        "i+INT_MAX": m.BinOp("+", i, m.Lit(2147483647)),
        "INT_MIN-i": m.BinOp("-", m.Lit(-2147483648), i),
        "-(i%j)": m.UnOp("NEG", m.BinOp("%", i, j)),
        "f>g AND NOT i=0": m.BinOp("AND", m.BinOp(">", f, g), m.UnOp(
            "NOT", m.BinOp("=", i, m.Lit(0)))),
        "(f%g)/(i-j)": m.BinOp("/", m.BinOp("%", f, g), m.BinOp("-", i, j)),
        "const 3": m.Lit(3),
        "const 2.5*4": m.BinOp("*", m.Lit(2.5), m.Lit(4)),
    }


class _M:
    """Constructors of one package's AST."""

    def __init__(self, mod):
        self.Col, self.Lit = mod.Col, mod.Lit
        self.BinOp, self.UnOp = mod.BinOp, mod.UnOp


JM, TM = _M(je), _M(te)
COLS = columns()


def run_both(jexpr, texpr):
    """(jnp result as numpy | None if jnp refuses, port result | None)."""
    try:
        fn = je.compile_device(jexpr, JSCHEMA)
        want = np.asarray(fn({k: jnp.asarray(v) for k, v in COLS.items()}))
        want = np.broadcast_to(want, (N,))
    except (TypeError, JSQLCodegenError):
        want = None
    try:
        prog = te.compile_device(texpr, TSCHEMA)
    except SQLCodegenError:
        assert want is None, "the port refused what jnp computes"
        return None, None
    assert want is not None, "the port computes what jnp refuses"
    got = prog({k: torch.from_numpy(v) for k, v in COLS.items()}).numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert prog.dtype == {np.dtype(np.float32): "f32",
                          np.dtype(np.int32): "i32",
                          np.dtype(np.bool_): "bool"}[got.dtype]
    return want, got


def assert_same(want, got, exact: bool):
    if want is None:
        return
    if got.dtype != np.float32 or exact:
        if got.dtype == np.float32:
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))
        else:
            np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("op,pair", binary_cases(),
                         ids=[f"{a}{o}{b}".replace(" ", "")
                              for o, p in binary_cases()
                              for a, b in [p.split()]])
def test_binary_ops_match_jnp(op, pair):
    a, b = pair.split()
    want, got = run_both(JM.BinOp(op, _operand(JM, a), _operand(JM, b)),
                         TM.BinOp(op, _operand(TM, a), _operand(TM, b)))
    # float arithmetic may differ in its last bits (XLA may contract);
    # everything else is exact
    assert_same(want, got, exact=op not in ("+", "-", "*", "/", "%"))


@pytest.mark.parametrize("op,col", UNARY,
                         ids=[f"{o}_{c}" for o, c in UNARY])
def test_unary_ops_match_jnp(op, col):
    want, got = run_both(JM.UnOp(op, JM.Col(col)), TM.UnOp(op, TM.Col(col)))
    assert_same(want, got, exact=True)


@pytest.mark.parametrize("name", list(compound(JM)))
def test_compound_expressions_match_jnp(name):
    want, got = run_both(compound(JM)[name], compound(TM)[name])
    assert want is not None
    assert_same(want, got, exact=got.dtype != np.float32)


def test_string_equality_runs_on_dictionary_ids():
    from hstream_tpu.engine.types import StringDictionary as JDict
    from hstream_tpu_torch.engine.types import StringDictionary

    jd, td = {"s": JDict()}, {"s": StringDictionary()}
    for d in (jd, td):
        for v in ("w", "x", "y", "z"):
            d["s"].encode(v)
    jx = je.encode_strings(JM.BinOp("=", JM.Col("s"), JM.Lit("y")),
                           JSCHEMA, jd)
    tx = te.encode_strings(TM.BinOp("=", TM.Col("s"), TM.Lit("y")),
                           TSCHEMA, td)
    assert tx.right == te.Lit(2) and jx.right.value == 2
    want, got = run_both(jx, tx)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == (COLS["s"] == 2).sum()


@pytest.mark.parametrize("expr,err", [
    (te.Lit(None), SQLCodegenError),
    (te.Lit("a"), SQLCodegenError),
    (te.Col("nope"), SQLCodegenError),
    (te.BinOp("IFNULL", te.Col("f"), te.Lit(1.0)), SQLCodegenError),
    (te.UnOp("TO_UPPER", te.Col("s")), SQLCodegenError),
    (te.UnOp("SQRT", te.Col("f")), NotPortedError),
    (te.Lit(1 << 40), SQLCodegenError),
], ids=["null_lit", "string_lit", "unknown_col", "ifnull", "host_only",
        "unported_unary", "int_overflow_lit"])
def test_refusals(expr, err):
    with pytest.raises(err):
        te.compile_device(expr, TSCHEMA)


def test_program_limits_and_the_kernel_wrapper_on_the_cpu():
    deep = te.Col("f")
    for _ in range(40):
        deep = te.BinOp("+", deep, te.Lit(1.0))
    with pytest.raises(SQLCodegenError, match="ops"):
        te.compile_device(deep, TSCHEMA)
    nested = te.Col("f")
    for _ in range(16):
        nested = te.BinOp("+", te.Col("g"), nested)
    with pytest.raises(SQLCodegenError, match="stack"):
        te.compile_device(nested, TSCHEMA)
    # eval_programs on CPU tensors: the plain versions, no launch
    cols = {k: torch.from_numpy(v) for k, v in COLS.items()}
    where = te.compile_device(te.BinOp(">", te.Col("f"), te.Lit(0.0)),
                              TSCHEMA)
    val = te.compile_device(te.BinOp("*", te.Col("i"), te.Lit(2)), TSCHEMA)
    valid = torch.ones(N, dtype=torch.bool)
    before = te.eval_programs.launches
    te.eval_programs(((where, None), (val, "__in_a0")), cols, valid)
    assert te.eval_programs.launches == before
    np.testing.assert_array_equal(valid.numpy(), COLS["f"] > 0)
    np.testing.assert_array_equal(
        cols["__in_a0"].numpy(),
        (COLS["i"].astype(np.int64) * 2).astype(np.int32))
