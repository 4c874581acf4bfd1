"""Parity of the port's device expressions (expr.compile_device and the
plain version of the expression kernel) with hstream_tpu's traced jnp
functions.

Each expression is built in both packages and run over the same columns,
made from a numpy seed with the awkward values mixed in: NaN, +-inf,
-0.0, subnormals, INT_MIN / INT_MAX, zero and negative divisors. Where
jnp refuses an expression (a TypeError or ValueError at trace time, or
the reference's SQLCodegenError), the port refuses it at compile time
with SQLCodegenError. Otherwise the result has jnp's dtype, and its values
are exact for integer, boolean and comparison results and within rel
1e-6 for float arithmetic (XLA on the CPU may contract a multiply and an
add). The unaries: CEIL, FLOOR, ROUND (half to even), SIGN, SQRT, ABS
and NEG are exact; each transcendental is held within its own ULP bound
(ULP below). The CUDA kernel is held against the plain version by
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
from hstream_tpu_torch.common.errors import SQLCodegenError
from hstream_tpu_torch.engine import expr as te
from hstream_tpu_torch.engine.types import ColumnType, Schema

N = 2048
JSCHEMA = JSchema.of(f=JType.FLOAT, g=JType.FLOAT, i=JType.INT,
                     j=JType.INT, b=JType.BOOL, c=JType.BOOL,
                     s=JType.STRING, h=JType.FLOAT)
TSCHEMA = Schema.of(f=ColumnType.FLOAT, g=ColumnType.FLOAT,
                    i=ColumnType.INT, j=ColumnType.INT, b=ColumnType.BOOL,
                    c=ColumnType.BOOL, s=ColumnType.STRING,
                    h=ColumnType.FLOAT)


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
    # halves for ROUND (20.5 -> 20, -0.5 -> -0.0) and their neighbours
    h = (rng.integers(-400, 400, N) / 2).astype(np.float32)
    h[::9] = np.nextafter(h[::9], np.float32(np.inf))
    h[1::9] = np.nextafter(h[1::9], np.float32(-np.inf))
    h[2::97] = (1 << 23) + 1.0
    h[3::97] = np.nan
    h[:8] = [0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 20.5, -0.0]
    return dict(f=f, g=g, i=i, j=j,
                b=rng.integers(0, 2, N).astype(np.bool_),
                c=rng.integers(0, 2, N).astype(np.bool_),
                s=rng.integers(0, 4, N).astype(np.int32), h=h)


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
         ("ABS", "b")] + [(op, col) for op in ("CEIL", "FLOOR", "ROUND",
                                               "SIGN", "SQRT")
                          for col in "fihb"]


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
    except (TypeError, ValueError, JSQLCodegenError):
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
    if op in ("NOT", "NEG", "ABS") or want is None:
        assert_same(want, got, exact=True)
        return
    # exact, a NaN as a NaN (XLA's sqrt of a negative sets the sign bit)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)].view(np.int32),
                                  want[~np.isnan(want)].view(np.int32))
    if col == "h" and op == "ROUND":
        assert list(got[:8]) == [0.0, -0.0, 2.0, -2.0, 2.0, -2.0, 20.0, -0.0]
        assert np.signbit(got[1]) and np.signbit(got[7])


# The largest ULP distance of torch's float32 function on the CPU (the
# plain version) from XLA's on the CPU (jax 0.9.0), measured over 12
# draws of unary_domain's 200,000 values: XLA's own error, mostly. XLA's
# sinh and cosh lose 24 ULP past |x| ~ 30 (torch is within 1 of the
# correctly rounded value there), its tanh 5 near |x| = 8.
ULP = {"SIN": 1, "COS": 1, "TAN": 1, "ASIN": 2, "ACOS": 2, "ATAN": 1,
       "SINH": 24, "COSH": 24, "TANH": 5, "ASINH": 2, "ACOSH": 4,
       "ATANH": 3, "LOG": 1, "LOG2": 2, "LOG10": 3, "EXP": 1}
# values where both sides must agree exactly: NaN, +-inf, +-0 and
# inputs outside the domain (NaN out)
SPECIAL = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, -1.0, -3.0, 2.0,
                    1.0, -1e30, 1e30], np.float32)


def unary_domain(op: str, col: str, n: int = 200_000) -> np.ndarray:
    """Inputs whose values and results are normal floats: normal(0, 10)
    (|x| for the logs and SQRT, 1 + |x| for ACOSH, uniform(-1, 1) for
    ASIN, ACOS and ATANH); integers in the same ranges for an int32
    operand; then SPECIAL for a float one."""
    rng = np.random.default_rng(sorted(ULP).index(op) if op in ULP else 99)
    x = rng.normal(0, 10, n)
    if op in ("ASIN", "ACOS", "ATANH"):
        x = rng.uniform(-1, 1, n)
    elif op in ("LOG", "LOG2", "LOG10", "SQRT"):
        x = np.abs(x)
    elif op == "ACOSH":
        x = 1 + np.abs(x)
    if col == "i":
        if op in ("ASIN", "ACOS", "ATANH"):
            return rng.integers(-1, 2, 64).astype(np.int32)
        x = np.rint(x * (4 if op in ("LOG", "LOG2", "LOG10") else 1))
        return np.concatenate([x, [2**31 - 1] if op.startswith("LOG")
                               else []]).astype(np.int32)
    return np.concatenate([x.astype(np.float32), SPECIAL])


def ulp_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in units in the last place of float32 (ordered ints)."""
    ai, bi = (v.view(np.int32).astype(np.int64) for v in (a, b))
    ai = np.where(ai < 0, -(ai & 0x7FFFFFFF), ai)
    bi = np.where(bi < 0, -(bi & 0x7FFFFFFF), bi)
    return np.abs(ai - bi)


FLOAT_UNARY = [(op, col) for op in ULP for col in "fib"]


@pytest.mark.parametrize("op,col", FLOAT_UNARY,
                         ids=[f"{o}_{c}" for o, c in FLOAT_UNARY])
def test_float_unaries_within_their_ulp_bound_of_jnp(op, col):
    """Every transcendental unary over a float32, an int32 (converted
    first) and a bool operand: jnp's float32 result type, NaN, inf and
    zero where jnp has them, the rest within ULP[op]."""
    x = (np.array([False, True, True, False]) if col == "b"
         else unary_domain(op, col))
    jnp_col = {"f": JType.FLOAT, "i": JType.INT, "b": JType.BOOL}[col]
    t_col = {"f": ColumnType.FLOAT, "i": ColumnType.INT,
             "b": ColumnType.BOOL}[col]
    want = np.asarray(je.compile_device(JM.UnOp(op, JM.Col("x")),
                                        JSchema.of(x=jnp_col))(
        {"x": jnp.asarray(x)}))
    prog = te.compile_device(TM.UnOp(op, TM.Col("x")), Schema.of(x=t_col))
    got = prog({"x": torch.from_numpy(x)}).numpy()
    assert prog.dtype == "f32" and got.dtype == want.dtype == np.float32
    odd = ~np.isfinite(want) | (want == 0)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[odd & ~np.isnan(want)],
                                  want[odd & ~np.isnan(want)])
    np.testing.assert_array_equal(np.signbit(got[odd & ~np.isnan(want)]),
                                  np.signbit(want[odd & ~np.isnan(want)]))
    assert ulp_distance(got[~odd], want[~odd]).max(initial=0) <= ULP[op]


@pytest.mark.parametrize("op,x,ref", [
    ("EXP", -100.0, 0.0),
    ("EXP", -88.0, 0.0),
    ("LOG", 1e-45, -np.inf),
    ("SQRT", 1e-45, 0.0),
])
def test_subnormals_flush_in_the_port_as_in_the_reference(op, x, ref):
    """XLA's CPU backend flushes subnormal inputs and results to zero, and
    so does the port: its plain versions through expr.ftz, its kernel by
    --ftz=true (ROADMAP C, fixed in the port). Once 3.78e-44, 6.05e-39,
    -103.28 and 3.74e-23 in the port."""
    j = je.compile_device(JM.UnOp(op, JM.Col("x")), JSchema.of(x=JType.FLOAT))
    t = te.compile_device(TM.UnOp(op, TM.Col("x")),
                          Schema.of(x=ColumnType.FLOAT))
    xs = np.array([x], np.float32)
    want = np.asarray(j({"x": jnp.asarray(xs)}))
    got = t({"x": torch.from_numpy(xs)}).numpy()
    assert want[0] == np.float32(ref)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# subnormals of both signs, the smallest normals and their neighbours,
# zeros, ordinary values and the non-finite ones
EDGE = np.array([1e-45, -1e-45, 1e-40, -1e-40, 3e-39, -3e-39,
                 1.1754942e-38, -1.1754942e-38, 1.1754944e-38,
                 -1.1754944e-38, 2.4e-38, 3e-38, 0.0, -0.0, 1.0, -2.5,
                 3.0, -7.0, 1e-30, np.nan, np.inf, -np.inf], np.float32)
_XY = JSchema.of(x=JType.FLOAT, y=JType.FLOAT)
_TXY = Schema.of(x=ColumnType.FLOAT, y=ColumnType.FLOAT)


def _run_xy(jx, tx, x, y):
    want = np.asarray(je.compile_device(jx, _XY)(
        {"x": jnp.asarray(x), "y": jnp.asarray(y)}))
    got = te.compile_device(tx, _TXY)(
        {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}).numpy()
    assert got.dtype == want.dtype
    return want, got


def _same_bits(want, got, ulp: int = 0):
    """Bit for bit (NaN as NaN), or within `ulp` where both are finite
    and non-zero."""
    if want.dtype != np.float32:
        return want == got
    same = (want.view(np.int32) == got.view(np.int32)) | (
        np.isnan(want) & np.isnan(got))
    if ulp:
        fin = np.isfinite(want) & np.isfinite(got) & (want != 0) & (got != 0)
        same |= fin & (ulp_distance(got, want) <= ulp)
    return same


@pytest.mark.parametrize("op", ["+", "-", "*", "/", "%", "=", "<>", "<",
                                "<=", ">", ">="])
def test_binary_float_ops_flush_subnormals_as_jnp(op):
    """Every pair of EDGE values: the flushed operands and results bit for
    bit, jnp.remainder's unflushed pass-through of a subnormal remainder
    included."""
    x, y = np.repeat(EDGE, len(EDGE)), np.tile(EDGE, len(EDGE))
    want, got = _run_xy(JM.BinOp(op, JM.Col("x"), JM.Col("y")),
                        TM.BinOp(op, TM.Col("x"), TM.Col("y")), x, y)
    bad = ~_same_bits(want, got)
    assert not bad.any(), list(zip(x[bad], y[bad], want[bad], got[bad]))[:5]


def _tiny(seed: int) -> np.ndarray:
    """Magnitudes from 2^-149 to 2^-100 of both signs, then EDGE."""
    rng = np.random.default_rng(seed)
    m = np.float32(2.0) ** rng.uniform(-149, -100, 600).astype(np.float32)
    return np.concatenate([m * rng.choice([-1, 1], 600),
                           EDGE]).astype(np.float32)


@pytest.mark.parametrize("op", list(ULP) + ["CEIL", "FLOOR", "ROUND",
                                            "SIGN", "SQRT", "NEG", "ABS"])
def test_unaries_flush_subnormals_as_jnp(op):
    """A tiny or subnormal operand of each unary: flushed where XLA
    flushes it (NEG and ABS are bit operations and keep it; SIN, TAN,
    ATAN and TANH return it as it is; ASIN flushes below 2^-125), the
    rest of the results within the unary's ULP bound."""
    x = _tiny(len(op))
    want, got = _run_xy(JM.UnOp(op, JM.Col("x")), TM.UnOp(op, TM.Col("x")),
                        x, x)
    bad = ~_same_bits(want, got, ULP.get(op, 0))
    assert not bad.any(), list(zip(x[bad], want[bad], got[bad]))[:5]


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
    (te.UnOp("ROUND", te.Col("b")), SQLCodegenError),
    (te.UnOp("SIGN", te.BinOp("<", te.Col("f"), te.Lit(0.0))),
     SQLCodegenError),
    (te.Lit(1 << 40), SQLCodegenError),
], ids=["null_lit", "string_lit", "unknown_col", "ifnull", "host_only",
        "round_bool", "sign_bool", "int_overflow_lit"])
def test_refusals(expr, err):
    with pytest.raises(err):
        te.compile_device(expr, TSCHEMA)


@pytest.mark.parametrize("op,jerr", [("ROUND", ValueError),
                                     ("SIGN", TypeError)])
def test_round_and_sign_of_a_bool_raise_where_the_reference_raises(op,
                                                                   jerr):
    """The reference builds the expression's function without a check
    and raises when it runs (jnp at trace time: ValueError for ROUND,
    TypeError for SIGN), so a query over such an input builds and fails
    at its first step; the port refuses it when its executor compiles
    the step's programs."""
    from hstream_tpu.engine import executor as jexec
    from hstream_tpu.engine import plan as jplan
    from hstream_tpu.engine import window as jwin
    from hstream_tpu_torch.engine import (AggKind, AggregateNode, AggSpec,
                                          QueryExecutor, SourceNode,
                                          TumblingWindow)

    fn = je.compile_device(JM.UnOp(op, JM.Col("b")), JSCHEMA)
    with pytest.raises(jerr):
        fn({k: jnp.asarray(v) for k, v in COLS.items()})
    with pytest.raises(SQLCodegenError, match=f"{op} of a boolean"):
        te.compile_device(TM.UnOp(op, TM.Col("b")), TSCHEMA)

    js = JSchema.of(k=JType.STRING, b=JType.BOOL)
    jnode = jplan.AggregateNode(
        child=jplan.SourceNode("s", js), group_keys=[JM.Col("k")],
        window=jwin.TumblingWindow(1000, grace_ms=0),
        aggs=[jplan.AggSpec(jplan.AggKind.SUM, "x",
                            input=JM.UnOp(op, JM.Col("b")))])
    jx = jexec.QueryExecutor(jnode, js, emit_changes=False)
    rows = [{"k": "a", "b": True}, {"k": "b", "b": False}]
    with pytest.raises(jerr):
        jx.process(rows, [1_700_000_000_000, 1_700_000_000_001])

    ts = Schema.of(k=ColumnType.STRING, b=ColumnType.BOOL)
    tnode = AggregateNode(
        child=SourceNode("s", ts), group_keys=[TM.Col("k")],
        window=TumblingWindow(1000, grace_ms=0),
        aggs=[AggSpec(AggKind.SUM, "x", input=TM.UnOp(op, TM.Col("b")))])
    with pytest.raises(SQLCodegenError, match=f"{op} of a boolean"):
        tx = QueryExecutor(tnode, ts, emit_changes=False, device="cpu")
        tx.process(rows, [1_700_000_000_000, 1_700_000_000_001])


def test_program_limits_and_the_kernel_wrapper_on_the_cpu():
    """A chain of 40 additions (81 postfix ops) and a right-deep nest of
    16 compile, as the reference traces them, and their register forms
    give the postfix version's bits; the one limit left is the register
    form's spill slots (test_torch_expr_caps.py). On CPU tensors the
    wrapper runs the plain versions and launches nothing."""
    deep = te.Col("f")
    for _ in range(40):
        deep = te.BinOp("+", deep, te.Lit(1.0))
    nested = te.Col("f")
    for _ in range(16):
        nested = te.BinOp("+", te.Col("g"), nested)
    tcols = {k: torch.from_numpy(v) for k, v in COLS.items()}
    for e in (deep, nested):
        prog = te.compile_device(e, TSCHEMA)
        assert te.lower(prog).slots == 0
        assert torch.equal(te.run_lowered(prog, tcols).view(torch.int32),
                           prog(tcols).view(torch.int32))
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


@pytest.mark.parametrize("expr,unary", [
    (TM.UnOp("SQRT", TM.Col("f")), True),
    (TM.BinOp(">", TM.UnOp("LOG10", TM.UnOp("ABS", TM.Col("f"))),
              TM.Lit(1.0)), True),
    (TM.UnOp("CEIL", TM.Col("i")), False),   # an int32 CEIL is no op
    (TM.UnOp("ABS", TM.Col("f")), False),
    (TM.UnOp("NEG", TM.Col("i")), False),
    (TM.BinOp("*", TM.Col("i"), TM.Lit(2)), False),
], ids=["sqrt", "nested_log10", "ceil_int", "abs", "neg", "binary"])
def test_has_unary_marks_the_programs_that_run_a_unary(expr, unary):
    """compile_device sets has_unary once, on the programs whose ops run
    one of the 21 unaries; eval_programs counts their launches from it.
    The flag takes no part in a program's equality."""
    prog = te.compile_device(expr, TSCHEMA)
    assert prog.has_unary is unary
    assert prog == te.DeviceProgram(prog.ops, prog.types, prog.cols,
                                    prog.dtype, has_unary=not unary)
