"""The register form of the port's device expressions (hstream_tpu_torch/
engine/expr.py `lower`, its plain evaluator `run_lowered` and the
kernel's argument block `launch_plan`), which csrc/expr.cu runs, against
the postfix plain version and the reference's compile_device
(hstream_tpu/engine/expr.py) run through jnp on the CPU.

Cases: every expression of chip_smoke.expr_cases() (each op on every
int / float / bool mix the device takes, and the ones it refuses), and
hypothesis-drawn trees, left-deep, right-deep (with computed left sides,
so they spill) and balanced, past the old per-program caps (64 postfix
ops, 16 stack slots), over columns
with NaN, +-inf, +-0.0, subnormals, INT_MIN / INT_MAX and zero divisors
(chip_smoke.expr_columns) and literals among the same.

Tolerances: the register form equals the postfix plain version bit for
bit (NaN payloads included). Both equal jnp called eagerly, one XLA op
at a time (so no multiply-add is contracted and no division by a
constant becomes a multiply), value for value: float32 by its bits, but
a NaN matches any NaN (XLA's is 0xFFC00000, the port's 0x7FC00000). Trees
with a transcendental unary are held against the postfix version only
(test_torch_expr.py holds each unary within its ULP bound of jnp).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
import jax.numpy as jnp
from hstream_tpu.common.errors import SQLCodegenError as JSQLCodegenError
from hstream_tpu.engine import expr as je
from hstream_tpu.engine.types import ColumnType as JType
from hstream_tpu.engine.types import Schema as JSchema
from hstream_tpu_torch.common.errors import SQLCodegenError
from hstream_tpu_torch.engine import expr as te
from hstream_tpu_torch.engine.kernels import binding as kb
from hstream_tpu_torch.engine.types import ColumnType, Schema

N = 1024
JSCHEMA = JSchema.of(f=JType.FLOAT, g=JType.FLOAT, i=JType.INT,
                     j=JType.INT, b=JType.BOOL, c=JType.BOOL)
TSCHEMA = Schema.of(f=ColumnType.FLOAT, g=ColumnType.FLOAT,
                    i=ColumnType.INT, j=ColumnType.INT, b=ColumnType.BOOL,
                    c=ColumnType.BOOL)
TCOLS = chip_smoke.expr_columns("cpu", N, 31)
JCOLS = {k: jnp.asarray(v.numpy()) for k, v in TCOLS.items()}
CASES = chip_smoke.expr_cases()


def to_jax(e):
    """The same expression in the reference's AST."""
    if isinstance(e, te.Col):
        return je.Col(e.name)
    if isinstance(e, te.Lit):
        return je.Lit(e.value)
    if isinstance(e, te.BinOp):
        return je.BinOp(e.op, to_jax(e.left), to_jax(e.right))
    return je.UnOp(e.op, to_jax(e.operand))


def bits(x: np.ndarray) -> np.ndarray:
    return x.view(np.int32) if x.dtype == np.float32 else x


def same_value(got: np.ndarray, want: np.ndarray) -> bool:
    """Equal, float32 by its bits, any NaN matching any NaN."""
    if got.dtype != want.dtype:
        return False
    if got.dtype != np.float32:
        return np.array_equal(got, want)
    nan = np.isnan(got)
    return np.array_equal(nan, np.isnan(want)) and \
        np.array_equal(bits(got)[~nan], bits(want)[~nan])


def check(e, against_jnp: bool = True) -> te.DeviceProgram | None:
    """Compile e in both packages and hold the register form against the
    postfix plain version and jnp; None where both refuse it."""
    try:
        fn = je.compile_device(to_jax(e), JSCHEMA)
        want = np.broadcast_to(np.asarray(fn(JCOLS)), (N,))
    except (TypeError, ValueError, JSQLCodegenError):
        want = None
    try:
        prog = te.compile_device(e, TSCHEMA)
    except SQLCodegenError:
        assert want is None, "the port refused what jnp computes"
        return None
    assert want is not None, "the port computes what jnp refuses"
    post = prog(TCOLS).numpy()
    low = te.run_lowered(prog, TCOLS).numpy()
    assert low.dtype == post.dtype and np.array_equal(bits(low), bits(post))
    if against_jnp:
        assert same_value(low, want), e
    return prog


@pytest.mark.parametrize("k", range(len(CASES)))
def test_chip_smoke_cases_lower_exactly(k):
    check(CASES[k])


# ---- hypothesis-drawn trees ------------------------------------------------

INT_MIN, INT_MAX = -(1 << 31), (1 << 31) - 1
LEAVES = (["f", "g", "i", "j", "b", "c"] * 3
          + [0, 3, -7, INT_MIN, INT_MAX, 2.5, -0.0, 1e-40, float("nan"),
             float("inf"), -1.5, True, False])
BIN = ("+", "-", "*", "/", "%", "=", "<>", "<", "<=", ">", ">=", "AND", "OR")
EXACT_UN = ("NOT", "NEG", "ABS", "CEIL", "FLOOR", "ROUND", "SIGN", "SQRT")
TRANS_UN = ("SIN", "COS", "TAN", "ASIN", "ACOS", "ATAN", "SINH", "COSH",
            "TANH", "ASINH", "ACOSH", "ATANH", "LOG", "LOG2", "LOG10", "EXP")
_TYPE = {"f": "f32", "g": "f32", "i": "i32", "j": "i32", "b": "bool",
         "c": "bool"}


def leaf_type(v) -> str:
    if isinstance(v, str):
        return _TYPE[v]
    return "bool" if isinstance(v, bool) else \
        "f32" if isinstance(v, float) else "i32"


def bin_type(op: str, lt: str, rt: str) -> str | None:
    """jnp's result type (compile_device's rules), None where refused."""
    if op in ("AND", "OR"):
        return None if "f32" in (lt, rt) else \
            "bool" if lt == rt == "bool" else "i32"
    if op in ("=", "<>", "<", "<=", ">", ">="):
        return "bool"
    if op == "/":
        return "f32"
    if lt == rt == "bool":
        return None if op in ("-", "%") else "bool"
    if op == "*" and "bool" in (lt, rt):
        return rt if lt == "bool" else lt
    return "f32" if "f32" in (lt, rt) else "i32"


def un_type(op: str, t: str) -> str | None:
    if op == "NOT":
        return None if t == "f32" else t
    if op in ("NEG", "ROUND", "SIGN"):
        return None if t == "bool" else t
    if op in ("ABS", "CEIL", "FLOOR"):
        return t
    return "f32"


class Draw:
    """Typed trees drawn from hypothesis: (port expr, type)."""

    def __init__(self, data, unaries):
        self.data, self.unaries = data, unaries

    def leaf(self):
        v = self.data.draw(st.sampled_from(LEAVES))
        return (te.Col(v) if isinstance(v, str) else te.Lit(v)), leaf_type(v)

    def bin(self, left, right):
        (le, lt), (re_, rt) = left, right
        op = self.data.draw(st.sampled_from(BIN))
        t = bin_type(op, lt, rt)
        if t is None:   # `+` takes every mix
            op, t = "+", bin_type("+", lt, rt)
        return te.BinOp(op, le, re_), t

    def maybe_un(self, node):
        """node, or one time in four a unary of it"""
        if self.data.draw(st.integers(0, 3)) != 0:
            return node
        e, t = node
        op = self.data.draw(st.sampled_from(self.unaries))
        u = un_type(op, t)
        return (te.UnOp(op, e), u) if u is not None else node

    def left_deep(self):
        node = self.maybe_un(self.leaf())
        for _ in range(self.data.draw(st.integers(1, 40))):
            node = self.maybe_un(self.bin(node, self.maybe_un(self.leaf())))
        return node

    def right_deep(self):
        node = self.maybe_un(self.leaf())
        for _ in range(self.data.draw(st.integers(1, 24))):
            left = self.leaf()
            if self.data.draw(st.booleans()):   # a computed left side
                left = self.bin(left, self.leaf())
            node = self.maybe_un(self.bin(self.maybe_un(left), node))
        return node

    def balanced(self, depth: int | None = None):
        if depth is None:
            depth = self.data.draw(st.integers(1, 6))
        if depth == 0:
            return self.maybe_un(self.leaf())
        return self.maybe_un(self.bin(self.balanced(depth - 1),
                                      self.balanced(depth - 1)))


SHAPES = ("left_deep", "right_deep", "balanced")


def drawn(data, shape: str, unaries) -> te.DeviceProgram:
    e, _ = getattr(Draw(data, unaries), shape)()
    return e


@pytest.mark.parametrize("shape", SHAPES)
@settings(max_examples=40, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large])
@given(data=st.data())
def test_drawn_trees_lower_exactly(shape, data):
    prog = check(drawn(data, shape, EXACT_UN))
    low = te.lower(prog)
    assert low.slots <= min(te.MAX_SLOTS, _postfix_depth(prog) - 1)
    # a left-deep chain spills at most its value, beside a unary of a leaf
    assert low.slots <= 1 or shape != "left_deep"


@pytest.mark.parametrize("shape", SHAPES)
@settings(max_examples=25, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large])
@given(data=st.data())
def test_drawn_trees_with_transcendentals_match_the_postfix_version(
        shape, data):
    check(drawn(data, shape, EXACT_UN + TRANS_UN), against_jnp=False)


# ---- the form itself and the kernel's argument block -----------------------

def _postfix_depth(prog: te.DeviceProgram) -> int:
    depth = peak = 0
    for code, _ in prog.ops:
        depth += 1 if code in (te.OP_COL, te.OP_LIT) else \
            -1 if code in te._BINARY else 0
        peak = max(peak, depth)
    return peak


def _full_tree(depth: int):
    if depth == 0:
        return te.Col("f")
    sub = _full_tree(depth - 1)
    return te.BinOp("*" if depth % 2 else "+", sub, sub)


@pytest.mark.parametrize("depth", range(1, 6))
def test_balanced_trees_spill_one_slot_less_than_the_stack_depth(depth):
    """A full tree of 2^depth leaves: the postfix stack holds depth + 1
    values, the register form depth - 1 spill slots (a binary op of two
    leaves needs none); its first instruction loads a leaf."""
    prog = te.compile_device(_full_tree(depth), TSCHEMA)
    low = te.lower(prog)
    assert _postfix_depth(prog) == depth + 1
    assert low.slots == depth - 1
    assert low.ins[0].op == te.OP_LOAD
    assert torch.equal(te.run_lowered(prog, TCOLS).view(torch.int32),
                       prog(TCOLS).view(torch.int32))


def test_the_main_paths_programs_need_no_slot():
    """The changelog's and phase 11's programs are left-deep: no spill,
    one instruction per op but the leaves and their conversions, which
    ride on the ops as operands."""
    progs = chip_smoke.changelog_plan()[3] + chip_smoke.log_programs()
    for prog, _ in progs:
        low = te.lower(prog)
        assert low.slots == 0
        assert all(i.op != te.OP_SPILL for i in low.ins)
        leaves = sum(c in (te.OP_COL, te.OP_LIT) for c, _ in prog.ops)
        cvts = sum(c in te._CVT for c, _ in prog.ops)
        assert len(low.ins) >= len(prog.ops) - leaves - cvts + 1
        assert len(low.ins) <= len(prog.ops)


def test_right_deep_leaves_take_the_swapped_operand():
    """g - (g - (... - (g - f))): the innermost op loads g and takes f as
    its right operand, each one above it the leaf g as its left; no
    slot."""
    e = te.Col("f")
    for _ in range(15):
        e = te.BinOp("-", te.Col("g"), e)
    prog = te.compile_device(e, TSCHEMA)
    low = te.lower(prog)
    assert low.slots == 0 and sum(i.swap for i in low.ins) == 14
    assert torch.equal(te.run_lowered(prog, TCOLS).view(torch.int32),
                       prog(TCOLS).view(torch.int32))


def _decode(plan: te.LaunchPlan) -> kb.ExprArgs:
    assert len(plan.blocks) == 1 and not plan.temps
    return kb.ExprArgs.from_buffer_copy(plan.blocks[0].args)


def test_launch_plan_packs_every_program():
    """The argument block of a WHERE, the changelog's value program and a
    spilling one: the programs' instructions packed one after another
    (the op word's opcode, source, conversion and swap), the columns
    numbered once, the outputs named, n and the pointers left to the
    launch."""
    where = te.compile_device(te.BinOp(">", te.Col("f"), te.Lit(15.0)),
                              TSCHEMA)
    val = chip_smoke.changelog_plan()[3][1][0]
    spill = te.compile_device(_full_tree(3), TSCHEMA)
    mix = te.compile_device(te.BinOp("+", te.Col("i"),
                                     te.BinOp("*", te.Col("b"), te.Col("j"))),
                            TSCHEMA)
    progs = ((where, None), (val, "__in_a1"), (spill, "s"), (mix, "m"))
    plan = te.launch_plan(progs)
    a = _decode(plan)
    assert (a.n, a.n_progs, a.n_slots) == (0, 4, 2)
    # in the order the instructions name them: b * j runs before i
    assert plan.blocks[0].cols == (
        ("f", torch.float32), ("temp", torch.float32), ("b", torch.bool),
        ("j", torch.int32), ("i", torch.int32))
    assert [a.col_type[k] for k in range(a.n_cols)] == [0, 0, 2, 1, 1]
    assert plan.blocks[0].outs == ((1, "__in_a1", torch.float32),
                                   (2, "s", torch.float32),
                                   (3, "m", torch.int32))
    first = 0
    for p, (prog, name) in enumerate(progs):
        low = te.lower(prog)
        pr = a.progs[p]
        assert (pr.first, pr.n_ops, pr.where) == \
            (first, len(low.ins), int(name is None))
        assert pr.out_type == kb.VTYPES[te._TORCH[prog.dtype]]
        for k, ins in enumerate(low.ins):
            if ins.src == te.SRC_COL:
                ins = ins._replace(arg=plan.blocks[0].cols.index(
                    (prog.cols[ins.arg], te._TORCH[ins.t])))
            w = a.ops[first + k]
            assert (w.op, w.arg) == (ins.word(), ins.arg)
            assert (w.op & 0xFF, w.op >> 8 & 0xFF, w.op >> 16 & 0xFF,
                    w.op >> 24) == (ins.op, ins.src, ins.cvt, int(ins.swap))
        first += len(low.ins)
    assert not any(a.cols[k] for k in range(kb.EXPR_MAX_COLS)) and \
        not a.valid and not any(a.progs[p].out for p in range(4))


def _sum_of(names):
    e = te.Col(names[0])
    for c in names[1:]:
        e = te.BinOp("+", e, te.Col(c))
    return e


def run_plan(plan: te.LaunchPlan, cols: dict, valid: torch.Tensor) -> dict:
    """A model of the plan's launches on the CPU: each block's argument
    bytes hold its pieces' register forms (as
    test_launch_plan_packs_every_program reads them), and the pieces run
    in order through run_lowered, a temporary column visible to every
    later piece; returns the work columns, WHERE ANDed into `valid`."""
    work = dict(cols)
    for blk in plan.blocks:
        a = kb.ExprArgs.from_buffer_copy(blk.args)
        assert a.n_progs == len(blk.progs) <= kb.EXPR_MAX_PROGS
        assert a.n_cols == len(blk.cols) <= kb.EXPR_MAX_COLS
        first = 0
        for p, (prog, name) in enumerate(blk.progs):
            low = te.lower(prog)
            assert (a.progs[p].first, a.progs[p].n_ops, a.progs[p].where) \
                == (first, len(low.ins), int(name is None))
            first += len(low.ins)
            for c in prog.cols:   # a piece reads what ran before it
                assert c in work, c
            r = te.run_lowered(prog, work)
            if name is None:
                valid &= r
            else:
                work[name] = r
        assert first <= kb.EXPR_MAX_OPS
    return work


@pytest.mark.parametrize("what", ["programs", "instructions", "columns",
                                  "where"])
def test_launch_plan_refuses_what_the_kernel_does_not_take(what):
    """The kernel takes every program set: more programs, instructions or
    columns than one argument block holds go into further blocks (a
    program past a block alone is cut into pieces), which give the
    postfix plain versions' bits; only a WHERE that is not bool is
    refused."""
    one = te.compile_device(te.BinOp("*", te.Col("f"), te.Lit(2.0)),
                            TSCHEMA)
    cols = dict(TCOLS)
    if what == "programs":
        progs = tuple((one, f"p{k}") for k in range(kb.EXPR_MAX_PROGS + 1))
        blocks = 2
    elif what == "instructions":
        e = te.Col("f")
        for _ in range(21):   # 64 ops, 43 instructions
            e = te.UnOp("NEG", te.BinOp("+", e, te.Col("g")))
        big = te.compile_device(e, TSCHEMA)
        progs = tuple((big, f"p{k}") for k in range(6))
        blocks = 2
    elif what == "columns":
        names = [f"x{k}" for k in range(kb.EXPR_MAX_COLS + 1)]
        schema = Schema.of(**{c: ColumnType.INT for c in names})
        rng = np.random.default_rng(5)
        cols = {c: torch.from_numpy(rng.integers(-9, 9, N).astype(np.int32))
                for c in names}
        progs = ((te.compile_device(_sum_of(names), schema), "s"),)
        blocks = 2
    else:
        with pytest.raises(ValueError, match="WHERE"):
            te.launch_plan(((one, None),))
        return
    plan = te.launch_plan(progs)
    assert len(plan.blocks) == blocks
    valid = torch.ones(N, dtype=torch.bool)
    work = run_plan(plan, cols, valid)
    assert valid.all()
    for prog, name in progs:
        assert torch.equal(work[name].view(torch.int32),
                           prog(cols).view(torch.int32)), name


def test_eval_programs_on_the_cpu_gives_the_register_forms_results():
    """On the CPU the wrapper takes the postfix plain versions: the
    changelog step's WHERE mask and computed input equal the register
    form's."""
    progs = chip_smoke.changelog_plan()[3]
    rng = np.random.default_rng(3)
    temp = torch.from_numpy(rng.normal(20, 5, N).astype(np.float32))
    cols, valid = {"temp": temp}, torch.ones(N, dtype=torch.bool)
    te.eval_programs(progs, cols, valid)
    assert torch.equal(valid, te.run_lowered(progs[0][0], {"temp": temp}))
    assert torch.equal(cols["__in_a1"].view(torch.int32),
                       te.run_lowered(progs[1][0], {"temp": temp})
                       .view(torch.int32))
