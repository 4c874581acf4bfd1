"""Queries past the port's old caps, held against the reference on the CPU.

The reference (hstream_tpu/engine/expr.py:122 compile_device) traces jnp
at any size. The port lowers each expression into a register form
(hstream_tpu_torch/engine/expr.py lower) whose one per-program limit is
its spill slots (MAX_SLOTS, a balanced tree of 2^17 leaves), and packs a
step's programs into argument blocks (launch_plan), splitting a set or a
program past one block. A query may have at most MAX_AGGS aggregates and
MAX_COLS input columns (engine/lattice.py check_device_caps): past them
it is refused when it is created, on every device.

Cases:
  * `f + 1.0 + ... + 1.0` chains of 40 and 200 additions, `f - (f - (...
    f))` nests of 20 and 40, a balanced sum of 256 products: the postfix
    plain version, the register form and the launch plan's blocks (run
    by test_torch_expr_plan.run_plan) equal jnp bit for bit (a NaN
    matches any NaN), over chip_smoke's edge columns;
  * a full tree of 2^16 leaves takes the 15 slots; one of 2^17 is
    refused at creation, by compile_device and by a query;
  * a program set of 24 programs over 20 columns with more than 256
    instructions goes into further blocks, with the plain versions'
    results;
  * a window query with 24 aggregates over 20 columns and a WHERE, and a
    session query with 20 aggregates: the port's rows equal the
    reference's (tolerances as in torch_parity and test_torch_session);
  * 65 aggregates, or 65 input columns, are refused at creation;
  * a join whose inner query passes the fused probe's feed tables takes
    the match-fetch path, with the reference's rows.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hstream_tpu.engine import expr as je
from hstream_tpu_torch.common.errors import SQLCodegenError
from hstream_tpu_torch.engine import expr as te
from hstream_tpu_torch.engine.kernels import binding as kb
from hstream_tpu_torch.engine.types import ColumnType, Schema
from test_torch_expr_plan import (JCOLS, JSCHEMA, N, TCOLS, TSCHEMA,
                                  _full_tree, bits, run_plan, same_value,
                                  to_jax)
from test_torch_session import _feed, _node as _session_node, gen
from test_session_device import assert_rows_close
from torch_parity import BASE, JM, TM, drive, pair


def chain(n: int):
    e = te.Col("f")
    for _ in range(n):
        e = te.BinOp("+", e, te.Lit(1.0))
    return e


def nest(n: int):
    e = te.Col("f")
    for _ in range(n):
        e = te.BinOp("-", te.Col("f"), e)
    return e


def products(n: int):
    """A balanced sum of n products of column pairs (n a power of 2)."""
    leaves = ["f", "g", "i", "j"]
    level = [te.BinOp("*", te.Col(leaves[k % 4]),
                      te.Col(leaves[(k + 1) % 4])) for k in range(n)]
    while len(level) > 1:
        level = [te.BinOp("+", level[k], level[k + 1])
                 for k in range(0, len(level), 2)]
    return level[0]


SHAPES = {"chain 40": (chain, 40), "chain 200": (chain, 200),
          "nest 20": (nest, 20), "nest 40": (nest, 40),
          "products 256": (products, 256)}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_large_expressions_match_the_reference(shape):
    make, n = SHAPES[shape]
    e = make(n)
    want = np.broadcast_to(np.asarray(
        je.compile_device(to_jax(e), JSCHEMA)(JCOLS)), (N,))
    prog = te.compile_device(e, TSCHEMA)
    post = prog(TCOLS).numpy()
    assert same_value(post, want), shape
    low = te.lower(prog)
    assert low.slots <= te.MAX_SLOTS
    assert np.array_equal(bits(te.run_lowered(prog, TCOLS).numpy()),
                          bits(post))
    plan = te.launch_plan(((prog, "x"),))
    assert (len(plan.blocks) > 1) == (len(low.ins) > kb.EXPR_MAX_OPS)
    valid = torch.ones(N, dtype=torch.bool)
    got = run_plan(plan, dict(TCOLS), valid)["x"].numpy()
    assert np.array_equal(bits(got), bits(post))


def test_the_spill_slots_are_the_one_limit_of_a_program():
    """A full tree of 2^16 leaves needs the 15 slots the kernel has and
    compiles; one of 2^17 needs 16 and is refused when it is compiled,
    and so when a query holding it is created, on the CPU as well."""
    big = te.compile_device(_full_tree(16), TSCHEMA)
    assert te.lower(big).slots == te.MAX_SLOTS == kb.EXPR_MAX_SLOTS
    with pytest.raises(SQLCodegenError, match="16 spill slots"):
        te.compile_device(_full_tree(17), TSCHEMA)
    schema = TM.Schema.of(device=TM.ColumnType.STRING,
                          f=TM.ColumnType.FLOAT)
    node = TM.AggregateNode(
        child=TM.SourceNode("s", schema), group_keys=[TM.Col("device")],
        window=TM.TumblingWindow(10_000, grace_ms=0),
        aggs=[TM.AggSpec(TM.AggKind.SUM, "s", input=_full_tree(17))])
    with pytest.raises(SQLCodegenError, match="spill slots"):
        TM.QueryExecutor(node, schema, device="cpu")


def _wide_set(n_cols: int = 20, n_progs: int = 24):
    """n_progs programs over n_cols int columns, each a chain over eight
    of them with a literal folded in: ~30 instructions a program."""
    names = [f"x{k}" for k in range(n_cols)]
    schema = Schema.of(**{c: ColumnType.INT for c in names})
    progs = []
    for p in range(n_progs):
        e = te.Col(names[p % n_cols])
        for k in range(1, 8):
            c = te.Col(names[(p + 3 * k) % n_cols])
            e = te.BinOp("-" if k % 3 else "*", te.BinOp("+", e, c),
                         te.Lit(k))
        progs.append((te.compile_device(e, schema), f"p{p}"))
    return names, tuple(progs)


def test_launch_plan_takes_a_wide_program_set():
    """24 programs over 20 columns, ~600 instructions in all: as few
    argument blocks as the instructions need, every program in one of
    them once, each within the kernel's tables, with the plain versions'
    results."""
    names, progs = _wide_set()
    total = sum(len(te.lower(p).ins) for p, _ in progs)
    assert total > kb.EXPR_MAX_OPS and len(progs) > kb.EXPR_MAX_PROGS
    plan = te.launch_plan(progs)
    assert len(plan.blocks) == -(-total // kb.EXPR_MAX_OPS)
    assert sorted(n for b in plan.blocks for _, n in b.progs) == \
        sorted(n for _, n in progs) and not plan.temps
    rng = np.random.default_rng(8)
    cols = {c: torch.from_numpy(rng.integers(-1000, 1000, N)
                                .astype(np.int32)) for c in names}
    valid = torch.ones(N, dtype=torch.bool)
    work = run_plan(plan, cols, valid)
    for prog, name in progs:
        assert torch.equal(work[name], prog(cols)), name


def test_a_program_past_a_block_is_cut_into_pieces():
    """One program over 80 columns (more than a block's column table)
    and one of 500 instructions: each is cut into pieces that pass
    temporary columns on; the last piece writes the program's own
    output."""
    names = [f"x{k}" for k in range(80)]
    schema = Schema.of(**{c: ColumnType.INT for c in names})
    wide = te.compile_device(
        te.BinOp("*", te.BinOp("+", _sum(names[:40]), te.Lit(3)),
                 _sum(names[40:])), schema)
    long = te.compile_device(
        te.BinOp("-", _sum(names[:20] * 25), te.Col(names[0])), schema)
    rng = np.random.default_rng(9)
    cols = {c: torch.from_numpy(rng.integers(-50, 50, N).astype(np.int32))
            for c in names}
    for prog in (wide, long):
        plan = te.launch_plan(((prog, "out"),))
        assert len(plan.blocks) > 1 and plan.temps
        last = plan.blocks[-1].progs[-1]
        assert last[1] == "out"
        valid = torch.ones(N, dtype=torch.bool)
        assert torch.equal(run_plan(plan, cols, valid)["out"], prog(cols))


def _sum(names):
    e = te.Col(names[0])
    for c in names[1:]:
        e = te.BinOp("+", e, te.Col(c))
    return e


# ---- queries ----------------------------------------------------------------

WIDE_COLS = [f"c{k}" for k in range(20)]


def _wide_aggs(m):
    """24 aggregates over the 20 columns: one of each plain kind per
    column in turn, COUNT(*), two computed inputs, a distinct count and
    a quantile."""
    kinds = [m.AggKind.SUM, m.AggKind.MIN, m.AggKind.MAX, m.AggKind.AVG,
             m.AggKind.COUNT]
    aggs = [m.AggSpec(m.AggKind.COUNT_ALL, "cnt")]
    for k, c in enumerate(WIDE_COLS):
        aggs.append(m.AggSpec(kinds[k % 5], f"a{k}", input=m.Col(c)))
    aggs.append(m.AggSpec(m.AggKind.SUM, "mix", input=m.BinOp(
        "+", m.BinOp("*", m.Col("c0"), m.Lit(2.0)), m.Col("c1"))))
    aggs.append(m.AggSpec(m.AggKind.APPROX_COUNT_DISTINCT, "dc",
                          input=m.Col("c2")))
    aggs.append(m.AggSpec(m.AggKind.SUM, "nested", input=m.BinOp(
        "-", m.Col("c3"), m.BinOp("-", m.Col("c4"), m.BinOp(
            "-", m.Col("c5"), m.Col("c6"))))))
    assert len(aggs) == 24
    return aggs


def _wide_recipe(m):
    schema = m.Schema.of(device=m.ColumnType.STRING,
                         **{c: m.ColumnType.FLOAT for c in WIDE_COLS})
    where = m.BinOp("AND", m.BinOp(">", m.Col("c19"), m.Lit(10.0)),
                    m.BinOp("<", m.Col("c18"), m.Lit(90.0)))
    child = m.FilterNode(m.SourceNode("s", schema), where)
    node = m.AggregateNode(child=child, group_keys=[m.Col("device")],
                           window=m.TumblingWindow(10_000, grace_ms=0),
                           aggs=_wide_aggs(m))
    return node, schema


def _wide_batches(seed: int, n_batches: int = 6, n: int = 200):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        vals = rng.integers(0, 100, (n, len(WIDE_COLS))).astype(float)
        keys = rng.integers(0, 6, n)
        rows = [{"device": f"d{k}", **dict(zip(WIDE_COLS, v))}
                for k, v in zip(keys, vals)]
        ts = (BASE + b * 3_000 + np.sort(rng.integers(0, 3_000, n)))
        out.append((rows, ts.tolist()))
    return out


@pytest.mark.parametrize("mode", ["close", "changes"])
def test_a_window_query_with_24_aggregates_over_20_columns(mode):
    jex, tex = pair(_wide_recipe, mode)
    assert len(tex._progs) == 3 and len(tex._needed_cols) == 20
    assert drive(jex, tex, _wide_batches(3))


def test_a_session_query_with_20_aggregates():
    """20 aggregates (four quantiles of v sharing one histogram):
    the port's device path (segment mode on the CPU) against the
    reference's device path, row for row; a quantile within 4e-6 (XLA
    contracts the midpoint's exp argument into an FMA, as torch_parity
    notes), the rest exact but for SUM's order (1e-6)."""
    names = ["c", "n", "s", "a", "lo", "hi", "d", "sx", "p50", "p99"]

    def aggs(m):
        base = {
            "c": lambda i: m.AggSpec(m.AggKind.COUNT_ALL, f"c{i}"),
            "n": lambda i: m.AggSpec(m.AggKind.COUNT, f"n{i}",
                                     input=m.Col("v")),
            "s": lambda i: m.AggSpec(m.AggKind.SUM, f"s{i}", input=m.BinOp(
                "+", m.Col("v"), m.Lit(float(i)))),
            "a": lambda i: m.AggSpec(m.AggKind.AVG, f"a{i}",
                                     input=m.Col("v")),
            "lo": lambda i: m.AggSpec(m.AggKind.MIN, f"lo{i}",
                                      input=m.Col("v")),
            "hi": lambda i: m.AggSpec(m.AggKind.MAX, f"hi{i}",
                                      input=m.Col("v")),
            "d": lambda i: m.AggSpec(m.AggKind.APPROX_COUNT_DISTINCT,
                                     f"d{i}", input=m.Col("v")),
            "sx": lambda i: m.AggSpec(m.AggKind.SUM, f"sx{i}", input=m.BinOp(
                "*", m.Col("v"), m.Lit(2.0))),
            "p50": lambda i: m.AggSpec(m.AggKind.APPROX_QUANTILE, f"p50{i}",
                                       input=m.Col("v"), quantile=0.5),
            "p99": lambda i: m.AggSpec(m.AggKind.APPROX_QUANTILE, f"p99{i}",
                                       input=m.Col("v"), quantile=0.99),
        }
        return [base[n](i) for i in range(2) for n in names]

    from hstream_tpu.engine.session import SessionExecutor as JSession
    from hstream_tpu_torch.engine import SessionExecutor

    jnode, jschema = _session_node(JM, aggs)
    tnode, tschema = _session_node(TM, aggs)
    j = JSession(jnode, jschema)
    t = SessionExecutor(tnode, tschema, device="cpu")
    j.use_device_sessions = t.use_device_sessions = True
    j.device_session_mode = t.device_session_mode = "segment"
    assert len(tnode.aggs) == 20
    outs, peeks = _feed([j, t], gen(4, n_batches=6))
    assert t._dev is not None and outs[0]
    assert_rows_close(list(outs[1]), list(outs[0]), 4e-6)
    assert_rows_close(list(peeks[1]), list(peeks[0]), 4e-6)


def _caps_aggs(m, what: str, n: int):
    """n SUMs of one column, or one SUM over n columns."""
    if what == "aggregates":
        return [m.AggSpec(m.AggKind.SUM, f"s{k}", input=m.Col("c0"))
                for k in range(n)]
    e = m.Col("c0")
    for k in range(1, n):
        e = m.BinOp("+", e, m.Col(f"c{k}"))
    return [m.AggSpec(m.AggKind.SUM, "s", input=e)]


@pytest.mark.parametrize("what", ["aggregates", "columns"])
def test_past_the_device_caps_a_query_is_refused_at_creation(what):
    """65 aggregates, or 65 input columns, are refused when the window or
    session query is created, on the CPU as on the card; 64 of each are
    taken."""
    n = kb.MAX_AGGS if what == "aggregates" else kb.MAX_COLS
    for count, ok in ((n, True), (n + 1, False)):
        schema = TM.Schema.of(device=TM.ColumnType.STRING, **{
            f"c{k}": TM.ColumnType.FLOAT for k in range(count)})
        aggs = _caps_aggs(TM, what, count)
        for window in (TM.TumblingWindow(10_000, grace_ms=0),
                       TM.SessionWindow(1000, grace_ms=0)):
            node = TM.AggregateNode(
                child=TM.SourceNode("s", schema),
                group_keys=[TM.Col("device")], window=window, aggs=aggs)
            make = (TM.QueryExecutor if isinstance(
                window, TM.TumblingWindow) else TM.SessionExecutor)
            if ok:
                make(node, schema, device="cpu")
            else:
                with pytest.raises(SQLCodegenError, match=what[:-1]):
                    make(node, schema, device="cpu")


def test_the_wide_window_query_runs_on_its_launch_plan():
    """The 24-aggregate query's step programs (WHERE and three computed
    inputs) fit one argument block: one launch a batch on the card."""
    _, tex = pair(_wide_recipe, "close")
    plan = te.launch_plan(tex._progs)
    assert len(plan.blocks) == 1
    batch = _wide_batches(5, 1, N)[0][0]
    cols = {c: torch.tensor([r[c] for r in batch], dtype=torch.float32)
            for c in WIDE_COLS}
    v1, v2 = torch.ones(N, dtype=torch.bool), torch.ones(N, dtype=torch.bool)
    work = run_plan(plan, cols, v1)
    te.eval_programs(tex._progs, cols, v2)
    assert torch.equal(v1, v2)
    for _, name in tex._progs:
        if name is not None:
            assert torch.equal(work[name].view(torch.int32),
                               cols[name].view(torch.int32))


def test_a_join_past_the_probe_feed_tables_takes_the_match_fetch_path():
    """A join whose inner query has 17 aggregates over inputs (17 NULL
    masks, past the fused probe's 16) runs on the port's match-fetch
    path: its feed plans are None, and its final change per (key,
    window) equals the reference's host join, counts exact and sums
    within rel 1e-6 (another order)."""
    from test_join_device import gen_batches
    from test_torch_join import make, run_all

    sums = ", ".join(f"SUM(l.x * {k}.0) AS s{k}" for k in range(1, 18))
    sql = ("SELECT l.k, COUNT(*) AS c, " + sums + " FROM l INNER JOIN r "
           "WITHIN (INTERVAL 1 SECOND) ON l.k = r.k GROUP BY l.k, "
           "TUMBLING (INTERVAL 10 SECOND) GRACE BY INTERVAL 0 SECOND "
           "EMIT CHANGES;")
    host = make(sql, port=False, use_device_join=False)
    dev = make(sql, port=True)
    outs = run_all((host, make(sql, port=False), dev),
                   gen_batches(seed=5, n_batches=8), planes=False)
    assert dev._dev is not None and dev._dev["feed"] is None
    assert dev.join_stats["fused_batches"] == 0 < \
        dev.join_stats["probe_batches"]

    def last(rows):
        return {(r["l.k"], r["winStart"]): r for r in rows}

    want, got = last(outs[0]), last(outs[2])
    assert set(want) == set(got) and want
    for key, w in want.items():
        assert got[key]["c"] == w["c"], key
        for k in range(1, 18):
            assert got[key][f"s{k}"] == pytest.approx(
                w[f"s{k}"], rel=1e-6, abs=0), (key, k)
