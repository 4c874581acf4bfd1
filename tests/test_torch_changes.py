"""EMIT CHANGES parity of the port's QueryExecutor (on the CPU, plain
versions) with hstream_tpu's, through the entry points users call:
process (rows), process_columnar, IngestPipeline, flush_changes, peek.

Each case mirrors a fixed-window case of the reference's own tests and
runs in every drain mode: close-only (emit_changes=False), changelog
decoded at once, deferred (two extracts per batched fetch) and the
asynchronous drain on the shared pool. Both engines get the same
batches, made from numpy seeds; every call's rows must agree (keys,
window bounds, counts and TOPK exact; float aggregates rel 1e-6; a
quantile rel 4e-6, tests/torch_parity.py).
"""

from __future__ import annotations

import numpy as np
import pytest

from hstream_tpu_torch.engine import convert
from torch_parity import BASE, JM, MODES, TM, assert_rows_equal, drive, \
    pair, rows_of


def _node(m, aggs, *, window="tumble", where=(), schema=None):
    schema = schema or m.Schema.of(device=m.ColumnType.STRING,
                                   temp=m.ColumnType.FLOAT,
                                   humidity=m.ColumnType.FLOAT)
    child = m.SourceNode("s", schema)
    for w in where:
        child = m.FilterNode(child, w(m))
    win = {"tumble": m.TumblingWindow(10_000, grace_ms=0),
           "none": None}[window]
    return m.AggregateNode(child=child, group_keys=[m.Col("device")],
                           window=win, aggs=aggs(m)), schema


def _count(m):
    return [m.AggSpec(m.AggKind.COUNT_ALL, "cnt")]


def _count_sum(m):
    return [m.AggSpec(m.AggKind.COUNT_ALL, "cnt"),
            m.AggSpec(m.AggKind.SUM, "total", input=m.Col("temp"))]


# ---- the mirrored cases: (recipe, batches) ----------------------------------

def tumbling_emit_changes():
    # tests/test_engine.py::test_tumbling_emit_changes
    return (lambda m: _node(m, _count),
            [rows_of(("a", 1.0, 0), ("a", 1.0, 100)),
             rows_of(("a", 1.0, 200))])


def where_filter_on_device():
    # tests/test_engine.py::test_where_filter_on_device
    return (lambda m: _node(m, _count, where=[
                lambda m: m.BinOp(">", m.Col("temp"), m.Lit(0.0))]),
            [rows_of(("a", 5.0, 0), ("a", -5.0, 100), ("a", 1.0, 200)),
             rows_of(("a", 1.0, 11_000))])


def string_equality_filter():
    # tests/test_engine.py::test_string_equality_filter
    return (lambda m: _node(m, _count, where=[
                lambda m: m.BinOp("=", m.Col("device"), m.Lit("a"))]),
            [rows_of(("a", 1.0, 0), ("b", 1.0, 100), ("a", 1.0, 200)),
             rows_of(("b", 1.0, 11_000))])


def approx_quantile():
    # tests/test_engine.py::test_approx_quantile
    vals = np.random.default_rng(1).lognormal(2.0, 1.0, size=5000)
    rows = [{"device": "a", "temp": float(v)} for v in vals]
    return (lambda m: _node(m, lambda m: [m.AggSpec(
                m.AggKind.APPROX_QUANTILE, "p50", input=m.Col("temp"),
                quantile=0.5)]),
            [(rows, [BASE + i for i in range(5000)]),
             rows_of(("a", 0.0, 11_000))])


def count_col_and_avg_skip_nulls():
    # tests/test_engine.py::test_count_col_and_avg_skip_nulls
    rows = [{"device": "a", "temp": 2.0}, {"device": "a"},
            {"device": "a", "temp": 4.0}, {"device": "a", "temp": None}]
    return (lambda m: _node(m, lambda m: [
                m.AggSpec(m.AggKind.COUNT, "c", input=m.Col("temp")),
                m.AggSpec(m.AggKind.AVG, "avg", input=m.Col("temp")),
                m.AggSpec(m.AggKind.COUNT_ALL, "call")]),
            [(rows, [BASE + i for i in range(4)]),
             rows_of(("a", 0.0, 11_000))])


def nested_filters_all_applied():
    # tests/test_engine.py::test_nested_filters_all_applied
    return (lambda m: _node(m, _count, where=[
                lambda m: m.BinOp(">", m.Col("temp"), m.Lit(0.0)),
                lambda m: m.BinOp("<", m.Col("temp"), m.Lit(10.0))]),
            [rows_of(("a", -5.0, 0), ("a", 5.0, 100), ("a", 50.0, 200)),
             rows_of(("a", 5.0, 11_000))])


def _topk_schema(m):
    return m.Schema.of(d=m.ColumnType.STRING, v=m.ColumnType.FLOAT)


def _topk_recipe(kind, k):
    def recipe(m):
        schema = _topk_schema(m)
        node = m.AggregateNode(
            child=m.SourceNode("s", schema), group_keys=[m.Col("d")],
            window=m.TumblingWindow(10_000, grace_ms=0),
            aggs=[m.AggSpec(getattr(m.AggKind, kind), "top",
                            input=m.Col("v"), k=k)])
        return node, schema
    return recipe


def _v(*pairs):
    return ([{"d": d, "v": float(v)} for d, v, _ in pairs],
            [BASE + t for _, _, t in pairs])


def topk_device_lattice():
    # tests/test_topk_tablejoin.py::test_topk_device_lattice
    rows = [("a", x, i) for i, x in enumerate([5, 1, 9, 7, 3, 9])]
    return (_topk_recipe("TOPK", 3),
            [_v(*rows, ("b", 2.0, 6)), _v(("z", 0.0, 30_000))])


def topk_distinct_device_lattice():
    # tests/test_topk_tablejoin.py::test_topk_distinct_device_lattice
    rows = [("a", x, i) for i, x in enumerate([5, 9, 9, 9, 7, 5, 3])]
    return (_topk_recipe("TOPK_DISTINCT", 3),
            [_v(*rows), _v(("z", 0.0, 30_000))])


def topk_across_batches_monoid():
    # tests/test_topk_tablejoin.py::test_topk_across_batches_monoid
    return (_topk_recipe("TOPK", 2),
            [_v(("a", 1.0, 0), ("a", 5.0, 1)), _v(("a", 3.0, 2)),
             _v(("a", 8.0, 3)), _v(("z", 0.0, 30_000))])


CASES = {f.__name__: f for f in (
    tumbling_emit_changes, where_filter_on_device, string_equality_filter,
    approx_quantile, count_col_and_avg_skip_nulls,
    nested_filters_all_applied, topk_device_lattice,
    topk_distinct_device_lattice, topk_across_batches_monoid)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", list(CASES))
def test_mirrored_cases_match_the_reference(case, mode):
    recipe, batches = CASES[case]()
    jex, tex = pair(recipe, mode)
    rows = drive(jex, tex, batches,
                 quantiles=("p50",) if case == "approx_quantile" else ())
    assert rows or mode == "close", "the changelog is empty"
    assert tex.close_stats == jex.close_stats


def test_reference_expectations_hold_in_the_port():
    """The reference tests' own assertions, on the port's changelog."""
    recipe, batches = tumbling_emit_changes()
    _, tex = pair(recipe)
    out = list(tex.process(*batches[0]))
    assert len(out) == 1 and out[0]["cnt"] == 2 and out[0]["device"] == "a"
    assert list(tex.process(*batches[1]))[0]["cnt"] == 3
    recipe, batches = topk_device_lattice()
    _, tex = pair(recipe)
    out = [r for b in batches for r in tex.process(*b)]
    fin = {r["d"]: r["top"] for r in out if r.get("winStart") == BASE}
    assert fin["a"] == [9.0, 9.0, 7.0] and fin["b"] == [2.0]
    recipe, batches = topk_distinct_device_lattice()
    _, tex = pair(recipe)
    out = [r for b in batches for r in tex.process(*b)]
    assert {r["d"]: r["top"] for r in out
            if r.get("winStart") == BASE}["a"] == [9.0, 7.0, 5.0]
    recipe, batches = count_col_and_avg_skip_nulls()
    _, tex = pair(recipe, "close")
    tex.process(*batches[0])
    r = list(tex.process(*batches[1]))[0]
    assert (r["call"], r["c"], r["avg"]) == (4, 2, pytest.approx(3.0))


def test_emit_changes_close_resets_without_fetch():
    # tests/test_close_batched.py::test_emit_changes_close_resets_without_fetch
    jex, tex = pair(lambda m: _node(m, _count))
    for ex in (jex, tex):
        out = list(ex.process(*rows_of(("a", 1.0, 0), ("a", 1.0, 100))))
        assert out[0]["cnt"] == 2
        before = dict(ex.close_stats)
        ex.process(*rows_of(("a", 1.0, 12_000)))   # closes w0 silently
        assert ex.close_stats["close_dispatches"] == \
            before["close_dispatches"] + 1
        assert ex.close_stats["close_fetches"] == before["close_fetches"]
        got = {(r["device"], r["winStart"]): r for r in ex.peek()}
        assert ("a", BASE) not in got
        assert got[("a", BASE + 10_000)]["cnt"] == 1
    assert_rows_equal(jex.peek(), tex.peek())


def test_windowless_peek_matches_changes():
    # tests/test_close_batched.py::test_windowless_peek_matches_changes
    jex, tex = pair(lambda m: _node(m, _count_sum, window="none"))
    batch = rows_of(("a", 1.0, 0), ("b", 2.0, 50), ("a", 3.0, 60))
    assert_rows_equal(jex.process(*batch), tex.process(*batch))
    got = {r["device"]: r for r in tex.peek()}
    assert got["a"]["cnt"] == 2 and got["a"]["total"] == pytest.approx(4.0)
    assert got["b"]["cnt"] == 1
    assert_rows_equal(jex.peek(), tex.peek())


def test_default_is_emit_changes_in_both_packages():
    """QueryExecutor(node, schema) emits a changelog in both packages."""
    out = []
    for m, kw in ((JM, {}), (TM, {"device": "cpu"})):
        node, schema = _node(m, _count_sum)
        ex = m.QueryExecutor(node, schema, **kw)
        assert ex.emit_changes
        rows = list(ex.process(*rows_of(("a", 1.0, 0), ("b", 2.0, 10))))
        rows += list(ex.process(*rows_of(("a", 4.0, 20))))
        out.append(rows)
    assert len(out[1]) == 3       # a changelog row per touched key per batch
    assert_rows_equal(out[0], out[1])


def _sensor_batches(seed: int, n_batches: int = 12, n: int = 300,
                    null_rate: float = 0.05):
    """Columnar batches over 16 keys with NULL temps, 4 s of stream time
    each (three per window)."""
    rng = np.random.default_rng(seed)
    for b in range(n_batches):
        kids = rng.integers(0, 16, n).astype(np.int32)
        ts = BASE + b * 4_000 + np.sort(rng.integers(0, 4_000, n))
        temps = (np.rint(rng.normal(18, 6, n) * 10).astype(np.float32)
                 * np.float32(0.1))
        temps[::41] = np.nan
        nulls = {"temp": rng.random(n) < null_rate}
        yield kids, ts, {"temp": temps}, nulls


def _changelog_recipe(m):
    temp = m.Col("temp")
    return _node(m, lambda m: [
        m.AggSpec(m.AggKind.COUNT, "c", input=temp),
        m.AggSpec(m.AggKind.SUM, "s", input=m.BinOp(
            "+", m.BinOp("*", temp, m.Lit(1.8)), m.Lit(32))),
        m.AggSpec(m.AggKind.APPROX_QUANTILE, "q", input=temp,
                  quantile=0.99),
        m.AggSpec(m.AggKind.TOPK, "t", input=temp, k=3),
        m.AggSpec(m.AggKind.TOPK_DISTINCT, "td", input=temp, k=3)],
        where=[lambda m: m.BinOp(">", m.Col("temp"), m.Lit(15.0))])


def _keyed(jex, tex):
    for k in range(16):
        jex.key_id_for((f"d{k}",))
        tex.key_id_for((f"d{k}",))


@pytest.mark.parametrize("mode", ["changes", "async"])
def test_changelog_query_columnar_with_nulls(mode):
    """The changelog path's query (chip_smoke phase 6) at a small size:
    WHERE, a computed input, NULLs, COUNT(col), quantile, both TOPKs."""
    jex, tex = pair(_changelog_recipe, mode)
    _keyed(jex, tex)
    rows = drive(jex, tex, list(_sensor_batches(3)), columnar=True,
                 quantiles=("q",))
    assert len({r["winStart"] for r in rows}) == 5
    assert tex.close_stats == jex.close_stats
    assert tex.close_stats["close_fetches"] == 0
    assert tex.close_stats["close_cycles"] == 4


def test_pipeline_returns_changes_in_submission_order_and_flush_drains():
    from hstream_tpu.engine.pipeline import IngestPipeline as JPipe
    from hstream_tpu_torch.engine import IngestPipeline as TPipe

    jex, tex = pair(_changelog_recipe, "async")
    _keyed(jex, tex)
    batches = list(_sensor_batches(5))
    want = []
    for b in batches:
        want.extend(jex.process_columnar(*b))
    want.extend(jex.flush_changes())
    pipe = TPipe(tex, depth=3, workers=2)
    got = []
    try:
        for kids, ts, cols, nulls in batches:
            got.extend(pipe.submit(kids, ts, cols, nulls))
        got.extend(pipe.flush())
    finally:
        pipe.close()
    assert not tex.has_pending_changes()
    assert_rows_equal(want, got, quantiles=("q",))
    assert JPipe is not None


def test_adopt_a_jax_changelog_executor_mid_stream():
    """convert.adopt carries a running EMIT CHANGES query (quantile and
    TOPK planes, touched, epoch, watermark, open windows, keys) from the
    JAX executor into the port; both then emit the same changelog."""
    jex, tex = pair(_changelog_recipe, "changes")
    _keyed(jex, tex)
    batches = list(_sensor_batches(9))
    for b in batches[:5]:
        jex.process_columnar(*b)
    convert.adopt(tex, {k: np.asarray(v) for k, v in jex.state.items()},
                  epoch=jex.epoch, watermark_abs=jex.watermark_abs,
                  open_windows={s: w.slot for s, w in jex._open.items()},
                  keys=jex._key_rev)
    assert {"a2_approx_quantile", "a3_topk", "a4_topk_distinct",
            "touched"} <= set(tex.state)
    drive(jex, tex, batches[5:], columnar=True, quantiles=("q",))
