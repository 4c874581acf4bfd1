"""Parity of the port's SQL front end with hstream_tpu.sql: the same SQL
text through both packages' parse -> refine -> codegen.

Every case of tests/test_sql.py and tests/test_validate.py: plans are
compared field by field (torch_parity.plan_tuple turns either package's
plan dataclasses into plain tuples), errors by class name and message,
EXPLAIN line for line (the MESH line's device count left out), and the
end-to-end cases run the lowered plans
through both packages' executors (the port's on device="cpu") and
compare every emitted row (floats rel 1e-6, torch_parity).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hstream_tpu import sql as jsql
from hstream_tpu.sql import codegen as jcg
from hstream_tpu_torch import sql as tsql
from hstream_tpu_torch.common.errors import NotPortedError
from hstream_tpu_torch.sql import codegen as tcg
from test_validate import BAD, GOOD
from torch_parity import BASE, assert_rows_equal, plan_tuple

# the SQL text of tests/test_sql.py's plan and error cases
PLAN_SQL = [
    "SELECT COUNT(*), SUM(temp) FROM weather "
    "GROUP BY city, TUMBLING (INTERVAL 10 SECOND) EMIT CHANGES;",
    "SELECT COUNT(*), SUM(temp) FROM weather WHERE temp > 0 "
    "GROUP BY city, TUMBLING (INTERVAL 10 SECOND) EMIT CHANGES;",
    "SELECT AVG(x) FROM s GROUP BY k, "
    "HOPPING (INTERVAL 1 MINUTE, INTERVAL 10 SECOND) EMIT CHANGES;",
    "SELECT COUNT(*) FROM s GROUP BY k, "
    "SESSION (INTERVAL 30 SECOND) EMIT CHANGES;",
    "CREATE STREAM s;",
    "CREATE STREAM s2 AS SELECT COUNT(*) FROM s GROUP BY k EMIT CHANGES;",
    "CREATE VIEW v AS SELECT COUNT(*) FROM s GROUP BY k;",
    "INSERT INTO s (a, b) VALUES (1, 'x');",
    'INSERT INTO s VALUES \'{"a": 2.5}\';',
    "SHOW STREAMS;",
    "DROP VIEW v IF EXISTS;",
    "TERMINATE QUERY q1;",
    "SELECT * FROM v WHERE k = 'a';",
    "EXPLAIN SELECT COUNT(*) FROM s GROUP BY k EMIT CHANGES;",
    "SELECT COUNT(*), SUM(temp) FROM weather WHERE city = 'sf' "
    "GROUP BY city, TUMBLING (INTERVAL 10 SECOND) EMIT CHANGES;",
]
ERROR_SQL = [
    "SELECT COUNT(*) FROM s WHERE SUM(x) > 1 GROUP BY k EMIT CHANGES;",
    "SELECT x AS a, y AS a FROM s EMIT CHANGES;",
    "SELECT SUM(COUNT(*)) FROM s GROUP BY k EMIT CHANGES;",
    "SELECT * FROM s GROUP BY k, HOPPING (INTERVAL 15 SECOND, "
    "INTERVAL 10 SECOND) EMIT CHANGES;",
    "SELECT FROM s;",
    "SELECT a FROM s GROUP BY k, TUMBLING (INTERVAL 10 PARSEC) "
    "EMIT CHANGES;",
]

_G = " GRACE BY INTERVAL 0 SECOND"
# (SQL, sample rows, batches as (rows, ts offsets)) of tests/test_sql.py's
# end-to-end cases
RUNS = {
    "tumbling": (
        "SELECT COUNT(*), SUM(temp) FROM weather GROUP BY city, "
        "TUMBLING (INTERVAL 10 SECOND) GRACE BY INTERVAL 1 SECOND "
        "EMIT CHANGES;",
        [([{"city": "sf", "temp": 10.0}, {"city": "sf", "temp": 20.0},
           {"city": "la", "temp": 30.0}], [0, 100, 200]),
         ([{"city": "la", "temp": 1.0}], [20_000])]),
    "projection_alias": (
        "SELECT city, AVG(temp) AS avg_temp, SUM(temp) / COUNT(temp) AS "
        "check FROM weather GROUP BY city, TUMBLING (INTERVAL 10 SECOND)"
        + _G + " EMIT CHANGES;",
        [([{"city": "sf", "temp": 10.0}, {"city": "sf", "temp": 30.0}],
          [0, 100]), ([{"city": "x", "temp": 0.0}], [20_000])]),
    "having": (
        "SELECT k, COUNT(*) AS c FROM s GROUP BY k, "
        "TUMBLING (INTERVAL 10 SECOND)" + _G
        + " HAVING COUNT(*) >= 2 EMIT CHANGES;",
        [([{"k": "a", "x": 1.0}, {"k": "a", "x": 1.0},
           {"k": "b", "x": 1.0}], [0, 1, 2]),
         ([{"k": "c", "x": 0.0}], [20_000])]),
    "stateless": (
        "SELECT temp AS t, city FROM weather WHERE temp > 15 EMIT CHANGES;",
        [([{"city": "sf", "temp": 10.0}, {"city": "la", "temp": 20.0}],
          [0, 1])]),
    "aliased_group_key": (
        "SELECT city AS town, COUNT(*) AS c FROM weather GROUP BY city, "
        "TUMBLING (INTERVAL 10 SECOND)" + _G + " EMIT CHANGES;",
        [([{"city": "sf", "temp": 1.0}, {"city": "sf", "temp": 2.0}],
          [0, 1]), ([{"city": "xx", "temp": 0.0}], [20_000])]),
    "string_filter": (
        "SELECT COUNT(*) AS c FROM weather WHERE city = 'sf' GROUP BY city, "
        "TUMBLING (INTERVAL 10 SECOND)" + _G + " EMIT CHANGES;",
        [([{"city": "sf", "temp": 1.0}, {"city": "la", "temp": 1.0},
           {"city": "sf", "temp": 1.0}], [0, 1, 2]),
         ([{"city": "xx", "temp": 0.0}], [20_000])]),
    "session": (
        "SELECT k, COUNT(*) AS c FROM s GROUP BY k, "
        "SESSION (INTERVAL 5 SECOND)" + _G + " EMIT CHANGES;",
        [([{"k": "a"}, {"k": "a"}], [0, 1000]), ([{"k": "a"}], [10_000]),
         ([{"k": "a"}], [30_000])]),
    "session_merge": (
        "SELECT k, COUNT(*) AS c, MIN(x) AS mn FROM s GROUP BY k, "
        "SESSION (INTERVAL 5 SECOND)" + _G + " EMIT CHANGES;",
        [([{"k": "a", "x": 3.0}], [0]), ([{"k": "a", "x": 5.0}], [8000]),
         ([{"k": "a", "x": 1.0}], [4000]),
         ([{"k": "a", "x": 9.0}], [40_000])]),
    "session_quantile": (
        "SELECT k, APPROX_QUANTILE(x, 0.5) AS p50 FROM s GROUP BY k, "
        "SESSION (INTERVAL 5 SECOND)" + _G + " EMIT CHANGES;",
        [([{"k": "a", "x": float(v)} for v in np.random.default_rng(0)
           .lognormal(1.0, 0.8, size=500)], list(range(500))),
         ([{"k": "a", "x": 1.0}], [60_000])]),
}


def _both(fn_name: str, *args):
    """fn_name of both packages' sql modules on args: (JAX, port), each
    a value or the exception it raised."""
    out = []
    for mod in (jsql, tsql):
        try:
            out.append(getattr(mod, fn_name)(*args))
        except Exception as e:  # noqa: BLE001 — compared below
            out.append(e)
    return out


def _same_error(j, t):
    assert isinstance(j, Exception) and isinstance(t, Exception), (j, t)
    assert type(t).__name__ == type(j).__name__
    assert str(t) == str(j)
    assert getattr(t, "pos", None) == getattr(j, "pos", None)


def _explain_lines(text: str) -> list[str]:
    """EXPLAIN's lines, the MESH line's device count left out: the
    reference counts jax.device_count() (8 virtual CPU devices under the
    test suite), the port the cards (1 here)."""
    import re

    return [re.sub(r"over \d+ chips", "over N chips", ln)
            for ln in text.splitlines()]


def _same_plan(j, t):
    assert not isinstance(j, Exception), j
    assert not isinstance(t, Exception), t
    if isinstance(j, jsql.plans.ExplainPlan):
        assert plan_tuple(t.inner) == plan_tuple(j.inner)
        assert _explain_lines(t.text) == _explain_lines(j.text)
        pack = [[ln for ln in x.text.splitlines() if ln.startswith("PACK:")]
                for x in (j, t)]
        assert pack[1] == pack[0]
    else:
        assert plan_tuple(t) == plan_tuple(j)


@pytest.mark.parametrize("sql", PLAN_SQL + GOOD + [r[0] for r in
                                                   RUNS.values()],
                         ids=lambda s: s[:48])
def test_plans_match(sql):
    _same_plan(*_both("stream_codegen", sql))
    j, t = _both("parse_and_refine", sql)
    assert plan_tuple(t) == plan_tuple(j)


@pytest.mark.parametrize("sql", PLAN_SQL + GOOD, ids=lambda s: s[:48])
def test_explain_matches_but_for_the_pack_line(sql):
    """EXPLAIN's whole text, the PACK line included (the name is the one
    the test had while the port lacked that line)."""
    j, t = _both("stream_codegen", "EXPLAIN " + sql)
    if isinstance(j, Exception):
        _same_error(j, t)
        return
    _same_plan(j, t)


@pytest.mark.parametrize("sql,pat", BAD, ids=[b[0][:48] for b in BAD])
def test_rejected_with_the_same_error(sql, pat):
    import re

    j, t = _both("parse_and_refine", sql)
    _same_error(j, t)
    assert re.search(pat, str(t)), (pat, str(t))
    _same_error(*_both("stream_codegen", sql))


@pytest.mark.parametrize("sql", ERROR_SQL, ids=lambda s: s[:48])
def test_errors_match(sql):
    j, t = _both("stream_codegen", sql)
    _same_error(j, t)


@pytest.mark.parametrize("case", list(RUNS))
def test_end_to_end_rows_match(case):
    sql, batches = RUNS[case]
    jplan, tplan = jsql.stream_codegen(sql), tsql.stream_codegen(sql)
    sample = batches[0][0]
    jex = jcg.make_executor(jplan, sample_rows=sample, initial_keys=8,
                            batch_capacity=256)
    tex = tcg.make_executor(tplan, sample_rows=sample, initial_keys=8,
                            batch_capacity=256, device="cpu")
    assert type(tex).__name__ == type(jex).__name__
    want, got = [], []
    for rows, offs in batches:
        ts = [BASE + o for o in offs]
        want.extend(jex.process(rows, ts))
        got.extend(tex.process(rows, ts))
    assert want
    assert_rows_equal(want, got, quantiles=("p50",))


def test_bind_schema_inference_matches():
    sql = ("SELECT COUNT(*), SUM(temp) FROM weather WHERE city = 'sf' "
           "GROUP BY city, TUMBLING (INTERVAL 10 SECOND) EMIT CHANGES;")
    rows = [{"city": "sf", "temp": 1.0, "ok": True, "n": 3, "s": "x"}]
    j = jcg.bind_schema(jsql.stream_codegen(sql), rows)
    t = tcg.bind_schema(tsql.stream_codegen(sql), rows)
    assert plan_tuple(t) == plan_tuple(j)


def test_emitted_group_cols_and_mesh_reason_match():
    for sql in ("SELECT city AS c, COUNT(*) AS n FROM w GROUP BY city "
                "EMIT CHANGES;",
                "SELECT k, TOPK(x, 2) FROM s GROUP BY k EMIT CHANGES;",
                "SELECT a, b FROM s WHERE a > 1 EMIT CHANGES;",
                "SELECT l.k, COUNT(*) FROM l INNER JOIN TABLE(r) "
                "ON l.k = r.k GROUP BY l.k EMIT CHANGES;"):
        jp, tp = jsql.stream_codegen(sql), tsql.stream_codegen(sql)
        assert tcg.mesh_exclusion_reason(tp) == \
            jcg.mesh_exclusion_reason(jp)
        if hasattr(jp.node, "aggs"):
            assert tcg.emitted_group_cols(tp.node) == \
                jcg.emitted_group_cols(jp.node)


def test_explain_mesh_line_counts_the_cards(monkeypatch):
    sql = "EXPLAIN SELECT COUNT(*) FROM s GROUP BY k EMIT CHANGES;"
    text = tsql.stream_codegen(sql).text
    assert "MESH: shardable over 1 chips" in text  # no card here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert "MESH: shardable over 4 chips" in tsql.stream_codegen(sql).text


def test_make_executor_shards_on_a_mesh():
    """On a mesh with a key axis past one, a windowed aggregate builds a
    ShardedQueryExecutor, a session window a SessionExecutor whose arena
    key-shards once its device path activates (B19c), and an interval
    join a JoinExecutor whose stores key-shard and whose inner aggregate
    goes sharded (B19b); a mesh of one key shard keeps the session's
    single-card kernels."""
    from hstream_tpu_torch.engine.join import JoinExecutor
    from hstream_tpu_torch.engine.session import SessionExecutor
    from hstream_tpu_torch.parallel import ShardedQueryExecutor, make_mesh

    mesh = make_mesh(2, 2, devices=["cpu"])
    plan = tsql.stream_codegen(PLAN_SQL[0])
    ex = tcg.make_executor(plan, mesh=mesh, initial_keys=8, device="cpu")
    assert isinstance(ex, ShardedQueryExecutor)
    session = tsql.stream_codegen(
        "CREATE VIEW sv AS SELECT k, COUNT(*) AS c FROM s GROUP BY k, "
        "SESSION (INTERVAL 5 SECOND);").select
    sx = tcg.make_executor(session, mesh=mesh,
                           sample_rows=[{"k": "a"}], device="cpu")
    assert isinstance(sx, SessionExecutor) and sx.mesh is mesh
    sx.process([{"k": f"k{i % 5}"} for i in range(20)],
               [BASE + 10 * i for i in range(20)])
    assert sx._dev is not None and sx._dev["ssl"].n_shards == 2
    assert sx.sharded_dispatches == 1
    join = tsql.stream_codegen(
        "SELECT s.k, COUNT(*) AS c FROM s INNER JOIN t WITHIN "
        "(INTERVAL 5 SECOND) ON s.k = t.k GROUP BY s.k, "
        "TUMBLING (INTERVAL 10 SECOND) EMIT CHANGES;")
    jx = tcg.make_executor(join, mesh=mesh, sample_rows=[{"k": "a"}],
                           device="cpu")
    assert isinstance(jx, JoinExecutor) and jx.mesh is mesh
    for b in range(4):
        jx.process([{"k": f"k{i % 3}"} for i in range(6)],
                   [BASE + 100 * b + i for i in range(6)],
                   stream="s" if b % 2 else "t")
    assert jx._dev is not None and jx._dev["sjl"].n_shards == 2
    assert isinstance(jx._inner, ShardedQueryExecutor)
    assert jx.sharded_dispatches > 0
    # a mesh of one key shard keeps the session's single-card kernels
    one = tcg.make_executor(session, mesh=make_mesh(2, 1, devices=["cpu"]),
                            sample_rows=[{"k": "a"}], device="cpu")
    one.process([{"k": "a"}], [BASE])
    assert type(one).__name__ == "SessionExecutor"
    assert one._dev is not None and one._dev["ssl"] is None
