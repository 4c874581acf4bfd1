"""Parity of the port's host-only engine pieces with hstream_tpu's: the
stateless executor (filter + projection over rows) and the keyed state
stores, driven with the same seeded operations in both packages; their
outputs must be equal (they are host Python, so exactly).
"""

from __future__ import annotations

import numpy as np
import pytest

import hstream_tpu.engine as J
from hstream_tpu.engine import expr as je
from hstream_tpu.engine import statestore as jss
from hstream_tpu.engine.stateless import StatelessExecutor as JStateless
import hstream_tpu_torch.engine as T
from hstream_tpu_torch.common.errors import SQLCodegenError
from hstream_tpu_torch.engine import expr as te


def _plan(m, e, project: bool):
    schema = m.Schema.of(device=m.ColumnType.STRING,
                         temp=m.ColumnType.FLOAT)
    node = m.FilterNode(m.SourceNode("s", schema),
                        e.BinOp(">", e.Col("temp"), e.Lit(15.0)))
    if project:
        node = m.ProjectNode(node, [
            ("device", e.Col("device")),
            ("f", e.BinOp("+", e.BinOp("*", e.Col("temp"), e.Lit(1.8)),
                          e.Lit(32))),
            ("up", e.UnOp("TO_UPPER", e.Col("device")))])
    return node


def _rows(seed: int):
    rng = np.random.default_rng(seed)
    rows = [{"device": f"d{rng.integers(0, 5)}",
             "temp": float(np.rint(rng.normal(18, 6) * 10) / 10)}
            for _ in range(300)]
    for r in rows[::13]:
        r["temp"] = None                 # NULL operand: predicate not true
    for r in rows[5::17]:
        del r["temp"]
    return rows


@pytest.mark.parametrize("project", [False, True])
def test_stateless_executor_matches(project):
    jex = JStateless(_plan(J, je, project))
    tex = T.StatelessExecutor(_plan(T, te, project))
    for seed in range(3):
        rows = _rows(seed)
        assert tex.process(rows) == jex.process(rows)


def test_stateless_executor_refuses_what_the_reference_refuses():
    schema = T.Schema.of(device=T.ColumnType.STRING)
    src = T.SourceNode("s", schema)
    agg = T.AggregateNode(child=src, group_keys=[te.Col("device")],
                          window=None, aggs=[])
    with pytest.raises(SQLCodegenError, match="AggregateNode"):
        T.StatelessExecutor(agg)


def test_state_stores_match():
    rng = np.random.default_rng(4)
    jt, tt = jss.TimestampedKVStore(), T.TimestampedKVStore()
    jl, tl = jss.LastValueStore(), T.LastValueStore()
    for _ in range(500):
        key = (f"k{rng.integers(0, 6)}",)
        ts = int(rng.integers(0, 1000))
        row = {"v": int(rng.integers(0, 100))}
        for s in (jt, tt):
            s.put(key, ts, row)
        for s in (jl, tl):
            s.update(key, ts, row)
        if rng.random() < 0.05:
            cut = int(rng.integers(0, 1000))
            jt.prune(cut)
            tt.prune(cut)
    for k in range(7):
        key = (f"k{k}",)
        assert tt.range(key, 100, 700) == jt.range(key, 100, 700)
        assert tl.lookup(key) == jl.lookup(key)
    assert tt.by_key == jt.by_key and len(tl) == len(jl)
