"""The port's JoinExecutor and TableJoinExecutor (hstream_tpu_torch/engine/
join.py) against the JAX package's, on the CPU.

Every case starts from the same SQL: the JAX package's parser and codegen
lower it (`stream_codegen`), and tests/torch_parity.py's `plan_from`
rebuilds that plan from the port's dataclasses. The port runs with
device="cpu" (its device path on the plain PyTorch versions of the
kernels) against the JAX package's device path and its host reference
path (use_device_join=False). Tolerances: the FINAL change per (key,
window) must agree (coalescing and deferred drains change emission
cadence only), counts exact, SUM within rel 1e-6 (the inputs are
normal(1, 1) floats added in another order); store planes, compared
through convert.join_state after each batch, bit-exact.

Left out here, with their slices: the snapshot round trip and
_host_store_view (ROADMAP A3), the server cases (A5), the sharded mirror
(A11).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from hstream_tpu.engine.join import JoinExecutor as JJoin
from hstream_tpu.sql import stream_codegen
from hstream_tpu.sql.codegen import make_executor as jmake
from hstream_tpu_torch.common.errors import DeviceUnavailable, SQLCodegenError
from hstream_tpu_torch.engine import convert
from hstream_tpu_torch.engine import join_lattice as jl
from hstream_tpu_torch.engine.join import JoinExecutor, TableJoinExecutor
from hstream_tpu_torch.sql.codegen import make_executor as tmake
from test_join_device import SQL, gen_batches
from torch_parity import plan_from

BASE = 1_700_000_000_000
SAMPLE = [{"k": "k0", "x": 1.0}]


def make(sql=SQL, *, port: bool, sample=SAMPLE, **tune):
    plan = stream_codegen(sql)
    ex = (tmake(plan_from(plan), sample_rows=sample, device="cpu") if port
          else jmake(plan, sample_rows=sample))
    for k, v in tune.items():
        setattr(ex, k, v)
    return ex


def trio(sql=SQL, sample=SAMPLE, **tune):
    """(JAX host path, JAX device path, port on the CPU)."""
    return (make(sql, port=False, sample=sample, use_device_join=False,
                 **tune),
            make(sql, port=False, sample=sample, **tune),
            make(sql, port=True, sample=sample, **tune))


def feed(ex, rows, ts, side, columnar=False):
    if not columnar:
        return list(ex.process(rows, ts, stream=side))
    kk = np.asarray([r["k"] for r in rows], object)
    xx = np.asarray([r["x"] for r in rows], np.float64)
    return list(ex.process_columnar(np.asarray(ts, np.int64),
                                    {"k": kk, "x": xx}, stream=side))


def final(rows, key="l.k"):
    last = {}
    for r in rows:
        last[(r[key], r["winStart"])] = (r["c"], r.get("s"))
    return last


def assert_final_equal(want, got):
    assert set(want) == set(got)
    for k, (c, s) in want.items():
        gc, gs = got[k]
        assert gc == c, k
        if s is not None:
            assert gs == pytest.approx(s, rel=1e-6, abs=0), k


def assert_stores_equal(jex, tex):
    a, b = convert.join_state(jex), convert.join_state(tex)
    for side in ("l", "r"):
        for k in ("code", "ts", "flags", "cols"):
            assert np.array_equal(a["stores"][side][k],
                                  b["stores"][side][k]), (side, k)
        assert jl.store_sorted({k: torch.from_numpy(v) for k, v
                                in b["stores"][side].items()})
    for k in ("cap", "t0", "n", "match_cap", "evict_cutoff", "lay",
              "jcode_rev", "watermark"):
        assert a[k] == b[k], k
    assert np.array_equal(a["kid_lut"], b["kid_lut"])


def run_all(execs, batches, *, columnar=False, planes=True):
    """Feed every executor the batches, flushing after each when
    comparing store planes; returns each one's rows."""
    outs = [[] for _ in execs]
    for rows, ts, side in batches:
        for ex, out in zip(execs, outs):
            out.extend(feed(ex, rows, ts, side, columnar))
            if planes:
                out.extend(ex.flush_changes())
        jdev, tdev = execs[1], execs[2]
        if planes and jdev._dev is not None:
            assert tdev._dev is not None
            assert_stores_equal(jdev, tdev)
    for ex, out in zip(execs, outs):
        out.extend(ex.flush_changes())
        assert not ex.has_pending_changes()
    return outs


def assert_equivalent(batches, *, columnar=False, planes=True, **tune):
    host, jdev, tdev = trio(**tune)
    outs = run_all((host, jdev, tdev), batches, columnar=columnar,
                   planes=planes)
    href = final(outs[0])
    assert_final_equal(href, final(outs[1]))
    assert_final_equal(href, final(outs[2]))
    assert tdev._dev is not None, "the port's device path did not activate"
    assert tdev.join_stats == jdev.join_stats
    return host, jdev, tdev


# ---- equivalence (tests/test_join_device.py) --------------------------------

def test_equivalence_basic():
    _, _, dev = assert_equivalent(gen_batches())
    assert dev.join_stats["probe_batches"] > 0


def test_out_of_order_arrivals():
    _, _, dev = assert_equivalent(gen_batches(seed=7, jitter=1500,
                                              shuffle=True))
    assert dev.join_stats["probe_dispatches"] == \
        dev.join_stats["probe_batches"]


def test_watermark_eviction():
    batches = gen_batches(seed=3, n_batches=30, stride=700, jitter=900)
    host, jdev, dev = trio()
    jdev.DEVICE_STORE_CAPACITY = dev.DEVICE_STORE_CAPACITY = 1 << 9
    outs = run_all((host, jdev, dev), batches)
    assert_final_equal(final(outs[0]), final(outs[2]))
    assert dev.join_stats["evict_dispatches"] > 0
    assert dev.join_stats == jdev.join_stats
    counts = dev.device_store_counts()
    assert counts == jdev.device_store_counts()
    assert counts["l"] + counts["r"] < 30 * 256


def test_key_growth_and_code_remap():
    """More distinct keys than the inner executor's initial capacity (the
    code -> kid table grows, the inner lattice grows its keys), then a
    code compaction mid-stream in both packages (the device remap: the
    remap kernel's sentinel mode on the card)."""
    batches = gen_batches(seed=5, n_batches=16, n_keys=3000, n=512)
    host, jdev, dev = trio()
    outs = run_all((host, jdev, dev), batches[:9])
    for ex in (jdev, dev):
        ex.DEVICE_STORE_CAPACITY = 1 << 10
        ex._compact_codes()
    assert_stores_equal(jdev, dev)
    more = run_all((host, jdev, dev), batches[9:])
    assert_final_equal(final(outs[0] + more[0]), final(outs[2] + more[2]))
    assert dev._inner.spec.n_keys > 1024
    assert len(dev._jcode_rev) < 3000


def test_deferred_and_coalesced():
    assert_equivalent(gen_batches(seed=13), planes=False,
                      match_drain_depth=4, coalesce_rows=2048,
                      defer_change_decode=True, change_drain_depth=3,
                      async_change_drain=True)


def test_columnar_input():
    assert_equivalent(gen_batches(seed=17), columnar=True)


def test_columnar_null_keys_dropped():
    execs = trio()
    for ex in execs:
        ex.process([{"k": "a", "x": 1.0}], [BASE], stream="r")
        ex.process([{"k": "a", "x": 2.0}], [BASE + 10], stream="l")
    kk = np.asarray(["a", "a", "a"], object)
    xx = np.asarray([5.0, 7.0, 9.0], np.float64)
    nm = np.asarray([False, True, False])
    outs = []
    for ex in execs[1:]:
        out = list(ex.process_columnar(
            np.asarray([BASE + 20] * 3, np.int64), {"k": kk, "x": xx},
            {"k": nm}, stream="l"))
        outs.append(out + list(ex.flush_changes()))
    rows = [{"k": "a", "x": 5.0}, {"x": 7.0}, {"k": "a", "x": 9.0}]
    host = list(execs[0].process(rows, [BASE + 20] * 3, stream="l"))
    host += execs[0].flush_changes()
    assert_final_equal(final(host), final(outs[0]))
    assert_final_equal(final(host), final(outs[1]))
    assert_stores_equal(execs[1], execs[2])


# ---- contracts --------------------------------------------------------------

def test_one_probe_call_per_batch_and_no_fetch():
    _, jdev, dev = assert_equivalent(gen_batches(seed=19, n_batches=16),
                                     planes=False, match_drain_depth=8)
    js = dev.join_stats
    assert js["probe_batches"] > 4
    assert js["probe_dispatches"] == js["probe_batches"]
    assert js["match_redispatches"] == 0
    assert js["fused_batches"] == js["probe_batches"]
    assert js["probe_fetches"] == 0


def test_fetch_path_stacks_buffers():
    batches = gen_batches(seed=43, n_batches=16)
    host, jdev, dev = trio(match_drain_depth=8)
    outs = run_all((host, jdev, dev), batches[:3], planes=False)
    for ex in (jdev, dev):
        assert ex._dev is not None
        ex._dev["feed"] = None  # force the match-fetch path
    more = run_all((host, jdev, dev), batches[3:], planes=False)
    js = dev.join_stats
    assert js["probe_dispatches"] == js["probe_batches"]
    assert 0 < js["probe_fetches"] < js["probe_batches"]
    assert js == jdev.join_stats
    assert_final_equal(final(outs[0] + more[0]), final(outs[2] + more[2]))
    assert_stores_equal(jdev, dev)


def _hot(n_batches=5, n=120):
    out = []
    for b in range(n_batches):
        rows = [{"k": "hot", "x": 1.0} for _ in range(n)]
        ts = [BASE + b * 200 + i for i in range(n)]
        out.append((rows, ts, "l" if b % 2 else "r"))
    return out


def test_match_width_self_sizing():
    host, jdev, dev = trio()
    for ex in (jdev, dev):
        ex.DEVICE_STORE_CAPACITY = 1 << 10
    batches = _hot()
    outs = run_all((host, jdev, dev), batches[:3])
    for ex in (jdev, dev):
        ex._dev["match_cap"] = 64  # the shadow must grow it back, exactly
    more = run_all((host, jdev, dev), batches[3:])
    assert dev.join_stats["match_redispatches"] == 0
    assert dev._dev["match_cap"] >= 120
    assert_final_equal(final(outs[0] + more[0]), final(outs[2] + more[2]))


def test_probe_reports_overflow_and_probe_only_recovers():
    cap, bcap = 64, 16
    store = jl.init_join_store(cap, 0)
    empty = jl.init_join_store(cap, 0)
    batch = np.zeros((4, bcap), np.int32)
    batch[0, 10:] = jl.JOIN_SENT_CODE
    batch[1, :10] = np.arange(10)
    bt = torch.from_numpy(batch)
    store2, _ = jl.join_probe_insert(store, empty, bt, 10, 5, -1000, 8, 0)
    _, pk = jl.join_probe_insert(empty, store2, bt, 10, 100, -1000, 8, 0)
    total = int(pk[0, 0])
    assert total == 100 and total > 8
    pk2 = jl.join_probe_only(store2, bt, 10, 100, -1000, 128, 0)
    t2, kid, *_ = jl.unpack_join_matches(pk2.numpy(), 0)
    assert t2 == 100 and len(kid) == 100


def test_store_grow():
    batches = gen_batches(seed=23, n_batches=10, n=512, stride=100)
    host, jdev, dev = trio()
    jdev.DEVICE_STORE_CAPACITY = dev.DEVICE_STORE_CAPACITY = 256
    outs = run_all((host, jdev, dev), batches)
    assert_final_equal(final(outs[0]), final(outs[2]))
    assert dev.join_stats["store_grows"] >= 1
    assert dev._dev["cap"] > 256


def test_epoch_rebase_boundary():
    batches = gen_batches(seed=29, n_batches=60, stride=400, jitter=600)
    host, jdev, dev = trio()
    jdev.REBASE_REL_MS = dev.REBASE_REL_MS = 1 << 14
    outs = run_all((host, jdev, dev), batches, planes=False)
    assert_final_equal(final(outs[0]), final(outs[2]))
    assert dev.join_stats["rebase_dispatches"] >= 1
    assert dev._dev["t0"] > int(batches[0][1][0]) - dev.retention_ms
    assert_stores_equal(jdev, dev)


def test_rebase_down_for_late_batch():
    host, jdev, dev = trio()
    outs = run_all((host, jdev, dev), gen_batches(seed=31, n_batches=4))
    t0_before = dev._dev["t0"]
    late = ([{"k": "k1", "x": 4.0}], [t0_before - 5000], "l")
    more = run_all((host, jdev, dev), [late])
    assert dev._dev["t0"] < t0_before
    assert_final_equal(final(outs[0] + more[0]), final(outs[2] + more[2]))


# ---- the changelog decode (test_join_device.py's columnar decode cases) -----

def _changelog_executors():
    from hstream_tpu.engine import QueryExecutor as JQ
    from hstream_tpu_torch.engine import QueryExecutor as TQ
    from torch_parity import JM, TM

    out = []
    for m, Q, extra in ((JM, JQ, {}), (TM, TQ, {"device": "cpu"})):
        schema = m.Schema.of(device=m.ColumnType.STRING,
                             temp=m.ColumnType.FLOAT)
        A, S = m.AggKind, m.AggSpec
        node = m.AggregateNode(
            child=m.SourceNode("s", schema), group_keys=[m.Col("device")],
            window=m.TumblingWindow(10_000, grace_ms=0),
            aggs=[S(A.COUNT_ALL, "c"), S(A.SUM, "s", input=m.Col("temp")),
                  S(A.TOPK, "t2", input=m.Col("temp"), k=2)],
            having=m.BinOp(">", m.Col("c"), m.Lit(1)),
            post_projections=[("device", m.Col("device")),
                              ("c", m.Col("c")),
                              ("s2", m.BinOp("*", m.Col("s"), m.Lit(2)))])
        ex = Q(node, schema, emit_changes=True, initial_keys=256,
               batch_capacity=4096, **extra)
        ex.defer_change_decode = True
        for k in range(100):
            ex.key_id_for((f"d{k}",))
        out.append(ex)
    return out


def test_columnar_changelog_decode_matches_the_perrow_reference():
    jex, tex = _changelog_executors()
    rng = np.random.default_rng(2)
    kids = rng.integers(0, 100, 2048).astype(np.int32)
    temps = rng.normal(20, 5, 2048).astype(np.float32)
    ts = BASE + np.arange(2048, dtype=np.int64) % 500
    tex.process_columnar(kids, ts, {"temp": temps})
    epoch, buf = tex._pending_changes[0]
    pk = buf.numpy()
    cols = list(tex._decode_changes(pk, epoch))
    rows = jex._decode_changes_rows(pk, epoch)  # the reference's per-row
    assert len(cols) == len(rows) > 0
    for ra, rb in zip(cols, rows):
        assert set(ra) == set(rb)
        for k in rb:
            if isinstance(rb[k], (float, list)):
                assert ra[k] == pytest.approx(rb[k])
            else:
                assert ra[k] == rb[k]
    assert list(tex._decode_changes(np.zeros((7, 64), np.int32),
                                    BASE)) == []


def test_changelog_drain_stays_columnar():
    from hstream_tpu_torch.common.columnar import ColumnarEmit

    _, tex = _changelog_executors()
    tex.defer_change_decode = False
    rng = np.random.default_rng(4)
    kids = rng.integers(0, 100, 1024).astype(np.int32)
    temps = rng.normal(20, 5, 1024).astype(np.float32)
    ts = BASE + np.arange(1024, dtype=np.int64) % 500
    out = tex.process_columnar(kids, ts, {"temp": temps})
    assert isinstance(out, ColumnarEmit) and len(out) > 0


def test_join_projection_stays_columnar():
    sql = ("SELECT TO_UPPER(l.k) AS kk, COUNT(*) AS c "
           "FROM l INNER JOIN r WITHIN (INTERVAL 1 SECOND) "
           "ON l.k = r.k GROUP BY l.k, TUMBLING (INTERVAL 10 SECOND) "
           "GRACE BY INTERVAL 0 SECOND EMIT CHANGES;")
    outs = []
    for port in (False, True):
        ex = make(sql, port=port)
        ex.process([{"k": "a"}, {"k": "b"}], [BASE, BASE + 1], stream="r")
        out = ex.process([{"k": "a"}, {"k": "b"}], [BASE + 10, BASE + 11],
                         stream="l")
        outs.append(sorted((r["kk"], r["c"]) for r in
                           list(out) + list(ex.flush_changes())))
    assert outs[0] == outs[1] and ("A", 1) in outs[1]


# ---- tests/test_join.py -----------------------------------------------------

def _pair(sql, sample):
    return make(sql, port=False, sample=sample), \
        make(sql, port=True, sample=sample)


def _both(execs, rows, ts, stream):
    outs = [list(ex.process(rows, ts, stream=stream)) for ex in execs]
    assert outs[0] == outs[1]
    return outs[1]


STATELESS = ("SELECT s1.x, s2.y FROM s1 INNER JOIN s2 "
             "WITHIN (INTERVAL 10 SECOND) ON s1.k = s2.k EMIT CHANGES;")


def test_stateless_pairs():
    execs = _pair(STATELESS, [{"k": "a", "x": 1.0}])
    assert _both(execs, [{"k": "a", "x": 1.0}], [BASE], "s1") == []
    out = _both(execs, [{"k": "a", "y": 2.0}], [BASE + 1000], "s2")
    assert len(out) == 1
    assert out[0]["s1.x"] == 1.0 and out[0]["s2.y"] == 2.0
    assert _both(execs, [{"k": "a", "y": 9.0}], [BASE + 60_000], "s2") == []
    assert _both(execs, [{"k": "b", "x": 5.0}], [BASE + 61_000], "s1") == []


def test_symmetric_and_multiple_matches():
    execs = _pair(STATELESS, [{"k": "a", "x": 0.0}])
    _both(execs, [{"k": "a", "y": 1.0}, {"k": "a", "y": 2.0}],
          [BASE, BASE + 100], "s2")
    out = _both(execs, [{"k": "a", "x": 7.0}], [BASE + 200], "s1")
    assert sorted(r["s2.y"] for r in out) == [1.0, 2.0]


def test_groupby_other_key_runs_the_host_join():
    """GROUP BY a column that is not the join key: _plan_fast refuses, so
    both packages keep the host join (the port's device path never
    activates)."""
    sql = ("SELECT s2.loc, SUM(s1.x) AS total FROM s1 INNER JOIN s2 "
           "WITHIN (INTERVAL 10 SECOND) ON s1.k = s2.k "
           "GROUP BY s2.loc, TUMBLING (INTERVAL 10 SECOND) "
           "GRACE BY INTERVAL 0 SECOND EMIT CHANGES;")
    execs = _pair(sql, [{"k": "a", "x": 1.0}])
    out = []
    out += _both(execs, [{"k": "a", "loc": "sf"}, {"k": "b", "loc": "la"}],
                 [BASE, BASE + 10], "s2")
    out += _both(execs, [{"k": "a", "x": 1.5}, {"k": "a", "x": 2.5},
                         {"k": "b", "x": 10.0}],
                 [BASE + 100, BASE + 200, BASE + 300], "s1")
    out += _both(execs, [{"k": "a", "loc": "sf"}], [BASE + 40_000], "s2")
    out += _both(execs, [{"k": "a", "x": 0.5}], [BASE + 40_001], "s1")
    rows = {r["s2.loc"]: r for r in out if r.get("winStart") == BASE}
    assert rows["sf"]["total"] == pytest.approx(4.0)
    assert rows["la"]["total"] == pytest.approx(10.0)
    assert execs[1]._dev is None and execs[1]._fast is False


def test_timestamp_is_max_of_pair():
    sql = ("SELECT s1.k, COUNT(*) AS c FROM s1 INNER JOIN s2 "
           "WITHIN (INTERVAL 10 SECOND) ON s1.k = s2.k "
           "GROUP BY s1.k, TUMBLING (INTERVAL 10 SECOND) "
           "GRACE BY INTERVAL 0 SECOND EMIT CHANGES;")
    execs = _pair(sql, [{"k": "a", "x": 1.0}])
    out = _both(execs, [{"k": "a"}], [BASE + 2_000], "s1")
    out += _both(execs, [{"k": "a"}], [BASE + 12_000], "s2")
    assert all(r.get("winStart") != BASE for r in out)
    win2 = [r for r in out if r.get("winStart") == BASE + 10_000]
    assert len(win2) == 1 and win2[0]["c"] == 1


def test_rejects_a_one_sided_condition():
    """ON s1.k = s1.j relates one side only. The reference's validator
    refuses the SQL first; the port, which has no parser yet (A4), refuses
    the plan in split_on_condition."""
    from hstream_tpu_torch.engine.expr import BinOp, Col

    plan = plan_from(stream_codegen(STATELESS))
    bad = dataclasses.replace(plan, join=dataclasses.replace(
        plan.join, on=BinOp("=", Col("k", "s1"), Col("j", "s1"))))
    with pytest.raises(SQLCodegenError, match="both sides"):
        tmake(bad, sample_rows=[{"k": 1, "j": 1}], device="cpu")


def test_alias_qualifiers():
    sql = ("SELECT a.x, b.y FROM s1 AS a INNER JOIN s2 AS b "
           "WITHIN (INTERVAL 10 SECOND) ON a.k = b.k EMIT CHANGES;")
    execs = _pair(sql, [{"k": "a", "x": 1.0}])
    _both(execs, [{"k": "z", "x": 3.0}], [BASE], "s1")
    out = _both(execs, [{"k": "z", "y": 4.0}], [BASE + 50], "s2")
    assert len(out) == 1 and out[0]["a.x"] == 3.0 and out[0]["b.y"] == 4.0


def test_deferred_async_changes_match_sync():
    sql = ("SELECT l.k, COUNT(*) AS c, SUM(l.x) AS s FROM l INNER JOIN r "
           "WITHIN (INTERVAL 1 SECOND) ON l.k = r.k "
           "GROUP BY l.k, TUMBLING (INTERVAL 10 SECOND) "
           "GRACE BY INTERVAL 0 SECOND EMIT CHANGES;")
    rng = np.random.default_rng(11)
    batches = []
    for b in range(12):
        rows = [{"k": f"k{int(i)}", "x": 1.0}
                for i in rng.integers(0, 50, 256)]
        ts = [BASE + b * 500 + i % 500 for i in range(256)]
        batches.append((rows, ts, "l" if b % 2 else "r"))

    def run(tune: bool):
        ex = make(sql, port=True)
        if tune:
            ex.defer_change_decode = True
            ex.change_drain_depth = 3
            ex.async_change_drain = True
            ex.coalesce_rows = 1024
        out = []
        for rows, ts, side in batches:
            out.extend(ex.process(rows, ts, stream=side))
        out.extend(ex.flush_changes())
        assert not ex.has_pending_changes()
        if tune:
            assert ex._inner.defer_change_decode is True
            assert ex._inner.async_change_drain is True
        return out

    sync_rows = run(False)
    assert len(sync_rows) > 0
    assert final(sync_rows) == final(run(True))
    ref = make(sql, port=False)
    want = []
    for rows, ts, side in batches:
        want.extend(ref.process(rows, ts, stream=side))
    assert final(want) == final(sync_rows)


def test_flat_store_rejects_timestamp_span_overflow():
    from hstream_tpu_torch.engine.join import _FlatIntervalStore

    st = _FlatIntervalStore([("a",), ("b",)])
    st.insert_sorted(np.array([0], np.int64),
                     np.array([3_000_000_000_000], np.int64),
                     np.array([{"x": 1}], object))
    with pytest.raises(SQLCodegenError):
        st.insert_sorted(np.array([1], np.int64), np.array([0], np.int64),
                         np.array([{"x": 2}], object))


# ---- stream-table join (tests/test_topk_tablejoin.py:132, :160) -------------

def test_table_join_engine():
    sql = ("SELECT o.item, SUM(o.qty) AS q FROM orders AS o "
           "INNER JOIN TABLE(prices) AS p ON o.item = p.item "
           "GROUP BY o.item, TUMBLING (INTERVAL 10 SECOND) "
           "GRACE BY INTERVAL 0 SECOND EMIT CHANGES;")
    execs = _pair(sql, [{"item": "x", "qty": 1.0}])
    assert isinstance(execs[1], TableJoinExecutor)
    assert _both(execs, [{"item": "x", "qty": 1.0}], [BASE], "orders") == []
    assert _both(execs, [{"item": "x", "price": 10.0}], [BASE + 1],
                 "prices") == []
    out = _both(execs, [{"item": "x", "qty": 2.0}, {"item": "y", "qty": 9.0}],
                [BASE + 2, BASE + 3], "orders")
    out += _both(execs, [{"item": "x", "qty": 3.0}], [BASE + 4], "o")
    out += _both(execs, [{"item": "zz", "qty": 0.0}], [BASE + 30_000],
                 "orders")
    fin = {r["o.item"]: r["q"] for r in out if r.get("winStart") == BASE}
    assert fin == {"x": pytest.approx(5.0)}
    assert execs[1].table[("x",)][1]["price"] == 10.0


def test_table_join_last_value_wins():
    sql = ("SELECT s.k, MAX(s.v) AS m FROM s "
           "INNER JOIN TABLE(t) ON s.k = t.k GROUP BY s.k EMIT CHANGES;")
    execs = _pair(sql, [{"k": "a", "v": 1.0}])
    _both(execs, [{"k": "a", "tag": "old"}], [BASE], "t")
    _both(execs, [{"k": "a", "tag": "new"}], [BASE + 10], "t")
    _both(execs, [{"k": "a", "tag": "stale"}], [BASE + 5], "t")
    assert execs[1].table[("a",)][1]["tag"] == "new"
    assert execs[1].table == execs[0].table


# ---- the port's own rules ---------------------------------------------------

def test_join_without_a_device_needs_the_card(monkeypatch):
    plan = plan_from(stream_codegen(SQL))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        JoinExecutor(plan)
    with pytest.raises(DeviceUnavailable):
        tmake(plan, sample_rows=SAMPLE)


def test_failed_activation_raises_and_keeps_the_host_stores(monkeypatch):
    """Where the reference degrades a failed device activation to its
    host path (device_fallbacks), the port raises; the host stores stay
    intact and nothing moved to the device half-done."""
    ex = make(port=True)
    batches = gen_batches(n_batches=3)
    for rows, ts, side in batches[:2]:
        ex.process(rows, ts, stream=side)
    assert ex._dev is None and len(ex._stores["r"]) > 0

    def boom(*a, **k):
        raise RuntimeError("injected activation failure")

    monkeypatch.setattr(jl, "init_join_store", boom)
    with pytest.raises(RuntimeError, match="injected"):
        ex.process(*batches[2][:2], stream=batches[2][2])
    assert ex._dev is None and ex.device_fallbacks == 0
    assert len(ex._stores["l"]) + len(ex._stores["r"]) > 0


def test_failed_probe_raises(monkeypatch):
    ex = make(port=True)
    batches = gen_batches(n_batches=4)
    for rows, ts, side in batches[:3]:
        ex.process(rows, ts, stream=side)
    assert ex._dev is not None

    def boom(*a, **k):
        raise RuntimeError("injected launch failure")

    monkeypatch.setattr(jl, "join_probe_insert_step", boom)
    with pytest.raises(RuntimeError, match="injected"):
        ex.process(*batches[3][:2], stream=batches[3][2])
    assert ex._dev is not None and ex.use_device_join


def test_carry_a_jax_join_across_mid_stream():
    """convert.join_from: a JAX device-mode join's position (stores,
    shadows, codes, the inner lattice) carried into the port; both then
    continue over the same batches with equal changes and store planes."""
    plan = stream_codegen(SQL)
    batches = gen_batches(seed=3, n_batches=20, stride=700, jitter=900)
    jex = jmake(plan, sample_rows=SAMPLE)
    jex.DEVICE_STORE_CAPACITY = 1 << 9
    want = []
    for rows, ts, side in batches[:8]:
        want.extend(jex.process(rows, ts, stream=side))
    want.extend(jex.flush_changes())
    tex = convert.join_from(jex, plan_from(plan), device="cpu")
    got = list(want)
    for rows, ts, side in batches[8:]:
        want.extend(jex.process(rows, ts, stream=side))
        want.extend(jex.flush_changes())
        got.extend(tex.process(rows, ts, stream=side))
        got.extend(tex.flush_changes())
        assert_stores_equal(jex, tex)
    assert_final_equal(final(want), final(got))
    assert tex.join_stats["evict_dispatches"] > 0


def test_chip_smoke_plan_is_the_translated_config_5_query():
    """chip_smoke.py builds BASELINE config 5's plan by hand from the
    port's dataclasses (it may not import the JAX package); it equals the
    translation of the JAX package's codegen of bench.py's SQL."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_plan", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for sql, built in ((mod.JOIN_SQL, mod.join_plan()),
                       (mod.JOIN_FETCH_SQL, mod.join_fetch_plan())):
        assert built == plan_from(stream_codegen(sql))
    assert isinstance(JJoin, type)
