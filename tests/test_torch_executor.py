"""Parity of the port's QueryExecutor (on the CPU, plain versions) with
hstream_tpu's, through the entry points users call: process_columnar,
process (rows), stage_columnar/process_staged via IngestPipeline,
drain_closed and peek.

Both configurations of the slice — BASELINE 1/3 (TUMBLE(10s) COUNT(*),
SUM, APPROX_COUNT_DISTINCT) and BASELINE 2 (HOP(60s,10s) AVG/MIN/MAX) —
get the same batches, made from numpy seeds, in both engines; emitted
rows must agree: keys, window bounds, counts and HLL estimates exactly,
float aggregates within rel 1e-6 (the reference's own bound,
tests/test_close_batched.py). Also covered: multi-slot hopping closes,
the gap-guard split, a forced epoch rebase, the close counters, key
growth, and carrying a running query's state from the JAX executor into
the port mid-stream.
"""

from __future__ import annotations

import numpy as np
import pytest

import hstream_tpu.engine as J
from hstream_tpu.engine.expr import BinOp as JBinOp
from hstream_tpu.engine.expr import Col as JCol
from hstream_tpu.engine.expr import Lit as JLit
import hstream_tpu_torch.engine as T
from hstream_tpu_torch.engine import convert
from hstream_tpu_torch.engine.expr import BinOp, Col, Lit

BASE = 1_700_000_000_000
N_KEYS = 20


def _window(mod, cfg):
    if cfg == "tumble":
        return mod.TumblingWindow(10_000, grace_ms=0)
    if cfg == "hop":
        return mod.HoppingWindow(60_000, 10_000, grace_ms=0)
    if cfg == "hop5":
        return mod.HoppingWindow(20_000, 5_000, grace_ms=0)
    return None


def _aggs(mod, col, cfg):
    if cfg in ("tumble", "global"):
        return [mod.AggSpec(mod.AggKind.COUNT_ALL, "cnt"),
                mod.AggSpec(mod.AggKind.SUM, "total", input=col("temp")),
                mod.AggSpec(mod.AggKind.APPROX_COUNT_DISTINCT, "uniq",
                            input=col("temp"))]
    return [mod.AggSpec(mod.AggKind.AVG, "avg", input=col("temp")),
            mod.AggSpec(mod.AggKind.MIN, "lo", input=col("temp")),
            mod.AggSpec(mod.AggKind.MAX, "hi", input=col("temp"))]


def pair(cfg, *, initial_keys=32, having=None, post=None):
    """(JAX executor, port executor on the CPU) for one configuration."""
    out = []
    for mod, col, binop, lit, kw in (
            (J, JCol, JBinOp, JLit, {}),
            (T, Col, BinOp, Lit, {"device": "cpu"})):
        schema = mod.Schema.of(device=mod.ColumnType.STRING,
                               temp=mod.ColumnType.FLOAT)
        node = mod.AggregateNode(
            child=mod.SourceNode("s", schema), group_keys=[col("device")],
            window=_window(mod, cfg), aggs=_aggs(mod, col, cfg),
            having=having(col, binop, lit) if having else None,
            post_projections=post(col, binop, lit) if post else [])
        ex = mod.QueryExecutor(node, schema, emit_changes=False,
                               initial_keys=initial_keys,
                               batch_capacity=512, **kw)
        out.append(ex)
    return out


def gen(seed, n_batches=24, n=300, span=5_000, t0=BASE):
    """Columnar batches: key ids, sorted absolute ms, one-decimal temps."""
    rng = np.random.default_rng(seed)
    for b in range(n_batches):
        kids = rng.integers(0, N_KEYS, n).astype(np.int32)
        ts = t0 + b * span + np.sort(rng.integers(0, span, n))
        temps = (np.rint(rng.normal(20, 5, n) * 10).astype(np.float32)
                 * np.float32(0.1))
        yield kids, ts.astype(np.int64), {"temp": temps}


def register_keys(*exs):
    for ex in exs:
        for k in range(N_KEYS):
            ex.key_id_for((f"d{k}",))


def assert_rows_equal(jrows, trows, min_rows=1):
    jrows, trows = list(jrows), list(trows)
    assert len(jrows) == len(trows) >= min_rows
    kj = {(r["device"], r.get("winStart")): r for r in jrows}
    kt = {(r["device"], r.get("winStart")): r for r in trows}
    assert kj.keys() == kt.keys()
    for key, want in kj.items():
        got = kt[key]
        assert got.keys() == want.keys(), key
        for name, v in want.items():
            if isinstance(v, float):
                assert got[name] == pytest.approx(v, rel=1e-6), (key, name)
            else:
                assert got[name] == v, (key, name)


def feed(ex, batches):
    rows = []
    for kids, ts, cols in batches:
        rows.extend(ex.process_columnar(kids, ts, cols))
    return rows


@pytest.mark.parametrize("cfg", ["tumble", "hop"])
def test_columnar_path_emits_the_same_rows(cfg):
    ej, et = pair(cfg)
    register_keys(ej, et)
    batches = list(gen(1))
    assert_rows_equal(feed(ej, batches), feed(et, batches), min_rows=100)
    assert et.close_stats == ej.close_stats
    assert et.close_stats["close_cycles"] == \
        et.close_stats["close_dispatches"] == et.close_stats["close_fetches"]
    assert et.watermark_abs == ej.watermark_abs and et.epoch == ej.epoch
    assert sorted(et._open) == sorted(ej._open)
    assert et.late_drops == ej.late_drops


def test_row_path_with_having_and_projection():
    def having(col, binop, lit):
        return binop(">", col("cnt"), lit(3))

    def post(col, binop, lit):
        return [("device", col("device")), ("cnt", col("cnt")),
                ("twice", binop("*", col("total"), lit(2.0))),
                ("uniq", col("uniq"))]

    ej, et = pair("tumble", having=having, post=post)
    rng = np.random.default_rng(4)
    out_j, out_t = [], []
    for b in range(12):
        n = 150
        rows = [{"device": f"d{int(k)}", "temp": float(t)}
                for k, t in zip(rng.integers(0, 9, n),
                                np.rint(rng.normal(20, 5, n) * 10) / 10)]
        ts = [BASE + b * 4_000 + int(t)
              for t in np.sort(rng.integers(0, 4_000, n))]
        out_j.extend(ej.process(rows, ts))
        out_t.extend(et.process(rows, ts))
    assert_rows_equal(out_j, out_t, min_rows=10)
    assert all(r["cnt"] > 3 for r in out_t)


def test_hopping_multi_slot_close_in_one_cycle():
    ej, et = pair("hop5")
    register_keys(ej, et)
    batches = list(gen(2, n_batches=10, span=3_000))
    rows_j, rows_t = feed(ej, batches), feed(et, batches)
    # a watermark jump closes several open windows per cycle
    before = dict(et.close_stats)
    closer = (np.array([0], np.int32), np.array([BASE + 200_000], np.int64),
              {"temp": np.array([1.0], np.float32)})
    rows_j.extend(ej.process_columnar(*closer))
    last = et.process_columnar(*closer)
    rows_t.extend(last)
    assert_rows_equal(rows_j, rows_t, min_rows=50)
    assert et.close_stats == ej.close_stats
    # the jump also aliases slots, so the gap guard splits it: still
    # fewer cycles than windows, each ONE launch and ONE fetch
    delta = {k: et.close_stats[k] - before[k] for k in before}
    assert len({r["winStart"] for r in last}) > delta["close_cycles"]
    assert delta["close_dispatches"] == delta["close_fetches"] == \
        delta["close_cycles"]


def test_gap_guard_split_matches():
    """A batch whose records span more than W * advance aliases lattice
    slots; both engines split it in time order at the same place."""
    ej, et = pair("tumble")
    register_keys(ej, et)
    batches = list(gen(3, n_batches=6, span=3_000))
    rng = np.random.default_rng(5)
    n = 200
    ts = np.sort(np.concatenate([
        BASE + 18_500 + rng.integers(0, 1_000, n // 2),
        BASE + 18_500 + 30_000 + rng.integers(0, 1_000, n // 2)]))
    batches.append((rng.integers(0, N_KEYS, n).astype(np.int32),
                    ts.astype(np.int64),
                    {"temp": np.full(n, np.float32(2.5))}))
    batches.extend(gen(6, n_batches=3, span=3_000, t0=BASE + 70_000))
    calls = []
    inner = et._process_columnar
    et._process_columnar = lambda *a: calls.append(1) or inner(*a)
    assert_rows_equal(feed(ej, batches), feed(et, batches), min_rows=20)
    assert len(calls) > len(batches)  # the aliasing batch was split
    assert et.close_stats == ej.close_stats


@pytest.mark.parametrize("cfg", ["tumble", "hop"])
def test_forced_rebase_matches(cfg):
    ej, et = pair(cfg)
    register_keys(ej, et)
    for ex in (ej, et):
        ex.rebase_threshold = 40_000
    batches = list(gen(7, n_batches=30))
    rows_j, rows_t = feed(ej, batches), feed(et, batches)
    first = next(gen(7))[1].min()
    assert et.epoch > first - 200_000 + 40_000  # it moved at least once
    assert et.epoch == ej.epoch
    assert_rows_equal(rows_j, rows_t, min_rows=50)


def test_deferred_closes_drain_in_one_fetch():
    ej, et = pair("tumble")
    register_keys(ej, et)
    for ex in (ej, et):
        ex.defer_close_decode = True
    batches = list(gen(8, n_batches=14))
    assert feed(et, batches) == [] and feed(ej, batches) == []
    assert et.close_stats["close_cycles"] >= 3
    assert et.close_stats["close_fetches"] == 0
    assert_rows_equal(ej.drain_closed(), et.drain_closed(), min_rows=40)
    assert et.close_stats == ej.close_stats
    assert et.close_stats["close_fetches"] == 1
    assert et.drain_closed() == []


@pytest.mark.parametrize("workers", [1, 2])
def test_pipeline_matches_direct(workers):
    ej, et = pair("hop")
    register_keys(ej, et)
    batches = list(gen(9, n_batches=20))
    rows_j = feed(ej, batches)
    pipe = T.IngestPipeline(et, depth=3, workers=workers)
    try:
        rows_t = []
        for kids, ts, cols in batches:
            rows_t.extend(pipe.submit(kids, ts, cols))
        rows_t.extend(pipe.flush())
    finally:
        pipe.close()
    assert_rows_equal(rows_j, rows_t, min_rows=50)
    assert et.close_stats == ej.close_stats


def test_key_growth_matches():
    ej, et = pair("tumble", initial_keys=8)
    register_keys(ej, et)
    assert et.spec.n_keys == ej.spec.n_keys == 32
    batches = list(gen(10, n_batches=8))
    assert_rows_equal(feed(ej, batches), feed(et, batches), min_rows=20)


@pytest.mark.parametrize("cfg", ["tumble", "hop"])
def test_plane_bytes_and_live_window_end_match(cfg):
    ej, et = pair(cfg)
    register_keys(ej, et)
    batches = list(gen(13, n_batches=4))
    feed(ej, batches)
    feed(et, batches)
    et.block_until_ready()  # nothing to wait for on the CPU
    assert et.device_plane_bytes() == ej.device_plane_bytes()
    assert et.live_min_win_end() == ej.live_min_win_end() is not None


@pytest.mark.parametrize("cfg", ["tumble", "hop", "global"])
def test_peek_matches(cfg):
    ej, et = pair(cfg)
    register_keys(ej, et)
    batches = list(gen(11, n_batches=5))
    feed(ej, batches)
    feed(et, batches)
    v0 = et.read_version()
    assert_rows_equal(ej.peek(), et.peek(), min_rows=N_KEYS)
    assert et.read_version() == v0  # a peek changes nothing


@pytest.mark.parametrize("cfg", ["tumble", "hop"])
def test_state_carried_over_mid_stream(cfg):
    """A JAX executor runs part of a stream; its position (state planes,
    epoch, watermark, open windows, key dictionary) moves into a fresh
    port executor; both then take the same next batches and emit the
    same rows."""
    ej, et = pair(cfg)
    register_keys(ej)
    batches = list(gen(12, n_batches=26))
    feed(ej, batches[:13])
    convert.adopt(et, {k: np.asarray(v) for k, v in ej.state.items()},
                  epoch=ej.epoch, watermark_abs=ej.watermark_abs,
                  open_windows={s: w.slot for s, w in ej._open.items()},
                  keys=ej._key_rev)
    assert_rows_equal(feed(ej, batches[13:]), feed(et, batches[13:]),
                      min_rows=50)
