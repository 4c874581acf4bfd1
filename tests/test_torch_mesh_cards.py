"""The port's sharded window lattice, key-sharded session arena and
key-sharded join stores on a mesh that spans two CUDA cards, against the
same mesh wrapped onto one card. The session and join cases are set out
in their own section below; this part is about the window lattice.

Where a key shard's partials lie on other cards than its data shard 0's
partial, the merged kernels read copies made on a side stream of that
card and copy the reset partials back (parallel/lattice.py `_gather`,
`_put_back`); with two launch groups each group writes a buffer of its
own, and the merged changelog extract shifts its key ids. Every launch
runs with its shard's card current. One card cannot take this branch, so
these tests need two cards and skip elsewhere. Two layouts of a (2, 2)
mesh over cards 0 and 1 cover it:

  * "key split": key shard 0 on card 0 and key shard 1 on card 1, each
    key shard's data-1 partial on the other card (two launch groups,
    both data-1 partials copied);
  * "data split": data shard 0 on card 0, data shard 1 on card 1 (one
    launch group, both data-1 partials copied).

Closed rows, changelog rows, peeks, a per-slot close, key growth, the
rebase and snapshots must equal the one-card mesh's: keys, window
bounds, counts, MIN/MAX, HLL registers and estimates and every integer
plane exactly; float32 SUM and AVG within twice the float32
summation-order bound n 2^-24 sum|x| of each run, since the scatter's
atomics add a cell's terms in an order that changes from run to run
(csrc/scatter.cu). The file imports no JAX, so it runs where the port
does:

    python -m pytest -p no:cacheprovider --noconftest \
        tests/test_torch_mesh_cards.py
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import hstream_tpu_torch.engine as T
from hstream_tpu_torch.engine import join_lattice as jl
from hstream_tpu_torch.engine import snapshot as tsnap
from hstream_tpu_torch.engine.expr import Col
from hstream_tpu_torch.engine.kernels.binding import (
    CLOSE_EXTRACT,
    CLOSE_RESET,
)
from hstream_tpu_torch.parallel import ShardedQueryExecutor, make_mesh
from hstream_tpu_torch.parallel import lattice as pl

BASE = 1_700_000_000_000
U = 2.0 ** -24                  # float32 unit roundoff
# card of shard (0, 0), (0, 1), (1, 0), (1, 1)
LAYOUTS = {"key split": (0, 1, 1, 0), "data split": (0, 0, 1, 1)}


def _schema():
    return T.Schema.of(device=T.ColumnType.STRING, temp=T.ColumnType.FLOAT)


def _node():
    temp = Col("temp")
    aggs = [T.AggSpec(T.AggKind.COUNT_ALL, "cnt"),
            T.AggSpec(T.AggKind.SUM, "total", input=temp),
            T.AggSpec(T.AggKind.MIN, "mn", input=temp),
            T.AggSpec(T.AggKind.MAX, "mx", input=temp),
            T.AggSpec(T.AggKind.AVG, "avg", input=temp),
            T.AggSpec(T.AggKind.APPROX_COUNT_DISTINCT, "u", input=temp)]
    return T.AggregateNode(
        child=T.SourceNode("s", _schema()), group_keys=[Col("device")],
        window=T.TumblingWindow(10_000, grace_ms=0), aggs=aggs)


def _batches(n_batches=13, per=3000, n_keys=200, seed=5):
    """Batches over 200 keys (the executors start at 64 and grow twice),
    5 s of stream each, so windows close every other batch."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        rows = [{"device": f"d{int(k)}", "temp": float(np.float32(t))}
                for k, t in zip(rng.integers(0, n_keys, per),
                                rng.normal(20, 5, per))]
        ts = [BASE + b * 5000 + int(t)
              for t in np.sort(rng.integers(0, 5000, per))]
        out.append((rows, ts))
    return out


def _sum_bound(n, lo, hi):
    """How far two runs' float32 sums of the same n terms in [lo, hi] may
    lie apart: twice the order bound n U sum|x|, sum|x| <= n max|x|."""
    big = np.maximum(np.abs(lo), np.abs(hi))
    return 4.0 * n * n * U * np.where(n > 0, big, 0.0)


def assert_rows_match(got, want):
    """Rows (closed windows, changes or peeks) of the two meshes, matched
    by (window, key): SUM and AVG within the order bound, the rest
    exact."""
    def by_key(rows):
        out = {(r["winStart"], r["device"]): r for r in rows}
        assert len(out) == len(rows)
        return out

    got, want = by_key(got), by_key(want)
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert set(g) == set(w), key
        lim = float(_sum_bound(w["cnt"], w["mn"], w["mx"]))
        for name, wv in w.items():
            if name == "total":
                assert abs(g[name] - wv) <= lim, (key, name, g[name], wv)
            elif name == "avg":
                assert abs(g[name] - wv) <= lim / w["cnt"] \
                    + 2 * U * abs(wv), (key, name, g[name], wv)
            else:
                assert g[name] == wv, (key, name, g[name], wv)
    return len(want)


def assert_planes_match(got, want):
    """Snapshot arrays of the two meshes: the SUM and AVG planes within
    the order bound of their cells, every other plane exact."""
    assert set(got) == set(want)
    n = want["s/count"]
    lo, hi = want["s/a2_min"], want["s/a3_max"]
    for name, w in want.items():
        if name in ("s/a1_sum", "s/a4_avg"):
            assert (np.abs(got[name] - w) <= _sum_bound(n, lo, hi)).all(), \
                name
        else:
            assert np.array_equal(got[name], w), name


@pytest.mark.cuda
@pytest.mark.parametrize("emit_changes", [False, True])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_a_mesh_across_two_cards_matches_one_card(layout, emit_changes):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: the copies between cards")
    cards = [torch.device("cuda", i) for i in LAYOUTS[layout]]
    check_against_one_card(make_mesh(2, 2, devices=cards),
                           make_mesh(2, 2, devices=[cards[0]]), cards,
                           emit_changes)


def check_against_one_card(across, one, cards, emit_changes):
    """Drive a ShardedQueryExecutor on each mesh with the same batches and
    hold everything the mesh across cards gives against the other's."""
    kw = dict(emit_changes=emit_changes, initial_keys=64,
              batch_capacity=4096)
    execs = [ShardedQueryExecutor(_node(), _schema(), mesh=m, **kw)
             for m in (across, one)]
    launches = (pl.close_merged.launches, pl.touched_merged.launches,
                pl.close_slot_merged.launches, pl.merge_partials.launches)
    *batches, last = _batches()
    n_rows = 0
    for i, (rows, ts) in enumerate(batches):
        n_rows += assert_rows_match(*(ex.process(rows, ts) for ex in execs))
        if i % 4 == 3:
            assert_rows_match(*(ex.peek() for ex in execs))
    assert n_rows > 0
    assert execs[0].spec.n_keys == 256            # grew twice
    for d in range(2):
        for k in range(2):
            assert execs[0].state[d][k]["count"].device == cards[2 * d + k]
    # the rebase kernel on every card (delta 0 leaves slot_start alone)
    before = [p["slot_start"].clone() for row in execs[0].state
              for p in row]
    execs[0]._rebase_planes(0)
    after = [p["slot_start"] for row in execs[0].state for p in row]
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    # the per-slot close of an open window's slot, then its reset
    start, ow = next(iter(execs[0]._open.items()))
    spec = execs[0]._sharded.local_spec
    extracted = [pl.close_slot_merged(spec, ex.state, ow.slot,
                                      CLOSE_EXTRACT) for ex in execs]
    assert extracted[0].device == cards[0]
    assert assert_rows_match(*(
        ex._decode_extract_batch(out.cpu().numpy()[None], [start])
        for ex, out in zip(execs, extracted))) > 0
    for ex in execs:
        pl.close_slot_merged(spec, ex.state, ow.slot, CLOSE_RESET)
    assert_rows_match(*(ex.peek() for ex in execs))
    assert_rows_match(*(ex.process(*last) for ex in execs))
    # a snapshot across cards equals the one-card mesh's, and restores
    # onto one card and onto the mesh across cards
    blobs = [tsnap.snapshot_executor(ex) for ex in execs]
    assert_planes_match(*(tsnap._unpack(b)[1] for b in blobs))
    plan = SimpleNamespace(node=_node())
    restored = [tsnap.restore_executor(plan, blobs[0], device=cards[0])[0],
                tsnap.restore_executor(plan, blobs[0], mesh=across)[0]]
    assert type(restored[1]) is ShardedQueryExecutor
    closer = ([{"device": "d0", "temp": 1.0}], [BASE + 200_000])
    want = execs[1].process(*closer)
    assert want
    for ex in restored:
        assert_rows_match(ex.process(*closer), want)
    after = (pl.close_merged.launches, pl.touched_merged.launches,
             pl.close_slot_merged.launches, pl.merge_partials.launches)
    if cards[0].type == "cpu":       # the plain versions: no launch
        assert after == launches
        return
    assert after[0] > launches[0] and after[2] > launches[2] \
        and after[3] > launches[3]
    if emit_changes:
        assert after[1] > launches[1]


# ---- the key-sharded session arena and join stores across two cards ------
#
# A key shard's session arena or join stores live on the card of its
# data-0 shard (parallel/lattice.py key_shard_devices). Where those cards
# differ, every batch, segment and slot list is copied to each shard's
# card, a shard off shard 0's card writes its extract rows, match buffer
# columns, match feed segment and live counts on its own card and they
# are copied in, and in the join's fused step the routed feed is copied
# to each inner partial's card. "(1, 2)" and "(2, 2) key split" put the
# two key shards on cards 0 and 1; "(2, 2) data split" keeps both on
# card 0 with every data-1 partial of the join's inner aggregate on card
# 1. Values are integers, so every SUM is exact in any order and the
# rows, stores and snapshots must equal the one-card mesh's exactly.

KEY_SPLIT = {"(1, 2)": ((1, 2), (0, 1)),
             "(2, 2) key split": ((2, 2), (0, 1, 1, 0))}
JOIN_LAYOUTS = dict(KEY_SPLIT, **{"(2, 2) data split": ((2, 2), (0, 0, 1, 1))})
SESSION_NAMES = ("c", "sv", "mn", "mx")
JOIN_SQL = {
    # one tumble covers the join's span, so every batch fuses
    "fused": ("SELECT l.k, COUNT(*) AS c, SUM(l.x) AS s FROM l INNER JOIN "
              "r WITHIN (INTERVAL 10 SECOND) ON l.k = r.k GROUP BY l.k, "
              "TUMBLING (INTERVAL 10 SECOND) GRACE BY INTERVAL 0 SECOND "
              "EMIT CHANGES;"),
    # WITHIN 10 s over TUMBLE(1 s) spans more windows than the inner
    # lattice's slots: every batch takes the match-fetch path
    "fetch": ("SELECT l.k, COUNT(*) AS c, SUM(l.x) AS s FROM l INNER JOIN "
              "r WITHIN (INTERVAL 10 SECOND) ON l.k = r.k GROUP BY l.k, "
              "TUMBLING (INTERVAL 1 SECOND) GRACE BY INTERVAL 4 SECOND "
              "EMIT CHANGES;"),
}


def _two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: the copies between cards")


def _meshes(layouts, name):
    """(the mesh across cards 0 and 1, the same mesh on card 0)."""
    (n_data, n_key), order = layouts[name]
    cards = [torch.device("cuda", i) for i in order]
    return (make_mesh(n_data, n_key, devices=cards),
            make_mesh(n_data, n_key, devices=[cards[0]]))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["record", "segment"])
@pytest.mark.parametrize("layout", sorted(KEY_SPLIT))
def test_sessions_across_two_cards_match_one_card(layout, mode):
    _two_cards()
    check_sessions_against_one_card(*_meshes(KEY_SPLIT, layout), mode)


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(JOIN_SQL))
@pytest.mark.parametrize("layout", sorted(JOIN_LAYOUTS))
def test_joins_across_two_cards_match_one_card(layout, path):
    _two_cards()
    check_joins_against_one_card(*_meshes(JOIN_LAYOUTS, layout), path)


def _session_node():
    schema = T.Schema.of(k=T.ColumnType.STRING, v=T.ColumnType.FLOAT)
    v = Col("v")
    aggs = [T.AggSpec(T.AggKind.COUNT_ALL, "c"),
            T.AggSpec(T.AggKind.SUM, "sv", input=v),
            T.AggSpec(T.AggKind.MIN, "mn", input=v),
            T.AggSpec(T.AggKind.MAX, "mx", input=v)]
    node = T.AggregateNode(
        child=T.SourceNode("s", schema), group_keys=[Col("k")],
        window=T.SessionWindow(800, grace_ms=400), aggs=aggs)
    return node, schema


def _session_batches(n_batches=14, per=250, seed=11):
    """A rotating key population (the executor's code compaction runs
    mid-run) with a late tail, integer values."""
    rng = np.random.default_rng(seed)
    out, t = [], BASE
    for b in range(n_batches):
        ks = rng.integers(b * 37, b * 37 + 90, per)
        ts = t + rng.integers(0, 3000, per)
        late = rng.random(per) < 0.1
        ts = np.where(late, ts - rng.integers(3000, 15_000, per), ts)
        rows = [{"k": f"u{int(k)}", "v": float(v)}
                for k, v in zip(ks, rng.integers(0, 1000, per))]
        out.append((rows, ts.tolist()))
        t += 2000
    return out


def _session_rows(out):
    rows = [] if out is None else (out if isinstance(out, list)
                                   else out.rows())
    return sorted((r["k"], int(r["winStart"]), int(r["winEnd"]))
                  + tuple(float(r[n]) for n in SESSION_NAMES) for r in rows)


def check_sessions_against_one_card(across, one, mode):
    """Drive a key-sharded SessionExecutor on each mesh with the same
    batches (a code compaction included) and hold closed rows, peeks and
    a snapshot's restores onto one card and onto the mesh across cards
    against the one-card mesh's."""
    from hstream_tpu_torch.engine import SessionExecutor
    counters = (pl.sharded_session_step if mode == "record"
                else pl.sharded_session_merge,
                pl.sharded_session_extract, pl.sharded_session_remap)
    before = [c.launches for c in counters]
    node, schema = _session_node()
    execs = []
    for m in (across, one):
        ex = SessionExecutor(node, schema, device=m.devices[0, 0], mesh=m)
        ex.device_session_mode = mode
        ex._KEY_CACHE_MAX = 128              # code compaction mid-run
        execs.append(ex)
    data = _session_batches()
    cut = 11
    n_rows = 0
    for i in range(cut):
        got, want = (_session_rows(ex.process(*data[i])) for ex in execs)
        assert got == want, i
        n_rows += len(want)
        if i % 4 == 3:
            assert _session_rows(execs[0].peek()) == \
                _session_rows(execs[1].peek())
    assert n_rows > 0
    ex = execs[0]
    assert ex.device_fallbacks == 0 and ex._dev["ssl"] is not None, \
        ex._device_refusal
    assert ex.session_stats["remap_dispatches"] > 0, "no remap ran"
    for s, arena in enumerate(ex._dev["arena"]):
        assert arena["code"].device == across.devices[0, s]
    # a snapshot across cards restores onto one card and onto the mesh
    # across cards; both continue as the one-card mesh does
    blob = tsnap.snapshot_executor(ex)
    plan = SimpleNamespace(node=node)
    restored = [tsnap.restore_executor(plan, blob,
                                       device=across.devices[0, 0])[0],
                tsnap.restore_executor(plan, blob, mesh=across,
                                       device=across.devices[0, 0])[0]]
    for r in restored:
        r.device_session_mode = mode
    for i in range(cut, len(data)):
        want = _session_rows(execs[1].process(*data[i]))
        for r in restored:
            assert _session_rows(r.process(*data[i])) == want, i
    want = _session_rows(execs[1].peek())
    assert want
    for r in restored:
        assert _session_rows(r.peek()) == want
    assert restored[1]._dev["ssl"] is not None
    if across.devices[0, 0].type != "cpu":
        assert all(c.launches > b for c, b in zip(counters, before)), \
            [(c.__name__, b, c.launches) for c, b in zip(counters, before)]


def _join_batches(n_batches=18, per=400, seed=3):
    """Alternating sides over a rotating key population (code churn), a
    span past retention (eviction), out of order within each batch,
    integer x."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        lo = b * 23
        rows = [{"k": f"k{int(i)}", "x": float(v)}
                for i, v in zip(rng.integers(lo, lo + 120, per),
                                rng.integers(-3, 6, per))]
        ts = BASE + b * 900 + rng.integers(0, 1400, per).astype(np.int64)
        out.append((rows, ts.tolist(), "l" if b % 2 else "r"))
    return out


def _settled(rows):
    """Last change per (key, winStart)."""
    return {(r["l.k"], r["winStart"]): (r["c"], r["s"]) for r in rows}


def _store_views(ex):
    """Each side's per-shard stores as numpy, after a flush."""
    from hstream_tpu_torch.engine import convert
    st = convert.join_state(ex)
    return st["stores"], st["n"], st["cap"]


def check_joins_against_one_card(across, one, path):
    """Drive a key-sharded JoinExecutor on each mesh with the same batches
    (store growth, eviction and two code compactions included) and hold
    the settled changes, each shard's stores and a snapshot's restores
    onto one card and onto the mesh across cards against the one-card
    mesh's."""
    from hstream_tpu_torch.sql import stream_codegen
    from hstream_tpu_torch.sql.codegen import make_executor
    counters = ((pl.sharded_join_probe_insert_step, pl.scatter_table_cuda)
                if path == "fused" else (pl.sharded_join_probe_insert,))
    counters += (pl.sharded_join_evict, jl.group_cuda, jl.probe_table_cuda,
                 jl.insert_table_cuda)
    before = [c.launches for c in counters]
    sql = JOIN_SQL[path]
    sample = [{"k": "k0", "x": 1.0}]

    def make(mesh, **kw):
        ex = make_executor(stream_codegen(sql), sample_rows=sample,
                           mesh=mesh, device=across.devices[0, 0], **kw)
        ex.DEVICE_STORE_CAPACITY = 256       # grows mid-run
        return ex

    execs = [make(across), make(one)]
    data = _join_batches()
    cut = 12
    outs = [[], []]
    for i, (rows, ts, side) in enumerate(data[:cut]):
        for ex, out in zip(execs, outs):
            out.extend(ex.process(rows, ts, stream=side))
            if i in (5, 10) and ex._dev is not None:
                ex._compact_codes()
    for ex, out in zip(execs, outs):
        out.extend(ex.flush_changes())
    assert outs[0] and _settled(outs[0]) == _settled(outs[1])
    ex = execs[0]
    js = ex.join_stats
    assert ex.device_fallbacks == 0 and ex._dev["sjl"] is not None
    assert js["evict_dispatches"] > 0 and js["store_grows"] > 0, js
    if path == "fused":
        assert js["fused_batches"] > 0, js
    else:
        assert js["fused_batches"] == 0 and js["probe_fetches"] > 0, js
    for side in ("l", "r"):
        for s, st in enumerate(ex._dev["stores"][side]):
            assert st["code"].device == across.devices[0, s]
    inner = ex._inner.state
    for d in range(inner.n_data):
        for k in range(inner.n_key):
            assert inner[d][k]["count"].device == across.devices[d, k]
    got, want = _store_views(execs[0]), _store_views(execs[1])
    assert got[1:] == want[1:]
    for side in ("l", "r"):
        for name, plane in want[0][side].items():
            assert np.array_equal(got[0][side][name], plane), (side, name)
    # a snapshot across cards restores onto one card and onto the mesh
    # across cards; both continue as the one-card mesh does
    blob = tsnap.snapshot_executor(ex)
    restored = [tsnap.restore_executor(stream_codegen(sql), blob,
                                       device=across.devices[0, 0])[0],
                tsnap.restore_executor(stream_codegen(sql), blob,
                                       mesh=across,
                                       device=across.devices[0, 0])[0]]
    tails = [[], [], []]
    for rows, ts, side in data[cut:]:
        for r, out in zip([execs[1]] + restored, tails):
            out.extend(r.process(rows, ts, stream=side))
    for r, out in zip([execs[1]] + restored, tails):
        out.extend(r.flush_changes())
    assert tails[0]
    want = _settled(outs[1] + tails[0])
    for out in tails[1:]:
        assert _settled(outs[0] + out) == want
    assert restored[1]._dev["sjl"] is not None
    if across.devices[0, 0].type != "cpu":
        assert all(c.launches > b for c, b in zip(counters, before)), \
            [(c.__name__, b, c.launches) for c, b in zip(counters, before)]
