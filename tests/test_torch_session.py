"""The port's SessionExecutor (hstream_tpu_torch/engine/session.py) on
device="cpu" against the JAX package's SessionExecutor and against the
port's own host engine, in both kernel modes.

The port's device path on the CPU runs the plain PyTorch versions of the
session kernels (engine/session_lattice.py); the CUDA kernels are held
against those on the card by chip_smoke.py. The cases mirror
tests/test_session_device.py and tests/test_session_vectorized.py.
Tolerances, as there: rows are matched by their exact non-float fields
(keys, window bounds, counts, HLL estimates) and float fields compare
within rel 1e-5 (device accumulators are float32, host ones float64);
APPROX_QUANTILE within rel 0.08, one bucket (bin edges in float32 on the
device, float64 on the host). Where the reference degraded to the host
engine after a failed launch, the port raises; those cases assert the
raise.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hstream_tpu.engine.session import SessionExecutor as JSessionExecutor
from hstream_tpu_torch.common.columnar import ColumnarEmit
from hstream_tpu_torch.common.errors import DeviceUnavailable, NotPortedError
from hstream_tpu_torch.engine import SessionExecutor, convert
from hstream_tpu_torch.engine import session_lattice as sl
from test_session_device import assert_rows_close, gen
from test_session_vectorized import canon_rows, canon_state
from test_session_vectorized import gen as gen_vec
from test_session_vectorized import oracle_process
from torch_parity import BASE, JM, TM

MODES = ["segment", "record"]


def _aggs(names):
    """Aggregate recipes by short name, in either package's namespace."""
    table = {
        "c": lambda m: m.AggSpec(m.AggKind.COUNT_ALL, "c"),
        "n": lambda m: m.AggSpec(m.AggKind.COUNT, "n", input=m.Col("v")),
        "s": lambda m: m.AggSpec(m.AggKind.SUM, "s", input=m.Col("v")),
        "a": lambda m: m.AggSpec(m.AggKind.AVG, "a", input=m.Col("v")),
        "lo": lambda m: m.AggSpec(m.AggKind.MIN, "lo", input=m.Col("v")),
        "hi": lambda m: m.AggSpec(m.AggKind.MAX, "hi", input=m.Col("v")),
        "d": lambda m: m.AggSpec(m.AggKind.APPROX_COUNT_DISTINCT, "d",
                                 input=m.Col("v")),
        "p50": lambda m: m.AggSpec(m.AggKind.APPROX_QUANTILE, "p50",
                                   input=m.Col("v"), quantile=0.5),
        "p99": lambda m: m.AggSpec(m.AggKind.APPROX_QUANTILE, "p99",
                                   input=m.Col("v"), quantile=0.99),
        "sx": lambda m: m.AggSpec(m.AggKind.SUM, "sx", input=m.BinOp(
            "*", m.Col("v"), m.Lit(2.0))),
        "top": lambda m: m.AggSpec(m.AggKind.TOPK, "top", input=m.Col("v"),
                                   k=3),
    }
    return lambda m: [table[n](m) for n in names]


EXACT = _aggs(["c", "n", "s", "a", "lo", "hi", "d", "sx"])


def _node(m, aggs, gap=1000, grace=500, having=None, projections=None,
          where=None, group=("k",), schema=None):
    schema = schema or m.Schema.of(k=m.ColumnType.STRING,
                                   v=m.ColumnType.FLOAT)
    child = m.SourceNode("s", schema)
    if where is not None:
        child = m.FilterNode(child, where(m))
    node = m.AggregateNode(
        child=child, group_keys=[m.Col(g) for g in group],
        window=m.SessionWindow(gap, grace_ms=grace), aggs=aggs(m),
        having=None if having is None else having(m),
        post_projections=[] if projections is None else projections(m))
    return node, schema


def port(aggs, mode=None, device=True, emit_changes=False, **kw):
    """A port SessionExecutor on the CPU (device path in `mode`, or the
    host engine)."""
    node, schema = _node(TM, aggs, **kw)
    ex = SessionExecutor(node, schema, emit_changes=emit_changes,
                         device="cpu")
    ex.use_device_sessions = device
    ex.device_session_mode = mode
    return ex


def jax(aggs, mode=None, device=False, emit_changes=False, **kw):
    """The JAX package's SessionExecutor (host engine unless `device`)."""
    node, schema = _node(JM, aggs, **kw)
    ex = JSessionExecutor(node, schema, emit_changes=emit_changes)
    ex.use_device_sessions = device
    ex.device_session_mode = mode
    return ex


def _feed(exs, batches, peek=True):
    outs = [[] for _ in exs]
    for rows, ts in batches:
        for ex, out in zip(exs, outs):
            out.extend(ex.process(rows, ts))
    if peek:
        return outs, [list(ex.peek()) for ex in exs]
    return outs, None


def _agree(outs, rtol=1e-5):
    for o in outs[1:]:
        assert_rows_close(list(o), list(outs[0]), rtol)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [0, 1])
def test_device_matches_both_host_engines_out_of_order(mode, seed):
    """Out-of-order rows straddling the gap and genuinely late records:
    closed rows, peeks and the watermark agree with the JAX host engine
    and the port's host engine."""
    exs = [jax(EXACT), port(EXACT, mode), port(EXACT, device=False)]
    outs, peeks = _feed(exs, gen(seed))
    dev = exs[1]
    assert dev._dev is not None and dev._dev["mode"] == mode
    assert dev.device_fallbacks == 0 and dev.late_drops > 0
    assert dev.late_drops == exs[0].late_drops == exs[2].late_drops
    _agree(outs)
    _agree(peeks)
    assert len({ex.watermark for ex in exs}) == 1


@pytest.mark.parametrize("mode", MODES)
def test_device_mirror_and_counters_match_jax_device_path(mode):
    """The JAX executor in device mode (same kernel mode) and the port
    keep the same interval mirror, the same counters and the same rows."""
    aggs = _aggs(["c", "s", "lo", "hi", "d"])
    j, t = jax(aggs, mode, device=True), port(aggs, mode)
    outs, peeks = _feed([j, t], gen(2, n_batches=6))
    _agree(outs, rtol=1e-6)
    _agree(peeks, rtol=1e-6)
    for k in ("mir_code", "mir_t0", "mir_t1", "mir_live"):
        assert np.array_equal(j._dev[k], t._dev[k]), k
    for k in ("batches", "step_dispatches", "close_cycles",
              "close_dispatches", "close_fetches", "grows"):
        assert j.session_stats[k] == t.session_stats[k], k
    assert j._dev["cap"] == t._dev["cap"] and j.epoch == t.epoch


@pytest.mark.parametrize("mode", MODES)
def test_quantile_within_one_bucket(mode):
    aggs = _aggs(["p50", "p99"])
    exs = [jax(aggs), port(aggs, mode)]
    outs, peeks = _feed(exs, gen(7))
    assert exs[1]._dev is not None
    _agree(outs, rtol=0.08)
    _agree(peeks, rtol=0.08)


@pytest.mark.parametrize("mode", MODES)
def test_cross_batch_session_extension(mode):
    aggs = _aggs(["c", "s"])
    exs = [port(aggs, mode, gap=1000, grace=0),
           jax(aggs, gap=1000, grace=0)]
    for b in range(6):
        for ex in exs:
            assert list(ex.process([{"k": "a", "v": 1.0}],
                                   [BASE + b * 900])) == []
    closed = []
    for ex in exs:
        out = ex.process([{"k": "z", "v": 0.0}], [BASE + 100_000])
        closed.append([r for r in out if r["k"] == "a"])
    assert closed[0] == closed[1] and len(closed[0]) == 1
    r = closed[0][0]
    assert (r["c"], r["s"], r["winStart"], r["winEnd"]) == \
        (6, 6.0, BASE, BASE + 5 * 900 + 1000)


@pytest.mark.parametrize("mode", MODES)
def test_multi_session_merge_within_limit(mode):
    """One batch bridging five open sessions of a key merges them all."""
    aggs = _aggs(["c", "lo", "hi"])
    exs = [port(aggs, mode, gap=100, grace=5000),
           jax(aggs, gap=100, grace=5000)]
    for ex in exs:
        for i in range(5):
            ex.process([{"k": "a", "v": float(i)}], [BASE + i * 400])
    assert len(list(exs[0].peek())) == 5
    ts = list(range(BASE + 50, BASE + 5 * 400, 80))
    for ex in exs:
        ex.process([{"k": "a", "v": 99.0} for _ in ts], ts)
    assert exs[0].device_fallbacks == 0
    pd, ph = list(exs[0].peek()), list(exs[1].peek())
    assert_rows_close(pd, ph)
    assert len(pd) == 1 and pd[0]["c"] == 5 + len(ts)
    assert (pd[0]["lo"], pd[0]["hi"]) == (0.0, 99.0)


@pytest.mark.parametrize("mode", MODES)
def test_deep_chain_stays_on_the_device(mode):
    """A batch chain merging six open sessions stays on the device path
    (the port has no chain limit; the kernels handle any chain) and
    gives the rows of the JAX device path, which its chain limit moved
    to its host engine."""
    aggs = _aggs(["c", "s"])
    t = port(aggs, mode, gap=100, grace=5000)
    h = jax(aggs, mode, device=True, gap=100, grace=5000)
    h.chain_merge_limit = 3
    for ex in (t, h):
        for i in range(6):
            ex.process([{"k": "a", "v": 1.0}], [BASE + i * 400])
    assert t._dev is not None and h._dev is not None
    ts = list(range(BASE + 50, BASE + 6 * 400, 80))
    od = t.process([{"k": "a", "v": 1.0} for _ in ts], ts)
    oh = h.process([{"k": "a", "v": 1.0} for _ in ts], ts)
    assert h._dev is None and h.device_fallbacks == 1
    assert t._dev is not None and t.device_fallbacks == 0
    assert int(t._dev["mir_live"].sum()) == 1
    assert list(od) == list(oh) == []
    _agree([list(h.peek()), list(t.peek())])
    od = t.process([{"k": "z", "v": 0.0}], [BASE + 100_000])
    oh = h.process([{"k": "z", "v": 0.0}], [BASE + 100_000])
    _agree([list(oh), list(od)])
    assert [r["c"] for r in od] == [6 + len(ts)]


@pytest.mark.parametrize("mode", MODES)
def test_key_growth_and_code_compaction(mode):
    """Key cardinality past the cache bound compacts the code space
    through the remap (order-preserving, evicting dead codes); rows stay
    equal to the reference across the remap."""
    aggs = _aggs(["c", "s"])
    t = port(aggs, mode, gap=500, grace=0)
    h = jax(aggs, gap=500, grace=0)
    t._KEY_CACHE_MAX = 64
    rng = np.random.default_rng(3)
    batches = []
    for b in range(8):
        ks = [f"k{b}_{int(i)}" for i in rng.integers(0, 40, 120)]
        ts = (BASE + b * 5000 + rng.integers(0, 400, 120)).tolist()
        batches.append(([{"k": k, "v": 1.0} for k in ks], ts))
    outs, peeks = _feed([h, t], batches)
    assert t._dev is not None
    assert t.session_stats["remap_dispatches"] >= 1
    assert len(t._code_rev) < 8 * 40
    _agree(outs)
    _agree(peeks)


@pytest.mark.parametrize("mode", MODES)
def test_watermark_close_parity(mode):
    aggs = _aggs(["c"])
    gap, grace = 1000, 300
    exs = [port(aggs, mode, gap=gap, grace=grace),
           jax(aggs, gap=gap, grace=grace)]
    for ex in exs:
        ex.process([{"k": "a", "v": 1.0}], [BASE])
    boundary = BASE + 2 * gap + grace
    for ex in exs:
        out = ex.process([{"k": "z", "v": 0.0}], [boundary - 1])
        assert [r for r in out if r["k"] == "a"] == []
    outs = []
    for ex in exs:
        out = ex.process([{"k": "z", "v": 0.0}], [boundary])
        outs.append([r for r in out if r["k"] == "a"])
    assert outs[0] == outs[1] and len(outs[0]) == 1


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("keys", ["unicode", "object"])
def test_columnar_feed_matches_row_feed(mode, keys):
    """process_columnar (unicode or object key columns, NULL masks)
    equals the row path of both host engines."""
    aggs = _aggs(["c", "n", "s"])
    t, h, th = port(aggs, mode), jax(aggs), port(aggs, device=False)
    rng = np.random.default_rng(5)
    od, oh, oth = [], [], []
    for b in range(6):
        n = 200
        ks = np.array([f"u{int(i)}" for i in rng.integers(0, 10, n)])
        if keys == "object":
            ks = ks.astype(object)
        vs = rng.integers(0, 100, n).astype(np.float32)
        ts = BASE + b * 2500 + rng.integers(0, 4000, n)
        nulls = {"v": rng.random(n) < 0.1}
        od.extend(t.process_columnar(ts, {"k": ks, "v": vs}, nulls))
        rows = [({"k": str(k)} if isnull else {"k": str(k), "v": float(v)})
                for k, v, isnull in zip(ks, vs, nulls["v"])]
        oh.extend(h.process(rows, ts.tolist()))
        oth.extend(th.process(rows, ts.tolist()))
    assert t._dev is not None
    _agree([oh, od, oth])
    _agree([list(h.peek()), list(t.peek()), list(th.peek())])


@pytest.mark.parametrize("mode", MODES)
def test_one_launch_zero_fetch_ingest_contract(mode):
    """ONE step (or merge) call per micro-batch and no fetch outside
    close cycles; each close cycle is one extract and one fetch. On the
    CPU the wrappers run the plain versions and count no launch."""
    aggs = _aggs(["c", "s"])
    ex = port(aggs, mode, gap=1000, grace=0)
    rng = np.random.default_rng(9)
    before = {f: getattr(sl, f).launches for f in
              ("session_step", "session_merge", "session_extract")}
    for b in range(10):
        rows = [{"k": f"u{int(i)}", "v": 1.0}
                for i in rng.integers(0, 20, 256)]
        ts = (BASE + b * 10_000 + rng.integers(0, 900, 256)).tolist()
        ex.process(rows, ts)
    st = ex.session_stats
    assert st["step_dispatches"] == st["batches"] == 10
    assert st["close_dispatches"] == st["close_cycles"] >= 8
    assert st["close_fetches"] == st["close_cycles"]
    assert ex.transfer_stats["h2d_bytes"] > 0
    assert {f: getattr(sl, f).launches for f in before} == before


@pytest.mark.parametrize("mode", MODES)
def test_deferred_close_drain_single_stacked_fetch(mode):
    aggs = _aggs(["c", "s"])
    exd = port(aggs, mode, gap=1000, grace=0)
    exs = port(aggs, mode, gap=1000, grace=0)
    exd.defer_close_decode = True
    rng = np.random.default_rng(13)
    sync_rows = []
    for b in range(6):
        rows = [{"k": f"u{int(i)}", "v": 1.0}
                for i in rng.integers(0, 8, 128)]
        ts = (BASE + b * 10_000 + rng.integers(0, 900, 128)).tolist()
        assert list(exd.process(rows, ts)) == []
        sync_rows.extend(exs.process(rows, ts))
    assert exd.has_pending_closes()
    shapes = {tuple(p[3].shape) for p in exd._pending_closes}
    before = exd.session_stats["close_fetches"]
    drained = list(exd.flush_changes())
    assert exd.session_stats["close_fetches"] - before == len(shapes)
    assert_rows_close(drained, sync_rows)
    assert not exd.has_pending_closes()


def test_emit_changes_and_topk_stay_on_the_host_engine():
    """Host-only configurations never activate the device path (a
    refusal, not a counted move) and give the reference's rows."""
    t = port(_aggs(["c"]), emit_changes=True)
    h = jax(_aggs(["c"]), emit_changes=True)
    outs, _ = _feed([h, t], gen(4, n_batches=3), peek=False)
    assert t._dev is None and t._device_refusal is not None
    assert t.device_fallbacks == 0
    _agree(outs)
    t2, h2 = port(_aggs(["top", "c"])), jax(_aggs(["top", "c"]))
    outs, peeks = _feed([h2, t2], gen(5, n_batches=4))
    assert t2._dev is None and "host-only" in t2._device_refusal
    assert canon_rows(outs[0]) == canon_rows(outs[1])
    assert canon_rows(peeks[0]) == canon_rows(peeks[1])


def test_host_and_device_emission_is_columnar():
    aggs = _aggs(["c", "s"])
    for ex in (port(aggs, device=False), port(aggs, gap=1000, grace=0)):
        ex.process([{"k": "a", "v": 1.0}, {"k": "b", "v": 2.0}],
                   [BASE, BASE + 10])
        peeked = ex.peek()
        assert isinstance(peeked, ColumnarEmit)
        assert {r["k"] for r in peeked} == {"a", "b"}
        out = ex.process([{"k": "z", "v": 0.0}], [BASE + 100_000])
        assert isinstance(out, ColumnarEmit)
        assert {r["k"] for r in out} == {"a", "b"}


@pytest.mark.parametrize("mode", MODES)
def test_having_and_projections_parity(mode):
    def having(m):
        return m.BinOp(">", m.Col("c"), m.Lit(2))

    def projections(m):
        return [("key", m.Col("k")), ("total", m.Col("s"))]

    aggs = _aggs(["c", "s"])
    t = port(aggs, mode, having=having, projections=projections)
    h = jax(aggs, having=having, projections=projections)
    outs, _ = _feed([h, t], gen(17, n_batches=5), peek=False)
    assert t._dev is not None and len(outs[0]) > 0
    assert set(outs[1][0]) == {"key", "total", "winStart", "winEnd"}
    _agree(outs)


@pytest.mark.parametrize("mode", MODES)
def test_where_filter_parity(mode):
    def where(m):
        return m.BinOp(">", m.Col("v"), m.Lit(100.0))

    aggs = _aggs(["c", "s"])
    t, h = port(aggs, mode, where=where), jax(aggs, where=where)
    outs, _ = _feed([h, t], gen(21, n_batches=6), peek=False)
    assert t._dev is not None
    _agree(outs)
    assert t.watermark == h.watermark  # pre-filter max


def _pinned_batches(n):
    """An ancient open session ("pin", kept open by a huge grace) and a
    new key per batch, 500 s apart: past batch 8 relative time reaches a
    threshold of 2^22 ms that no rebase can reclaim."""
    return [([{"k": "pin", "v": 1.0}, {"k": f"s{b}", "v": 1.0}],
             [BASE + b * 500_000, BASE + b * 500_000 + 10])
            for b in range(n)]


def test_pinned_anchor_span_moves_to_host_engine():
    """On device="cpu", once relative time reaches the device range the
    state moves to the host engine (counted) as in the reference,
    instead of desyncing the mirror."""
    aggs = _aggs(["c"])
    t = port(aggs, "segment", gap=1000, grace=1 << 25)
    h = jax(aggs, gap=1000, grace=1 << 25)
    t.REBASE_THRESHOLD = 1 << 22
    outs, peeks = _feed([h, t], _pinned_batches(12))
    assert t._dev is None and t.device_fallbacks == 1
    _agree(outs)
    _agree(peeks)


def test_pinned_anchor_span_raises_on_the_card():
    """On the card the same span raises NotPortedError: state on the card
    never moves to the host engine. The check runs before any device
    work, so the executor's device is switched to CUDA just before the
    batch that crosses the bound."""
    t = port(_aggs(["c"]), "segment", gap=1000, grace=1 << 25)
    t.REBASE_THRESHOLD = 1 << 22
    batches = _pinned_batches(10)
    _feed([t], batches[:9], peek=False)
    assert t._dev is not None
    t.device = torch.device("cuda", 0)
    with pytest.raises(NotPortedError, match="A7c"):
        t.process(*batches[9])
    assert t._dev is not None and t.device_fallbacks == 0


@pytest.mark.parametrize("op", ["SQRT", "IFNULL"])
def test_refused_input_host_engine_on_cpu_raise_on_the_card(op):
    """A record-mode aggregate input the device compiler refuses (SQRT,
    not ported: A6b; IFNULL, host-only: A7c) runs on the host
    engine on device="cpu", with the reference's rows, and raises
    NotPortedError on the card before any device work."""
    def sx(m):
        inp = (m.UnOp("SQRT", m.Col("v")) if op == "SQRT"
               else m.BinOp("IFNULL", m.Col("v"), m.Lit(7.0)))
        return [m.AggSpec(m.AggKind.COUNT_ALL, "c"),
                m.AggSpec(m.AggKind.SUM, "sx", input=inp)]

    t, h = port(sx, "record"), jax(sx)
    rows = [{"k": f"k{i % 3}", "v": float(i)} for i in range(9)]
    ts = [BASE + 100 * i for i in range(9)]
    _, peeks = _feed([h, t], [(rows, ts)])
    assert t._dev is None and "compile refused" in t._device_refusal
    assert t.device_fallbacks == 0
    _agree(peeks)
    card = port(sx, "record")
    card.device = torch.device("cuda", 0)
    with pytest.raises(NotPortedError,
                       match="A6b" if op == "SQRT" else "A7c"):
        card.process(rows, ts)


def test_rebase_shifts_the_arena_with_the_step():
    """A lowered threshold re-anchors the epoch; the delta rides the next
    step and rows stay equal to the reference."""
    aggs = _aggs(["c", "s"])
    t = port(aggs, "record", gap=1000, grace=0)
    h = jax(aggs, gap=1000, grace=0)
    t.REBASE_THRESHOLD = 1 << 14
    epochs = []
    batches = [([{"k": f"u{i % 3}", "v": float(i)} for i in range(6)],
                [BASE + b * 7000 + i * 300 for i in range(6)])
               for b in range(6)]
    outs = [[], []]
    for rows, ts in batches:
        outs[0].extend(h.process(rows, ts))
        outs[1].extend(t.process(rows, ts))
        epochs.append(t.epoch)
    assert len(set(epochs)) > 1
    _agree(outs)
    _agree([list(h.peek()), list(t.peek())])


def test_huge_gap_grace_refuses_device():
    t = port(_aggs(["c"]), gap=1 << 29, grace=1 << 29)
    t.process([{"k": "a", "v": 1.0}], [BASE])
    assert t._dev is None and "relative-time range" in t._device_refusal
    assert t.device_fallbacks == 0


def test_peek_does_not_skew_close_accounting():
    t = port(_aggs(["c"]), gap=1000, grace=0)
    t.process([{"k": "a", "v": 1.0}], [BASE])
    for _ in range(3):
        t.peek()
    st = t.session_stats
    assert st["peek_dispatches"] == 3
    assert st["close_dispatches"] == st["close_cycles"] == 0


@pytest.mark.parametrize("mode", MODES)
def test_late_records_merge_into_open_sessions(mode):
    """A late record overlapping an open session merges; a late one far
    from any session is dropped."""
    t = port(_aggs(["c"]), mode, gap=1000, grace=0)
    h = jax(_aggs(["c"]), gap=1000, grace=0)
    for ex in (t, h):
        ex.process([{"k": "a", "v": 1.0}], [BASE + 10_000])
        ex.process([{"k": "a", "v": 1.0}, {"k": "a", "v": 1.0}],
                   [BASE + 9_500, BASE + 2_000])
    pd, ph = list(t.peek()), list(h.peek())
    assert pd == ph and pd[0]["c"] == 2
    assert t.late_drops == h.late_drops == 1


def test_move_to_host_with_pending_deferred_closes_keeps_keys():
    """Pending deferred closes resolve their key columns when the state
    moves to the host engine (the span bound on device="cpu"); a later
    host-mode key-cache clear must not change them."""
    t = port(_aggs(["c"]), gap=1000, grace=0)
    t.defer_close_decode = True
    t.process([{"k": "a", "v": 1.0}], [BASE])
    t.process([{"k": "closer", "v": 0.0}], [BASE + 100_000])
    assert t.has_pending_closes()
    t._degrade_to_host("test: the span bound's move, forced")
    t._KEY_CACHE_MAX = 0
    t.process([{"k": f"n{i}", "v": 1.0} for i in range(4)],
              [BASE + 200_000 + i for i in range(4)])
    assert [r["k"] for r in t.drain_closed()] == ["a"]


def _boom(*_a, **_k):
    raise RuntimeError("launch failed")


@pytest.mark.parametrize("mode", MODES)
def test_failed_step_raises(monkeypatch, mode):
    """Where the reference degraded to the host after a failed step
    dispatch, the port raises and keeps no hidden fallback."""
    t = port(_aggs(["c", "s"]), mode, gap=1000, grace=0)
    t.process([{"k": "a", "v": 1.0}], [BASE])
    monkeypatch.setattr(sl, "session_step" if mode == "record"
                        else "session_merge", _boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        t.process([{"k": "a", "v": 2.0}], [BASE + 10])
    assert t._dev is not None and t.device_fallbacks == 0


def test_failed_close_extract_raises(monkeypatch):
    t = port(_aggs(["c"]), gap=1000, grace=0)
    t.process([{"k": "a", "v": 1.0}], [BASE])
    monkeypatch.setattr(sl, "session_extract", _boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        t.process([{"k": "z", "v": 0.0}], [BASE + 100_000])
    assert t._dev is not None and t.device_fallbacks == 0


def test_failed_peek_extract_and_activation_raise(monkeypatch):
    t = port(_aggs(["c"]), gap=1000, grace=0)
    t.process([{"k": "a", "v": 1.0}], [BASE])
    monkeypatch.setattr(sl, "session_extract", _boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        t.peek()
    assert t._dev is not None and t.device_fallbacks == 0
    monkeypatch.setattr(sl, "init_session_arena", _boom)
    fresh = port(_aggs(["c"]), gap=1000, grace=0)
    with pytest.raises(RuntimeError, match="launch failed"):
        fresh.process([{"k": "a", "v": 1.0}], [BASE])
    assert fresh.device_fallbacks == 0 and fresh.use_device_sessions


def test_session_executor_needs_the_card_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    node, schema = _node(TM, _aggs(["c"]))
    with pytest.raises(DeviceUnavailable, match="device='cpu'"):
        SessionExecutor(node, schema)
    assert SessionExecutor(node, schema, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("mode", MODES)
def test_state_carries_across_from_the_jax_executor(mode):
    """convert: a JAX SessionExecutor in device mode, part way through a
    stream (arena, mirror, code dictionary, epoch, watermark, last close
    cycle), continues in the port with the same rows. Quantiles: exact
    buckets in segment mode (both engines bin on the host), one bucket
    in record mode (the port bins in float32)."""
    aggs = _aggs(["c", "s", "lo", "hi", "d", "p50"])
    j = jax(aggs, device=True)
    ref = jax(aggs, device=True)
    batches = gen(23, n_batches=8)
    for rows, ts in batches[:4]:
        j.process(rows, ts)
        ref.process(rows, ts)
    assert j._dev is not None and j._closed_wm >= 0
    node, schema = _node(TM, aggs)
    if mode == "segment":        # the CPU's default mode
        t = convert.session_from(j, node, schema, device="cpu")
    else:
        t = SessionExecutor(node, schema, device="cpu")
        t.device_session_mode = mode
        convert.adopt_session(t, convert.session_state(j))
    assert t._dev["mode"] == mode
    assert (t.watermark, t.epoch, t._closed_wm) == \
        (j.watermark, j.epoch, j._closed_wm)
    outs = [[], []]
    for rows, ts in batches[4:]:
        outs[0].extend(ref.process(rows, ts))
        outs[1].extend(t.process(rows, ts))
    assert t.device_fallbacks == 0 and len(outs[0]) > 0
    rtol = 1e-5 if mode == "segment" else 0.08
    _agree(outs, rtol)
    _agree([list(ref.peek()), list(t.peek())], rtol)
    state = convert.session_state(t)
    assert set(state["arena"]) == set(j._dev["arena"])
    with pytest.raises(ValueError, match="not fresh"):
        convert.adopt_session(t, state)


@pytest.mark.parametrize("aggset", range(4))
def test_host_engine_batch_matches_per_record_oracle(aggset):
    """The port's host engine: batch process() equals the per-record
    merge path over out-of-order, late workloads (the reference's
    tests/test_session_vectorized.py), and equals the JAX host engine."""
    aggs = [_aggs(["c", "s", "a"]), _aggs(["lo", "hi", "n"]),
            _aggs(["p50", "d"]), _aggs(["top"])][aggset]
    tb = port(aggs, device=False)
    tr = port(aggs, device=False)
    jb = jax(aggs)
    out_b, out_r, out_j = [], [], []
    for rows, ts in gen_vec(aggset):
        out_b.extend(tb.process(rows, ts))
        out_r.extend(oracle_process(tr, rows, ts))
        out_j.extend(jb.process(rows, ts))
    assert canon_state(tb) == canon_state(tr) == canon_state(jb)
    assert canon_rows(out_b) == canon_rows(out_r) == canon_rows(out_j)


def test_multi_column_group_key_and_null_rules():
    """Two group columns; junk, numeric-string and ragged inputs are
    NULL on both the vectorized and the per-record (late) paths."""
    schema_t = TM.Schema.of(k=TM.ColumnType.STRING, r=TM.ColumnType.INT,
                            v=TM.ColumnType.FLOAT)
    for device in (False, True):
        node, schema = _node(TM, _aggs(["s"]), grace=0, group=("k", "r"),
                             schema=schema_t)
        ex = SessionExecutor(node, schema, device="cpu")
        ex.use_device_sessions = device
        ex.process([{"k": "a", "r": 1, "v": 1.0}, {"k": "a", "r": 2,
                                                   "v": 2.0},
                    {"k": "a", "r": 1, "v": 3.0}], [BASE, BASE, BASE + 10])
        got = ex.process([{"k": "z", "v": 0.0}], [BASE + 100_000])
        assert {(r["k"], r["r"]): r["s"] for r in got
                if r["k"] == "a"} == {("a", 1): 4.0, ("a", 2): 2.0}
    ex = port(_aggs(["s", "n", "c"]), device=False, grace=0)
    ex.process([{"k": "a", "v": 1.0}], [BASE + 50_000])
    ex.process([{"k": "a", "v": "junk"}, {"k": "a", "v": "3"},
                {"k": "b", "v": [1.0, 2.0]}, {"k": "b", "v": 2.0}],
               [BASE + 49_900, BASE + 49_950, BASE + 51_000,
                BASE + 51_010])
    rows = ex.process([{"k": "z", "v": 0.0}], [BASE + 200_000])
    got = {r["k"]: (r["c"], r["n"], r["s"]) for r in rows if r["k"] in "ab"}
    assert got == {"a": (3, 1, 1.0), "b": (2, 1, 2.0)}, got
