"""Parity of the port's compiled lattice bundle (plain PyTorch versions)
with hstream_tpu's `lattice.compiled`: the step over the packed int32
transport (B10: unpack, then the step's programs) and the per-slot close
(B9: extract_slot, reset_slot), then the executor's per-slot close
(`_fused_close_ok = False`) against the JAX executor's.

Inputs come from numpy seeds: keys past K, records before the epoch and
late ones, invalid rows, NaN / +-inf / -0.0, and NULL masks packed as
the reference's sharded executor packs them (one entry per aggregate,
None for COUNT(*)). The same packed buffer goes to both packages.
Tolerances (shared with tests/test_torch_changelog_lattice.py): integer
planes, slot_start, touched, MIN/MAX by value, TOPK planes and packed
integer rows exact; float32 SUM/AVG sums and finalized SUM / AVG / HLL
values rel 1e-6; a finalized quantile the same bucket, its midpoint
within rel 4e-6. Executor rows compare as tests/test_close_batched.py
compares them (floats rel 1e-6).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import hstream_tpu.engine as J
from hstream_tpu.engine import expr as je
from hstream_tpu.engine import lattice as jl
import hstream_tpu_torch.engine as T
from hstream_tpu_torch.engine import convert
from hstream_tpu_torch.engine import expr as te
from hstream_tpu_torch.engine import lattice as tl
from test_torch_changelog_lattice import assert_rows, assert_states
from torch_parity import BASE

K = 12
CAP = 512


def _schema(m):
    return m.Schema.of(device=m.ColumnType.STRING, x=m.ColumnType.FLOAT,
                       i=m.ColumnType.INT, b=m.ColumnType.BOOL)


def _agg(m, e, i, kind, col=None, **kw):
    arg = None if col is None else (col(e) if callable(col) else e.Col(col))
    return m.AggSpec(m.AggKind[kind], f"o{i}", input=arg, **kw)


# name -> (aggregates as (kind, column or a function giving the input
#          expression, extra), a function giving the WHERE, or None)
CASES = {
    "count_all": ([("COUNT_ALL", None, {})], None),
    "sum": ([("SUM", "x", {})], None),
    "avg": ([("AVG", "x", {})], None),
    "min": ([("MIN", "x", {})], None),
    "max": ([("MAX", "x", {})], None),
    "count_col": ([("COUNT", "x", {})], None),
    "hll": ([("APPROX_COUNT_DISTINCT", "x", {})], None),
    "quantile": ([("APPROX_QUANTILE", "x", {"quantile": 0.9})], None),
    "topk": ([("TOPK", "x", {"k": 3})], None),
    "topk_distinct": ([("TOPK_DISTINCT", "x", {"k": 3})], None),
    "where": ([("COUNT_ALL", None, {}), ("SUM", "x", {})],
              lambda e: e.BinOp("AND", e.BinOp(">", e.Col("x"),
                                               e.Lit(-1.0)),
                                e.UnOp("NOT", e.Col("b")))),
    "bool_col": ([("COUNT", "b", {}), ("SUM", "i", {})],
                 lambda e: e.Col("b")),
    "i32_col": ([("SUM", "i", {}), ("MIN", "i", {}), ("MAX", "i", {}),
                 ("APPROX_COUNT_DISTINCT", "i", {}), ("TOPK", "i", {"k": 2})],
                None),
    "f32_computed": ([("SUM", lambda e: e.BinOp(
        "+", e.BinOp("*", e.Col("x"), e.Lit(1.8)), e.Lit(32)), {}),
        ("APPROX_QUANTILE", lambda e: e.BinOp("*", e.Col("i"), e.Lit(2)),
         {"quantile": 0.5})], None),
    "nulls": ([("SUM", "x", {}), ("AVG", "x", {}), ("COUNT", "i", {}),
               ("COUNT_ALL", None, {})], None),
    # COUNT(*) before null-tracked aggregates: the packer and the
    # unpacker number the masks differently (ROADMAP C)
    "count_star_then_nulls": ([("COUNT_ALL", None, {}), ("SUM", "x", {}),
                               ("MAX", "i", {})], None),
}


def _aggs(m, e, case):
    return tuple(_agg(m, e, i, k, c, **kw)
                 for i, (k, c, kw) in enumerate(CASES[case][0]))


def _filter(e, case):
    w = CASES[case][1]
    return None if w is None else w(e)


def _layout(m, e, aggs, where):
    need = set()
    for a in aggs:
        if a.input is not None:
            need |= e.columns_of(a.input)
    if where is not None:
        need |= e.columns_of(where)
    schema = _schema(m)
    return tuple((c, tl.layout_tag(T.ColumnType[schema.type_of(c).name]))
                 for c in sorted(need))


def packed_batches(case: str, seed: int, n_batches: int = 3):
    """(packed int32 [3 + n_cols, CAP], watermark, per-aggregate masks)
    per batch, packed by pack_batch_host with one NULL mask entry per
    aggregate (None for COUNT(*))."""
    rng = np.random.default_rng(seed)
    aggs = _aggs(J, je, case)
    layout = _layout(J, je, aggs, _filter(je, case))
    pool = np.array([-2.0, -0.0, 0.0, 1.0, 2.5, np.nan, np.inf, -np.inf],
                    np.float32)
    wm, t0 = -1, 40_000
    for _ in range(n_batches):
        n = int(rng.integers(200, CAP))
        key = rng.integers(0, K + 2, n).astype(np.int32)
        ts = (t0 + rng.integers(-12_000, 18_000, n)).astype(np.int64)
        ts[:3] = -rng.integers(1, 9_000, 3)
        x = (np.rint(rng.normal(4, 6, n) * 4) / 4).astype(np.float32)
        x[::7] = pool[rng.integers(0, len(pool), x[::7].shape[0])]
        cols = {"x": x, "i": rng.integers(-40, 40, n).astype(np.int32),
                "b": rng.random(n) < 0.3}
        nulls = {c: rng.random(n) < 0.1 for c in cols}
        masks = []
        for a in aggs:
            if a.input is None:
                masks.append(None)
                continue
            mk = np.zeros(n, np.bool_)
            for c in je.columns_of(a.input):
                mk |= nulls[c]
            masks.append(mk)
        valid = rng.random(n) < 0.95
        buf = tl.pack_batch_host(CAP, n, key, ts, valid, cols, masks,
                                 layout)
        yield buf, wm, masks
        wm = int(ts.max())
        t0 += 15_000


def bundles(case: str):
    jschema, tschema = _schema(J), _schema(T)
    jspec = jl.LatticeSpec(n_keys=K, window=J.TumblingWindow(
        10_000, grace_ms=0), aggs=_aggs(J, je, case))
    tspec = tl.LatticeSpec(n_keys=K, window=T.TumblingWindow(
        10_000, grace_ms=0), aggs=_aggs(T, te, case))
    jw, tw = _filter(je, case), _filter(te, case)
    jlay = _layout(J, je, jspec.aggs, jw)
    tlay = _layout(T, te, tspec.aggs, tw)
    assert jlay == tlay
    jf = jl.compiled(jspec, jschema, jw, 64, jlay)
    tf = tl.compiled(tspec, tschema, tw, 64, tlay)
    return jspec, tspec, jf, tf


def run_packed(case: str, seed: int):
    jspec, tspec, jf, tf = bundles(case)
    jstate = jl.init_state(jspec)
    tstate = tl.init_state(tspec, "cpu")
    for buf, wm, _masks in packed_batches(case, seed):
        jstate = jf.step(jstate, np.int32(wm), buf)
        got = tf.step(tstate, wm, torch.from_numpy(buf.copy()))
        assert got is tstate  # the port's step updates in place
        assert_states(jspec, jstate, tstate)
    assert int(tstate["count"].sum()) > 0
    return jspec, tspec, jf, tf, jstate, tstate


@pytest.mark.parametrize("case", list(CASES))
def test_packed_step_matches_compiled_step(case):
    run_packed(case, seed=len(case))


@pytest.mark.parametrize("case", list(CASES))
def test_per_slot_close_matches_compiled_extract_and_reset(case):
    jspec, tspec, jf, tf, jstate, tstate = run_packed(case, seed=3)
    for slot in range(tspec.n_slots):
        jp = np.asarray(jf.extract_slot(jstate, np.int32(slot)))
        tp = tf.extract_slot(tstate, slot).numpy()
        assert jp.shape == tp.shape == (2 + tl.out_rows(tspec), K)
        np.testing.assert_array_equal(tp[:2], jp[:2])
        assert_rows(jspec, jp[2:], tp[2:])
        # the per-slot extract is one slot of the fused close's buffer
        fused = tl.extract_slots_ref(tspec, tstate,
                                     torch.tensor([slot], dtype=torch.int32))
        np.testing.assert_array_equal(fused[0].numpy(), tp)
        jstate = jf.reset_slot(jstate, np.int32(slot))
        assert tf.reset_slot(tstate, slot) is tstate
        assert_states(jspec, jstate, tstate)
    assert int(tstate["count"].sum()) == 0
    assert (tstate["slot_start"] == tl.EMPTY_START).all()


def test_packed_null_bits_follow_the_reference_numbering():
    """The host packer shifts aggregate j's mask to bit 1 + j counting
    COUNT(*)'s None entry; the unpacker numbers the masks over the
    aggregates that have one. With COUNT(*) first, SUM(x)'s mask lands
    in bit 2 and is read back from bit 1: all False, in both packages
    (ROADMAP C; the port keeps the reference's two loops)."""
    m = np.array([1, 0, 1, 0, 0, 0, 1, 1], np.bool_)
    buf = tl.pack_batch_host(8, 8, np.zeros(8, np.int32),
                             np.zeros(8, np.int64), None,
                             {"x": np.ones(8, np.float32)}, [None, m],
                             (("x", "f32"),))
    np.testing.assert_array_equal(buf[2], [5, 1, 5, 1, 1, 1, 5, 5])
    np.testing.assert_array_equal(
        buf, jl.pack_batch_host(8, 8, np.zeros(8, np.int32),
                                np.zeros(8, np.int64), None,
                                {"x": np.ones(8, np.float32)}, [None, m],
                                (("x", "f32"),)))
    keys = (None, "__null_a1")
    _k, _t, _v, jcols = jl.unpack_batch_device(buf, (("x", "f32"),), keys)
    _k, _t, valid, tcols = tl.unpack(torch.from_numpy(buf), (("x", "f32"),),
                                     keys)
    assert not np.asarray(jcols["__null_a1"]).any()
    assert not tcols["__null_a1"].any()
    assert valid.all()
    # with the masked aggregate first both loops agree
    buf = tl.pack_batch_host(8, 8, np.zeros(8, np.int32),
                             np.zeros(8, np.int64), None,
                             {"x": np.ones(8, np.float32)}, [m, None],
                             (("x", "f32"),))
    _k, _t, _v, tcols = tl.unpack(torch.from_numpy(buf), (("x", "f32"),),
                                  ("__null_a0", None))
    np.testing.assert_array_equal(tcols["__null_a0"].numpy(), m)


def test_count_star_then_nulls_reads_the_shifted_masks_in_both():
    """The consequence of the numbering, for COUNT(*), SUM(x), MAX(i):
    SUM(x) reads bit 1 (no mask: its NULL inputs are summed) and MAX(i)
    reads bit 2, which holds SUM(x)'s mask. The packed step equals a
    decoded step fed exactly those masks, and the reference's planes
    equal the port's (test_packed_step_matches_compiled_step)."""
    _js, tspec, _jf, tf, _jstate, tstate = run_packed(
        "count_star_then_nulls", seed=5)
    want = tl.init_state(tspec, "cpu")
    for buf, wm, masks in packed_batches("count_star_then_nulls", 5):
        assert masks[0] is None and masks[1].any() and masks[2].any()
        key, ts, valid, cols = tl.unpack_batch(
            torch.from_numpy(buf), (("i", "i32"), ("x", "f32")), ())
        shifted = np.zeros(CAP, np.bool_)
        shifted[:len(masks[1])] = masks[1]
        cols["__null_a2"] = torch.from_numpy(shifted)
        tl.step_decoded(tspec, want, wm, key, ts, valid, cols)
    for k in want:
        torch.testing.assert_close(tstate[k], want[k], rtol=1e-6, atol=0)


def test_unpack_views_and_refusals():
    buf = tl.pack_batch_host(16, 10, np.arange(10, dtype=np.int32),
                             np.arange(10, dtype=np.int64), None,
                             {"x": np.linspace(-1, 1, 10).astype(np.float32),
                              "i": np.arange(10, dtype=np.int32),
                              "b": np.arange(10) % 3 == 0},
                             [None, None], (("b", "bool"), ("i", "i32"),
                                            ("x", "f32")))
    t = torch.from_numpy(buf)
    key, ts, valid, cols = tl.unpack(t, (("b", "bool"), ("i", "i32"),
                                         ("x", "f32")), ())
    assert key.data_ptr() == t[0].data_ptr()
    assert cols["x"].data_ptr() == t[5].data_ptr()
    assert cols["x"].dtype == torch.float32 and cols["b"].dtype == torch.bool
    assert valid[:10].all() and not valid[10:].any()   # padding past n
    with pytest.raises(ValueError, match="int32"):
        tl.unpack(t[:4], (("b", "bool"), ("i", "i32"), ("x", "f32")), ())
    with pytest.raises(ValueError, match="int32"):
        tl.unpack(t.float(), (("b", "bool"), ("i", "i32"), ("x", "f32")),
                  ())
    spec = tl.LatticeSpec(n_keys=4, window=T.TumblingWindow(10_000, 0),
                          aggs=(T.AggSpec(T.AggKind.COUNT_ALL, "c"),))
    st = tl.init_state(spec, "cpu")
    with pytest.raises(ValueError, match="out of range"):
        tl.extract_slot(spec, st, spec.n_slots)
    with pytest.raises(ValueError, match="out of range"):
        tl.reset_slot(spec, st, -1)


def test_compiled_is_cached_and_holds_no_state():
    _js, tspec, _jf, tf = bundles("where")
    tschema = _schema(T)
    tw = _filter(te, "where")
    lay = _layout(T, te, tspec.aggs, tw)
    assert tl.compiled(tspec, tschema, tw, 64, lay) is tf
    assert tf.null_keys == jl.compiled(*_jax_args("where")).null_keys
    for fn in tf[:7]:
        cells = getattr(fn, "__closure__", None) or ()
        assert not any(isinstance(c.cell_contents, dict) for c in cells)


def _jax_args(case):
    jspec = jl.LatticeSpec(n_keys=K, window=J.TumblingWindow(
        10_000, grace_ms=0), aggs=_aggs(J, je, case))
    jw = _filter(je, case)
    return jspec, _schema(J), jw, 64, _layout(J, je, jspec.aggs, jw)


def test_compiled_fused_close_and_changelog_match_the_reference():
    """The bundle's fused close, peek, reset and changelog callables
    against the reference's, on the packed step's state."""
    jspec, tspec, jf, tf, jstate, tstate = run_packed("nulls", seed=9)
    slots = tl.pad_slots([2, 0])
    jpeek = np.asarray(jf.extract_slots(jstate, slots))
    tpeek = tf.extract_slots(tstate, slots).numpy()
    np.testing.assert_array_equal(tpeek[:, :2], jpeek[:, :2])
    jstate, jtouched = jf.extract_touched(jstate)
    tstate2, ttouched = tf.extract_touched(tstate)
    assert tstate2 is tstate
    jt, tt = np.asarray(jtouched), ttouched.numpy()
    np.testing.assert_array_equal(tt[:3], jt[:3])
    jstate, jpacked = jf.extract_reset_slots(jstate, slots)
    tstate2, tpacked = tf.extract_reset_slots(tstate, slots)
    assert tstate2 is tstate
    for p in range(len(slots)):
        np.testing.assert_array_equal(tpacked[p, :2].numpy(),
                                      np.asarray(jpacked)[p, :2])
        assert_rows(jspec, np.asarray(jpacked)[p, 2:], tpacked[p, 2:].numpy())
    assert_states(jspec, jstate, tstate)
    jstate = jf.reset_slots(jstate, tl.pad_slots([1]))
    assert tf.reset_slots(tstate, tl.pad_slots([1])) is tstate
    assert_states(jspec, jstate, tstate)


# ---- the executor's per-slot close against the reference's ---------------

def make_pair(aggs, window, having=None, post=None, fused_ok=False,
              emit_changes=False):
    out = []
    for m, e, extra in ((J, je, {}), (T, te, {"device": "cpu"})):
        schema = m.Schema.of(device=m.ColumnType.STRING,
                             temp=m.ColumnType.FLOAT)
        node = m.AggregateNode(
            child=m.SourceNode("s", schema), group_keys=[e.Col("device")],
            window=window(m), aggs=list(aggs(m, e)),
            having=None if having is None else having(e),
            post_projections=[] if post is None else post(e))
        ex = m.QueryExecutor(node, schema, emit_changes=emit_changes,
                             initial_keys=8, batch_capacity=256, **extra)
        ex._fused_close_ok = fused_ok
        out.append(ex)
    return out


def gen(n, n_keys=6, span_ms=35_000, seed=0):
    rng = np.random.default_rng(seed)
    rows = [{"device": f"d{int(k)}", "temp": float(t)}
            for k, t in zip(rng.integers(0, n_keys, n),
                            rng.normal(10, 4, n).astype(np.float32))]
    ts = [BASE + int(t) for t in np.sort(rng.integers(0, span_ms, n))]
    return rows, ts


def run_per_slot(aggs, window, *, n=500, seed=1, having=None, post=None):
    """The JAX executor and the port on the per-slot close, and a fused
    port twin; returns (JAX rows, port rows, fused port rows, port)."""
    jex, tex = make_pair(aggs, window, having, post)
    _, fex = make_pair(aggs, window, having, post, fused_ok=True)
    rows, ts = gen(n, seed=seed)
    closer = [{"device": "d0", "temp": 0.0}], [BASE + 200_000]
    outs = ([], [], [])
    for i in list(range(0, n, 200)) + [None]:
        batch = closer if i is None else (rows[i:i + 200], ts[i:i + 200])
        for ex, out in zip((jex, tex, fex), outs):
            out.extend(ex.process(*batch))
    return (*outs, tex)


def by_key(rows):
    return {(r["device"], r.get("winStart")): r for r in rows}


def assert_rows_equal(want, got):
    assert len(got) == len(want) > 0
    kw, kg = by_key(want), by_key(got)
    assert set(kw) == set(kg)
    for key, w in kw.items():
        g = kg[key]
        assert set(g) == set(w), key
        for name, v in w.items():
            if isinstance(v, float):
                assert g[name] == pytest.approx(v, rel=1e-6), (key, name)
            else:
                assert g[name] == pytest.approx(v), (key, name)


def _count(m, e):
    return m.AggSpec(m.AggKind.COUNT_ALL, "cnt")


def _col_agg(kind, name, **kw):
    return lambda m, e: m.AggSpec(m.AggKind[kind], name,
                                  input=e.Col("temp"), **kw)


PER_SLOT = {
    "tumbling": (lambda m, e: [_count(m, e), _col_agg("SUM", "total")(m, e),
                               _col_agg("MIN", "mn")(m, e),
                               _col_agg("AVG", "avg")(m, e)],
                 lambda m: m.TumblingWindow(10_000, grace_ms=0),
                 dict(n=500, seed=1)),
    "hopping_multi_due": (lambda m, e: [
        _count(m, e), _col_agg("SUM", "total")(m, e),
        _col_agg("APPROX_COUNT_DISTINCT", "u")(m, e)],
        lambda m: m.HoppingWindow(20_000, 5_000, grace_ms=0),
        dict(n=800, seed=2)),
    "having_and_projection": (
        lambda m, e: [_count(m, e)],
        lambda m: m.TumblingWindow(10_000, grace_ms=0),
        dict(n=300, seed=3,
             having=lambda e: e.BinOp(">=", e.Col("cnt"), e.Lit(2)),
             post=lambda e: [("device", e.Col("device")),
                             ("doubled", e.BinOp("*", e.Col("cnt"),
                                                 e.Lit(2)))])),
    "topk": (lambda m, e: [_count(m, e),
                           _col_agg("TOPK", "top3", k=3)(m, e)],
             lambda m: m.TumblingWindow(10_000, grace_ms=0),
             dict(n=400, seed=5)),
}


@pytest.mark.parametrize("case", list(PER_SLOT))
def test_per_slot_close_matches_the_reference_executor(case):
    """test_close_batched.py's per-slot equivalence cases: the port's
    per-slot close gives the JAX executor's per-slot rows and the port's
    fused rows, two launches per window, one fetch per window."""
    aggs, window, kw = PER_SLOT[case]
    want, got, fused, tex = run_per_slot(aggs, window, **kw)
    assert_rows_equal(want, got)
    assert_rows_equal(got, fused)
    assert [r.get("winStart") for r in got] == \
        [r.get("winStart") for r in want]
    st = tex.close_stats
    n_windows = len({r["winStart"] for r in got})
    assert st["close_dispatches"] >= 2 * n_windows > 0
    assert st["close_dispatches"] % 2 == 0
    assert st["close_fetches"] == st["close_dispatches"] // 2
    if case == "hopping_multi_due":  # several windows per close cycle
        assert st["close_fetches"] > st["close_cycles"]
    if case == "having_and_projection":
        assert all("doubled" in r and "winStart" in r for r in got)


def test_per_slot_close_in_emit_changes_mode_resets_without_fetch():
    jex, tex = make_pair(lambda m, e: [_count(m, e)],
                         lambda m: m.TumblingWindow(10_000, grace_ms=0),
                         emit_changes=True)
    rows, ts = gen(120, seed=7)
    closer = ([{"device": "d0", "temp": 1.0}], [BASE + 200_000])
    want = jex.process(rows, ts) + jex.process(*closer)
    got = list(tex.process(rows, ts)) + list(tex.process(*closer))
    assert_rows_equal(want, got)
    st = tex.close_stats
    assert st["close_fetches"] == 0
    assert st["close_dispatches"] >= st["close_cycles"] > 0  # resets only
    assert int(tex.state["count"].sum()) == 1


def test_failed_fused_close_raises_and_keeps_the_fused_path(monkeypatch):
    """No automatic degrade: a failed fused close raises, the per-slot
    close is not taken, and _fused_close_ok stays True."""
    _jex, tex = make_pair(lambda m, e: [_count(m, e)],
                          lambda m: m.TumblingWindow(10_000, grace_ms=0),
                          fused_ok=True)
    rows, ts = gen(100, seed=8)
    tex.process(rows, ts)

    def boom(*_a):
        raise RuntimeError("fused_close kernel launch failed")

    monkeypatch.setattr(tex, "_extract_reset_slots", boom)
    monkeypatch.setattr(tex, "_extract_slot", boom)
    with pytest.raises(RuntimeError, match="fused_close"):
        tex.process([{"device": "d0", "temp": 0.0}], [BASE + 200_000])
    assert tex._fused_close_ok is True
    assert tex.device_fallbacks == 0


def test_executor_programs_follow_key_growth():
    """_grow_keys recompiles: the close programs take the new K."""
    _jex, tex = make_pair(lambda m, e: [_count(m, e)],
                          lambda m: m.TumblingWindow(10_000, grace_ms=0))
    rows = [{"device": f"k{i}", "temp": 1.0} for i in range(20)]
    tex.process(rows, [BASE + i for i in range(20)])
    assert tex.spec.n_keys == 32
    out = tex.process([{"device": "k0", "temp": 1.0}], [BASE + 50_000])
    assert len(out) == 20 and all(r["cnt"] == 1 for r in out)
    assert convert.state_to_numpy(tex.state)["count"].shape[0] == 32
