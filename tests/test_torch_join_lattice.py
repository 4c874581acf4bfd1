"""The port's interval-join programs (hstream_tpu_torch/engine/
join_lattice.py) against the JAX package's (hstream_tpu/engine/lattice.py
join kernels) on JAX's CPU backend, on the same numpy inputs.

The port's functions here are the plain PyTorch versions the CUDA kernels
are held against on the card (chip_smoke.py). Tolerances: bounds, match
buffers and every store plane bit-exact; the fused step's integer planes
(count, COUNT(col), slot_start, touched) exact and its float planes (SUM,
MIN, MAX) exact too, because its inputs are multiples of 1/4 in a small
range, so every summation order gives the same float32 sum. Every store
a program returns must stay sorted by (code, ts), the invariant the
kernels rely on; the plain merge and the plain compaction (what the
kernels compute) equal the plain sorts they replace.

Inputs are awkward on purpose: equal (code, ts) runs across store and
batch, dead-but-resident entries below the cutoff, evicted sentinel slots
that kept their flags and columns, negative relative times, n = 0, three
columns with null and present bits on both sides, and feed sources "m",
"o", "both" and "both_o" with a filter-NULL column.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hstream_tpu.engine import lattice as JL
from hstream_tpu_torch.engine import convert
from hstream_tpu_torch.engine import join_lattice as jl
from torch_parity import JM, TM

SENT = jl.JOIN_SENT_CODE
WITHIN = 25


def store_np(rng, cap: int, n_cols: int, n_live: int, codes: int = 6):
    """A sorted store: n_live entries over few codes and a narrow ts range
    (equal (code, ts) runs), then sentinel slots (SENT, 0) that keep
    random flags and columns, as evicted entries do."""
    code = np.full(cap, SENT, np.int32)
    ts = np.zeros(cap, np.int32)
    c = rng.integers(0, codes, n_live)
    t = rng.integers(-60, 120, n_live)
    o = np.lexsort((t, c))
    code[:n_live], ts[:n_live] = c[o], t[o]
    flags = rng.integers(0, 1 << 28, cap).astype(np.int32)
    cols = value_bits(rng, n_cols, cap)
    return {"code": code, "ts": ts, "flags": flags, "cols": cols}


def value_bits(rng, n_cols: int, n: int) -> np.ndarray:
    """int32 [n_cols, n] column planes of f32 bits: column 0 multiples of
    1/4 (a few NaN and inf), column 1 small integers, column 2 0.0 / 1.0.
    (No subnormals: XLA's CPU backend flushes them to zero, the port's
    plain versions and CUDA kernels keep them.)"""
    out = np.zeros((n_cols, n), np.int32)
    for c in range(n_cols):
        if c % 3 == 0:
            v = (rng.integers(-8, 24, n) / 4).astype(np.float32)
            v[rng.random(n) < 0.03] = np.nan
            v[rng.random(n) < 0.02] = np.inf
            out[c] = v.view(np.int32)
        elif c % 3 == 1:
            out[c] = rng.integers(-50, 50, n).astype(np.float32) \
                .view(np.int32)
        else:
            out[c] = rng.integers(0, 2, n).astype(np.float32) \
                .view(np.int32)
    return out


def batch_np(rng, bcap: int, n: int, n_cols: int, codes: int = 6,
             n_keys: int = 8) -> np.ndarray:
    """A batch sorted by (code, ts), padded with (SENT, 0) and zeros."""
    buf = np.zeros((4 + n_cols, bcap), np.int32)
    c = rng.integers(0, codes, n)
    t = rng.integers(-60, 150, n)
    o = np.lexsort((t, c))
    buf[0, :n], buf[1, :n] = c[o], t[o]
    buf[0, n:] = SENT
    buf[2, :n] = rng.integers(0, n_keys, n)
    buf[3, :n] = rng.integers(0, 1 << 28, n)
    buf[4:, :n] = value_bits(rng, n_cols, n)
    return buf


def to_t(st):
    return {k: torch.from_numpy(np.array(v)) for k, v in st.items()}


def to_j(st):
    return {k: jnp.asarray(v) for k, v in st.items()}


def assert_store_equal(want, got, what=""):
    for k in ("code", "ts", "flags", "cols"):
        assert np.array_equal(np.asarray(want[k]), got[k].numpy()), (what, k)


def assert_sorted(st):
    assert jl.store_sorted(st)


CASES = [  # (cap, bcap, n, n_cols_mine, n_cols_other, match_cap, cutoff)
    (64, 16, 10, 3, 3, 256, -(1 << 31)),
    (64, 16, 16, 3, 3, 8, -(1 << 31)),       # truncated: total > match_cap
    (256, 64, 50, 3, 0, 512, 0),             # dead entries below cutoff
    (256, 64, 0, 0, 3, 64, -10),             # n = 0: every record padding
    (1024, 256, 200, 2, 1, 4096, -30),
]


@pytest.mark.parametrize("seed", [0, 1])
def test_bounds_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    st = store_np(rng, 128, 0, 90)
    q = batch_np(rng, 40, 33, 0)
    lo_ts = q[1] - WITHIN
    hi_ts = q[1] + WITHIN
    qcode = np.where(np.arange(40) < 33, q[0], SENT).astype(np.int32)
    want = JL._join_bounds(jnp.asarray(st["code"]), jnp.asarray(st["ts"]),
                           jnp.asarray(qcode), jnp.asarray(lo_ts),
                           jnp.asarray(hi_ts))
    got = jl._join_bounds(*(torch.from_numpy(x) for x in (
        st["code"], st["ts"], qcode, lo_ts, hi_ts)))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    # and they are what two binary searches per query give
    key = st["code"].astype(np.int64) * (1 << 32) + st["ts"] + (1 << 31)
    lo = np.searchsorted(key, qcode.astype(np.int64) * (1 << 32)
                         + lo_ts + (1 << 31), "left")
    hi = np.searchsorted(key, qcode.astype(np.int64) * (1 << 32)
                         + hi_ts + (1 << 31), "right")
    assert np.array_equal(lo, got[0].numpy())
    assert np.array_equal(hi, got[1].numpy())


@pytest.mark.parametrize("case", CASES)
def test_probe_insert_and_probe_only_match_the_reference(case):
    cap, bcap, n, nm, no, mc, cutoff = case
    rng = np.random.default_rng(cap + n)
    mine = store_np(rng, cap, nm, cap // 3)
    other = store_np(rng, cap, no, cap // 2)
    b = batch_np(rng, bcap, n, nm)
    kern = JL.join_probe_insert(cap, bcap, mc, nm, no)
    wm, wp = kern(to_j(mine), to_j(other), jnp.asarray(b), np.int32(n),
                  np.int32(WITHIN), np.int32(cutoff))
    gm, gp = jl.join_probe_insert(to_t(mine), to_t(other),
                                  torch.from_numpy(b), n, WITHIN, cutoff, mc,
                                  nm)
    assert np.array_equal(np.asarray(wp), gp.numpy())
    assert_store_equal(wm, gm, "insert")
    assert_sorted(gm)
    total = int(gp[0, 0])
    if case[5] == 8:
        assert total > mc  # the true total beyond the buffer
    wide = JL.join_probe_only(cap, bcap, max(mc, 1 << 12), nm, no)(
        to_j(other), jnp.asarray(b), np.int32(n), np.int32(WITHIN),
        np.int32(cutoff))
    got = jl.join_probe_only(to_t(other), torch.from_numpy(b), n, WITHIN,
                             cutoff, max(mc, 1 << 12), nm)
    assert np.array_equal(np.asarray(wide), got.numpy())
    t2, kid, *_ = jl.unpack_join_matches(got.numpy(), nm)
    assert t2 == total and len(kid) == total


@pytest.mark.parametrize("case", CASES)
def test_merge_equals_the_sorting_insert(case):
    """csrc/join_insert.cu's merge (insert_merge_ref) is the reference's
    stable sort of store ++ batch when both runs are sorted."""
    cap, bcap, n, nm, *_ = case
    rng = np.random.default_rng(7 + n)
    mine = to_t(store_np(rng, cap, nm, cap // 2))
    b = torch.from_numpy(batch_np(rng, bcap, n, nm))
    want = jl.join_insert_ref(mine, b, n, nm)
    got = jl.insert_merge_ref(mine, b, n, nm)
    for k in want:
        assert torch.equal(want[k], got[k]), k
    assert_sorted(got)


EVICTS = [(0, 0), (40, 0), (40, 37), (-20, -100), (-(1 << 31), 5)]


@pytest.mark.parametrize("cutoff,delta", EVICTS)
def test_evict_matches_the_reference_and_the_compaction(cutoff, delta):
    rng = np.random.default_rng(cutoff & 0xFF)
    cap = 256
    left = store_np(rng, cap, 3, 170)
    right = store_np(rng, cap, 1, 90)
    wl, wr, wn = JL.join_evict(cap, 3, 1)(to_j(left), to_j(right),
                                          np.int32(cutoff), np.int32(delta))
    gl, gr, gn = jl.join_evict(to_t(left), to_t(right), cutoff, delta)
    assert_store_equal(wl, gl, "left")
    assert_store_equal(wr, gr, "right")
    assert np.array_equal(np.asarray(wn), gn.numpy())
    cl, cr, cn = jl.evict_compact_ref(to_t(left), to_t(right), cutoff, delta)
    for want, got in ((gl, cl), (gr, cr)):
        for k in want:
            assert torch.equal(want[k], got[k]), k
        assert_sorted(got)
    assert torch.equal(gn, cn)


def test_remap_with_the_sentinel_flag_matches_the_reference():
    """The join's code remap (session_remap with sent_above): codes below
    the table map through it, codes at or above it (the sentinel among
    them) become the sentinel, as join.py:2092-2108 computes."""
    from hstream_tpu_torch.engine import session_lattice as sl

    code = np.array([0, 1, 1, 3, 6, 9, SENT, SENT], np.int32)
    table = np.array([0, 1, -1, 2, 3, 4, 5], np.int32)
    live = code < len(table)
    want = np.where(live, table[np.where(live, code, 0)], SENT)
    st = {"code": torch.from_numpy(code.copy())}
    sl.session_remap(st, torch.from_numpy(table), sent_above=True)
    assert np.array_equal(st["code"].numpy(), want)
    plain = {"code": torch.from_numpy(code.copy())}
    sl.session_remap(plain, torch.from_numpy(table))
    assert np.array_equal(plain["code"].numpy(),
                          np.where(live, want, code))


# ---- the fused probe + window step ------------------------------------------

def _inner(m, where: bool):
    """An inner plan over the joined columns a (f32), b (f32 of ints) and
    c (f32 of 0/1): COUNT(*), SUM(a), MIN(b), MAX(c), COUNT(c), grouped by
    k over TUMBLE(100 ms); WHERE a > 0 optionally."""
    schema = m.Schema.of(k=m.ColumnType.STRING, a=m.ColumnType.FLOAT,
                         b=m.ColumnType.FLOAT, c=m.ColumnType.FLOAT)
    child = m.SourceNode("s", schema)
    if where:
        child = m.FilterNode(child, m.BinOp(">", m.Col("a"), m.Lit(0.0)))
    A, S = m.AggKind, m.AggSpec
    node = m.AggregateNode(
        child=child, group_keys=[m.Col("k")],
        window=m.TumblingWindow(100, grace_ms=0),
        aggs=[S(A.COUNT_ALL, "n"), S(A.SUM, "s", input=m.Col("a")),
              S(A.MIN, "lo", input=m.Col("b")),
              S(A.MAX, "hi", input=m.Col("c")),
              S(A.COUNT, "nc", input=m.Col("c"))])
    return node, schema


FEEDS = {
    # column a from the batch, b from the store, c bare (left precedence)
    # with the batch as the SQL left side ("both") or the store ("both_o")
    "left": (("a", "f32", "m", 0, -1), ("b", "f32", "o", -1, 1),
             ("c", "f32", "both", 2, 2)),
    "right": (("a", "f32", "o", -1, 0), ("b", "f32", "m", 1, -1),
              ("c", "f32", "both_o", 2, 2)),
}


def _feed(name: str, ex, where: bool):
    feed = FEEDS[name]
    src = {f[0]: f[2:] for f in feed}
    nulls = tuple((key, tuple(src[c] for c in refs))
                  for key, refs in ex._null_specs)
    filt = (src["a"],) if where else ()
    return feed, nulls, filt


@pytest.mark.parametrize("where", [False, True])
@pytest.mark.parametrize("feed_name", ["left", "right"])
@pytest.mark.parametrize("case", [(256, 64, 50, 512, -30),
                                  (64, 16, 16, 4, -(1 << 31)),
                                  (64, 16, 0, 64, 0)])
def test_fused_step_matches_the_reference(case, feed_name, where):
    cap, bcap, n, mc, cutoff = case
    nm = no = 3
    rng = np.random.default_rng(n + len(feed_name) + where)
    jex = JM.QueryExecutor(*_inner(JM, where), initial_keys=8)
    tex = TM.QueryExecutor(*_inner(TM, where), initial_keys=8, device="cpu")
    feed = _feed(feed_name, jex, where)
    assert feed == _feed(feed_name, tex, where)
    mine = store_np(rng, cap, nm, cap // 3)
    other = store_np(rng, cap, no, cap // 2)
    b = batch_np(rng, bcap, n, nm)
    state0 = {k: np.asarray(v) for k, v in jex.state.items()}
    tstate = convert.state_from_numpy(state0, "cpu")
    wm_rel, ts_off = 120, 300
    kern = JL.join_probe_insert_step(cap, bcap, mc, nm, no, jex.spec,
                                     jex.schema, jex._filter_expr, *feed)
    wmine, wstate, wtotal = kern(
        to_j(mine), to_j(other), jnp.asarray(b), np.int32(n),
        np.int32(WITHIN), np.int32(cutoff), jex.state, np.int32(wm_rel),
        np.int32(ts_off))
    gmine, gtotal = jl.join_probe_insert_step(
        to_t(mine), to_t(other), torch.from_numpy(b), n, WITHIN, cutoff, mc,
        nm, tex.spec, tstate, wm_rel, ts_off, tex._progs, feed)
    assert int(wtotal) == int(gtotal)
    assert_store_equal(wmine, gmine, "insert")
    assert_sorted(gmine)
    assert set(wstate) == set(tstate)
    for k, v in wstate.items():
        w = np.asarray(v)
        g = tstate[k].numpy()
        assert np.array_equal(w, g), k   # exact: see the module note
    assert int(np.asarray(wstate["count"]).sum()) > 0 or n == 0 or \
        int(wtotal) == 0


def test_feed_resolves_every_source_like_the_reference():
    """The feed columns themselves (the inputs the card's step receives),
    against the reference's _join_match_feed, both layouts."""
    rng = np.random.default_rng(3)
    cap, bcap, n, mc = 128, 32, 30, 256
    mine = store_np(rng, cap, 3, 0)
    other = store_np(rng, cap, 3, 100)
    b = batch_np(rng, bcap, n, 3)
    for name in FEEDS:
        feed = (FEEDS[name], (("__null_a1", (FEEDS[name][0][2:],
                                             FEEDS[name][2][2:])),),
                (FEEDS[name][1][2:],))
        want = JL._join_match_feed(to_j(other), jnp.asarray(b), n, WITHIN,
                                   -10, bcap, mc, *feed)
        got = jl._join_match_feed(to_t(other), torch.from_numpy(b), n,
                                  WITHIN, -10, mc, *feed)
        assert int(want[0]) == got[0]
        for w, g in zip(want[1:4], got[1:4]):
            assert np.array_equal(np.asarray(w), g.numpy())
        for k, v in want[4].items():
            w = np.asarray(v)
            g = got[4][k].numpy()
            if w.dtype == np.float32:
                assert np.array_equal(w.view(np.int32), g.view(np.int32)), k
            else:
                assert np.array_equal(w, g), k
        assert int(np.asarray(want[3]).sum()) < int(want[0])  # some masked
    del mine
