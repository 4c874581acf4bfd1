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

The kernels' plans are modelled in numpy and held against the plain
probe and insert on small random sorted cases: the probe's bounds per
tile of records against a store window (staged, in global memory, and
the whole store where ts -+ within wraps int32), the matches' load-
balanced expansion, the merge-path insert, and the eviction's tiles
(live entries after a look-back, dead ones after the side's total),
the last also against the reference's join_evict; with the kernels'
tile sizes and with tiles so small that a key's store run and a
record's matches span several of them.

Inputs are awkward on purpose: equal (code, ts) runs across store and
batch, dead-but-resident entries below the cutoff, evicted sentinel slots
that kept their flags and columns, subnormal column bits (one case),
negative relative times, n = 0, three columns with null and present bits
on both sides, and feed sources "m", "o", "both" and "both_o" with a
filter-NULL column.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hstream_tpu.engine import lattice as JL
from hstream_tpu_torch.engine import convert
from hstream_tpu_torch.engine import join_lattice as jl
from hstream_tpu_torch.engine.kernels import binding as kb
from torch_parity import JM, TM

SENT = jl.JOIN_SENT_CODE
WITHIN = 25


def store_np(rng, cap: int, n_cols: int, n_live: int, codes: int = 6,
             subnormals: bool = False):
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
    cols = value_bits(rng, n_cols, cap, subnormals)
    return {"code": code, "ts": ts, "flags": flags, "cols": cols}


SUBNORMAL_BITS = np.array([1, 0x80000001, 0x000FFFFF, 0x807FFFFF, 0,
                           0x80000000], np.uint32).view(np.int32)


def value_bits(rng, n_cols: int, n: int,
               subnormals: bool = False) -> np.ndarray:
    """int32 [n_cols, n] column planes of f32 bits: column 0 multiples of
    1/4 (a few NaN and inf), column 1 small integers, column 2 0.0 / 1.0;
    with `subnormals`, a sixth of every column the bits of subnormals of
    both signs and of +-0.0 (the port flushes them where the reference
    does)."""
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
        if subnormals:
            out[c, ::6] = SUBNORMAL_BITS[rng.integers(
                0, len(SUBNORMAL_BITS), out[c, ::6].shape[0])]
    return out


def batch_np(rng, bcap: int, n: int, n_cols: int, codes: int = 6,
             n_keys: int = 8, subnormals: bool = False) -> np.ndarray:
    """A batch sorted by (code, ts), padded with (SENT, 0) and zeros."""
    buf = np.zeros((4 + n_cols, bcap), np.int32)
    c = rng.integers(0, codes, n)
    t = rng.integers(-60, 150, n)
    o = np.lexsort((t, c))
    buf[0, :n], buf[1, :n] = c[o], t[o]
    buf[0, n:] = SENT
    buf[2, :n] = rng.integers(0, n_keys, n)
    buf[3, :n] = rng.integers(0, 1 << 28, n)
    buf[4:, :n] = value_bits(rng, n_cols, n, subnormals)
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


def _below(lane: int) -> int:
    return (1 << lane) - 1


def evict_model(st, cutoff: int, delta: int, threads: int, per: int):
    """csrc/join_evict.cu's plan in numpy, one side: tiles of threads x
    per entries, entry r * threads + t of a tile on thread t. (1) Tile by
    tile in ticket order: per (round, warp) a ballot of the live lanes
    (code < SENT and ts >= cutoff), its count scanned round by round; the
    tile's live prefix summed from its predecessors' counts (the
    look-back); each live entry placed at that prefix + its (round, warp)
    scan + the live lanes below it; the ballots and the prefix kept.
    (2) Once the side's total is known, each tile's dead entries from
    its kept ballots, placed at the total + the entries before the tile
    less its live prefix + their own scan + the dead lanes below.
    Returns the evicted store and the live count."""
    code, ts = st["code"], st["ts"]
    cap = code.shape[0]
    tile_n, warps = threads * per, threads // 32
    tiles = -(-cap // tile_n)
    out = {k: np.full_like(v, -7) for k, v in st.items()}

    def rounds(tile):
        for r in range(per):
            for w in range(warps):
                yield r, w, tile * tile_n + r * threads + w * 32

    def popc(x: int) -> int:
        return bin(x).count("1")

    def place(masks: dict, start: int, tile: int, live: bool):
        run = 0
        for r, w, i0 in rounds(tile):
            m = masks[r, w]
            for lane in range(32):
                if not m >> lane & 1:
                    continue
                i = i0 + lane
                pos = start + run + popc(m & _below(lane))
                if live:
                    out["code"][pos] = code[i]
                    out["ts"][pos] = np.int32(
                        (int(ts[i]) - delta + (1 << 31)) % (1 << 32)
                        - (1 << 31))
                else:
                    out["code"][pos], out["ts"][pos] = SENT, 0
                out["flags"][pos] = st["flags"][i]
                out["cols"][:, pos] = st["cols"][:, i]
            run += popc(m)
        return run

    counts, kept = {}, {}
    for tile in range(tiles):   # (1)
        ballots = {}
        for r, w, i0 in rounds(tile):
            ballots[r, w] = sum(
                1 << lane for lane in range(32)
                if i0 + lane < cap and code[i0 + lane] < SENT
                and ts[i0 + lane] >= cutoff)
        off = sum(counts[k] for k in range(tile))   # the look-back
        counts[tile] = place(ballots, off, tile, True)
        kept[tile] = (ballots, off)
    n_live = sum(counts.values())
    for tile in range(tiles):   # (2)
        ballots, off = kept[tile]
        dead = {(r, w): ((1 << min(max(cap - i0, 0), 32)) - 1)
                & ~ballots[r, w] for r, w, i0 in rounds(tile)}
        place(dead, n_live + tile * tile_n - off, tile, False)
    return out, n_live


# name -> (cap, live entries left, right, cutoff): every slot live, every
# entry dead (all below the cutoff), no entry resident, a store below one
# tile, not a multiple of the tile, over many tiles
EVICT_PLANS = {
    "all live": (3000, 3000, 3000, -(1 << 31)),
    "all dead": (3000, 2000, 1000, 1 << 20),
    "none resident": (3000, 0, 0, 40),
    "below a tile": (100, 60, 30, 40),
    "not a multiple": (2 * 2048 + 37, 3000, 1500, 40),
    "many tiles": (9 * 2048 + 5, 12000, 6000, 40),
}


@pytest.mark.parametrize("tiles", ["kernel", "small"])
@pytest.mark.parametrize("delta", [0, 37, -100])
@pytest.mark.parametrize("name", list(EVICT_PLANS))
def test_evict_plan_model_matches_the_reference(name, delta, tiles):
    """The eviction kernel's tiles (kb.JOIN_EVICT_THREADS x
    JOIN_EVICT_PER, or 32 x 2 so that small stores span many) give
    join_evict_ref's stores and live counts and the reference's
    join_evict(cap, ...) bit for bit."""
    cap, nl, nr, cutoff = EVICT_PLANS[name]
    threads, per = ((kb.JOIN_EVICT_THREADS, kb.JOIN_EVICT_PER)
                    if tiles == "kernel" else (32, 2))
    rng = np.random.default_rng(cap + nl)
    left = store_np(rng, cap, 3, nl)
    right = store_np(rng, cap, 1, nr)
    wl, wr, wn = JL.join_evict(cap, 3, 1)(to_j(left), to_j(right),
                                          np.int32(cutoff), np.int32(delta))
    gl, gr, gn = jl.join_evict_ref(to_t(left), to_t(right), cutoff, delta)
    for side, (st, want, plain) in enumerate(((left, wl, gl),
                                              (right, wr, gr))):
        got, n_live = evict_model(st, cutoff, delta, threads, per)
        assert n_live == int(np.asarray(wn)[side]) == int(gn[side])
        for k in ("code", "ts", "flags", "cols"):
            assert np.array_equal(got[k], np.asarray(want[k])), (side, k)
            assert np.array_equal(got[k], plain[k].numpy()), (side, k)
    if name == "all dead":
        assert int(gn.sum()) == 0
    if name == "all live":
        assert int(gn.sum()) == 2 * cap


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
    fused_step_case(case, feed_name, where)


@pytest.mark.parametrize("where", [False, True])
@pytest.mark.parametrize("feed_name", ["left", "right"])
def test_fused_step_flushes_subnormals_as_the_reference(feed_name, where):
    """Subnormal column bits on both sides (ROADMAP C, fixed in the port):
    the feed moves their bits as they are, the inner step's SUM, MIN and
    MAX and the WHERE comparison take them as zeros of their sign. Once
    MAX of the bit pattern 1 was 1e-45 in the port and 0.0 in the
    reference."""
    fused_step_case((256, 64, 60, 1024, -30), feed_name, where,
                    subnormals=True)


def fused_step_case(case, feed_name, where, subnormals=False):
    cap, bcap, n, mc, cutoff = case
    nm = no = 3
    rng = np.random.default_rng(n + len(feed_name) + where)
    jex = JM.QueryExecutor(*_inner(JM, where), initial_keys=8)
    tex = TM.QueryExecutor(*_inner(TM, where), initial_keys=8, device="cpu")
    feed = _feed(feed_name, jex, where)
    assert feed == _feed(feed_name, tex, where)
    mine = store_np(rng, cap, nm, cap // 3, subnormals=subnormals)
    other = store_np(rng, cap, no, cap // 2, subnormals=subnormals)
    b = batch_np(rng, bcap, n, nm, subnormals=subnormals)
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


# ---- numpy models of the kernels' plans (csrc/join_core.cuh, join_insert.cu)

def _key(code, ts):
    return np.asarray(code, np.int64) * (1 << 32) + (
        np.asarray(ts, np.int64) + (1 << 31))


def partition(lo: int, hi: int, pred) -> int:
    """warp_partition: the first i in [lo, hi) where pred is false (pred
    true on a prefix), by 32 probes a step."""
    while hi - lo > 32:
        probes = [lo + (hi - lo) * (k + 1) // 33 for k in range(32)]
        t = [pred(p) for p in probes]
        k = sum(t)
        assert t == [True] * k + [False] * (32 - k)  # a prefix
        if k > 0:
            lo = probes[k - 1] + 1
        if k < 32:
            hi = probes[k]
    return lo + sum(pred(p) for p in range(lo, hi))


def merge_model(skey, bkey, cap: int, tile: int = 2048, per: int = 8):
    """join_insert.cu: each block's split of the two runs by a diagonal
    search (the store first on equal keys), each thread's split of the
    staged runs and its `per` places. Returns the sources of the first
    `cap` places: i >= 0 a store entry, -1 - j a batch entry."""
    na, nb = len(skey), len(bkey)
    out = []
    for d0 in range(0, cap, tile):
        d1 = min(d0 + tile, cap)

        def split(d, lo=0):
            return partition(max(lo, d - nb), min(d, na),
                             lambda i: skey[i] <= bkey[d - 1 - i])
        i0 = split(d0)
        i1 = split(d1, i0)
        j0, j1 = d0 - i0, d1 - i1
        a, b = skey[i0:i1], bkey[j0:j1]
        src = [None] * (d1 - d0)
        for dd in range(0, d1 - d0, per):
            lo, hi = max(0, dd - len(b)), min(dd, len(a))
            while lo < hi:
                mid = (lo + hi) // 2
                if a[mid] <= b[dd - 1 - mid]:
                    lo = mid + 1
                else:
                    hi = mid
            ia, ib = lo, dd - lo
            for k in range(per):
                if dd + k >= d1 - d0:
                    break
                if ia < len(a) and (ib >= len(b) or a[ia] <= b[ib]):
                    src[dd + k] = i0 + ia
                    ia += 1
                else:
                    src[dd + k] = -1 - (j0 + ib)
                    ib += 1
        out.extend(src)
    return np.array(out, np.int64)


def bounds_model(scode, sts, bcode, bts, n, within, cutoff, tile=256,
                 window=2048, branch=0):
    """probe_bounds_kernel: per tile of sorted records, the store window
    between its first valid record's lower key and its last one's upper
    key (branch 0: searched staged or in place alike; 1 in place; 2 or
    where a key wraps int32 or within < 0, the whole store). Returns
    (lo, cnt, ccnt, total, branches taken)."""
    cap, bcap = len(scode), len(bcode)
    skey = _key(scode, sts)
    lo = np.zeros(bcap, np.int64)
    cnt = np.zeros(bcap, np.int64)
    taken = []
    for t0 in range(0, bcap, tile):
        j = np.arange(t0, min(t0 + tile, bcap))
        valid = (j < n) & (bcode[j] < SENT)
        t = bts[j].astype(np.int64)
        lw, hw = t - within, t + within
        wraps = valid & ((lw < -(1 << 31)) | (lw >= 1 << 31)
                         | (hw < -(1 << 31)) | (hw >= 1 << 31))
        lts = np.maximum(((lw + (1 << 31)) % (1 << 32)) - (1 << 31), cutoff)
        hts = ((hw + (1 << 31)) % (1 << 32)) - (1 << 31)
        lkey, hkey = _key(bcode[j], lts), _key(bcode[j], hts)
        if not valid.any():
            taken.append("empty")
            continue
        if wraps.any() or within < 0 or branch == 2:
            wl, wh = 0, cap
            taken.append("whole")
        else:
            f, la = np.nonzero(valid)[0][[0, -1]]
            wl = partition(0, cap, lambda i: skey[i] < lkey[f])
            wh = partition(wl, cap, lambda i: skey[i] <= hkey[la])
            taken.append("staged" if branch == 0 and wh - wl <= window
                         else "window")
            # the window's bounds hold every record's (monotone keys)
            assert (lkey[valid][1:] >= lkey[valid][:-1]).all()
        win = skey[wl:wh]
        for q in np.nonzero(valid)[0]:
            l = wl + np.searchsorted(win, lkey[q], "left")
            h = wl + np.searchsorted(win, hkey[q], "right")
            lo[j[q]] = l
            cnt[j[q]] = max(h - l, 0)
    ccnt = np.cumsum(cnt)
    return lo, cnt, ccnt, int(ccnt[-1]) if bcap else 0, taken


def expand_model(lo, cnt, ccnt, total, match_cap, cap, n, tile=2048,
                 per=8):
    """probe_expand_kernel: the merged sequence of the first n records'
    ends (ccnt) and matches 0 .. mc - 1 cut into tiles; each tile's split
    from the bounds kernel's per-record splits (and equal to a diagonal
    search), each thread's by a search of the staged ends.
    Returns (rec, oidx, mvalid) over match_cap, the clip past the
    matches."""
    bcap = len(ccnt)
    nrec = min(n, bcap)
    mc = min(total, match_cap)
    rec = np.full(match_cap, bcap - 1, np.int64)
    oidx = np.zeros(match_cap, np.int64)
    seen = np.zeros(match_cap, np.int64)
    length = mc + nrec
    # probe_bounds_kernel's splits: record j ends at e = j + ccnt[j] of the
    # merged sequence and is the first to end at or past every tile
    # boundary in (e - 1 - cnt[j], e]; the boundaries past record n get n
    tiles_max = -(-(match_cap + bcap) // tile)
    split = np.full(tiles_max + 1, -1, np.int64)
    for j in range(nrec):
        e = j + int(ccnt[j])
        ep = e - 1 - int(cnt[j])
        for t in range(0 if ep < 0 else ep // tile + 1,
                       min(e // tile, tiles_max) + 1):
            split[t] = j
    e_last = nrec - 1 + (int(ccnt[nrec - 1]) if nrec else 0)
    split[(0 if e_last < 0 else e_last // tile + 1):] = nrec
    assert (split >= 0).all()
    for d0 in range(0, length, tile):
        d1 = min(d0 + tile, length)

        def ends_before(d, t):
            got = min(max(split[t], d - mc), min(d, nrec))
            assert got == partition(max(0, d - mc), min(d, nrec),
                                    lambda i: ccnt[i] <= d - 1 - i)
            return got
        r0 = ends_before(d0, d0 // tile)
        r1 = nrec if d1 == length else ends_before(d1, d0 // tile + 1)
        m0, m1 = d0 - r0, d1 - r1
        if m1 == m0:
            continue  # record ends only
        ends = ccnt[r0:r1]
        na, nb = r1 - r0, m1 - m0
        for dd in range(0, na + nb, per):
            lo_, hi_ = max(0, dd - nb), min(dd, na)
            while lo_ < hi_:
                mid = (lo_ + hi_) // 2
                if ends[mid] <= m0 + dd - 1 - mid:
                    lo_ = mid + 1
                else:
                    hi_ = mid
            i, m = lo_, dd - lo_
            for _ in range(per):
                if i + m >= na + nb:
                    break
                if i < na and (m >= nb or ends[i] <= m0 + m):
                    i += 1
                    continue
                r = r0 + i
                rec[m0 + m] = r
                oidx[m0 + m] = min(max(lo[r] + m0 + m - (ccnt[r] - cnt[r]),
                                       0), cap - 1)
                seen[m0 + m] += 1
                m += 1
    assert (seen[:mc] == 1).all() and not seen[mc:].any()
    return rec, oidx, np.arange(match_cap) < mc


def _sorted_store(rng, cap, n_live, codes, ts_lo, ts_hi, run=0):
    code = np.full(cap, SENT, np.int32)
    ts = np.zeros(cap, np.int32)
    c = rng.integers(0, codes, n_live)
    if run:  # one key with a long run of entries
        c[:run] = 0
    t = rng.integers(ts_lo, ts_hi, n_live, dtype=np.int64)
    o = np.lexsort((t, c))
    code[:n_live], ts[:n_live] = c[o], t[o]
    return code, ts


def _sorted_batch(rng, bcap, n, codes, ts_lo, ts_hi):
    bc = np.full(bcap, SENT, np.int32)
    bt = np.zeros(bcap, np.int32)
    c = rng.integers(0, codes, n)
    t = rng.integers(ts_lo, ts_hi, n, dtype=np.int64)
    o = np.lexsort((t, c))
    bc[:n], bt[:n] = c[o], t[o]
    return bc, bt


PLAN_CASES = {  # cap, live, bcap, n, codes, ts range, within, cutoff, run
    "plain": (300, 200, 120, 100, 8, (-60, 120), 25, -(1 << 31), 0),
    "long run": (400, 390, 64, 60, 4, (-30, 30), 10, -40, 300),
    "wraps": (200, 150, 80, 70, 3, (-(1 << 31), (1 << 31) - 1), 1 << 30,
              -(1 << 31), 0),
    "near the ends": (200, 150, 80, 70, 3, ((1 << 31) - 50, (1 << 31) - 1),
                      40, -(1 << 31), 0),
    "all sentinel": (128, 0, 64, 50, 5, (0, 50), 5, 0, 0),
    "n = 0": (128, 90, 64, 0, 5, (0, 50), 5, 0, 0),
    "equal keys": (256, 250, 128, 128, 2, (0, 3), 1, -(1 << 31), 0),
}


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
@pytest.mark.parametrize("tiles", ["kernel", "small"])
def test_probe_plan_models_match_the_plain_probe(name, tiles):
    """The bounds per tile (staged, window and whole-store branches, the
    non-monotone one where ts -+ within wraps) and the load-balanced
    expansion give _join_match_arrays' bounds, total, records and store
    entries, also with a total above match_cap and with tiles so small
    that a record's matches span several of them."""
    cap, live, bcap, n, codes, (t0, t1), within, cutoff, run = \
        PLAN_CASES[name]
    small = tiles == "small"
    for seed in range(4):
        rng = np.random.default_rng(seed)
        scode, sts = _sorted_store(rng, cap, live, codes, t0, t1, run)
        bcode, bts = _sorted_batch(rng, bcap, n, codes, t0, t1)
        other = {"code": torch.from_numpy(scode), "ts": torch.from_numpy(sts),
                 "flags": torch.zeros(cap, dtype=torch.int32),
                 "cols": torch.zeros((0, cap), dtype=torch.int32)}
        batch = torch.from_numpy(np.stack([bcode, bts, np.zeros_like(bcode),
                                           np.zeros_like(bcode)]))
        for branch in (0, 1, 2):
            lo, cnt, ccnt, total, taken = bounds_model(
                scode, sts, bcode, bts, n, within, cutoff,
                tile=16 if small else 256, window=24 if small else 2048,
                branch=branch)
            if name == "wraps":
                assert "whole" in taken
            for match_cap in (max(total, 1) + 7, max(total // 2, 1)):
                want = jl._join_match_arrays(other, batch, n, within, cutoff,
                                             match_cap)
                assert want[0] == total
                rec, oidx, mvalid = expand_model(
                    lo, cnt, ccnt, total, match_cap, cap, n,
                    tile=8 if small else 2048, per=2 if small else 8)
                assert np.array_equal(rec, want[1].numpy())
                assert np.array_equal(mvalid, want[3].numpy())
                assert np.array_equal(np.where(mvalid, oidx, 0),
                                      want[2].numpy())


def test_probe_plan_takes_each_branch():
    rng = np.random.default_rng(5)
    scode, sts = _sorted_store(rng, 400, 390, 4, -30, 30, 300)
    bcode, bts = _sorted_batch(rng, 64, 60, 4, -30, 30)
    taken = bounds_model(scode, sts, bcode, bts, 60, 10, -40, tile=16,
                         window=24)[4]
    assert {"staged", "window"} <= set(taken)
    assert set(bounds_model(scode, sts, bcode, bts, 60, 10, -40,
                            branch=2)[4]) == {"whole"}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("tiles", ["kernel", "small"])
def test_merge_path_model_equals_the_sorting_insert(case, tiles):
    """join_insert.cu's merge path (block splits, thread splits, the
    store first on equal keys, places past cap dropped) gives
    join_insert_ref's store."""
    cap, bcap, n, nm, *_ = case
    rng = np.random.default_rng(11 + n)
    mine = store_np(rng, cap, nm, cap // 2)
    b = batch_np(rng, bcap, n, nm)
    bcode = np.where((np.arange(bcap) < n) & (b[0] < SENT), b[0], SENT)
    src = merge_model(_key(mine["code"], mine["ts"]), _key(bcode, b[1]), cap,
                      tile=16 if tiles == "small" else 2048,
                      per=4 if tiles == "small" else 8)
    want = jl.join_insert_ref(to_t(mine), torch.from_numpy(b), n, nm)
    fa = src >= 0
    got_code = np.where(fa, mine["code"][np.where(fa, src, 0)],
                        bcode[np.where(fa, 0, -1 - src)])
    got_flags = np.where(fa, mine["flags"][np.where(fa, src, 0)],
                         b[3][np.where(fa, 0, -1 - src)])
    assert np.array_equal(got_code, want["code"].numpy())
    assert np.array_equal(got_flags, want["flags"].numpy())
