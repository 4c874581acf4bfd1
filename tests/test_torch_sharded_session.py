"""The port's key-sharded session arena (hstream_tpu_torch.parallel
ShardedSessionLattice and SessionExecutor's mesh branch) against the
reference's (hstream_tpu/parallel/lattice.py ShardedSessionLattice) on
the CPU.

The reference runs on conftest's 8 virtual CPU devices; the port on
make_mesh(..., devices=["cpu"]), every key shard's arena on the CPU,
where each wrapper runs its kernel's plain version. The executor cases
mirror tests/test_sharded_session.py, both kernel modes: rows equal the
reference's sharded executor's and the port's single-card executor's
(keys, session bounds and counts exact, float sums to 4 decimals as
there). The lattice cases hold each ShardedSessionLattice entry against
the reference's on per-shard arenas built by the reference: code, t0,
t1, integer planes, histograms and registers exact per shard, SUM/AVG
planes within rel 1e-6 (the reference adds in XLA's order), the
finalized rows as tests/test_torch_session_lattice.py holds them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from hstream_tpu.engine import lattice as JL
from hstream_tpu.engine.session import SessionExecutor as JSessionExecutor
from hstream_tpu.engine.snapshot import restore_executor as jrestore
from hstream_tpu.engine.snapshot import snapshot_executor as jsnapshot
from hstream_tpu.parallel.lattice import ShardedSessionLattice as JSSL
from hstream_tpu_torch.engine import SessionExecutor
from hstream_tpu_torch.engine import session_lattice as sl
from hstream_tpu_torch.engine.kernels import binding as kb
from hstream_tpu_torch.engine.snapshot import restore_executor, \
    snapshot_executor
from hstream_tpu_torch.parallel import lattice as pl
from hstream_tpu_torch.parallel import make_mesh
from test_torch_session_lattice import (
    GAP,
    JSCHEMA,
    JSPEC,
    LAYOUT,
    SUMS,
    TSCHEMA,
    TSPEC,
    _batch,
    _segments,
)
from torch_parity import BASE, JM, TM

MODES = ["record", "segment"]
S = 4          # key shards of the lattice cases
CAP = 256      # slots an arena


@pytest.fixture(scope="module")
def jmesh():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return Mesh(np.array(devs[:8]).reshape(1, 8), ("data", "key"))


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh(1, 8, devices=["cpu"])


def node_of(m, gap_ms, grace_ms, names=("c", "sv", "mn", "mx")):
    schema = m.Schema.of(k=m.ColumnType.STRING, v=m.ColumnType.FLOAT)
    table = {"c": m.AggSpec(m.AggKind.COUNT_ALL, "c"),
             "sv": m.AggSpec(m.AggKind.SUM, "sv", input=m.Col("v")),
             "mn": m.AggSpec(m.AggKind.MIN, "mn", input=m.Col("v")),
             "mx": m.AggSpec(m.AggKind.MAX, "mx", input=m.Col("v"))}
    return m.AggregateNode(
        child=m.SourceNode("s", schema), group_keys=[m.Col("k")],
        window=m.SessionWindow(gap_ms, grace_ms=grace_ms),
        aggs=[table[n] for n in names], having=None,
        post_projections=[]), schema


def to_rows(out):
    if out is None:
        return []
    return out if isinstance(out, list) else out.rows()


def canon(rows, names=("c", "sv", "mn", "mx")):
    return sorted(
        (r["k"], int(r["winStart"]), int(r["winEnd"]))
        + tuple(round(float(r[n]), 4) for n in names)
        for r in rows)


def executor(pkg, mesh, node, schema):
    if pkg == "jax":
        kw = {} if mesh is None else {"mesh": mesh}
        return JSessionExecutor(node, schema, **kw)
    return SessionExecutor(node, schema, device="cpu", mesh=mesh)


def gen_ooo(seed, n_batches=10, batch=300, keys=40, late_frac=0.15):
    """Out-of-order traffic with a late tail reaching past grace."""
    rng = np.random.default_rng(seed)
    batches, t = [], BASE
    for _ in range(n_batches):
        ks = rng.integers(0, keys, batch)
        ts = t + rng.integers(0, 4000, batch)
        late = rng.random(batch) < late_frac
        ts = np.where(late, ts - rng.integers(3000, 20_000, batch), ts)
        vs = rng.integers(0, 1000, batch)
        rows = [{"k": f"u{int(k)}", "v": float(v)}
                for k, v in zip(ks, vs)]
        batches.append((rows, ts.tolist()))
        t += 2500
    return batches


@pytest.mark.parametrize("mode", MODES)
def test_sharded_sessions_match_single_chip(jmesh, tmesh, mode):
    """Out-of-order records and late drops: the port's mesh rows equal
    the reference's mesh rows and the port's single-card rows."""
    def run(pkg, mesh):
        node, schema = node_of(JM if pkg == "jax" else TM, 1000, 500)
        ex = executor(pkg, mesh, node, schema)
        ex.device_session_mode = mode
        out = []
        for rows, ts in gen_ooo(3):
            out.extend(to_rows(ex.process(rows, ts)))
        out.extend(to_rows(ex.drain_closed()))
        out.extend(to_rows(ex.peek()))
        assert ex.device_fallbacks == 0, ex._device_refusal
        return canon(out), ex

    want, _ = run("jax", jmesh)
    single, _ = run("port", None)
    got, ex = run("port", tmesh)
    assert ex._dev is not None and ex._dev.get("ssl") is not None, \
        ex._device_refusal
    assert ex._dev["ssl"].n_shards == 8
    assert ex.sharded_dispatches > 0
    assert got == want == single


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("defer", [False, True])
def test_sharded_sessions_compaction_and_deferred(jmesh, tmesh, mode,
                                                  defer):
    """A rotating key population forces the residue-preserving code
    compaction mid-run; with deferral several close cycles stack before
    each drain, across a compaction; the host view of the sharded arena
    then round-trips into the host engine."""
    names = ("c", "sv", "mx")

    def gen(seed, n_batches=14, batch=250):
        rng = np.random.default_rng(seed)
        batches, t = [], BASE
        for b in range(n_batches):
            ks = rng.integers(b * 37, b * 37 + 90, batch)
            ts = t + rng.integers(0, 3000, batch)
            late = rng.random(batch) < 0.1
            ts = np.where(late, ts - rng.integers(3000, 15_000, batch), ts)
            vs = rng.integers(0, 1000, batch)
            rows = [{"k": f"u{int(k)}", "v": float(v)}
                    for k, v in zip(ks, vs)]
            batches.append((rows, ts.tolist()))
            t += 2000
        return batches

    def run(pkg, mesh):
        node, schema = node_of(JM if pkg == "jax" else TM, 800, 400, names)
        ex = executor(pkg, mesh, node, schema)
        ex.device_session_mode = mode
        ex.defer_close_decode = defer
        ex._KEY_CACHE_MAX = 128   # force code compaction mid-run
        out = []
        for i, (rows, ts) in enumerate(gen(11)):
            out.extend(to_rows(ex.process(rows, ts)))
            if defer and i % 5 == 4:
                out.extend(to_rows(ex.drain_closed()))
        out.extend(to_rows(ex.drain_closed()))
        remaps = ex.session_stats["remap_dispatches"]
        if ex._dev is not None:
            ex._degrade_to_host("test: host view check")
        out.extend(to_rows(ex.peek()))
        return canon(out, names), remaps

    want, _ = run("jax", jmesh)
    single, _ = run("port", None)
    got, remaps = run("port", tmesh)
    assert remaps > 0, "no remap ran"
    assert got == want == single


@pytest.mark.parametrize("mode", MODES)
def test_sharded_sessions_arena_growth(jmesh, tmesh, mode):
    """A live key population past the first per-shard capacity grows
    every shard's arena (and its spare) on both paths."""
    names = ("c", "sv")

    def gen(seed, n_batches=8, batch=900, keys=3000):
        rng = np.random.default_rng(seed)
        batches, t = [], BASE
        for _ in range(n_batches):
            ks = rng.integers(0, keys, batch)
            ts = t + rng.integers(0, 1500, batch)
            vs = rng.integers(0, 100, batch)
            rows = [{"k": f"u{int(k)}", "v": float(v)}
                    for k, v in zip(ks, vs)]
            batches.append((rows, ts.tolist()))
            t += 1200
        return batches

    def run(pkg, mesh):
        # gap >> span: nothing closes, the arena only accretes
        node, schema = node_of(JM if pkg == "jax" else TM, 60_000, 100,
                               names)
        ex = executor(pkg, mesh, node, schema)
        ex.device_session_mode = mode
        out = []
        for rows, ts in gen(5):
            out.extend(to_rows(ex.process(rows, ts)))
        out.extend(to_rows(ex.peek()))
        assert ex.device_fallbacks == 0, ex._device_refusal
        return canon(out, names), ex

    want, _ = run("jax", jmesh)
    single, exa = run("port", None)
    got, exb = run("port", tmesh)
    assert exa.session_stats["grows"] > 0, "single card never grew"
    assert exb.session_stats["grows"] > 0, "the mesh never grew"
    assert all(a["code"].shape[0] == exb._dev["cap"]
               for a in exb._dev["arena"] + exb._dev["spare"])
    assert got == want == single


@pytest.mark.parametrize("mode", MODES)
def test_session_mesh_size_migration(jmesh, tmesh, mode):
    """A snapshot on one mesh size restores onto another (one card <->
    eight key shards), in either package and across the packages: the
    blob holds the gathered host view, the restore re-shards on its
    first batch, and the rows stay those of the uninterrupted run."""
    names = ("c", "sv")

    class P:  # restore_executor reads .node off the plan
        pass

    def gen(seed=2, n_batches=10, batch=250, keys=30):
        rng = np.random.default_rng(seed)
        out, t = [], BASE
        for _ in range(n_batches):
            ks = rng.integers(0, keys, batch)
            ts = t + rng.integers(0, 3000, batch)
            vs = rng.integers(0, 500, batch)
            rows = [{"k": f"u{int(k)}", "v": float(v)}
                    for k, v in zip(ks, vs)]
            out.append((rows, ts.tolist()))
            t += 2200
        return out

    def run(pkg_a, mesh_a, pkg_b, mesh_b, cut=5):
        node, schema = node_of(JM if pkg_a == "jax" else TM, 1000, 500,
                               names)
        ex = executor(pkg_a, mesh_a, node, schema)
        ex.device_session_mode = mode
        out, bs = [], gen()
        for rows, ts in bs[:cut]:
            out.extend(to_rows(ex.process(rows, ts)))
        blob = (jsnapshot if pkg_a == "jax" else snapshot_executor)(ex)
        p = P()
        p.node = node_of(JM if pkg_b == "jax" else TM, 1000, 500, names)[0]
        if pkg_b == "jax":
            ex2, _ = jrestore(p, blob, mesh=mesh_b)
        else:
            ex2, _ = restore_executor(p, blob, mesh=mesh_b, device="cpu")
        ex2.device_session_mode = mode
        for rows, ts in bs[cut:]:
            out.extend(to_rows(ex2.process(rows, ts)))
        out.extend(to_rows(ex2.peek()))
        return canon(out, names), ex2

    base, _ = run("port", None, "port", None)
    up, ux = run("port", None, "port", tmesh)
    assert ux._dev is not None and ux._dev.get("ssl") is not None, \
        ("the restore onto a mesh did not shard", ux._device_refusal)
    down, dx = run("port", tmesh, "port", None)
    assert dx._dev is None or dx._dev.get("ssl") is None
    from_ref, fx = run("jax", jmesh, "port", tmesh)
    assert fx._dev.get("ssl") is not None
    to_ref, _ = run("port", tmesh, "jax", jmesh)
    assert base == up == down == from_ref == to_ref


# ---- the lattice entries against the reference's ----------------------------

@pytest.fixture(scope="module")
def meshes():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return (Mesh(np.array(devs[:8]).reshape(2, S), ("data", "key")),
            make_mesh(2, S, devices=["cpu"]))


def _jssl(meshes):
    return JSSL(meshes[0], "key", JSPEC, JSCHEMA, LAYOUT)


def _tssl(meshes):
    return pl.ShardedSessionLattice(meshes[1], TSPEC)


def _host(arena):
    """A sharded arena as the reference's [S, cap, ...] planes."""
    if isinstance(arena, list):
        return {k: np.stack([a[k].numpy() for a in arena]) for k in arena[0]}
    return {k: np.array(v) for k, v in arena.items()}


def _assert_sharded(got, want, exact_sums):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], want[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k in SUMS and not exact_sums:
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=k)
        else:
            assert np.array_equal(g, w), k


@pytest.fixture(scope="module")
def shard_arenas(meshes):
    """Per-shard arenas the reference's sharded step built from empty
    ones, with evicted entries (sentinel codes) between live ones."""
    j = _jssl(meshes)
    empty = j.init_arena(CAP)
    a = _host(j.step(empty, jnp.asarray(_batch(1, 512, 24, 0)),
                     np.int32(GAP), np.int32(-(1 << 30)), np.int32(0)))
    live = a["code"] < JL.SESSION_SENT_CODE
    for s in range(S):
        assert (a["code"][s][live[s]] % S == s).all()
        idx = np.nonzero(live[s])[0]
        assert 10 < len(idx) < CAP
        a["code"][s, idx[::7]] = JL.SESSION_SENT_CODE
    return a


def _port_arena(host):
    return [{k: torch.from_numpy(v[s].copy()) for k, v in host.items()}
            for s in range(S)]


@pytest.mark.parametrize("integral", [True, False])
def test_lattice_step_matches_reference(meshes, shard_arenas, integral):
    """Record mode: every aggregate kind, NULL masks, invalid records,
    retired entries (t1 <= close_cut) and a delta; each shard folds only
    the records it owns."""
    live_t1 = np.sort(shard_arenas["t1"][shard_arenas["code"]
                                         < JL.SESSION_SENT_CODE])
    close_cut = int(live_t1[len(live_t1) // 3])
    packed = _batch(2, 512, 24, 800, integral)
    j = _jssl(meshes)
    want = _host(j.step(j.put_arena(shard_arenas), jnp.asarray(packed),
                        np.int32(GAP), np.int32(close_cut), np.int32(37)))
    t = _tssl(meshes)
    out = t.init_arena(CAP)
    p = torch.from_numpy(packed.copy())
    inputs = sl.session_inputs(TSPEC, LAYOUT, p,
                               sl.session_programs(TSPEC, TSCHEMA))
    before = pl.sharded_session_step.launches
    got = t.step(_port_arena(shard_arenas), out, p, inputs, GAP, close_cut,
                 37)
    assert pl.sharded_session_step.launches == before   # the plain one
    assert got is out
    _assert_sharded(_host(got), want, exact_sums=integral)


def test_lattice_merge_matches_reference(meshes, shard_arenas):
    """Segment mode: each shard merges only the segments it owns (the
    others, and sentinel segments, are dropped)."""
    live_t1 = shard_arenas["t1"][shard_arenas["code"]
                                 < JL.SESSION_SENT_CODE]
    close_cut = int(np.quantile(live_t1, 0.25))
    seg = _segments(4, 128, 24, 600)
    j = _jssl(meshes)
    want = _host(j.merge(j.put_arena(shard_arenas),
                         {k: jnp.asarray(v) for k, v in seg.items()},
                         np.int32(GAP), np.int32(close_cut), np.int32(11)))
    t = _tssl(meshes)
    got = t.merge(_port_arena(shard_arenas), t.init_arena(CAP),
                  {k: torch.from_numpy(v) for k, v in seg.items()}, GAP,
                  close_cut, 11)
    _assert_sharded(_host(got), want, exact_sums=True)


def test_lattice_extract_matches_reference(meshes, shard_arenas):
    """Per-shard slot lists of different lengths, -1 pads, a shard with
    no slot named: [S, 1 + n_aggs, pcap]."""
    rng = np.random.default_rng(5)
    pcap = 64
    slots = np.full((S, pcap), -1, np.int32)
    for s, n in enumerate((40, 0, 64, 7)):
        slots[s, :n] = rng.permutation(CAP)[:n]
    j = _jssl(meshes)
    want = np.asarray(j.extract(j.put_arena(shard_arenas),
                                jnp.asarray(slots)))
    t = _tssl(meshes)
    got = t.extract(_port_arena(shard_arenas), slots).numpy()
    assert got.shape == want.shape == (S, 1 + len(TSPEC.aggs), pcap)
    for r, agg in enumerate((None,) + TSPEC.aggs):
        g, w = got[:, r], want[:, r]
        if agg is not None and agg.kind == TM.AggKind.APPROX_QUANTILE:
            np.testing.assert_allclose(g.view(np.float32),
                                       w.view(np.float32), rtol=4e-6)
        elif agg is not None and agg.kind in (TM.AggKind.SUM,
                                              TM.AggKind.AVG):
            np.testing.assert_allclose(g.view(np.float32),
                                       w.view(np.float32), rtol=1e-6)
        else:
            assert np.array_equal(g, w), r


def _extract_slots(seed: int, named, pcap: int) -> np.ndarray:
    """Per-shard slot lists padded to pcap: shard s names named[s]
    slots, one of them (where it names three or more) a pad inside the
    prefix."""
    rng = np.random.default_rng(seed)
    slots = np.full((S, pcap), -1, np.int32)
    for s, n in enumerate(named):
        slots[s, :n] = rng.permutation(CAP)[:n]
        if n >= 3:
            slots[s, 1] = -1
    return slots


@pytest.mark.parametrize("tables", [None, [[0, 2], [1, 3]],
                                    [[3], [0, 1, 2]]],
                         ids=["one", "pairs", "three"])
def test_extract_tables_match_reference(meshes, shard_arenas, monkeypatch,
                                        tables):
    """The table launches' plain model (each table's prefixes
    concatenated, each shard's row from its own) against the reference's
    extract, over one table of the card's shards and split tables; rows
    as test_lattice_extract_matches_reference holds them, and equal to
    the plain per-shard version exactly."""
    if tables is not None:
        monkeypatch.setattr(pl, "extract_tables", lambda devices: [
            (devices[ks[0]], ks) for ks in tables])
    slots = _extract_slots(6, (40, 0, 64, 7), 64)
    j = _jssl(meshes)
    want = np.asarray(j.extract(j.put_arena(shard_arenas),
                                jnp.asarray(slots)))
    arenas = _port_arena(shard_arenas)
    got = pl.sharded_session_extract_table_ref(TSPEC, arenas, slots)
    assert torch.equal(got, pl.sharded_session_extract_ref(TSPEC, arenas,
                                                           slots))
    got = got.numpy()
    for r, agg in enumerate((None,) + TSPEC.aggs):
        g, w = got[:, r], want[:, r]
        if agg is not None and agg.kind == TM.AggKind.APPROX_QUANTILE:
            np.testing.assert_allclose(g.view(np.float32),
                                       w.view(np.float32), rtol=4e-6)
        elif agg is not None and agg.kind in (TM.AggKind.SUM,
                                              TM.AggKind.AVG):
            np.testing.assert_allclose(g.view(np.float32),
                                       w.view(np.float32), rtol=1e-6)
        else:
            assert np.array_equal(g, w), r


def test_extract_plan_prefixes():
    """Each shard's named prefix ends at its last named slot (interior
    pads kept, an empty list 0), the prefixes concatenated in table
    order."""
    slots = _extract_slots(7, (5, 0, 64, 3), 64)
    slots[0, 4] = -1                      # a pad ending the prefix
    n_live, sel0, cat = pl.extract_plan(slots, [2, 0, 1, 3])
    assert n_live == [64, 4, 0, 3]
    assert sel0 == [0, 64, 68, 68]
    assert np.array_equal(cat, np.concatenate(
        [slots[2], slots[0, :4], slots[3, :3]]))
    n_live, sel0, cat = pl.extract_plan(slots, [1])
    assert (n_live, sel0, cat.shape) == ([0], [0], (0,))


@pytest.mark.parametrize("pcap,named", [(64, (40, 0, 64, 7)),
                                        (4096, (4096, 0, 2000, 1500))],
                         ids=["inline", "uploaded"])
def test_extract_table_args(monkeypatch, pcap, named):
    """The table a launch takes, built over CPU tensors (the binding's
    pointer check, which wants CUDA tensors, replaced by data_ptr): each
    shard's aggregates' plane pointers in the words, then the prefixes
    there or uploaded where they do not fit beside the pointers; each
    piece (a grid row) its shard's arena, row, place and prefix, its
    warps as extract_pieces cuts them; a table past 16 shards refused."""
    import ctypes

    monkeypatch.setattr(kb, "ptr", lambda t: t.data_ptr())
    cap = 4096
    arenas = [sl.init_session_arena(TSPEC, cap, "cpu") for _ in range(S)]
    rng = np.random.default_rng(8)
    slots = np.full((S, pcap), -1, np.int32)
    for s, n in enumerate(named):
        slots[s, :n] = rng.permutation(cap)[:n]
    shards = [3, 0, 2]
    out = torch.zeros((S, 1 + len(TSPEC.aggs), pcap), dtype=torch.int32)
    rows = [out[s] for s in shards]
    t, keep = pl._extract_table_args(TSPEC, arenas, shards, slots, rows)
    A = len(TSPEC.aggs)
    n_live, sel0, cat = pl.extract_plan(slots, shards)
    assert (t.cap, t.n_sel, t.n_group) == (cap, pcap, 3)
    A = len(TSPEC.aggs)
    inline = 4 * 3 * A + len(cat) <= kb.SESS_XT_WORDS
    pieces = pl.extract_pieces(n_live, pcap)
    assert t.n_pieces == len(pieces) <= kb.SESS_XT_PIECES
    for r, (g, j0, nw) in enumerate(pieces):
        pc, s = t.pc[r], shards[g]
        assert pc.code == arenas[s]["code"].data_ptr()
        assert pc.out == out[s].data_ptr()
        assert (pc.place, pc.n_live, pc.j0, pc.n_warps) == \
            (g, n_live[g], j0, nw)
        assert pc.sel0 == sel0[g] + (4 * 3 * A if inline else 0)
    words = np.ctypeslib.as_array(t.words)
    ptrs = words[:4 * 3 * A].view(np.uint64)
    names = sl.session_plane_names(TSPEC)
    for g, s in enumerate(shards):
        for i, (name, agg) in enumerate(zip(names, TSPEC.aggs)):
            assert ptrs[2 * (g * A + i)] == arenas[s][name].data_ptr()
            want_n = (arenas[s][name + "_n"].data_ptr()
                      if agg.kind == TM.AggKind.AVG else 0)
            assert ptrs[2 * (g * A + i) + 1] == want_n
    assert inline == (pcap == 64)
    if inline:
        assert not t.slots and not keep
        assert np.array_equal(words[4 * 3 * A:4 * 3 * A + len(cat)], cat)
    else:
        assert t.slots == keep[0].data_ptr()
        assert np.array_equal(keep[0].numpy(), cat)
    assert ctypes.sizeof(t) <= 32764
    many = [sl.init_session_arena(TSPEC, 8, "cpu") for _ in range(17)]
    with pytest.raises(ValueError, match="does not fit a launch"):
        pl._extract_table_args(TSPEC, many, list(range(17)),
                               np.full((17, 8), -1, np.int32),
                               [torch.zeros((1 + A, 8), dtype=torch.int32)]
                               * 17)


@pytest.mark.parametrize("n_live,P", [
    ((0, 0, 6250, 0), 8192), ((1563, 1563, 1562, 1562), 8192),
    ((0,), 64), ((7, 0, 64, 40), 64), ((0,) * 16, 1 << 13),
    (tuple(range(0, 1600, 100)), 2048), ((0, 0), 0)])
def test_extract_pieces_cover_every_warp_in_even_rows(n_live, P):
    """The table's grid rows: each shard's warps (an entry of its prefix
    each, then one each 32 pad columns) once, in order, in at most 32
    pieces none longer than ceil(total / (32 - G)), however the named
    slots fall among the shards."""
    warps = [n + -(-(P - n) // 32) for n in n_live]
    pieces = pl.extract_pieces(list(n_live), P)
    assert len(pieces) <= kb.SESS_XT_PIECES
    per = -(-sum(warps) // (kb.SESS_XT_PIECES - len(warps)))
    for g, w in enumerate(warps):
        mine = [(j0, nw) for gg, j0, nw in pieces if gg == g]
        assert [j0 for j0, _ in mine] == list(range(0, w, max(per, 1)))
        assert sum(nw for _, nw in mine) == w
        assert all(0 < nw <= per for _, nw in mine)


def test_extract_tables_cut_past_16_shards():
    a, b = torch.device("cpu", 0), torch.device("cpu", 1)
    assert pl.extract_tables([a] * 20) == [(a, list(range(16))),
                                           (a, [16, 17, 18, 19])]
    assert pl.extract_tables([a, b, a]) == [(a, [0, 2]), (b, [1])]


def test_lattice_remap_and_growth_match_reference(meshes, shard_arenas):
    """One residue-preserving table remaps every shard (dead codes to the
    sentinel); growth pads every shard with identities."""
    rng = np.random.default_rng(6)
    lcap = 32
    live = np.arange(24)
    new = np.empty(24, np.int64)
    for s in range(S):
        m = live % S == s
        new[m] = np.arange(int(m.sum())) * S + s
    lut = np.full(lcap, JL.SESSION_SENT_CODE, np.int32)
    keep = rng.random(24) < 0.7
    lut[live[keep]] = new[keep]
    j = _jssl(meshes)
    want = _host(j.remap(j.put_arena(shard_arenas), jnp.asarray(lut)))
    t = _tssl(meshes)
    arena = _port_arena(shard_arenas)
    assert t.remap(arena, torch.from_numpy(lut)) is arena
    _assert_sharded(_host(arena), want, exact_sums=True)
    for s in range(S):
        c = want["code"][s]
        assert (c[c < JL.SESSION_SENT_CODE] % S == s).all()
    grown_want = _host(j.grow_arena(j.put_arena(shard_arenas), 2 * CAP))
    grown = t.grow_arena(_port_arena(shard_arenas), 2 * CAP)
    _assert_sharded(_host(grown), grown_want, exact_sums=True)
    init_want = _host(j.init_arena(CAP))
    _assert_sharded(_host(t.init_arena(CAP)), init_want, exact_sums=True)


# ---- the remap's table launch (one a card) -----------------------------------

REMAP_MESHES = [(1, 2), (1, 4), (1, 17), (2, 2)]


def _remap_case(S: int, cap: int, lcap: int, seed: int):
    """[S, cap] codes (shard s's residue s) below, at and above lcap and
    the sentinel, and a residue-preserving table (dead codes to the
    sentinel)."""
    rng = np.random.default_rng(seed)
    codes = np.empty((S, cap), np.int32)
    for s in range(S):
        c = rng.integers(0, (lcap + 40) // S, cap) * S + s
        c[rng.random(cap) < 0.1] = JL.SESSION_SENT_CODE
        at = lcap + (s - lcap) % S        # the first code at or past lcap
        c[: 2] = at, at + S
        codes[s] = c
    lut = np.full(lcap, JL.SESSION_SENT_CODE, np.int32)
    live = np.arange(lcap)
    keep = rng.random(lcap) < 0.7
    for s in range(S):
        m = keep & (live % S == s)
        lut[live[m]] = np.arange(int(m.sum())) * S + s
    return codes, lut


@pytest.mark.parametrize("shape", REMAP_MESHES)
def test_sharded_remap_table_matches_reference(shape, monkeypatch):
    """The key-sharded remap on a mesh on the CPU (the wrapper's plain
    path) and the table kernel's plain model over every shard's code
    plane (heads of 0-3 codes, caps off four) against the reference's
    ShardedSessionLattice.remap; a mesh past the 8 virtual devices
    against its shard_map body, the remap kernel a shard."""
    n_data, S = shape
    cap, lcap = 203, 96
    codes, lut = _remap_case(S, cap, lcap, 40 + S)
    if n_data * S <= len(jax.devices()):
        mesh = Mesh(np.array(jax.devices()[:n_data * S]).reshape(n_data, S),
                    ("data", "key"))
        j = JSSL(mesh, "key", JSPEC, JSCHEMA, LAYOUT)
        host = _host(j.init_arena(cap))
        host["code"] = codes
        want = _host(j.remap(j.put_arena(host), jnp.asarray(lut)))["code"]
    else:
        fn = JL.session_remap_kernel(cap, lcap)
        want = np.stack([np.asarray(fn({"code": jnp.asarray(c)},
                                       jnp.asarray(lut))["code"])
                         for c in codes])
    assert (want == JL.SESSION_SENT_CODE).any() and (want >= lcap).any()
    for s in range(S):
        live = want[s][want[s] < JL.SESSION_SENT_CODE]
        assert (live % S == s).all()
    ssl = pl.ShardedSessionLattice(make_mesh(n_data, S, devices=["cpu"]),
                                   TSPEC)
    arena = [{"code": torch.from_numpy(c.copy())} for c in codes]
    assert ssl.remap(arena, torch.from_numpy(lut)) is arena
    assert np.array_equal(np.stack([a["code"].numpy() for a in arena]), want)
    # the table's rows over planes at every offset of a 16-byte boundary
    monkeypatch.setattr(kb, "ptr", lambda t: t.data_ptr())
    pitch = (cap + 7) // 4 * 4             # a multiple of 16 bytes
    buf = torch.zeros(S * pitch + 4, dtype=torch.int32)
    base = -buf.data_ptr() % 16 // 4
    planes = []
    for s in range(S):
        at = base + s * pitch + s % 4
        planes.append(buf[at:at + cap])
        planes[-1].copy_(torch.from_numpy(codes[s]))
    words, total = pl.remap_rows(planes)
    heads = words[kb.REMAP_HEAD::kb.REMAP_WORDS]
    assert set(heads) == {(4 - s % 4) % 4 for s in range(S)}
    assert total == sum((cap - h) // 4 for h in heads)
    pl.remap_table_ref(words, total, planes, torch.from_numpy(lut))
    assert np.array_equal(np.stack([p.numpy() for p in planes]), want)


def test_remap_table_cached_by_addresses(monkeypatch):
    """One table a card, uploaded once for the same planes and again for
    another plane or cap."""
    monkeypatch.setattr(kb, "ptr", lambda t: t.data_ptr())
    cpu = torch.device("cpu")
    planes = [torch.zeros(100, dtype=torch.int32) for _ in range(3)]
    before = pl.remap_table.uploads
    t1, n1 = pl.remap_table(planes, cpu)
    t2, n2 = pl.remap_table(planes, cpu)
    assert t1 is t2 and n1 == n2 and pl.remap_table.uploads == before + 1
    assert t1.shape == (3 * kb.REMAP_WORDS,)
    pl.remap_table(planes[:2] + [torch.zeros(7, dtype=torch.int32)], cpu)
    assert pl.remap_table.uploads == before + 2
