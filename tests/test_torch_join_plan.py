"""The key-sharded join's table launches (the port's
hstream_tpu_torch/engine/kernels/csrc/join_group.cu and the table entries
of join_probe.cu, join_insert.cu and scatter.cu) on the CPU: the plain
models of their plan against the reference and against the reference's
own plan, and the host's tables and argument blocks.

On the card the key shards whose stores lie on one card probe and insert
in one launch sequence over a table of them: the batch's valid records
are grouped once by owner (join_lattice.group_ref models the grouping),
each shard probes and inserts only its group's records, and the fused
step's scatter folds the gathered feed into a table of the inner
lattice's partials (parallel.lattice.scatter_table_ref). The reference
(hstream_tpu/parallel/lattice.py ShardedJoinLattice) runs every shard
over the whole batch with its owned mask; both plans must give the same
match buffers, totals, stores and partials, exactly (the partials' sums
are of multiples of 1/4, so every order gives one float32 sum).
"""

from __future__ import annotations

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from hstream_tpu.parallel import ShardedQueryExecutor as JSharded
from hstream_tpu.parallel.lattice import ShardedJoinLattice as JSJL
from hstream_tpu_torch.engine import join_lattice as jl
from hstream_tpu_torch.engine.kernels import binding as kb
from hstream_tpu_torch.parallel import ShardedQueryExecutor, make_mesh
from hstream_tpu_torch.parallel import lattice as pl
from test_torch_join_lattice import WITHIN, _feed, _inner, batch_np, store_np
from torch_parity import JM, TM

SENT = jl.JOIN_SENT_CODE
TILE = jl.JOIN_GROUP_TILE

# the tables of S shards on one card: one table, and split tables
TABLES = {1: {"one": [[0]]},
          2: {"one": [[0, 1]], "split": [[1], [0]]},
          3: {"one": [[0, 1, 2]], "split": [[0, 2], [1]]},
          4: {"one": [[0, 1, 2, 3]], "split": [[0, 2], [1, 3]]}}
CASES = [(S, name) for S in TABLES for name in TABLES[S]]


def _split(monkeypatch, tables):
    """The sharded join's wrappers launched over `tables` (lists of the
    shards, whose stores all lie on the CPU), as join_groups splits the
    shards of a mesh over several cards."""
    monkeypatch.setattr(pl, "join_groups", lambda devices: [
        (devices[ks[0]], list(ks)) for ks in tables])


def _stores(rng, S, cap, n_cols, n_live):
    """Per-shard sorted stores: shard s's codes c * S + s, so each holds
    only codes it owns."""
    out = []
    for s in range(S):
        st = store_np(rng, cap, n_cols, n_live)
        live = st["code"] < SENT
        st["code"][live] = st["code"][live] * S + s
        out.append(st)
    return out


def _batch(rng, S, bcap, n, n_cols):
    b = batch_np(rng, bcap, n, n_cols, codes=6 * S)
    b[1, :n] += 60    # times >= 0, as the executor's rebase keeps them
    return b


def _port(stores):
    return [{k: torch.from_numpy(np.array(v)) for k, v in st.items()}
            for st in stores]


def _jmesh(D, S):
    devs = jax.devices()
    if len(devs) < D * S:
        pytest.skip("needs 8 (virtual) devices")
    return Mesh(np.array(devs[:D * S]).reshape(D, S), ("data", "key"))


# ---- the grouping -----------------------------------------------------------

@pytest.mark.parametrize("n", [0, 37, 300])
@pytest.mark.parametrize("S,name", CASES)
def test_grouping_keeps_each_owners_records_in_batch_order(S, name, n):
    """Per table: group g holds exactly the valid records (within n, below
    the sentinel) that shard shards[g] owns, in batch order, from a first
    place that is a multiple of the probe's tile; the records of shards
    in other tables are dropped."""
    rng = np.random.default_rng(S * 31 + n)
    b = torch.from_numpy(_batch(rng, S, 300, n, 1))
    b[0, 5] = SENT    # an invalid record inside n
    code = b[0].numpy().astype(np.int64)
    seen = []
    for shards in TABLES[S][name]:
        idx, base, count = jl.group_ref(b, n, shards, S)
        assert idx.shape == (300 + len(shards) * TILE,)
        assert int(base[0]) == 0 and (base % TILE == 0).all()
        for g, s in enumerate(shards):
            want = [j for j in range(n)
                    if code[j] < SENT and code[j] % S == s]
            got = jl.group_records((idx, base, count), g).tolist()
            assert got == want
            assert int(base[g + 1]) - int(base[g]) == \
                -(-len(want) // TILE) * TILE
            seen += got
        kept = np.zeros(idx.shape[0], bool)
        for g in range(len(shards)):
            kept[int(base[g]):int(base[g]) + int(count[g])] = True
        assert (idx.numpy()[~kept] == -1).all()
    # every valid record lands in exactly one table's group
    assert sorted(seen) == [j for j in range(n) if code[j] < SENT]


# ---- the table probe and insert ---------------------------------------------

@pytest.mark.parametrize("S,name", CASES)
def test_table_probe_and_insert_match_the_reference(monkeypatch, S, name):
    """The table probe's and insert's plain models (the port's CPU path)
    against the reference's plan (owned masks over the whole batch) and
    the reference's ShardedJoinLattice on a (1, S) mesh: match buffers in
    the [rows, S * match_cap] layout (a truncated shard included), the
    probe-only redo, and every shard's store, over three batches."""
    cap, bcap, n, mc = 128, 48, 40, 8
    rng = np.random.default_rng(7 * S + len(name))
    nm, no = 2, 1
    tables = TABLES[S][name]
    assert pl.join_groups([torch.device("cpu")] * S) == [
        (torch.device("cpu"), sum(TABLES[S]["one"], []))]
    if name == "split":
        _split(monkeypatch, tables)
    jsj = JSJL(_jmesh(1, S), "key", cap, bcap, mc, nm, no)
    host = {"l": _stores(rng, S, cap, nm, cap // 4),
            "r": _stores(rng, S, cap, no, cap // 4)}
    jst = {side: jsj.put_store({k: np.stack([st[k] for st in h])
                                for k in h[0]})
           for side, h in host.items()}
    tst = {side: _port(h) for side, h in host.items()}
    totals = []
    for i in range(3):
        batch = _batch(rng, S, bcap, n, nm)
        tb = torch.from_numpy(batch)
        jmine, jpk = jsj.probe_insert("l", jst["l"], jst["r"],
                                      jnp.asarray(batch), np.int32(n),
                                      np.int32(WITHIN), np.int32(-30))
        before = (jl.group_cuda.launches, jl.probe_table_cuda.launches,
                  jl.insert_table_cuda.launches)
        tmine, tpk = pl.sharded_join_probe_insert(
            tst["l"], tst["r"], tb, n, WITHIN, -30, mc, nm)
        assert (jl.group_cuda.launches, jl.probe_table_cuda.launches,
                jl.insert_table_cuda.launches) == before   # plain on the CPU
        jpk = np.asarray(jpk)
        assert tpk.shape == (5 + nm + no, S * mc)
        np.testing.assert_array_equal(tpk.numpy(), jpk)
        np.testing.assert_array_equal(
            pl.sharded_join_probe_ref(tst["r"], tb, n, WITHIN, -30, mc,
                                      nm).numpy(), jpk)
        for s in range(S):
            for k in ("code", "ts", "flags", "cols"):
                assert np.array_equal(np.asarray(jmine[k])[s],
                                      tmine[s][k].numpy()), (i, s, k)
        want = pl.sharded_join_insert_ref(tst["l"], tb, n, nm)
        for s in range(S):
            for k in want[s]:
                assert torch.equal(want[s][k], tmine[s][k])
        jpo = np.asarray(jsj.probe_only("l", jst["r"], jnp.asarray(batch),
                                        np.int32(n), np.int32(WITHIN),
                                        np.int32(-30), 2 * mc))
        tpo = pl.sharded_join_probe_only(tst["r"], tb, n, WITHIN, -30,
                                         2 * mc, nm)
        np.testing.assert_array_equal(tpo.numpy(), jpo)
        jst["l"], tst["l"] = jmine, tmine
        totals += [int(tpk[0, s * mc]) for s in range(S)]
    assert max(totals) > mc    # a truncated shard


def test_a_shard_without_records_writes_an_empty_buffer(monkeypatch):
    """A table shard whose group is empty: total 0 and every column the
    reference's clip, its store unchanged."""
    S, cap, bcap, mc = 3, 64, 16, 8
    rng = np.random.default_rng(5)
    mine = _port(_stores(rng, S, cap, 1, cap // 4))
    other = _port(_stores(rng, S, cap, 1, cap // 4))
    batch = _batch(rng, S, bcap, bcap, 1)
    batch[0] = batch[0] - batch[0] % S      # every record owned by shard 0
    batch = batch[:, np.lexsort((batch[1], batch[0]))]
    tb = torch.from_numpy(batch)
    _split(monkeypatch, [[2, 0], [1]])
    new, pk = pl.sharded_join_probe_insert(mine, other, tb, bcap, WITHIN,
                                           -(1 << 31), mc, 1)
    want = pl.sharded_join_probe_ref(other, tb, bcap, WITHIN, -(1 << 31),
                                     mc, 1)
    assert torch.equal(pk, want)
    assert int(pk[0, mc]) == 0 and int(pk[0, 2 * mc]) == 0
    for s in (1, 2):
        for k in mine[s]:
            assert torch.equal(new[s][k], mine[s][k])


# ---- the fused step's table scatter -----------------------------------------

@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4), (2, 1)])
def test_fused_step_tables_match_the_reference(monkeypatch, mesh_shape,
                                               split):
    """The fused step's plain table models (the grouped probe feeds at
    entries [s * match_cap, ...), the programs once, the table scatter's
    routing: entry i's slot opened in every partial of data shard i mod
    n_data, its cell folded in partial (d, kid div Kl)) against the
    reference's per-partial local_step: totals, stores and every
    partial's planes, with one table of partials or split ones."""
    D, K = mesh_shape
    jmesh = _jmesh(D, K)
    tmesh = make_mesh(D, K, devices=["cpu"])
    cap, bcap, n, mc = 256, 64, 50, 128
    nm = no = 3
    rng = np.random.default_rng(D * 10 + K + split)
    jnode, jschema = _inner(JM, False)
    tnode, tschema = _inner(TM, False)
    jex = JSharded(jnode, jschema, mesh=jmesh, initial_keys=8)
    tex = ShardedQueryExecutor(tnode, tschema, mesh=tmesh, initial_keys=8)
    feed = _feed("left", jex, False)
    jsj = JSJL(jmesh, "key", cap, bcap, mc, nm, no)
    tsj = pl.ShardedJoinLattice(tmesh, nm, no)
    mine, other = _stores(rng, K, cap, nm, cap // 3), \
        _stores(rng, K, cap, no, cap // 2)
    b = _batch(rng, K, bcap, n, nm)
    b[2, :n] = rng.integers(0, 8, n)             # inner key ids
    if split:   # every partial in a table of its own
        monkeypatch.setattr(pl, "scatter_groups", lambda st, _n: [
            (torch.device("cpu"), [(d, k)]) for d in range(st.n_data)
            for k in range(st.n_key)])
    jstate = jex._sharded.init_state()
    tstate = tex._sharded.init_state()
    jmine, jstate, jtot = jsj.probe_insert_step(
        "l", jex._sharded, jsj.put_store(
            {k: np.stack([st[k] for st in mine]) for k in mine[0]}),
        jsj.put_store({k: np.stack([st[k] for st in other])
                       for k in other[0]}),
        jnp.asarray(b), np.int32(n), np.int32(WITHIN), np.int32(-30),
        jstate, np.int32(120), np.int32(300), feed_plan=feed[0],
        nulls_plan=feed[1], filter_nulls=feed[2])
    tmine, _st, ttot = tsj.probe_insert_step(
        "l", tex._sharded, _port(mine), _port(other), torch.from_numpy(b),
        n, WITHIN, -30, tstate, 120, 300, feed_plan=feed[0],
        nulls_plan=feed[1], filter_nulls=feed[2], match_cap=mc)
    np.testing.assert_array_equal(ttot.numpy(), np.asarray(jtot))
    for s in range(K):
        for k in tmine[s]:
            assert np.array_equal(np.asarray(jmine[k])[s],
                                  tmine[s][k].numpy()), (s, k)
    Kl = tex._sharded.local_spec.n_keys
    for name, v in jstate.items():
        w = np.asarray(v)
        for d in range(D):
            for k in range(K):
                g = tstate[d][k][name].numpy()
                want = w[d] if name == "slot_start" else \
                    w[d, k * Kl:(k + 1) * Kl]
                assert np.array_equal(want, g), (name, d, k)
    counts = [int(tstate[d][k]["count"].sum()) for d in range(D)
              for k in range(K)]
    assert sum(counts) > 0
    # a data shard's slots open in its every partial, also where no key
    # of the partial's key range matched
    for d in range(D):
        starts = {tuple(tstate[d][k]["slot_start"].tolist())
                  for k in range(K)}
        assert len(starts) == 1


def test_table_scatter_model_is_the_routing_and_the_partials_scatter():
    """scatter_table_ref over any split of the partials into tables
    equals the routing (join_route_ref) and one scatter a partial."""
    D, K = 2, 2
    tex = ShardedQueryExecutor(*_inner(TM, False),
                               mesh=make_mesh(D, K, devices=["cpu"]),
                               initial_keys=8)
    spec = tex._sharded.local_spec
    rng = np.random.default_rng(9)
    m = 400
    kid = torch.from_numpy(rng.integers(-2, 2 * spec.n_keys + 3, m)
                           .astype(np.int32))
    ts = torch.from_numpy(rng.integers(0, 400, m).astype(np.int32))
    valid = torch.from_numpy(rng.random(m) < 0.8)
    cols = {c: torch.from_numpy((rng.integers(-8, 8, m) / 4)
                                .astype(np.float32)) for c in "abc"}
    states = []
    for tables in ([[(0, 0), (0, 1), (1, 0), (1, 1)]],
                   [[(1, 1), (0, 0)], [(0, 1)], [(1, 0)]]):
        st = tex._sharded.init_state()
        for parts in tables:
            pl.scatter_table_ref(spec, st, parts, 50, kid, ts, valid, cols)
        states.append(st)
    want = tex._sharded.init_state()
    keys, vd = pl.join_route_ref(kid, valid, D, K, spec.n_keys)
    for d in range(D):
        for k in range(K):
            pl.lattice.scatter_step_ref(spec, want[d][k], 50, keys[k], ts,
                                        vd[d], cols)
    for st in states:
        for d in range(D):
            for k in range(K):
                for name, v in want[d][k].items():
                    assert torch.equal(st[d][k][name], v), (d, k, name)
    assert int(want[1][1]["count"].sum()) > 0


@pytest.mark.parametrize("mesh_shape", [(2, 40), (4, 32)])
def test_fused_step_runs_on_a_mesh_past_the_place_span(mesh_shape):
    """A mesh of more partials than one scatter table's places (80, 128):
    the fused step's table models (scatter_groups cut into tables of at
    most kb.SCATTER_PLACES consecutive partials) against the reference's
    plan in plain PyTorch (sharded_join_probe_insert_step_ref): totals,
    stores and every partial's planes exactly."""
    D, K = mesh_shape
    assert D * K > kb.SCATTER_PLACES
    tex = ShardedQueryExecutor(*_inner(TM, False),
                               mesh=make_mesh(D, K, devices=["cpu"]),
                               initial_keys=2 * K)
    rng = np.random.default_rng(D + K)
    cap, bcap, n, mc = 64, 256, 200, 64
    mine = _port(_stores(rng, K, cap, 3, cap // 3))
    other = _port(_stores(rng, K, cap, 3, cap // 2))
    b = _batch(rng, K, bcap, n, 3)
    b[2, :n] = rng.integers(0, 2 * K, n)          # inner key ids
    tb = torch.from_numpy(b)
    feed = _feed("left", tex, False)
    runs = []
    for fn in (pl.sharded_join_probe_insert_step,
               pl.sharded_join_probe_insert_step_ref):
        st = tex._sharded.init_state()
        new, tot = fn(mine, other, tb, n, WITHIN, -30, mc, 3,
                      tex._sharded.local_spec, st, 120, 300,
                      tex._sharded._progs, feed)
        runs.append((new, tot, st))
    (gm, gt, gs), (wm, wt, ws) = runs
    assert torch.equal(gt, wt) and int(wt.sum()) > 0
    for s in range(K):
        for k in wm[s]:
            assert torch.equal(gm[s][k], wm[s][k]), (s, k)
    for d in range(D):
        for k in range(K):
            for name, v in ws[d][k].items():
                assert torch.equal(gs[d][k][name], v), (d, k, name)
    assert sum(int(ws[d][k]["count"].sum()) for d in range(D)
               for k in range(K)) > 0


# ---- the host's tables and argument blocks ----------------------------------

def test_join_tables_take_a_card_each_and_split_past_a_launch(monkeypatch):
    """join_groups: one table a card, cut past kb.JOIN_GROUP shards; the
    wrappers' CPU path over tables cut so gives the reference's plan."""
    a, b = torch.device("cpu", 0), torch.device("cpu", 1)
    devs = pl.key_shard_devices(make_mesh(1, 4, devices=[a, b]))
    assert pl.join_groups(devs) == [(a, [0, 2]), (b, [1, 3])]
    assert pl.join_groups([a] * 4) == [(a, [0, 1, 2, 3])]
    many = pl.join_groups([a] * 40)
    assert [len(ks) for _d, ks in many] == [16, 16, 8]
    assert sum((ks for _d, ks in many), []) == list(range(40))
    S, cap, mc = 5, 64, 16
    rng = np.random.default_rng(11)
    mine = _port(_stores(rng, S, cap, 1, cap // 4))
    other = _port(_stores(rng, S, cap, 1, cap // 4))
    tb = torch.from_numpy(_batch(rng, S, 40, 40, 1))
    monkeypatch.setattr(kb, "JOIN_GROUP", 2)
    assert [ks for _d, ks in pl.join_groups([a] * S)] == [[0, 1], [2, 3],
                                                         [4]]
    new, pk = pl.sharded_join_probe_insert(mine, other, tb, 40, WITHIN, -30,
                                           mc, 1)
    assert torch.equal(pk, pl.sharded_join_probe_ref(other, tb, 40, WITHIN,
                                                     -30, mc, 1))
    want = pl.sharded_join_insert_ref(mine, tb, 40, 1)
    for s in range(S):
        for k in want[s]:
            assert torch.equal(new[s][k], want[s][k])


def test_join_table_args_name_each_shards_store(monkeypatch):
    """The table a probe or insert launch takes by value: shard shards[g]'s
    store (and out store) in place g, its first column at[g]; the
    grouping's launch names each shard's place; a table past a launch is
    refused. Built over CPU tensors (kb.ptr, which wants CUDA tensors,
    replaced by data_ptr); the blocks leave room for the kernels' other
    parameters."""
    monkeypatch.setattr(kb, "ptr", lambda t: t.data_ptr())
    S, shards = 4, [3, 1]
    stores = [jl.init_join_store(8, 2) for _ in range(S)]
    outs = [jl.init_join_store(8, 2) for _ in range(S)]
    grouping = torch.zeros(64, dtype=torch.int32)
    totals = torch.zeros(S, dtype=torch.int32)
    t = jl._table_args(stores, shards, grouping, outs=outs, at=[24, 8],
                       totals=totals)
    assert t.n_group == 2 and t.grouping == grouping.data_ptr()
    assert t.totals == totals.data_ptr()
    for g, s in enumerate(shards):
        assert t.sh[g].code == stores[s]["code"].data_ptr()
        assert t.sh[g].cols == stores[s]["cols"].data_ptr()
        assert t.sh[g].out_ts == outs[s]["ts"].data_ptr()
    assert (t.sh[0].at, t.sh[1].at) == (24, 8)
    with pytest.raises(ValueError, match="does not fit a launch"):
        jl._table_args([stores[0]] * 17, list(range(17)), grouping)
    assert ctypes.sizeof(kb.JoinProbeArgs) + ctypes.sizeof(kb.JoinTable) \
        + 256 <= 32764
    assert ctypes.sizeof(kb.JoinGroupArgs) <= 32764


def test_scatter_table_args_place_each_partial(monkeypatch):
    """The table scatter's block: partial parts[p]'s count, slot starts,
    touched flags and plane pointers in place p, the mesh's (d, k) named
    by place (-1 elsewhere); 16 partials a launch (every aggregate's
    planes fit), the scatter's arguments and the table within Hopper's
    parameters."""
    monkeypatch.setattr(kb, "ptr", lambda t: t.data_ptr())
    tex = ShardedQueryExecutor(*_inner(TM, False),
                               mesh=make_mesh(2, 2, devices=["cpu"]),
                               initial_keys=8)
    spec, st = tex._sharded.local_spec, tex._sharded.init_state()
    aggs = pl._scatter_aggs(spec)
    parts = [(1, 0), (0, 1)]
    t = pl._scatter_table_args(spec, st, parts, aggs)
    assert (t.n_data, t.n_key, t.n_parts) == (2, 2, 2)
    assert (t.q0, t.n_q) == (1, 2)
    assert list(t.place[:2]) == [1, 0] and set(t.place[2:]) == {-1}
    for p, (d, k) in enumerate(parts):
        assert t.p[p].count == st[d][k]["count"].data_ptr()
        assert t.p[p].slot_start == st[d][k]["slot_start"].data_ptr()
        for g, i in enumerate(aggs):
            name = pl.lattice._plane_name(i, spec.aggs[i])
            assert t.pp[p * len(aggs) + g].plane == \
                st[d][k][name].data_ptr()
    assert [len(ps) for _d, ps in pl.scatter_groups(st, len(aggs))] == [4]
    big = make_mesh(4, 8, devices=["cpu"])
    sq = ShardedQueryExecutor(*_inner(TM, False), mesh=big, initial_keys=8)
    assert [len(ps) for _d, ps in pl.scatter_groups(
        sq._sharded.init_state(), kb.MAX_AGGS)] == [16, 16]
    assert ctypes.sizeof(kb.ScatterArgs) + ctypes.sizeof(kb.ScatterTable) \
        + 16 <= 32764


@pytest.mark.parametrize("D,K,cards", [(4, 32, 1), (2, 40, 5), (8, 16, 3)])
def test_scatter_tables_cover_any_mesh(monkeypatch, D, K, cards):
    """scatter_groups over a mesh of any size: every partial once, each
    table on one card, within a launch's partials and its place span;
    each table's block names its partials at place[q - q0]. Cards here
    are names (the partials' planes on the CPU), assigned as make_mesh
    assigns them, row-major round the cards."""
    monkeypatch.setattr(kb, "ptr", lambda t: t.data_ptr())
    tex = ShardedQueryExecutor(*_inner(TM, False),
                               mesh=make_mesh(D, K, devices=["cpu"]),
                               initial_keys=K)
    spec, st = tex._sharded.local_spec, tex._sharded.init_state()
    aggs = pl._scatter_aggs(spec)
    card = {(d, k): torch.device("cuda", (d * K + k) % cards)
            for d in range(D) for k in range(K)}
    monkeypatch.setattr(pl, "_device", lambda part: card[next(
        dk for dk in card if st[dk[0]][dk[1]] is part)])
    groups = pl.scatter_groups(st, len(aggs))
    seen = []
    for dev, parts in groups:
        qs = [d * K + k for d, k in parts]
        assert all(card[p] == dev for p in parts)
        assert 1 <= len(parts) <= kb.SCATTER_TABLE
        assert qs == sorted(qs) and qs[-1] - qs[0] < kb.SCATTER_PLACES
        t = pl._scatter_table_args(spec, st, parts, aggs)
        assert (t.q0, t.n_q) == (qs[0], qs[-1] - qs[0] + 1)
        for p, q in enumerate(qs):
            assert t.place[q - t.q0] == p
        assert sum(x >= 0 for x in t.place) == len(parts)
        seen += parts
    assert sorted(seen) == sorted(card)
    with pytest.raises(ValueError, match="does not fit a launch"):
        pl._scatter_table_args(spec, st, [(0, 0), divmod(64, K)], aggs)
