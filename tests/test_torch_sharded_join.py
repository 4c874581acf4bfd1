"""The port's key-sharded interval join (hstream_tpu_torch.parallel
ShardedJoinLattice and JoinExecutor's mesh branch) against the
reference's (hstream_tpu/parallel/lattice.py ShardedJoinLattice) on the
CPU.

The reference runs on conftest's 8 virtual CPU devices; the port on
make_mesh(..., devices=["cpu"]), every key shard's stores on the CPU,
where each wrapper runs its kernel's plain version. The executor cases
mirror tests/test_sharded_join.py: the final change per (key, window)
equals the reference's sharded executor's and the port's single-card
executor's, counts exact and SUM within rel 1e-6 (normal(1, 1) inputs
added in another order). The lattice cases mirror
tests/test_join_device.py::test_sharded_join_kernels_match_single_chip
against the reference's ShardedJoinLattice itself: match buffers column
by column in the reference's [rows, n_shards * match_cap] layout, every
shard's store planes and live counts exact, and the fused step's inner
partials exact (its inputs are multiples of 1/4, so every summation
order gives one float32 sum, as in tests/test_torch_join_lattice.py).

A key shard's insert leaves out the records it does not own, where the
reference keeps them as dead (sentinel, ts) entries; a store's first
`cap` places take such an entry only for a ts below the store
sentinels' 0, and the executor's rebase keeps every batch ts >= 0. The
stores are held whole where the batch's times are >= 0, and by their
live entries (the dead ones all sentinels) where some are negative.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from hstream_tpu.engine.snapshot import restore_executor as jrestore
from hstream_tpu.engine.snapshot import snapshot_executor as jsnapshot
from hstream_tpu.parallel import ShardedQueryExecutor as JSharded
from hstream_tpu.parallel.lattice import ShardedJoinLattice as JSJL
from hstream_tpu.sql import stream_codegen as jcodegen
from hstream_tpu.sql.codegen import make_executor as jmake
from hstream_tpu_torch.engine import convert
from hstream_tpu_torch.engine import join_lattice as jl
from hstream_tpu_torch.engine.snapshot import restore_executor, \
    snapshot_executor
from hstream_tpu_torch.parallel import ShardedQueryExecutor, make_mesh
from hstream_tpu_torch.parallel import lattice as pl
from hstream_tpu_torch.sql import stream_codegen as tcodegen
from hstream_tpu_torch.sql.codegen import make_executor as tmake
from test_torch_join_lattice import (
    WITHIN,
    _feed,
    _inner,
    batch_np,
    store_np,
)
from torch_parity import JM, TM

BASE = 1_700_000_000_000
SENT = jl.JOIN_SENT_CODE
SQL = ("SELECT l.k, COUNT(*) AS c, SUM(l.x) AS s FROM l INNER JOIN r "
       "WITHIN (INTERVAL 10 SECOND) ON l.k = r.k "
       "GROUP BY l.k, TUMBLING (INTERVAL 10 SECOND) "
       "GRACE BY INTERVAL 0 SECOND EMIT CHANGES;")
SAMPLE = [{"k": "k0", "x": 1.0}]


@pytest.fixture(scope="module")
def jmesh():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return Mesh(np.array(devs[:8]).reshape(1, 8), ("data", "key"))


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh(1, 8, devices=["cpu"])


def make_join(pkg, mesh=None, sql=SQL, **tune):
    if pkg == "jax":
        ex = jmake(jcodegen(sql), sample_rows=SAMPLE, mesh=mesh)
    else:
        ex = tmake(tcodegen(sql), sample_rows=SAMPLE, mesh=mesh,
                   device="cpu")
    for k, v in tune.items():
        setattr(ex, k, v)
    return ex


def run_batches(ex, batches, compact_at=()):
    out = []
    for i, (rows, ts, side) in enumerate(batches):
        out.extend(ex.process(rows, ts, stream=side))
        if i in compact_at and ex._dev is not None:
            ex._compact_codes()
    out.extend(ex.flush_changes())
    assert not ex.has_pending_changes()
    return out


def final_changes(rows):
    """Last change per (key, winStart): EMIT CHANGES retracts and
    re-emits, so the settled value is what compares."""
    return {(r["l.k"], r["winStart"]): (r["c"], r["s"]) for r in rows}


def assert_final_equal(want, got):
    assert set(want) == set(got)
    for k, (c, s) in want.items():
        assert got[k][0] == c, k
        assert got[k][1] == pytest.approx(s, rel=1e-6, abs=1e-9), k


def gen_batches(seed=3, n_batches=18, n=400, stride=900, jitter=1400,
                key_lo_step=23, key_span=120):
    """Alternating-side traffic: a rotating key population (code churn),
    a span past retention (eviction), out of order within each batch."""
    rng = np.random.default_rng(seed)
    batches = []
    for b in range(n_batches):
        lo = b * key_lo_step
        rows = [{"k": f"k{int(i)}", "x": float(v)}
                for i, v in zip(rng.integers(lo, lo + key_span, n),
                                rng.normal(1, 1, n))]
        ts = (BASE + b * stride
              + rng.integers(0, jitter, n).astype(np.int64))
        batches.append((rows, ts.tolist(), "l" if b % 2 else "r"))
    return batches


def test_sharded_join_matches_single_chip(jmesh, tmesh):
    """The same batches on the reference's mesh, the port's mesh and one
    card: equal settled rows, and the port's mesh took the fused sharded
    step (stores and inner aggregate both sharded)."""
    batches = gen_batches(seed=7, n_batches=10, n=250, key_lo_step=0,
                          key_span=40)
    want = final_changes(run_batches(make_join("jax", jmesh), batches))
    single = final_changes(run_batches(make_join("port"), batches))
    ex = make_join("port", tmesh)
    got = final_changes(run_batches(ex, batches))
    assert ex._dev is not None and ex._dev.get("sjl") is not None, \
        "the mesh did not shard the stores"
    assert isinstance(ex._inner, ShardedQueryExecutor)
    assert ex.join_stats["fused_batches"] > 0, "no fused sharded step"
    assert ex.sharded_dispatches > 0 and ex.device_fallbacks == 0
    assert_final_equal(want, got)
    assert_final_equal(single, got)


def test_sharded_join_evict_grow_compact(jmesh, tmesh):
    """Eviction, capacity growth (tiny first store capacities) and a code
    compaction mid-run (residue-preserving, host shadows re-sorted) on
    both packages' meshes; every settled row identical. The stores,
    compared after the run through convert.join_state, hold the same
    live entries per shard."""
    batches = gen_batches()
    jex = make_join("jax", jmesh, DEVICE_STORE_CAPACITY=256)
    want = final_changes(run_batches(jex, batches, (5, 11)))
    ex = make_join("port", tmesh, DEVICE_STORE_CAPACITY=256)
    got = final_changes(run_batches(ex, batches, (5, 11)))
    assert ex._dev is not None and ex._dev.get("sjl") is not None
    assert ex.join_stats["evict_dispatches"] > 0, "no sharded evict"
    assert ex.join_stats["store_grows"] > 0, "no sharded grow"
    assert_final_equal(want, got)
    ws, gs = convert.join_state(jex), convert.join_state(ex)
    assert ws["cap"] == gs["cap"] and ws["n"] == gs["n"]
    assert ws["jcode_rev"] == gs["jcode_rev"]
    for side in ("l", "r"):
        w, g = ws["stores"][side], gs["stores"][side]
        assert w["code"].shape == g["code"].shape == (8, gs["cap"])
        for s in range(8):
            live = w["code"][s] < SENT
            assert np.array_equal(live, g["code"][s] < SENT), (side, s)
            for k in ("code", "ts", "flags"):
                assert np.array_equal(w[k][s][live], g[k][s][live]), \
                    (side, s, k)
            assert np.array_equal(w["cols"][s][:, live],
                                  g["cols"][s][:, live]), (side, s)


def test_join_mesh_size_migration(jmesh, tmesh):
    """A snapshot on one mesh size restores onto another (one card <->
    eight key shards), in the port and across the packages: the blob
    holds the gathered host view of both stores and the inner lattice,
    the restore re-shards on activation, including the lazily built
    inner aggregate."""
    batches = gen_batches(seed=9, n_batches=12, n=200, stride=600,
                          jitter=800, key_lo_step=0, key_span=40)

    def run(pkg_a, mesh_a, pkg_b, mesh_b, cut=6):
        ex = make_join(pkg_a, mesh_a)
        out = []
        for rows, ts, side in batches[:cut]:
            out.extend(ex.process(rows, ts, stream=side))
        out.extend(ex.flush_changes())
        blob = (jsnapshot if pkg_a == "jax" else snapshot_executor)(ex)
        if pkg_b == "jax":
            ex2, _ = jrestore(jcodegen(SQL), blob, mesh=mesh_b)
        else:
            ex2, _ = restore_executor(tcodegen(SQL), blob, mesh=mesh_b,
                                      device="cpu")
        for rows, ts, side in batches[cut:]:
            out.extend(ex2.process(rows, ts, stream=side))
        out.extend(ex2.flush_changes())
        assert not ex2.has_pending_changes()
        return final_changes(out), ex, ex2

    base, _, _ = run("port", None, "port", None)
    up, _, ux = run("port", None, "port", tmesh)
    assert ux._dev is not None and ux._dev.get("sjl") is not None, \
        "the restore onto a mesh did not shard the join stores"
    assert getattr(ux._inner, "_sharded", None) is not None, \
        "the inner aggregate did not re-shard on restore"
    down, dx, dx2 = run("port", tmesh, "port", None)
    assert dx._dev is not None and dx._dev.get("sjl") is not None
    assert dx2._dev is None or dx2._dev.get("sjl") is None
    from_ref, _, fx = run("jax", jmesh, "port", tmesh)
    assert fx._dev is not None and fx._dev.get("sjl") is not None
    to_ref, _, _ = run("port", tmesh, "jax", jmesh)
    for other in (up, down, from_ref, to_ref):
        assert_final_equal(base, other)


# ---- the lattice entries against the reference's ----------------------------

S = 4


@pytest.fixture(scope="module")
def meshes():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return (Mesh(np.array(devs[:8]).reshape(2, S), ("data", "key")),
            make_mesh(2, S, devices=["cpu"]))


def shard_stores(rng, cap, n_cols, n_live):
    """Per-shard sorted stores [S, ...]: shard s's codes c * S + s, so
    each holds only codes it owns."""
    out = {k: [] for k in ("code", "ts", "flags", "cols")}
    for s in range(S):
        st = store_np(rng, cap, n_cols, n_live)
        live = st["code"] < SENT
        st["code"][live] = st["code"][live] * S + s
        for k in out:
            out[k].append(st[k])
    return {k: np.stack(v) for k, v in out.items()}


def sharded_batch(rng, bcap, n, n_cols, nonneg):
    """A sorted batch over the codes of every shard; with `nonneg`, its
    times shifted to >= 0 as the executor's rebase keeps them."""
    b = batch_np(rng, bcap, n, n_cols, codes=6 * S)
    if nonneg:
        b[1, :n] += 60
    return b


def port_stores(host):
    return [{k: torch.from_numpy(np.array(v[s])) for k, v in host.items()}
            for s in range(S)]


def host_of(stores):
    if isinstance(stores, list):
        return {k: np.stack([x[k].numpy() for x in stores])
                for k in stores[0]}
    return {k: np.array(v) for k, v in stores.items()}


def assert_stores(want, got, whole):
    """Per shard: every plane, or (not `whole`) the live entries, with the
    dead ones all sentinels in both."""
    for s in range(S):
        live = want["code"][s] < SENT
        assert np.array_equal(live, got["code"][s] < SENT), s
        if whole:
            for k in ("code", "ts", "flags", "cols"):
                assert np.array_equal(want[k][s], got[k][s]), (s, k)
            continue
        n = int(live.sum())
        assert live[:n].all()
        for k in ("code", "ts", "flags"):
            assert np.array_equal(want[k][s][:n], got[k][s][:n]), (s, k)
        assert np.array_equal(want["cols"][s][:, :n],
                              got["cols"][s][:, :n]), s
        assert jl.store_sorted({k: torch.from_numpy(got[k][s])
                                for k in ("code", "ts")})


@pytest.mark.parametrize("nonneg", [True, False])
@pytest.mark.parametrize("case", [(64, 16, 12, 64), (256, 64, 50, 8),
                                  (64, 16, 0, 16)])
def test_probe_insert_and_probe_only_match_the_reference(meshes, case,
                                                         nonneg):
    """Both sides over six batches: the match buffers in the reference's
    layout (per-shard headers at column s * match_cap, a truncated shard
    included), probe_only, unpack_matches, then the eviction's stores and
    live counts [S, 2]."""
    cap, bcap, n, mc = case
    rng = np.random.default_rng(cap + n + nonneg)
    nm = no = 2
    jsj = JSJL(meshes[0], "key", cap, bcap, mc, nm, no)
    tsj = pl.ShardedJoinLattice(meshes[1], nm, no)
    host = {"l": shard_stores(rng, cap, nm, cap // 4),
            "r": shard_stores(rng, cap, no, cap // 4)}
    jst = {side: jsj.put_store(h) for side, h in host.items()}
    tst = {side: port_stores(h) for side, h in host.items()}
    cutoff = -(1 << 31) if n % 2 else -20
    for b in range(6):
        side, other = ("l", "r") if b % 2 else ("r", "l")
        batch = sharded_batch(rng, bcap, n, nm, nonneg)
        jst[side], jpk = jsj.probe_insert(
            side, jst[side], jst[other], jnp.asarray(batch), np.int32(n),
            np.int32(WITHIN), np.int32(cutoff))
        tst[side], tpk = tsj.probe_insert(
            side, tst[side], tst[other], torch.from_numpy(batch), n,
            WITHIN, cutoff, mc)
        jpk = np.asarray(jpk)
        assert tpk.shape == jpk.shape == (5 + nm + no, S * mc)
        for c in range(jpk.shape[1]):
            assert np.array_equal(tpk[:, c].numpy(), jpk[:, c]), (b, c)
        assert_stores(host_of(jst[side]), host_of(tst[side]), nonneg)
        want = jsj.unpack_matches(jpk, side)
        got = tsj.unpack_matches(tpk.numpy(), side)
        assert want[0] == got[0]
        for w, g in zip(want[1:], got[1:]):
            assert np.array_equal(w, g)
        jpo = np.asarray(jsj.probe_only(side, jst[other], jnp.asarray(batch),
                                        np.int32(n), np.int32(WITHIN),
                                        np.int32(cutoff), 2 * mc))
        tpo = tsj.probe_only(side, tst[other], torch.from_numpy(batch), n,
                             WITHIN, cutoff, 2 * mc)
        assert np.array_equal(tpo.numpy(), jpo)
    jl_, jr_, jn = jsj.evict(jst["l"], jst["r"], np.int32(40), np.int32(7))
    tl_, tr_, tn = tsj.evict(tst["l"], tst["r"], 40, 7)
    assert tn.shape == (S, 2) and np.array_equal(tn.numpy(), np.asarray(jn))
    assert_stores(host_of(jl_), host_of(tl_), nonneg)
    assert_stores(host_of(jr_), host_of(tr_), nonneg)


@pytest.mark.parametrize("where", [False, True])
@pytest.mark.parametrize("feed_name", ["left", "right"])
@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 4)])
def test_fused_step_matches_the_reference(meshes, feed_name, where,
                                          mesh_shape):
    """The fused step into an inner lattice on the same mesh (data-shard
    routing by i mod n_data on (2, 4)): per-shard totals, the inner
    partials plane by plane, and the stores."""
    D, K = mesh_shape
    jmesh = Mesh(np.array(jax.devices()[:D * K]).reshape(D, K),
                 ("data", "key"))
    tmesh = make_mesh(D, K, devices=["cpu"])
    cap, bcap, n, mc = 256, 64, 50, 128
    nm = no = 3
    rng = np.random.default_rng(D + len(feed_name) + where)
    jnode, jschema = _inner(JM, where)
    tnode, tschema = _inner(TM, where)
    jex = JSharded(jnode, jschema, mesh=jmesh, initial_keys=8)
    tex = ShardedQueryExecutor(tnode, tschema, mesh=tmesh, initial_keys=8)
    feed = _feed(feed_name, jex, where)
    assert feed == _feed(feed_name, tex, where)
    jsj = JSJL(jmesh, "key", cap, bcap, mc, nm, no)
    tsj = pl.ShardedJoinLattice(tmesh, nm, no)
    mine = shard_stores(rng, cap, nm, cap // 3)
    other = shard_stores(rng, cap, no, cap // 2)
    b = sharded_batch(rng, bcap, n, nm, True)
    b[2, :n] = rng.integers(0, 8, n)             # inner key ids
    jstate = jex._sharded.init_state()
    tstate = tex._sharded.init_state()
    wm_rel, ts_off = 120, 300
    jmine, jstate, jtot = jsj.probe_insert_step(
        "l", jex._sharded, jsj.put_store(mine), jsj.put_store(other),
        jnp.asarray(b), np.int32(n), np.int32(WITHIN), np.int32(-30),
        jstate, np.int32(wm_rel), np.int32(ts_off), feed_plan=feed[0],
        nulls_plan=feed[1], filter_nulls=feed[2])
    tmine, tstate2, ttot = tsj.probe_insert_step(
        "l", tex._sharded, port_stores(mine), port_stores(other),
        torch.from_numpy(b), n, WITHIN, -30, tstate, wm_rel, ts_off,
        feed_plan=feed[0], nulls_plan=feed[1], filter_nulls=feed[2],
        match_cap=mc)
    assert tstate2 is tstate
    assert np.array_equal(ttot.numpy(), np.asarray(jtot))
    assert int(np.asarray(jtot).sum()) > 0
    assert_stores(host_of(jmine), host_of(tmine), True)
    Kl = tex._sharded.local_spec.n_keys
    for name, v in jstate.items():
        w = np.asarray(v)
        for d in range(D):
            for k in range(K):
                g = tstate[d][k][name].numpy()
                if name == "slot_start":
                    assert np.array_equal(w[d], g), (name, d, k)
                else:
                    assert np.array_equal(w[d, k * Kl:(k + 1) * Kl], g), \
                        (name, d, k)
    assert sum(int(p["count"].sum()) for row in tstate for p in row) > 0


def test_route_matches_the_reference_routing():
    """The plain model of the routing the table scatter does as it reads
    each feed entry: key column k = kid - k * Kl (int32 wrap), valid row
    d = valid & (i mod n_data == d)."""
    rng = np.random.default_rng(4)
    m = 300
    kid = torch.from_numpy(rng.integers(-5, 40, m).astype(np.int32))
    kid[0] = (1 << 31) - 1
    valid = torch.from_numpy(rng.random(m) < 0.7)
    keys, vd = pl.join_route_ref(kid, valid, 3, 4, 10)
    i = np.arange(m)
    for k in range(4):
        want = (kid.numpy().astype(np.int64) - 10 * k).astype(np.int32)
        assert np.array_equal(keys[k].numpy(), want)
    for d in range(3):
        assert np.array_equal(vd[d].numpy(), valid.numpy() & (i % 3 == d))
