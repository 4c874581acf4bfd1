"""The sharded lattice past 16 partials (hstream_tpu_torch.parallel) on the
CPU: meshes whose key shards on one card, or whose data shards, pass the
16 partials the merged kernels once took.

* ShardedQueryExecutor on make_mesh(1, 17), (1, 24), (2, 16) and
  (32, 1), every shard on the CPU (the wrappers' plain versions), against
  the reference's single-chip QueryExecutor and the port's single-card
  one on the same batches (test_parallel.py's generator): every call's
  rows, keys, window bounds, counts, HLL estimates, MIN/MAX exact and
  float32 SUM/AVG at rel 1e-6 (the partials' sums taken in another
  order), closed rows and EMIT CHANGES alike.
* The snapshot merge at D = 17 and 32 against the reference's
  _merge_partials on its [D, K, ...] state (it reads .spec and .state
  alone), and the segment plan of its one launch (merge_plan_ref)
  against the plain version: exact (random states whose sums are whole
  numbers, so no merge order changes a bit).
* The merged close's and changelog extract's plain versions at D = 17
  against the single-card versions on the merged lattice (their
  one-partial merge): exact.
* The partial table's host side: an entry for every (key shard, data
  shard, plane), and its cache a card, which builds a new table when a
  pointer changes and reuses the one it has when none does.
"""

from __future__ import annotations

import ctypes
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hstream_tpu.engine as J
from hstream_tpu.engine import lattice as JL
from hstream_tpu.engine import sketches as JS
from hstream_tpu.engine.snapshot import _merge_partials
import hstream_tpu_torch.engine as T
from hstream_tpu_torch.engine import lattice as tl
from hstream_tpu_torch.engine import sketches as TS
from hstream_tpu_torch.engine.kernels import binding as kb
from hstream_tpu_torch.parallel import ShardedQueryExecutor, make_mesh
from hstream_tpu_torch.parallel import lattice as pl
from torch_parity import JM, TM, assert_rows_equal

BASE = 1_700_000_000_000
MESHES = [(1, 17), (1, 24), (2, 16), (32, 1)]


def _aggs(m, which):
    temp = m.Col("temp")
    every = {
        "cnt": m.AggSpec(m.AggKind.COUNT_ALL, "cnt"),
        "total": m.AggSpec(m.AggKind.SUM, "total", input=temp),
        "mn": m.AggSpec(m.AggKind.MIN, "mn", input=temp),
        "mx": m.AggSpec(m.AggKind.MAX, "mx", input=temp),
        "avg": m.AggSpec(m.AggKind.AVG, "avg", input=temp),
        "c": m.AggSpec(m.AggKind.COUNT, "c", input=temp),
        "u": m.AggSpec(m.AggKind.APPROX_COUNT_DISTINCT, "u", input=temp),
        "p50": m.AggSpec(m.AggKind.APPROX_QUANTILE, "p50", input=temp,
                         quantile=0.5),
    }
    return [every[w] for w in which]


def _schema(m):
    return m.Schema.of(device=m.ColumnType.STRING, temp=m.ColumnType.FLOAT)


def _node(m, which):
    return m.AggregateNode(child=m.SourceNode("s", _schema(m)),
                           group_keys=[m.Col("device")],
                           window=m.TumblingWindow(10_000, grace_ms=0),
                           aggs=_aggs(m, which))


def _rows(n, n_keys=40, seed=0):
    """test_parallel.py's generator."""
    rng = np.random.default_rng(seed)
    rows = [{"device": f"d{int(rng.integers(n_keys))}",
             "temp": float(rng.normal(10.0, 5.0))} for _ in range(n)]
    ts = [BASE + int(t) for t in np.sort(rng.integers(0, 25_000, size=n))]
    return rows, ts


CASES = {
    "closed rows": (["cnt", "total", "mn", "mx", "avg", "u"], False),
    "emit changes": (["cnt", "total", "p50"], True),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_executor_past_16_partials_matches_the_single_chip(mesh, case):
    """Every call's rows (three batches and a closer) equal the
    reference's single-chip executor's and the port's single-card
    executor's; the emitted rows are not empty."""
    which, changes = CASES[case]
    kw = dict(emit_changes=changes, batch_capacity=256)
    tex = ShardedQueryExecutor(_node(TM, which), _schema(TM),
                               mesh=make_mesh(*mesh, devices=["cpu"]),
                               initial_keys=2 * mesh[1], **kw)
    jex = J.QueryExecutor(_node(JM, which), _schema(JM), initial_keys=16,
                          **kw)
    single = T.QueryExecutor(_node(TM, which), _schema(TM), device="cpu",
                             initial_keys=16, **kw)
    rows, ts = _rows(600, seed=mesh[0] + mesh[1])
    calls = [(rows[i:i + 200], ts[i:i + 200]) for i in range(0, 600, 200)]
    calls.append(([{"device": "d0", "temp": 0.0}], [BASE + 80_000]))
    n = 0
    for batch in calls:
        want = {(r["device"], r["winStart"]): r for r in jex.process(*batch)}
        got = {(r["device"], r["winStart"]): r for r in tex.process(*batch)}
        one = {(r["device"], r["winStart"]): r
               for r in single.process(*batch)}
        assert set(got) == set(want) == set(one)
        for key in want:
            assert_rows_equal([want[key]], [got[key]], quantiles=("p50",))
            assert_rows_equal([one[key]], [got[key]], quantiles=("p50",))
        n += len(got)
    assert n > 0
    assert tex.state.n_data == mesh[0] and tex.state.n_key == mesh[1]


def _random_state(spec, D: int, seed: int) -> dict[str, np.ndarray]:
    """The reference's sharded state [D, K, W, ...] (slot_start [D, W]),
    every plane drawn within what a step leaves; sums whole numbers."""
    rng = np.random.default_rng(seed)
    one = {k: np.asarray(v) for k, v in JL.init_state(spec).items()}
    st = {k: np.broadcast_to(v[None], (D,) + v.shape).copy()
          for k, v in one.items()}
    shape = st["count"].shape
    st["count"][:] = np.where(rng.random(shape) < 0.3, 0,
                              rng.integers(1, 40, shape))
    st["touched"][:] = rng.random(shape) < 0.2
    W = st["slot_start"].shape[1]
    st["slot_start"][:] = np.where(rng.random((D, W)) < 0.2,
                                   JL.EMPTY_START,
                                   rng.integers(-(1 << 30), 1 << 30, (D, W)))
    for i, agg in enumerate(spec.aggs):
        kind = agg.kind.value
        if kind == "count_all":
            continue
        p = st[JL._plane_name(i, agg)]
        if kind in ("sum", "avg"):
            p[:] = rng.integers(-9999, 9999, p.shape)
            if kind == "avg":
                st[JL._plane_name(i, agg) + "_n"][:] = \
                    rng.integers(0, 40, shape)
        elif kind in ("min", "max"):
            p[:] = rng.integers(-99, 99, p.shape)
            p[rng.random(p.shape) < 0.2] = np.inf if kind == "min" \
                else -np.inf
        elif kind == "count":
            p[:] = rng.integers(0, 40, p.shape)
        elif kind == "approx_count_distinct":
            p[:] = np.where(rng.random(p.shape) < 0.5,
                            rng.integers(1, 34 - spec.hll.precision, p.shape),
                            0)
        else:   # approx_quantile
            p[:] = np.where(rng.random(p.shape) < 0.2,
                            rng.integers(1, 9, p.shape), 0)
    return st


def _to_port(host: dict[str, np.ndarray], n_key: int) -> pl.ShardedState:
    D, K = host["count"].shape[:2]
    Kl = K // n_key
    return pl.ShardedState(
        [{name: torch.from_numpy(np.array(
            v[d] if name == "slot_start" else v[d, k * Kl:(k + 1) * Kl]))
          for name, v in host.items()} for k in range(n_key)]
        for d in range(D))


WHICH = ["cnt", "total", "avg", "mn", "mx", "c", "u", "p50"]


def _spec(m, lat, n_keys: int):
    """Every kind a mesh takes, small sketches (HLL p = 4, 32 bins)."""
    sk = JS if lat is JL else TS
    return lat.LatticeSpec(
        n_keys=n_keys, window=m.TumblingWindow(10_000, grace_ms=30_000),
        aggs=tuple(_aggs(m, WHICH)), hll=sk.HLLConfig(precision=4),
        qcfg=sk.QuantileConfig(n_bins=32), track_touched=True)


@pytest.mark.parametrize("mesh", [(17, 1), (17, 3), (32, 1), (32, 2)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_snapshot_merge_past_16_partials(mesh):
    """merge_partials (plain) and its launch's segment plan against the
    reference's _merge_partials: every canonical plane exact, the key
    shards in global order; Kl = 5 keys, so a key shard's flags (15
    bytes) are no multiple of 16 and go element by element."""
    D, nk = mesh
    jspec = _spec(JM, JL, 5 * nk)
    host = _random_state(jspec, D, seed=7 * D + nk)
    want = _merge_partials(types.SimpleNamespace(
        spec=jspec, state={k: jnp.asarray(v) for k, v in host.items()}))
    tspec = _spec(TM, tl, 5)
    got = pl.merge_partials(tspec, _to_port(host, nk))
    plan = pl.merge_plan_ref(tspec, _to_port(host, nk))
    assert list(got) == list(plan) and set(got) == set(want)
    for name, v in want.items():
        v = np.asarray(v)
        assert got[name].numpy().dtype == v.dtype, name
        assert np.array_equal(got[name].numpy(), v), name
        assert torch.equal(plan[name], got[name]), name
    segs = pl.merge_plan(tspec, [_to_port(host, nk).key_shard(k)
                                 for k in range(nk)])
    assert len(segs) == (len(got) - 1) * nk + 1
    assert not any(sg.vec for sg in segs
                   if sg.plane == kb.PART_TOUCHED and sg.shard > 0)


@pytest.mark.parametrize("mode", ["extract reset", "extract", "reset"])
def test_merged_close_at_17_partials_is_the_one_partial_close(mode):
    """close_merged_ref over (17, 2) against extract_slots_ref /
    reset_slots_ref of the merged lattice: the rows exact, and after a
    reset every partial's slots at the identities (their merge is the
    single-card reset)."""
    D, nk = 17, 2
    tspec = _spec(TM, tl, 6)
    gspec = _spec(TM, tl, 6 * nk)
    host = _random_state(_spec(JM, JL, 6 * nk), D, seed=5)
    state = _to_port(host, nk)
    merged = pl.merge_partials_ref(tspec, state)
    slots = tl.pad_slots(np.array([2, 0], np.int32))
    kind = {"extract reset": pl.CLOSE_EXTRACT_RESET,
            "extract": pl.CLOSE_EXTRACT, "reset": pl.CLOSE_RESET}[mode]
    got = pl.close_merged_ref(tspec, state, slots, kind)
    if kind != pl.CLOSE_RESET:
        want = tl.extract_slots_ref(gspec, merged, torch.from_numpy(slots))
        assert torch.equal(got, want)
    if kind != pl.CLOSE_EXTRACT:
        tl.reset_slots_ref(gspec, merged, torch.from_numpy(slots))
    after = pl.merge_partials_ref(tspec, state)
    for name, v in merged.items():
        assert torch.equal(after[name], v), name


def test_merged_extract_at_17_partials_is_the_one_partial_extract():
    """touched_merged_ref over (17, 1), at max_out of every cell and of a
    third of them, against extract_touched_ref of the merged lattice:
    exact, and every partial's flags cleared."""
    tspec = _spec(TM, tl, 7)
    host = _random_state(_spec(JM, JL, 7), 17, seed=9)
    cells = tspec.n_keys * tspec.n_slots
    for mo in (cells, cells // 3):
        state = _to_port(host, 1)
        merged = pl.merge_partials_ref(tspec, state)
        want = tl.extract_touched_ref(tspec, merged, mo)
        got = pl.touched_merged_ref(tspec, state, mo)
        assert int(want[0, 0]) > 0
        assert torch.equal(got[0], want)
        assert not any(p["touched"].any() for row in state for p in row)


def test_part_table_has_every_partials_planes():
    """part_table_key: key shard s's data shard d's plane i at entry
    (s * D + d) * (3 + 2 n_aggs) + i, every plane of every partial once,
    nothing where the query has no plane (COUNT(*), a non-AVG's count)."""
    D, nk = 3, 4
    tspec = _spec(TM, tl, 2)
    state = _to_port(_random_state(_spec(JM, JL, 2 * nk), D, seed=1), nk)
    by_key = [state.key_shard(k) for k in range(nk)]
    key = pl.part_table_key(tspec, by_key)
    n_planes = pl.part_planes(tspec)
    assert n_planes == 3 + 2 * len(WHICH) and len(key) == nk * D * n_planes
    want = {p[name].data_ptr() for row in state for p in row for name in p}
    assert {a for a in key if a} == want
    assert sum(1 for a in key if a) == len(want)
    for s in range(nk):
        for d in range(D):
            base = (s * D + d) * n_planes
            part = state[d][s]
            assert key[base + kb.PART_COUNT] == part["count"].data_ptr()
            assert key[base + kb.PART_SLOT_START] == \
                part["slot_start"].data_ptr()
            assert key[base + kb.PART_TOUCHED] == part["touched"].data_ptr()
            for g, agg in enumerate(tspec.aggs):
                name = tl._plane_name(g, agg)
                plane = key[base + 3 + 2 * g]
                count = key[base + 4 + 2 * g]
                if agg.kind == TM.AggKind.COUNT_ALL:
                    assert plane == 0
                else:
                    assert plane == part[name].data_ptr()
                assert count == (part[name + "_n"].data_ptr()
                                 if agg.kind == TM.AggKind.AVG else 0)


def test_part_table_cache_uploads_only_when_a_pointer_changes():
    """The cache a card: the same partials (updated in place, as steps and
    closes update them) reuse their table; a partial with a new plane (a
    restore's) builds a new one; the old key's table is kept; the
    segment table of the snapshot merge follows the same key and the
    planes' sizes."""
    tspec = _spec(TM, tl, 3)
    host = _random_state(_spec(JM, JL, 6), 2, seed=2)
    state = _to_port(host, 2)
    by_key = [state.key_shard(k) for k in range(2)]
    dev = torch.device("cpu")
    before = pl.part_table.uploads
    tab = pl.part_table(tspec, by_key, dev)
    assert pl.part_table.uploads == before + 1
    assert tab.dtype == torch.int64
    assert tuple(tab.tolist()) == pl.part_table_key(tspec, by_key)
    for row in state:            # in place: no new table
        for p in row:
            p["count"].add_(1)
            p["touched"].zero_()
    assert pl.part_table(tspec, by_key, dev) is tab
    assert pl.part_table.uploads == before + 1
    state[1][0]["count"] = state[1][0]["count"].clone()   # a new plane
    by_key = [state.key_shard(k) for k in range(2)]
    tab2 = pl.part_table(tspec, by_key, dev)
    assert pl.part_table.uploads == before + 2 and tab2 is not tab
    assert int(tab2[(0 * 2 + 1) * pl.part_planes(tspec)]) == \
        state[1][0]["count"].data_ptr()
    assert pl.part_table(tspec, by_key, dev) is tab2
    key = pl.part_table_key(tspec, by_key)
    segs0 = pl.merge_segments.uploads
    first = pl.merge_segments(tspec, by_key, dev, key)
    assert pl.merge_segments(tspec, by_key, dev, key) is first
    assert pl.merge_segments.uploads == segs0 + 1
    buf, n_seg, n_blocks = first
    assert n_seg == (len(state[0][0]) - 1) * 2 + 1
    blocks = np.frombuffer(buf.numpy().tobytes()[
        n_seg * ctypes.sizeof(kb.MergeSeg):], np.int32)
    assert len(blocks) == n_blocks and blocks.tolist() == sorted(blocks)

