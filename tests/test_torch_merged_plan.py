"""The sharded lattice's merged launches (hstream_tpu_torch.parallel) on
the CPU: the merged changelog extract's plain version and its launch
plan against the reference's touched_local (hstream_tpu/parallel/
lattice.py ShardedLattice.extract_touched), and the merged launches'
plan: one launch a card at any number of partials.

The reference runs on conftest's 8 virtual CPU devices over meshes
(2, 2), (1, 4), (4, 1) and (2, 3); the port on the same shapes with
every shard on the CPU. The states are random, made with numpy from a
seed: counts, flags (a key shard touched nowhere), slot starts, SUM/AVG
sums that are whole numbers (so a merge's order cannot change a bit),
MIN/MAX with their identities, COUNT(col) counts, HLL ranks and sparse
histograms, at lattices whose key shards hold 24 cells (the kernel's one
launch) and 4,098 (staged, past one block's 4,096). Tolerances: every
row exact (the count, key ids, slot starts, counts, sums, averages,
MIN/MAX, the fill columns) but the sketch estimates: HLL within rel
1e-6 (XLA's log of the linear count differs from the port's by an ulp)
and APPROX_QUANTILE within rel 4e-6 (the same bucket's midpoint: XLA
contracts the estimate's exp argument into an FMA, tests/
torch_parity.py); the launch plan's model against the port's plain
version exact throughout.
"""

from __future__ import annotations

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hstream_tpu.engine import lattice as JL
from hstream_tpu.engine import sketches as JS
from hstream_tpu.parallel import make_mesh as jmake_mesh
from hstream_tpu.parallel.lattice import ShardedLattice as JShardedLattice
from hstream_tpu_torch.engine import lattice as tl
from hstream_tpu_torch.engine import sketches as TS
from hstream_tpu_torch.engine.kernels import binding as kb
from hstream_tpu_torch.parallel import lattice as pl
from hstream_tpu_torch.parallel import make_mesh
from torch_parity import JM, TM

MESHES = [(2, 2), (1, 4), (4, 1), (2, 3)]
# keys a key shard: 8 x 3 slots within one block's scan, 1366 x 3 past it
REGIMES = {"one": 8, "staged": 1366}
WHICH = ("cnt", "total", "avg", "mn", "mx", "c", "u", "p50")


def _aggs(m):
    temp = m.Col("temp")
    table = {
        "cnt": m.AggSpec(m.AggKind.COUNT_ALL, "cnt"),
        "total": m.AggSpec(m.AggKind.SUM, "total", input=temp),
        "avg": m.AggSpec(m.AggKind.AVG, "avg", input=temp),
        "mn": m.AggSpec(m.AggKind.MIN, "mn", input=temp),
        "mx": m.AggSpec(m.AggKind.MAX, "mx", input=temp),
        "c": m.AggSpec(m.AggKind.COUNT, "c", input=temp),
        "u": m.AggSpec(m.AggKind.APPROX_COUNT_DISTINCT, "u", input=temp),
        "p50": m.AggSpec(m.AggKind.APPROX_QUANTILE, "p50", input=temp,
                         quantile=0.5),
    }
    return tuple(table[w] for w in WHICH)


def _spec(m, lat, n_keys: int):
    """A spec of every kind a mesh takes, small sketches (HLL p = 4, 32
    quantile bins) so the staged lattices stay small."""
    sk = JS if lat is JL else TS
    return lat.LatticeSpec(
        n_keys=n_keys, window=m.TumblingWindow(10_000, grace_ms=0),
        aggs=_aggs(m), hll=sk.HLLConfig(precision=4),
        qcfg=sk.QuantileConfig(n_bins=32), track_touched=True)


def _schema(m):
    return m.Schema.of(device=m.ColumnType.STRING, temp=m.ColumnType.FLOAT)


def _random_state(spec, D: int, seed: int) -> dict[str, np.ndarray]:
    """The reference's sharded state [D, K, W, ...] (slot_start [D, W]),
    every plane drawn at random within what a step leaves."""
    rng = np.random.default_rng(seed)
    one = {k: np.asarray(v) for k, v in JL.init_state(spec).items()}
    st = {k: np.broadcast_to(v[None], (D,) + v.shape).copy()
          for k, v in one.items()}
    shape = st["count"].shape
    st["count"][:] = np.where(rng.random(shape) < 0.3, 0,
                              rng.integers(1, 40, shape))
    st["touched"][:] = rng.random(shape) < 0.4
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
                n = st[JL._plane_name(i, agg) + "_n"]
                n[:] = rng.integers(0, 40, shape)
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


def _rows_of(spec, kind) -> list[int]:
    row, out = 3, []
    for agg in spec.aggs:
        if agg.kind == kind:
            out.append(row)
        row += tl.agg_width(agg)
    return out


def _assert_touched_equal(want, got, spec) -> None:
    """Exact but the sketch estimates: HLL rel 1e-6 (XLA's log of the
    linear count against the port's), APPROX_QUANTILE rel 4e-6."""
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape
    h = _rows_of(spec, TM.AggKind.APPROX_COUNT_DISTINCT)
    q = _rows_of(spec, TM.AggKind.APPROX_QUANTILE)
    rest = [r for r in range(want.shape[1]) if r not in h + q]
    assert np.array_equal(want[:, rest], got[:, rest]), \
        np.argwhere(want[:, rest] != got[:, rest])[:5]
    for rows, rtol in ((h, 1e-6), (q, 4e-6)):
        np.testing.assert_allclose(got[:, rows].view(np.float32),
                                   want[:, rows].view(np.float32),
                                   rtol=rtol)


@pytest.fixture(scope="module")
def jmeshes():
    return {m: jmake_mesh(n_data=m[0], n_key=m[1]) for m in MESHES}


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_merged_touched_matches_touched_local(jmeshes, mesh, regime):
    """The plain merged extract and the launch plan's model against the
    reference's touched_local, at max_out of every cell and of a fifth
    of them (below the touched count, not a multiple of four where the
    kernel stores four columns at a time); the flags cleared in every
    partial; the port's plan picks the one launch or the staged one."""
    D, nk = mesh
    Kl = REGIMES[regime]
    jspec = _spec(JM, JL, Kl * nk)
    tspec = _spec(TM, tl, Kl)
    assert tl.touched_plan(tspec, 1) == (kb.TOUCHED_ONE if regime == "one"
                                        else kb.TOUCHED_STAGED)
    host = _random_state(jspec, D, seed=11 * D + nk)
    if nk > 1:      # the last key shard touched nowhere
        host["touched"][:, (nk - 1) * Kl:] = False
    cells = Kl * tspec.n_slots
    for mo in (cells, cells // 5 + 1):
        jsl = JShardedLattice(jspec, _schema(JM), None, mo, jmeshes[mesh],
                              ())
        jstate = {k: jnp.asarray(v) for k, v in host.items()}
        jout, want = jsl.extract_touched(jstate)
        want = np.asarray(want)
        assert want.shape == (nk, 3 + tl.out_rows(tspec), mo)
        assert (want[:, 0, 0] > 0).sum() == (nk - 1 if nk > 1 else 1)
        if mo < cells:
            assert want[:, 0, 0].max() > mo
        got = pl.touched_merged(tspec, _to_port(host, nk), mo)
        _assert_touched_equal(want, got.numpy(), tspec)
        state = _to_port(host, nk)
        plan = pl.touched_merged_launches_ref(tspec, state, mo)
        assert torch.equal(plan, got)
        for row in state:
            for part in row:
                assert not part["touched"].any()
        assert not np.asarray(jout["touched"]).any()


def _cpu_state(mesh, devices=("cpu",)):
    """A mesh's partials as merged_groups reads them: each a count plane
    that names its shard's device."""
    m = make_mesh(*mesh, devices=list(devices))
    return pl.ShardedState(
        [{"count": types.SimpleNamespace(device=m.devices[d, k])}
         for k in range(mesh[1])] for d in range(mesh[0]))


@pytest.mark.parametrize("mesh,sizes", [
    ((2, 2), [2]), ((4, 4), [4]), ((2, 16), [16]), ((1, 24), [24]),
    ((3, 7), [7]), ((16, 1), [1]), ((2, 40), [40])])
def test_merged_groups_cut_a_card_at_16_partials(mesh, sizes):
    """No cut past 16 partials any more (the name is the old limit's):
    every key shard of a card in one launch, in key order, whatever the
    number of partials, which the kernels read through the partial table
    on the card."""
    groups = pl.merged_groups(_cpu_state(mesh))
    assert [len(ks) for _d, ks in groups] == sizes
    assert sum((ks for _d, ks in groups), []) == list(range(mesh[1]))


def test_merged_groups_one_card_each_launch():
    """A mesh wrapped over two cards: one launch a card, each with the
    key shards whose data-0 partials lie on it."""
    a, b = torch.device("cpu", 0), torch.device("cpu", 1)
    groups = pl.merged_groups(_cpu_state((2, 20), devices=(a, b)))
    assert groups == [(a, list(range(0, 20, 2))),
                      (b, list(range(1, 20, 2)))]


@pytest.mark.parametrize("mesh", [(17, 2), (32, 1)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_a_key_shard_past_16_partials_is_refused(mesh):
    """No longer refused (the name is the old limit's): a key shard of 17
    or 32 data shards runs in one launch, and the launches' model of the
    merged changelog extract and the snapshot merge's segment plan equal
    the plain versions exactly."""
    D, nk = mesh
    tspec = _spec(TM, tl, 4)
    host = _random_state(_spec(JM, JL, 4 * nk), D, seed=3 * D + nk)
    assert pl.merged_groups(_to_port(host, nk)) == \
        [(torch.device("cpu"), list(range(nk)))]
    want = pl.touched_merged_ref(tspec, _to_port(host, nk), 12)
    got = pl.touched_merged_launches_ref(tspec, _to_port(host, nk), 12)
    assert torch.equal(got, want)
    state = _to_port(host, nk)
    want = pl.merge_partials_ref(tspec, state)
    got = pl.merge_plan_ref(tspec, state)
    assert list(got) == list(want)
    for name, v in want.items():
        assert torch.equal(got[name], v), name


@pytest.mark.parametrize("mesh", [(2, 16), (1, 24)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_the_cut_plan_places_every_key_shard(mesh):
    """Past 16 partials, one launch: its buffers (launch-local key ids)
    placed as the wrapper places them equal the plain version over the
    whole mesh, exactly; every partial's flags cleared."""
    D, nk = mesh
    tspec = _spec(TM, tl, 4)
    host = _random_state(_spec(JM, JL, 4 * nk), D, seed=D + nk)
    state = _to_port(host, nk)
    assert len(pl.merged_groups(state)) == 1
    want = pl.touched_merged_ref(tspec, _to_port(host, nk), 12)
    got = pl.touched_merged_launches_ref(tspec, state, 12)
    assert torch.equal(got, want)
    for k in range(nk):      # global key ids, the fill's too
        assert ((got[k, 1] >= 4 * k) & (got[k, 1] < 4 * k + 4)).all()
    assert not any(p["touched"].any() for row in state for p in row)
