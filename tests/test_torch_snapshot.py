"""Operator-state snapshots in the port (hstream_tpu_torch/engine/
snapshot.py) against hstream_tpu's, all from SQL text on device="cpu".

Covers the reference's round trips (tests/test_checkpoint_resume.py's
five unit cases, the TOPK and table-join round trips of
test_topk_tablejoin.py, the device join's round trip and host store view
of test_join_device.py, the session's device-mode round trip and drained-
closes guard of test_session_device.py), cross-restore both ways for
every executor kind (a JAX blob restored by the port and a port blob by
the JAX package, each continuing to the rows an uninterrupted run
emits), the blob's format (the same npz entries, dtypes and meta),
sealing (a flipped bit or a truncation is caught, a wrong version
refused), and a capture that keeps its planes while later steps change
the executor's.

Rows compare as the reference's round-trip tests compare them: sorted,
floats rounded to 6 decimals (the inputs keep float32 sums exact); the
device join by its final change per (key, window); sessions by
test_session_device.assert_rows_close (floats rel 1e-5).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hstream_tpu.engine import snapshot as jsnap
from hstream_tpu.sql import codegen as jcg
from hstream_tpu.sql import stream_codegen as jcodegen
from hstream_tpu_torch.common.errors import (
    NotPortedError,
    SQLCodegenError,
    StoreError,
)
from hstream_tpu_torch.engine import snapshot as tsnap
from hstream_tpu_torch.sql import codegen as tcg
from hstream_tpu_torch.sql import stream_codegen as tcodegen
from test_join_device import final_changes, gen_batches
from test_session_device import assert_rows_close
from test_session_device import gen as session_gen
from torch_parity import BASE

PKG = {
    "jax": (jcodegen, jcg.make_executor, jsnap, {}),
    "torch": (tcodegen, tcg.make_executor, tsnap, {"device": "cpu"}),
}


def _make(pkg, sql, sample, **kw):
    codegen, make, _snap, dev = PKG[pkg]
    plan = codegen(sql)
    return plan, make(plan, sample_rows=sample, **kw, **dev)


def _restore(pkg, plan, blob, **kw):
    _c, _m, snap, dev = PKG[pkg]
    return snap.restore_executor(plan, blob, **kw, **dev)


def _feed(ex, batch):
    rows, ts, *origin = batch
    if origin:
        return list(ex.process(rows, ts, stream=origin[0]))
    return list(ex.process(rows, ts))


def _norm(rows):
    return sorted(
        tuple(sorted((k, round(v, 6) if isinstance(v, float) else v)
                     for k, v in r.items()))
        for r in rows)


def run_split(sql, batches, split, src="torch", dst="torch", **kw):
    """Rows of (a) an uninterrupted `src` executor and (b) one whose state
    is snapshotted by `src` after it took batch `split` (the reference's
    tests snapshot before it), sealed, opened and restored by `dst`,
    which takes the remaining batches."""
    sample = batches[0][0]
    _plan, a = _make(src, sql, sample, **kw)
    _plan, b = _make(src, sql, sample, **kw)
    out_a, out_b = [], []
    for i, batch in enumerate(batches):
        out_a.extend(_feed(a, batch))
        out_b.extend(_feed(b, batch))
        if i == split:
            blob = PKG[src][2].snapshot_executor(b, {"mark": 42})
            blob = PKG[dst][2].open_blob(PKG[src][2].seal_blob(blob))
            b, extra = _restore(dst, PKG[dst][0](sql), blob, **kw)
            assert extra == {"mark": 42}
    return out_a, out_b, b


# ---- the reference's round trips (test_checkpoint_resume.py:65-135) --------

ROUND_TRIPS = {
    "lattice_mid_window": (
        "SELECT device, COUNT(*) AS c, SUM(temp) AS s, MIN(temp) AS lo "
        "FROM s GROUP BY device, TUMBLING (INTERVAL 10 SECOND) "
        "GRACE BY INTERVAL 0 SECOND EMIT CHANGES;",
        [([{"device": "a", "temp": 1.0}, {"device": "b", "temp": 5.0}],
          [BASE, BASE + 100]),
         ([{"device": "a", "temp": 2.0}], [BASE + 5000]),
         ([{"device": "c", "temp": 9.0}], [BASE + 15_000]),
         ([{"device": "c", "temp": 1.0}], [BASE + 30_000])]),
    "lattice_sketches_and_strings": (
        "SELECT k, APPROX_COUNT_DISTINCT(v) AS d, AVG(v) AS m FROM s "
        "WHERE tag = 'keep' GROUP BY k, TUMBLING (INTERVAL 10 SECOND) "
        "GRACE BY INTERVAL 0 SECOND EMIT CHANGES;",
        [([{"k": "x", "v": float(i % 7), "tag": "keep"} for i in range(40)]
          + [{"k": "x", "v": 99.0, "tag": "drop"}],
          [BASE + i for i in range(41)]),
         ([{"k": "x", "v": float(i % 5), "tag": "keep"} for i in range(20)],
          [BASE + 2000 + i for i in range(20)]),
         ([{"k": "z", "v": 0.0, "tag": "keep"}], [BASE + 20_000])]),
    "session": (
        "SELECT user, COUNT(*) AS c FROM s GROUP BY user, "
        "SESSION (INTERVAL 5 SECOND) GRACE BY INTERVAL 0 SECOND "
        "EMIT CHANGES;",
        [([{"user": "u1"}, {"user": "u2"}], [BASE, BASE + 1000]),
         ([{"user": "u1"}], [BASE + 3000]),
         ([{"user": "u1"}], [BASE + 40_000])]),
    "join": (
        "SELECT l.k, COUNT(*) AS c FROM l INNER JOIN r "
        "WITHIN (INTERVAL 5 SECOND) ON l.k = r.k "
        "GROUP BY l.k, TUMBLING (INTERVAL 10 SECOND) "
        "GRACE BY INTERVAL 0 SECOND EMIT CHANGES;",
        [([{"k": "a", "x": 1.0}], [BASE], "l"),
         ([{"k": "a", "y": 2.0}], [BASE + 1000], "r"),
         ([{"k": "a", "x": 3.0}], [BASE + 30_000], "l")]),
    "stateless": (
        "SELECT a FROM s WHERE a > 1 EMIT CHANGES;",
        [([{"a": 1}, {"a": 2}], [BASE, BASE + 1]),
         ([{"a": 3}], [BASE + 2])]),
    "topk": (
        "SELECT d, TOPK(v, 2) AS top FROM s GROUP BY d, "
        "TUMBLING (INTERVAL 10 SECOND) GRACE BY INTERVAL 0 SECOND "
        "EMIT CHANGES;",
        [([{"d": "a", "v": 5.0}, {"d": "a", "v": 2.0}], [BASE, BASE + 1]),
         ([{"d": "a", "v": 4.0}], [BASE + 2]),
         ([{"d": "z", "v": 0.0}], [BASE + 30_000])]),
    "table_join": (
        "SELECT s.k, COUNT(*) AS c FROM s INNER JOIN TABLE(t) "
        "ON s.k = t.k GROUP BY s.k, TUMBLING (INTERVAL 10 SECOND) "
        "GRACE BY INTERVAL 0 SECOND EMIT CHANGES;",
        [([{"k": "a", "side": "table"}], [BASE], "t"),
         ([{"k": "a"}], [BASE + 1], "s"),
         ([{"k": "a"}], [BASE + 2], "s"),
         ([{"k": "zz"}], [BASE + 30_000], "s")]),
}
SPLIT = {"topk": 0, "table_join": 1}


def _split_run(case, src, dst):
    sql, batches = ROUND_TRIPS[case]
    split = SPLIT.get(case, 0)
    out_a, out_b, restored = run_split(sql, batches, split, src, dst)
    return out_a, out_b, restored


@pytest.mark.parametrize("case", list(ROUND_TRIPS))
def test_round_trip_in_the_port(case):
    out_a, out_b, _ = _split_run(case, "torch", "torch")
    assert _norm(out_a) == _norm(out_b)
    # and the uninterrupted port run equals the uninterrupted JAX run
    want, _b, _ = _split_run(case, "jax", "jax")
    assert _norm(out_a) == _norm(want)
    if case == "lattice_mid_window":
        got = {r["device"]: r for r in out_b if r.get("winStart") == BASE}
        assert got["a"]["c"] == 2 and got["a"]["lo"] == 1.0
    elif case == "join":
        assert any(r.get("c") == 1 for r in out_b)
    elif case == "stateless":
        assert len(out_b) == 2
    elif case == "topk":
        fin = [r["top"] for r in out_b
               if r.get("winStart") == BASE and r.get("d") == "a"]
        assert fin[-1] == [5.0, 4.0]
    elif case == "table_join":
        fin = [r["c"] for r in out_b
               if r.get("winStart") == BASE and r.get("s.k") == "a"]
        assert fin[-1] == 2


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("case", list(ROUND_TRIPS))
def test_cross_restore(case, direction):
    """A blob written by one package restores in the other, and the
    restored executor emits what an uninterrupted run emits."""
    src, dst = (("jax", "torch") if direction == "jax_to_port"
                else ("torch", "jax"))
    out_a, out_b, restored = _split_run(case, src, dst)
    assert _norm(out_a) == _norm(out_b)
    want_mod = "hstream_tpu_torch" if dst == "torch" else "hstream_tpu."
    assert type(restored).__module__.startswith(want_mod)


@pytest.mark.parametrize("case", ["lattice_mid_window",
                                  "lattice_sketches_and_strings", "topk"])
def test_blob_format_matches_the_reference(case):
    """Both packages write the same npz entries with the same dtypes,
    shapes and values, and the same meta JSON, for the same state."""
    sql, batches = ROUND_TRIPS[case]
    blobs = {}
    for pkg in ("jax", "torch"):
        _plan, ex = _make(pkg, sql, batches[0][0])
        for batch in batches[:2]:
            _feed(ex, batch)
        blobs[pkg] = tsnap._unpack(PKG[pkg][2].snapshot_executor(ex))
    (jm, ja), (tm, ta) = blobs["jax"], blobs["torch"]
    assert tm == jm
    assert sorted(ta) == sorted(ja)
    for k in ja:
        assert ta[k].dtype == ja[k].dtype and ta[k].shape == ja[k].shape, k
        if ja[k].dtype == np.float32:
            np.testing.assert_allclose(ta[k], ja[k], rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)


# ---- the device join (test_join_device.py:314-350) ---------------------------

JOIN_SQL = ("SELECT l.k, COUNT(*) AS c, SUM(l.x) AS s FROM l INNER JOIN r "
            "WITHIN (INTERVAL 1 SECOND) ON l.k = r.k "
            "GROUP BY l.k, TUMBLING (INTERVAL 10 SECOND) "
            "GRACE BY INTERVAL 0 SECOND EMIT CHANGES;")


def _join(pkg, **tune):
    _plan, ex = _make(pkg, JOIN_SQL, [{"k": "k0", "x": 1.0}])
    for k, v in tune.items():
        setattr(ex, k, v)
    return ex


def _run(ex, batches):
    out = []
    for rows, ts, side in batches:
        out.extend(ex.process(rows, ts, stream=side))
    out.extend(ex.flush_changes())
    return out


@pytest.mark.parametrize("dst", ["torch", "jax"])
def test_device_join_snapshot_roundtrip(dst):
    batches = gen_batches(seed=37, n_batches=12)
    href = final_changes(_run(_join("jax", use_device_join=False), batches))
    dev = _join("torch")
    out = _run(dev, batches[:6])
    assert dev._dev is not None  # snapshot taken in device mode
    blob = tsnap.snapshot_executor(dev)
    resumed, _ = _restore(dst, PKG[dst][0](JOIN_SQL), blob)
    assert resumed._dev is None
    out.extend(_run(resumed, batches[6:]))
    assert resumed._dev is not None  # the device path re-activated
    assert final_changes(out) == href


def test_jax_device_join_restores_into_the_port():
    batches = gen_batches(seed=38, n_batches=12)
    href = final_changes(_run(_join("torch", use_device_join=False),
                              batches))
    dev = _join("jax")
    out = _run(dev, batches[:6])
    assert dev._dev is not None
    resumed, _ = _restore("torch", tcodegen(JOIN_SQL),
                          jsnap.snapshot_executor(dev))
    out.extend(_run(resumed, batches[6:]))
    assert resumed._dev is not None
    assert final_changes(out) == href


def test_host_store_view_matches_reference_store():
    batches = gen_batches(seed=41, n_batches=6)
    host = _join("torch", use_device_join=False)
    _run(host, batches)
    jhost = _join("jax", use_device_join=False)
    _run(jhost, batches)
    dev = _join("torch")
    _run(dev, batches)
    assert dev._dev is not None
    hv = dev._host_store_view()
    for side in ("l", "r"):
        ref, got = host._stores[side], hv[side]
        assert len(ref) == len(got) == len(jhost._stores[side])
        ref_keys = {k: tss for k, (tss, _r) in ref.by_key.items()}
        got_keys = {k: tss for k, (tss, _r) in got.by_key.items()}
        assert ref_keys == got_keys
        assert {k: tss for k, (tss, _r)
                in jhost._stores[side].by_key.items()} == got_keys
        # the rebuilt rows carry the columns future matches emit
        for k, (_tss, rows) in got.by_key.items():
            assert all(set(r) <= {"k", "x"} for r in rows), k


# ---- sessions (test_session_device.py:246-275, 523-539) ----------------------

SESS_SQL = ("SELECT k, COUNT(*) AS c, SUM(v) AS s, "
            "APPROX_COUNT_DISTINCT(v) AS d FROM s GROUP BY k, "
            "SESSION (INTERVAL 1 SECOND) GRACE BY INTERVAL 1 SECOND "
            "EMIT CHANGES;")


def _session(pkg, device=True, mode=None):
    plan, ex = _make(pkg, SESS_SQL, [{"k": "u0", "v": 1.0}])
    ex.emit_changes = False
    ex.use_device_sessions = device
    ex.device_session_mode = mode
    return plan, ex


@pytest.mark.parametrize("dst", ["torch", "jax"])
@pytest.mark.parametrize("mode", ["segment", "record"])
def test_session_snapshot_roundtrip_in_device_mode(mode, dst):
    """A snapshot taken while sessions live on the device restores into
    the host engine, re-activates on the next batch (migrating the
    restored sessions into a fresh arena) and continues as the host
    engine does."""
    _p, exd = _session("torch", mode=mode)
    _p, exh = _session("jax", device=False)
    batches = session_gen(11, n_batches=5)
    batches.append(([{"k": "zz", "v": 0.0}], [BASE + 100_000]))  # closer
    for rows, ts in batches[:3]:
        exd.process(rows, ts)
        exh.process(rows, ts)
    assert exd._dev is not None
    blob = tsnap.snapshot_executor(exd)
    restored, _ = _restore(dst, PKG[dst][0](SESS_SQL), blob)
    assert restored._dev is None  # restores host-side
    restored.device_session_mode = mode
    od, oh = [], []
    for rows, ts in batches[3:]:
        od.extend(restored.process(rows, ts))
        oh.extend(exh.process(rows, ts))
    assert restored._dev is not None  # re-activated on the next batch
    assert od
    assert_rows_close(od, oh)
    assert_rows_close(list(restored.peek()), list(exh.peek()))


def test_jax_device_sessions_restore_into_the_port():
    _p, exd = _session("jax")
    _p, exh = _session("torch", device=False)
    batches = session_gen(12, n_batches=5)
    batches.append(([{"k": "zz", "v": 0.0}], [BASE + 100_000]))  # closer
    for rows, ts in batches[:3]:
        exd.process(rows, ts)
        exh.process(rows, ts)
    assert exd._dev is not None
    restored, _ = _restore("torch", tcodegen(SESS_SQL),
                           jsnap.snapshot_executor(exd))
    od, oh = [], []
    for rows, ts in batches[3:]:
        od.extend(restored.process(rows, ts))
        oh.extend(exh.process(rows, ts))
    assert restored._dev is not None
    assert od
    assert_rows_close(od, oh)


def test_snapshot_guard_requires_drained_closes():
    sql = ("SELECT k, COUNT(*) AS c FROM s GROUP BY k, "
           "SESSION (INTERVAL 1 SECOND) GRACE BY INTERVAL 0 SECOND "
           "EMIT CHANGES;")
    _plan, ex = _make("torch", sql, [{"k": "a", "v": 1.0}])
    ex.emit_changes = False
    ex.defer_close_decode = True
    ex.process([{"k": "a", "v": 1.0}], [BASE])
    ex.process([{"k": "z", "v": 0.0}], [BASE + 100_000])
    assert ex._dev is not None and ex.has_pending_closes()
    with pytest.raises(SQLCodegenError, match="deferred session"):
        tsnap.snapshot_executor(ex)
    rows = ex.flush_changes()
    assert [r["k"] for r in rows] == ["a"]
    tsnap.snapshot_executor(ex)  # drained: the snapshot proceeds


def test_lattice_guards_require_drained_closes_and_changes():
    sql, batches = ROUND_TRIPS["lattice_mid_window"]
    _plan, ex = _make("torch", sql, batches[0][0])
    ex.defer_change_decode = True
    ex.change_drain_depth = 4
    _feed(ex, batches[0])
    with pytest.raises(SQLCodegenError, match="deferred changes"):
        tsnap.snapshot_executor(ex)
    ex.flush_changes()
    tsnap.snapshot_executor(ex)
    ex.emit_changes = False
    ex.defer_close_decode = True
    _feed(ex, batches[2])
    assert ex._pending_closes
    with pytest.raises(SQLCodegenError, match="deferred closes"):
        tsnap.snapshot_executor(ex)


# ---- sealing, versions, and a capture that outlives later steps -------------

def _lattice_blob():
    sql, batches = ROUND_TRIPS["lattice_mid_window"]
    _plan, ex = _make("torch", sql, batches[0][0])
    _feed(ex, batches[0])
    return sql, tsnap.snapshot_executor(ex)


def test_sealed_blob_catches_a_flipped_bit_and_a_truncation():
    _sql, blob = _lattice_blob()
    sealed = tsnap.seal_blob(blob)
    assert sealed == jsnap.seal_blob(blob)  # the same framing
    assert tsnap.open_blob(sealed) == blob
    assert tsnap.open_blob(blob) == blob    # legacy unsealed npz
    bad = bytearray(sealed)
    bad[len(bad) // 2] ^= 0x10
    with pytest.raises(tsnap.SnapshotCorrupt, match="checksum"):
        tsnap.open_blob(bytes(bad))
    with pytest.raises(tsnap.SnapshotCorrupt, match="truncated"):
        tsnap.open_blob(sealed[:-7])
    with pytest.raises(tsnap.SnapshotCorrupt, match="magic"):
        tsnap.open_blob(b"garbage" + sealed)
    assert issubclass(tsnap.SnapshotCorrupt, StoreError)
    with pytest.raises(jsnap.SnapshotCorrupt):  # the reference agrees
        jsnap.open_blob(bytes(bad))


def test_wrong_version_is_refused():
    sql, blob = _lattice_blob()
    meta, arrays = tsnap._unpack(blob)
    meta["version"] = tsnap.SNAPSHOT_VERSION + 1
    with pytest.raises(SQLCodegenError, match="version"):
        tsnap.restore_executor(tcodegen(sql), tsnap._pack(meta, arrays),
                               device="cpu")
    with pytest.raises(NotPortedError, match="A11"):
        tsnap.restore_executor(tcodegen(sql), blob, mesh=object(),
                               device="cpu")


def test_capture_keeps_its_planes_while_later_steps_run():
    """The port's steps update the planes in place: a capture followed
    by more steps still serializes the captured state (and its meta)."""
    sql, batches = ROUND_TRIPS["lattice_mid_window"]
    _plan, ex = _make("torch", sql, batches[0][0])
    _plan, twin = _make("torch", sql, batches[0][0])
    _feed(ex, batches[0])
    _feed(twin, batches[0])
    meta, arrays = tsnap.capture_executor(ex, {"at": 0})
    before = {k: v.clone() for k, v in ex.state.items()}
    for batch in batches[1:3]:
        _feed(ex, batch)
    assert not all(torch.equal(before[k], ex.state[k]) for k in before)
    got = tsnap._unpack(tsnap.serialize_capture(meta, arrays))
    want = tsnap._unpack(tsnap.snapshot_executor(twin, {"at": 0}))
    assert got[0] == want[0]
    assert sorted(got[1]) == sorted(want[1])
    for k in want[1]:
        np.testing.assert_array_equal(got[1][k], want[1][k], err_msg=k)
    # and it restores to the state of the moment it was taken
    restored, _ = tsnap.restore_executor(
        tcodegen(sql), tsnap.serialize_capture(meta, arrays), device="cpu")
    assert _norm(_feed(restored, batches[1])) == _norm(
        _feed(twin, batches[1]))


def test_restore_refuses_planes_of_another_plan():
    sql, blob = _lattice_blob()
    other = sql.replace("MIN(temp) AS lo", "MAX(temp) AS lo")
    with pytest.raises(SQLCodegenError, match="planes"):
        tsnap.restore_executor(tcodegen(other), blob, device="cpu")
