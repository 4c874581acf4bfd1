"""Sharded execution through the port's server and snapshots, on the CPU:
the mirrors of tests/test_sharded_server.py's three cases, a session view
and an interval-join view on a mesh across the port's and the
reference's servers, and mesh snapshots carried across the two packages
both ways.

A server started with `mesh_shape` routes windowed aggregates through the
port's ShardedQueryExecutor, its shards wrapped onto the CPU; its rows
must equal the single-card server's and the reference's sharded
server's (keys, window bounds and counts exact, float32 sums rel 1e-6,
torch_parity's bound). A mesh capture is the canonical single-card
lattice, so it restores onto one card or any mesh, in either package.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from hstream_tpu.engine import snapshot as jsnap
from hstream_tpu.parallel import make_mesh as jmake_mesh
from hstream_tpu.sql.codegen import make_executor as jmake_executor
from hstream_tpu.sql.codegen import stream_codegen as jcodegen
from hstream_tpu_torch.engine import snapshot as tsnap
from hstream_tpu_torch.parallel import ShardedQueryExecutor, make_mesh
from hstream_tpu_torch.sql import make_executor, stream_codegen
from torch_parity import assert_rows_equal
from torch_server import BASE, Side, has, poll, same_rows

SQL = ("CREATE VIEW v AS SELECT device, COUNT(*) AS c, SUM(temp) AS s, "
       "MIN(temp) AS lo FROM src WHERE temp > 0 GROUP BY device, "
       "TUMBLING (INTERVAL 10 SECOND) GRACE BY INTERVAL 0 SECOND;")


def _dataset():
    """test_sharded_server.py's data."""
    rng = np.random.default_rng(11)
    rows = [{"device": f"d{int(d)}", "temp": float(np.float32(t))}
            for d, t in zip(rng.integers(0, 6, 300),
                            np.abs(rng.normal(20, 5, 300)) + 0.1)]
    for i in range(0, 300, 17):
        rows[i]["temp"] = -1.0
    ts = [BASE + i * 10 for i in range(300)]
    return rows, ts


def _closed(side: Side, rows, ts) -> list[dict]:
    side.sql("CREATE STREAM src;")
    side.sql(SQL)
    side.task("view-v")
    side.append("src", rows, ts)
    side.append("src", [{"device": "zz", "temp": 1.0}], [BASE + 30_000])
    side.view_rows("v", has("device", "zz"))
    out = side.view_rows(
        "v", lambda rs: len([r for r in rs if r.get("winStart") == BASE])
        >= 6)
    return sorted((r for r in out if r.get("winStart") == BASE),
                  key=lambda r: r["device"])


def test_sharded_server_equals_single_card():
    """`mesh_shape="2x2"` on the port against its single-card server and
    the reference's 2x2 server: the closed window's rows equal."""
    rows, ts = _dataset()
    sides = []
    try:
        for root, shape in (("hstream_tpu_torch", None),
                            ("hstream_tpu_torch", "2x2"),
                            ("hstream_tpu", "2x2")):
            sides.append(Side(root, mesh_shape=shape))
        single, sharded, ref = (_closed(s, rows, ts) for s in sides)
        task = sides[1].ctx.running_queries["view-v"]
        assert type(task.executor).__name__ == "ShardedQueryExecutor"
        assert task.mesh_shards() == 2
        assert task.executor.sharded_dispatches > 0
        # the task mirrors them into the sharded_dispatches stat family
        ladder = sides[1].ctx.stats.stat_ladder("sharded_dispatches",
                                                "view-v")
        assert 0 < ladder["total"] <= task.executor.sharded_dispatches
        assert len(sharded) == 6
        assert_rows_equal(single, sharded)
        assert_rows_equal(ref, sharded)
    finally:
        for s in sides:
            s.close()


def test_sharded_kill_restart_resumes():
    """A crashed sharded view restarts from its mesh snapshot (partials
    merged to the canonical blob, scattered back on restore) and
    resumes without undercount."""
    side = Side("hstream_tpu_torch", mesh_shape="4x1")
    tasks = side.m.tasks
    tasks.QueryTask.snapshot_interval_ms = 50
    try:
        side.sql("CREATE STREAM src;")
        side.sql(SQL.replace("WHERE temp > 0 ", ""))
        qid = "view-v"
        side.task(qid)
        side.append("src", [{"device": f"d{i % 3}", "temp": 2.0}
                            for i in range(20)],
                    [BASE + i for i in range(20)])
        deadline = time.time() + 20
        while time.time() < deadline:
            task = side.ctx.running_queries.get(qid)
            if (side.ctx.store.meta_get(tasks.snapshot_key(qid)) is not None
                    and task is not None and task.executor is not None
                    and task.executor.watermark_abs >= BASE + 19):
                break
            time.sleep(0.05)
        assert side.ctx.store.meta_get(tasks.snapshot_key(qid)) is not None
        side.ctx.running_queries[qid].stop(crash=True)
        side.stub.RestartQuery(side.pb.RestartQueryRequest(id=qid))
        task = side.task(qid)
        side.append("src", [{"device": "d0", "temp": 2.0},
                            {"device": "zz", "temp": 1.0}],
                    [BASE + 100, BASE + 30_000])
        out = side.view_rows("v", lambda rs: {
            r["device"]: r["c"] for r in rs
            if r.get("winStart") == BASE}.get("d0") == 8)
        closed = {r["device"]: r["c"] for r in out
                  if r.get("winStart") == BASE}
        assert closed == {"d0": 8, "d1": 7, "d2": 6}, closed
        assert isinstance(task.executor, ShardedQueryExecutor)
    finally:
        tasks.QueryTask.snapshot_interval_ms = 1000
        side.close()


PLAN = ("SELECT k, COUNT(*) AS c, SUM(v) AS s FROM s GROUP BY k, "
        "TUMBLING (INTERVAL 10 SECOND) GRACE BY INTERVAL 0 SECOND "
        "EMIT CHANGES;")
ROWS = [{"k": f"k{i % 5}", "v": 1.0 + (i % 7)} for i in range(40)]
TS = [BASE + i for i in range(40)]
MORE = ([{"k": "k0", "v": 1.0}, {"k": "k9", "v": 2.5}],
        [BASE + 1000, BASE + 1001])


def norm(rows):
    return sorted((r for r in rows if r.get("winStart") == BASE),
                  key=lambda r: r["k"])


def test_sharded_snapshot_restores_single_card():
    """A capture of a 2x2 executor restores into a single-card one with
    the same open-window state, and both continue alike."""
    plan = stream_codegen(PLAN)
    sh = make_executor(plan, sample_rows=[{"k": "a", "v": 1.0}],
                       mesh=make_mesh(2, 2, devices=["cpu"]), device="cpu")
    assert isinstance(sh, ShardedQueryExecutor)
    sh.process(ROWS, TS)
    blob = tsnap.snapshot_executor(sh)
    single, _ = tsnap.restore_executor(plan, blob, device="cpu")
    assert type(single).__name__ == "QueryExecutor"
    a, b = norm(sh.peek()), norm(single.peek())
    assert len(b) == 5 and sum(r["c"] for r in b) == 40
    assert_rows_equal(b, a)
    sh.process(*MORE)
    single.process(*MORE)
    assert_rows_equal(norm(single.peek()), norm(sh.peek()))
    # and back onto another mesh
    again, _ = tsnap.restore_executor(plan, tsnap.snapshot_executor(sh),
                                      mesh=make_mesh(4, 2, devices=["cpu"]))
    assert isinstance(again, ShardedQueryExecutor)
    assert_rows_equal(norm(sh.peek()), norm(again.peek()))


@pytest.mark.parametrize("ref_mesh", [False, True])
def test_a_port_mesh_blob_restores_in_the_reference(ref_mesh):
    """The port's mesh capture is the reference's blob format: the
    reference restores it single-chip or onto its own 4x2 mesh, with the
    same open-window rows, and both continue alike."""
    sh = make_executor(stream_codegen(PLAN),
                       sample_rows=[{"k": "a", "v": 1.0}],
                       mesh=make_mesh(2, 2, devices=["cpu"]), device="cpu")
    sh.process(ROWS, TS)
    kw = {"mesh": jmake_mesh(n_data=4, n_key=2)} if ref_mesh else {}
    jex, _ = jsnap.restore_executor(jcodegen(PLAN),
                                    tsnap.snapshot_executor(sh), **kw)
    assert (type(jex).__name__ == "ShardedQueryExecutor") == ref_mesh
    assert_rows_equal(norm(jex.peek()), norm(sh.peek()))
    jex.process(*MORE)
    sh.process(*MORE)
    assert_rows_equal(norm(jex.peek()), norm(sh.peek()))


def test_a_reference_mesh_blob_restores_onto_a_port_mesh():
    """The reference's 4x2 capture restores onto the port's 2x2 mesh
    (data shard 0 takes the canonical lattice); the open windows and the
    rows that follow equal the reference's."""
    jex = jmake_executor(jcodegen(PLAN), sample_rows=[{"k": "a", "v": 1.0}],
                         mesh=jmake_mesh(n_data=4, n_key=2))
    assert type(jex).__name__ == "ShardedQueryExecutor"
    jex.process(ROWS, TS)
    ex, _ = tsnap.restore_executor(stream_codegen(PLAN),
                                   jsnap.snapshot_executor(jex),
                                   mesh=make_mesh(2, 2, devices=["cpu"]))
    assert isinstance(ex, ShardedQueryExecutor)
    for d in (1,):
        assert int(ex.state[d][0]["count"].sum()) == 0   # identities
    assert_rows_equal(norm(jex.peek()), norm(ex.peek()))
    assert_rows_equal(jex.process(*MORE), ex.process(*MORE))
    assert_rows_equal(norm(jex.peek()), norm(ex.peek()))


# ---- session and interval-join views on a mesh --------------------------------

def _fed(s, task, stream, rows, ts):
    """Append, then wait until the task has processed that batch."""
    lsn = s.append(stream, rows, ts).record_ids[-1].batch_id
    logid = s.ctx.streams.get_logid(stream)
    poll(lambda: task._pending_ckps.get(logid, 0), lambda got: got >= lsn,
         20, f"{s.m.root}: {stream} batch {lsn} processed")


def _three_sides():
    """The port's 2x2 server, its single-card server, the reference's
    2x2 server."""
    return [Side(root, mesh_shape=shape)
            for root, shape in (("hstream_tpu_torch", "2x2"),
                                ("hstream_tpu_torch", None),
                                ("hstream_tpu", "2x2"))]


def test_sharded_session_view_equals_single_card():
    """A session view on `mesh_shape="2x2"`: its arena key-shards over the
    mesh's two key shards, and the closed sessions equal the single-card
    server's and the reference's 2x2 server's."""
    rng = np.random.default_rng(3)
    batches, t = [], BASE
    for _ in range(4):
        n = 40
        gaps = rng.choice([100, 900, 2500, 7000], n, p=[.4, .3, .2, .1])
        ts = t + np.cumsum(gaps)
        t = int(ts[-1])
        batches.append(([{"user": f"u{u}", "x": float(x)} for u, x in zip(
            rng.integers(0, 6, n), np.round(rng.normal(0, 3, n), 2))],
            ts.tolist()))

    def run(s):
        s.stub.CreateStream(s.pb.Stream(stream_name="clicks"))
        s.sql("CREATE VIEW sv AS SELECT user, COUNT(*) AS c, SUM(x) AS s, "
              "MAX(x) AS hi FROM clicks GROUP BY user, "
              "SESSION (INTERVAL 5 SECOND) GRACE BY INTERVAL 0 SECOND;")
        task = s.task("view-sv")
        for rows, ts in batches:
            _fed(s, task, "clicks", rows, ts)
        _fed(s, task, "clicks", [{"user": "zz", "x": 0.0}], [t + 60_000])
        rows = s.view_rows("sv", has("user", "zz"))
        return [r for r in rows if r["winEnd"] <= t + 5_000], task

    sides = _three_sides()
    try:
        (sharded, task), (single, _), (ref, _) = (run(s) for s in sides)
        ex = task.executor
        assert ex._dev is not None and ex._dev["ssl"].n_shards == 2
        assert ex.sharded_dispatches > 0 and task.mesh_shards() == 2
        assert len(sharded) >= 6
        same_rows(single, sharded, cols=("user", "winStart"))
        same_rows(ref, sharded, cols=("user", "winStart"))
    finally:
        for s in sides:
            s.close()


def test_sharded_join_view_equals_single_card():
    """An interval-join view on `mesh_shape="2x2"`: both side stores
    key-shard, the inner aggregate goes sharded, and the closed windows
    equal the single-card server's and the reference's 2x2 server's."""
    rng = np.random.default_rng(5)
    feed = []
    for b in range(8):
        side = "l" if b % 2 == 0 else "r"
        n = 30
        ts = BASE + b * 1500 + np.sort(rng.integers(0, 1500, n))
        col = "x" if side == "l" else "y"
        feed.append((side, [{"k": f"k{k}", col: float(v)} for k, v in zip(
            rng.integers(0, 5, n), np.round(rng.normal(10, 4, n), 1))],
            ts.tolist()))

    def run(s):
        for name in ("l", "r"):
            s.stub.CreateStream(s.pb.Stream(stream_name=name))
        s.sql("CREATE VIEW jv AS SELECT l.k, COUNT(*) AS c, SUM(l.x) AS s "
              "FROM l INNER JOIN r WITHIN (INTERVAL 2 SECOND) ON l.k = r.k "
              "GROUP BY l.k, TUMBLING (INTERVAL 5 SECOND) "
              "GRACE BY INTERVAL 0 SECOND;")
        task = s.task("view-jv")
        for side, rows, ts in feed:
            _fed(s, task, side, rows, ts)
        for side, col in (("l", "x"), ("r", "y")):
            _fed(s, task, side, [{"k": "zz", col: 0.0}], [BASE + 60_000])
        rows = s.view_rows("jv", has("l.k", "zz"))
        return [r for r in rows if r["winEnd"] <= BASE + 10_000], task

    sides = _three_sides()
    try:
        (sharded, task), (single, _), (ref, _) = (run(s) for s in sides)
        ex = task.executor
        assert ex._dev is not None and ex._dev["sjl"].n_shards == 2
        assert isinstance(ex._inner, ShardedQueryExecutor)
        assert ex.sharded_dispatches > 0
        assert len(sharded) == 10
        same_rows(single, sharded, cols=("winStart", "l.k"))
        same_rows(ref, sharded, cols=("winStart", "l.k"))
    finally:
        for s in sides:
            s.close()


SESSION_SQL = ("CREATE VIEW sv AS SELECT k, COUNT(*) AS c, SUM(v) AS s "
               "FROM s GROUP BY k, SESSION (INTERVAL 5 SECOND) "
               "GRACE BY INTERVAL 0 SECOND;")
JOIN_SQL = ("SELECT l.k, COUNT(*) AS c, SUM(l.v) AS s FROM l INNER JOIN r "
            "WITHIN (INTERVAL 2 SECOND) ON l.k = r.k GROUP BY l.k, "
            "TUMBLING (INTERVAL 10 SECOND) GRACE BY INTERVAL 0 SECOND "
            "EMIT CHANGES;")


def _kind_batches(kind):
    rng = np.random.default_rng(17)
    out = []
    for b in range(8):
        n = 60
        ts = (BASE + b * 700 + np.sort(rng.integers(0, 700, n))).tolist()
        rows = [{"k": f"k{int(k)}", "v": float(v)} for k, v in zip(
            rng.integers(0, 9, n), rng.integers(0, 50, n))]
        out.append((rows, ts, ("l" if b % 2 else "r") if kind == "join"
                    else None))
    return out


def _kind_plan(kind, codegen):
    plan = codegen(SESSION_SQL if kind == "session" else JOIN_SQL)
    return plan.select if kind == "session" else plan


def _kind_rows(kind, ex, rows, ts, side):
    out = ex.process(rows, ts, stream=side) if side else \
        ex.process(rows, ts)
    return out if isinstance(out, list) else out.rows()


def _kind_state(kind, ex):
    if kind == "session":
        return sorted((r["k"], r["winStart"], r["winEnd"], r["c"],
                       round(r["s"], 3)) for r in ex.peek())
    return None


@pytest.mark.parametrize("kind", ["session", "join"])
def test_session_and_join_mesh_blobs_cross_packages(kind):
    """A capture of a session or join executor on the port's 2x2 mesh
    restores onto one card in the port, single-chip and onto a 4x2 mesh
    in the reference, and a reference 4x2 capture onto the port's mesh;
    the rows after each restore equal the uninterrupted port run's."""
    batches = _kind_batches(kind)
    tplan, jplan = _kind_plan(kind, stream_codegen), _kind_plan(kind,
                                                                jcodegen)
    sample = [{"k": "a", "v": 1.0}]

    def drive(ex, part):
        out = []
        for rows, ts, side in part:
            out.extend(_kind_rows(kind, ex, rows, ts, side))
        if kind == "join":
            out.extend(ex.flush_changes())
        else:
            out.extend(ex.drain_closed())
        return out

    def settled(rows):
        if kind == "join":
            return {(r["l.k"], r["winStart"]): (r["c"], round(r["s"], 3))
                    for r in rows}
        return sorted((r["k"], r["winStart"], r["winEnd"], r["c"],
                       round(r["s"], 3)) for r in rows)

    def port_exec(mesh):
        return make_executor(tplan, sample_rows=sample, mesh=mesh,
                             device="cpu")

    base_ex = port_exec(None)
    base = drive(base_ex, batches)
    want = (settled(base), _kind_state(kind, base_ex))

    def check(ex2, first, restored):
        rows = first + drive(ex2, batches[4:])
        assert (settled(rows), _kind_state(kind, ex2)) == want, restored

    tmesh = make_mesh(2, 2, devices=["cpu"])
    sh = port_exec(tmesh)
    first = drive(sh, batches[:4])
    ex_dev = sh._dev
    assert ex_dev is not None and ex_dev.get(
        "ssl" if kind == "session" else "sjl").n_shards == 2
    blob = tsnap.snapshot_executor(sh)
    one, _ = tsnap.restore_executor(tplan, blob, device="cpu")
    assert one.mesh is None
    check(one, first, "port, one card")
    for ref_mesh in (None, jmake_mesh(n_data=4, n_key=2)):
        jex, _ = jsnap.restore_executor(jplan, blob, mesh=ref_mesh)
        check(jex, first, f"reference, mesh {ref_mesh is not None}")
    jex = jmake_executor(jplan, sample_rows=sample,
                         mesh=jmake_mesh(n_data=4, n_key=2))
    jfirst = drive(jex, batches[:4])
    back, _ = tsnap.restore_executor(tplan, jsnap.snapshot_executor(jex),
                                     mesh=tmesh, device="cpu")
    check(back, jfirst, "reference mesh -> port mesh")
    assert back._dev is not None and back._dev.get(
        "ssl" if kind == "session" else "sjl") is not None
