"""Session, join, table-join and TOPK queries created through the port's
server, against the reference server's rows (the server cases of
tests/test_topk_tablejoin.py, and a session and an interval-join view).
Each batch waits until the query's task has processed it before the next
is sent, so both servers see the two streams in the same order."""

import numpy as np
import pytest

from torch_server import BASE, Pair, has, poll, same_rows


@pytest.fixture(scope="module")
def pair():
    p = Pair()
    yield p
    p.close()


def _fed(s, task, stream, rows, ts):
    """Append, then wait until the task has processed that batch."""
    lsn = s.append(stream, rows, ts).record_ids[-1].batch_id
    logid = s.ctx.streams.get_logid(stream)
    poll(lambda: task._pending_ckps.get(logid, 0), lambda got: got >= lsn,
         20, f"{s.m.root}: {stream} batch {lsn} processed")


def _closed_before(rows, end):
    return [r for r in rows if r["winEnd"] <= end]


def test_session_view_through_server(pair):
    """SESSION windows: sessions that extend, merge and close; the closed
    sessions of both servers agree."""
    rng = np.random.default_rng(3)
    batches = []
    t = BASE
    for b in range(4):
        n = 40
        gaps = rng.choice([100, 900, 2500, 7000], n, p=[.4, .3, .2, .1])
        ts = t + np.cumsum(gaps)
        t = int(ts[-1])
        batches.append(([{"user": f"u{u}", "x": float(x)} for u, x in zip(
            rng.integers(0, 6, n), np.round(rng.normal(0, 3, n), 2))],
            ts.tolist()))

    def run(s):
        for name in ("clicks",):
            s.stub.CreateStream(s.pb.Stream(stream_name=name))
        s.sql("CREATE VIEW sv AS SELECT user, COUNT(*) AS c, SUM(x) AS s, "
              "MAX(x) AS hi FROM clicks GROUP BY user, "
              "SESSION (INTERVAL 5 SECOND) GRACE BY INTERVAL 0 SECOND;")
        task = s.task("view-sv")
        for rows, ts in batches:
            _fed(s, task, "clicks", rows, ts)
        _fed(s, task, "clicks", [{"user": "zz", "x": 0.0}], [t + 60_000])
        return s.view_rows("sv", has("user", "zz"))

    ref, port = pair.each(run)
    ref, port = (_closed_before(r, t + 5_000) for r in (ref, port))
    assert len(port) >= 6
    same_rows(ref, port, cols=("user", "winStart"))


def test_interval_join_view_through_server(pair):
    """An interval join of two streams grouped into tumbling windows: both
    servers' closed windows agree."""
    rng = np.random.default_rng(5)
    feed = []
    for b in range(6):
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
        return s.view_rows("jv", has("l.k", "zz"))

    ref, port = pair.each(run)
    ref, port = (_closed_before(r, BASE + 10_000) for r in (ref, port))
    assert len(port) == 10
    same_rows(ref, port, cols=("winStart", "l.k"))


def test_table_join_through_server(pair):
    def run(s):
        for name in ("ord", "prc"):
            s.stub.CreateStream(s.pb.Stream(stream_name=name))
        s.sql("CREATE VIEW tj AS SELECT ord.item, COUNT(*) AS c FROM ord "
              "INNER JOIN TABLE(prc) ON ord.item = prc.item "
              "GROUP BY ord.item, TUMBLING (INTERVAL 10 SECOND) "
              "GRACE BY INTERVAL 0 SECOND;")
        task = s.task("view-tj")
        _fed(s, task, "prc", [{"item": "x", "price": 2.0}], [BASE])
        _fed(s, task, "ord", [{"item": "x"}] * 3 + [{"item": "nope"}],
             [BASE + 10, BASE + 11, BASE + 12, BASE + 20])
        _fed(s, task, "ord", [{"item": "zz"}], [BASE + 30_000])
        # every batch is processed (_fed): the window's one row is final
        return s.view_rows("tj", lambda rs: any(r["winStart"] == BASE
                                                for r in rs))

    ref, port = pair.each(run)
    closed = [[r for r in rows if r["winStart"] == BASE]
              for rows in (ref, port)]
    same_rows(*closed, cols=("ord.item",))
    assert {r["ord.item"]: r["c"] for r in closed[1]} == {"x": 3}


def test_topk_through_server_view(pair):
    def run(s):
        s.stub.CreateStream(s.pb.Stream(stream_name="tks"))
        s.sql("CREATE VIEW tkv AS SELECT d, TOPK(v, 2) AS top FROM tks "
              "GROUP BY d, TUMBLING (INTERVAL 10 SECOND) "
              "GRACE BY INTERVAL 0 SECOND;")
        s.task("view-tkv")
        s.append("tks", [{"d": "a", "v": 3.0}, {"d": "a", "v": 9.0},
                         {"d": "a", "v": 5.0}, {"d": "b", "v": -1.5},
                         {"d": "z", "v": 0.0}],
                 [BASE, BASE + 1, BASE + 2, BASE + 3, BASE + 30_000])
        return s.view_rows("tkv", has("d", "z"))

    ref, port = pair.each(run)
    closed = [[r for r in rows if r["winStart"] == BASE]
              for rows in (ref, port)]
    same_rows(*closed, cols=("d",))
    assert {r["d"]: r["top"] for r in closed[1]} == {"a": [9.0, 5.0],
                                                      "b": [-1.5]}
