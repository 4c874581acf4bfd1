"""The port's gRPC server against the reference's: tests/test_server.py's
cases, each request sent to both servers (the JAX package's and the
port's, on the CPU) through each package's own stub, the answers
compared; and the port's guards (no card, the mesh), the replicated
store's flags and sink connectors."""

import threading

import grpc
import pytest

from torch_server import BASE, Pair, PushConsumer, Side, has, poll, \
    same_finals, same_rows


@pytest.fixture(scope="module")
def pair():
    p = Pair()
    yield p
    p.close()


def test_echo_and_nodes(pair):
    for s in pair.sides:
        assert s.stub.Echo(s.pb.EchoRequest(msg="hi")).msg == "hi"
    ref, port = pair.each(
        lambda s: s.stub.ListNodes(s.pb.ListNodesRequest()).nodes)
    assert len(ref) == len(port) == 1
    assert (port[0].status, list(port[0].roles)) == \
        (ref[0].status, list(ref[0].roles))


def test_stream_crud_and_append(pair):
    def run(s):
        s.stub.CreateStream(s.pb.Stream(stream_name="crud",
                                        replication_factor=1))
        with pytest.raises(grpc.RpcError) as ei:
            s.stub.CreateStream(s.pb.Stream(stream_name="crud"))
        listed = [(x.stream_name, x.replication_factor) for x in
                  s.stub.ListStreams(s.pb.ListStreamsRequest()).streams]
        resp = s.append("crud", [{"a": 1}, {"a": 2}], [BASE, BASE + 1])
        ids = [(r.batch_id, r.batch_index) for r in resp.record_ids]
        s.stub.DeleteStream(s.pb.DeleteStreamRequest(stream_name="crud"))
        after = [x.stream_name for x in
                 s.stub.ListStreams(s.pb.ListStreamsRequest()).streams]
        return ei.value.code(), sorted(listed), len(ids), \
            len({b for b, _ in ids}), [i for _, i in ids], "crud" in after

    ref, port = pair.each(run)
    assert port == ref
    assert ref[0] == grpc.StatusCode.ALREADY_EXISTS and not ref[-1]


def test_execute_query_ddl_insert_show_explain(pair):
    def run(s):
        s.sql("CREATE STREAM ddl1;")
        shown = sorted(r["stream"] for r in s.sql("SHOW STREAMS;"))
        ins = s.sql("INSERT INTO ddl1 (a, b) VALUES (1, 'x');")
        ex = s.sql("EXPLAIN SELECT COUNT(*) FROM ddl1 GROUP BY k "
                   "EMIT CHANGES;")
        return shown, [sorted(r) for r in ins], ins[0]["lsn"] >= 1, \
            ex[0]["explain"]

    ref, port = pair.each(run)
    assert port[:3] == ref[:3]
    assert "AGGREGATE" in port[3]
    # the port's EXPLAIN has no PACK line yet (ROADMAP C), and the MESH
    # line counts each package's own devices: the other lines agree
    plan = lambda t: [ln for ln in t.splitlines()  # noqa: E731
                      if not ln.startswith(("PACK", "MESH"))]
    assert plan(port[3]) == plan(ref[3])


def test_push_query_end_to_end(pair):
    """CREATE STREAM -> push query -> INSERT -> the windowed changes
    stream back -> TERMINATE ends the call; both servers' last change of
    every (city, window) agree."""
    sql = ("SELECT city, COUNT(*) AS c, SUM(temp) AS s FROM weather "
           "GROUP BY city, TUMBLING (INTERVAL 10 SECOND) "
           "GRACE BY INTERVAL 0 SECOND EMIT CHANGES;")
    rows = [{"city": "sf", "temp": 1.5}, {"city": "sf", "temp": 2.25},
            {"city": "la", "temp": 3.0}, {"city": "la", "temp": -0.5},
            {"city": "sf", "temp": 8.0}]
    ts = [BASE, BASE + 100, BASE + 200, BASE + 12_000, BASE + 12_500]
    consumers = []
    for s in pair.sides:
        s.stub.CreateStream(s.pb.Stream(stream_name="weather"))
        before = set(s.ctx.running_queries)
        c = PushConsumer(s, sql)
        c.started.wait(10)
        poll(lambda: [q for q, t in list(s.ctx.running_queries.items())
                      if q not in before and t.attached.is_set()],
             bool, 20, f"{s.m.root}: push task attached")
        s.append("weather", rows, ts)
        consumers.append(c)

    def done(got):
        fin = {(r.get("city"), r.get("winStart")): r.get("c") for r in got}
        return fin.get(("sf", BASE)) == 2 and fin.get(("la", BASE)) == 1 \
            and fin.get(("sf", BASE + 10_000)) == 1 \
            and fin.get(("la", BASE + 10_000)) == 1

    got = [c.wait_rows(done) for c in consumers]
    same_finals(*got, cols=("city", "winStart"))
    for s, c in zip(pair.sides, consumers):
        s.stub.TerminateQueries(s.pb.TerminateQueriesRequest(all=True))
        c.thread.join(15)
        assert not c.thread.is_alive() and c.error is None, s.m.root


def test_query_lifecycle(pair):
    def run(s):
        s.stub.CreateStream(s.pb.Stream(stream_name="lifec"))
        q = s.stub.CreateQuery(s.pb.CreateQueryRequest(
            id="lq1", query_text="SELECT k, COUNT(*) AS c FROM lifec "
                                 "GROUP BY k EMIT CHANGES;"))
        listed = "lq1" in [x.id for x in s.stub.ListQueries(
            s.pb.ListQueriesRequest()).queries]
        text = s.stub.GetQuery(s.pb.GetQueryRequest(id="lq1")).query_text
        term = list(s.stub.TerminateQueries(s.pb.TerminateQueriesRequest(
            query_ids=["lq1"])).query_ids)
        status = poll(
            lambda: s.stub.GetQuery(s.pb.GetQueryRequest(id="lq1")).status,
            lambda st: st == 4, 10, f"{s.m.root}: terminated")
        s.stub.RestartQuery(s.pb.RestartQueryRequest(id="lq1"))
        restarted = s.stub.GetQuery(s.pb.GetQueryRequest(id="lq1")).status
        s.stub.DeleteQuery(s.pb.DeleteQueryRequest(id="lq1"))
        with pytest.raises(grpc.RpcError) as ei:
            s.stub.GetQuery(s.pb.GetQueryRequest(id="lq1"))
        return q.id, listed, text, term, status, restarted, ei.value.code()

    ref, port = pair.each(run)
    assert port == ref
    assert ref[-3:] == (4, 3, grpc.StatusCode.NOT_FOUND)


def test_subscription_fetch_ack(pair):
    def run(s):
        s.stub.CreateStream(s.pb.Stream(stream_name="subs"))
        s.stub.CreateSubscription(s.pb.Subscription(
            subscription_id="sub1", stream_name="subs"))
        exists = s.stub.CheckSubscriptionExist(
            s.pb.CheckSubscriptionExistRequest(subscription_id="sub1")).exists
        s.append("subs", [{"n": i} for i in range(5)],
                 [BASE + i for i in range(5)])
        got = s.stub.Fetch(s.pb.FetchRequest(subscription_id="sub1",
                                             timeout_ms=2000, max_size=64))
        recs = [s.rec.record_to_dict(s.rec.parse_record(r.record))
                for r in got.received_records]
        s.stub.Acknowledge(s.pb.AcknowledgeRequest(
            subscription_id="sub1",
            ack_ids=[r.record_id for r in got.received_records]))
        committed = s.ctx.subscriptions.get("sub1").committed_lsn >= \
            got.received_records[0].record_id.batch_id
        s.stub.DeleteSubscription(
            s.pb.DeleteSubscriptionRequest(subscription_id="sub1"))
        gone = not s.stub.CheckSubscriptionExist(
            s.pb.CheckSubscriptionExistRequest(subscription_id="sub1")).exists
        return exists, recs, committed, gone

    ref, port = pair.each(run)
    assert port == ref
    assert ref[1] == [{"n": i} for i in range(5)] and ref[2] and ref[3]


def test_subscription_resume_from_checkpoint(pair):
    """A new runtime resumes from the committed checkpoint, redelivering
    only the unacknowledged records, on both servers alike."""
    def run(s):
        s.stub.CreateStream(s.pb.Stream(stream_name="resume"))
        sub = s.pb.Subscription(subscription_id="res1",
                                stream_name="resume")
        s.stub.CreateSubscription(sub)
        s.append("resume", [{"n": 0}], [BASE])
        s.append("resume", [{"n": 1}], [BASE + 1])
        got = s.stub.Fetch(s.pb.FetchRequest(subscription_id="res1",
                                             timeout_ms=2000, max_size=64))
        s.stub.Acknowledge(s.pb.AcknowledgeRequest(
            subscription_id="res1",
            ack_ids=[got.received_records[0].record_id]))
        at_first = s.ctx.subscriptions.get("res1").committed_lsn == \
            got.received_records[0].record_id.batch_id
        s.ctx.subscriptions.remove("res1")
        s.stub.CreateSubscription(sub)
        got2 = s.stub.Fetch(s.pb.FetchRequest(subscription_id="res1",
                                              timeout_ms=2000, max_size=64))
        return len(got.received_records), at_first, [
            s.rec.record_to_dict(s.rec.parse_record(r.record))["n"]
            for r in got2.received_records]

    ref, port = pair.each(run)
    assert port == ref == (2, True, [1])


def test_view_pull_query(pair):
    """A view's closed rows and its pull query over them (WHERE and a
    projection), then the view's deletion, on both servers."""
    def run(s):
        s.stub.CreateStream(s.pb.Stream(stream_name="vsrc"))
        s.sql("CREATE VIEW v1 AS SELECT city, COUNT(*) AS c, "
              "SUM(temp) AS s, AVG(temp) AS a, "
              "APPROX_COUNT_DISTINCT(temp) AS d FROM vsrc GROUP BY city, "
              "TUMBLING (INTERVAL 10 SECOND) GRACE BY INTERVAL 0 SECOND;")
        listed = any(v.view_id == "v1" for v in
                     s.stub.ListViews(s.pb.ListViewsRequest()).views)
        s.task("view-v1")
        temps = [20.1, 20.1, 19.5, 21.0, 18.25, 20.1]
        s.append("vsrc", [{"city": c, "temp": t} for c, t in
                          zip("sf sf la sf la ny".split(), temps)],
                 [BASE + i for i in range(6)])
        s.append("vsrc", [{"city": "xx", "temp": 0.0}], [BASE + 30_000])
        rows = s.view_rows("v1", has("city", "xx"))
        sf = s.view_rows("v1", bool, where=" WHERE city = 'sf'")
        proj = s.sql("SELECT city, c FROM v1 WHERE c > 1;")
        s.stub.DeleteView(s.pb.DeleteViewRequest(view_id="v1"))
        gone = not any(v.view_id == "v1" for v in
                       s.stub.ListViews(s.pb.ListViewsRequest()).views)
        return listed, rows, sf, proj, gone

    ref, port = pair.each(run)
    assert (port[0], port[4]) == (ref[0], ref[4]) == (True, True)
    for i in (1, 2, 3):
        same_rows(ref[i], port[i], cols=("winStart", "city"))
    sf = {r["winStart"]: r for r in port[2]}
    assert sf[BASE]["c"] == 3 and sf[BASE]["d"] == 2


def test_streaming_fetch(pair):
    def run(s):
        s.stub.CreateStream(s.pb.Stream(stream_name="sf_src"))
        s.stub.CreateSubscription(s.pb.Subscription(
            subscription_id="sf_sub", stream_name="sf_src"))
        s.append("sf_src", [{"n": i} for i in range(3)],
                 [BASE + i for i in range(3)])
        hold = threading.Event()

        def requests():
            yield s.pb.StreamingFetchRequest(subscription_id="sf_sub",
                                             consumer_name="c1")
            hold.wait(10)  # the request side stays open while we read

        call = s.stub.StreamingFetch(requests())
        got = []
        try:
            for resp in call:
                got.extend(s.rec.record_to_dict(
                    s.rec.parse_record(r.record))["n"]
                    for r in resp.received_records)
                if len(got) >= 3:
                    break
        finally:
            hold.set()
            call.cancel()
        return sorted(got)

    ref, port = pair.each(run)
    assert port == ref == [0, 1, 2]


def test_query_trace_rpc(pair):
    """GetQueryTrace: the same stages on both servers, and NOT_FOUND for
    an unknown query."""
    def run(s):
        s.stub.CreateStream(s.pb.Stream(stream_name="trsrc"))
        s.sql("CREATE VIEW trview AS SELECT k, COUNT(*) AS c FROM trsrc "
              "GROUP BY k, TUMBLING (INTERVAL 10 SECOND) "
              "GRACE BY INTERVAL 0 SECOND;")
        s.task("view-trview")
        s.append("trsrc", [{"k": f"k{i % 2}"} for i in range(10)],
                 [BASE + i for i in range(10)])
        summary = poll(lambda: s.rec.struct_to_dict(s.stub.GetQueryTrace(
            s.pb.GetQueryRequest(id="view-trview"))),
            lambda d: "step" in d and "decode" in d, 20,
            f"{s.m.root}: trace")
        with pytest.raises(grpc.RpcError) as ei:
            s.stub.GetQueryTrace(s.pb.GetQueryRequest(id="nope"))
        return summary, ei.value.code()

    (rsum, rcode), (psum, pcode) = pair.each(run)
    assert pcode == rcode == grpc.StatusCode.NOT_FOUND
    assert psum["step"]["count"] >= 1 and psum["decode"]["mean_ms"] >= 0
    assert set(psum["step"]) == set(rsum["step"])


# ---- the port's guards -----------------------------------------------------

def test_serve_without_a_card_raises_device_unavailable():
    from hstream_tpu_torch.common.errors import DeviceUnavailable
    from hstream_tpu_torch.server.main import serve

    with pytest.raises(DeviceUnavailable):
        serve("127.0.0.1", 0, "mem://")


@pytest.mark.parametrize("flags, item", [
    (["--replicate", "127.0.0.1:1"], "A5c"),
])
def test_unported_server_flags_raise(flags, item):
    """The flags that raised NotPortedError naming their ROADMAP item
    until it was ported now configure the server: `--replicate` (A5c)
    boots a store leader over the named follower (none listens here, so
    its appends are acked degraded, as in the reference)."""
    from hstream_tpu_torch.server import main
    from hstream_tpu_torch.store.replica import ReplicatedStore

    assert item == "A5c"
    cfg = main._parse_args(["--device", "cpu", *flags,
                            "--replication-factor", "3",
                            "--replica-ack-timeout-ms", "700"])
    assert (cfg["replicate"], cfg["replication_factor"],
            cfg["replica_ack_timeout_ms"]) == ("127.0.0.1:1", 3, 700)
    server, ctx = main.serve("127.0.0.1", 0, "mem://", device="cpu",
                             replicate=cfg["replicate"],
                             replication_factor=cfg["replication_factor"],
                             replica_ack_timeout_ms=700)
    try:
        assert isinstance(ctx.store, ReplicatedStore)
        assert ctx.store.replication_factor == 3
        assert ctx.store.ack_timeout_s == 0.7
        assert [f["addr"] for f in ctx.store.follower_status()] == \
            ["127.0.0.1:1"]
    finally:
        server.stop(grace=1)
        ctx.shutdown()


def test_the_mesh_flag_builds_a_mesh_over_the_servers_devices():
    """`--mesh DxK` (the case the flags test refused until the sharded
    window path was ported): a (data, key) mesh whose shards wrap round
    the server's one device."""
    import torch

    from hstream_tpu_torch.server import main

    cfg = main._parse_args(["--device", "cpu", "--mesh", "2x2"])
    mesh = main._build_mesh(cfg["mesh"], torch.device("cpu"))
    assert mesh.shape == {"data": 2, "key": 2}
    assert {str(d) for d in mesh.devices.flat} == {"cpu"}
    assert main._build_mesh("3", torch.device("cpu")).shape == \
        {"data": 3, "key": 1}


def test_context_with_a_mesh_builds_sharded_sessions_and_joins():
    """The context keeps its mesh, and on it a session window and an
    interval join build key-sharded (B19c, B19b): the session's arena and
    the join's stores split over the mesh's two key shards once their
    device paths activate."""
    from hstream_tpu_torch.parallel import ShardedQueryExecutor, make_mesh
    from hstream_tpu_torch.server.context import ServerContext
    from hstream_tpu_torch.sql import make_executor, stream_codegen
    from hstream_tpu_torch.store import open_store

    mesh = make_mesh(2, 2, devices=["cpu"])
    ctx = ServerContext(open_store("mem://"), mesh=mesh, device="cpu")
    try:
        assert ctx.mesh is mesh
        sx = make_executor(stream_codegen(
            "CREATE VIEW sv AS SELECT k, COUNT(*) AS c FROM s GROUP BY k, "
            "SESSION (INTERVAL 5 SECOND);").select, mesh=ctx.mesh,
            sample_rows=[{"k": "a"}], device="cpu")
        sx.process([{"k": f"k{i % 4}"} for i in range(12)],
                   [1_700_000_000_000 + i for i in range(12)])
        assert sx._dev["ssl"].n_shards == 2
        jx = make_executor(stream_codegen(
            "SELECT COUNT(*) AS c FROM s INNER JOIN t WITHIN "
            "(INTERVAL 5 SECOND) ON s.k = t.k GROUP BY s.k, "
            "TUMBLING (INTERVAL 10 SECOND) EMIT CHANGES;"), mesh=ctx.mesh,
            sample_rows=[{"k": "a"}], device="cpu")
        for b in range(4):
            jx.process([{"k": f"k{i % 3}"} for i in range(6)],
                       [1_700_000_000_000 + 100 * b + i for i in range(6)],
                       stream="s" if b % 2 else "t")
        assert jx._dev["sjl"].n_shards == 2
        assert isinstance(jx._inner, ShardedQueryExecutor)
    finally:
        ctx.shutdown()


def test_sink_connectors_raise_not_ported(pair, tmp_path):
    """Sink connectors, refused with NotPortedError (A5c) until they were
    ported: both servers create the connector through SQL and through
    CreateSinkConnector, list it, and write the stream's rows to their
    own sqlite table alike."""
    import sqlite3

    def run(s):
        db = tmp_path / f"{s.m.root}.db"
        conn = sqlite3.connect(db)
        conn.execute("CREATE TABLE t (a INTEGER, b TEXT)")
        conn.commit()
        conn.close()
        s.stub.CreateStream(s.pb.Stream(stream_name="csrc"))
        stmt = (f"CREATE SINK CONNECTOR sc1 WITH (type = 'sqlite', "
                f"stream = 'csrc', path = '{db}', table = 't');")
        s.sql(stmt)
        s.append("csrc", [{"a": 1, "b": "x"}], [BASE])

        def rows():
            conn = sqlite3.connect(db)
            try:
                return conn.execute("SELECT a, b FROM t").fetchall()
            finally:
                conn.close()

        got = poll(rows, lambda r: len(r) == 1, 20.0,
                   f"{s.m.root}: the sink's table")
        listed = [c.id for c in s.stub.ListConnectors(
            s.pb.ListConnectorsRequest()).connectors]
        s.stub.DeleteConnector(s.pb.DeleteConnectorRequest(id="sc1"))
        made = s.stub.CreateSinkConnector(s.pb.CreateSinkConnectorRequest(
            id="sc2", config=stmt.replace("sc1", "sc2")))
        s.stub.DeleteConnector(s.pb.DeleteConnectorRequest(id="sc2"))
        return got, listed, made.id

    ref, port = pair.each(run)
    assert ref == port == ([(1, "x")], ["sc1"], "sc2")


def test_every_query_runs_on_the_contexts_device():
    s = Side("hstream_tpu_torch")
    try:
        assert str(s.ctx.device) == "cpu"
        s.stub.CreateStream(s.pb.Stream(stream_name="dsrc"))
        s.sql("CREATE VIEW dv AS SELECT k, COUNT(*) AS c FROM dsrc "
              "GROUP BY k, TUMBLING (INTERVAL 10 SECOND) "
              "GRACE BY INTERVAL 0 SECOND;")
        task = s.task("view-dv")
        s.append("dsrc", [{"k": "a"}], [BASE])
        ex = poll(lambda: task.executor, lambda e: e is not None, 20,
                  "executor built")
        assert ex.device.type == "cpu"
    finally:
        s.close()
