"""The port's admin CLI (hstream_tpu_torch/admin) against the reference's
(hstream_tpu/admin), each over its own package's server (the port's on
the CPU).

The commands of tests/test_admin_ops.py run through both packages and
their tables (the CLI's printed text, or the rows its `cmd_*` functions
return) are compared. Per-process fields are masked, each by name
(`MASKED`): addresses and ports (ephemeral), times, generated query ids,
log ids and a leader's generated node id, snapshot byte counts (each
package's blob holds its own planes' layout), lock-ledger timings and
flow-signal values (the clock). A printed table is compared cell by cell
(column widths follow the masked cells). Everything else must be equal,
`replicas` and `promote replicas=` included: a replicated server of each
package with a follower of its own. Its `degraded_appends` and
`last_ack_status` are compared apart: the reference acks the boot's
writes degraded until its sender first dials the follower, as many as
the race allows, and the port acks none degraded (ROADMAP C; pinned
deterministically by tests/test_torch_replication.py).
"""

from __future__ import annotations

import importlib
import json
import re
import socket
import time
from types import SimpleNamespace

import grpc
import pytest

from torch_server import BASE, Pair, Side, poll

MASKED = frozenset({"addr", "port", "target", "created_time_ms", "bytes",
                    "logid", "degraded_appends", "last_ack_status",
                    "value", "leader_hint", "id", "query_id",
                    "last_heartbeat_ms", "age_ms", "wait_p50_ms",
                    "wait_p99_ms", "hold_p50_ms", "hold_p99_ms"})


def mask(x):
    if isinstance(x, dict):
        return {k: "<masked>" if k in MASKED else mask(v)
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [mask(v) for v in x]
    if isinstance(x, str):
        x = re.sub(r"127\.0\.0\.1:\d+", "127.0.0.1:<port>", x)
        x = re.sub(r"^leader-[0-9a-f]+$", "leader-<id>", x)
        return re.sub(r"^\d{9,}$", "<logid>", x)
    return x


def admin_mod(side):
    return importlib.import_module(f"{side.m.root}.admin")


def admin(side, command, **kwargs):
    resp = side.stub.SendAdminCommand(side.pb.AdminCommandRequest(
        command=command, args=side.rec.dict_to_struct(kwargs)))
    return json.loads(resp.result)


def cli(side, capsys, *argv) -> tuple[int, str]:
    """The package's admin CLI against its server: (exit code, text),
    a printed table as its rows of cells."""
    capsys.readouterr()
    rc = admin_mod(side).main(["--port", str(side.ctx.port), *argv])
    text = capsys.readouterr().out
    cells = [[c.strip() for c in ln.split("|")[1:-1]]
             for ln in text.splitlines() if ln.startswith("|")]
    return rc, cells if cells else text


@pytest.fixture(scope="module")
def pair():
    p = Pair()
    yield p
    p.close()


def same(pair, fn):
    ref, port = pair.each(fn)
    assert mask(ref) == mask(port), (ref, port)
    return port


def test_offsets_trim_findtime(pair, capsys):
    far = int(time.time() * 1000) + 3_600_000

    def run(s):
        s.stub.CreateStream(s.pb.Stream(stream_name="ops"))
        for i in range(5):
            s.append("ops", [{"i": i}], [BASE + i * 1000])
        return [cli(s, capsys, "offsets", "ops"),
                cli(s, capsys, "find-time", "ops", str(BASE)),
                cli(s, capsys, "find-time", "ops", str(far)),
                cli(s, capsys, "trim", "ops", "2"),
                cli(s, capsys, "offsets", "ops")]

    out = same(pair, run)
    assert all(rc == 0 for rc, _ in out)
    assert out[0][1][1][3] == "5" and out[2][1][1][-1] == "6"


def test_sub_lag(pair):
    def run(s):
        s.stub.CreateStream(s.pb.Stream(stream_name="lagged"))
        s.append("lagged", [{"i": i} for i in range(4)],
                 [BASE + i for i in range(4)])
        s.stub.CreateSubscription(s.pb.Subscription(
            subscription_id="lagsub", stream_name="lagged"))
        mod = admin_mod(s)
        before = mod.cmd_sub_lag(s.stub, SimpleNamespace(id="lagsub"))
        got = s.stub.Fetch(s.pb.FetchRequest(subscription_id="lagsub",
                                             timeout_ms=1000, max_size=10))
        s.stub.Acknowledge(s.pb.AcknowledgeRequest(
            subscription_id="lagsub",
            ack_ids=[rr.record_id for rr in got.received_records]))
        after = poll(lambda: mod.cmd_sub_lag(s.stub,
                                             SimpleNamespace(id="lagsub")),
                     lambda rows: rows[0]["lag"] == 0, 10.0,
                     f"{s.m.root}: sub-lag")
        return [before, after]

    out = same(pair, run)
    assert out[0][0]["tail_lsn"] == 1 and out[1][0]["lag"] == 0


def test_snapshots_replicas_and_assignments(pair, capsys):
    def run(s):
        s.stub.CreateStream(s.pb.Stream(stream_name="snapsrc"))
        q = s.stub.CreateQuery(s.pb.CreateQueryRequest(
            query_text="SELECT k, COUNT(*) AS c FROM snapsrc GROUP BY k, "
                       "TUMBLING (INTERVAL 10 SECOND) EMIT CHANGES;"))
        task = s.task(q.id)
        s.append("snapsrc", [{"k": "a"}], [BASE])
        # terminate once the record was stepped (a query that never
        # stepped has no state to snapshot)
        poll(lambda: task.executor is not None, bool, 10.0,
             f"{s.m.root}: the query's first step")
        s.stub.TerminateQueries(s.pb.TerminateQueriesRequest(
            query_ids=[q.id]))
        mod = admin_mod(s)
        # the terminate hands the final snapshot to the persist thread
        snaps = poll(lambda: mod.cmd_snapshots(s.stub, None),
                     lambda rows: any(r["key"] == q.id for r in rows),
                     10.0, f"{s.m.root}: the terminated query's snapshot")
        mine = [r for r in snaps if r["key"] == q.id]
        return [len(mine), mine[0]["bytes"] > 0,
                mod.cmd_replicas(s.stub, None),
                cli(s, capsys, "replicas"),
                q.id in admin(s, "assignments")]

    out = same(pair, run)
    assert out[:2] == [1, True] and out[2] == [{"role": "single"}]
    assert out[4] is False


def test_admin_cli_quota_and_flow_verbs(pair, capsys):
    def run(s):
        out = [cli(s, capsys, "quota", "set", "stream/cliq", "--records",
                   "7", "--bytes", "4096"),
               cli(s, capsys, "quota", "get", "stream/cliq"),
               cli(s, capsys, "quota", "list")]
        rc, flow = cli(s, capsys, "flow")
        # the flow table's signal values follow the clock: its first
        # column (names and levels) compared
        out.append((rc, [row[0] for row in flow]))
        out += [cli(s, capsys, "quota", "unset", "stream/cliq"),
                cli(s, capsys, "quota", "get", "stream/cliq")]
        return out

    out = same(pair, run)
    assert all(rc == 0 for rc, _ in out)
    assert "4096" in str(out[1][1]) and "unset" in str(out[5][1])


def test_status_tables(pair, capsys):
    """streams, views, connectors and subscriptions as the CLI prints
    them."""
    def run(s):
        s.stub.CreateStream(s.pb.Stream(stream_name="tbl_s"))
        return [cli(s, capsys, c) for c in ("streams", "views",
                                            "connectors", "subscriptions")]

    out = same(pair, run)
    assert "tbl_s" in str(out[0][1])


def test_virtual_tables(pair):
    def run(s):
        s.stub.CreateStream(s.pb.Stream(stream_name="vt1",
                                        replication_factor=2))
        s.stub.CreateStream(s.pb.Stream(stream_name="vt2"))
        s.append("vt1", [{"x": 1}], [BASE])
        rows = s.sql("SELECT name, tail_lsn FROM __streams__ "
                     "WHERE replication_factor > 1;")
        stats = s.sql("SELECT * FROM __stats__;")
        return [rows, any(r.get("stream") == "vt1" for r in stats)]

    out = same(pair, run)
    assert out == [[{"name": "vt1", "tail_lsn": 1}], True]


def test_virtual_table_names_are_reserved(pair):
    def run(s):
        out = []
        for call in (
                lambda: s.stub.CreateStream(s.pb.Stream(
                    stream_name="__streams__")),
                lambda: s.sql("CREATE STREAM __queries__ AS SELECT x "
                              "FROM vt1;"),
                lambda: s.sql("CREATE VIEW __views__ AS SELECT x, COUNT(*) "
                              "AS c FROM vt1 GROUP BY x, TUMBLING "
                              "(INTERVAL 10 SECOND);"),
                lambda: s.stub.CreateQuery(s.pb.CreateQueryRequest(
                    id="__streams__",
                    query_text="SELECT x, COUNT(*) AS c FROM vt1 GROUP BY "
                               "x, TUMBLING (INTERVAL 10 SECOND) "
                               "EMIT CHANGES;"))):
            with pytest.raises(grpc.RpcError) as e:
                call()
            out.append((e.value.code(), "reserved" in e.value.details()))
        return out + ["__views__" in s.ctx.views.names()]

    pair.each(lambda s: s.stub.CreateStream(s.pb.Stream(
        stream_name="vt1")) if "vt1" not in [
            x.stream_name for x in s.stub.ListStreams(
                s.pb.ListStreamsRequest()).streams] else None)
    out = same(pair, run)
    assert all(r for _c, r in out[:4]) and out[4] is False


def test_explain_notes_mesh_exclusion(pair):
    """The MESH line of three plans (the port's EXPLAIN has no PACK
    line, ROADMAP A9)."""
    def run(s):
        for n in ("l1", "r1"):
            s.stub.CreateStream(s.pb.Stream(stream_name=n))
        out = []
        for sql in ("EXPLAIN SELECT l1.k, COUNT(*) AS c FROM l1 INNER JOIN "
                    "r1 WITHIN (INTERVAL 1 SECOND) ON l1.k = r1.k GROUP BY "
                    "l1.k, TUMBLING (INTERVAL 10 SECOND) EMIT CHANGES;",
                    "EXPLAIN SELECT k, TOPK(v, 3) AS t FROM l1 GROUP BY k, "
                    "TUMBLING (INTERVAL 10 SECOND) EMIT CHANGES;",
                    "EXPLAIN SELECT k, COUNT(*) AS c FROM l1 GROUP BY k, "
                    "TUMBLING (INTERVAL 10 SECOND) EMIT CHANGES;"):
            text = s.sql(sql)[0]["explain"]
            out.append([re.sub(r"over \d+ chips", "over <n> chips", ln)
                        for ln in text.splitlines() if ln.startswith("MESH")])
        return out

    out = same(pair, run)
    assert out[0][0].startswith("MESH: shardable")
    assert out[1][0].startswith("MESH: single-chip")


def test_append_compression_knob():
    def run(root):
        s = Side(root, append_compression="zlib")
        try:
            s.stub.CreateStream(s.pb.Stream(stream_name="z"))
            s.append("z", [{"v": "x" * 500}] * 8,
                     [BASE + i for i in range(8)])
            s.stub.CreateSubscription(s.pb.Subscription(
                subscription_id="zs", stream_name="z"))
            got = s.stub.Fetch(s.pb.FetchRequest(subscription_id="zs",
                                                 timeout_ms=2000,
                                                 max_size=20))
            return [s.rec.record_to_dict(s.rec.parse_record(r.record))
                    for r in got.received_records]
        finally:
            s.close()

    ref, port = run("hstream_tpu"), run("hstream_tpu_torch")
    assert ref == port and len(port) == 8
    assert all(r["v"] == "x" * 500 for r in port)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _promote_flow(root: str, capsys) -> list:
    """tests/test_admin_ops.py's promote case through one package: a
    replicated server with one follower, `admin replicas`, a planned
    handoff (`promote target=`), the fenced server, then `promote
    replicas=` through the CLI."""
    store = importlib.import_module(f"{root}.store")
    repl = importlib.import_module(f"{root}.store.replica")
    fport = _free_port()
    fsrv, svc = repl.serve_follower(store.open_store("mem://"),
                                    f"127.0.0.1:{fport}", node_id="adm-f")
    s = Side(root, replicate=f"127.0.0.1:{fport}", replication_factor=2,
             replica_ack_timeout_ms=2500)
    out: list = []
    try:
        s.stub.CreateStream(s.pb.Stream(stream_name="adm"))
        s.append("adm", [{"i": 1}], [BASE])
        # the reference's degraded acks did not wait for the follower
        out.append(poll(lambda: admin(s, "replicas"),
                        lambda r: r["followers"][0]["behind"] == 0, 10.0,
                        f"{root}: the follower caught up"))
        rc, rows = cli(s, capsys, "replicas")
        out.append((rc, [r for r in rows if "leader-status" in r]))
        out.append(admin(s, "promote", target=f"127.0.0.1:{fport}",
                         leader_addr="next:1"))
        out.append((svc.is_leader, svc.epoch,
                    s.ctx.stats.stream_stat_get("promotions", "_store")))
        out.append(admin(s, "replicas")["leader"])
        try:
            s.append("adm", [{"i": 2}], [BASE + 1])
            out.append("accepted")
        except grpc.RpcError as e:
            out.append((e.code(), "not_leader leader_hint=next:1"
                        in e.details()))
        mod = admin_mod(s)
        rows = mod.cmd_replicas(s.stub, None)
        out.append((rows[0]["role"], rows[0]["fenced"]))
        rc, text = cli(s, capsys, "promote", "--replicas",
                       f"127.0.0.1:{fport}")
        out.append((rc, text))
        out.append((svc.epoch, svc.is_leader))
        try:
            admin(s, "promote")
            out.append("accepted")
        except grpc.RpcError as e:
            out.append(e.code())
        return out
    finally:
        s.channel.close()
        s.server.stop(grace=1)
        try:
            s.ctx.shutdown()
        except Exception:  # noqa: BLE001 — a fenced store refuses the
            pass           # final status writes, in both packages
        svc.close()
        fsrv.stop(grace=1)


def test_admin_promote_verb_and_replicas_leader_status(capsys):
    """`admin replicas` (leader epoch, fencing, ack timeout, dedup
    window), `promote target=` (the planned handoff), the fenced server
    refusing appends with the hint, and `promote replicas=` through the
    CLI (leader death: the most caught-up replica, epoch 2)."""
    ref = _promote_flow("hstream_tpu", capsys)
    port = _promote_flow("hstream_tpu_torch", capsys)
    assert mask(ref) == mask(port), (ref, port)
    # the boot's writes: none acked degraded by the port
    assert port[0]["followers"][0]["degraded_appends"] == 0
    assert port[0]["followers"][0]["last_ack_status"] == "replicated"
    assert port[0]["role"] == "leader"
    assert port[0]["leader"]["ack_timeout_ms"] == 2500
    assert port[2]["ok"] and port[2]["epoch"] == 1
    assert port[3] == (True, 1, 1)
    assert port[4]["fenced"] is True and port[4]["fenced_by_epoch"] == 1
    assert port[5] == (grpc.StatusCode.UNAVAILABLE, True)
    assert port[6] == ("leader-status", True)
    assert port[7][0] == 0 and port[8] == (2, True)
    assert port[9] == grpc.StatusCode.INTERNAL


def test_admin_locks_verb_arm_ledger_disarm(pair, capsys):
    def run(s):
        lt = importlib.import_module(f"{s.m.root}.common.locktrace")
        lt.LOCKTRACE.disarm()
        try:
            armed = admin(s, "locks", action="arm")["armed"]
            admin(s, "supervisor")
            s.stub.ListQueries(s.pb.ListQueriesRequest())
            out = admin(s, "locks")
            some = next(iter(out["locks"].values()))
            rc, text = cli(s, capsys, "locks")
            text = str(text)
            off = admin(s, "locks", action="disarm")
            with pytest.raises(grpc.RpcError):
                admin(s, "locks", action="explode")
            return [armed, out["armed"], out["cycles"], bool(out["locks"]),
                    sorted(some), rc, "(witness)" in text and "armed" in text,
                    off["armed"], off["locks"]]
        finally:
            lt.LOCKTRACE.disarm()

    out = same(pair, run)
    assert out[:4] == [True, True, [], True] and out[5:] == [0, True,
                                                            False, {}]
