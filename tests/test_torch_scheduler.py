"""The scheduler seed (hstream_tpu_torch/server/scheduler.py) against the
reference's (tests/test_scheduler.py): query -> server assignments live in
the CAS-versioned config store, and a successor server adopts the queries
whose owner's boot epoch predates its own and resumes them from their
snapshots.

Each case runs once against each package (`root`, parametrised over
torch_server.PACKAGES). The two-process case boots the package's server
as `python -m <package>.server.main` (the port's with `--device cpu`),
SIGKILLs it, and boots a successor over the same store in process; the
resumed count must continue from the snapshot in both packages.
"""

from __future__ import annotations

import importlib
import os
import signal
import socket
import subprocess
import sys
import time
from types import SimpleNamespace

import grpc
import pytest

from helpers import wait_attached
from torch_server import PACKAGES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = 1_700_000_000_000

_MODS = {
    "rec": "common.records", "columnar": "common.columnar",
    "pb": "proto.api_pb2", "rpc": "proto.rpc", "scheduler": "server.scheduler",
    "main": "server.main", "context": "server.context", "store": "store",
    "api": "store.api",
}


@pytest.fixture(params=PACKAGES)
def p(request):
    root = request.param
    ns = SimpleNamespace(root=root, **{
        k: importlib.import_module(f"{root}.{v}") for k, v in _MODS.items()})
    port = root.endswith("_torch")
    ns.cpu = {"device": "cpu"} if port else {}
    ns.cli = ["--device", "cpu"] if port else []
    return ns


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def wait_up(p, port, timeout=60.0):
    """Poll Echo with a fresh channel per attempt until the server
    answers (a channel made while the port refuses connections can
    wedge in connect-backoff)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        ch = grpc.insecure_channel(f"127.0.0.1:{port}")
        stub = p.rpc.HStreamApiStub(ch)
        try:
            stub.Echo(p.pb.EchoRequest(msg="up"), timeout=1)
            return ch, stub
        except grpc.RpcError:
            ch.close()
            time.sleep(0.3)
    raise TimeoutError("server never came up")


def append_rows(p, stub, stream, rows, ts):
    req = p.pb.AppendRequest(stream_name=stream)
    for row, t in zip(rows, ts):
        req.records.append(p.rec.build_record(row, publish_time_ms=t))
    return stub.Append(req)


def _read_rows(p, ctx, stream):
    logid = ctx.streams.get_logid(stream)
    tail = ctx.store.tail_lsn(logid)
    out = []
    if not tail:
        return out
    r = ctx.store.new_reader()
    r.set_timeout(0)
    r.start_reading(logid, 1, tail)
    while True:
        items = r.read(256)
        if not items:
            break
        for it in items:
            if not isinstance(it, p.api.DataBatch):
                continue
            for payload in it.payloads:
                pr = p.rec.parse_record(payload)
                rows = p.columnar.payload_rows(pr.payload)
                if rows is not None:
                    out.extend(rows)
                else:
                    out.append(p.rec.record_to_dict(pr))
    return out


def test_successor_adopts_and_resumes_from_snapshot(p, tmp_path):
    pb = p.pb
    store_dir = str(tmp_path / "store")
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{p.root}.server.main",
         "--host", "127.0.0.1", "--port", str(port),
         "--store", store_dir, "--snapshot-interval-ms", "100", *p.cli],
        env=env, cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    qid = None
    try:
        ch, stub = wait_up(p, port)
        stub.CreateStream(pb.Stream(stream_name="src"))
        stub.ExecuteQuery(pb.CommandQuery(
            stmt_text="CREATE STREAM snk AS SELECT k, COUNT(*) AS c "
                      "FROM src GROUP BY k, TUMBLING (INTERVAL 10 SECOND) "
                      "GRACE BY INTERVAL 0 SECOND EMIT CHANGES;"))
        qs = stub.ListQueries(pb.ListQueriesRequest()).queries
        assert len(qs) == 1
        qid = qs[0].id
        append_rows(p, stub, "src", [{"k": "a"} for _ in range(10)],
                    [BASE + i for i in range(10)])
        time.sleep(1.5)  # snapshot cadence is 100ms; let state commit
        ch.close()
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(10)

    # the successor boots on the same store: it adopts and resumes
    server, ctx = p.main.serve("127.0.0.1", 0, store_dir,
                               snapshot_interval_ms=100, **p.cpu)
    try:
        assert qid in ctx.running_queries, "query not adopted"
        a = p.scheduler.assignment(ctx, qid)
        assert a is not None and a["epoch"] == ctx.boot_epoch
        assert a["node"] == p.scheduler.node_name(ctx)
        task = wait_attached(ctx, qid)
        ch = grpc.insecure_channel(f"127.0.0.1:{ctx.port}")
        stub = p.rpc.HStreamApiStub(ch)
        # one more record in the SAME window, then close it: the count
        # continues from the snapshot (11), it does not restart at 1
        append_rows(p, stub, "src", [{"k": "a"}], [BASE + 100])
        append_rows(p, stub, "src", [{"k": "zz"}], [BASE + 60_000])
        deadline = time.time() + 30
        best = 0
        while time.time() < deadline:
            counts = [r.get("c", 0) for r in _read_rows(p, ctx, "snk")
                      if r and r.get("k") == "a"]
            best = max([best] + counts)
            if best >= 11:
                break
            time.sleep(0.3)
        assert best == 11, f"resumed count {best} != 11"
        if p.cpu:
            assert task.executor.device.type == "cpu"
        ch.close()
    finally:
        server.stop(grace=1)
        ctx.shutdown()


def test_adoption_skips_live_owner_epoch(p):
    """A query whose owner epoch >= ours is not adopted."""
    sch = p.scheduler
    store = p.store.open_store("mem://")
    ctx = p.context.ServerContext(store, **p.cpu)
    ctx2 = None
    try:
        sch.record_assignment(ctx, "q1")
        assert not sch.try_adopt(ctx, "q1")
        ctx2 = p.context.ServerContext(store, persistence=ctx.persistence,
                                       **p.cpu)
        assert ctx2.boot_epoch > ctx.boot_epoch
        assert sch.try_adopt(ctx2, "q1")
        a = sch.assignment(ctx2, "q1")
        assert a["epoch"] == ctx2.boot_epoch
        assert "q1" in sch.assignments(ctx2)
    finally:
        if ctx2 is not None:
            ctx2.shutdown()
        ctx.shutdown()
