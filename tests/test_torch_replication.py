"""The port's replicated store (hstream_tpu_torch/store/replica.py)
against the reference's (hstream_tpu/store/replica.py).

Each case of tests/test_replication.py that does not race a promotion
against appends runs here through both packages, each over stores of its
own, and the two runs' observations are compared: records and LSNs,
trim points, meta, op-log sequences, epochs, ack statuses and the
promotion's choice. Payloads that hold a wall-clock time (server-built
records, op-log entries) are compared by count and shape only, named
where it happens. The wire between a leader and its followers is one
proto (`api.proto` is the same file in both packages), so the last cases
cross it: a port leader replicating to a reference follower and a
reference leader replicating to a port follower, each against the same
operations within one package.

Every port is an ephemeral one and every wait is bounded.
"""

from __future__ import annotations

import importlib
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import grpc
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 30.0


def _pkg(name: str) -> SimpleNamespace:
    """One package's replication surface: `ref` the JAX package's,
    `port` the PyTorch port's."""
    base = "hstream_tpu" if name == "ref" else "hstream_tpu_torch"

    def mod(m):
        return importlib.import_module(f"{base}.{m}")

    return SimpleNamespace(
        name=name, base=base, pb=mod("proto.api_pb2"), rpc=mod("proto.rpc"),
        open_store=mod("store").open_store, api=mod("store.api"),
        repl=mod("store.replica"), dedup=mod("store.dedup"),
        errors=mod("common.errors"), rec=mod("common.records"),
        main=mod("server.main"))


REF, PORT = _pkg("ref"), _pkg("port")


def both(scenario, *args) -> dict:
    """scenario(p, *args) through both packages; their observations must
    be equal. Returns the port's."""
    got = {p.name: scenario(p, *args) for p in (REF, PORT)}
    assert got["port"] == got["ref"], got
    return got["port"]


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def log_contents(store, logid: int) -> list[tuple[int, tuple[bytes, ...]]]:
    tail = store.tail_lsn(logid)
    if tail == 0:
        return []
    r = store.new_reader()
    r.set_timeout(0)
    r.start_reading(logid, 1, tail)
    out = []
    while True:
        items = r.read(512)
        if not items:
            break
        out.extend((it.lsn, tuple(it.payloads)) for it in items
                   if type(it).__name__ == "DataBatch")
    return out


def oplog_ops(p, store, times: bool = False) -> list[bytes]:
    """The op-log's entries, each serialized; without `times` their
    append stamps (the leader's clock) are cleared."""
    out = []
    for _lsn, payloads in log_contents(store, p.repl.OPLOG_ID):
        for b in payloads:
            e = p.repl._decode_entry(b)
            if not times:
                e.ClearField("append_time_ms")
            out.append(e.SerializeToString(deterministic=True))
    return out


def wait_until(cond, what: str, timeout: float = WAIT_S) -> None:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise TimeoutError(what)


def follower_seq(p, port: int) -> int:
    with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
        return p.rpc.StoreReplicaStub(ch).ReplicaInfo(
            p.pb.ReplicaInfoRequest(), timeout=2).applied_seq


def wait_caught_up(p, leader, port: int) -> None:
    def done():
        try:
            return follower_seq(p, port) >= leader.oplog_seq
        except grpc.RpcError:
            return False

    wait_until(done, f"follower on {port} never converged")


# ---- the reference's cases ---------------------------------------------------

def _all_ops(p) -> dict:
    follower_store = p.open_store("mem://")
    port = free_port()
    server, svc = p.repl.serve_follower(follower_store, f"127.0.0.1:{port}")
    leader = p.repl.ReplicatedStore(p.open_store("mem://"),
                                    [f"127.0.0.1:{port}"],
                                    replication_factor=2)
    try:
        leader.create_log(7)
        for i in range(10):
            leader.append_batch(7, [f"x{i}".encode(), b"y"])
        leader.trim(7, 3)
        leader.meta_put("k1", b"v1")
        leader.meta_put("k2", b"v2")
        leader.meta_delete("k2")
        leader.create_log(8)
        leader.remove_log(8)
        wait_until(lambda: svc.applied_seq >= leader.oplog_seq, "all ops")
        assert svc.applied_seq == leader.oplog_seq
        want = log_contents(leader.local, 7)
        assert log_contents(follower_store, 7) == want
        return {"log": want, "trim": follower_store.trim_point(7),
                "k1": follower_store.meta_get("k1"),
                "k2": follower_store.meta_get("k2"),
                "log8": follower_store.log_exists(8),
                "seq": svc.applied_seq,
                "oplog": oplog_ops(p, follower_store)}
    finally:
        leader.close()
        server.stop(grace=1)


def test_replication_in_process_all_ops():
    """Every op kind replicates (append, trim, create, remove, meta) to
    one in-process follower over mem stores."""
    got = both(_all_ops)
    assert got["trim"] == 3 and got["k1"] == b"v1" and got["k2"] is None
    assert not got["log8"] and len(got["log"]) == 7   # 3 trimmed


def _degraded(p) -> dict:
    dead_port = free_port()
    leader = p.repl.ReplicatedStore(p.open_store("mem://"),
                                    [f"127.0.0.1:{dead_port}"],
                                    replication_factor=2)
    try:
        leader.create_log(1)
        t0 = time.time()
        lsn = leader.append(1, b"solo")
        quick = time.time() - t0 < 6.0
        st = leader.follower_status()
        return {"lsn": lsn, "quick": quick,
                "status": leader.last_ack_status,
                "degraded": leader.degraded_appends >= 1,
                "follower_status": st[0]["last_ack_status"],
                "behind": st[0]["behind"] >= 1}
    finally:
        leader.close()


def test_degraded_append_when_follower_down():
    """No live follower: the append still succeeds and says it was
    degraded (both packages ack it: ROADMAP C)."""
    got = both(_degraded)
    assert got["lsn"] == 1 and got["quick"]
    assert got["status"] == got["follower_status"] == \
        "degraded:followers_down"
    assert got["degraded"] and got["behind"]


def _rf_roundtrip(p) -> dict:
    kw = {"device": "cpu"} if p.name == "port" else {}
    server, ctx = p.main.serve("127.0.0.1", 0, "mem://", **kw)
    ch = grpc.insecure_channel(f"127.0.0.1:{ctx.port}")
    stub = p.rpc.HStreamApiStub(ch)
    try:
        stub.CreateStream(p.pb.Stream(stream_name="rf",
                                      replication_factor=3))
        return {s.stream_name: s.replication_factor
                for s in stub.ListStreams(p.pb.ListStreamsRequest()).streams}
    finally:
        ch.close()
        server.stop(grace=1)
        ctx.shutdown()


def test_replication_factor_roundtrips_through_stream_api():
    assert both(_rf_roundtrip)["rf"] == 3


def _server_leader(p) -> dict:
    follower_store = p.open_store("mem://")
    fport = free_port()
    fsrv, svc = p.repl.serve_follower(follower_store, f"127.0.0.1:{fport}")
    kw = {"device": "cpu"} if p.name == "port" else {}
    server, ctx = p.main.serve("127.0.0.1", 0, "mem://",
                               replicate=f"127.0.0.1:{fport}",
                               replication_factor=2, **kw)
    ch = grpc.insecure_channel(f"127.0.0.1:{ctx.port}")
    stub = p.rpc.HStreamApiStub(ch)
    try:
        assert isinstance(ctx.store, p.repl.ReplicatedStore)
        stub.CreateStream(p.pb.Stream(stream_name="rs"))
        req = p.pb.AppendRequest(stream_name="rs")
        for i in range(5):
            req.records.append(p.rec.build_record({"i": i}))
        stub.Append(req)
        wait_until(lambda: svc.applied_seq >= ctx.store.oplog_seq,
                   "server leader")
        logid = ctx.streams.get_logid("rs")
        want = log_contents(ctx.store.local, logid)
        assert log_contents(follower_store, logid) == want
        # the records carry their publish time: compared by shape
        return {"batches": [(lsn, len(x)) for lsn, x in want],
                "meta": follower_store.meta_list("") != [],
                "rows": [p.rec.record_to_dict(p.rec.parse_record(b))
                         ["i"] for _lsn, x in want for b in x]}
    finally:
        ch.close()
        server.stop(grace=1)
        ctx.shutdown()
        fsrv.stop(grace=1)


def test_server_leader_mode_replicates_streams():
    """serve(replicate=...) wraps the store: a stream's create and
    appends through the public API land on the follower."""
    got = both(_server_leader)
    assert got["rows"] == list(range(5)) and got["meta"]


def _apply_reconcile(p) -> dict:
    st = p.open_store("mem://")
    st.create_log(p.repl.OPLOG_ID)
    st.create_log(5)
    e = p.pb.LogEntry(op=p.pb.OP_APPEND, logid=5, payloads=[b"a"],
                      expect_lsn=1, append_time_ms=123)
    st.append(p.repl.OPLOG_ID, p.repl._encode_entry(e))
    p.repl._reconcile(st)
    first = st.tail_lsn(5)
    p.repl._apply(st, e)
    return {"after_reconcile": first, "after_reapply": st.tail_lsn(5),
            "find_time": st.find_time(5, 123)}


def test_apply_idempotent_and_reconcile():
    assert both(_apply_reconcile) == {"after_reconcile": 1,
                                      "after_reapply": 1, "find_time": 1}


def _append_time(p) -> dict:
    follower_store = p.open_store("mem://")
    port = free_port()
    server, svc = p.repl.serve_follower(follower_store, f"127.0.0.1:{port}")
    leader = p.repl.ReplicatedStore(p.open_store("mem://"),
                                    [f"127.0.0.1:{port}"],
                                    replication_factor=2)
    try:
        leader.create_log(9)
        leader.append_batch(9, [b"x"], append_time_ms=1000)
        leader.append_batch(9, [b"y"], append_time_ms=2000)
        wait_until(lambda: svc.applied_seq >= leader.oplog_seq,
                   "append time")
        return {"follower": follower_store.find_time(9, 1500),
                "leader": leader.local.find_time(9, 1500)}
    finally:
        leader.close()
        server.stop(grace=1)


def test_append_time_replicates():
    assert both(_append_time) == {"follower": 2, "leader": 2}


def _slow_follower(p, monkeypatch) -> dict:
    monkeypatch.setattr(p.repl, "_ACK_TIMEOUT_S", 0.4)
    leader = p.repl.ReplicatedStore(p.open_store("mem://"), [],
                                    replication_factor=2)

    class _SlowFollower:
        addr = "slow:1"
        alive = True
        tried = True   # the port's sender sets it after its first dial
        acked_seq = 0

    try:
        leader.create_log(1)
        clean = leader.last_ack_status
        leader._followers = [_SlowFollower()]
        lsn = leader.append_batch(1, [b"x"])
        return {"clean": clean, "lsn": lsn,
                "status": leader.last_ack_status,
                "degraded": leader.degraded_appends}
    finally:
        leader._followers = []
        leader.close()


def test_slow_follower_ack_times_out_degraded(monkeypatch):
    """A live follower that never applies degrades the ack at the
    timeout (the append itself is acknowledged: ROADMAP C)."""
    assert both(_slow_follower, monkeypatch) == {
        "clean": "replicated", "lsn": 1, "status": "degraded:timeout",
        "degraded": 1}


def _binding_restart(p) -> dict:
    pb, stub_of = p.pb, p.rpc.StoreReplicaStub
    follower_store = p.open_store("mem://")
    port = free_port()
    server, _svc = p.repl.serve_follower(follower_store,
                                         f"127.0.0.1:{port}")
    try:
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            stub_of(ch).Replicate(pb.ReplicateRequest(
                entries=[pb.LogEntry(seq=1, op=pb.OP_CREATE_LOG, logid=3)],
                leader_id="L1"), timeout=5)
    finally:
        server.stop(grace=1)
    out = {"bound": follower_store.meta_get("replica/leader_id")}
    port2 = free_port()
    server2, svc2 = p.repl.serve_follower(follower_store,
                                          f"127.0.0.1:{port2}")
    try:
        out["reloaded"] = svc2._leader_id
        with grpc.insecure_channel(f"127.0.0.1:{port2}") as ch:
            stub = stub_of(ch)
            try:
                stub.Replicate(pb.ReplicateRequest(
                    entries=[pb.LogEntry(seq=2, op=pb.OP_CREATE_LOG,
                                         logid=4)],
                    leader_id="L2"), timeout=5)
                out["second"] = "accepted"
            except grpc.RpcError as err:
                out["second"] = err.code().name
            out["log4"] = follower_store.log_exists(4)
            stub.Replicate(pb.ReplicateRequest(
                entries=[pb.LogEntry(seq=2, op=pb.OP_CREATE_LOG, logid=5)],
                leader_id="L1"), timeout=5)
            out["log5"] = follower_store.log_exists(5)
    finally:
        server2.stop(grace=1)
    return out


def test_follower_leader_binding_survives_restart():
    """The accepted leader id persists in store meta: a restarted
    follower keeps refusing a second leader and takes the first."""
    assert both(_binding_restart) == {
        "bound": b"L1", "reloaded": "L1", "second": "FAILED_PRECONDITION",
        "log4": False, "log5": True}


def _second_leader(p) -> dict:
    pb = p.pb
    follower_store = p.open_store("mem://")
    port = free_port()
    server, _svc = p.repl.serve_follower(follower_store, f"127.0.0.1:{port}")
    try:
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            stub = p.rpc.StoreReplicaStub(ch)
            stub.Replicate(pb.ReplicateRequest(
                entries=[pb.LogEntry(seq=1, op=pb.OP_CREATE_LOG, logid=3)],
                leader_id="L1"), timeout=5)
            try:
                stub.Replicate(pb.ReplicateRequest(entries=[],
                                                   leader_id="L2"),
                               timeout=5)
                return {"second": "accepted"}
            except grpc.RpcError as err:
                return {"second": err.code().name}
    finally:
        server.stop(grace=1)


def test_follower_rejects_second_leader():
    assert both(_second_leader) == {"second": "FAILED_PRECONDITION"}


def _leader_restart(p, tmp_path) -> dict:
    follower_store = p.open_store("mem://")
    port = free_port()
    server, svc = p.repl.serve_follower(follower_store, f"127.0.0.1:{port}")
    d = str(tmp_path / p.name / "lead")
    try:
        leader = p.repl.ReplicatedStore(p.open_store(d),
                                        [f"127.0.0.1:{port}"],
                                        replication_factor=2)
        nid = leader.node_id
        leader.create_log(11)
        leader.append(11, b"one")
        wait_until(lambda: svc.applied_seq >= leader.oplog_seq, "first")
        leader.close()
        leader = p.repl.ReplicatedStore(p.open_store(d),
                                        [f"127.0.0.1:{port}"],
                                        replication_factor=2)
        same_id = leader.node_id == nid
        leader.append(11, b"two")
        wait_until(lambda: svc.applied_seq >= leader.oplog_seq, "second")
        want = log_contents(leader.local, 11)
        assert log_contents(follower_store, 11) == want
        out = {"same_id": same_id, "seq": svc.applied_seq,
               "oplog_seq": leader.oplog_seq, "log": want}
        leader.close()
        return out
    finally:
        server.stop(grace=1)


def test_leader_restart_keeps_feeding_followers(tmp_path):
    """A restarted leader keeps its persisted node id, so a live
    follower takes its entries."""
    got = both(_leader_restart, tmp_path)
    assert got["same_id"] and got["seq"] == got["oplog_seq"]
    assert got["log"] == [(1, (b"one",)), (2, (b"two",))]


def _dedup_single(p) -> dict:
    st = p.open_store("mem://")
    st.create_log(3)
    lock = threading.Lock()
    none = p.api.Compression.NONE

    def app(seq, payloads, producer="p1"):
        return p.dedup.guarded_append(st, lock, 3, payloads, none,
                                      producer, seq)

    first = app(1, [b"a", b"b"])
    retry = app(1, [b"a", b"b"])
    tail = st.tail_lsn(3)
    for seq in range(2, p.dedup.DEDUP_WINDOW + 3):
        app(seq, [b"x"])
    with pytest.raises(p.errors.DuplicateAppend):
        app(1, [b"a", b"b"])
    other = app(1, [b"y"], "p2")[2]
    out = {"first": first, "retry": retry, "tail": tail, "other": other,
           "window": p.dedup.window_size(st),
           "meta": st.meta_get("dedup/p1")}
    st.close()
    return out


def test_dedup_window_semantics_single_store():
    """A new seq appends, a remembered one answers the original (lsn, n),
    one evicted from the window refuses (DuplicateAppend)."""
    got = both(_dedup_single)
    lsn = got["first"][0]
    assert got["first"] == (lsn, 2, False) and got["retry"] == (lsn, 2, True)
    assert got["tail"] == lsn and got["other"] is False


def _dedup_replicates(p) -> dict:
    follower_store = p.open_store("mem://")
    port = free_port()
    server, _svc = p.repl.serve_follower(follower_store, f"127.0.0.1:{port}")
    leader = p.repl.ReplicatedStore(p.open_store("mem://"),
                                    [f"127.0.0.1:{port}"],
                                    replication_factor=2)
    none = p.api.Compression.NONE
    try:
        leader.create_log(4)
        first = leader.append_batch_dedup(4, [b"r1", b"r2"], none,
                                          producer_id="pp", producer_seq=1)
        retry = leader.append_batch_dedup(4, [b"r1", b"r2"], none,
                                          producer_id="pp", producer_seq=1)
        wait_caught_up(p, leader, port)
        window = follower_store.meta_get("dedup/pp")
        assert window == leader.local.meta_get("dedup/pp")
        return {"first": first, "retry": retry, "window": window,
                "lookup": p.dedup.lookup(follower_store, "pp", 1)}
    finally:
        leader.close()
        server.stop(grace=1)


def test_dedup_window_replicates_with_the_oplog():
    got = both(_dedup_replicates)
    lsn = got["first"][0]
    assert got["retry"] == (lsn, 2, True) and got["lookup"] == (lsn, 2)


def _handoff(p) -> dict:
    f1_store, f2_store = p.open_store("mem://"), p.open_store("mem://")
    p1, p2, pr = free_port(), free_port(), free_port()
    s1, svc1 = p.repl.serve_follower(f1_store, f"127.0.0.1:{p1}",
                                     node_id="hand-f1")
    s2, svc2 = p.repl.serve_follower(f2_store, f"127.0.0.1:{p2}",
                                     node_id="hand-f2")
    leader = p.repl.ReplicatedStore(
        p.open_store("mem://"), [f"127.0.0.1:{p1}", f"127.0.0.1:{p2}"],
        replication_factor=3)
    new_leader = rejoin_srv = None
    out: dict = {}
    try:
        leader.create_log(6)
        for i in range(3):
            leader.append(6, f"pre-{i}".encode())
        wait_caught_up(p, leader, p1)
        wait_caught_up(p, leader, p2)
        res = leader.promote_follower(f"127.0.0.1:{p1}",
                                      leader_addr="client-new:1")
        out["promote"] = (res["ok"], res["node_id"],
                          [a == f"127.0.0.1:{p2}" for a in res["sealed"]])
        out["epochs"] = (svc1.is_leader, svc1.epoch, svc2.is_leader,
                         svc2.epoch)
        try:
            leader.append(6, b"stale")
            out["stale"] = "accepted"
        except p.errors.NotLeaderError as e:
            out["stale"] = e.leader_hint
        out["fenced"] = (leader.fenced_appends,
                         leader.leader_status()["fenced"])
        rejoin_srv, rejoin_svc = p.repl.serve_follower(
            leader.local, f"127.0.0.1:{pr}", node_id="demoted")
        new_leader = p.repl.ReplicatedStore(
            f1_store, [f"127.0.0.1:{p2}", f"127.0.0.1:{pr}"],
            replication_factor=3, client_addr="client-new:1")
        out["new"] = (new_leader.epoch, new_leader.node_id)
        for i in range(3):
            new_leader.append(6, f"post-{i}".encode())
        wait_caught_up(p, new_leader, p2)
        wait_caught_up(p, new_leader, pr)
        want = log_contents(new_leader.local, 6)
        out["log"] = want
        out["converged"] = (log_contents(f2_store, 6) == want,
                            log_contents(leader.local, 6) == want)
        out["stored_epochs"] = [p.repl.load_epoch(s) for s in
                                (f1_store, f2_store, leader.local)]
        rejoin_srv.stop(grace=1)
        rejoin_svc.close()
        rejoin_srv = None
        return out
    finally:
        if new_leader is not None:
            # new_leader shares f1_store: stop its replication only
            new_leader._stop.set()
            for f in new_leader._followers:
                f._thread.join(timeout=2)
            new_leader._async_pool.shutdown(wait=True)
        if rejoin_srv is not None:
            rejoin_srv.stop(grace=1)
        leader.close()
        svc1.close()
        svc2.close()
        s1.stop(grace=1)
        s2.stop(grace=1)
        f1_store.close()
        f2_store.close()


def test_planned_handoff_fences_seals_and_demoted_rejoins():
    """Promote a follower: the old leader fences itself with the hint,
    the other follower is sealed at the new epoch, and the demoted leader
    rejoins as a follower; every store converges."""
    got = both(_handoff)
    assert got["promote"] == (True, "hand-f1", [True])
    assert got["epochs"] == (True, 1, False, 1)
    assert got["stale"] == "client-new:1" and got["fenced"] == (1, True)
    assert got["new"] == (1, "hand-f1") and len(got["log"]) == 6
    assert got["converged"] == (True, True)
    assert got["stored_epochs"] == [1, 1, 1]


def spawn_follower(p, store_dir: str, port: int,
                   node_id: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, "-m", f"{p.base}.store.replica", "--store",
         store_dir, "--listen", f"127.0.0.1:{port}", "--node-id", node_id],
        env=env, cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)


def wait_follower_up(p, port: int) -> None:
    def up():
        try:
            follower_seq(p, port)
            return True
        except grpc.RpcError:
            return False

    wait_until(up, f"follower on {port} never came up", 90.0)


def _kill_rejoin(p, tmp_path) -> dict:
    dirs = {n: str(tmp_path / p.name / n) for n in ("a", "b", "c")}
    pb_port, pc_port = free_port(), free_port()
    proc_b = spawn_follower(p, dirs["b"], pb_port, "b")
    proc_c = spawn_follower(p, dirs["c"], pc_port, "c")
    leader = None
    try:
        wait_follower_up(p, pb_port)
        wait_follower_up(p, pc_port)
        leader = p.repl.ReplicatedStore(
            p.open_store(dirs["a"]),
            [f"127.0.0.1:{pb_port}", f"127.0.0.1:{pc_port}"],
            replication_factor=3)
        leader.create_log(42)
        for i in range(50):
            leader.append(42, f"rec-{i}".encode())
        proc_c.send_signal(signal.SIGKILL)
        proc_c.wait(10)
        for i in range(50, 100):
            leader.append(42, f"rec-{i}".encode())
        tail = leader.tail_lsn(42)
        wait_caught_up(p, leader, pb_port)
        proc_c = spawn_follower(p, dirs["c"], pc_port, "c")
        wait_follower_up(p, pc_port)
        wait_caught_up(p, leader, pc_port)
        want = log_contents(leader.local, 42)
        for proc in (proc_b, proc_c):
            proc.send_signal(signal.SIGTERM)
            proc.wait(10)
        out = {"tail": tail, "log": want, "replicas": []}
        for n in ("b", "c"):
            st = p.open_store(dirs[n])
            out["replicas"].append(
                (log_contents(st, 42) == want,
                 st.tail_lsn(p.repl.OPLOG_ID) == leader.oplog_seq))
            st.close()
        return out
    finally:
        for proc in (proc_b, proc_c):
            if proc.poll() is None:
                proc.kill()
        if leader is not None:
            leader.close()


def test_three_node_kill_and_rejoin(tmp_path):
    """Follower processes: kill one of three mid-append; appends go on,
    the survivors hold everything and the restarted one converges."""
    got = both(_kill_rejoin, tmp_path)
    assert got["tail"] == 100 and len(got["log"]) == 100
    assert got["replicas"] == [(True, True), (True, True)]


# ---- across the packages: one wire ------------------------------------------

def _ops(leader) -> None:
    """The same appends, trims, stream (log) operations and meta on any
    leader; the append times are given, so the op-logs compare whole."""
    leader.create_log(21)
    leader.create_log(22)
    for i in range(12):
        leader.append_batch(21, [f"a{i}".encode(), b"b" * i],
                            append_time_ms=1000 + i)
    leader.append_batch(22, [b"only"], append_time_ms=5000)
    leader.trim(21, 4)
    leader.meta_put("stream/s1", b"21")
    leader.meta_put("stream/s2", b"22")
    leader.meta_delete("stream/s2")
    leader.remove_log(22)
    leader.create_log(23)


def _leader_to(lp, fp) -> dict:
    """A leader of package `lp` replicating _ops to a follower of package
    `fp`: the follower's records, LSNs, op-log and stored epoch."""
    follower_store = fp.open_store("mem://")
    port = free_port()
    server, svc = fp.repl.serve_follower(follower_store, f"127.0.0.1:{port}",
                                         node_id="cross-f")
    leader = lp.repl.ReplicatedStore(lp.open_store("mem://"),
                                     [f"127.0.0.1:{port}"],
                                     replication_factor=2, node_id="cross-l")
    try:
        _ops(leader)
        wait_until(lambda: svc.applied_seq >= leader.oplog_seq, "cross")
        if lp is PORT:   # its first ops wait for the first dial
            assert leader.degraded_appends == 0, leader.last_ack_status
        return {"log21": log_contents(follower_store, 21),
                "trim21": follower_store.trim_point(21),
                "log22": follower_store.log_exists(22),
                "log23": follower_store.log_exists(23),
                "meta": (follower_store.meta_get("stream/s1"),
                         follower_store.meta_get("stream/s2")),
                "seq": svc.applied_seq,
                "oplog": oplog_ops(fp, follower_store, times=True),
                "epoch": fp.repl.load_epoch(follower_store),
                "bound": follower_store.meta_get("replica/leader_id")}
    finally:
        leader.close()
        server.stop(grace=1)


@pytest.mark.parametrize("leader,follower", [("port", "ref"),
                                             ("ref", "port")])
def test_cross_package_replication(leader, follower):
    """A port leader replicating to a reference follower, and a reference
    leader to a port follower, leave the follower as the same package's
    own leader leaves it: records, LSNs, trim point, logs, meta, op-log
    sequence and stored epoch equal."""
    pk = {"ref": REF, "port": PORT}
    lp, fp = pk[leader], pk[follower]
    crossed = _leader_to(lp, fp)
    same = _leader_to(fp, fp)
    assert crossed == same
    assert len(crossed["oplog"]) == 21 and crossed["seq"] >= 21
    assert crossed["trim21"] == 4 and len(crossed["log21"]) == 8
    assert crossed["epoch"] == 0 and crossed["bound"] == b"cross-l"


def _fed_group(fp, seqs=(6, 9, 3)) -> list:
    """Followers of package `fp` fed by one leader straight over the wire
    (leader id "L", epoch 0): follower i applied seqs[i] entries of one
    log. (server, service, addr) each."""
    pb = fp.pb
    group = []
    for i, n in enumerate(seqs):
        port = free_port()
        srv, svc = fp.repl.serve_follower(fp.open_store("mem://"),
                                          f"127.0.0.1:{port}",
                                          node_id=f"g{i}")
        entries = [pb.LogEntry(seq=1, op=pb.OP_CREATE_LOG, logid=1)]
        entries += [pb.LogEntry(seq=k, op=pb.OP_APPEND, logid=1,
                                payloads=[f"r{k}".encode()],
                                expect_lsn=k - 1, append_time_ms=1000 + k)
                    for k in range(2, n + 1)]
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            fp.rpc.StoreReplicaStub(ch).Replicate(
                pb.ReplicateRequest(entries=entries, leader_id="L"),
                timeout=5)
        group.append((srv, svc, f"127.0.0.1:{port}"))
    return group


def _promote(p, fp) -> dict:
    """p.repl.promote_best over a fed group of fp's followers and one
    address where nothing listens."""
    group = _fed_group(fp)
    addrs = [g[2] for g in group] + [f"127.0.0.1:{free_port()}"]
    try:
        res = p.repl.promote_best(addrs, leader_addr="next:1",
                                  promoted_by="test")
        return {"target": addrs.index(res["target"]), "ok": res["ok"],
                "epoch": res["epoch"], "node_id": res["node_id"],
                "applied_seq": res["applied_seq"],
                "sealed": [addrs.index(a) for a in res["sealed"]],
                "unreachable": [addrs.index(a) for a in res["unreachable"]],
                "replicas": [(svc.is_leader, svc.epoch)
                             for _s, svc, _a in group]}
    finally:
        for srv, svc, _a in group:
            srv.stop(grace=0)
            svc.close()


@pytest.mark.parametrize("followers", ["ref", "port"])
def test_promote_best_picks_the_same_replica(followers):
    """Both packages' promote_best over equal groups of one package's
    followers: the most caught-up replica promoted to epoch 1, the
    others sealed at it, the dead address named."""
    fp = {"ref": REF, "port": PORT}[followers]
    got = both(_promote, fp)
    assert got["target"] == 1 and got["node_id"] == "g1" and got["ok"]
    assert got["epoch"] == 1 and got["applied_seq"] == 9
    assert got["sealed"] == [0, 2] and got["unreachable"] == [3]
    assert got["replicas"] == [(False, 1), (True, 1), (False, 1)]


def _first_ack(p, monkeypatch, hold: bool) -> dict:
    """A fresh leader's first mutations with both followers listening:
    how many were acked degraded before the senders had dialled. Each
    sender's first dial waits for `go`: set 0.3 s after the start, or
    with `hold` only once the mutations returned."""
    stub_cls = p.repl.StoreReplicaStub
    go = threading.Event()

    class SlowDial(stub_cls):
        def ReplicaInfo(self, *a, **k):
            go.wait(30)
            return super().ReplicaInfo(*a, **k)

    monkeypatch.setattr(p.repl, "StoreReplicaStub", SlowDial)
    group = []
    for _ in range(2):
        addr = f"127.0.0.1:{free_port()}"
        group.append(p.repl.serve_follower(p.open_store("mem://"), addr)
                     + (addr,))
    timer = None if hold else threading.Timer(0.3, go.set)
    leader = p.repl.ReplicatedStore(p.open_store("mem://"),
                                    [g[2] for g in group],
                                    replication_factor=3)
    try:
        if timer is not None:
            timer.start()
        leader.create_log(1)
        leader.append(1, b"first")
        return {"degraded": leader.degraded_appends,
                "status": leader.last_ack_status}
    finally:
        go.set()
        if timer is not None:
            timer.cancel()
        leader.close()
        for srv, svc, _a in group:
            srv.stop(grace=0)
            svc.close()


def test_a_fresh_leader_waits_for_its_first_dial(monkeypatch):
    """ROADMAP C: the reference acks a fresh leader's mutations
    "degraded:followers_down" until its senders have dialled the
    (listening) followers (held here until the mutations returned); a
    server booted with --replicate does so with its boot's first write.
    The port counts a follower not yet dialled as pending, so the same
    mutations (its dials held 0.3 s) are replicated."""
    assert _first_ack(PORT, monkeypatch, hold=False) == {
        "degraded": 0, "status": "replicated"}
    assert _first_ack(REF, monkeypatch, hold=True) == {
        "degraded": 2, "status": "degraded:followers_down"}


def _large_catch_up(p) -> dict:
    """Ten appends of 3 MiB while the follower is not listening yet, then
    the follower: whether its catch-up (30 MiB of op-log) converges."""
    addr = f"127.0.0.1:{free_port()}"
    leader = p.repl.ReplicatedStore(p.open_store("mem://"), [addr],
                                    replication_factor=2)
    big = [bytes([i]) * (3 << 20) for i in range(10)]
    server = None
    try:
        leader.create_log(1)
        for b in big:
            leader.append(1, b)
        follower_store = p.open_store("mem://")
        server, svc = p.repl.serve_follower(follower_store, addr)
        try:
            wait_until(lambda: svc.applied_seq >= leader.oplog_seq,
                       "catch-up", 8.0)
        except TimeoutError:
            return {"caught_up": False}
        return {"caught_up": True,
                "same": log_contents(follower_store, 1) ==
                log_contents(leader.local, 1)}
    finally:
        leader.close()
        if server is not None:
            server.stop(grace=0)


def test_a_follower_catches_up_on_large_appends():
    """ROADMAP C: the reference's sender puts up to 64 op-log entries in
    one Replicate and its follower takes gRPC's 4 MiB default, so a
    follower behind by a few framed blocks is refused with
    RESOURCE_EXHAUSTED and stays down; the port's requests stop at 16
    MiB of payloads and its follower takes a 64 MiB append."""
    assert _large_catch_up(PORT) == {"caught_up": True, "same": True}
    assert _large_catch_up(REF) == {"caught_up": False}
