"""The cluster layer under chaos: the promotion and placer cases of
tests/test_chaos.py (follower flap, failover with a retrying producer,
a partitioned stale leader, dueling promotions, the divergence guard,
lease auto-promotion, promotion racing appends, and killing the owner of
a placed query), each run once against each package (`p`, parametrised
over torch_server.PACKAGES). The port's servers run on the CPU.

Every fault schedule is seeded through the package's own fault registry
(FAULTS), disarmed before and after each case in both packages.

Killing a placed query's owner runs with a heartbeat lease of its
package's measured margin (LEASE_MS). A placer writes its heartbeats
only at its ticks, and the tick that adopts a query resumes it inline.
In the reference that resume compiles its executor, so an adopting tick
was measured at up to 2.6 s on the CPU in one process: past an 800 ms
lease the adopter's own fresh record lapsed, a second survivor adopted
it and the first self-fenced, with two owners at the samples between
(ROADMAP C). The port's ticks took at most 10 ms on the CPU and 25 ms
on an H100, and its owner's record was never older than 105 ms. The
properties stay the reference's: exactly one owner at every sampled
instant and final counts equal to a no-fault run, here the reference
package's executor over the same seeded rows.
"""

from __future__ import annotations

import importlib
import random
import socket
import threading
import time
from types import SimpleNamespace

import grpc
import pytest

from torch_server import PACKAGES

BASE = 1_700_000_000_000
# the heartbeat lease of the placer cases: about three times the largest
# adopting tick measured in process for the reference (2.6 s), and twenty
# times the port's largest heartbeat age (105 ms)
LEASE_MS = {"hstream_tpu": 8000, "hstream_tpu_torch": 2000}

_MODS = {
    "rec": "common.records", "faults": "common.faultinject",
    "locktrace": "common.locktrace", "errors": "common.errors",
    "pb": "proto.api_pb2", "rpc": "proto.rpc", "main": "server.main",
    "tasks": "server.tasks", "scheduler": "server.scheduler",
    "codegen": "sql.codegen", "store": "store", "api": "store.api",
    "replica": "store.replica", "retry": "client.retry",
    "columnar": "common.columnar", "prometheus": "stats.prometheus",
}


def _package(root: str) -> SimpleNamespace:
    ns = SimpleNamespace(root=root, **{
        k: importlib.import_module(f"{root}.{v}") for k, v in _MODS.items()})
    ns.cpu = {"device": "cpu"} if root.endswith("_torch") else {}
    ns.FAULTS = ns.faults.FAULTS
    ns.LOCKTRACE = ns.locktrace.LOCKTRACE
    return ns


def _disarm(p) -> None:
    p.FAULTS.disarm()
    p.LOCKTRACE.disarm()
    p.tasks.QueryTask.snapshot_interval_ms = 1000


@pytest.fixture(params=PACKAGES)
def p(request):
    """One package, its process-global registries disarmed before and
    after the case (so are the other package's)."""
    pkgs = {root: _package(root) for root in PACKAGES}
    for q in pkgs.values():
        _disarm(q)
    yield pkgs[request.param]
    for q in pkgs.values():
        _disarm(q)


def _wait(cond, timeout=20.0, step=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(step)
    return False


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _event_kinds(ctx):
    return {e["kind"] for e in ctx.events.query(limit=1000)}


def _log_contents(p, store, logid):
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
        for it in items:
            if isinstance(it, p.api.DataBatch):
                out.append((it.lsn, tuple(it.payloads)))
    return out


def _store_fingerprint(p, store):
    """Every data log's contents plus every meta key but the replica's
    own leadership binding: two converged replicas compare equal."""
    logs = {lid: _log_contents(p, store, lid) for lid in store.list_logs()
            if lid != p.replica.OPLOG_ID}
    meta = {key: store.meta_get(key) for key in store.meta_list("")
            if not key.startswith("replica/")}
    return {"logs": logs, "meta": meta}


# ---- follower flap ----------------------------------------------------------


def test_follower_flap_backs_off_then_converges(p):
    """store.follower.connect=fail:1:3 fails the sender's first three
    connects: the reconnect loop backs off and the follower converges
    once the site goes quiet, every injected hit accounted for."""
    FAULTS = p.FAULTS
    port = _free_port()
    follower_store = p.store.open_store("mem://")
    fsrv, svc = p.replica.serve_follower(follower_store, f"127.0.0.1:{port}")
    FAULTS.arm("store.follower.connect", "fail:1:3")
    leader = p.replica.ReplicatedStore(p.store.open_store("mem://"),
                                       [f"127.0.0.1:{port}"],
                                       replication_factor=2)
    try:
        leader.create_log(5)
        leader.append(5, b"one")
        leader.append(5, b"two")
        f = leader._followers[0]
        assert _wait(lambda: FAULTS.status()
                     ["store.follower.connect"]["injected"] >= 3,
                     timeout=15)
        assert _wait(lambda: svc.applied_seq >= leader.oplog_seq,
                     timeout=20), (svc.applied_seq, leader.oplog_seq)
        assert _wait(lambda: f.connect_attempts == 0, timeout=10)
        assert f.last_backoff_s == 0.0
        assert leader.follower_status()[0]["alive"] is True
        assert FAULTS.status()["store.follower.connect"]["injected"] == 3
    finally:
        FAULTS.disarm()
        leader.close()
        fsrv.stop(grace=1)


# ---- multi-node failover: epoch fencing, promotion, dedup -------------------


class _ReplicaGroup:
    """One leader SQL server over a mem store + N in-process follower
    replica services, with teardown that survives partial failover."""

    def __init__(self, p, n_followers=2, ack_timeout_ms=2000):
        self.p = p
        self.followers = []
        for i in range(n_followers):
            st = p.store.open_store("mem://")
            addr = f"127.0.0.1:{_free_port()}"
            srv, svc = p.replica.serve_follower(st, addr,
                                                node_id=f"replica-{i}")
            self.followers.append(
                {"store": st, "srv": srv, "svc": svc, "addr": addr})
        self.server, self.ctx = p.main.serve(
            "127.0.0.1", 0, "mem://",
            replicate=",".join(f["addr"] for f in self.followers),
            replication_factor=1 + n_followers,
            replica_ack_timeout_ms=ack_timeout_ms, **p.cpu)
        self.addr = f"127.0.0.1:{self.ctx.port}"
        self.channel = grpc.insecure_channel(self.addr)
        self.stub = p.rpc.HStreamApiStub(self.channel)
        self.new_server = None
        self.new_ctx = None

    def follower(self, addr):
        return next(f for f in self.followers if f["addr"] == addr)

    def caught_up(self):
        seq = self.ctx.store.oplog_seq
        return all(f["svc"].applied_seq >= seq for f in self.followers)

    def close(self):
        self.channel.close()
        self.server.stop(grace=1)
        try:
            self.ctx.shutdown()
        except Exception:  # noqa: BLE001 — a fenced store refuses the
            pass           # final status writes; teardown goes on
        if self.new_server is not None:
            self.new_server.stop(grace=1)
            try:
                self.new_ctx.shutdown()
            except Exception:  # noqa: BLE001
                pass
        for f in self.followers:
            f["svc"].close()
            f["srv"].stop(grace=1)


class _Producer:
    """Append client with a stamped (producer_id, seq) and a retry policy
    that follows NOT_LEADER hints by rebinding its channel."""

    def __init__(self, p, addr, producer_id="prod-1", seed=7):
        self.p = p
        self.addr = addr
        self.producer_id = producer_id
        self.channel = grpc.insecure_channel(addr)
        self.stub = p.rpc.HStreamApiStub(self.channel)
        self.policy = p.retry.RetryPolicy(attempts=6, base_ms=5,
                                          rng=random.Random(seed))

    def _follow(self, hint):
        old = self.channel
        self.addr = hint
        self.channel = grpc.insecure_channel(hint)
        self.stub = self.p.rpc.HStreamApiStub(self.channel)
        old.close()

    def append(self, stream, row, seq):
        pb = self.p.pb
        req = pb.AppendRequest(stream_name=stream,
                               producer_id=self.producer_id,
                               producer_seq=seq)
        req.records.append(self.p.rec.build_record(row,
                                                   publish_time_ms=BASE))
        return self.policy.call(lambda r: self.stub.Append(r), req,
                                on_leader_hint=self._follow)

    def close(self):
        self.channel.close()


def test_leader_failover_retrying_producer_exact_once(p):
    """The leader loses leadership mid-append-stream, the retrying
    producer follows the NOT_LEADER hint, the retry that straddles the
    promotion lands exactly once, and the survivors converge
    byte-identical."""
    pb = p.pb
    g = _ReplicaGroup(p, n_followers=2)
    prod = _Producer(p, g.addr)
    try:
        g.stub.CreateStream(pb.Stream(stream_name="fo1"))
        lsns = {}
        for seq in (1, 2, 3):
            resp = prod.append("fo1", {"n": seq}, seq)
            assert not resp.duplicate
            lsns[seq] = resp.record_ids[0].batch_id
        assert _wait(g.caught_up), "followers never caught up"

        new_port = _free_port()
        promo = p.replica.promote_best(
            [f["addr"] for f in g.followers],
            leader_addr=f"127.0.0.1:{new_port}")
        assert promo["ok"] and promo["epoch"] == 1
        assert promo["node_id"] == "replica-1"
        other = next(f for f in g.followers
                     if f["addr"] != promo["target"])
        assert promo["sealed"] == [other["addr"]]
        assert other["svc"].epoch == promo["epoch"]

        winner = g.follower(promo["target"])
        g.new_server, g.new_ctx = p.main.serve(
            "127.0.0.1", new_port, store=winner["store"],
            replicate=other["addr"], replication_factor=2,
            replica_ack_timeout_ms=2000, **p.cpu)
        assert g.new_ctx.store.epoch == promo["epoch"]
        assert g.new_ctx.store.node_id == "replica-1"

        assert _wait(lambda: g.ctx.store.fenced_by is not None,
                     timeout=15), "old leader never fenced"
        assert g.ctx.store.fenced_by[0] == promo["epoch"]

        r3 = prod.append("fo1", {"n": 3}, 3)
        assert prod.policy.leader_follows >= 1
        assert prod.addr == f"127.0.0.1:{new_port}"
        assert r3.duplicate, "retry across failover must dedup"
        assert r3.record_ids[0].batch_id == lsns[3]
        for seq in (4, 5):
            resp = prod.append("fo1", {"n": seq}, seq)
            assert not resp.duplicate
            lsns[seq] = resp.record_ids[0].batch_id

        new_store = g.new_ctx.store
        assert _wait(lambda: other["svc"].applied_seq
                     >= new_store.oplog_seq), "peer never converged"
        logid = g.new_ctx.streams.get_logid("fo1")
        want = _log_contents(p, new_store.local, logid)
        assert len(want) == 5 and want[-1][0] == lsns[5]
        assert _log_contents(p, other["store"], logid) == want
        assert _store_fingerprint(p, other["store"]) == \
            _store_fingerprint(p, new_store.local)

        assert g.new_ctx.stats.stream_stat_get("append_deduped",
                                               "fo1") == 1
        assert g.ctx.store.fenced_appends >= 1
        assert "replica_fenced" in _event_kinds(g.ctx)
        text = p.prometheus.render_metrics(g.new_ctx)
        assert f"hstream_replica_epoch {promo['epoch']}" in text
        assert "hstream_dedup_window_size 5" in text
        assert 'hstream_append_deduped_total{stream="fo1"} 1' in text
    finally:
        prod.close()
        g.close()


def test_stale_leader_partition_appends_fenced_not_replicated(p):
    """replica.partition drops every Replicate: the partitioned leader's
    appends land only on its own store (degraded). A follower promoted
    during the partition fences it: its later appends are rejected, the
    orphan entry never reaches a survivor, and a stale-epoch Replicate
    is answered fenced."""
    pb, rec, FAULTS = p.pb, p.rec, p.FAULTS
    g = _ReplicaGroup(p, n_followers=2, ack_timeout_ms=600)
    try:
        g.stub.CreateStream(pb.Stream(stream_name="pt1"))
        req = pb.AppendRequest(stream_name="pt1")
        req.records.append(rec.build_record({"n": 1},
                                            publish_time_ms=BASE))
        g.stub.Append(req)
        assert _wait(g.caught_up)
        logid = g.ctx.streams.get_logid("pt1")

        FAULTS.arm("replica.partition", "fail:1:100000")
        req = pb.AppendRequest(stream_name="pt1")
        req.records.append(rec.build_record({"n": "orphan"},
                                            publish_time_ms=BASE))
        g.stub.Append(req)
        assert g.ctx.store.last_ack_status.startswith("degraded")

        promo = p.replica.promote_best([f["addr"] for f in g.followers],
                                       leader_addr="127.0.0.1:1")
        assert promo["ok"] and promo["sealed"] == []
        FAULTS.disarm("replica.partition")
        other = next(f for f in g.followers
                     if f["addr"] != promo["target"])
        assert p.replica.seal_replicas(
            [other["addr"]], epoch=promo["epoch"],
            leader_id=promo["node_id"],
            leader_hint="127.0.0.1:1") == [other["addr"]]

        assert _wait(lambda: g.ctx.store.fenced_by is not None,
                     timeout=20), "stale leader never fenced"
        tail_before = g.ctx.store.local.tail_lsn(logid)
        req = pb.AppendRequest(stream_name="pt1")
        req.records.append(rec.build_record({"n": "rejected"},
                                            publish_time_ms=BASE))
        with pytest.raises(grpc.RpcError) as err:
            g.stub.Append(req)
        e = err.value
        assert e.code() == grpc.StatusCode.UNAVAILABLE
        assert "not_leader leader_hint=127.0.0.1:1" in e.details()
        md = dict(e.trailing_metadata() or ())
        assert md.get("x-leader-hint") == "127.0.0.1:1"
        assert g.ctx.store.local.tail_lsn(logid) == tail_before

        for f in g.followers:
            assert len(_log_contents(p, f["store"], logid)) == 1
        with grpc.insecure_channel(other["addr"]) as ch:
            resp = p.rpc.StoreReplicaStub(ch).Replicate(
                pb.ReplicateRequest(
                    entries=[pb.LogEntry(seq=99, op=pb.OP_CREATE_LOG,
                                         logid=77)],
                    leader_id=g.ctx.store.node_id, epoch=0),
                timeout=5)
        assert resp.fenced and resp.epoch == promo["epoch"]
        assert resp.leader_hint == "127.0.0.1:1"
        assert not other["store"].log_exists(77)
        assert g.ctx.store.fenced_appends >= 1
        assert "replica_fenced" in _event_kinds(g.ctx)
    finally:
        g.close()


def test_dueling_promotions_resolve_to_one_leader(p):
    """Two operators promote two followers at the same epoch: first
    contact resolves it, the higher node id keeps leadership."""
    pb, FAULTS = p.pb, p.FAULTS
    g = _ReplicaGroup(p, n_followers=2)
    try:
        assert _wait(g.caught_up)
        FAULTS.arm("replica.promote.race", "delay:30")
        for f in g.followers:
            with grpc.insecure_channel(f["addr"]) as ch:
                resp = p.rpc.StoreReplicaStub(ch).Promote(
                    pb.PromoteRequest(epoch=1, leader_addr=f["addr"],
                                      promoted_by="race"),
                    timeout=5)
            assert resp.ok
        FAULTS.disarm("replica.promote.race")
        lo, hi = g.followers[0], g.followers[1]  # replica-0 < replica-1
        assert lo["svc"].is_leader and hi["svc"].is_leader

        assert p.replica.seal_replicas(
            [lo["addr"]], epoch=1, leader_id=hi["svc"].node_id,
            leader_hint=hi["addr"]) == [lo["addr"]]
        assert not lo["svc"].is_leader
        assert lo["store"].meta_get("replica/leader_id") == \
            hi["svc"].node_id.encode()
        with grpc.insecure_channel(hi["addr"]) as ch:
            resp = p.rpc.StoreReplicaStub(ch).Replicate(
                pb.ReplicateRequest(entries=[], epoch=1,
                                    leader_id=lo["svc"].node_id,
                                    leader_hint=lo["addr"]),
                timeout=5)
        assert resp.fenced
        assert hi["svc"].is_leader
        assert [f["svc"].is_leader for f in g.followers] == [False, True]
    finally:
        g.close()


def test_follower_divergence_guard_halts_loudly(p):
    """A follower whose local store drifted from the op-log halts with
    the divergence error, applying nothing more."""
    pb, rec = p.pb, p.rec
    g = _ReplicaGroup(p, n_followers=2)
    try:
        g.stub.CreateStream(pb.Stream(stream_name="dv1"))
        for n in (1, 2):
            req = pb.AppendRequest(stream_name="dv1")
            req.records.append(rec.build_record({"n": n},
                                                publish_time_ms=BASE))
            g.stub.Append(req)
        assert _wait(g.caught_up)
        logid = g.ctx.streams.get_logid("dv1")
        bad, good = g.followers[0], g.followers[1]

        bad["store"].remove_log(logid)
        bad["store"].create_log(logid)
        frozen_seq = bad["svc"].applied_seq
        req = pb.AppendRequest(stream_name="dv1")
        req.records.append(rec.build_record({"n": 3},
                                            publish_time_ms=BASE))
        g.stub.Append(req)

        assert _wait(lambda: bad["svc"]._broken is not None,
                     timeout=15), "divergence never latched"
        assert "diverged" in str(bad["svc"]._broken)
        assert bad["svc"].applied_seq == frozen_seq
        assert _log_contents(p, bad["store"], logid) == []
        with grpc.insecure_channel(bad["addr"]) as ch:
            with pytest.raises(grpc.RpcError) as err:
                p.rpc.StoreReplicaStub(ch).Replicate(
                    pb.ReplicateRequest(
                        entries=[], leader_id=g.ctx.store.node_id,
                        epoch=0),
                    timeout=5)
        assert err.value.code() == grpc.StatusCode.INTERNAL
        assert "diverged" in (err.value.details() or "")
        assert _wait(lambda: good["svc"].applied_seq
                     >= g.ctx.store.oplog_seq)
        assert len(_log_contents(p, good["store"], logid)) == 3
    finally:
        g.close()


def test_heartbeat_loss_triggers_lease_auto_promotion(p):
    """replica.heartbeat.drop kills every idle-leader heartbeat: the
    follower's lease monitor promotes it, and the old leader fences
    itself on its next contact."""
    FAULTS = p.FAULTS
    st = p.store.open_store("mem://")
    addr = f"127.0.0.1:{_free_port()}"
    fsrv, svc = p.replica.serve_follower(st, addr, node_id="auto-f",
                                         lease_timeout_s=0.6)
    leader = p.replica.ReplicatedStore(p.store.open_store("mem://"), [addr],
                                       replication_factor=2,
                                       client_addr="old:1")
    try:
        leader.create_log(5)
        leader.append(5, b"one")
        assert _wait(lambda: svc.applied_seq >= leader.oplog_seq)
        FAULTS.arm("replica.heartbeat.drop", "fail:1:100000")
        assert _wait(lambda: svc.is_leader, timeout=20), \
            "lease auto-promotion never fired"
        assert svc.epoch >= 1
        assert _wait(lambda: leader.fenced_by is not None, timeout=20)
        assert leader.fenced_by[1] == addr
        with pytest.raises(p.errors.NotLeaderError) as err:
            leader.append(5, b"two")
        assert err.value.leader_hint == addr
    finally:
        FAULTS.disarm()
        leader.close()
        svc.close()
        fsrv.stop(grace=1)


def test_interleaving_promotion_vs_append_races(p):
    """A producer appending through the leader store while a follower is
    promoted out from under it: every acked, replicated append is
    durable on the promoted side, and the armed witness sees no replica
    lock-order cycle."""
    FAULTS, LOCKTRACE = p.FAULTS, p.LOCKTRACE
    for seed in (3, 17):
        FAULTS.disarm()
        LOCKTRACE.disarm()
        LOCKTRACE.arm()
        for site in ("replica.oplog", "replica.follower"):
            FAULTS.arm(f"lock.acquire.{site}", f"yield:2:{seed}")
        follower_store = p.store.open_store("mem://")
        port = _free_port()
        fsrv, svc = p.replica.serve_follower(
            follower_store, f"127.0.0.1:{port}", node_id="replica-p")
        leader = p.replica.ReplicatedStore(p.store.open_store("mem://"),
                                           [f"127.0.0.1:{port}"],
                                           replication_factor=2,
                                           ack_timeout_s=2.0)
        try:
            leader.create_log(7)
            acked: list[tuple[int, bytes, str]] = []
            refused = []

            def producer():
                for i in range(40):
                    payload = b"row-%d" % i
                    try:
                        lsn = leader.append_batch(7, [payload])
                        acked.append((lsn, payload,
                                      leader.last_ack_status))
                    except Exception:  # noqa: BLE001 — NotLeader or a
                        # transport error racing the fence: the contract
                        # binds only acked appends
                        refused.append(payload)
                        return

            t = threading.Thread(target=producer)
            t.start()
            time.sleep(0.02)
            promo = p.replica.promote_best([f"127.0.0.1:{port}"],
                                           leader_addr="127.0.0.1:1")
            assert promo["ok"], promo
            t.join(timeout=30)
            assert not t.is_alive(), f"seed {seed}: producer hung"
            _wait(lambda: svc.applied_seq >= leader.oplog_seq
                  or leader.fenced_by is not None, timeout=10)
            landed = dict(_log_contents(p, follower_store, 7))
            replicated = [(lsn, pl) for lsn, pl, st in acked
                          if st == "replicated"]
            assert replicated, f"seed {seed}: nothing replicated " \
                               "before the fence; scenario degenerate"
            for lsn, payload in replicated:
                assert landed.get(lsn) == (payload,), \
                    f"seed {seed}: acked lsn {lsn} missing/diverged"
            if leader.fenced_by is not None and \
                    len(replicated) < len(acked):
                assert any(st != "replicated" for _l, _p, st in acked)
        finally:
            leader.close()
            svc.close()
            fsrv.stop(grace=1)
        assert LOCKTRACE.cycles() == [], \
            f"seed {seed}: witness reported a lock-order cycle"
        LOCKTRACE.disarm()
        FAULTS.disarm()


# ---- the placer: kill-the-owner adoption, exact results ---------------------


def _placer_cluster(p, n=3):
    """N armed servers over ONE shared mem store."""
    store = p.store.open_store("mem://")
    nodes = []
    for _ in range(n):
        nodes.append(p.main.serve(
            "127.0.0.1", 0, store=store, owns_store=False,
            placer_interval_ms=100, heartbeat_lease_ms=LEASE_MS[p.root],
            snapshot_interval_ms=60, load_report_interval_ms=300, **p.cpu))
    return store, nodes


def _placer_kill(server, ctx):
    """Crash-style death: no record cleanup, the node's scheduler records
    just stop heartbeating."""
    ctx.placer.stop()
    ctx.supervisor.shutdown()
    server.stop(grace=0)
    for task in list(ctx.running_queries.values()):
        try:
            task.stop(detach=True)
        except Exception:  # noqa: BLE001
            pass
    ctx.running_queries.clear()
    ctx.load_reporter.stop()


def _placer_owners(nodes, qid, dead):
    return [i for i, (_s, c) in enumerate(nodes)
            if i not in dead and qid in c.running_queries]


def _sink_final(rows, count_col):
    """Last-change-wins fold of an EMIT CHANGES sink log: the final count
    per (key, window)."""
    final = {}
    for r in rows:
        if "k" in r and count_col in r and "winStart" in r:
            final[(r["k"], r["winStart"])] = r[count_col]
    return final


def _read_sink(p, ctx, stream):
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
                crows = p.columnar.payload_rows(pr.payload)
                if crows is not None:
                    out.extend(crows)
                    continue
                row = p.rec.record_to_dict(pr)
                if row is not None:
                    out.append(row)
    return out


SELECT = ("SELECT k, COUNT(*) AS c FROM src GROUP BY k, TUMBLING "
          "(INTERVAL 10 SECOND) GRACE BY INTERVAL 0 SECOND EMIT CHANGES;")


def _no_fault_finals(root, batches):
    """The final counts of a no-fault single executor of `root` over the
    same rows."""
    q = _package(root)
    ex = q.codegen.make_executor(q.codegen.stream_codegen(SELECT),
                                 sample_rows=[{"k": "a", "v": 0}], **q.cpu)
    out = []
    for rows, ts in batches:
        out.extend(ex.process(rows, ts))
    out.extend(ex.flush_changes())
    return _sink_final(out, "c")


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_placer_kill_owner_adoption_exact(p, seed):
    """Kill the node that owns a live query mid-stream: within the lease
    and a few placer ticks exactly one survivor adopts it (one owner at
    every sampled instant), resumes from the snapshot, and the sink's
    final per-window counts equal a no-fault run over the same rows."""
    pb, rec, sch = p.pb, p.rec, p.scheduler
    lease_s = LEASE_MS[p.root] / 1000
    rng = random.Random(seed)
    store, nodes = _placer_cluster(p, 3)
    dead: set[int] = set()
    channels = []
    try:
        _s0, c0 = nodes[0]
        ch0 = grpc.insecure_channel(f"127.0.0.1:{c0.port}")
        channels.append(ch0)
        stub0 = p.rpc.HStreamApiStub(ch0)
        stub0.CreateStream(pb.Stream(stream_name="src"))
        stub0.ExecuteQuery(pb.CommandQuery(
            stmt_text="CREATE STREAM snk AS " + SELECT))
        qid = c0.persistence.get_queries()[0].query_id
        assert _wait(lambda: len(_placer_owners(nodes, qid, dead)) == 1,
                     timeout=15), "query never landed on a node"

        batches = []  # the seeded row sequence, for the no-fault run

        def append_via(ctx, rows, ts):
            req = pb.AppendRequest(stream_name="src")
            for row, t in zip(rows, ts):
                req.records.append(rec.build_record(row, publish_time_ms=t))
            ch = grpc.insecure_channel(f"127.0.0.1:{ctx.port}")
            channels.append(ch)
            p.rpc.HStreamApiStub(ch).Append(req)
            batches.append((rows, ts))

        def seeded_batch(w, n):
            rows = [{"k": rng.choice("abc"), "v": rng.randrange(10)}
                    for _ in range(n)]
            return rows, [BASE + w * 10_000 + i for i in range(len(rows))]

        for w in range(3):
            append_via(c0, *seeded_batch(w, rng.randrange(3, 7)))
        owner = _placer_owners(nodes, qid, dead)[0]
        assert _wait(lambda: bool(_sink_final(_read_sink(p, c0, "snk"),
                                              "c")), timeout=30), \
            "no output before the kill; scenario degenerate"

        _placer_kill(*nodes[owner])
        dead.add(owner)
        survivor_ctx = next(c for i, (_s, c) in enumerate(nodes)
                            if i not in dead)
        for w in range(3, 5):
            append_via(survivor_ctx, *seeded_batch(w, rng.randrange(3, 7)))

        deadline = time.time() + lease_s + 20
        adopted = False
        while time.time() < deadline:
            owners = _placer_owners(nodes, qid, dead)
            assert len(owners) <= 1, f"seed {seed}: double owners {owners}"
            if owners and owners[0] != owner:
                adopted = True
                break
            time.sleep(0.05)
        assert adopted, f"seed {seed}: no survivor adopted {qid}"

        for w in range(5, 7):
            append_via(survivor_ctx, *seeded_batch(w, rng.randrange(3, 7)))
        append_via(survivor_ctx, [{"k": "zz", "v": 0}], [BASE + 90_000])

        want = _no_fault_finals(PACKAGES[0], batches)
        assert want, "reference emitted nothing; scenario degenerate"
        assert _no_fault_finals(p.root, batches) == want

        def exact():
            got = _sink_final(_read_sink(p, survivor_ctx, "snk"), "c")
            return all(got.get(kw) == c for kw, c in want.items())

        assert _wait(exact, timeout=30), (
            f"seed {seed}: adopted run diverged: "
            f"{_sink_final(_read_sink(p, survivor_ctx, 'snk'), 'c')}"
            f" != {want}")
        owners = _placer_owners(nodes, qid, dead)
        assert len(owners) == 1
        a = sch.assignment(survivor_ctx, qid)
        assert a["node"] == sch.node_name(nodes[owners[0]][1])
        assert a["state"] == "owned"
        assert sch.owner_live(a, lease_ms=LEASE_MS[p.root])
        kinds = [e["kind"] for e in nodes[owners[0]][1].events.query(
            kind="query_adopted", limit=10)]
        assert kinds, f"seed {seed}: no query_adopted event"
        if p.cpu:
            task = nodes[owners[0]][1].running_queries[qid]
            assert task.executor.device.type == "cpu"
    finally:
        for ch in channels:
            ch.close()
        for i, (server, ctx) in enumerate(nodes):
            if i in dead:
                continue
            server.stop(grace=0.1)
            ctx.shutdown()
        store.close()
