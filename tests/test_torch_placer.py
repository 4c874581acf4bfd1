"""The placer (hstream_tpu_torch/placer/core.py, score.py) against the
reference's (tests/test_placer.py).

Every case of tests/test_placer.py runs once against each package (`p`,
parametrised over torch_server.PACKAGES): the scoring units, the
heartbeat / offer / live-adopt CAS discipline, and in-process armed
clusters over one shared store (least-loaded placement, failover
adoption, rebalance, self-fencing). The port's contexts and servers run
on the CPU. Then both packages score the same seeded load records:
node_score and rank_nodes (ranking and skip reasons) exact.
"""

from __future__ import annotations

import importlib
import json
import time
from types import SimpleNamespace

import grpc
import numpy as np
import pytest

from torch_server import PACKAGES

BASE = 1_700_000_000_000
NOW = 10**14  # fixed "now" for pure scoring units

_MODS = {
    "score": "placer.score", "core": "placer.core", "pb": "proto.api_pb2",
    "rpc": "proto.rpc", "scheduler": "server.scheduler",
    "context": "server.context", "main": "server.main", "store": "store",
    "rec": "common.records", "persistence": "server.persistence",
    "health": "server.health", "prometheus": "stats.prometheus",
    "versioned": "store.versioned",
}


def _package(root: str) -> SimpleNamespace:
    ns = SimpleNamespace(root=root, **{
        k: importlib.import_module(f"{root}.{v}") for k, v in _MODS.items()})
    ns.cpu = {"device": "cpu"} if root.endswith("_torch") else {}
    return ns


@pytest.fixture(params=PACKAGES)
def p(request):
    return _package(request.param)


def _wait(cond, timeout=20.0, step=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(step)
    return False


# ---- scoring units ----------------------------------------------------------


def test_node_score_folds_load_axes(p):
    node_score = p.score.node_score
    assert node_score({"hb_ms": NOW}) == 0.0
    loaded = {"hb_ms": NOW, "running_queries": 3, "append_inflight": 2,
              "append_front": {"in_flight": 1},
              "arena_pending_batches": 2,
              "dispatch_p99_ms": 7.5, "rss_bytes": 2_000_000_000,
              "health": {"degraded": 1, "stalled": 0}}
    # 3*10 + 2*2 + 1*2 + 2*2 + 7.5 + 2 + 10 = 59.5
    assert node_score(loaded) == 59.5
    assert node_score({"health": {"stalled": 1}}) == 100.0


def test_skip_reasons_cover_ineligible_nodes(p):
    s = p.score
    lease = 1000
    assert s.skip_reason({"hb_ms": NOW}, lease_ms=lease, now_ms=NOW) is None
    assert s.skip_reason({"hb_ms": NOW - 5000}, lease_ms=lease,
                         now_ms=NOW) == s.SKIP_STALE
    assert s.skip_reason({"hb_ms": NOW, "fenced": True}, lease_ms=lease,
                         now_ms=NOW) == s.SKIP_FENCED
    assert s.skip_reason({"hb_ms": NOW, "shed_level": 2}, lease_ms=lease,
                         now_ms=NOW) == s.SKIP_SHEDDING
    assert s.skip_reason({"hb_ms": NOW, "health": {"stalled": 2}},
                         lease_ms=lease, now_ms=NOW) == s.SKIP_STALLED
    # precedence: a stale record is skipped as stale even if also fenced
    assert s.skip_reason({"hb_ms": NOW - 5000, "fenced": True},
                         lease_ms=lease, now_ms=NOW) == s.SKIP_STALE


def test_rank_nodes_is_deterministic_with_name_tiebreak(p):
    records = {
        "b-node": {"hb_ms": NOW, "running_queries": 1},
        "a-node": {"hb_ms": NOW, "running_queries": 1},
        "c-busy": {"hb_ms": NOW, "running_queries": 5},
        "d-dead": {"hb_ms": NOW - 10_000},
    }
    ranked, skipped = p.score.rank_nodes(records, lease_ms=1000, now_ms=NOW)
    assert [n for _s, n in ranked] == ["a-node", "b-node", "c-busy"]
    assert skipped == {"d-dead": p.score.SKIP_STALE}


def _load_records(seed: int, n: int = 40) -> dict:
    """Seeded load records over every axis node_score folds and every
    skip reason: stale, fenced, shedding and stalled nodes among them."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        rec = {"hb_ms": int(NOW - rng.integers(0, 2500))}
        for axis in ("running_queries", "append_inflight",
                     "arena_pending_batches", "shed_level"):
            if rng.random() < 0.7:
                rec[axis] = int(rng.integers(0, 6))
        if rng.random() < 0.7:
            rec["append_front"] = {"in_flight": int(rng.integers(0, 4))}
        if rng.random() < 0.7:
            rec["dispatch_p99_ms"] = float(np.round(rng.gamma(2.0, 3.0), 3))
        if rng.random() < 0.7:
            rec["rss_bytes"] = int(rng.integers(0, 8_000_000_000))
        if rng.random() < 0.5:
            rec["device_hbm_bytes"] = int(rng.integers(0, 4_000_000_000))
        if rng.random() < 0.6:
            rec["health"] = {"degraded": int(rng.integers(0, 3)),
                             "stalled": int(rng.random() < 0.1)}
        if rng.random() < 0.1:
            rec["fenced"] = True
        out[f"node-{int(rng.integers(0, 10**6)):06d}"] = rec
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_scores_and_rankings_match_across_packages(seed):
    """Both packages' node_score over the same seeded load records, and
    their rank_nodes (order and skip reasons), equal exactly."""
    j, t = (_package(root) for root in PACKAGES)
    records = _load_records(seed)
    for name, rec in records.items():
        assert t.score.node_score(rec) == j.score.node_score(rec), name
        assert t.score.skip_reason(rec, lease_ms=1500, now_ms=NOW) == \
            j.score.skip_reason(rec, lease_ms=1500, now_ms=NOW), name
    rj = j.score.rank_nodes(records, lease_ms=1500, now_ms=NOW)
    rt = t.score.rank_nodes(records, lease_ms=1500, now_ms=NOW)
    assert rt == rj
    assert rj[0] and rj[1]  # some ranked, some skipped


# ---- heartbeat / offer / live-adopt CAS units -------------------------------


def _two_contexts(p):
    """Two bare server contexts over ONE store + persistence: ctx2 boots
    later, so its epoch is strictly higher. Both placers are armed but
    never started: tests drive the stages directly."""
    store = p.store.open_store("mem://")
    ctx1 = p.context.ServerContext(store, port=1111, owns_store=False,
                                   placer_interval_ms=100, **p.cpu)
    ctx2 = p.context.ServerContext(store, persistence=ctx1.persistence,
                                   port=2222, owns_store=False,
                                   placer_interval_ms=100, **p.cpu)
    assert ctx2.boot_epoch > ctx1.boot_epoch
    return store, ctx1, ctx2


def _close(store, *ctxs):
    for ctx in reversed(ctxs):
        ctx.shutdown()
    store.close()


def _rewrite_hb(ctx, qid, hb_ms):
    """Backdate a record's heartbeat (a crashed owner's last stamp)."""
    key = "scheduler/query/" + qid
    version, raw = ctx.config.get(key)
    record = json.loads(raw)
    record["hb_ms"] = hb_ms
    ctx.config.put(key, json.dumps(record).encode(), base_version=version)


def test_record_assignment_carries_heartbeat_and_refreshes(p):
    sch = p.scheduler
    store, ctx1, ctx2 = _two_contexts(p)
    try:
        sch.record_assignment(ctx1, "q1")
        a = sch.assignment(ctx1, "q1")
        assert a["state"] == "owned"
        assert sch.owner_live(a, lease_ms=10_000)
        _rewrite_hb(ctx1, "q1", sch.now_ms() - 60_000)
        assert not sch.owner_live(sch.assignment(ctx1, "q1"),
                                  lease_ms=10_000)
        assert sch.heartbeat_assignment(ctx1, "q1")
        assert sch.owner_live(sch.assignment(ctx1, "q1"), lease_ms=10_000)
        before = sch.assignment(ctx1, "q1")
        assert not sch.heartbeat_assignment(ctx2, "q1")
        assert sch.assignment(ctx1, "q1") == before
    finally:
        _close(store, ctx1, ctx2)


def test_try_adopt_live_respects_fresh_heartbeat_whatever_epoch(p):
    sch = p.scheduler
    store, ctx1, ctx2 = _two_contexts(p)
    try:
        sch.record_assignment(ctx1, "q1")
        assert not sch.try_adopt_live(ctx2, "q1", lease_ms=5000)
        assert sch.assignment(ctx2, "q1")["node"] == sch.node_name(ctx1)
        _rewrite_hb(ctx1, "q1", sch.now_ms() - 60_000)
        assert sch.try_adopt_live(ctx2, "q1", lease_ms=5000)
        a = sch.assignment(ctx2, "q1")
        assert a["node"] == sch.node_name(ctx2)
        assert a["state"] == "owned"
        kinds = [e["kind"] for e in ctx2.events.query(limit=100)]
        assert "query_adopted" in kinds
    finally:
        _close(store, ctx1, ctx2)


def test_try_adopt_live_claims_missing_and_offered_records(p):
    sch = p.scheduler
    store, ctx1, ctx2 = _two_contexts(p)
    try:
        assert sch.try_adopt_live(ctx2, "orphan", lease_ms=5000)
        assert sch.assignment(ctx2, "orphan")["node"] == sch.node_name(ctx2)
        sch.record_assignment(ctx1, "q2")
        assert sch.offer_assignment(ctx1, "q2", sch.node_name(ctx2))
        offered = sch.assignment(ctx1, "q2")
        assert offered["state"] == "offered"
        assert offered["epoch"] == 0
        assert offered["src"] == sch.node_name(ctx1)
        assert not sch.try_adopt_live(ctx1, "q2", lease_ms=5000)
        assert sch.try_adopt_live(ctx2, "q2", lease_ms=5000)
        assert sch.assignment(ctx2, "q2")["state"] == "owned"
        assert not sch.try_adopt_live(ctx2, "q2", lease_ms=5000)
    finally:
        _close(store, ctx1, ctx2)


def test_try_adopt_live_legacy_records_keep_epoch_rule(p):
    sch = p.scheduler
    store, ctx1, ctx2 = _two_contexts(p)
    try:
        legacy_hi = json.dumps({"node": "server-9@x:1",
                                "epoch": ctx2.boot_epoch + 5}).encode()
        ctx1.config.put("scheduler/query/qh", legacy_hi)
        assert not sch.try_adopt_live(ctx2, "qh", lease_ms=100)
        legacy_lo = json.dumps({"node": "server-9@x:1",
                                "epoch": 1}).encode()
        ctx2.config.put("scheduler/query/ql", legacy_lo)
        assert sch.try_adopt_live(ctx2, "ql", lease_ms=100)
    finally:
        _close(store, ctx1, ctx2)


def test_boot_try_adopt_stays_epoch_only(p):
    sch = p.scheduler
    store, ctx1, ctx2 = _two_contexts(p)
    try:
        sch.record_assignment(ctx1, "q1")  # fresh hb_ms
        assert sch.try_adopt(ctx2, "q1")
        assert sch.assignment(ctx2, "q1")["node"] == sch.node_name(ctx2)
    finally:
        _close(store, ctx1, ctx2)


def test_disarmed_server_writes_legacy_record(p):
    sch = p.scheduler
    store = p.store.open_store("mem://")
    ctx1 = p.context.ServerContext(store, port=1111, owns_store=False,
                                   **p.cpu)  # disarmed
    try:
        sch.record_assignment(ctx1, "q1")
        a = sch.assignment(ctx1, "q1")
        assert "hb_ms" not in a and "state" not in a
        assert sch.owner_heartbeat_age_ms(a) is None
        assert not sch.owner_live(a, lease_ms=10_000)
    finally:
        _close(store, ctx1)


def _running_query(p, ctx, qid="q1"):
    QueryInfo, TaskStatus = p.persistence.QueryInfo, p.persistence.TaskStatus
    ctx.persistence.insert_query(QueryInfo(
        query_id=qid, sql="select", created_time_ms=BASE,
        query_type="stream", status=TaskStatus.CREATED, sink="s"))
    ctx.persistence.set_query_status(qid, TaskStatus.RUNNING)


def test_adopt_sweep_never_takes_a_live_disarmed_peers_query(p):
    sch = p.scheduler
    store, ctx1, ctx2 = _two_contexts(p)
    try:
        _running_query(p, ctx1)
        legacy = json.dumps({"node": "server-9@x:1", "epoch": 1}).encode()
        ctx1.config.put("scheduler/query/q1", legacy)
        ctx2.placer._adopt_sweep()  # epoch 1 << ctx2's, still skipped
        assert sch.assignment(ctx2, "q1")["node"] == "server-9@x:1"
    finally:
        _close(store, ctx1, ctx2)


def test_orphaned_created_query_rescued_after_lease_lapse(p):
    sch = p.scheduler
    QueryInfo, TaskStatus = p.persistence.QueryInfo, p.persistence.TaskStatus
    store, ctx1, ctx2 = _two_contexts(p)
    try:
        ctx1.persistence.insert_query(QueryInfo(
            query_id="q1", sql="select", created_time_ms=BASE,
            query_type="stream", status=TaskStatus.CREATED, sink="s"))
        offer = {"node": "server-9@x:1", "epoch": 0,
                 "hb_ms": sch.now_ms(), "state": "offered",
                 "src": sch.node_name(ctx1)}
        ctx1.config.put("scheduler/query/q1", json.dumps(offer).encode())
        ctx2.placer._adopt_sweep()
        assert sch.assignment(ctx2, "q1")["node"] == "server-9@x:1"
        _rewrite_hb(ctx2, "q1", sch.now_ms() - 60_000)
        ctx2.placer._adopt_sweep()
        a = sch.assignment(ctx2, "q1")
        assert a["node"] == sch.node_name(ctx2)
        assert a["state"] == "owned"
        adopts = [d for d in ctx2.placer.status()["decisions"]
                  if d["action"] == "adopt"]
        assert adopts and adopts[-1]["query"] == "q1"
    finally:
        _close(store, ctx1, ctx2)


def test_lease_clamped_to_three_ticks(p):
    store = p.store.open_store("mem://")
    ctx = p.context.ServerContext(store, port=1111, owns_store=False,
                                  placer_interval_ms=5000,
                                  heartbeat_lease_ms=1000, **p.cpu)
    try:
        assert ctx.placer.lease_ms == 15_000
        assert ctx.heartbeat_lease_ms == 15_000
        Placer = p.core.Placer
        assert Placer(None, interval_ms=None, lease_ms=1000).lease_ms == 1000
        assert Placer(None, interval_ms=100, lease_ms=800).lease_ms == 800
    finally:
        _close(store, ctx)


def test_dead_owner_heartbeat_lapse_reads_stalled_dead(p):
    sch = p.scheduler
    store, ctx1, ctx2 = _two_contexts(p)
    try:
        _running_query(p, ctx1)
        sch.record_assignment(ctx1, "q1")
        h = p.health.evaluate_query(ctx2, "q1")
        assert h["verdict"] == "OK"
        assert not sch.try_adopt_live(ctx2, "q1",
                                      lease_ms=ctx2.heartbeat_lease_ms)
        _rewrite_hb(ctx1, "q1", sch.now_ms() - 60_000)
        h = p.health.evaluate_query(ctx2, "q1")
        assert h["verdict"] == "STALLED"
        assert "dead" in h["reasons"]
        stalled = [e for e in ctx2.events.query(limit=100)
                   if e["kind"] == "query_stalled"]
        assert stalled and "dead" in stalled[-1]["reasons"]
    finally:
        _close(store, ctx1, ctx2)


# ---- in-process armed clusters ----------------------------------------------


def _serve_node(p, store, lease_ms=800, **kw):
    kw.setdefault("snapshot_interval_ms", 60)
    return p.main.serve("127.0.0.1", 0, store=store, owns_store=False,
                        placer_interval_ms=100, heartbeat_lease_ms=lease_ms,
                        load_report_interval_ms=300, **kw, **p.cpu)


def _cluster(p, n=3, *, lease_ms=800):
    """N armed servers over ONE shared in-memory store."""
    store = p.store.open_store("mem://")
    return store, [_serve_node(p, store, lease_ms) for _ in range(n)]


def _teardown(store, nodes, dead=()):
    for i, (server, ctx) in enumerate(nodes):
        if i in dead:
            continue
        server.stop(grace=0.1)
        ctx.shutdown()
    store.close()


def _kill(server, ctx):
    """Crash a node: no drop_assignment, no record cleanup."""
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


def _owners(nodes, qid, dead=()):
    return [i for i, (_s, c) in enumerate(nodes)
            if i not in dead and qid in c.running_queries]


def _stub(p, ctx):
    ch = grpc.insecure_channel(f"127.0.0.1:{ctx.port}")
    return ch, p.rpc.HStreamApiStub(ch)


def _admin(p, stub, cmd, **kw):
    resp = stub.SendAdminCommand(p.pb.AdminCommandRequest(
        command=cmd, args=p.rec.dict_to_struct(kw)))
    return json.loads(resp.result)


CSAS = ("CREATE STREAM {sink} AS SELECT k, COUNT(*) AS c FROM {src} "
        "GROUP BY k, TUMBLING (INTERVAL 10 SECOND) "
        "GRACE BY INTERVAL 0 SECOND EMIT CHANGES;")


def _qid(ctx):
    qs = [q.query_id for q in ctx.persistence.get_queries()]
    assert len(qs) == 1
    return qs[0]


def test_cluster_places_on_least_loaded_and_exposes_scores(p):
    pb = p.pb
    store, nodes = _cluster(p, 3)
    ch = None
    try:
        _s0, c0 = nodes[0]
        ch, stub = _stub(p, c0)
        stub.CreateStream(pb.Stream(stream_name="src"))
        assert _wait(lambda: len(c0.placer.scores()) == 3, timeout=10)
        stub.ExecuteQuery(pb.CommandQuery(
            stmt_text=CSAS.format(sink="snk", src="src")))
        assert _wait(lambda: len(_owners(nodes, _qid(c0))) == 1,
                     timeout=15)
        qid = _qid(c0)
        st = _admin(p, stub, "placer")
        assert st["armed"] and len(st["nodes"]) == 3
        decision = next(d for d in st["decisions"]
                        if d["action"] == "place")
        assert decision["reason"] == "least_loaded"
        assert decision["query"] == qid
        assert set(decision["scores"]) == set(st["nodes"])
        assert decision["target"] \
            == min(sorted(decision["scores"]),
                   key=lambda n: (decision["scores"][n], n))
        assert st["placements"][qid]["state"] == "owned"
        text = p.prometheus.render_metrics(c0)
        assert "placement_decisions" in text
        assert 'placer_node_score{node="' in text
        if p.cpu:
            owner = nodes[_owners(nodes, qid)[0]][1]
            assert owner.device.type == "cpu"
    finally:
        if ch is not None:
            ch.close()
        _teardown(store, nodes)


def test_full_lifecycle_place_kill_adopt_rebalance(p):
    """Queries placed, the owner killed, a survivor adopts within the
    lease, and a later boot pulls load over through a rebalance offer."""
    pb, sch = p.pb, p.scheduler
    store, nodes = _cluster(p, 1, lease_ms=800)
    ch = None
    dead = set()
    try:
        _s0, c0 = nodes[0]
        ch, stub = _stub(p, c0)
        stub.CreateStream(pb.Stream(stream_name="src"))
        stub.ExecuteQuery(pb.CommandQuery(
            stmt_text=CSAS.format(sink="snk1", src="src")))
        stub.ExecuteQuery(pb.CommandQuery(
            stmt_text=CSAS.format(sink="snk2", src="src")))
        assert _wait(lambda: len(c0.running_queries) == 2, timeout=15)

        for _ in range(2):
            nodes.append(_serve_node(p, store, 800))
        qids = sorted(q.query_id for q in c0.persistence.get_queries())
        assert _wait(
            lambda: sorted(len(_owners(nodes, q)) for q in qids) == [1, 1]
            and len(c0.running_queries) == 1, timeout=20)
        moved = next(q for q in qids if q not in c0.running_queries)
        move = next(d for d in c0.placer.status()["decisions"]
                    if d["action"] == "rebalance")
        assert move["reason"] == "load_skew"
        assert move["query"] == moved

        owner_idx = _owners(nodes, moved)[0]
        assert owner_idx != 0
        _kill(*nodes[owner_idx])
        dead.add(owner_idx)
        t_kill = time.time()
        assert _wait(lambda: len(_owners(nodes, moved, dead)) == 1,
                     timeout=15)
        adopt_s = time.time() - t_kill
        assert adopt_s < 10, f"adoption took {adopt_s:.1f}s"
        survivors = _owners(nodes, moved, dead)
        assert len(survivors) == 1
        a = sch.assignment(c0, moved)
        adopter_ctx = nodes[survivors[0]][1]
        assert a["node"] == sch.node_name(adopter_ctx)
        assert a["state"] == "owned"
        adopts = [d for d in adopter_ctx.placer.status()["decisions"]
                  if d["action"] == "adopt"]
        assert adopts and adopts[-1]["reason"] in ("lease_lapsed",
                                                   "offered")
    finally:
        if ch is not None:
            ch.close()
        _teardown(store, nodes, dead)


def test_restarting_owner_defers_to_live_adopter(p):
    """A server restarting with a HIGHER boot epoch must not snatch back
    a query a live peer owns and heartbeats."""
    pb, sch = p.pb, p.scheduler
    store, nodes = _cluster(p, 1, lease_ms=5000)
    ch = None
    try:
        _s0, c0 = nodes[0]
        ch, stub = _stub(p, c0)
        stub.CreateStream(pb.Stream(stream_name="src"))
        stub.ExecuteQuery(pb.CommandQuery(
            stmt_text=CSAS.format(sink="snk", src="src")))
        assert _wait(lambda: len(c0.running_queries) == 1, timeout=15)
        qid = _qid(c0)
        server2, ctx2 = p.main.serve(
            "127.0.0.1", 0, store=store, owns_store=False,
            placer_interval_ms=100, heartbeat_lease_ms=5000,
            load_report_interval_ms=300, **p.cpu)
        nodes.append((server2, ctx2))
        assert ctx2.boot_epoch > c0.boot_epoch
        assert qid not in ctx2.running_queries
        time.sleep(0.6)
        assert qid not in ctx2.running_queries
        assert sch.assignment(ctx2, qid)["node"] == sch.node_name(c0)
        assert qid in c0.running_queries
    finally:
        if ch is not None:
            ch.close()
        _teardown(store, nodes)


def _cas_put(p, ctx, key, value):
    for _ in range(64):
        cur = ctx.config.get(key)
        try:
            ctx.config.put(key, value,
                           base_version=None if cur is None else cur[0])
            return True
        except p.versioned.VersionMismatch:
            continue
    return False


def test_owner_self_fences_when_ownership_lost(p):
    """A slow-but-alive owner whose record was taken stops its local
    task: its next heartbeat sees the loss and self-fences."""
    pb, sch = p.pb, p.scheduler
    store, nodes = _cluster(p, 1, lease_ms=800)
    ch = None
    try:
        _s0, c0 = nodes[0]
        ch, stub = _stub(p, c0)
        stub.CreateStream(pb.Stream(stream_name="src"))
        stub.ExecuteQuery(pb.CommandQuery(
            stmt_text=CSAS.format(sink="snk", src="src")))
        assert _wait(lambda: len(c0.running_queries) == 1, timeout=15)
        qid = _qid(c0)
        key = "scheduler/query/" + qid
        thief = {"node": "server-99@x:1", "epoch": 999, "state": "owned"}

        def fenced():
            _cas_put(p, c0, key, json.dumps(
                dict(thief, hb_ms=sch.now_ms())).encode())
            return any(d["action"] == "self_fence" and d["query"] == qid
                       for d in c0.placer.status()["decisions"])

        assert _cas_put(p, c0, key, json.dumps(
            dict(thief, hb_ms=sch.now_ms())).encode())
        assert _wait(fenced, timeout=10)
        assert qid not in c0.running_queries
        assert c0.persistence.get_query(qid).status == \
            p.persistence.TaskStatus.RUNNING
        assert sch.assignment(c0, qid)["node"] == "server-99@x:1"
        fence = next(d for d in c0.placer.status()["decisions"]
                     if d["action"] == "self_fence")
        assert fence["reason"] == "ownership_lost"
        time.sleep(0.3)
        assert qid not in c0.running_queries
    finally:
        if ch is not None:
            ch.close()
        _teardown(store, nodes)
