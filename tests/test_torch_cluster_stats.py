"""The cluster stats plane (hstream_tpu_torch/stats) against the
reference's (tests/test_cluster_stats.py): MultiLevelTimeSeries exactness
against brute-force recounts, the declarative-family admin verbs, the
gateway's /stats, the node_load_report journal event, and a seeded
three-node federation merge.

Every case runs once against each package (`p`, or the module-scoped
`stack` of one server and its gateway, parametrised over
torch_server.PACKAGES); the port's servers run on the CPU. Then both
packages are held to each other, exactly: the same seeded random walk
through each package's MultiLevelTimeSeries, and the same seeded
three-node federation's per-node, per-stream ladders.
"""

from __future__ import annotations

import importlib
import json
import random
import socket
import time
import urllib.request
from argparse import Namespace
from types import SimpleNamespace

import grpc
import numpy as np
import pytest

from torch_server import PACKAGES

BASE_S = 1_700_000_000

_MODS = {
    "rec": "common.records", "pb": "proto.api_pb2", "rpc": "proto.rpc",
    "main": "server.main", "stats": "stats", "ts": "stats.timeseries",
    "cluster": "stats.cluster", "prometheus": "stats.prometheus",
    "gateway": "http_gateway", "admin": "admin", "store": "store",
    "replica": "store.replica",
}


def _package(root: str) -> SimpleNamespace:
    ns = SimpleNamespace(root=root, **{
        k: importlib.import_module(f"{root}.{v}") for k, v in _MODS.items()})
    ns.cpu = {"device": "cpu"} if root.endswith("_torch") else {}
    return ns


@pytest.fixture(params=PACKAGES)
def p(request):
    return _package(request.param)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---- multilevel exactness vs brute force -----------------------------------


def _brute_window(adds, now, width, n):
    """(sum, count) of adds whose second lands in the trailing `n` bucket
    slots of width `width` aligned to the bucket grid."""
    cur = int(now) // width
    lo = cur - n + 1
    hits = [v for t, v in adds if lo <= int(t) // width <= cur]
    return sum(hits), len(hits)


STEPS = [0.0, 0.0, 0.3, 0.7, 1.0, 1.0, 2.0, 9.0, 10.0, 59.0, 60.0, 61.0,
         599.0, 601.0, 3601.0]


def _walk(p, seed: int = 0xC1A5, n: int = 2000):
    """A seeded walk of adds and queries through one package's
    MultiLevelTimeSeries, each query checked against the brute-force
    recount; returns every queried (sum, count, rate) and the all-time
    totals."""
    rng = random.Random(seed)
    ts = p.ts.MultiLevelTimeSeries()
    adds, seen = [], []
    t = float(BASE_S)
    qmax = t
    for step in range(n):
        t += rng.choice(STEPS)
        v = float(rng.randint(1, 1000))
        ts.add(v, now=t)
        adds.append((t, v))
        if step % 37 == 0:
            q = max(t, qmax) + rng.choice([0.0, 0.5, 1.0, 30.0, 120.0])
            qmax = q
            for name, (w, k) in zip(p.ts.INTERVAL_NAMES, p.ts.DEFAULT_LEVELS):
                want_sum, want_count = _brute_window(adds, q, w, k)
                got = (ts.sum(name, now=q), ts.count(name, now=q),
                       ts.rate(name, now=q))
                assert got[:2] == (want_sum, want_count), (step, name)
                assert got[2] == want_sum / (w * k)
                seen.append(got)
    total_sum, total_count = ts.all_time()
    assert total_sum == sum(v for _t, v in adds)
    assert total_count == len(adds)
    return seen, ts.all_time()


def test_multilevel_exactness_random_walk(p):
    _walk(p)


def test_multilevel_walks_match_across_packages():
    """The same seeded walk through both packages: every queried sum,
    count and rate, and the all-time totals, equal exactly."""
    for seed in (7, 0xC1A5):
        j, t = (_walk(_package(root), seed, 800) for root in PACKAGES)
        assert t == j


def test_multilevel_idle_gap_clears_narrow_keeps_wide(p):
    ts = p.ts.MultiLevelTimeSeries()
    for i in range(10):
        ts.add(2.0, now=BASE_S + i)
    q = BASE_S + 9 + 90
    assert ts.sum("1min", now=q) == 0.0
    assert ts.sum("10min", now=q) == 20.0
    assert ts.sum("1h", now=q) == 20.0
    q = BASE_S + 9 + 660
    assert ts.sum("10min", now=q) == 0.0
    assert ts.sum("1h", now=q) == 20.0
    assert ts.all_time() == (20.0, 10)


def test_multilevel_late_add_lands_in_its_bucket(p):
    ts = p.ts.MultiLevelTimeSeries()
    ts.add(1.0, now=BASE_S + 30)
    ts.add(4.0, now=BASE_S + 25)
    assert ts.sum("1min", now=BASE_S + 30) == 5.0
    ts.add(8.0, now=BASE_S - 40)
    assert ts.sum("1min", now=BASE_S + 30) == 5.0
    assert ts.sum("10min", now=BASE_S + 30) == 13.0
    assert ts.all_time() == (13.0, 3)


def test_multilevel_avg_and_interval_names(p):
    ts = p.ts.MultiLevelTimeSeries()
    for v in (2.0, 4.0, 6.0):
        ts.add(v, now=BASE_S)
    assert ts.avg("1min", now=BASE_S) == 4.0
    ladder = ts.ladder(now=BASE_S)
    assert set(ladder) == {"1min", "10min", "1h", "total", "total_count"}
    assert ladder["total"] == 12.0
    with pytest.raises(KeyError):
        ts.sum("5min")


def test_holder_family_api_rejects_undeclared(p):
    stats = p.stats.StatsHolder()
    with pytest.raises(KeyError):
        stats.stat_add("no_such_family", "k")
    with pytest.raises(KeyError):
        stats.stat_rate("no_such_family", "k")
    with pytest.raises(KeyError):
        stats.stat_keys("no_such_family")
    assert stats.stat_rate("delivered_records", "nope") == 0.0
    assert stats.stat_keys("delivered_records") == []


# ---- admin verbs + gateway /stats on a live server -------------------------


@pytest.fixture(scope="module", params=PACKAGES)
def stack(request):
    p = _package(request.param)
    server, ctx = p.main.serve("127.0.0.1", 0, "mem://",
                               load_report_interval_ms=400, **p.cpu)
    addr = f"127.0.0.1:{ctx.port}"
    httpd, gw = p.gateway.serve_gateway(addr, port=0)
    base = f"http://127.0.0.1:{httpd.server_port}"
    channel = grpc.insecure_channel(addr)
    stub = p.rpc.HStreamApiStub(channel)
    yield SimpleNamespace(p=p, addr=addr, base=base, stub=stub, ctx=ctx)
    channel.close()
    httpd.shutdown()
    gw.close()
    server.stop(grace=1)
    ctx.shutdown()


def _admin(p, stub, command, **kwargs):
    resp = stub.SendAdminCommand(p.pb.AdminCommandRequest(
        command=command, args=p.rec.dict_to_struct(kwargs)))
    return json.loads(resp.result)


def _append(p, stub, stream, rows):
    req = p.pb.AppendRequest(stream_name=stream)
    for i in range(rows):
        req.records.append(p.rec.build_record({"k": "a", "v": i}))
    stub.Append(req)


def test_admin_stats_verbs_all_scopes(stack):
    p, stub, ctx, pb = stack.p, stack.stub, stack.ctx, stack.p.pb
    stub.CreateStream(pb.Stream(stream_name="cs1"))
    _append(p, stub, "cs1", 6)
    out = _admin(p, stub, "stats", entity="streams", interval="1min")
    row = out["cs1"]
    assert row["interval"] == "1min"
    assert row["append_in_records_total"] == 6.0
    assert row["append_in_records_per_s"] == round(6.0 / 60.0, 3)
    assert row["append_in_bytes_total"] == \
        ctx.stats.stream_stat_get("append_payload_bytes", "cs1")
    stub.CreateSubscription(pb.Subscription(
        subscription_id="cssub", stream_name="cs1"))
    got = stub.Fetch(pb.FetchRequest(subscription_id="cssub",
                                     timeout_ms=500, max_size=64))
    n = len(got.received_records)
    assert n == 6
    stub.Acknowledge(pb.AcknowledgeRequest(
        subscription_id="cssub",
        ack_ids=[r.record_id for r in got.received_records]))
    out = _admin(p, stub, "stats", entity="subscriptions")
    assert out["cssub"]["delivered_records_total"] == float(n)
    assert out["cssub"]["acks_received_total"] == float(n)
    assert _admin(p, stub, "stats", entity="queries") == {}
    assert _admin(p, stub, "stats", entity="streams",
                  interval="10min")["cs1"]["interval"] == "10min"
    with pytest.raises(grpc.RpcError):
        _admin(p, stub, "stats", entity="nonsense")
    with pytest.raises(grpc.RpcError):
        _admin(p, stub, "stats", interval="5min")
    stub.DeleteSubscription(pb.DeleteSubscriptionRequest(
        subscription_id="cssub"))


def test_admin_cli_stats_table(stack):
    rows = stack.p.admin.cmd_stats(
        stub=stack.stub,
        args=Namespace(entity="streams", interval="1min", json=False))
    assert any(r.get("stream") == "cs1" for r in rows)
    row = next(r for r in rows if r.get("stream") == "cs1")
    assert "append_in_records_per_s" in row


def test_gateway_stats_endpoint(stack):
    base = stack.base
    with urllib.request.urlopen(f"{base}/stats?entity=streams"
                                f"&interval=1min") as r:
        assert r.status == 200
        out = json.loads(r.read())
    assert "cs1" in out
    assert out["cs1"]["interval"] == "1min"
    with urllib.request.urlopen(f"{base}/cluster-stats") as r:
        nodes = json.loads(r.read())
    (rep,) = nodes.values()
    assert rep["streams"]["cs1"]["append_in_records"]["total"] == 6.0
    assert rep["rss_bytes"] > 0


def test_metrics_carries_stream_rate_ladder(stack):
    text = stack.p.prometheus.render_metrics(stack.ctx)
    for interval in stack.p.ts.INTERVAL_NAMES:
        assert (f'hstream_stream_rate{{stream="cs1",'
                f'metric="append_in_records",interval="{interval}"}}'
                in text)
    assert "hstream_node_rss_bytes" in text
    assert "hstream_append_inflight" in text


def test_node_load_report_journal_event(stack):
    ctx = stack.ctx
    deadline = time.time() + 10
    events = []
    while time.time() < deadline:
        events = ctx.events.query(kind="node_load_report", limit=10)
        if events:
            break
        time.sleep(0.1)
    assert events, "no node_load_report journaled"
    ev = events[-1]
    for field in ("node", "rss_bytes", "running_queries",
                  "append_inflight", "health", "streams"):
        assert field in ev, ev
    assert ev["rss_bytes"] > 0
    out = _admin(stack.p, stack.stub, "events", kind="node_load_report",
                 limit=5)
    assert out["events"]


def test_stale_family_series_dropped_at_scrape(stack):
    """A deleted entity's rate ladder stops rendering and frees its cap
    slot at the scrape-time sweep."""
    p, stub, ctx, pb = stack.p, stack.stub, stack.ctx, stack.p.pb
    render = p.prometheus.render_metrics
    stub.CreateStream(pb.Stream(stream_name="tmp-s"))
    stub.CreateSubscription(pb.Subscription(
        subscription_id="tmpsub", stream_name="tmp-s"))
    _append(p, stub, "tmp-s", 3)
    got = stub.Fetch(pb.FetchRequest(subscription_id="tmpsub",
                                     timeout_ms=500, max_size=16))
    assert len(got.received_records) == 3
    assert "tmpsub" in ctx.stats.stat_keys("delivered_records")
    assert "tmp-s" in ctx.stats.stat_keys("append_in_records")
    stub.DeleteSubscription(pb.DeleteSubscriptionRequest(
        subscription_id="tmpsub"))
    stub.DeleteStream(pb.DeleteStreamRequest(stream_name="tmp-s"))
    assert "tmpsub" not in _admin(p, stub, "stats", entity="subscriptions")
    assert "tmp-s" not in _admin(p, stub, "stats", entity="streams")
    render(ctx)
    assert "tmpsub" not in ctx.stats.stat_keys("delivered_records")
    assert "tmpsub" not in ctx.stats.stat_keys("delivered_bytes")
    assert "tmp-s" not in ctx.stats.stat_keys("append_in_records")
    ctx.stats.stat_add("append_in_bytes", "_overflow", 1.0)
    render(ctx)
    assert "_overflow" in ctx.stats.stat_keys("append_in_bytes")


def test_node_load_report_carries_bound_identity(stack):
    events = stack.ctx.events.query(kind="node_load_report", limit=1000)
    assert events
    for ev in events:
        assert ev["addr"] == stack.addr, ev["addr"]
        assert not ev["addr"].endswith(":0")


# ---- seeded 3-node federation ----------------------------------------------


def _federation(p, seed: int = 42) -> list[dict]:
    """Three in-process servers with seeded per-node append counts;
    `admin cluster-stats` against node 0 with the other two as peers
    returns one report per node whose per-stream 1min/10min rates equal
    the direct recounts exactly, a same-named stream on two nodes
    staying per node. Returns each node's {stream: append_in_records
    ladder without its time-dependent keys}, by node index."""
    rng = random.Random(seed)
    nodes = []
    try:
        for _ in range(3):
            server, ctx = p.main.serve("127.0.0.1", 0, "mem://",
                                       load_report_interval_ms=60_000,
                                       **p.cpu)
            addr = f"127.0.0.1:{ctx.port}"
            ch = grpc.insecure_channel(addr)
            nodes.append((server, ctx, addr, ch, p.rpc.HStreamApiStub(ch)))
        counts = []
        for i, (_s, _c, _a, _ch, stub) in enumerate(nodes):
            k = rng.randint(3, 9)
            stub.CreateStream(p.pb.Stream(stream_name=f"fed-s{i}"))
            _append(p, stub, f"fed-s{i}", k)
            shared = 0
            if i < 2:
                shared = rng.randint(2, 7) + i * 10
                stub.CreateStream(p.pb.Stream(stream_name="fed-shared"))
                _append(p, stub, "fed-shared", shared)
            counts.append((k, shared))
        stub0 = nodes[0][4]
        peers = ",".join(a for _s, _c, a, _ch, _stub in nodes[1:])
        merged = _admin(p, stub0, "cluster-stats", peers=peers)
        assert len(merged) == 3, list(merged)
        by_addr = {rep["addr"]: rep for rep in merged.values()}
        ladders = []
        for i, (_s, ctx, addr, _ch, _stub) in enumerate(nodes):
            rep = by_addr[addr]
            assert "error" not in rep
            k, shared = counts[i]
            lad = rep["streams"][f"fed-s{i}"]["append_in_records"]
            assert lad["total"] == float(k)
            assert lad["1min"] == k / 60.0
            assert lad["10min"] == k / 600.0
            if shared:
                sl = rep["streams"]["fed-shared"]["append_in_records"]
                assert sl["total"] == float(shared)
                assert sl["1min"] == shared / 60.0
            assert rep["streams"][f"fed-s{i}"]["append_in_bytes"][
                "total"] == ctx.stats.stream_stat_get(
                    "append_payload_bytes", f"fed-s{i}")
            ladders.append({s: {key: v[key] for key in
                                ("1min", "10min", "1h", "total",
                                 "total_count")}
                            for s, fams in rep["streams"].items()
                            for fam, v in fams.items()
                            if fam == "append_in_records"})
        s0 = by_addr[nodes[0][2]]["streams"]["fed-shared"][
            "append_in_records"]["total"]
        s1 = by_addr[nodes[1][2]]["streams"]["fed-shared"][
            "append_in_records"]["total"]
        assert s0 == float(counts[0][1]) and s1 == float(counts[1][1])
        assert s0 != s1
        rows = p.cluster.merge_rows(list(merged.values()), interval="1min")
        node_rows = [r for r in rows if r["stream"] == "(node)"]
        assert len(node_rows) == 3
        stream_rows = [(r["node"], r["stream"]) for r in rows
                       if r["stream"] != "(node)"]
        assert len(stream_rows) == len(set(stream_rows)) == 5
        dead = _admin(p, stub0, "cluster-stats", peers="127.0.0.1:1",
                      timeout_s=1.0)
        assert any(r.get("role") == "unreachable" for r in dead.values())
        return ladders
    finally:
        for server, ctx, _a, ch, _stub in nodes:
            ch.close()
            server.stop(grace=1)
            ctx.shutdown()


def test_three_node_federation_merge_exact(p):
    _federation(p)


def test_federations_match_across_packages():
    """The same seeded federation in both packages: every node's
    per-stream ladders (rates and totals) equal exactly."""
    seed = int(np.random.default_rng(5).integers(0, 1 << 30))
    j, t = (_federation(_package(root), seed) for root in PACKAGES)
    assert t == j and len(j) == 3


def test_cluster_stats_merge_disambiguates_node_name_collisions(p):
    """Two bare followers with the default node id both stay visible in
    the merged table."""
    server, ctx = p.main.serve("127.0.0.1", 0, "mem://", **p.cpu)
    ch = grpc.insecure_channel(f"127.0.0.1:{ctx.port}")
    stub = p.rpc.HStreamApiStub(ch)
    stores, followers = [], []
    try:
        peers = []
        for _ in range(2):
            st = p.store.open_store("mem://")
            port = _free_port()
            fs, svc = p.replica.serve_follower(st, f"127.0.0.1:{port}",
                                               node_id="follower")
            stores.append(st)
            followers.append((fs, svc))
            peers.append(f"127.0.0.1:{port}")
        merged = _admin(p, stub, "cluster-stats", peers=",".join(peers))
        assert len(merged) == 3, list(merged)
        roles = sorted(r["role"] for r in merged.values())
        assert roles == ["follower", "follower", "single"]
    finally:
        ch.close()
        for fs, svc in followers:
            fs.stop(grace=1)
            svc.close()
        for st in stores:
            st.close()
        server.stop(grace=1)
        ctx.shutdown()


def test_query_overflow_fold_survives_liveness_filter(p):
    stats = p.stats.StatsHolder()
    stats.stat_add("emit_rows", "_overflow", 3.0)
    stats.stat_add("append_in_bytes", "_overflow", 7.0)
    text = p.prometheus.render_holder(stats, live_streams=set(),
                                      live_queries=set())
    assert 'hstream_emit_rows_rate{query="_overflow"}' in text
    assert 'hstream_append_in_bytes_rate{stream="_overflow"}' in text


def test_bare_follower_answers_cluster_stats(p):
    local = p.store.open_store("mem://")
    port = _free_port()
    server, svc = p.replica.serve_follower(local, f"127.0.0.1:{port}",
                                           node_id="fed-follower")
    try:
        rep = p.cluster._fetch_peer(f"127.0.0.1:{port}", timeout=5.0)
        assert rep["node"] == "fed-follower"
        assert rep["role"] == "follower"
        assert rep["rss_bytes"] > 0
        assert rep["streams"] == {}
    finally:
        server.stop(grace=1)
        svc.close()
        local.close()
