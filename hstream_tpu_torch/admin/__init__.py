"""Operator admin CLI (the reference's hstore-admin analogue).

Reference: a Thrift admin CLI with status/nodes-config/logs/
check-impact/maintenance/sql subcommands
(hstream-store/admin/app/cli.hs:56-69). Here the ops surface rides the
gRPC API: cluster status tables, per-entity listings, live stats, and
lifecycle verbs (restart/terminate/delete), printed as aligned tables.

    python -m hstream_tpu_torch.admin [--host H --port P] <command> [args]
"""

# A copy of hstream_tpu/admin/__init__.py; the port imports
# nothing of the JAX package.

from __future__ import annotations

import argparse
import sys

import grpc

from hstream_tpu_torch.client import format_table
from hstream_tpu_torch.proto import api_pb2 as pb
from hstream_tpu_torch.proto.rpc import HStreamApiStub


def _stub(args) -> HStreamApiStub:
    ch = grpc.insecure_channel(f"{args.host}:{args.port}")
    return HStreamApiStub(ch)


def cmd_status(stub, args) -> list[dict]:
    nodes = stub.ListNodes(pb.ListNodesRequest()).nodes
    return [{"id": n.id, "address": n.address, "port": n.port,
             "roles": ",".join(n.roles), "status": n.status}
            for n in nodes]


def cmd_streams(stub, args) -> list[dict]:
    out = stub.ListStreams(pb.ListStreamsRequest()).streams
    return [{"stream": s.stream_name,
             "replication": s.replication_factor} for s in out]


def cmd_queries(stub, args) -> list[dict]:
    out = stub.ListQueries(pb.ListQueriesRequest()).queries
    return [{"id": q.id, "status": q.status,
             "created_ms": q.created_time_ms,
             "sql": q.query_text[:60]} for q in out]


def cmd_views(stub, args) -> list[dict]:
    out = stub.ListViews(pb.ListViewsRequest()).views
    return [{"view": v.view_id, "status": v.status,
             "sql": v.sql[:60]} for v in out]


def cmd_connectors(stub, args) -> list[dict]:
    out = stub.ListConnectors(pb.ListConnectorsRequest()).connectors
    return [{"id": c.id, "status": c.status,
             "config": c.config[:60]} for c in out]


def cmd_subscriptions(stub, args) -> list[dict]:
    out = stub.ListSubscriptions(pb.ListSubscriptionsRequest())
    return [{"id": s.subscription_id, "stream": s.stream_name}
            for s in out.subscription]


def cmd_stats(stub, args) -> list[dict]:
    """Declarative-family rate tables (the `hadmin server stats`
    analogue): one row per entity with every family's rate at the
    requested ladder interval (1min/10min/1h) + all-time totals;
    --json prints the raw verb output for scripting."""
    out = _admin(stub, "stats", entity=args.entity,
                 interval=args.interval)
    if getattr(args, "json", False):
        import json

        print(json.dumps({r.pop("key"): r for r in out}, indent=2,
                         sort_keys=True))
        return []
    label = {"streams": "stream", "subscriptions": "subscription",
             "queries": "query"}.get(args.entity, "key")
    return [{label: r.pop("key"), **r} for r in out]


def cmd_cluster_stats(stub, args) -> list[dict]:
    """Federated node load reports: fan the ClusterStats
    RPC out to --peers (or the leader's followers) and print ONE
    merged per-node table — a node summary row per node, then one row
    per (node, stream) with the family rate ladder."""
    from hstream_tpu_torch.stats.cluster import merge_rows

    kwargs = {"interval": args.interval, "timeout_s": args.timeout}
    if args.peers:
        kwargs["peers"] = args.peers
    out = _admin(stub, "cluster-stats", **kwargs)
    reports = {r.pop("key"): r for r in out}
    if getattr(args, "json", False):
        import json

        print(json.dumps(reports, indent=2, sort_keys=True))
        return []
    return merge_rows([reports[k] for k in sorted(reports)],
                      interval=args.interval)


def cmd_trace(stub, args) -> list[dict]:
    from hstream_tpu_torch.common import records as rec

    if getattr(args, "spans", False):
        # Chrome trace-event JSON of the query's span ring:
        # printed raw so it pipes straight into a .json file for
        # chrome://tracing / Perfetto
        import json

        out = _admin(stub, "trace-spans", scope=args.id)
        print(json.dumps(out[0] if out else {}))
        return []
    summary = rec.struct_to_dict(
        stub.GetQueryTrace(pb.GetQueryRequest(id=args.id)))
    return [{"stage": stage, **vals}
            for stage, vals in sorted(summary.items())]


def cmd_health(stub, args) -> list[dict]:
    """Per-query health rollup: OK/DEGRADED/STALLED with
    reasons, one row per query (or one query with --id)."""
    if args.id:
        rows = _admin(stub, "health", query=args.id)
    else:
        # the verb returns qid -> health dict; _admin renders that as
        # one {"key": qid, **health} row per query, already sorted
        rows = _admin(stub, "health")
    return [{"query": h.get("query"), "verdict": h.get("verdict"),
             "reasons": ",".join(h.get("reasons") or []) or "-",
             "status": h.get("status"),
             "wm_lag_ms": h.get("watermark_lag_ms"),
             "backlog": h.get("backlog"),
             "fallbacks": h.get("device_fallbacks"),
             "late_drops": h.get("late_drops")}
            for h in rows]


def cmd_programs(stub, args) -> list[dict]:
    """Compiled-program inventory: one row per compile of the server
    process (the kernel library's build, a program-factory miss);
    --json dumps the raw summary + rows."""
    out = _admin(stub, "programs")
    data = out[0] if out else {}
    if getattr(args, "json", False):
        import json

        print(json.dumps(data, indent=2, sort_keys=True))
        return []
    return [{"shape_key": r.get("shape_key"),
             "family": r.get("family") or "-",
             "name": (r.get("name") or "")[:40],
             "compiles": r.get("compiles"),
             "compile_ms": round(r.get("compile_ms") or 0.0, 1),
             "gflops": (round(r["flops"] / 1e9, 3)
                        if r.get("flops") else "-"),
             "mbytes_acc": (round(r["bytes_accessed"] / 1e6, 3)
                            if r.get("bytes_accessed") else "-")}
            for r in data.get("programs", [])]


def cmd_flightrec(stub, args) -> list[dict]:
    """Flight-recorder bundles: with a query id, print the
    raw postmortem bundles as JSON (pipe to a file); without, the
    recorder index."""
    import json

    if args.id:
        out = _admin(stub, "flightrec", query=args.id)
        print(json.dumps(out[0] if out else {}, indent=2,
                         sort_keys=True))
        return []
    out = _admin(stub, "flightrec")
    data = out[0] if out else {}
    return [{"query": q, "bundles": n}
            for q, n in sorted((data.get("queries") or {}).items())]


def cmd_restart_query(stub, args) -> list[dict]:
    stub.RestartQuery(pb.RestartQueryRequest(id=args.id))
    return [{"restarted": args.id}]


def cmd_terminate_query(stub, args) -> list[dict]:
    req = (pb.TerminateQueriesRequest(all=True) if args.id == "all"
           else pb.TerminateQueriesRequest(query_ids=[args.id]))
    done = stub.TerminateQueries(req)
    return [{"terminated": qid} for qid in done.query_ids]


def cmd_delete_stream(stub, args) -> list[dict]:
    stub.DeleteStream(pb.DeleteStreamRequest(stream_name=args.name))
    return [{"deleted": args.name}]


def _admin(stub, command: str, **kwargs) -> list[dict]:
    """Store-ops verbs over SendAdminCommand (reference hstore-admin
    trim/findTime/offsets, admin/app/cli.hs:56-69)."""
    import json

    from hstream_tpu_torch.common import records as rec

    resp = stub.SendAdminCommand(pb.AdminCommandRequest(
        command=command, args=rec.dict_to_struct(kwargs)))
    out = json.loads(resp.result)
    if isinstance(out, dict) and not out:
        return []
    if isinstance(out, dict) and out and all(
            isinstance(v, dict) for v in out.values()):
        return [{"key": k, **v} for k, v in sorted(out.items())]
    if isinstance(out, dict):
        return [out]
    return list(out)


def cmd_trim(stub, args) -> list[dict]:
    return _admin(stub, "trim", stream=args.stream, lsn=args.lsn)


def cmd_find_time(stub, args) -> list[dict]:
    return _admin(stub, "find-time", stream=args.stream, ts_ms=args.ts_ms)


def cmd_offsets(stub, args) -> list[dict]:
    return _admin(stub, "offsets", stream=args.stream)


def cmd_sub_lag(stub, args) -> list[dict]:
    return _admin(stub, "sub-lag", subscription=args.id)


def cmd_snapshots(stub, args) -> list[dict]:
    return _admin(stub, "snapshots")


def cmd_replicas(stub, args) -> list[dict]:
    out = _admin(stub, "replicas")
    if out and "followers" in out[0]:
        rows = []
        leader = out[0].get("leader")
        if leader:
            # leadership state first: epoch, fencing, ack
            # tuning, dedup footprint — sorted keys so operator diffs
            # and test assertions are stable
            rows.append({"role": "leader-status",
                         **{k: leader[k] for k in sorted(leader)}})
        fols = sorted(out[0]["followers"],
                      key=lambda f: f.get("addr", ""))
        rows.extend({"role": out[0]["role"], **f} for f in fols)
        return rows or [{"role": out[0]["role"]}]
    return out


def cmd_promote(stub, args) -> list[dict]:
    """Epoch-fenced leader failover: planned handoff
    (--target, through the current leader) or leader-death promotion
    (--replicas, most-caught-up reachable replica wins)."""
    kwargs = {}
    if args.leader_addr:
        kwargs["leader_addr"] = args.leader_addr
    if args.target:
        return _admin(stub, "promote", target=args.target, **kwargs)
    if args.replicas:
        return _admin(stub, "promote", replicas=args.replicas, **kwargs)
    raise SystemExit("promote needs --target ADDR (planned handoff) "
                     "or --replicas A,B,... (leader death)")


def cmd_assignments(stub, args) -> list[dict]:
    return _admin(stub, "assignments")


def cmd_placer(stub, args) -> list[dict]:
    """Placement plane: per-node scores with skip reasons,
    current placements, the last decision + machine-readable reason,
    and any co-compile packs."""
    import json

    resp = _admin(stub, "placer")
    st = resp[0] if resp else {}
    if getattr(args, "json", False):
        print(json.dumps(st, indent=2, sort_keys=True))
        return []
    rows = [{"": "placer",
             "value": "armed" if st.get("armed") else "disarmed",
             "detail": (f"node {st.get('node')} lease "
                        f"{st.get('lease_ms')}ms ticks "
                        f"{st.get('ticks')}")}]
    for node, n in sorted((st.get("nodes") or {}).items()):
        rows.append({
            "": f"node {node}",
            "value": (f"SKIP {n['skip']}" if n.get("skip")
                      else f"score {n.get('score')}"),
            "detail": (f"queries {n.get('running_queries')} rss "
                       f"{n.get('rss_mb')}MB p99 "
                       f"{n.get('dispatch_p99_ms')}ms hb_age "
                       f"{n.get('hb_age_ms')}ms")})
    for qid, p in sorted((st.get("placements") or {}).items()):
        age = p.get("hb_age_ms")
        rows.append({
            "": f"query {qid}",
            "value": f"{p.get('state')} @ {p.get('node')}",
            "detail": (f"epoch {p.get('epoch')}"
                       + ("" if age is None else f" hb_age {age}ms"))})
    for pack in st.get("packs") or []:
        members = pack.get("members") or []
        rows.append({
            "": f"pack {pack.get('signature')}",
            "value": f"{len(members)} member(s)",
            "detail": ",".join(members)})
    last = st.get("last_decision")
    if last:
        rows.append({
            "": "last-decision",
            "value": f"{last.get('action')} {last.get('query')}",
            "detail": (f"-> {last.get('target')} "
                       f"reason={last.get('reason')}")})
    return rows


def cmd_quota(stub, args) -> list[dict]:
    """Flow-control quota CRUD over the hierarchical quota tree
    (scopes: cluster | tenant/<ns> | stream/<name>)."""
    if args.action == "list":
        return _admin(stub, "quota-list")
    if args.scope is None:
        raise SystemExit(f"quota {args.action} needs a scope")
    if args.action == "get":
        return _admin(stub, "quota-get", scope=args.scope)
    if args.action == "unset":
        return _admin(stub, "quota-unset", scope=args.scope)
    fields = {}
    for field, flag in (("records_per_s", args.records),
                        ("bytes_per_s", args.bytes),
                        ("read_records_per_s", args.read_records),
                        ("burst_records", args.burst_records),
                        ("burst_bytes", args.burst_bytes)):
        if flag is not None:
            fields[field] = flag
    if not fields:
        raise SystemExit("quota set needs at least one of --records/"
                         "--bytes/--read-records/--burst-records/"
                         "--burst-bytes")
    return _admin(stub, "quota-set", scope=args.scope, **fields)


def cmd_events(stub, args) -> list[dict]:
    """Operator event journal: shed transitions, degraded appends,
    adoption/restart/death, snapshot failures."""
    kwargs = {"limit": args.limit, "since": args.since}
    if args.kind:
        kwargs["kind"] = args.kind
    out = _admin(stub, "events", **kwargs)
    rows = out[0].get("events", []) if out else []
    return [{"seq": e.get("seq"), "ts_ms": e.get("ts_ms"),
             "kind": e.get("kind"), "message": e.get("message")}
            for e in rows]


def cmd_metrics(stub, args) -> list[dict]:
    """Raw Prometheus exposition (what GET /metrics serves)."""
    out = _admin(stub, "metrics")
    print(out[0]["text"], end="")
    return []


def cmd_fault(stub, args) -> list[dict]:
    """Chaos fault sites: arm/clear/list deterministic fault schedules
    (fail:N / prob:P:SEED / delay:MS / torn:N:SEED) on named sites."""
    if args.action == "list":
        out = _admin(stub, "fault-list")[0]
        sites = out.get("sites", {})
        return ([{"site": s, **v} for s, v in sorted(sites.items())]
                or [{"active": out.get("active", False)}])
    if args.site is None:
        if args.action == "clear":
            return _admin(stub, "fault-clear")  # no site: clear ALL
        raise SystemExit(f"fault {args.action} needs a site")
    if args.action == "set":
        if args.spec is None:
            raise SystemExit("fault set needs a spec (e.g. fail:3)")
        return _admin(stub, "fault-set", site=args.site, spec=args.spec)
    return _admin(stub, "fault-clear", site=args.site)


def cmd_locks(stub, args) -> list[dict]:
    """Lock-order witness ledger: named locks with
    acquire/contention counts and wait/hold percentiles, the observed
    order graph, and any detected cycles; --arm/--disarm flip the
    witness at runtime."""
    kwargs = {}
    if args.arm:
        kwargs["action"] = "arm"
    elif args.disarm:
        kwargs["action"] = "disarm"
    out = _admin(stub, "locks", **kwargs)
    st = out[0] if out else {}
    rows = [{"lock": "(witness)",
             "value": "armed" if st.get("armed") else "disarmed",
             "detail": f"cycles={len(st.get('cycles', []))}"}]
    for name, row in sorted((st.get("locks") or {}).items()):
        detail = " ".join(
            f"{k}={row[k]}" for k in ("wait_p50_ms", "wait_p99_ms",
                                      "hold_p50_ms", "hold_p99_ms")
            if row.get(k) is not None)
        rows.append({"lock": name,
                     "value": f"acq={row.get('acquires', 0)} "
                              f"cont={row.get('contentions', 0)}",
                     "detail": detail or "-"})
    for a, bs in sorted((st.get("edges") or {}).items()):
        rows.append({"lock": f"order {a}",
                     "value": "->", "detail": ",".join(bs)})
    for c in st.get("cycles") or []:
        ring = " -> ".join(e[0] for e in c.get("ring", []))
        rows.append({"lock": "CYCLE", "value": ring,
                     "detail": str(c.get("witness", ""))[:60]})
    return rows


def cmd_supervisor(stub, args) -> list[dict]:
    """Query-supervision status: pending restarts + open breakers."""
    resp = _admin(stub, "supervisor")
    out = resp[0] if resp else {}
    rows = [{"": "restarts", "value": out.get("restarts", 0),
             "detail": ""}]
    for qid, p in sorted(out.get("pending", {}).items()):
        rows.append({"": f"pending {qid}",
                     "value": f"attempt {p.get('attempt')}",
                     "detail": f"due in {p.get('due_in_s')}s"})
    for qid in out.get("breaker_open", []):
        rows.append({"": f"breaker {qid}", "value": "OPEN",
                     "detail": "RestartQuery to reset"})
    return rows


def cmd_flow(stub, args) -> list[dict]:
    """Live flow-control status: shed level, overload signals, active
    quotas, per-class shed counters."""
    out = _admin(stub, "flow-status")[0]
    rows = [{"": "level", "value": out.get("level"),
             "detail": f"active={out.get('active')} "
                       f"credit_window={out.get('credit_window')}"}]
    for name, sig in sorted(out.get("signals", {}).items()):
        rows.append({"": f"signal {name}", "value": sig.get("value"),
                     "detail": f"warn={sig.get('warn')} "
                               f"crit={sig.get('critical')} "
                               f"-> {sig.get('level')}"})
    for cls, n in sorted(out.get("shed", {}).items()):
        rows.append({"": f"shed {cls}", "value": n, "detail": ""})
    for scope, q in sorted(out.get("quotas", {}).items()):
        rows.append({"": f"quota {scope}", "value": "",
                     "detail": " ".join(f"{k}={v}"
                                        for k, v in sorted(q.items()))})
    return rows


def cmd_read_cache(stub, args) -> list[dict]:
    """Read-plane snapshot/expansion cache counters: hit ratio, byte
    budget occupancy, extracts, evictions, invalidations."""
    out = _admin(stub, "read-cache")[0]
    if not out.get("enabled"):
        return [{"": "enabled", "value": False,
                 "detail": "started with --read-cache-bytes 0"}]
    rows = []
    for key in sorted(out):
        if key == "enabled":
            continue
        rows.append({"": key, "value": out[key], "detail": ""})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        "hstream-tpu-admin",
        description="operator CLI over the gRPC admin surface")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=6570)
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("status", "streams", "queries", "views", "connectors",
                 "subscriptions"):
        sub.add_parser(name)
    p = sub.add_parser("stats",
                       help="per-entity rate-family tables off the "
                            "multi-level ladders (1min/10min/1h)")
    p.add_argument("entity", nargs="?", default="streams",
                   choices=["streams", "subscriptions", "queries"])
    p.add_argument("--interval", default="1min",
                   choices=["1min", "10min", "1h"],
                   help="trailing ladder window the rates cover")
    p.add_argument("--json", action="store_true",
                   help="raw JSON instead of the table")
    p = sub.add_parser("cluster-stats",
                       help="federated node load reports: one merged "
                            "per-node table (rates, health, rss, "
                            "queue depths) across --peers/followers")
    p.add_argument("--peers", default=None, metavar="ADDR,ADDR",
                   help="peer server addresses to fan out to "
                        "(default: this leader's store followers)")
    p.add_argument("--interval", default="1min",
                   choices=["1min", "10min", "1h"])
    p.add_argument("--timeout", type=float, default=5.0,
                   help="per-peer fan-out timeout (seconds)")
    p.add_argument("--json", action="store_true",
                   help="raw per-node reports instead of the table")
    p = sub.add_parser("trace")
    p.add_argument("id", help="running query id (e.g. view-<name>)")
    p.add_argument("--spans", action="store_true",
                   help="print the query's span ring as Chrome "
                        "trace-event JSON (server needs "
                        "--trace-sample > 0)")
    p = sub.add_parser("health",
                       help="per-query health rollup: OK/DEGRADED/"
                            "STALLED with reasons")
    p.add_argument("id", nargs="?", default=None,
                   help="one query id (default: every query)")
    p = sub.add_parser("programs",
                       help="compiled-program inventory: every compile "
                            "of the server process (the kernel "
                            "library's build, program-factory misses)")
    p.add_argument("--json", action="store_true",
                   help="raw summary + rows as JSON")
    p = sub.add_parser("flightrec",
                       help="flight-recorder postmortem bundles "
                            "captured at STALLED / crash-loop edges")
    p.add_argument("id", nargs="?", default=None,
                   help="query id: print its bundles as JSON "
                        "(default: the recorder index)")
    p = sub.add_parser("restart-query")
    p.add_argument("id")
    p = sub.add_parser("terminate-query")
    p.add_argument("id", help="query id, or 'all'")
    p = sub.add_parser("delete-stream")
    p.add_argument("name")
    p = sub.add_parser("trim", help="drop records with lsn <= LSN")
    p.add_argument("stream")
    p.add_argument("lsn", type=int)
    p = sub.add_parser("find-time",
                       help="first lsn at/after an epoch-ms timestamp")
    p.add_argument("stream")
    p.add_argument("ts_ms", type=int)
    p = sub.add_parser("offsets", help="trim point / tail lsn of a stream")
    p.add_argument("stream")
    p = sub.add_parser("sub-lag", help="consumer lag of a subscription")
    p.add_argument("id")
    sub.add_parser("snapshots", help="per-query state snapshot sizes")
    sub.add_parser("replicas", help="store replication follower status "
                                    "+ leader epoch/fencing state")
    p = sub.add_parser("promote",
                       help="promote a store replica to leader "
                            "(epoch-fenced failover)")
    p.add_argument("--target", default=None, metavar="ADDR",
                   help="planned handoff: the current leader promotes "
                        "this follower and fences itself")
    p.add_argument("--replicas", default=None, metavar="A,B,...",
                   help="leader death: promote the most-caught-up "
                        "reachable replica (highest (epoch, "
                        "applied_seq, node_id) wins)")
    p.add_argument("--leader-addr", default=None, metavar="ADDR",
                   help="client-facing address served as the redirect "
                        "hint (defaults to the promoted replica addr)")
    sub.add_parser("assignments", help="query -> server scheduler records")
    p = sub.add_parser("placer",
                       help="placement plane: per-node load scores + "
                            "skip reasons, query placements with "
                            "heartbeat ages, co-compile packs, last "
                            "decision with machine-readable reason")
    p.add_argument("--json", action="store_true",
                   help="dump the full status (decision ring, raw "
                        "scores map) as JSON")
    p = sub.add_parser("quota",
                       help="flow-control quotas: get/set/list/unset "
                            "on cluster | tenant/<ns> | stream/<name>")
    p.add_argument("action", choices=["get", "set", "list", "unset"])
    p.add_argument("scope", nargs="?", default=None)
    p.add_argument("--records", type=float, default=None,
                   help="append records/s")
    p.add_argument("--bytes", type=float, default=None,
                   help="append bytes/s")
    p.add_argument("--read-records", type=float, default=None,
                   help="read records/s (Fetch)")
    p.add_argument("--burst-records", type=float, default=None)
    p.add_argument("--burst-bytes", type=float, default=None)
    sub.add_parser("flow",
                   help="live flow-control status: shed level, "
                        "overload signals, quotas")
    sub.add_parser("read-cache",
                   help="read-plane snapshot cache counters: hit "
                        "ratio, bytes, extracts, evictions")
    p = sub.add_parser("events",
                       help="operator event journal: shed transitions, "
                            "degraded appends, adoption, snapshot "
                            "failures")
    p.add_argument("--kind", default=None,
                   help="filter to one event kind")
    p.add_argument("--since", type=int, default=0,
                   help="only events with seq > SINCE")
    p.add_argument("--limit", type=int, default=100)
    sub.add_parser("metrics",
                   help="raw Prometheus text exposition "
                        "(same as gateway GET /metrics)")
    p = sub.add_parser("fault",
                       help="chaos fault sites: set/clear/list "
                            "deterministic fault schedules")
    p.add_argument("action", choices=["set", "clear", "list"])
    p.add_argument("site", nargs="?", default=None,
                   help="fault site name (e.g. store.append); "
                        "clear with no site disarms every site")
    p.add_argument("spec", nargs="?", default=None,
                   help="schedule: fail:N | prob:P[:SEED] | "
                        "delay:MS | torn:N[:SEED]")
    sub.add_parser("supervisor",
                   help="query supervision: pending restarts and "
                        "crash-loop breakers")
    p = sub.add_parser("locks",
                       help="lock-order witness: named locks, wait/"
                            "hold p50/p99, contention, order graph, "
                            "cycle reports")
    p.add_argument("--arm", action="store_true",
                   help="arm the witness at runtime")
    p.add_argument("--disarm", action="store_true",
                   help="disarm and forget witness state")
    args = ap.parse_args(argv)

    fn = globals()[f"cmd_{args.cmd.replace('-', '_')}"]
    stub = _stub(args)
    try:
        rows = fn(stub, args)
    except grpc.RpcError as e:
        print(f"error: {e.details()}", file=sys.stderr)
        return 1
    print(format_table(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
