"""Cluster stats federation: per-node load reports, merged on demand.

Reference: ``hadmin server stats`` asks every node for its stats holder
and prints one merged table; the Overview endpoint does the same over
HTTP (SURVEY layer 2, §2.1). Our reproduction had per-NODE stats only —
nothing answered "which host is hot" for the thousand-query placer
(ROADMAP item 2), whose placement decisions gate on exactly the numbers
folded here.

Three pieces:

  * ``node_report(ctx)`` folds THIS node's StatsHolder into one
    JSON-able dict: per-stream rate ladders (every stream-scoped
    family x 1min/10min/1h + all-time), per-query health level +
    watermark lag + emit p99, node-wide kernel-dispatch p99,
    append-front queue depth, arena/pipeline occupancy, and rss.
  * ``collect_cluster(ctx, peers)`` fans out the protopatch-evolved
    ``ClusterStats`` RPC to explicit ``--peers`` (full HStreamApi
    servers), falling back per-address to the ``StoreReplica`` face so
    bare follower processes answer too; with no peers given it asks
    the replicated store's followers. Unreachable nodes come back as
    an ``error`` row — a dead peer must be VISIBLE in the merged
    table, not silently absent.
  * ``LoadReporter`` journals a periodic ``node_load_report`` event —
    THE machine-readable load signal placement/failover adoption gate
    on: bounded (top-K streams by 1min byte rate), cheap (one holder
    fold per period), and queryable via ``admin events --kind
    node_load_report`` / ``GET /events``.
"""

# A copy of hstream_tpu/stats/cluster.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import json
import os
import threading
import time

from hstream_tpu_torch.stats.families import families_for_scope
from hstream_tpu_torch.stats.timeseries import INTERVAL_NAMES

# streams carried by the periodic journal event, by 1min byte rate —
# the event rides a bounded ring; an unbounded stream list would turn
# a wide topology into journal churn (the FULL ladder stays available
# via the ClusterStats RPC / admin cluster-stats on demand)
LOAD_REPORT_TOP_STREAMS = 8

DEFAULT_LOAD_REPORT_INTERVAL_S = 30.0

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def rss_bytes() -> int:
    """Current resident set size of this process. /proc when the
    platform has it (linux), peak-rss via resource otherwise — a load
    signal, not an accounting number."""
    try:
        with open("/proc/self/statm", encoding="ascii") as f:
            return int(f.read().split()[1]) * _PAGE
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource
        import sys

        # ru_maxrss unit differs by platform: bytes on macOS (where
        # this fallback actually runs — no /proc), kilobytes elsewhere
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return rss if sys.platform == "darwin" else rss * 1024
    except Exception:  # noqa: BLE001 — a load report must not fail
        return 0


def live_entity_keys(ctx, scope: str) -> set[str]:
    """THE definition of "live" for one stat-family scope — shared by
    the admin `stats` verb, the scrape-time ``stat_drop_stale`` sweep,
    and the exposition's liveness filters, so they cannot drift apart.
    Raises whatever the underlying registry raises; callers choose
    fail-open vs skip."""
    if scope == "stream":
        keys = set(ctx.streams.find_streams())
        # materialized views are live READ endpoints: pull queries feed
        # stream-scoped families (read_out_records, read_extracts) keyed
        # by view name, which must survive the liveness sweep until the
        # view itself is dropped (the read plane)
        try:
            keys.update(ctx.views.names())
        except Exception:  # noqa: BLE001 — bare test contexts
            pass
        return keys
    if scope == "subscription":
        return {rt.sub_id for rt in ctx.subscriptions.list()}
    if scope == "query":
        return {q.query_id for q in ctx.persistence.get_queries()}
    raise KeyError(f"unknown stat scope {scope!r}")


def _stream_ladders(stats, now: float | None = None) -> dict:
    """stream -> family -> {1min,10min,1h,total,total_count}."""
    out: dict[str, dict] = {}
    for fam in families_for_scope("stream"):
        for key in stats.stat_keys(fam.name):
            out.setdefault(key, {})[fam.name] = \
                stats.stat_ladder(fam.name, key, now)
    return out


def _query_health(ctx) -> dict:
    """qid -> {health_level, verdict, watermark_lag_ms, emit_p99_ms}.
    Health comes from the health plane; a half-built context (tests
    construct bare ones) reports no queries rather than failing."""
    out: dict[str, dict] = {}
    try:
        from hstream_tpu_torch.server import health as _health

        for qid, h in _health.evaluate_all(ctx).items():
            out[qid] = {
                "verdict": h.get("verdict"),
                "health_level": h.get("level",
                                      {"OK": 0, "DEGRADED": 1,
                                       "STALLED": 2}.get(
                                          h.get("verdict"), 0)),
                "watermark_lag_ms": h.get("watermark_lag_ms"),
                "emit_p99_ms": ctx.stats.histogram_percentile(
                    "emit_latency_ms", qid, 99),
            }
    except Exception:  # noqa: BLE001 — the report must not fail
        pass
    return out


def node_report(ctx) -> dict:
    """Fold this node's holder + live subsystems into one load report
    (host-mirror reads only: zero dispatches, zero fetches)."""
    from hstream_tpu_torch.server import scheduler

    stats = ctx.stats
    store = ctx.store
    role = "leader" if hasattr(store, "follower_status") else "single"
    front = getattr(ctx, "append_front", None)
    front_stats = {}
    if front is not None:
        try:
            front_stats = front.stats()
        except Exception:  # noqa: BLE001
            front_stats = {}
    # arena occupancy: staged-but-unstepped batches across running
    # query pipelines (the host mirror of device arena pressure)
    arena_pending = 0
    # device HBM footprint: live arena/store bytes across every running
    # query's executor planes — nbytes metadata reads only
    device_hbm = 0
    for task in list(getattr(ctx, "running_queries", {}).values()):
        pipe = getattr(task, "_pipe", None)
        if pipe is not None:
            try:
                arena_pending += int(pipe.pending)
            except Exception:  # noqa: BLE001
                pass
        fn = getattr(task, "device_plane_bytes", None)
        if fn is not None:
            try:
                device_hbm += sum(fn().values())
            except Exception:  # noqa: BLE001
                pass
    return {
        "node": scheduler.node_name(ctx),
        "addr": f"{ctx.host}:{ctx.port}",
        "role": role,
        "ts_ms": int(time.time() * 1000),
        "rss_bytes": rss_bytes(),
        "device_hbm_bytes": device_hbm,
        "running_queries": len(getattr(ctx, "running_queries", {})),
        "append_inflight": int(front_stats.get("in_flight", 0)),
        "append_front": front_stats,
        "arena_pending_batches": arena_pending,
        "dispatch_p99_ms": stats.histogram_percentile(
            "kernel_dispatch_ms", "", 99),
        "streams": _stream_ladders(stats),
        "queries": _query_health(ctx),
    }


def load_report_fields(ctx) -> dict:
    """The bounded journal shape of ``node_report`` (top-K streams,
    health counts instead of the per-query map)."""
    full = node_report(ctx)
    streams = full["streams"]
    ranked = sorted(
        streams,
        key=lambda s: streams[s].get("append_in_bytes",
                                     {}).get("1min", 0.0),
        reverse=True)
    top = {s: {fam: {"1min": lad.get("1min", 0.0),
                     "10min": lad.get("10min", 0.0)}
               for fam, lad in streams[s].items()}
           for s in ranked[:LOAD_REPORT_TOP_STREAMS]}
    levels = [q.get("health_level", 0)
              for q in full["queries"].values()]
    return {
        "node": full["node"],
        "addr": full["addr"],
        "role": full["role"],
        "rss_bytes": full["rss_bytes"],
        "device_hbm_bytes": full.get("device_hbm_bytes", 0),
        "running_queries": full["running_queries"],
        "append_inflight": full["append_inflight"],
        "arena_pending_batches": full["arena_pending_batches"],
        "dispatch_p99_ms": full["dispatch_p99_ms"],
        "streams": top,
        "streams_total": len(streams),
        "health": {"ok": sum(1 for v in levels if v == 0),
                   "degraded": sum(1 for v in levels if v == 1),
                   "stalled": sum(1 for v in levels if v == 2)},
    }


# ---- placer node records ----------------------------------------

# Per-node load records in the CAS-versioned config store, keyed
# ``cluster/nodes/<node>``. The journal's node_load_report events are
# per-PROCESS rings — a peer's placer can't read them — so placement
# runs off these shared records instead: every armed placer publishes
# its own node's fold each tick, and every placer ranks ALL fresh
# records when it decides. Same bounded shape as the journal event,
# plus the placement-eligibility axes (epoch, heartbeat, shed level,
# fenced flag).
NODE_RECORD_PREFIX = "cluster/nodes/"


def node_record_fields(ctx) -> dict:
    """The placement view of this node: load_report_fields minus the
    per-stream ladders (scores don't rank on them), plus eligibility
    signals."""
    fields = load_report_fields(ctx)
    fields.pop("streams", None)
    fields["ts_ms"] = int(time.time() * 1000)
    fields["hb_ms"] = fields["ts_ms"]
    fields["epoch"] = getattr(ctx, "boot_epoch", 0)
    flow = getattr(ctx, "flow", None)
    fields["shed_level"] = 0 if flow is None \
        else int(flow.overload.effective_level())
    fields["fenced"] = bool(
        getattr(ctx.store, "fenced_by", None) is not None)
    return fields


def publish_node_record(ctx) -> dict | None:
    """Write this node's record to ``cluster/nodes/<node>``; the write
    doubles as the node's cluster-level heartbeat. Read-modify-write
    CAS (single writer per node, but a racing admin/test write must
    not wedge the publisher). Returns the published fields, or None
    when every retry lost."""
    from hstream_tpu_torch.store.versioned import VersionMismatch

    fields = node_record_fields(ctx)
    key = NODE_RECORD_PREFIX + fields["node"]
    value = json.dumps(fields).encode()
    for _ in range(4):
        cur = ctx.config.get(key)
        try:
            ctx.config.put(key, value,
                           base_version=None if cur is None else cur[0])
            return fields
        except VersionMismatch:
            continue
    return None


def cluster_node_records(ctx) -> dict[str, dict]:
    """node name -> last published record, every node that ever
    published on this store (callers filter by heartbeat age)."""
    out: dict[str, dict] = {}
    for key in ctx.config.keys():
        if not key.startswith(NODE_RECORD_PREFIX):
            continue
        cur = ctx.config.get(key)
        if cur is None:
            continue
        try:
            rec = json.loads(cur[1])
        except ValueError:
            continue
        out[key[len(NODE_RECORD_PREFIX):]] = rec
    return out


# ---- RPC glue --------------------------------------------------------------


def report_to_pb(report: dict):
    """One node's dict -> NodeStatsReport (scalars structured, the
    deep ladders as a JSON detail blob — the admin merge re-parses)."""
    from hstream_tpu_torch.proto import api_pb2 as pb

    return pb.NodeStatsReport(
        node=str(report.get("node", "")),
        role=str(report.get("role", "")),
        ts_ms=int(report.get("ts_ms", 0)),
        rss_bytes=int(report.get("rss_bytes", 0)),
        running_queries=int(report.get("running_queries", 0)),
        append_inflight=int(report.get("append_inflight", 0)),
        report=json.dumps(report))


def report_from_pb(msg) -> dict:
    try:
        out = json.loads(msg.report) if msg.report else {}
    except ValueError:
        out = {}
    out.setdefault("node", msg.node)
    out.setdefault("role", msg.role)
    out.setdefault("rss_bytes", msg.rss_bytes)
    out.setdefault("running_queries", msg.running_queries)
    out.setdefault("append_inflight", msg.append_inflight)
    return out


def _fetch_peer(addr: str, timeout: float) -> dict:
    """One peer's report over ClusterStats: the full HStreamApi face
    first, the bare StoreReplica face (follower processes) second."""
    import grpc

    from hstream_tpu_torch.proto import api_pb2 as pb
    from hstream_tpu_torch.proto.rpc import HStreamApiStub, StoreReplicaStub

    last_err: Exception | None = None
    for stub_cls in (HStreamApiStub, StoreReplicaStub):
        try:
            with grpc.insecure_channel(addr) as ch:
                resp = stub_cls(ch).ClusterStats(
                    pb.ClusterStatsRequest(), timeout=timeout)
            reports = list(resp.reports)
            if reports:
                out = report_from_pb(reports[0])
                out.setdefault("addr", addr)
                return out
            last_err = RuntimeError("empty ClusterStats response")
        except grpc.RpcError as e:  # try the other service face
            last_err = e
    detail = getattr(last_err, "details", lambda: None)() \
        or str(last_err)
    return {"node": addr, "addr": addr, "role": "unreachable",
            "error": detail}


def collect_cluster(ctx, peers: list[str] | None = None,
                    timeout: float = 5.0) -> list[dict]:
    """This node's report + one report per peer. Explicit peers win;
    otherwise a replication leader asks its followers. Peers answer
    concurrently (one thread per address, bounded by the peer list) so
    one dead node costs ONE timeout, not len(peers) of them."""
    reports = [node_report(ctx)]
    if not peers:
        status = getattr(ctx.store, "follower_status", None)
        if status is not None:
            try:
                peers = [f["addr"] for f in status()]
            except Exception:  # noqa: BLE001
                peers = []
    if not peers:
        return reports
    out: list[dict | None] = [None] * len(peers)

    def fetch(i: int, addr: str) -> None:
        out[i] = _fetch_peer(addr, timeout)

    threads = [threading.Thread(target=fetch, args=(i, a), daemon=True)
               for i, a in enumerate(peers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout + 1.0)
    for i, addr in enumerate(peers):
        reports.append(out[i] or {"node": addr, "addr": addr,
                                  "role": "unreachable",
                                  "error": "fan-out timed out"})
    return reports


def merge_rows(reports: list[dict],
               interval: str = "1min") -> list[dict]:
    """The admin `cluster-stats` table: one node summary row per node,
    then one row per (node, stream) with the family rates at every
    interval — rates are per-node by construction (each node folds its
    OWN holder), so the merge is a concatenation keyed (node, stream),
    never a lossy re-aggregation."""
    if interval not in INTERVAL_NAMES:
        raise KeyError(f"unknown interval {interval!r} "
                       f"(one of {INTERVAL_NAMES})")
    rows: list[dict] = []
    for rep in reports:
        row = {"node": rep.get("node"), "stream": "(node)",
               "role": rep.get("role"),
               "rss_mb": round(rep.get("rss_bytes", 0) / 1e6, 1),
               "queries": rep.get("running_queries", 0),
               "append_inflight": rep.get("append_inflight", 0)}
        if rep.get("error"):
            row["error"] = rep["error"]
        rows.append(row)
    for rep in reports:
        for stream in sorted(rep.get("streams", {})):
            ladders = rep["streams"][stream]
            row = {"node": rep.get("node"), "stream": stream,
                   "role": rep.get("role")}
            for fam in families_for_scope("stream"):
                lad = ladders.get(fam.name)
                if lad is None:
                    continue
                row[f"{fam.name}_{interval}"] = \
                    round(lad.get(interval, 0.0), 3)
                row[f"{fam.name}_total"] = lad.get("total", 0.0)
            rows.append(row)
    return rows


class LoadReporter:
    """Periodic ``node_load_report`` journal events off a daemon
    thread: one bounded holder fold per interval, first report at
    start so a fresh boot is immediately visible to the placer."""

    def __init__(self, ctx, interval_s: float =
                 DEFAULT_LOAD_REPORT_INTERVAL_S):
        self.ctx = ctx
        self.interval_s = max(float(interval_s), 0.5)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="load-reporter", daemon=True)

    def start(self) -> None:
        """Called AFTER the server's port is bound (server/main.serve):
        the boot report carries the node's real identity — on an
        ephemeral port, a reporter started at context construction
        would journal a phantom `host:0` node the placer can't match
        to any later report."""
        self._thread.start()

    def emit(self) -> int:
        """Journal one report now; returns its seq (0 on failure —
        load reporting must never take the server down)."""
        try:
            fields = load_report_fields(self.ctx)
            return self.ctx.events.append(
                "node_load_report",
                f"node {fields['node']}: "
                f"{fields['running_queries']} queries, "
                f"rss {fields['rss_bytes'] // 1_000_000}MB, "
                f"{fields['streams_total']} active streams",
                **fields)
        except Exception:  # noqa: BLE001
            return 0

    def _run(self) -> None:
        self.emit()  # boot-time baseline
        while not self._stop.wait(self.interval_s):
            self.emit()

    def stop(self) -> None:
        self._stop.set()
        if self._thread.ident is not None:  # never started: no join
            self._thread.join(timeout=2.0)
