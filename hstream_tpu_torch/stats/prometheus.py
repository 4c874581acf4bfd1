"""Prometheus text exposition over the stats holder + live subsystems.

Renders every registered counter, time-series rate, gauge, and
histogram in the text format scrapers expect (text/plain; version
0.0.4): `_total` counters, `_bucket`/`_sum`/`_count` histogram series
with cumulative `le` buckets ending at `+Inf`, label values escaped
per the spec (backslash, double-quote, newline).

`sample_gauges(ctx)` is the scrape-time bridge from live subsystems —
pipeline occupancy / reorder depth per running query, subscription
backlog and delivery credits in flight, the overload ladder state,
replica ack lag, and the durable store's segment/WAL footprint — into
the holder's gauge registry; `render_metrics(ctx)` samples and renders
in one call (the gateway's /metrics, the server's --metrics-port
exporter, and the admin `metrics` verb all go through it).
"""

# A copy of hstream_tpu/stats/prometheus.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import os
import threading
import time

from hstream_tpu_torch.stats import (
    GAUGES,
    HIST_LABEL_KEYS,
    PER_STREAM_COUNTERS,
    TS_OVERFLOW_LABEL,
)
from hstream_tpu_torch.stats.families import STAT_FAMILIES, families_for_scope
from hstream_tpu_torch.stats.timeseries import INTERVAL_NAMES

PREFIX = "hstream"

# counters whose series label is a QUERY id, not a stream name: they
# live outside the stream namespace, so the live-stream filter must
# not drop them (same rationale as "_"-prefixed pseudo-streams). A
# restart/fallback series for a crash-looped (FAILED, detached) query
# especially must survive the scrape — it is the evidence an operator
# scrapes FOR. kernel_recompiles joins the set with the named
# RetraceGuard attribution (a compile observed under a named guard
# counts against that query/bench scope, not only `_process`).
QUERY_LABEL_COUNTERS = frozenset({"query_restarts", "snapshot_fallbacks",
                                  "late_drops", "kernel_recompiles",
                                  "placement_decisions",
                                  "queries_adopted"})

# counters whose label is a closed vocabulary outside both the stream
# and query namespaces (kernel families): never liveness-filtered
FAMILY_LABEL_COUNTERS = frozenset({"factory_recompiles"})

# counters labeled by a traced-lock ROLE name (locktrace witness):
# lock roles are a small closed set named in code, not streams —
# the liveness filter must not drop them
LOCK_LABEL_COUNTERS = frozenset({"lock_contention"})

_HELP = {
    "append_payload_bytes": "bytes appended (payload only)",
    "append_total": "append batches accepted",
    "append_failed": "append batches failed",
    "append_throttled": "appends refused by quota (flow control)",
    "shed_total": "requests refused by overload shedding",
    "delivery_credit_waits": "push deliveries paused at zero credit",
    "record_payload_bytes": "bytes read out by consumers/queries",
    "record_total": "records read",
    "json_decode_native": "JSON records decoded by the native batch "
                          "decoder (libjsondec)",
    "json_decode_fallback": "JSON records decoded by the per-record "
                            "Python fallback",
    "join_probe_dispatches": "device interval-join probe dispatches "
                             "(one per join micro-batch)",
    "change_rows_columnar": "emitted aggregate rows that reached the "
                            "sink columnar (no per-row dicts)",
    "kernel_recompiles": "compiles of the port observed at runtime: "
                         "the kernel library's build, program-factory "
                         "misses (zero in steady state)",
    "query_restarts": "supervisor-initiated query restarts",
    "snapshot_fallbacks": "restores that skipped a corrupt snapshot "
                          "slot for the previous good one",
    "device_path_fallbacks": "device kernel activations degraded to "
                             "the host reference path",
    "promotions": "replica promotions driven through this server",
    "fenced_appends": "mutations refused NOT_LEADER after the store "
                      "was fenced by a higher epoch",
    "append_deduped": "producer-stamped appends answered from the "
                      "dedup window (retries landed exactly once)",
    "append_columnar_rows": "rows ingested through the framed columnar "
                            "append path",
    "late_drops": "records dropped as late (past the window close "
                  "boundary at the pre-batch watermark)",
    "device_h2d_bytes": "host-to-device bytes on the staging path",
    "device_d2h_bytes": "device-to-host bytes on the close/changelog "
                        "drain paths",
    "factory_recompiles": "compiles of the port attributed to the "
                          "kernel family whose dispatch triggered them",
    "stream_rate": "per-stream family rate ladder: records|bytes per "
                   "second over the named trailing interval "
                   "(1min/10min/1h), sampled at scrape",
    "node_rss_bytes": "resident set size of this server process",
    "append_inflight": "framed appends submitted to the append front "
                       "but not yet completed",
    "pipeline_occupancy": "ingest pipeline busy fraction per query",
    "pipeline_reorder_depth": "staged-but-unstepped batches per query",
    "sub_backlog": "subscription lag in LSNs (tail - committed)",
    "credit_inflight": "delivery credits in flight per subscription",
    "overload_level": "shed ladder: 0 admit / 1 defer / 2 reject",
    "replica_ack_lag": "op-log entries a follower is behind",
    "store_segment_bytes": "durable store segment bytes on disk",
    "store_wal_bytes": "durable store write-ahead-log bytes on disk",
    "running_queries": "live query tasks on this server",
    "event_journal_size": "entries held by the event journal",
    "crash_loop_open": "1 while the crash-loop breaker holds a query "
                       "FAILED",
    "replica_epoch": "leadership epoch of the replicated store this "
                     "server fronts",
    "dedup_window_size": "producer-dedup seqs remembered across all "
                         "producers",
    "query_watermark_ms": "event-time watermark of the query's "
                          "executor (absolute ms)",
    "query_watermark_lag_ms": "wall clock minus the query's event-time "
                              "watermark (answer staleness)",
    "query_health_level": "health-plane verdict: 0 OK / 1 DEGRADED / "
                          "2 STALLED",
    "mesh_shards": "key-axis shard count of the mesh the query's "
                   "executor runs on (absent for single-chip queries)",
    "append_latency_ms": "Append RPC latency",
    "fetch_latency_ms": "Fetch RPC latency",
    "sql_execute_latency_ms": "ExecuteQuery RPC latency",
    "stage_latency_ms": "per-stage query pipeline timings",
    "emit_latency_ms": "close-cycle event time to emitted rows on the "
                       "wire (per query)",
    "append_visible_latency_ms": "record publish time to visibility "
                                 "(view/sink emit, or subscription "
                                 "delivery)",
    "freshness_lag_ms": "end-to-end lag attributed per stage "
                        "(ingest / engine / delivery)",
    "kernel_dispatch_ms": "host dispatch time per kernel family "
                          "(step / close / probe / session)",
    "lock_contention": "traced-lock acquires that found the lock "
                       "taken (lock-order witness armed)",
    "placement_decisions": "placer decisions written onto "
                           "scheduler/query/* (place, live adopt, or "
                           "rebalance offer)",
    "queries_adopted": "queries claimed live through the heartbeat-"
                       "lease CAS (boot adoption not included)",
    "placer_node_score": "placer load score per cluster node folded "
                         "from its published node record (lower = "
                         "preferred)",
    "lock_wait_ms": "time spent waiting to acquire each named traced "
                    "lock (lock-order witness armed)",
    "lock_hold_ms": "time each named traced lock was held per "
                    "critical section (lock-order witness armed)",
    "device_hbm_bytes": "device bytes held by the query's live "
                        "arenas/stores (exact nbytes fold, zero "
                        "added dispatches)",
    "device_arena_bytes": "device bytes of one named arena/store "
                          "plane of a query",
    "device_hbm_total_bytes": "process total of device_hbm_bytes "
                              "across all live queries",
    "device_hbm_backend_bytes": "bytes the caching allocator holds in "
                                "tensors on the card "
                                "(torch.cuda.memory_allocated; absent "
                                "on the CPU)",
    "kernel_device_ms": "device time per kernel family: a CUDA event "
                        "pair around the dispatch scope on a "
                        "deterministic 1/N dispatch sample "
                        "(--device-time-sample)",
    "read_extracts": "pull-query serves that actually ran an executor "
                     "peek (~one per view per close cycle, not one "
                     "per reader)",
    "read_cache_hit_ratio": "snapshot-cache hit ratio over all "
                            "versioned pull-query serves",
    "read_cache_bytes": "bytes held by the read-plane snapshot + "
                        "shared-encode LRU (--read-cache-bytes)",
}

# rate-family HELP text lives on the declaration itself (the one-line
# `.inc` property: declaring a family brings its exposition docs)
_HELP.update({f.name: f.help for f in STAT_FAMILIES})


def escape_label_value(v: str) -> str:
    """Label-value escaping per the exposition format: backslash,
    double-quote, and newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(value: float) -> str:
    f = float(value)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _series(name: str, labels: dict[str, str], value: float) -> str:
    if labels:
        inner = ",".join(f'{k}="{escape_label_value(v)}"'
                         for k, v in labels.items())
        return f"{name}{{{inner}}} {_fmt(value)}"
    return f"{name} {_fmt(value)}"


def _header(lines: list[str], name: str, mtype: str, help_key: str
            ) -> None:
    help_text = _HELP.get(help_key, help_key)
    lines.append(f"# HELP {name} {help_text}")
    lines.append(f"# TYPE {name} {mtype}")


def render_holder(stats, *, live_streams=None, live_queries=None) -> str:
    """Exposition text for one StatsHolder: counters (`_total`), rates
    (gauge), gauges, histograms. `live_streams` (optional set) filters
    counter/rate series to streams that still exist, like GetStats;
    `live_queries` (optional set of query ids, ANY status — a
    crash-looped FAILED query must keep its evidence) likewise bounds
    the QUERY_LABEL_COUNTERS series so deleted queries don't grow the
    exposition forever."""
    lines: list[str] = []
    for metric in PER_STREAM_COUNTERS:
        name = f"{PREFIX}_{metric}" \
            if metric.endswith("_total") else f"{PREFIX}_{metric}_total"
        _header(lines, name, "counter", metric)
        for stream, v in sorted(stats.stream_stat_getall(metric).items()):
            # "_"-prefixed labels are process-scoped pseudo-streams
            # (kernel_recompiles{stream="_process"}),
            # QUERY_LABEL_COUNTERS series are labeled by query id, and
            # FAMILY_LABEL_COUNTERS by a closed kernel-family
            # vocabulary: none is in the stream namespace, so the
            # STREAM liveness filter must not drop them — query-
            # labeled series are bounded by query existence instead
            if not stream.startswith("_") \
                    and metric not in FAMILY_LABEL_COUNTERS \
                    and metric not in LOCK_LABEL_COUNTERS:
                if metric in QUERY_LABEL_COUNTERS:
                    if (live_queries is not None
                            and stream not in live_queries):
                        continue
                elif (live_streams is not None
                        and stream not in live_streams):
                    continue
            lines.append(_series(name, {"stream": stream}, v))
    for fam in STAT_FAMILIES:
        name = f"{PREFIX}_{fam.name}_rate"
        _header(lines, name, "gauge", fam.name)
        for key in stats.stat_keys(fam.name):
            # ONLY the reserved overflow fold is exempt from liveness
            # filtering: the bounded-cardinality aggregate must stay
            # visible exactly when the cap engages (a broader "_"
            # exemption would let "_"-named entities render forever)
            if key != TS_OVERFLOW_LABEL:
                if fam.scope == "stream" and live_streams is not None \
                        and key not in live_streams:
                    continue
                if fam.scope == "query" and live_queries is not None \
                        and key not in live_queries:
                    continue
            lines.append(_series(name, {fam.scope: key},
                                 stats.stat_rate(fam.name, key)))
    # the multi-interval ladder of every stream-scoped family in one
    # place: stream_rate{stream,metric,interval} — cardinality bounded
    # by the per-family series cap (TS_MAX_LABELS overflow fold), 3
    # intervals per (stream, family) pair
    name = f"{PREFIX}_stream_rate"
    _header(lines, name, "gauge", "stream_rate")
    for fam in families_for_scope("stream"):
        for key in stats.stat_keys(fam.name):
            if live_streams is not None and key not in live_streams \
                    and key != TS_OVERFLOW_LABEL:
                continue
            for interval in INTERVAL_NAMES:
                lines.append(_series(
                    name, {"stream": key, "metric": fam.name,
                           "interval": interval},
                    stats.stat_rate(fam.name, key, interval)))
    gauges = stats.gauges_snapshot()
    for metric in GAUGES:
        entries = sorted((label, v) for (m, label), v in gauges.items()
                         if m == metric)
        if not entries:
            continue
        name = f"{PREFIX}_{metric}"
        _header(lines, name, "gauge", metric)
        for label, v in entries:
            if metric == "device_arena_bytes" and label:
                # two-dimension gauge: the registry key is
                # "qid/plane" (plane names never contain "/"; query
                # ids may, so split from the right)
                qid, _, plane = label.rpartition("/")
                labels = {"query": qid, "plane": plane}
            elif label:
                labels = {_gauge_label_key(metric): label}
            else:
                labels = {}
            lines.append(_series(name, labels, v))
    hists = stats.histograms_snapshot()
    seen_types: set[str] = set()
    for (metric, label), h in sorted(hists.items()):
        name = f"{PREFIX}_{metric}"
        if metric not in seen_types:
            _header(lines, name, "histogram", metric)
            seen_types.add(metric)
        lkey = HIST_LABEL_KEYS.get(metric, "label")
        base = {lkey: label} if label else {}
        cum, total_sum, count = h.snapshot()
        for bound, c in zip(h.bounds, cum):
            lines.append(_series(f"{name}_bucket",
                                 {**base, "le": _fmt(bound)}, c))
        lines.append(_series(f"{name}_bucket", {**base, "le": "+Inf"},
                             count))
        lines.append(_series(f"{name}_sum", base, total_sum))
        lines.append(_series(f"{name}_count", base, count))
    return "\n".join(lines) + "\n"


def _gauge_label_key(metric: str) -> str:
    if metric.startswith(("pipeline_", "query_")) \
            or metric in ("crash_loop_open", "device_hbm_bytes"):
        return "query"
    if metric in ("sub_backlog", "credit_inflight"):
        return "subscription"
    if metric == "replica_ack_lag":
        return "follower"
    if metric == "placer_node_score":
        return "node"
    return "label"


# TTL cache for the store-footprint walk: found by hstream-analyze
# (blocking-hot) — the walk ran on EVERY scrape, so a store with many
# segment files turned each /metrics hit into an unbounded stat storm.
# One walk per root per TTL bounds the scrape path; footprint moves
# slowly, 5s staleness is fine. Concurrent scrapers cannot race a cold
# walk: render_metrics serializes whole scrapes under the holder's
# scrape_lock, so at most one walk runs per expiry.
_DIR_BYTES_TTL_S = 5.0
_dir_bytes_cache: dict[str, tuple[float, tuple[int, int]]] = {}
_dir_bytes_lock = threading.Lock()


def _store_dir_bytes(root: str) -> tuple[int, int]:
    """(segment bytes, wal bytes) under a native store root; cached
    for _DIR_BYTES_TTL_S so scrape cost stays O(live subsystems)."""
    now = time.monotonic()
    with _dir_bytes_lock:
        hit = _dir_bytes_cache.get(root)
        if hit is not None and now - hit[0] < _DIR_BYTES_TTL_S:
            return hit[1]
    seg = wal = 0
    try:
        # analyze: ok blocking-hot — deliberate: one cold walk per TTL
        for dirpath, _dirs, files in os.walk(root):
            for f in files:
                try:
                    # analyze: ok blocking-hot — bounded by the TTL cache
                    size = os.path.getsize(os.path.join(dirpath, f))
                except OSError:
                    continue
                if "wal" in f.lower():
                    wal += size
                else:
                    seg += size
    except OSError:
        pass
    with _dir_bytes_lock:
        # stamp AFTER the walk so a slow walk doesn't eat into the TTL
        _dir_bytes_cache[root] = (time.monotonic(), (seg, wal))
    return seg, wal


def sample_gauges(ctx) -> None:
    """Sample live subsystems into the holder's gauge registry. Called
    at scrape time — a scrape's cost is proportional to the number of
    live queries/subscriptions, never to ingest volume."""
    stats = ctx.stats
    # running query tasks: pipeline occupancy + reorder depth
    tasks = dict(getattr(ctx, "running_queries", {}))
    stats.gauge_set("running_queries", "", len(tasks))
    live_q: set[tuple[str, str]] = set()
    for qid, task in tasks.items():
        pipe = getattr(task, "_pipe", None)
        if pipe is None:
            continue
        try:
            st = pipe.stats()
            occ = max(st.get("encode_occupancy", 0.0),
                      st.get("step_occupancy", 0.0))
            stats.gauge_set("pipeline_occupancy", qid, occ)
            stats.gauge_set("pipeline_reorder_depth", qid, pipe.pending)
            live_q.add(("pipeline_occupancy", qid))
            live_q.add(("pipeline_reorder_depth", qid))
        except Exception:  # noqa: BLE001 — a task tearing down mid-
            continue       # scrape must not fail the scrape
    _drop_stale(stats, ("pipeline_occupancy", "pipeline_reorder_depth"),
                live_q)
    # subscriptions: backlog + credits in flight
    live_s: set[tuple[str, str]] = set()
    for rt in getattr(ctx, "subscriptions").list():
        try:
            tail = ctx.store.tail_lsn(rt.logid)
            stats.gauge_set("sub_backlog", rt.sub_id,
                            max(0, tail - rt.committed_lsn))
            stats.gauge_set("credit_inflight", rt.sub_id,
                            rt.credit_inflight())
            live_s.add(("sub_backlog", rt.sub_id))
            live_s.add(("credit_inflight", rt.sub_id))
        except Exception:  # noqa: BLE001
            continue
    _drop_stale(stats, ("sub_backlog", "credit_inflight"), live_s)
    # flow ladder state
    flow = getattr(ctx, "flow", None)
    if flow is not None:
        stats.gauge_set("overload_level", "",
                        flow.overload.effective_level())
    # replica ack lag (leader only)
    follower_status = getattr(ctx.store, "follower_status", None)
    live_f: set[tuple[str, str]] = set()
    if follower_status is not None:
        try:
            for f in follower_status():
                stats.gauge_set("replica_ack_lag", f["addr"],
                                f["behind"])
                live_f.add(("replica_ack_lag", f["addr"]))
        except Exception:  # noqa: BLE001
            pass
    _drop_stale(stats, ("replica_ack_lag",), live_f)
    # leadership epoch + producer-dedup footprint: sampled
    # from the leader store's status so a scrape answers "what epoch
    # does this node serve at" without an admin round trip
    leader_status = getattr(ctx.store, "leader_status", None)
    if leader_status is not None:
        try:
            ls = leader_status()
            stats.gauge_set("replica_epoch", "", ls["epoch"])
            stats.gauge_set("dedup_window_size", "", ls["dedup_window"])
        except Exception:  # noqa: BLE001 — a closing store must not
            pass           # fail the scrape
    # event-time freshness + health verdicts: per-query
    # watermark/lag gauges and the OK/DEGRADED/STALLED rollup — all
    # host-mirror values, zero device work (server/health.py owns the
    # thresholds and the query_stalled transition journal)
    try:
        from hstream_tpu_torch.server.health import sample_health

        sample_health(ctx)
    except Exception:  # noqa: BLE001 — a half-built context (tests
        pass           # construct bare ones) must not fail the scrape
    # retire rate ladders whose entity is gone (the
    # _drop_stale discipline for family series): a deleted stream /
    # subscription / query must stop rendering AND free its
    # TS_MAX_LABELS cap slot, or entity churn folds every new entity
    # into the overflow series. Each scope fails open independently
    # (a half-built test context must not fail the scrape); "live"
    # is defined ONCE (cluster.live_entity_keys) for the sweep, the
    # admin stats verb, and the render filters alike.
    from hstream_tpu_torch.stats.cluster import live_entity_keys

    for scope in ("stream", "subscription", "query"):
        try:
            stats.stat_drop_stale(scope, live_entity_keys(ctx, scope))
        except Exception:  # noqa: BLE001
            pass
    # device cost plane: exact per-query/per-plane arena
    # bytes folded from each executor's live device arrays — nbytes
    # metadata reads only, zero dispatches — plus the process total
    # and the backend allocator cross-check where one exists
    try:
        from hstream_tpu_torch.stats.devicecost import sample_device_gauges

        sample_device_gauges(ctx)
    except Exception:  # noqa: BLE001 — a half-built context must not
        pass           # fail the scrape
    # node load axes for the federation fold: process rss +
    # append-front queue depth — the same numbers NodeStatsReport and
    # the periodic node_load_report event carry
    from hstream_tpu_torch.stats.cluster import rss_bytes

    stats.gauge_set("node_rss_bytes", "", rss_bytes())
    # placer node scores: one gauge series per cluster node
    # with a fresh published record — the load fold the placement
    # decisions actually rank on, so an operator can see WHY a node
    # won. Stale nodes drop off the exposition with their records.
    placer = getattr(ctx, "placer", None)
    live_n: set[tuple[str, str]] = set()
    if placer is not None:
        try:
            for node, score in placer.scores().items():
                stats.gauge_set("placer_node_score", node, score)
                live_n.add(("placer_node_score", node))
        except Exception:  # noqa: BLE001 — a closing placer must not
            pass           # fail the scrape
    _drop_stale(stats, ("placer_node_score",), live_n)
    front = getattr(ctx, "append_front", None)
    if front is not None:
        try:
            stats.gauge_set("append_inflight", "",
                            front.stats().get("in_flight", 0))
        except Exception:  # noqa: BLE001 — a closing front must not
            pass           # fail the scrape
    # durable store footprint (native store roots at a directory)
    root = getattr(ctx.store, "root", None) \
        or getattr(getattr(ctx.store, "local", None), "root", None)
    if root:
        seg, wal = _store_dir_bytes(str(root))
        stats.gauge_set("store_segment_bytes", "", seg)
        stats.gauge_set("store_wal_bytes", "", wal)
    # event_journal_size is a gauge_fn sampler registered by the
    # ServerContext — gauges_snapshot() calls it at render time


def _drop_stale(stats, metrics: tuple[str, ...],
                live: set[tuple[str, str]]) -> None:
    """Drop gauge series whose subsystem (query, subscription,
    follower) went away, so /metrics reflects the live topology."""
    for metric in metrics:
        for label in stats.gauge_labels(metric):
            if (metric, label) not in live:
                stats.gauge_drop(metric, label)


def render_metrics(ctx) -> str:
    """One scrape: sample live subsystems, render the full exposition.
    Whole-scrape serialization (holder.scrape_lock): concurrent
    scrapers otherwise race sample_gauges' stale-series sweep against
    each other and intermittently drop live gauges."""
    from hstream_tpu_torch.stats.cluster import live_entity_keys

    with ctx.stats.scrape_lock:
        sample_gauges(ctx)
        try:
            live = live_entity_keys(ctx, "stream")
        except Exception:  # noqa: BLE001
            live = None
        try:
            queries = live_entity_keys(ctx, "query")
        except Exception:  # noqa: BLE001 — fail open, like streams
            queries = None
        return render_holder(ctx.stats, live_streams=live,
                             live_queries=queries)


CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def serve_exporter(ctx, host: str = "0.0.0.0", port: int = 9464):
    """Standalone scrape endpoint on the SERVER process (the
    `--metrics-port` flag): /metrics (Prometheus text) + /events
    (journal JSON) straight off the live context — no gRPC hop, so it
    keeps answering even when the RPC workers are saturated. Returns
    the httpd; caller owns shutdown. Port 0 picks a free port."""
    import json
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
            from urllib.parse import parse_qs, urlsplit

            parts = urlsplit(self.path)
            if parts.path.rstrip("/") == "/metrics":
                try:
                    body = render_metrics(ctx).encode()
                except Exception as e:  # noqa: BLE001 — scrape boundary
                    self._send(500, f"# scrape failed: {e}\n".encode())
                    return
                self._send(200, body, CONTENT_TYPE)
            elif parts.path.rstrip("/") == "/events":
                q = parse_qs(parts.query)
                try:
                    events = ctx.events.query(
                        kind=(q.get("kind") or [None])[0],
                        since=int((q.get("since") or [0])[0]),
                        limit=int((q.get("limit") or [100])[0]))
                except ValueError as e:
                    self._send(400, f"bad query param: {e}\n".encode())
                    return
                self._send(200, json.dumps(events).encode(),
                           "application/json")
            else:
                self._send(404, b"only /metrics and /events live here\n")

        def _send(self, code: int, body: bytes,
                  ctype: str = "text/plain") -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet
            pass

    httpd = ThreadingHTTPServer((host, port), Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="metrics-exporter")
    t.start()
    return httpd
