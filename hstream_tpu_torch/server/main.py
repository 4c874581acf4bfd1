"""Server boot: flags/config file -> store -> context -> gRPC serve.

Reference: hstream/app/server.hs:36-149 — optparse flags
(host/port/store/replication/timeout/compression/log-level; "TODO:
config file" at server.hs:32-34 — here the config file exists). Flags
override config-file values; see --help for the full surface.

The port's server runs its queries on the card unless `--device cpu`
(`serve(..., device="cpu")`) is given; with no card it refuses to
start. `--mesh` (sharded execution, ROADMAP A11) and `--replicate` (the
replicated store, ROADMAP A5c) are not ported and raise NotPortedError.
"""

# A copy of hstream_tpu/server/main.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import argparse
import json
import signal
from concurrent import futures

import grpc

from hstream_tpu_torch.common.errors import NotPortedError
from hstream_tpu_torch.common.logger import get_logger
from hstream_tpu_torch.device import resolve as resolve_device
from hstream_tpu_torch.proto.rpc import add_hstream_api_to_server
from hstream_tpu_torch.server.context import (
    DEFAULT_APPEND_LANES,
    DEFAULT_ENCODE_WORKERS,
    DEFAULT_PIPELINE_DEPTH,
    ServerContext,
)
from hstream_tpu_torch.store import open_store

log = get_logger("main")


def _build_mesh(shape: str):
    """'DxK' -> a (data, key) device mesh: sharded execution waits for
    ROADMAP A11."""
    raise NotPortedError(f"the device mesh (--mesh {shape})", "A11")


def serve(host: str = "127.0.0.1", port: int = 6570,
          store_uri: str = "mem://", *, max_workers: int = 32,
          mesh_shape: str | None = None,
          sync_interval_ms: int | None = None,
          segment_bytes: int | None = None,
          snapshot_interval_ms: int | None = None,
          replicate: str | None = None,
          replication_factor: int = 2,
          replica_ack_timeout_ms: int | None = None,
          store: "LogStore | None" = None,
          append_compression: str | None = None,
          pipeline_depth: int = DEFAULT_PIPELINE_DEPTH,
          encode_workers: int = DEFAULT_ENCODE_WORKERS,
          append_lanes: int = DEFAULT_APPEND_LANES,
          credit_window: int | None = None,
          metrics_port: int | None = None,
          slow_request_ms: float = 1000.0,
          faults: str | None = None,
          locktrace: bool = False,
          trace_sample: float = 0.0,
          health_degraded_ms: float | None = None,
          health_stalled_ms: float | None = None,
          load_report_interval_ms: float | None = None,
          placer_interval_ms: float | None = None,
          heartbeat_lease_ms: float | None = None,
          pack_queries: bool = False,
          device_time_sample: int = 0,
          read_max_staleness_ms: float | None = None,
          read_cache_bytes: int = 64 << 20,
          owns_store: bool = True,
          device=None
          ) -> tuple[grpc.Server, ServerContext]:
    """Start a server; returns (grpc_server, ctx). Caller owns shutdown.

    `mesh_shape` ("DxK", e.g. "4x2") would shard eligible aggregate
    queries over a (data, key) device mesh (SURVEY §2.3). `replicate`
    (comma-separated follower replica addresses) would make this server
    the store LEADER, replicating every store mutation to those
    follower nodes; `replication_factor` and `replica_ack_timeout_ms`
    tune it. Both are the reference's and not ported yet.
    `store` (an already-open LogStore) overrides `store_uri` — the
    failover path: promote a follower, then boot a server OVER its
    (promoted) store; the epoch persisted in store meta carries the
    leadership forward.

    `device` is where every query runs: the card when None (no card
    raises DeviceUnavailable before anything is opened), "cpu" for the
    plain PyTorch versions of the kernels. `mesh_shape` and `replicate`
    raise NotPortedError (ROADMAP A11 and A5c)."""
    device = resolve_device(device)
    mesh = _build_mesh(mesh_shape) if mesh_shape else None
    if replicate:
        raise NotPortedError(
            f"the replicated store (--replicate {replicate})", "A5c")
    if store is None:
        store = open_store(store_uri, sync_interval_ms=sync_interval_ms,
                           segment_bytes=segment_bytes)
    ctx = ServerContext(store, host=host, port=port, mesh=mesh,
                        pipeline_depth=pipeline_depth,
                        encode_workers=encode_workers,
                        credit_window=credit_window,
                        slow_request_ms=slow_request_ms,
                        append_lanes=append_lanes,
                        trace_sample=trace_sample,
                        health_degraded_ms=health_degraded_ms,
                        health_stalled_ms=health_stalled_ms,
                        load_report_interval_ms=load_report_interval_ms,
                        placer_interval_ms=placer_interval_ms,
                        heartbeat_lease_ms=heartbeat_lease_ms,
                        pack_queries=pack_queries,
                        device_time_sample=device_time_sample,
                        read_max_staleness_ms=read_max_staleness_ms,
                        read_cache_bytes=read_cache_bytes,
                        owns_store=owns_store,
                        device=device)
    if faults:
        # chaos harness: arm fault sites for this run (same grammar as
        # HSTREAM_FAULTS, which ServerContext already loaded)
        ctx.faults.load_env(faults)
    if locktrace:
        # lock-order witness: arm the runtime deadlock
        # detector for this process (HSTREAM_LOCKTRACE=1 equivalent)
        ctx.locktrace.arm()
    if append_compression:
        from hstream_tpu_torch.store.api import Compression

        ctx.append_compression = Compression[append_compression.upper()]
    if snapshot_interval_ms is not None:
        # per-context, not the QueryTask CLASS attribute: two servers in
        # one process must not leak cadence into each other's tasks
        ctx.snapshot_interval_ms = snapshot_interval_ms
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        options=[("grpc.max_receive_message_length", 64 * 1024 * 1024),
                 ("grpc.max_send_message_length", 64 * 1024 * 1024)])
    from hstream_tpu_torch.server.handlers import HStreamApiServicer

    servicer = HStreamApiServicer(ctx)
    add_hstream_api_to_server(servicer, server)
    bound = server.add_insecure_port(f"{host}:{port}")
    if bound == 0:
        raise RuntimeError(f"cannot bind {host}:{port}")
    ctx.port = bound
    if hasattr(ctx.store, "client_addr"):
        # the address that rides every Replicate as the leader hint:
        # followers persist it and serve it to redirected clients, so
        # it must be THIS server's client-facing endpoint (known only
        # after the bind)
        ctx.store.client_addr = f"{host}:{bound}"
    # only after a successful bind: a failed boot (port in use) must not
    # relaunch tasks and re-emit at-least-once rows before dying
    servicer.resume_persisted()
    server.start()
    # load reporter starts only now: its boot-time node_load_report
    # must journal the node's REAL bound identity (host:0 would be a
    # phantom node the placer can't match to later reports)
    ctx.load_reporter.start()
    # same bind-first rule for the placer: its node record and its
    # scheduler heartbeats carry server-<id>@host:port, which is only
    # real after the bind. No-op unless --placer-interval-ms armed it.
    ctx.placer.start()
    if metrics_port is not None:
        from hstream_tpu_torch.stats.prometheus import serve_exporter

        ctx.metrics_httpd = serve_exporter(ctx, host=host,
                                           port=metrics_port)
        log.info("metrics exporter on %s:%d (/metrics, /events)",
                 host, ctx.metrics_httpd.server_port)
    log.info("hstream-tpu server listening on %s:%d (store %s)",
             host, bound, store_uri)
    return server, ctx


def _parse_args(argv):
    ap = argparse.ArgumentParser(
        "hstream-tpu-server",
        description="streaming database server (PyTorch and CUDA)")
    ap.add_argument("--config", default=None, metavar="FILE",
                    help="JSON config file; flags given on the command "
                         "line override it")
    ap.add_argument("--host", default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--store", default=None,
                    help="mem:// or a directory path for the native "
                         "durable store")
    ap.add_argument("--workers", type=int, default=None,
                    help="gRPC worker threads")
    ap.add_argument("--mesh", default=None, metavar="DxK",
                    help="shard aggregate queries over a (data, key) "
                         "device mesh, e.g. 4x2 (needs D*K devices)")
    ap.add_argument("--device", default=None,
                    help="where queries run: cuda (the card, the "
                         "default) or cpu (the kernels' plain PyTorch "
                         "versions)")
    ap.add_argument("--log-level", default=None,
                    choices=["DEBUG", "INFO", "WARNING", "ERROR"])
    ap.add_argument("--sync-interval-ms", type=int, default=None,
                    help="native store group-commit fsync cadence")
    ap.add_argument("--segment-bytes", type=int, default=None,
                    help="native store segment roll size")
    ap.add_argument("--snapshot-interval-ms", type=int, default=None,
                    help="operator-state snapshot + checkpoint cadence")
    ap.add_argument("--replicate", default=None, metavar="ADDR,ADDR",
                    help="follower store-replica addresses; this server "
                         "becomes the store leader and replicates every "
                         "mutation to them (reference: server.hs "
                         "--replicate-factor onto LogDevice)")
    ap.add_argument("--replication-factor", type=int, default=None,
                    help="copies (incl. leader) an append waits for")
    ap.add_argument("--replica-ack-timeout-ms", type=int, default=None,
                    help="follower-ack deadline per append; expiry "
                         "journals replica_ack_timeout and records a "
                         "degraded ack instead of blocking forever "
                         "(default 5000)")
    ap.add_argument("--append-compression", default=None,
                    choices=["none", "zlib"],
                    help="storage compression for appended batches "
                         "(reference server.hs --compression)")
    ap.add_argument("--pipeline-depth", type=int, default=None,
                    help="ingest staging-ring depth: micro-batches "
                         "wire-encoded ahead of the ordered device "
                         f"step loop (default {DEFAULT_PIPELINE_DEPTH})")
    ap.add_argument("--encode-workers", type=int, default=None,
                    help="host-encode worker threads per query task "
                         "feeding the staging ring (default "
                         f"{DEFAULT_ENCODE_WORKERS})")
    ap.add_argument("--append-lanes", type=int, default=None,
                    help="sharded append-front lanes behind the framed "
                         "columnar append path (stores with a native "
                         "completion queue pipeline there instead; "
                         f"default {DEFAULT_APPEND_LANES})")
    ap.add_argument("--credit-window", type=int, default=None,
                    help="per-consumer in-flight record window for "
                         "push delivery (StreamingFetch); a stalled "
                         "consumer holds at most this many undelivered "
                         "records server-side (default 256)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus /metrics + /events on this "
                         "port straight off the server process "
                         "(0 picks a free port); omit to disable")
    ap.add_argument("--slow-request-ms", type=float, default=None,
                    help="log a correlated slow-request warning for "
                         "any RPC slower than this (default 1000)")
    ap.add_argument("--faults", default=None, metavar="SITE=SPEC;...",
                    help="arm chaos fault sites at boot, e.g. "
                         "'store.append=fail:3;snapshot.persist="
                         "torn:2:7' (also: HSTREAM_FAULTS env, admin "
                         "fault-set at runtime)")
    ap.add_argument("--locktrace", action="store_true", default=None,
                    help="arm the runtime lock-order witness "
                         "(GoodLock/lockdep): per-thread held-sets, "
                         "cycle detection journaling lock_cycle, "
                         "lock_wait_ms/lock_hold_ms/lock_contention "
                         "on /metrics, `admin locks` ledger; also: "
                         "HSTREAM_LOCKTRACE=1 env. Disarmed cost is "
                         "one attribute read + one branch per acquire")
    ap.add_argument("--trace-sample", type=float, default=None,
                    help="cross-component span sampling rate in [0,1]: "
                         "0 disarms tracing (one-branch cost), 1 "
                         "records every request's spans into the "
                         "per-query rings (GET /queries/<id>/trace, "
                         "admin trace --spans); default 0")
    ap.add_argument("--health-degraded-ms", type=float, default=None,
                    help="health plane: backlog with no watermark "
                         "advance for this long reads DEGRADED "
                         "(default 5000)")
    ap.add_argument("--health-stalled-ms", type=float, default=None,
                    help="health plane: backlog with no watermark "
                         "advance for this long reads STALLED and "
                         "journals query_stalled (default 30000)")
    ap.add_argument("--load-report-interval-ms", type=float,
                    default=None,
                    help="cadence of the node_load_report journal "
                         "event (per-stream rate ladders, query "
                         "health counts, append-front depth, rss — "
                         "the placement load signal; default 30000)")
    ap.add_argument("--placer-interval-ms", type=float, default=None,
                    help="ARM the placer loop at this cadence: publish "
                         "this node's record to cluster/nodes/<node>, "
                         "heartbeat owned scheduler/query/* records, "
                         "adopt queries whose owner's heartbeat lease "
                         "lapsed, rebalance on load skew. Unset (the "
                         "default) keeps pure boot-epoch adoption with "
                         "zero background config writes")
    ap.add_argument("--heartbeat-lease-ms", type=float, default=None,
                    help="owner-liveness lease: a scheduler record "
                         "whose heartbeat is older than this is "
                         "adoptable by any armed survivor "
                         "(default 10000)")
    ap.add_argument("--device-time-sample", type=int, default=None,
                    help="device-time sampling rate N: every Nth "
                         "dispatch per kernel family is timed with a "
                         "CUDA event pair into the "
                         "kernel_device_ms histogram (1 = every "
                         "dispatch, 0 = disarmed; default 0). "
                         "Disarmed cost is one attribute read + one "
                         "branch per dispatch")
    ap.add_argument("--read-max-staleness-ms", type=float, default=None,
                    help="read plane: age-bound snapshot-cache hits to "
                         "this many ms (exactness already comes from "
                         "the version key; this is a freshness SLA "
                         "backstop). Unset = no age bound")
    ap.add_argument("--read-cache-bytes", type=int, default=None,
                    help="read plane: LRU byte budget shared by the "
                         "pull-query snapshot cache and the "
                         "subscription shared-encode cache "
                         "(0 disables both; default 64 MiB)")
    ap.add_argument("--pack-queries", action="store_true", default=None,
                    help="co-compile packing: bucket compatible "
                         "queries (same source/window/agg signature) "
                         "into one shared slot-keyed executor, so N "
                         "queries ride one dispatch and the 2nd..Nth "
                         "compiles nothing")
    args = ap.parse_args(argv)

    defaults = {"host": "0.0.0.0", "port": 6570, "store": "mem://",
                "workers": 32, "mesh": None, "log_level": None,
                "device": None,
                "sync_interval_ms": None, "segment_bytes": None,
                "snapshot_interval_ms": None, "replicate": None,
                "replication_factor": 2,
                "replica_ack_timeout_ms": None,
                "append_compression": None,
                "pipeline_depth": DEFAULT_PIPELINE_DEPTH,
                "encode_workers": DEFAULT_ENCODE_WORKERS,
                "append_lanes": DEFAULT_APPEND_LANES,
                "credit_window": None,
                "metrics_port": None,
                "slow_request_ms": 1000.0,
                "faults": None,
                "locktrace": False,
                "trace_sample": 0.0,
                "health_degraded_ms": None,
                "health_stalled_ms": None,
                "load_report_interval_ms": None,
                "placer_interval_ms": None,
                "heartbeat_lease_ms": None,
                "pack_queries": False,
                "device_time_sample": 0,
                "read_max_staleness_ms": None,
                "read_cache_bytes": 64 << 20}
    if args.config:
        with open(args.config) as f:
            file_cfg = json.load(f)
        unknown = set(file_cfg) - set(defaults)
        if unknown:
            raise SystemExit(
                f"unknown config key(s) {sorted(unknown)}; "
                f"valid: {sorted(defaults)}")
        defaults.update(file_cfg)
    for key in defaults:
        v = getattr(args, key)
        if v is not None:
            defaults[key] = v
    return defaults


def main(argv=None) -> None:
    cfg = _parse_args(argv)
    if cfg["log_level"]:
        import logging

        level = str(cfg["log_level"]).upper()
        if level not in ("DEBUG", "INFO", "WARNING", "ERROR"):
            raise SystemExit(f"invalid log_level {cfg['log_level']!r}")
        # project logs ride the non-propagating 'hstream_tpu_torch'
        # logger
        logging.getLogger("hstream_tpu_torch").setLevel(level)
    server, ctx = serve(
        cfg["host"], cfg["port"], cfg["store"],
        max_workers=cfg["workers"], mesh_shape=cfg["mesh"],
        sync_interval_ms=cfg["sync_interval_ms"],
        segment_bytes=cfg["segment_bytes"],
        snapshot_interval_ms=cfg["snapshot_interval_ms"],
        replicate=cfg["replicate"],
        replication_factor=cfg["replication_factor"],
        replica_ack_timeout_ms=cfg["replica_ack_timeout_ms"],
        append_compression=cfg["append_compression"],
        pipeline_depth=cfg["pipeline_depth"],
        encode_workers=cfg["encode_workers"],
        append_lanes=cfg["append_lanes"],
        credit_window=cfg["credit_window"],
        metrics_port=cfg["metrics_port"],
        slow_request_ms=cfg["slow_request_ms"],
        faults=cfg["faults"],
        locktrace=cfg["locktrace"],
        trace_sample=cfg["trace_sample"],
        health_degraded_ms=cfg["health_degraded_ms"],
        health_stalled_ms=cfg["health_stalled_ms"],
        load_report_interval_ms=cfg["load_report_interval_ms"],
        placer_interval_ms=cfg["placer_interval_ms"],
        heartbeat_lease_ms=cfg["heartbeat_lease_ms"],
        pack_queries=cfg["pack_queries"],
        device_time_sample=cfg["device_time_sample"],
        read_max_staleness_ms=cfg["read_max_staleness_ms"],
        read_cache_bytes=cfg["read_cache_bytes"],
        device=cfg["device"])
    stop = {"flag": False}

    def on_signal(signum, frame):
        stop["flag"] = True
        server.stop(grace=2)

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    server.wait_for_termination()
    ctx.shutdown()


if __name__ == "__main__":
    main()
