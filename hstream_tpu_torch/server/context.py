"""ServerContext: the one object every handler reaches through.

Reference: `ServerContext` bundles the LD client, ZK handle, and the
MVar maps of running queries / connectors / subscriptions
(Handler/Common.hs:85-115). Here it bundles the log store, stream
namespace, checkpoint store, metadata persistence, view registry,
subscription registry and the running-task maps. The port's context
also holds the device every query task runs on: the card unless
`device="cpu"` is given.
"""

# A copy of hstream_tpu/server/context.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import threading

from hstream_tpu_torch.common.errors import NotPortedError
from hstream_tpu_torch.device import resolve as resolve_device
from hstream_tpu_torch.server.persistence import (
    MemPersistence,
    Persistence,
    StorePersistence,
)
from hstream_tpu_torch.server.subscriptions import SubscriptionRegistry
from hstream_tpu_torch.server.views import ViewRegistry
from hstream_tpu_torch.store.api import LogStore
from hstream_tpu_torch.store.checkpoint import LogCheckpointStore
from hstream_tpu_torch.store.streams import StreamApi

# canonical overlapped-ingest defaults; every consumer (serve() flags,
# QueryTask fallbacks) imports these so they cannot drift
DEFAULT_PIPELINE_DEPTH = 4
DEFAULT_ENCODE_WORKERS = 2
# append-front lanes behind the framed columnar append path (ignored
# on stores with their own completion queue — see server/appendfront)
DEFAULT_APPEND_LANES = 2


class ServerContext:
    def __init__(self, store: LogStore, *,
                 persistence: Persistence | None = None,
                 host: str = "127.0.0.1", port: int = 6570,
                 server_id: int = 1, durable_meta: bool = True,
                 mesh=None,
                 pipeline_depth: int = DEFAULT_PIPELINE_DEPTH,
                 encode_workers: int = DEFAULT_ENCODE_WORKERS,
                 credit_window: int | None = None,
                 slow_request_ms: float = 1000.0,
                 append_lanes: int = DEFAULT_APPEND_LANES,
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
                 device=None):
        if mesh is not None:
            raise NotPortedError("sharded execution (mesh=)", "A11")
        # every query task's executor lives here (device.resolve: the
        # card unless "cpu" is asked for; no card raises)
        self.device = resolve_device(device)
        self.store = store
        # in-process multi-node clusters share ONE store across several
        # contexts; only the context that opened it may close it
        self.owns_store = owns_store
        # the reference's device mesh (sharded execution) waits for
        # ROADMAP A11: the port runs every query on one device
        self.mesh = None
        # overlapped-ingest tuning shared by every query task: staging
        # ring depth (batches encoded ahead of the ordered step loop)
        # and host-encode worker count (server --pipeline-depth /
        # --encode-workers)
        self.pipeline_depth = max(int(pipeline_depth), 1)
        self.encode_workers = max(int(encode_workers), 1)
        self.streams = StreamApi(store)
        self.streams.ensure_checkpoint_log()
        self.ckp_store = LogCheckpointStore(store)
        if persistence is None:
            persistence = (StorePersistence(store) if durable_meta
                           else MemPersistence())
        self.persistence = persistence
        self.views = ViewRegistry()
        self.subscriptions = SubscriptionRegistry()
        # read plane: version-validated snapshot cache for
        # pull queries + the shared-encode expansion cache subscription
        # fan-out rides on; budget 0 disables caching entirely
        from hstream_tpu_torch.server.readcache import ReadCache

        self.read_cache = (ReadCache(
            max_bytes=int(read_cache_bytes),
            max_staleness_ms=read_max_staleness_ms)
            if int(read_cache_bytes) > 0 else None)
        # query_id -> QueryTask; connector_id -> ConnectorTask
        self.running_queries: dict[str, object] = {}
        self.running_connectors: dict[str, object] = {}
        from hstream_tpu_torch.common import locktrace

        self.lock = locktrace.lock("context.running")
        self.host = host
        self.port = port
        self.server_id = server_id
        from hstream_tpu_torch.stats import StatsHolder
        from hstream_tpu_torch.stats.events import EventJournal
        from hstream_tpu_torch.store.versioned import VersionedConfigStore

        self.stats = StatsHolder()
        # runtime face of the retrace contract: every compile of
        # the port in this process (common.tracing.note_compile: the
        # kernel library's build, a program-factory miss) bumps
        # kernel_recompiles, so a
        # steady-state recompile regression is visible on /metrics
        from hstream_tpu_torch.common.tracing import install_recompile_counter

        install_recompile_counter(self.stats)
        # observability plane: structured event journal + the slow-
        # request threshold handlers log correlated warnings above
        self.events = EventJournal()
        # sampler-style gauge: the holder calls it at scrape time
        self.stats.gauge_fn("event_journal_size", "",
                            lambda: len(self.events))
        if self.read_cache is not None:
            self.stats.gauge_fn("read_cache_hit_ratio", "",
                                self.read_cache.hit_ratio)
            self.stats.gauge_fn("read_cache_bytes", "",
                                self.read_cache.nbytes)
        self.slow_request_ms = float(slow_request_ms)
        # cross-component trace spans: bounded per-scope
        # rings + the --trace-sample knob; disarmed (rate 0) cost is
        # one attribute read + one branch at every probe site
        from hstream_tpu_torch.common.tracing import SpanCollector

        self.tracing = SpanCollector(sample_rate=trace_sample)
        # device cost plane: the compiled-program inventory
        # records the port's compiles (idempotent), and the
        # per-dispatch device-time sampler observes into this holder —
        # armed only when --device-time-sample > 0 (disarmed cost: one
        # attribute read + one branch per kernel_family scope)
        from hstream_tpu_torch.stats.devicecost import DEVICE_TIME, PROGRAMS

        PROGRAMS.install()
        DEVICE_TIME.add_sink(self.stats)
        self.device_time_sample = max(int(device_time_sample), 0)
        if self.device_time_sample > 0:
            DEVICE_TIME.arm(self.device_time_sample)
        # flight recorder: postmortem bundles captured at
        # the STALLED / crash-loop edges, surviving query deletion
        from hstream_tpu_torch.server.flightrec import FlightRecorder

        self.flightrec = FlightRecorder(self)
        # per-query health plane: progress memory + verdict
        # transitions behind GET /queries/<id>/health, admin health,
        # and the query_health_level gauge
        from hstream_tpu_torch.server.health import (
            DEGRADED_AFTER_MS,
            STALLED_AFTER_MS,
            HealthTracker,
        )

        self.health = HealthTracker()
        self.health_degraded_ms = float(
            DEGRADED_AFTER_MS if health_degraded_ms is None
            else health_degraded_ms)
        self.health_stalled_ms = float(
            STALLED_AFTER_MS if health_stalled_ms is None
            else health_stalled_ms)
        # a replicated store journals degraded acks / follower loss;
        # the leadership binding itself is the first journal entry, so
        # `admin events --kind leader_change` answers "who leads this
        # store, since when" on the serving node
        if hasattr(store, "follower_status"):
            store.journal = self.events
            # fenced_appends / promotions counters + the epoch gauge
            # sample through this binding (stats/prometheus.py)
            store.stats = self.stats
            self.events.append(
                "leader_change",
                f"this server leads the replicated store as "
                f"{store.node_id} (epoch {store.epoch})",
                leader=store.node_id, epoch=store.epoch)
        # producer-stamped appends on a NON-replicated store serialize
        # their lookup+append+record through this lock (the replicated
        # store has its own critical section; store/dedup.py)
        self.dedup_lock = locktrace.lock("context.dedup")
        # wire-speed ingest: framed columnar appends go
        # through sharded lanes feeding the store's completion-queue
        # path, so the RPC thread validates the NEXT block while the
        # previous one fsyncs
        from hstream_tpu_torch.server.appendfront import AppendFront

        self.append_front = AppendFront(store, lanes=append_lanes)
        # CAS-versioned cluster config (reference VersionedConfigStore);
        # first consumer: the boot-epoch counter below — each server
        # boot on a store CAS-increments it, so concurrent servers on
        # one store lose the race visibly instead of corrupting state
        self.config = VersionedConfigStore(store)
        self.boot_epoch = self._bump_boot_epoch()
        # flow control: admission quotas + overload shedding + delivery
        # credit windows; quotas persist in the versioned config store
        # (and therefore replicate/survive restart with it)
        from hstream_tpu_torch.flow import DEFAULT_CREDIT_WINDOW, FlowGovernor

        self.flow = FlowGovernor(
            config=self.config, stats=self.stats, events=self.events,
            credit_window=(DEFAULT_CREDIT_WINDOW if credit_window is None
                           else credit_window))
        self.flow.load()
        # chaos harness: the process-wide fault registry journals every
        # injection here; HSTREAM_FAULTS in the environment arms sites
        # for the whole server (admin fault-set does it at runtime)
        from hstream_tpu_torch.common.faultinject import FAULTS

        self.faults = FAULTS
        FAULTS.bind_events(self.events)
        FAULTS.load_env()
        # lock-order witness: the named traced locks above
        # (append front, supervisor, subscriptions, tasks, replica,
        # gateway) report into this registry when armed — per-lock
        # wait/hold histograms + contention on /metrics, lock_cycle
        # events in the journal, `admin locks` for the ledger.
        # HSTREAM_LOCKTRACE=1 / --locktrace arms it for the process.
        from hstream_tpu_torch.common.locktrace import LOCKTRACE

        self.locktrace = LOCKTRACE
        LOCKTRACE.bind(stats=self.stats, events=self.events)
        LOCKTRACE.load_env()
        # self-healing supervision: tasks report unexpected deaths here;
        # the servicer binds resume_fn once handlers exist
        from hstream_tpu_torch.server.scheduler import QuerySupervisor

        self.supervisor = QuerySupervisor(self)
        # cluster stats plane: periodic node_load_report
        # journal events — one bounded holder fold per interval, the
        # machine-readable load signal the thousand-query placer gates
        # on. Always on (a node that stops reporting load is invisible
        # to placement); the interval is tunable for tests/CI.
        # Constructed here, STARTED by serve() after the port binds —
        # the boot report must carry the node's real (bound) identity.
        from hstream_tpu_torch.stats.cluster import (
            DEFAULT_LOAD_REPORT_INTERVAL_S,
            LoadReporter,
        )

        self.load_reporter = LoadReporter(
            self, interval_s=(DEFAULT_LOAD_REPORT_INTERVAL_S
                              if load_report_interval_ms is None
                              else load_report_interval_ms / 1000.0))
        # the placer: placement + live failover adoption +
        # rebalance over the CAS scheduler records. Constructed always
        # (admin `placer` and /metrics read its status), ARMED only when
        # --placer-interval-ms is set — disarmed it never heartbeats,
        # never publishes node records and never sweeps, so single-node
        # deployments keep the pure boot-epoch adoption semantics.
        # Started by serve() after the port binds, like the reporter.
        from hstream_tpu_torch.placer import DEFAULT_LEASE_MS, PackPool, Placer

        self.heartbeat_lease_ms = int(
            DEFAULT_LEASE_MS if heartbeat_lease_ms is None
            else heartbeat_lease_ms)
        self.placer = Placer(self, interval_ms=placer_interval_ms,
                             lease_ms=self.heartbeat_lease_ms)
        # the placer clamps a lease shorter than 3 ticks (a healthy
        # owner must never look dead between heartbeats); health and
        # the boot-time live-peer guard must judge by the SAME lease
        self.heartbeat_lease_ms = self.placer.lease_ms
        # co-compile packing: compatible queries share one executor /
        # one dispatch; opt-in via --pack-queries
        self.pack_pool = PackPool(self) if pack_queries else None
        # the checkpoint-log replay above (LogCheckpointStore) happened
        # before the journal existed: surface any corrupt entries it
        # had to skip as a queryable event now
        skipped = getattr(self.ckp_store, "replay_skipped", 0)
        if skipped:
            self.events.append(
                "checkpoint_corrupt",
                f"checkpoint-log replay skipped {skipped} corrupt "
                f"entries; affected readers rewind and replay",
                skipped=skipped)

    def _bump_boot_epoch(self) -> int:
        from hstream_tpu_torch.store.versioned import VersionMismatch

        for _ in range(16):
            cur = self.config.get("cluster/boot_epoch")
            try:
                if cur is None:
                    self.config.put("cluster/boot_epoch", b"1")
                    return 1
                version, raw = cur
                epoch = int(raw) + 1
                self.config.put("cluster/boot_epoch",
                                str(epoch).encode(),
                                base_version=version)
                return epoch
            except VersionMismatch:
                continue
        raise RuntimeError("boot-epoch CAS kept losing; another server "
                           "is racing this store")

    def shutdown(self) -> None:
        # stop the placer before the supervisor: a placement/adoption
        # sweep racing shutdown would relaunch or move a query the
        # loop below is about to stop
        placer = getattr(self, "placer", None)
        if placer is not None:
            try:
                placer.stop()
            except Exception:
                pass
        pool = getattr(self, "pack_pool", None)
        if pool is not None:
            try:
                pool.stop()
            except Exception:
                pass
        rep = getattr(self, "load_reporter", None)
        if rep is not None:
            try:
                rep.stop()
            except Exception:
                pass
        # stop the supervisor FIRST: a restart racing shutdown would
        # relaunch a task the loop below just stopped
        sup = getattr(self, "supervisor", None)
        if sup is not None:
            try:
                sup.shutdown()
            except Exception:
                pass
        httpd = getattr(self, "metrics_httpd", None)
        if httpd is not None:
            try:
                httpd.shutdown()
                httpd.server_close()  # release the listening socket
            except Exception:
                pass
        for task in list(self.running_queries.values()):
            try:
                # detach: snapshot state but leave status RUNNING so the
                # next boot's resume_persisted relaunches the query
                task.stop(detach=True)
            except Exception:
                pass
        for task in list(self.running_connectors.values()):
            try:
                task.stop()
            except Exception:
                pass
        for rt in self.subscriptions.list():
            rt.shutdown()
        front = getattr(self, "append_front", None)
        if front is not None:
            # drain the append lanes BEFORE the store closes: a lane
            # worker mid-append against a closed store would fail an
            # acknowledged-in-flight batch
            front.close()
        if self.owns_store:
            self.store.close()
