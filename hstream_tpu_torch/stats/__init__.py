"""Per-stream stats: counters + multi-level time-series rate ladders.

Reference: a C++ stats library with thread-local `PerStreamStats`
(sharded counters aggregated on demand) and folly MultiLevelTimeSeries
rates, where the metric registry is an X-macro `.inc` file so adding a
metric is one line (common/clib/stats.h:80-118,
common/include/per_stream_time_series.inc:24-40).

Here the counter registry is the list below and the rate-ladder
registry is the declarative family table (stats/families.py — the
`.inc` analogue, machine-checked by the analyzer's registry pass); the
holder keeps per-thread counter shards aggregated on read — the GIL
makes plain dict bumps atomic enough, but sharding keeps the write path
contention-free and mirrors the reference's aggregation shape. Rates
live in fixed-ring MultiLevelTimeSeries (stats/timeseries.py): 60x1s /
60x10s / 60x60s + all-time, O(1) add, exact windowed recounts.
"""

# A copy of hstream_tpu/stats/__init__.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict

from hstream_tpu_torch.stats.families import (
    FAMILY_BY_NAME,
    STAT_FAMILIES,
    families_for_scope,
)
from hstream_tpu_torch.stats.timeseries import (
    DEFAULT_LEVELS,
    INTERVAL_NAMES,
    MultiLevelTimeSeries,
    level_for_window,
)

# ---- metric registry (the .inc analogue: one line per metric) --------------

PER_STREAM_COUNTERS = [
    "append_payload_bytes",    # bytes appended (payload only)
    "append_total",            # append batches
    "append_failed",
    "append_throttled",        # appends refused by quota (flow control)
    "shed_total",              # requests refused by overload shedding
    "delivery_credit_waits",   # push deliveries paused at zero credit
    "record_payload_bytes",    # bytes read out by consumers/queries
    "record_total",            # records read
    "json_decode_native",      # JSON records through libjsondec batch dec
    "json_decode_fallback",    # JSON records through the Python per-record
                               # decode (no toolchain, or CLS_PY rows)
    "join_probe_dispatches",   # device interval-join probe kernel launches
                               # (contract: one per join micro-batch)
    "change_rows_columnar",    # emitted aggregate rows that reached the
                               # sink as a ColumnarEmit batch (no dicts)
    "kernel_recompiles",       # the port's compiles (a kernel-library
                               # build or load, a program-factory miss)
                               # seen by the process-wide RetraceGuard
                               # listener (contract: zero in steady state)
    "query_restarts",          # supervisor-initiated query restarts
                               # (label: query id)
    "snapshot_fallbacks",      # restores that fell back past a corrupt
                               # snapshot slot (label: query id)
    "device_path_fallbacks",   # device-join / fused-close activations
                               # that degraded to the host reference
                               # path (label: source stream)
    "promotions",              # replica promotions driven through this
                               # server (label: "_store")
    "fenced_appends",          # mutations refused NOT_LEADER after the
                               # store was fenced (label: "_store")
    "append_deduped",          # producer-stamped appends answered from
                               # the dedup window (retry landed exactly
                               # once; label: stream)
    "append_columnar_rows",    # rows ingested through the framed
                               # columnar append path (bounds-check +
                               # handoff, no per-record protobuf)
    "late_drops",              # records dropped as late (past
                               # end/gap + grace at the pre-batch
                               # watermark), host-mirror count
                               # (label: query id)
    "device_h2d_bytes",        # host->device bytes on the staging
                               # path (label: source stream)
    "device_d2h_bytes",        # device->host bytes on the close/
                               # changelog drain paths (label: source
                               # stream)
    "factory_recompiles",      # the port's compiles attributed to
                               # the kernel family whose dispatch
                               # triggered them (label: step/close/
                               # probe/session)
    "lock_contention",         # traced-lock acquires that found the
                               # lock taken (locktrace witness armed;
                               # label: lock role name)
    "placement_decisions",     # placer decisions written onto
                               # scheduler/query/* — place, adopt, or
                               # rebalance offer (label: query id)
    "queries_adopted",         # queries this server claimed live via
                               # the heartbeat-lease CAS (try_adopt_
                               # live), boot adoption NOT included
                               # (label: query id)
    "read_extracts",           # pull-query serves that actually ran an
                               # executor peek (read-plane contract:
                               # ~one per view per close cycle, not one
                               # per reader; label: view name)
]

# stream-scoped rate families, in the (name, bucket-widths) tuple
# shape older consumers (GetStats, the __stats__ virtual table) walk;
# the declaration itself lives in stats/families.py — subscription- and
# query-scoped families are reached through the stat_* API only
PER_STREAM_TIME_SERIES = [
    (f.name, tuple(w for w, _n in DEFAULT_LEVELS))
    for f in families_for_scope("stream")
]

# Gauges: point-in-time values sampled from live subsystems. Direct
# sets (gauge_set) and scrape-time sampling callbacks (gauge_fn) share
# one registry; the label dimension is the subsystem's natural key
# (query id, subscription id, follower address, or "" for singletons).
GAUGES = [
    "pipeline_occupancy",     # per running query: encode/step busy frac
    "pipeline_reorder_depth", # per running query: staged-but-unstepped
    "sub_backlog",            # per subscription: tail - committed LSNs
    "credit_inflight",        # per subscription: delivery credits out
    "overload_level",         # shed ladder: 0 admit / 1 defer / 2 reject
    "replica_ack_lag",        # per follower: oplog entries behind
    "store_segment_bytes",    # durable store data footprint on disk
    "store_wal_bytes",        # durable store write-ahead-log footprint
    "running_queries",        # live query tasks on this server
    "event_journal_size",     # entries currently held by the journal
    "crash_loop_open",        # per query: 1 while the supervisor's
                              # crash-loop breaker holds it FAILED
    "replica_epoch",          # leadership epoch of the replicated
                              # store this server fronts
    "dedup_window_size",      # producer-dedup seqs remembered across
                              # all producers (bounded per producer)
    "query_watermark_ms",     # per query: event-time watermark
                              # (absolute ms) of the query's executor
    "query_watermark_lag_ms", # per query: wall clock - watermark (the
                              # Dataflow watermark-lag discipline: how
                              # stale is the answer a reader sees)
    "query_health_level",     # per query: 0 OK / 1 DEGRADED /
                              # 2 STALLED (the health-plane verdict)
    "node_rss_bytes",         # resident set size of this server
                              # process (the federation load signal's
                              # memory axis), sampled at scrape
    "append_inflight",        # framed appends submitted to the append
                              # front but not yet completed (queue
                              # depth across the lanes / completion
                              # queue), sampled at scrape
    "mesh_shards",            # per query: key-axis shard count of the
                              # mesh the executor runs on (absent for
                              # single-chip queries), sampled at scrape
    "placer_node_score",      # per cluster node: the placer's load
                              # score folded from the node's published
                              # record (lower = preferred), sampled at
                              # scrape while node records are fresh
    "device_hbm_bytes",       # per query: device bytes held by the
                              # query's live arenas/stores (exact
                              # nbytes fold), sampled at scrape with
                              # zero added dispatches
    "device_arena_bytes",     # per query+plane ("qid/plane" label,
                              # split at render): device bytes of one
                              # named arena/store plane
    "device_hbm_total_bytes", # process total of device_hbm_bytes
                              # across all live queries
    "device_hbm_backend_bytes",  # bytes-in-use per the backend's own
                              # memory_stats() where the platform
                              # provides it (absent on CPU) — the
                              # allocator-side cross-check of the fold
    "read_cache_hit_ratio",   # read plane: (hits+shared)/(all versioned
                              # serves) of the snapshot cache, sampled
                              # at scrape
    "read_cache_bytes",       # read plane: bytes held by the snapshot +
                              # shared-encode LRU (budget via
                              # --read-cache-bytes), sampled at scrape
]

# Fixed-bucket latency histograms (Prometheus-style cumulative buckets);
# upper bounds in milliseconds, +Inf implied. One label per family:
# `stream` for the RPC families, `stage` for pipeline stage timings.
LATENCY_BUCKETS_MS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0)

# freshness latencies span a wider range than RPCs (a healthy pipeline
# sits in the tens of ms; a stalled one drifts toward minutes), so the
# freshness families get their own bucket ladder topping out at 60s
FRESHNESS_BUCKETS_MS = (
    1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0,
    5000.0, 10000.0, 30000.0, 60000.0)

HISTOGRAMS = [
    # name, bucket upper bounds (ms), label key
    ("append_latency_ms", LATENCY_BUCKETS_MS, "stream"),
    ("fetch_latency_ms", LATENCY_BUCKETS_MS, "subscription"),
    ("sql_execute_latency_ms", LATENCY_BUCKETS_MS, "stmt"),
    ("stage_latency_ms", LATENCY_BUCKETS_MS, "stage"),
    # event-time freshness plane: how stale is the answer a
    # reader sees, and where the milliseconds live
    ("emit_latency_ms", FRESHNESS_BUCKETS_MS, "query"),
    ("append_visible_latency_ms", FRESHNESS_BUCKETS_MS, "consumer"),
    ("freshness_lag_ms", FRESHNESS_BUCKETS_MS, "stage"),
    # per-kernel-family host dispatch time (step/close/probe/session)
    ("kernel_dispatch_ms", LATENCY_BUCKETS_MS, "family"),
    # per-kernel-family DEVICE execution time: a CUDA event pair on
    # the dispatch's stream (the wall clock on the CPU) on a
    # deterministic 1/N dispatch sample (--device-time-sample), next
    # to the host-wall series above
    ("kernel_device_ms", LATENCY_BUCKETS_MS, "family"),
    # lock-order witness ledger: time spent waiting for /
    # holding each named traced lock, armed runs only
    ("lock_wait_ms", LATENCY_BUCKETS_MS, "lock"),
    ("lock_hold_ms", LATENCY_BUCKETS_MS, "lock"),
]

_HIST_BUCKETS = {name: buckets for name, buckets, _label in HISTOGRAMS}
HIST_LABEL_KEYS = {name: label for name, _b, label in HISTOGRAMS}

# per-metric label-series ceiling: RPC labels come from request fields
# (a failed Append still observes its latency), so a client looping
# over random stream names must not grow /metrics without bound —
# past the cap new labels fold into one overflow series
HIST_MAX_LABELS = 512
HIST_OVERFLOW_LABEL = "_overflow"

# the rate-ladder series maps get the same ceiling: a client looping
# over random stream names (a failed Append still notes its bytes)
# must not grow the series map — or /metrics — without bound; past the
# cap new keys fold into one overflow series per family
TS_MAX_LABELS = HIST_MAX_LABELS
TS_OVERFLOW_LABEL = HIST_OVERFLOW_LABEL


class Histogram:
    """Fixed-bucket latency histogram (Prometheus shape): cumulative
    bucket counts rendered at exposition time, plus sum and count for
    the `_sum`/`_count` series. Observe takes the lock — histograms sit
    on RPC boundaries, not per-record hot loops."""

    __slots__ = ("bounds", "counts", "sum", "count", "_lock")

    def __init__(self, bounds: tuple[float, ...]):
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self.counts[i] += 1
            self.sum += value
            self.count += 1

    def snapshot(self) -> tuple[list[int], float, int]:
        """(cumulative bucket counts incl. +Inf, sum, count)."""
        with self._lock:
            counts = list(self.counts)
            total_sum, total = self.sum, self.count
        cum = []
        running = 0
        for c in counts:
            running += c
            cum.append(running)
        return cum, total_sum, total

    def percentile(self, q: float) -> float | None:
        """Bucket-interpolated percentile estimate (None while empty).
        Within a bucket the value is linearly interpolated; the +Inf
        bucket reports its lower bound (the largest finite edge)."""
        cum, _s, total = self.snapshot()
        if total == 0:
            return None
        rank = q / 100.0 * total
        prev_cum = 0
        for i, c in enumerate(cum):
            if c >= rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                if i >= len(self.bounds):
                    return self.bounds[-1]
                hi = self.bounds[i]
                in_bucket = c - prev_cum
                frac = ((rank - prev_cum) / in_bucket) if in_bucket else 1.0
                return lo + (hi - lo) * frac
            prev_cum = c
        return self.bounds[-1]


class _Shard:
    __slots__ = ("counters", "owner")

    def __init__(self, owner: threading.Thread | None = None) -> None:
        self.counters: dict[tuple[str, str], int] = defaultdict(int)
        self.owner = owner


class StatsHolder:
    """newStatsHolder analogue: per-thread counter shards + shared
    time-series, aggregated on read (stats.h:80-118). Shards whose
    owning thread has exited are folded into a retired aggregate on
    read, so short-lived threads (per-query tasks, gRPC workers being
    recycled) cannot grow the shard list forever."""

    def __init__(self) -> None:
        self._local = threading.local()
        self._shards: list[_Shard] = []
        self._shards_lock = threading.Lock()
        self._retired: dict[tuple[str, str], int] = defaultdict(int)
        self._series: dict[tuple[str, str], MultiLevelTimeSeries] = {}
        self._series_lock = threading.Lock()
        # gauges: direct values + scrape-time sampling callbacks; both
        # keyed (metric, label). A dead callback (its subsystem went
        # away) is dropped at the next snapshot instead of erroring.
        self._gauges: dict[tuple[str, str], float] = {}
        self._gauge_fns: dict[tuple[str, str], object] = {}
        self._gauge_lock = threading.Lock()
        # serializes whole scrapes (sample + render): concurrent
        # scrapers (gateway /metrics, --metrics-port exporter, admin
        # verb) share the gauge registry, and an unserialized stale-
        # series sweep could drop a live series a sibling just sampled
        self.scrape_lock = threading.Lock()
        self._hists: dict[tuple[str, str], Histogram] = {}
        self._hist_lock = threading.Lock()

    def _shard(self) -> _Shard:
        sh = getattr(self._local, "shard", None)
        if sh is None:
            sh = _Shard(threading.current_thread())
            self._local.shard = sh
            with self._shards_lock:
                self._shards.append(sh)
        return sh

    def _fold_dead(self) -> tuple[list[_Shard], dict[tuple[str, str], int]]:
        """Fold dead threads' shards into the retired aggregate; return
        (live shards, retired snapshot) captured under one lock so a
        shard can never be counted both live and retired. A dead thread
        can no longer write its shard, so the fold loses no increments."""
        with self._shards_lock:
            live = []
            for sh in self._shards:
                if sh.owner is not None and not sh.owner.is_alive():
                    for key, v in sh.counters.items():
                        self._retired[key] += v
                else:
                    live.append(sh)
            self._shards = live
            return list(live), dict(self._retired)

    # ---- counters ----
    def stream_stat_add(self, metric: str, stream: str, value: int = 1
                        ) -> None:
        if metric not in PER_STREAM_COUNTERS:
            raise KeyError(f"unregistered counter {metric!r}")
        self._shard().counters[(metric, stream)] += value

    def stream_stat_get(self, metric: str, stream: str) -> int:
        shards, retired = self._fold_dead()
        total = retired.get((metric, stream), 0)
        return total + sum(sh.counters.get((metric, stream), 0)
                           for sh in shards)

    def stream_stat_getall(self, metric: str) -> dict[str, int]:
        shards, retired = self._fold_dead()
        out: dict[str, int] = defaultdict(int)
        for (m, stream), v in retired.items():
            if m == metric:
                out[stream] += v
        for sh in shards:
            for (m, stream), v in list(sh.counters.items()):
                if m == metric:
                    out[stream] += v
        return dict(out)

    # ---- rate ladders (declarative stat families) ----
    def _family_series(self, family: str, key: str
                       ) -> MultiLevelTimeSeries:
        """The (family, key) ladder, created from the family table on
        first write. Past TS_MAX_LABELS keys per family, new keys fold
        into the one overflow series — the series map (and /metrics)
        stays bounded no matter what key junk a client sends."""
        if family not in FAMILY_BY_NAME:
            raise KeyError(f"unregistered stat family {family!r}")
        k = (family, key)
        with self._series_lock:
            ts = self._series.get(k)
            if ts is None:
                n = sum(1 for (f, _key) in self._series if f == family)
                if n >= TS_MAX_LABELS:
                    k = (family, TS_OVERFLOW_LABEL)
                    ts = self._series.get(k)
                    if ts is not None:
                        return ts
                ts = MultiLevelTimeSeries()
                self._series[k] = ts
            return ts

    def stat_add(self, family: str, key: str, value: float = 1.0,
                 now: float | None = None) -> None:
        """THE family write path (the reference's `.inc` bump): one
        O(1) ladder add. Call sites are machine-checked against the
        family table by the analyzer's `registry-family` rule."""
        self._family_series(family, key).add(value, now)

    def _peek_series(self, family: str, key: str
                     ) -> MultiLevelTimeSeries | None:
        """Read-only lookup: monitoring reads must not allocate/retain
        state on the holder. An UNREGISTERED family raises the same
        KeyError `_family_series` does: a typo'd dashboard query must
        not read as a silent zero."""
        if family not in FAMILY_BY_NAME:
            raise KeyError(f"unregistered stat family {family!r}")
        with self._series_lock:
            return self._series.get((family, key))

    def stat_rate(self, family: str, key: str, interval="1min",
                  now: float | None = None) -> float:
        ts = self._peek_series(family, key)
        return 0.0 if ts is None else ts.rate(interval, now)

    def stat_sum(self, family: str, key: str, interval="1min",
                 now: float | None = None) -> float:
        ts = self._peek_series(family, key)
        return 0.0 if ts is None else ts.sum(interval, now)

    def stat_avg(self, family: str, key: str, interval="1min",
                 now: float | None = None) -> float:
        ts = self._peek_series(family, key)
        return 0.0 if ts is None else ts.avg(interval, now)

    def stat_count(self, family: str, key: str, interval="1min",
                   now: float | None = None) -> int:
        ts = self._peek_series(family, key)
        return 0 if ts is None else ts.count(interval, now)

    def stat_ladder(self, family: str, key: str,
                    now: float | None = None) -> dict[str, float]:
        """Every interval's rate + all-time sum/count for one series
        (zeros when the key has never been written)."""
        ts = self._peek_series(family, key)
        if ts is None:
            # same shape ladder() returns, derived from the declared
            # interval set so a level rename cannot fork cold keys
            return {**dict.fromkeys(INTERVAL_NAMES, 0.0),
                    "total": 0.0, "total_count": 0.0}
        return ts.ladder(now)

    def stat_keys(self, family: str) -> list[str]:
        """Keys with a live ladder for `family` (exposition and the
        federation fold walk this instead of the series map)."""
        if family not in FAMILY_BY_NAME:
            raise KeyError(f"unregistered stat family {family!r}")
        with self._series_lock:
            return sorted({k for (f, k) in self._series if f == family})

    def stat_drop_stale(self, scope: str, live: set[str]) -> None:
        """Drop every ladder of `scope`-scoped families whose entity
        no longer exists — the gauge `_drop_stale` discipline for the
        family series, run at scrape time. This is also what frees
        TS_MAX_LABELS cap slots: without it, entity churn would
        permanently fill a family's cap with retired keys and fold
        every NEW entity into the overflow series. ONLY the reserved
        overflow fold is exempt — a broader "_" exemption would let a
        client churning "_"-named entities exhaust the cap forever."""
        fams = {f.name for f in families_for_scope(scope)}
        with self._series_lock:
            stale = [k for k in self._series
                     if k[0] in fams and k[1] != TS_OVERFLOW_LABEL
                     and k[1] not in live]
            for k in stale:
                del self._series[k]

    # back-compat shims over the family API (older call sites/tests;
    # `window_s` picks the narrowest level ladder covering it)
    def _ts(self, metric: str, stream: str) -> MultiLevelTimeSeries:
        return self._family_series(metric, stream)

    def time_series_add(self, metric: str, stream: str, value: float
                        ) -> None:
        self.stat_add(metric, stream, value)

    def time_series_get_rate(self, metric: str, stream: str,
                             window_s: int | None = None) -> float:
        return self._family_series(metric, stream).rate(
            level_for_window(window_s or 60))

    def time_series_streams(self, metric: str) -> list[str]:
        return self.stat_keys(metric)

    def time_series_peek_rate(self, metric: str, stream: str,
                              window_s: int | None = None) -> float:
        ts = self._peek_series(metric, stream)
        if ts is None:
            return 0.0
        return ts.rate(level_for_window(window_s or 60))

    # ---- gauges ----
    def gauge_set(self, metric: str, label: str, value: float) -> None:
        if metric not in GAUGES:
            raise KeyError(f"unregistered gauge {metric!r}")
        with self._gauge_lock:
            self._gauges[(metric, label)] = float(value)

    def gauge_fn(self, metric: str, label: str, fn) -> None:
        """Register a scrape-time sampler: fn() -> float. Re-registering
        the same (metric, label) replaces the previous sampler."""
        if metric not in GAUGES:
            raise KeyError(f"unregistered gauge {metric!r}")
        with self._gauge_lock:
            self._gauge_fns[(metric, label)] = fn

    def gauge_drop(self, metric: str, label: str) -> None:
        """Remove a gauge value/sampler (its subsystem went away)."""
        with self._gauge_lock:
            self._gauges.pop((metric, label), None)
            self._gauge_fns.pop((metric, label), None)

    def gauge_labels(self, metric: str) -> list[str]:
        """Labels currently held for one gauge metric (values + fns)."""
        with self._gauge_lock:
            return sorted({label for (m, label) in
                           list(self._gauges) + list(self._gauge_fns)
                           if m == metric})

    def gauges_snapshot(self) -> dict[tuple[str, str], float]:
        """All gauges: direct values plus sampled callbacks. A sampler
        that raises is dropped (its subsystem died between scrapes) —
        monitoring never propagates subsystem errors."""
        with self._gauge_lock:
            out = dict(self._gauges)
            fns = list(self._gauge_fns.items())
        dead = []
        for key, fn in fns:
            try:
                out[key] = float(fn())
            except Exception:  # noqa: BLE001 — scrape must survive
                dead.append(key)
        if dead:
            with self._gauge_lock:
                for key in dead:
                    self._gauge_fns.pop(key, None)
        return out

    # ---- histograms ----
    def _hist(self, metric: str, label: str) -> Histogram:
        if metric not in _HIST_BUCKETS:
            raise KeyError(f"unregistered histogram {metric!r}")
        key = (metric, label)
        with self._hist_lock:
            h = self._hists.get(key)
            if h is None:
                n = sum(1 for (m, _l) in self._hists if m == metric)
                if n >= HIST_MAX_LABELS:
                    key = (metric, HIST_OVERFLOW_LABEL)
                    h = self._hists.get(key)
                    if h is not None:
                        return h
                h = Histogram(_HIST_BUCKETS[metric])
                self._hists[key] = h
            return h

    def observe(self, metric: str, label: str, value_ms: float) -> None:
        self._hist(metric, label).observe(value_ms)

    def histograms_snapshot(self) -> dict[tuple[str, str], Histogram]:
        with self._hist_lock:
            return dict(self._hists)

    def histogram_percentile(self, metric: str, label: str,
                             q: float) -> float | None:
        """Percentile estimate over every series of `metric` when label
        is ""; otherwise the one labeled series. None while empty."""
        if metric not in _HIST_BUCKETS:
            raise KeyError(f"unregistered histogram {metric!r}")
        with self._hist_lock:
            if label:
                hists = [h for k, h in self._hists.items()
                         if k == (metric, label)]
            else:
                hists = [h for (m, _l), h in self._hists.items()
                         if m == metric]
        if not hists:
            return None
        if len(hists) == 1:
            return hists[0].percentile(q)
        merged = Histogram(_HIST_BUCKETS[metric])
        for h in hists:
            with h._lock:
                for i, c in enumerate(h.counts):
                    merged.counts[i] += c
                merged.sum += h.sum
                merged.count += h.count
        return merged.percentile(q)

    # ---- convenience for the append/read hot paths ----
    def note_append(self, stream: str, n_records: int, n_bytes: int) -> None:
        self.stream_stat_add("append_total", stream)
        self.stream_stat_add("append_payload_bytes", stream, n_bytes)
        self.stat_add("append_in_bytes", stream, float(n_bytes))
        self.stat_add("append_in_records", stream, float(n_records))

    def note_read(self, stream: str, n_records: int, n_bytes: int) -> None:
        self.stream_stat_add("record_total", stream, n_records)
        self.stream_stat_add("record_payload_bytes", stream, n_bytes)
        self.stat_add("record_bytes", stream, float(n_bytes))
        self.stat_add("read_out_records", stream, float(n_records))
