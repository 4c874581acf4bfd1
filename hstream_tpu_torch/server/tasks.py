"""Managed continuous-query tasks.

The reference runs each continuous query as a forked green thread: a
checkpointed reader polls the source stream(s), every record walks the
processor DAG, and sink processors append results downstream
(runTaskWrapper, Handler/Common.hs:169-180; runTask, Processor.hs:99-144).

Here a task is one daemon thread per query driving the batched engine:
read a chunk from the checkpointed reader -> decode JSON records ->
executor.process (the lattice step's kernels) -> emit rows to the sink
callback -> checkpoint.

Checkpointing improves on the reference (which checkpoints readers only
— operator state is in-memory, so its restarts undercount every window
spanning them, Codegen.hs:374-385): read positions are committed ONLY
paired with an operator-state snapshot, in one atomic meta-KV write
(engine.snapshot). Resume restores the state and continues from the
paired LSNs — exact, modulo at-least-once re-emission of rows sunk
after the last snapshot.
"""

# A copy of hstream_tpu/server/tasks.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import json
import queue
import threading
import time
import traceback
from typing import Any, Callable

import numpy as np

from hstream_tpu_torch.common import columnar, jsondec, locktrace
from hstream_tpu_torch.common import records as rec
from hstream_tpu_torch.common.faultinject import FAULTS
from hstream_tpu_torch.common.logger import get_logger
from hstream_tpu_torch.common.tracing import QueryTracer, trace_span
from hstream_tpu_torch.device import handoff, receive
from hstream_tpu_torch.engine.pipeline import IngestPipeline
from hstream_tpu_torch.engine.snapshot import (
    capture_executor,
    open_blob,
    restore_executor,
    seal_blob,
    serialize_capture,
)
from hstream_tpu_torch.server.context import (
    DEFAULT_ENCODE_WORKERS,
    DEFAULT_PIPELINE_DEPTH,
)
from hstream_tpu_torch.server.persistence import QueryInfo, TaskStatus
from hstream_tpu_torch.store.api import LSN_MIN, DataBatch
from hstream_tpu_torch.store.checkpoint import CheckpointedReader
from hstream_tpu_torch.store.streams import StreamType

log = get_logger("tasks")

SinkFn = Callable[[list[dict[str, Any]]], None]

READ_CHUNK = 2048
POLL_TIMEOUT_MS = 50
PREFETCH_BATCHES = 2  # read-ahead depth of the reader prefetch thread


def snapshot_key(query_id: str) -> str:
    """Meta-KV key holding a query's operator-state snapshot: either a
    legacy raw npz blob (older servers) or a pointer to the
    current slot of the two-slot rotation."""
    return f"qsnap/{query_id}"


def snapshot_slot_key(query_id: str, slot: int) -> str:
    """One slot of the two-slot last-good snapshot rotation."""
    return f"qsnap/{query_id}@{slot}"


# pointer payload: magic + JSON {"slot": 0|1}. Written AFTER the slot
# blob, so a crash (or torn write) between the two leaves the pointer
# at the previous good slot.
SNAP_PTR_MAGIC = b"HSPTR1"


def parse_snapshot_pointer(raw: bytes) -> int | None:
    """Slot named by a two-slot rotation pointer, or None when ``raw``
    is not a pointer (legacy direct blob). A corrupt pointer parses to
    slot 0 — restore walks both slots anyway. The ONE place pointer
    bytes are interpreted: restore and the admin `snapshots` verb must
    never disagree on which slot is current."""
    if not raw.startswith(SNAP_PTR_MAGIC):
        return None
    try:
        return int(json.loads(raw[len(SNAP_PTR_MAGIC):])["slot"]) & 1
    except (ValueError, KeyError, TypeError):
        return 0


class QueryTask(threading.Thread):
    """One continuous query: source stream(s) -> executor -> sink rows."""

    # state snapshot + checkpoint cadence; tests lower it
    snapshot_interval_ms: int = 1000

    def __init__(self, ctx, info: QueryInfo, plan, sink: SinkFn, *,
                 from_beginning: bool = True):
        super().__init__(name=f"query-{info.query_id}", daemon=True)
        self.ctx = ctx
        self.info = info
        self.plan = plan
        self.from_beginning = from_beginning
        # per-context override wins over the class default (main.serve)
        ctx_iv = getattr(ctx, "snapshot_interval_ms", None)
        if ctx_iv is not None:
            self.snapshot_interval_ms = ctx_iv
        self.executor = None
        self.error: BaseException | None = None
        # serializes executor state mutation (this thread) against pull
        # queries peeking live state from gRPC threads (views.snapshot).
        # Named + traced: this is the busiest cross-object
        # lock in the server — the canonical order (tasks.state before
        # views.materialization / pipeline internals) is what the
        # armed witness certifies
        self.state_lock = locktrace.rlock("tasks.state")
        # optional sink-side state riding in the snapshot (a view's
        # closed-row materialization survives restarts this way)
        self.sink_dump: Callable[[], Any] | None = None
        self.sink_load: Callable[[Any], None] | None = None
        self._stop_ev = threading.Event()
        # readiness: set once the reader is attached to every source at
        # its start LSN — tests and callers wait on this instead of
        # sleeping (the notification mechanism the reference's test tier
        # lacks: "FIXME: requires a notification mechanism",
        # RunSQLSpec.hs:54)
        self.attached = threading.Event()
        self.attached_lsns: dict[int, int] = {}  # logid -> start LSN
        self._sources: dict[int, str] = {}  # logid -> stream name
        for name in self.source_streams():
            self._sources[ctx.streams.get_logid(name)] = name
        self._reader: CheckpointedReader | None = None
        # overlapped ingest: wire-encode + upload on a pool of worker
        # threads while this thread dispatches earlier batches' steps
        # in order (engine.pipeline); created lazily for executors with
        # a staged columnar path (plain aggregates — joins/sessions
        # stay on the row path)
        self._pipe: IngestPipeline | None = None
        self.pipeline_depth = int(getattr(ctx, "pipeline_depth",
                                          DEFAULT_PIPELINE_DEPTH))
        self.encode_workers = int(getattr(ctx, "encode_workers",
                                          DEFAULT_ENCODE_WORKERS))
        # reader prefetch (the HStreamDB layer-0/1 producer/consumer
        # split): a read-ahead thread polls the store so JSON decode +
        # encode of chunk N+1 overlaps the device work of chunk N
        self._read_q: queue.Queue = queue.Queue(maxsize=PREFETCH_BATCHES)
        self._read_thread: threading.Thread | None = None
        # always-on per-stage timing rings (SURVEY §5.1); every span
        # also lands in the holder's stage_latency_ms histogram so
        # /metrics carries per-stage percentiles across all queries
        self.tracer = QueryTracer(observer=self._observe_stage)
        self._pending_ckps: dict[int, int] = {}  # processed, not committed
        self._last_flow_feed = 0.0  # overload-signal feed rate limit
        self._flow_chunks = 0       # warmup chunks skipped (kernel build)
        self._join_probe_seen = 0   # join probe dispatches mirrored out
        self._last_snapshot_ms = 0.0
        self._last_persist_ms = 0.0   # cost of the last state write
        self._last_inline_ms = 0.0    # capture-side stall of last snap
        # condition over a traced re-entrant lock: waits release the
        # lock through the wrapper, so the held-set stays truthful
        self._persist_cv = threading.Condition(
            locktrace.rlock("tasks.persist"))
        self._persist_pending = None  # latest un-persisted capture
        self._persist_busy = False
        self._persist_stop = False
        self._persist_thread: threading.Thread | None = None
        self._dirty = False
        self._crash = False
        self._detach = False
        # two-slot snapshot rotation: next slot to write (restore sets
        # it to the OTHER slot than the one it loaded, so the last
        # known-good snapshot is never the one being overwritten)
        self._snap_slot = 0
        # device-fallback mirror: engine executors count activations
        # that degraded to the host reference path on themselves;
        # deltas land in the device_path_fallbacks counter
        self._dev_fallback_seen = 0
        # engine-counter mirrors: late drops + H2D/D2H
        # bytes, delta-based like the fallback mirror
        self._late_seen = 0
        self._h2d_seen = 0
        self._d2h_seen = 0
        # multi-chip plane: shard_map dispatch mirror (a
        # JoinExecutor's property already folds its inner aggregate,
        # so the mirror reads the executor attr directly — NEVER via
        # engine_total, which would double-count the inner)
        self._sharded_seen = 0
        # event-time freshness plane: the publish-time
        # watermark of ingested records (max record append/publish ms
        # seen) and the wall clock when it was picked up — emission
        # observes append->visible and per-stage lag from these, all
        # host values (zero added dispatches/fetches)
        self._publish_wm_ms = -1
        self._pickup_wall_ms = 0.0
        # every emission flows through the freshness-instrumented sink
        self.sink = self._wrap_sink(sink)

    def _observe_stage(self, stage: str, seconds: float) -> None:
        stats = getattr(self.ctx, "stats", None)
        if stats is not None:
            try:
                stats.observe("stage_latency_ms", stage, seconds * 1e3)
            except Exception:  # noqa: BLE001 — metrics must not kill
                pass           # the ingest loop

    def _observe_kernel(self, family: str, seconds: float) -> None:
        """Engine dispatch observer: per-kernel-family host
        dispatch time (step/close/probe/session) into /metrics."""
        stats = getattr(self.ctx, "stats", None)
        if stats is not None:
            try:
                stats.observe("kernel_dispatch_ms", family,
                              seconds * 1e3)
            except Exception:  # noqa: BLE001 — metrics must not kill
                pass           # the ingest loop

    # ---- event-time freshness plane -----------------------------

    def _wrap_sink(self, sink: SinkFn) -> SinkFn:
        """Freshness-instrumented sink: every emission observes
        append->visible latency (publish-time watermark -> now, the
        end-to-end number for views and sink streams), the engine-stage
        lag (wall since the publish watermark's pickup), and the close
        cycle's event-time emit latency — host arithmetic only. The
        original sink's durability barrier (`flush`) rides through."""
        stats = getattr(self.ctx, "stats", None)
        if stats is None:
            return sink

        def wrapped(rows):
            sink(rows)
            if rows is not None and len(rows):
                self._note_emit_freshness(stats, rows)

        flush = getattr(sink, "flush", None)
        if flush is not None:
            wrapped.flush = flush
        return wrapped

    def _note_emit_freshness(self, stats, rows) -> None:
        now = time.time() * 1e3
        qid = self.info.query_id
        try:
            # per-query emission ladder: rows on the wire
            # and completed close cycles — the query-scoped stat
            # families the federation fold and `admin stats queries`
            # serve
            stats.stat_add("emit_rows", qid, float(len(rows)))
            stats.stat_add("close_cycles", qid)
        except Exception:  # noqa: BLE001 — metrics must not kill emit
            pass
        try:
            if self._publish_wm_ms >= 0:
                # append -> visible: the emitted answer now reflects
                # (at least) everything published up to the watermark
                stats.observe("append_visible_latency_ms", qid,
                              max(0.0, now - self._publish_wm_ms))
                # engine stage: pickup of the newest ingested records
                # -> rows on the wire (pipeline depth + device work)
                stats.observe("freshness_lag_ms", "engine",
                              max(0.0, now - self._pickup_wall_ms))
            wm = self._event_watermark()
            win_end = _max_win_end(rows)
            if wm is not None:
                # emit latency: max event time the emitted rows can
                # cover (their window end, capped at the watermark —
                # the host mirror of "max event ts in the close
                # cycle") -> wall at emission
                ref = wm if win_end is None else min(win_end, wm)
                stats.observe("emit_latency_ms", qid,
                              max(0.0, now - ref))
        except Exception:  # noqa: BLE001 — metrics must not kill
            pass           # the emit path

    def _event_watermark(self) -> int | None:
        """The executor's event-time watermark (host attribute,
        whichever engine): fixed windows track watermark_abs, sessions
        and joins track watermark. The ONE place that fold lives —
        the freshness gauges and the health plane both read it here."""
        with self.state_lock:  # executor is guarded (hstream-analyze)
            ex = self.executor
        if ex is None:
            return None
        wm = getattr(ex, "watermark_abs", None)
        if wm is None:
            wm = getattr(ex, "watermark", None)
        if wm is None or wm < 0:
            return None
        return int(wm)

    def read_version(self) -> tuple | None:
        """The executor's read-plane version tuple — what
        the read cache validates snapshot hits against. None while no
        executor runs or the engine carries no versioning (stateless):
        such state never caches."""
        with self.state_lock:  # executor is guarded (hstream-analyze)
            ex = self.executor
        if ex is None:
            return None
        fn = getattr(ex, "read_version", None)
        return None if fn is None else fn()

    def engine_total(self, attr: str) -> int:
        """Sum a host counter over the executor AND a join's lazily
        created inner aggregate (device_fallbacks, late_drops) — the
        one fold the /metrics mirror and the health plane share."""
        with self.state_lock:  # executor is guarded (hstream-analyze)
            ex = self.executor
        if ex is None:
            return 0
        total = int(getattr(ex, attr, 0))
        inner = getattr(ex, "_inner", None)
        if inner is not None:
            total += int(getattr(inner, attr, 0))
        return total

    def device_plane_bytes(self) -> dict[str, int]:
        """Exact live device bytes per engine plane — the HBM
        accounting fold devicecost.sample_device_gauges scrapes. Zero
        dispatches, zero fetches: nbytes is shape metadata."""
        with self.state_lock:  # executor is guarded (hstream-analyze)
            ex = self.executor
        if ex is None:
            return {}
        fn = getattr(ex, "device_plane_bytes", None)
        if fn is None:
            return {}
        try:
            return fn()
        except Exception:  # noqa: BLE001 — a half-built executor must
            return {}      # not kill the stats sweep

    def mesh_shards(self) -> int:
        """Key-axis size of the running executor's mesh, 0 when the
        query executes single-chip (no mesh, or a mesh whose key axis
        is 1 — the executors only build sharded lattices for >1)."""
        with self.state_lock:  # executor is guarded (hstream-analyze)
            ex = self.executor
        if ex is None:
            return 0
        mesh = getattr(ex, "mesh", None)
        if mesh is None:
            mesh = getattr(ex, "_mesh", None)  # ShardedQueryExecutor
        if mesh is None:
            return 0
        axis = getattr(ex, "key_axis", None) \
            or getattr(ex, "_key_axis", "key")
        try:
            if axis not in mesh.axis_names:
                return 0
            n = int(mesh.shape[axis])
        except Exception:  # noqa: BLE001 — a half-built mesh must not
            return 0       # kill the stats sweep
        return n if n > 1 else 0

    def _note_ingest_freshness(self, publish_ms: int) -> None:
        """Called once per ingested chunk with the chunk's max record
        publish/append time: advances the publish watermark (+ its
        pickup wall clock) and observes the ingest-stage lag (time the
        records sat in the store + read path)."""
        now = time.time() * 1e3
        if publish_ms > self._publish_wm_ms:
            self._publish_wm_ms = publish_ms
            self._pickup_wall_ms = now
        stats = getattr(self.ctx, "stats", None)
        if stats is not None:
            try:
                stats.observe("freshness_lag_ms", "ingest",
                              max(0.0, now - publish_ms))
            except Exception:  # noqa: BLE001 — metrics must not kill
                pass           # the ingest loop

    def _journal(self, kind: str, message: str, **fields) -> None:
        events = getattr(self.ctx, "events", None)
        if events is not None:
            try:
                events.append(kind, message, **fields)
            except Exception:  # noqa: BLE001
                pass

    def _count_stat(self, metric: str) -> None:
        """Bump a per-query counter (label = query id); never fatal."""
        stats = getattr(self.ctx, "stats", None)
        if stats is not None:
            try:
                stats.stream_stat_add(metric, self.info.query_id)
            except Exception:  # noqa: BLE001 — metrics must not kill
                pass           # recovery paths

    def _note_decode(self, metric: str, logid: int, n: int) -> None:
        """Count records through the native libjsondec batch decoder vs
        the per-record Python fallback, per source stream — the /metrics
        evidence that the JSON append path actually hits the native
        decoder (server_json_eps regressions otherwise hide a silent
        fallback)."""
        stats = getattr(self.ctx, "stats", None)
        if stats is None or n <= 0:
            return
        try:
            stats.stream_stat_add(metric, self._sources[logid], n)
        except Exception:  # noqa: BLE001 — metrics must not kill ingest
            pass

    def source_streams(self) -> list[str]:
        names = [self.plan.source]
        if self.plan.join is not None:
            names.append(self.plan.join.right.name)
        return names

    @property
    def is_join(self) -> bool:
        return self.plan.join is not None

    # ---- lifecycle ---------------------------------------------------------

    def stop(self, timeout: float = 10.0, *, crash: bool = False,
             detach: bool = False) -> None:
        """Stop modes:
        default — user-initiated terminate: final snapshot + TERMINATED.
        detach=True — server shutdown: final snapshot but status stays
        RUNNING so boot-time resume_persisted relaunches the query.
        crash=True — fault injection (tests): no snapshot, no status
        update, like a killed process; resume replays from the last
        periodic snapshot."""
        if crash:
            self._crash = True
        if detach:
            self._detach = True
        self._stop_ev.set()
        if self.is_alive():
            self.join(timeout)

    def run(self) -> None:
        ctx = self.ctx
        try:
            reader = CheckpointedReader(
                f"query-{self.info.query_id}",
                ctx.store.new_reader(max_logs=len(self._sources)),
                ctx.ckp_store)
            self._reader = reader
            reader.set_timeout(POLL_TIMEOUT_MS)
            resumed = self._restore_state()
            for logid in self._sources:
                if resumed is not None and logid in resumed:
                    start = resumed[logid] + 1
                    reader.start_reading(logid, start)
                else:
                    start = reader.start_reading_from_checkpoint(
                        logid, LSN_MIN)
                self.attached_lsns[logid] = start
            ctx.persistence.set_query_status(self.info.query_id,
                                             TaskStatus.RUNNING)
            self.attached.set()
            self._read_thread = threading.Thread(
                target=self._read_loop, args=(reader,),
                name=f"read-{self.info.query_id}", daemon=True)
            self._read_thread.start()
            while not self._stop_ev.is_set():
                try:
                    results = self._read_q.get(
                        timeout=POLL_TIMEOUT_MS / 1000)
                except queue.Empty:
                    results = None
                if isinstance(results, BaseException):
                    raise results  # reader died on the prefetch thread
                if not results:
                    # idle tick: finish any staged-but-unprocessed
                    # batches so emitted rows lag ingest by at most one
                    # poll cycle, then drain deferred changelog fetches
                    self._drain_pipe()
                    self._flush_deferred_changes()
                    self._maybe_snapshot()
                    # idle = not overloaded: zero samples decay the
                    # latency EWMA so the shed level recovers
                    self._feed_flow_signals(0.0)
                    continue
                if FAULTS.active:  # chaos: crash mid-batch — the chunk
                    # is read but neither processed nor checkpointed
                    FAULTS.point("task.step")
                t_step = time.perf_counter()
                self._ingest_results(results)
                self._feed_flow_signals(time.perf_counter() - t_step)
                for r in results:
                    lsn = (r.lsn if isinstance(r, DataBatch) else r.hi_lsn)
                    if lsn > self._pending_ckps.get(r.logid, 0):
                        self._pending_ckps[r.logid] = lsn
                        self._dirty = True
                self._maybe_snapshot()
            if not self._crash:
                # graceful stop: final snapshot persists INLINE so state
                # is durable before the thread exits
                self._snapshot_now(sync=True)
                if not self._detach:
                    ctx.persistence.set_query_status(
                        self.info.query_id, TaskStatus.TERMINATED)
            # detach (server shutdown) and crash both leave status
            # RUNNING so boot-time resume_persisted relaunches the query
        except BaseException as e:  # noqa: BLE001 — status must reflect death
            self.error = e
            log.error("query %s died: %s\n%s", self.info.query_id, e,
                      traceback.format_exc())
            self._journal("query_died",
                          f"query {self.info.query_id} died: "
                          f"{type(e).__name__}: {e}",
                          query=self.info.query_id,
                          error=type(e).__name__)
            try:
                ctx.persistence.set_query_status(self.info.query_id,
                                                 TaskStatus.CONNECTION_ABORT)
            except Exception:
                pass
            # self-healing: hand the death to the supervisor UNLESS a
            # stop was requested (an operator stop racing an error must
            # not resurrect the query)
            sup = getattr(ctx, "supervisor", None)
            if sup is not None and not self._stop_ev.is_set():
                try:
                    sup.note_death(self.info, e)
                except Exception:  # noqa: BLE001 — supervision must
                    pass           # not mask the original death
        finally:
            t = self._read_thread
            if t is not None:
                # the prefetch thread watches _stop_ev; reap it BEFORE
                # the persist worker so no reader call races teardown
                self._stop_ev.set()
                t.join(timeout=10)
            with self._persist_cv:
                self._persist_stop = True
                self._persist_cv.notify_all()
            t = self._persist_thread
            if t is not None:
                # reap the persist worker HERE, not at interpreter
                # teardown: a daemon thread caught mid device fetch
                # during runtime destruction aborts the process
                t.join(timeout=10)
            with self.state_lock:
                pipe = self._pipe
            if pipe is not None:
                pipe.close()
            ctx.running_queries.pop(self.info.query_id, None)

    def _read_loop(self, reader: CheckpointedReader) -> None:
        """Prefetch thread: poll the store ahead of the ingest loop so
        the next chunk's bytes are in hand while the current chunk
        decodes/encodes/computes. Read errors travel to the task thread
        as a sentinel (raised at its next get). Only reader.read runs
        here — checkpoint writes stay on the task/persist threads."""
        while not self._stop_ev.is_set():
            try:
                results = reader.read(READ_CHUNK)
            except BaseException as e:  # noqa: BLE001 — surfaced on
                # the task thread; this thread must not die silently
                results = e
            while not self._stop_ev.is_set():
                try:
                    self._read_q.put(results, timeout=0.25)
                    break
                except queue.Full:
                    continue
            if isinstance(results, BaseException):
                return

    def _feed_flow_signals(self, step_s: float) -> None:
        """Feed the overload detector the signals this task produces:
        per-chunk step latency every chunk (an EWMA update, cheap), and
        pipeline occupancy + reorder-ring depth at ~1 Hz (stats() walks
        the stage rings)."""
        self._note_device_fallbacks()
        flow = getattr(self.ctx, "flow", None)
        if flow is None:
            return
        if step_s > 0.0 and self._flow_chunks < 5:
            # warmup: the first real chunks pay the kernel build (seconds
            # on a cold cache) — steady-state overload they are not; idle
            # zero-samples don't consume the warmup budget
            self._flow_chunks += 1
            return
        det = flow.overload
        qid = self.info.query_id  # per-source EWMA: tasks don't blend
        det.note("step_latency_ms", step_s * 1000.0, source=qid)
        with self.state_lock:  # _pipe is guarded (hstream-analyze)
            pipe = self._pipe
        if pipe is None:
            return
        now = time.monotonic()
        if now - self._last_flow_feed < 1.0:
            return
        self._last_flow_feed = now
        st = pipe.stats()
        det.note("pipeline_occupancy",
                 max(st.get("encode_occupancy", 0.0),
                     st.get("step_occupancy", 0.0)), source=qid)
        det.note("reorder_depth",
                 pipe.pending / max(self.pipeline_depth, 1), source=qid)

    def _note_device_fallbacks(self) -> None:
        """Mirror engine-side counters into /metrics, delta-based,
        once per chunk/idle tick: device->host path degradations (join
        activation / fused close falling back to the reference path),
        late-record drops, and H2D/D2H transfer bytes — all plain host
        counters the executors maintain on themselves."""
        with self.state_lock:  # executor is guarded (hstream-analyze)
            ex = self.executor
        if ex is None:
            return
        inner = getattr(ex, "_inner", None)
        stats = getattr(self.ctx, "stats", None)
        if inner is not None \
                and getattr(inner, "dispatch_observer", 1) is None:
            # a join's downstream aggregate is created lazily — wire
            # its dispatch observer the first time it appears
            inner.dispatch_observer = self._observe_kernel

        def transfer(key: str) -> int:
            cur = int(getattr(ex, "transfer_stats", {}).get(key, 0))
            if inner is not None:
                cur += int(getattr(inner, "transfer_stats",
                                   {}).get(key, 0))
            return cur

        cur = self.engine_total("device_fallbacks")
        delta = cur - self._dev_fallback_seen
        if delta > 0 and stats is not None:
            self._dev_fallback_seen = cur
            try:
                stats.stream_stat_add("device_path_fallbacks",
                                      self.plan.source, delta)
            except Exception:  # noqa: BLE001 — metrics must not kill
                pass           # the ingest loop
        if stats is None:
            return
        try:
            late = self.engine_total("late_drops")
            if late > self._late_seen:
                stats.stream_stat_add("late_drops", self.info.query_id,
                                      late - self._late_seen)
                self._late_seen = late
            h2d = transfer("h2d_bytes")
            if h2d > self._h2d_seen:
                stats.stream_stat_add("device_h2d_bytes",
                                      self.plan.source,
                                      h2d - self._h2d_seen)
                self._h2d_seen = h2d
            d2h = transfer("d2h_bytes")
            if d2h > self._d2h_seen:
                stats.stream_stat_add("device_d2h_bytes",
                                      self.plan.source,
                                      d2h - self._d2h_seen)
                self._d2h_seen = d2h
            # shard_map dispatches: read the executor attr
            # directly — JoinExecutor.sharded_dispatches is a property
            # that already folds its inner aggregate, so engine_total
            # would double-count it
            sd = int(getattr(ex, "sharded_dispatches", 0) or 0)
            if sd > self._sharded_seen:
                stats.stat_add("sharded_dispatches",
                               self.info.query_id,
                               float(sd - self._sharded_seen))
                self._sharded_seen = sd
        except Exception:  # noqa: BLE001 — metrics must not kill
            pass           # the ingest loop

    # ---- operator-state checkpointing --------------------------------------

    def _snapshot_candidates(self) -> list[tuple[str, bytes]]:
        """(label, sealed bytes) restore candidates, best first: the
        pointed-at slot, then the other slot (the previous good
        snapshot), or the single legacy blob."""
        qid = self.info.query_id
        raw = self.ctx.store.meta_get(snapshot_key(qid))
        if raw is None:
            return []
        slot = parse_snapshot_pointer(raw)
        if slot is None:
            return [("legacy", raw)]
        out = []
        for s in (slot, 1 - slot):
            data = self.ctx.store.meta_get(snapshot_slot_key(qid, s))
            if data is not None:
                out.append((f"slot {s}", data))
        return out

    def _restore_state(self) -> dict[int, int] | None:
        """Restore executor + sink state from the last snapshot. Returns
        the read positions the state corresponds to (logid -> committed
        LSN), or None when starting fresh.

        Integrity hardening: snapshot blobs are CRC-sealed
        and written to a two-slot rotation. A corrupt/torn newest slot
        journals ``snapshot_corrupt``, bumps ``snapshot_fallbacks`` and
        falls back to the previous good slot — restoring older state +
        its paired (older) checkpoints, so the gap REPLAYS instead of
        the query dying at boot. When every candidate is corrupt the
        checkpoints are removed too (rewind to the trim point) — a
        fresh aggregation beats a boot failure, and beats silently
        skipping the span the lost state covered."""
        qid = self.info.query_id
        candidates = self._snapshot_candidates()
        if not candidates:
            return None
        ex = extra = None
        for i, (label, sealed) in enumerate(candidates):
            try:
                blob = open_blob(sealed)
                if FAULTS.active:  # chaos: provoke a restore failure
                    FAULTS.point("snapshot.restore")
                with self.state_lock:
                    ex, extra = restore_executor(
                        self.plan, blob, mesh=self._query_mesh(),
                        device=self.ctx.device)
            except Exception as e:  # noqa: BLE001 — corrupt blob,
                # injected fault, or a restore bug: fall back rather
                # than die at boot
                log.error("query %s: snapshot %s unrestorable (%s); "
                          "falling back", qid, label, e)
                self._journal(
                    "snapshot_corrupt",
                    f"query {qid}: snapshot {label} unrestorable "
                    f"({type(e).__name__}: {e})",
                    query=qid, candidate=label, error=type(e).__name__)
                self._count_stat("snapshot_fallbacks")
                continue
            if label.startswith("slot"):
                # next persist must overwrite the OTHER slot, keeping
                # the one that just proved restorable
                self._snap_slot = 1 - int(label.split()[1])
            break
        if ex is None:
            # every candidate corrupt: rewind-from-trim-point — drop
            # the checkpoint mirror so the reader starts at its
            # fallback LSN and re-aggregates
            log.error("query %s: NO restorable snapshot (%d candidates)"
                      "; rewinding to trim point", qid, len(candidates))
            if self._reader is not None:
                self._reader.remove_checkpoints()
            return None
        with self.state_lock:
            self.executor = self._tune_executor(ex)
            if self.sink_load is not None and "sink" in extra:
                self.sink_load(extra["sink"])
        ckps = {int(k): int(v) for k, v in extra.get("ckps", {}).items()}
        self._pending_ckps = dict(ckps)
        # re-mirror to the ckp store: a crash between meta_put and
        # write_checkpoints leaves the observability mirror stale until
        # the next append; the blob's ckps are authoritative either way
        if self._reader is not None and self._pending_ckps:
            self._reader.write_checkpoints(self._pending_ckps)
        self._last_snapshot_ms = time.monotonic() * 1000
        log.info("query %s resumed from snapshot at %s",
                 self.info.query_id, ckps)
        return ckps

    def _flush_deferred_changes(self) -> None:
        """Drain deferred changelog extracts (queued, async-drain, or
        join-coalesced) AND deferred session closes to the sink — idle
        ticks and pre-snapshot; the snapshot guards require an empty
        queue on both surfaces."""
        with self.state_lock:  # executor is guarded (hstream-analyze)
            ex = self.executor
        if ex is None:
            return
        hp = getattr(ex, "has_pending_changes", None)
        pending = (hp() if hp is not None
                   else bool(getattr(ex, "_pending_changes", None)))
        hc = getattr(ex, "has_pending_closes", None)
        pending = pending or (hc is not None and hc())
        if not pending:
            return
        with self.state_lock:
            with trace_span(self.tracer, "close"):
                rows = ex.flush_changes()
            if rows:
                with trace_span(self.tracer, "emit"):
                    self.sink(rows)

    def _maybe_snapshot(self) -> None:
        if not self._dirty:
            return
        now = time.monotonic() * 1000
        # cadence scales with the measured cost of a snapshot — both
        # the inline stall (pipeline barrier + capture + sink flush)
        # and the background persist — so snapshotting never consumes
        # more than ~5% of wall time at ANY state size (SURVEY §7
        # item 8). Bigger state => rarer
        # snapshots => longer replay-on-crash, the LogDevice trade.
        cost = self._last_inline_ms + self._last_persist_ms
        interval = max(self.snapshot_interval_ms, 19.0 * cost)
        if now - self._last_snapshot_ms >= interval:
            # snapshots are background work: shed them first under
            # overload — but never past 8x cadence, so replay-on-crash
            # stays bounded even through a sustained overload episode
            flow = getattr(self.ctx, "flow", None)
            if (flow is not None
                    and now - self._last_snapshot_ms < 8.0 * interval
                    and flow.admit_background("snapshot") > 0.0):
                return
            t0 = time.monotonic()
            self._snapshot_now()
            self._last_inline_ms = (time.monotonic() - t0) * 1000

    def _snapshot_now(self, *, sync: bool = False) -> None:
        # pipeline barrier FIRST: _pending_ckps covers every submitted
        # batch, so the captured state must too — read positions never
        # advance past durable state
        self._drain_pipe()
        self._flush_deferred_changes()
        with trace_span(self.tracer, "snapshot"):
            self._snapshot_now_inner(sync=sync)

    def _snapshot_now_inner(self, *, sync: bool = False) -> None:
        """Atomically persist (operator state, read checkpoints): one
        meta-KV write. Read positions NEVER advance past durable state —
        the reference's failure mode (commit-then-lose-state undercount)
        cannot happen. The ckp store mirrors the LSNs for observability.

        The task thread only CAPTURES (a consistent device-side
        reference under the lock — cheap); serialization (the full
        device->host state fetch + npz pack) and the store writes run
        on a latest-wins background worker so sustained ingest never
        stalls on snapshot size. sync=True (final snapshot on stop)
        persists inline after draining the worker."""
        if not self._dirty:
            return
        extra: dict[str, Any] = {
            "ckps": {str(k): v for k, v in self._pending_ckps.items()}}
        with self.state_lock:  # executor is guarded (hstream-analyze)
            executor = self.executor
        if executor is None:
            # nothing aggregated yet (e.g. raw records only): committing
            # the read position loses no state
            if self._reader is not None and self._pending_ckps:
                self._reader.write_checkpoints(self._pending_ckps)
            self._last_snapshot_ms = time.monotonic() * 1000
            self._dirty = False
            return
        with self.state_lock:
            if self.sink_dump is not None:
                extra["sink"] = self.sink_dump()
            # capture_executor clones the planes on the card (later
            # steps write them in place; nothing is donated), so the
            # capture needs no copy of its own. The persist worker
            # fetches the clones from another thread: the event marks
            # the end of the cloning on this thread's stream
            meta, arrays = capture_executor(self.executor, extra)
            mark = handoff(arrays.values())
        # durability barrier: async sink appends for everything captured
        # must land before this capture's checkpoints can ever commit
        flush = getattr(self.sink, "flush", None)
        if flush is not None:
            flush()
        self._last_snapshot_ms = time.monotonic() * 1000
        self._dirty = False
        if sync:
            self._drain_persist()
            self._persist_capture(meta, arrays, dict(self._pending_ckps),
                                  mark)
            return
        with self._persist_cv:
            # latest wins: an unwritten older capture is superseded —
            # its checkpoints never commit, so resume just replays a
            # little more (at-least-once, unchanged)
            self._persist_pending = (meta, arrays,
                                     dict(self._pending_ckps), mark)
            if self._persist_thread is None:
                self._persist_thread = threading.Thread(
                    target=self._persist_loop,
                    name=f"snap-{self.info.query_id}", daemon=True)
                self._persist_thread.start()
            self._persist_cv.notify_all()

    def _persist_loop(self) -> None:
        while True:
            with self._persist_cv:
                while (self._persist_pending is None
                       and not self._persist_stop):
                    self._persist_cv.wait(0.5)
                item = self._persist_pending
                self._persist_pending = None
                if item is None:
                    return  # stop requested, nothing pending
                self._persist_busy = True
            try:
                self._persist_capture(*item)
            except Exception as e:  # noqa: BLE001 — a failed write keeps
                # the previous snapshot; resume replays from it
                log.exception("snapshot persist for %s failed",
                              self.info.query_id)
                self._journal("snapshot_failed",
                              f"snapshot persist for "
                              f"{self.info.query_id} failed: "
                              f"{type(e).__name__}: {e}",
                              query=self.info.query_id,
                              error=type(e).__name__)
            finally:
                with self._persist_cv:
                    self._persist_busy = False
                    self._persist_cv.notify_all()

    def _persist_capture(self, meta, arrays, ckps: dict[int, int],
                         mark=None) -> None:
        """Write one CRC-sealed snapshot into the two-slot rotation:
        slot blob first, pointer second. A crash or torn write anywhere
        in between leaves the pointer at the previous good slot, so
        restore never sees a half-written snapshot as newest-truth.
        `mark` is the capture's event (device.handoff): this thread's
        fetch waits on it."""
        t0 = time.monotonic()
        qid = self.info.query_id
        receive(mark, arrays.values())
        sealed = seal_blob(serialize_capture(meta, arrays))
        if FAULTS.active:  # chaos: injected persist failure/torn write
            FAULTS.point("snapshot.persist")
            sealed = FAULTS.mutate("snapshot.persist", sealed)
        slot = self._snap_slot & 1
        self.ctx.store.meta_put(snapshot_slot_key(qid, slot), sealed)
        self.ctx.store.meta_put(
            snapshot_key(qid),
            SNAP_PTR_MAGIC + json.dumps({"slot": slot}).encode())
        self._snap_slot = 1 - slot
        if self._reader is not None and ckps:
            self._reader.write_checkpoints(ckps)
        self._last_persist_ms = (time.monotonic() - t0) * 1000

    def _drain_persist(self) -> None:
        deadline = time.monotonic() + 30
        with self._persist_cv:
            while ((self._persist_pending is not None
                    or self._persist_busy)
                   and time.monotonic() < deadline):
                self._persist_cv.wait(0.5)

    # ---- processing --------------------------------------------------------

    def _ingest_results(self, results: list) -> None:
        """Decode + dispatch one poll's worth of read results, coalescing
        payloads ACROSS appended batches of the same source log into one
        decode + engine step — per-append device dispatches would bound
        the JSON path at (records per append) / RTT on real links."""
        groups: list[tuple[int, list[bytes], list[int]]] = []
        newest = max((r.append_time_ms for r in results
                      if isinstance(r, DataBatch)), default=0)
        if newest > 0:
            # freshness plane: one ingest-lag observation per poll
            self._note_ingest_freshness(newest)
        for r in results:
            if not isinstance(r, DataBatch):
                continue
            if groups and groups[-1][0] == r.logid:
                groups[-1][1].extend(r.payloads)
                groups[-1][2].extend(
                    [r.append_time_ms] * len(r.payloads))
            else:
                groups.append((r.logid, list(r.payloads),
                               [r.append_time_ms] * len(r.payloads)))
        for logid, payloads, dts in groups:
            self._ingest_group(logid, payloads, dts)

    def _ingest_group(self, logid: int, payloads: list[bytes],
                      dts: list[int]) -> None:
        """One coalesced run of appended payloads from one source log.
        Multi-record runs go through the native batch decoder (C++ wire
        walk -> columns, common/jsondec); single records and fallback
        classes use the per-record Python path."""
        # zero-copy columnar fast path: a run of columnar
        # records — the framed append shape arriving bunched — skips
        # BOTH the native batch classifier walk and the per-record
        # protobuf parse; the payload views feed the staging path
        # directly (those two walks were ~40% of task-thread time at
        # 12x4MB groups)
        views: list | None = []
        for p in payloads:
            v = rec.peek_columnar_payload(p)
            if v is None:
                views = None
                break
            views.append(v)
        if views:
            for v in views:
                self._run_columnar(v, logid)
            return
        decoded = None
        if len(payloads) > 1:
            with trace_span(self.tracer, "decode"):
                decoded = jsondec.decode_batch(
                    payloads, np.asarray(dts, np.int64))
        if decoded is None:
            self._ingest_group_py(logid, payloads, dts)
            return
        ts, cls, cols, nulls = decoded
        n = len(cls)
        self._note_decode("json_decode_native", logid,
                          int(np.sum(cls == jsondec.CLS_JSON)))
        i = 0
        while i < n:
            c = int(cls[i])
            j = i + 1
            while j < n and cls[j] == c:
                j += 1
            if c == jsondec.CLS_JSON:
                if i == 0 and j == n:
                    self._run_json_cols(ts, cols, nulls, logid)
                else:
                    self._run_json_cols(
                        ts[i:j],
                        {k: (kind, arr[i:j], d)
                         for k, (kind, arr, d) in cols.items()},
                        {k: m[i:j] for k, m in nulls.items()}, logid)
            elif c == jsondec.CLS_RAW:
                for k in range(i, j):
                    v = rec.peek_columnar_payload(payloads[k])
                    if v is not None:
                        self._run_columnar(v, logid)
                        continue
                    r = rec.parse_record(payloads[k])
                    if columnar.is_columnar(r.payload):
                        self._run_columnar(r.payload, logid)
                    # other RAW records skipped, like the reference's
                    # JSON-flag filter (HStore.hs:119-143)
            else:  # CLS_PY: nested values / type conflicts / bad bytes
                self._ingest_group_py(logid, payloads[i:j], dts[i:j])
            i = j

    def _ingest_group_py(self, logid: int, payloads: list[bytes],
                         dts: list[int]) -> None:
        """Per-record Python decode (single records, native-decoder
        fallback classes, toolchain-free deployments)."""
        rows: list[dict[str, Any]] = []
        ts: list[int] = []

        def flush_rows() -> None:
            nonlocal rows, ts
            if rows:
                self._run_rows(rows, ts, logid)
                rows, ts = [], []

        with trace_span(self.tracer, "decode"):
            items: list[tuple[str, Any, int]] = []
            for payload, default_ts in zip(payloads, dts):
                v = rec.peek_columnar_payload(payload)
                if v is not None:
                    items.append(("col", v, 0))
                    continue
                r = rec.parse_record(payload)
                if (r.header.flag == rec.pb.RECORD_FLAG_RAW
                        and columnar.is_columnar(r.payload)):
                    items.append(("col", r.payload, 0))
                    continue
                d = rec.record_to_dict(r)
                if d is None:
                    continue  # raw records skipped (HStore.hs:119-143)
                items.append(
                    ("row", d, r.header.publish_time_ms or default_ts))
        self._note_decode("json_decode_fallback", logid,
                          sum(1 for k, _v, _t in items if k == "row"))
        for kind, val, t in items:
            if kind == "col":
                flush_rows()
                self._run_columnar(val, logid)
            else:
                rows.append(val)
                ts.append(t)
        flush_rows()

    def _run_json_cols(self, ts: "np.ndarray", cols: dict, nulls: dict,
                       logid: int) -> None:
        """Dispatch natively-decoded JSON columns (f64/str/bool arrays +
        null masks) through the staged columnar path; joins/sessions/
        stateless materialize rows."""
        if len(ts) == 0:
            return
        with self.state_lock:
            if self.executor is None:
                self.executor = self._make_executor(
                    _sample_rows(ts, cols, nulls), len(ts))
            ex = self.executor
            if not self.is_join and getattr(
                    ex, "supports_columnar_sessions", False):
                # session executors take the batch COLUMNAR too (device
                # session lattice): no row dicts, vectorized key encode
                out = self._run_session_cols(ex, ts, cols, nulls)
                if out:
                    with trace_span(self.tracer, "emit"):
                        self.sink(out)
                return
            if self.is_join or not hasattr(ex, "process_columnar"):
                if self.is_join and getattr(ex, "supports_columnar_join",
                                            False):
                    # stream-stream joins take the batch COLUMNAR: the
                    # join packs device entries straight from the
                    # arrays (null-masked cells = absent fields, the
                    # drop_null row shape) — no row dicts on this path
                    out = self._run_join_cols(
                        ex, ts, _plain_columns(cols), nulls, logid)
                else:
                    with trace_span(self.tracer, "decode"):
                        # drop_null: a record never mentions columns it
                        # doesn't carry — same row shape as the
                        # per-record decode path, independent of
                        # producer batching
                        rws = columnar.to_rows(ts, cols, nulls,
                                               drop_null=True)
                    with trace_span(self.tracer, "step"):
                        if self.is_join:
                            out = ex.process(
                                rws, ts.tolist(),
                                stream=self._sources[logid])
                        else:
                            out = ex.process(rws, ts.tolist())
                if out:
                    with trace_span(self.tracer, "emit"):
                        self.sink(out)
                return
            with trace_span(self.tracer, "key_encode"):
                key_ids = _columnar_key_ids(ex, cols, len(ts),
                                            nulls=nulls)
                dev_cols, dnulls = _device_columns(ex, cols, len(ts),
                                                   nulls=nulls)
            self._submit(ex, key_ids, ts, dev_cols, dnulls)

    def _query_mesh(self):
        """The server mesh, when this plan can execute sharded. The
        exclusions are LOUD (SURVEY §2.3): a plan
        that falls back to single-chip logs why, and EXPLAIN carries
        the same note (codegen.explain_text)."""
        from hstream_tpu_torch.sql.codegen import mesh_exclusion_reason

        mesh = getattr(self.ctx, "mesh", None)
        if mesh is None:
            return None
        reason = mesh_exclusion_reason(self.plan)
        if reason is not None:
            log.warning(
                "query %s runs single-chip despite --mesh: %s",
                self.info.query_id, reason)
            return None
        return mesh

    def _make_executor(self, sample_rows: list, first_n: int):
        from hstream_tpu_torch.engine.types import round_up_pow2
        from hstream_tpu_torch.sql.codegen import make_executor

        # size the device batch to the producer's batch shape: a columnar
        # producer sending 256k-row batches must not be split into 64
        # separate device round-trips by the default 4096 capacity
        cap = min(max(round_up_pow2(first_n, lo=4096), 4096), 1 << 19)
        ex = make_executor(self.plan, sample_rows=sample_rows,
                           batch_capacity=cap, mesh=self._query_mesh(),
                           device=self.ctx.device)
        return self._tune_executor(ex)

    def _tune_executor(self, ex):
        """Per-task executor tuning, applied on BOTH the fresh and the
        snapshot-restore paths."""
        # per-kernel-family dispatch histograms: the engine
        # times its kernel dispatches into this task's observer (a
        # join's lazily-created inner aggregate is wired by the
        # per-chunk mirror when it appears)
        for target in (ex, getattr(ex, "_inner", None)):
            if target is not None and hasattr(target,
                                              "dispatch_observer"):
                target.dispatch_observer = self._observe_kernel
        if getattr(ex, "emit_changes", False) and \
                getattr(ex, "supports_deferred_changes", False):
            # pipeline changelog fetches behind later batches' work and
            # fetch them in BATCHED device->host transfers: on a real
            # link each fetch is a full round trip, which otherwise
            # bounds sustained ingest at (batch size / RTT). The idle
            # tick flushes everything pending, so emitted rows lag at
            # most one poll cycle once ingest pauses — under sustained
            # load they lag up to change_drain_depth micro-batches.
            # async_change_drain moves the batched fetch itself onto
            # the shared drain pool, so even the amortized round trip
            # stops serializing the compute loop. Join executors proxy
            # these knobs onto their downstream aggregate.
            ex.defer_change_decode = True
            ex.change_drain_depth = 8
            ex.async_change_drain = True
        return ex

    def _run_rows(self, rows: list, ts: list, logid: int | None) -> None:
        with self.state_lock:
            if self.executor is None:
                self.executor = self._make_executor(rows, len(rows))
            ex = self.executor
            if not self.is_join and hasattr(ex, "process_columnar") \
                    and not getattr(ex, "supports_columnar_sessions",
                                    False):
                # vectorized JSON ingest: one pass per needed column into
                # the same staged columnar path producer batches use
                # (SURVEY §7 "protobuf decode off the critical path")
                with trace_span(self.tracer, "key_encode"):
                    key_ids, cols, nulls = _columnarize_rows(ex, rows)
                self._submit(ex, key_ids, np.asarray(ts, np.int64),
                             cols, nulls)
                return
            with trace_span(self.tracer, "step"):
                if self.is_join:
                    out = ex.process(rows, ts,
                                     stream=self._sources[logid])
                    self._note_join_stats(ex, logid)
                else:
                    out = ex.process(rows, ts)
            # sink under the lock: a window removed from live state must
            # appear in the sink (view closed rows) atomically with the
            # removal, or a concurrent pull-query snapshot sees it in
            # neither half (no lock-order cycle: views.snapshot releases
            # the materialization lock before taking state_lock)
            if out:
                with trace_span(self.tracer, "emit"):
                    self.sink(out)

    # ---- columnar fast path ------------------------------------------------

    def _run_columnar(self, payload: bytes, logid: int) -> None:
        try:
            with trace_span(self.tracer, "decode"):
                # null masks (the framed append path's wire extension)
                # ride through like the native JSON decoder's: a masked
                # cell is a field the producer never sent
                ts, cols, nulls = columnar.decode_columnar_nulls(payload)
            if len(ts) == 0:
                return
        except Exception:  # noqa: BLE001 — a malformed/forged payload
            # must not kill the query task; skip it like any other
            # unrecognized RAW record
            log.warning("skipping malformed columnar record on logid %d",
                        logid)
            return
        with self.state_lock:
            if self.executor is None:
                self.executor = self._make_executor(
                    _sample_rows(ts, cols, nulls), len(ts))
            ex = self.executor
            if not self.is_join and getattr(
                    ex, "supports_columnar_sessions", False):
                out = self._run_session_cols(ex, ts, cols, nulls)
                if out:
                    with trace_span(self.tracer, "emit"):
                        self.sink(out)
                return
            if self.is_join or not hasattr(ex, "process_columnar"):
                if self.is_join and getattr(ex, "supports_columnar_join",
                                            False):
                    out = self._run_join_cols(
                        ex, ts, _plain_columns(cols), nulls, logid)
                else:
                    # stateless: row materialization
                    with trace_span(self.tracer, "decode"):
                        rws = columnar.to_rows(ts, cols, nulls,
                                               drop_null=True)
                    with trace_span(self.tracer, "step"):
                        if self.is_join:
                            out = ex.process(
                                rws, ts.tolist(),
                                stream=self._sources[logid])
                        else:
                            out = ex.process(rws, ts.tolist())
                if out:
                    with trace_span(self.tracer, "emit"):
                        self.sink(out)
                return
            with trace_span(self.tracer, "key_encode"):
                key_ids = _columnar_key_ids(ex, cols, len(ts),
                                            nulls=nulls)
                dev_cols, dnulls = _device_columns(ex, cols, len(ts),
                                                   nulls=nulls)
            self._submit(ex, key_ids, ts, dev_cols, dnulls)

    def _submit(self, ex, key_ids, ts, cols, nulls) -> None:
        """Submit one columnarized micro-batch through the ingest
        pipeline (caller holds state_lock). Rows returned belong to
        EARLIER batches whose encode already finished — emission lags
        submission by at most the pipeline depth; _drain_pipe() (idle
        tick / snapshot barrier) flushes the tail."""
        if self._pipe is None:
            self._pipe = IngestPipeline(ex, depth=self.pipeline_depth,
                                        workers=self.encode_workers)
        with trace_span(self.tracer, "step"):
            out = self._pipe.submit(key_ids, ts, cols, nulls)
        if out:
            with trace_span(self.tracer, "emit"):
                self.sink(out)

    def _run_session_cols(self, ex, ts, cols, nulls):
        """Columnar dispatch into a session executor (device session
        lattice, engine.session): string columns pre-gathered through
        their payload dictionaries into fixed-width unicode arrays, so
        the session key encoder factorizes them at C speed."""
        with trace_span(self.tracer, "step"):
            return ex.process_columnar(ts, _session_columns(cols), nulls)

    def _run_join_cols(self, ex, ts, plain, nulls, logid):
        """Columnar dispatch into a stream-stream join executor."""
        with trace_span(self.tracer, "step"):
            out = ex.process_columnar(
                ts, plain, nulls, stream=self._sources[logid])
        self._note_join_stats(ex, logid)
        return out

    def _note_join_stats(self, ex, logid: int) -> None:
        """Mirror the join executor's probe-dispatch counter into the
        per-stream metrics registry (delta since the last call)."""
        js = getattr(ex, "join_stats", None)
        if js is None:
            return
        cur = js.get("probe_dispatches", 0)
        delta = cur - self._join_probe_seen
        if delta > 0:
            self._join_probe_seen = cur
            self._note_decode("join_probe_dispatches", logid, delta)

    def _drain_pipe(self) -> None:
        """Pipeline barrier: every submitted batch processed, rows sunk."""
        with self.state_lock:  # _pipe is guarded (hstream-analyze)
            pipe = self._pipe
        if pipe is None or pipe.pending == 0:
            return
        with self.state_lock:
            rows = pipe.flush()
            if rows:
                with trace_span(self.tracer, "emit"):
                    self.sink(rows)


def _max_win_end(rows) -> float | None:
    """Max winEnd of an emitted batch, without materializing a
    ColumnarEmit's row view (read its columns directly); dict-row
    lists scan at most 1024 rows (row-shaped emissions are small)."""
    cols = getattr(rows, "cols", None)
    if cols is not None:
        we = cols.get("winEnd")
        if we is None or len(we) == 0:
            return None
        try:
            return float(np.max(we))
        except (TypeError, ValueError):
            return None
    best = None
    if isinstance(rows, list):
        for row in rows[:1024]:
            we = row.get("winEnd") if isinstance(row, dict) else None
            if we is not None and (best is None or we > best):
                best = we
    return None if best is None else float(best)


def _session_columns(cols: dict) -> dict:
    """Decoded payload columns -> the session executor's columnar feed:
    like _plain_columns, but string columns gather into fixed-width
    unicode arrays (one vectorized fancy-index) instead of object
    arrays — the session key encoder's np.unique factorization runs at
    C speed on those and would fall back to a per-row memo loop on
    object dtype."""
    out = {}
    for name, (kind, arr, d) in cols.items():
        if kind == "str":
            out[name] = np.asarray(d)[arr] if d else \
                np.zeros(len(arr), "U1")
        else:
            out[name] = arr
    return out


def _plain_columns(cols: dict) -> dict:
    """Decoded payload columns (kind, arr, dict) -> plain numpy arrays
    for the join's columnar ingest: string columns gather through their
    payload dictionary (one vectorized fancy-index, no per-row Python)."""
    out = {}
    for name, (kind, arr, d) in cols.items():
        if kind == "str":
            out[name] = np.asarray(d, object)[arr]
        else:
            out[name] = arr
    return out


def _sample_rows(ts: "np.ndarray", cols: dict,
                 nulls: dict | None = None, k: int = 8) -> list[dict]:
    n = min(int(len(ts)), k)
    return columnar.to_rows(
        ts[:n], {name: (kind, arr[:n], d)
                 for name, (kind, arr, d) in cols.items()},
        None if nulls is None else {name: m[:n]
                                    for name, m in nulls.items()},
        drop_null=True)


def _columnarize_rows(ex, rows: list) -> tuple:
    """Decoded JSON rows -> (key_ids, cols, nulls) for the staged
    columnar path: one pass per needed column instead of the per-row
    HostBatch scan. Semantics match HostBatch.from_rows: STRING columns
    stringify non-None values; numeric columns NULL anything that is not
    int/float/bool."""
    from hstream_tpu_torch.engine.types import ColumnType

    n = len(rows)
    if ex.group_cols:
        gc = ex.group_cols
        if len(gc) == 1:
            c0 = gc[0]
            key_ids = np.fromiter(
                (ex.key_id_for((r.get(c0),)) for r in rows), np.int32, n)
        else:
            key_ids = np.fromiter(
                (ex.key_id_for(tuple(r.get(c) for c in gc))
                 for r in rows), np.int32, n)
    else:
        key_ids = np.zeros(n, np.int32)
    cols: dict[str, np.ndarray] = {}
    nulls: dict[str, np.ndarray] = {}
    for name in ex._needed_cols:
        want = ex.schema.type_of(name)
        msk = np.zeros(n, np.bool_)
        if want == ColumnType.STRING:
            enc = ex.dicts[name].encode
            arr = np.empty(n, np.int32)
            for i, r in enumerate(rows):
                v = r.get(name)
                if v is None:
                    arr[i] = -1
                    msk[i] = True
                else:
                    arr[i] = enc(str(v))
        else:
            dt = (np.bool_ if want == ColumnType.BOOL
                  else np.int32 if want == ColumnType.INT else np.float32)
            arr = np.zeros(n, dt)
            for i, r in enumerate(rows):
                v = r.get(name)
                if v is None or not isinstance(v, (int, float, bool)):
                    msk[i] = True
                else:
                    arr[i] = v
        cols[name] = arr
        if msk.any():
            nulls[name] = msk
    return key_ids, cols, (nulls or None)


def _columnar_key_ids(ex, cols: dict, n: int,
                      nulls: dict | None = None) -> "np.ndarray":
    """Vectorized group-key encoding: per-column unique+inverse, then
    one key_id_for call per DISTINCT combination (not per row). `nulls`
    marks cells whose group value is None (native JSON decode)."""
    if not ex.group_cols:
        return np.zeros(n, np.int32)
    col_vals: list[list] = []
    col_codes: list[np.ndarray] = []
    for c in ex.group_cols:
        ent = cols.get(c)
        if ent is None:
            col_vals.append([None])
            col_codes.append(np.zeros(n, np.int64))
            continue
        kind, arr, d = ent
        if kind == "str" and len(d) <= n:
            # the payload's dictionary codes ARE dense per-batch value
            # ids (encode_columnar dictionary-encodes with np.unique):
            # use them directly — no O(n log n) unique pass per batch.
            # A forged dict LARGER than the batch row count falls
            # through to the unique path so key registration stays
            # bounded by rows actually present.
            vals: list = list(d)
            codes = arr.astype(np.int64)
        elif kind == "str":
            uniq, inv = np.unique(arr, return_inverse=True)
            vals = [d[int(u)] for u in uniq]
            codes = inv.astype(np.int64)
        elif kind == "bool":
            vals = [False, True]
            codes = arr.astype(np.int64)
        else:
            uniq, inv = np.unique(arr, return_inverse=True)
            if kind == "f64":
                # integral doubles decode as ints, like the Struct
                # number decoding JSON rows go through (records.py)
                vals = [int(u) if float(u).is_integer() else float(u)
                        for u in uniq]
            elif kind == "f32":
                vals = [float(u) for u in uniq]
            else:
                vals = [int(u) for u in uniq]
            codes = inv.astype(np.int64)
        nm = nulls.get(c) if nulls else None
        if nm is not None and nm.any():
            vals = [None] + vals
            codes = np.where(nm, 0, codes + 1)
        col_vals.append(vals)
        col_codes.append(codes)
    if len(col_vals) == 1:
        # single group column: map each distinct value to its key id
        # once, then one LUT gather over the batch. Register ONLY codes
        # that occur in the batch: vals can carry values absent from
        # every (unmasked) row — bool's fixed [False, True] domain, or
        # unique() placeholders from null-masked cells — and a phantom
        # key id would ride every snapshot and could force a needless
        # key-capacity grow.
        vals = col_vals[0]
        codes = col_codes[0]
        # raw-value -> key id memo: at SURVEY-scale cardinality (100K+
        # live keys) the per-distinct key_id_for canon+tuple work is
        # ~100ms per batch; a dict hit is ~10x cheaper. kids never
        # change once assigned, so the memo cannot go stale; it is
        # bounded like the session key caches.
        memo = getattr(ex, "_kid_vmemo", None)
        if memo is None:
            memo = ex._kid_vmemo = {}
        elif len(memo) > (1 << 20):
            memo.clear()
        kid_lut = np.zeros(len(vals), np.int32)
        for p in np.unique(codes).tolist():
            v = vals[p]
            kid = memo.get(v)
            if kid is None:
                kid = ex.key_id_for((v,))
                memo[v] = kid
            kid_lut[p] = kid
        return kid_lut[codes]
    radix = 1
    for vals in col_vals:
        radix *= max(len(vals), 1)
    if radix >= (1 << 62):
        # mixed-radix code would overflow int64 and silently collide
        # distinct groups: fall back to per-row tuples (rare — several
        # high-cardinality group columns in one batch)
        arrs = [np.asarray(vals, object)[codes]
                for vals, codes in zip(col_vals, col_codes)]
        return np.fromiter((ex.key_id_for(t) for t in zip(*arrs)),
                           np.int32, n)
    combined = col_codes[0]
    for codes, vals in zip(col_codes[1:], col_vals[1:]):
        combined = combined * len(vals) + codes
    u, inv = np.unique(combined, return_inverse=True)
    kid_for_u = np.empty(len(u), np.int32)
    for j, cu in enumerate(u.tolist()):
        idxs = []
        for vals in reversed(col_vals[1:]):
            idxs.append(cu % len(vals))
            cu //= len(vals)
        idxs.append(cu)
        idxs.reverse()
        key = tuple(col_vals[k][i] for k, i in enumerate(idxs))
        kid_for_u[j] = ex.key_id_for(key)
    return kid_for_u[inv]


def _device_columns(ex, cols: dict, n: int, nulls: dict | None = None):
    """Map batch columns to the executor's needed device columns;
    missing columns become all-NULL; per-cell null masks (native JSON
    decode) ride through."""
    from hstream_tpu_torch.engine.types import ColumnType

    dev: dict[str, Any] = {}
    out_nulls: dict[str, Any] = {}
    for name in ex._needed_cols:
        ent = cols.get(name)
        want = ex.schema.type_of(name)
        # type mismatch between the batch column and the bound schema
        # (e.g. a later producer sends strings where FLOAT was inferred)
        # becomes NULL, never dictionary ids masquerading as data
        kind = ent[0] if ent is not None else None
        mismatch = (kind == "str") != (want == ColumnType.STRING)
        if ent is None or mismatch:
            dev[name] = np.zeros(
                n, np.int32 if want == ColumnType.STRING else np.float32)
            out_nulls[name] = np.ones(n, np.bool_)
            continue
        kind, arr, d = ent
        if want == ColumnType.STRING:
            lut = np.asarray([ex.dicts[name].encode(s) for s in d],
                             np.int32)
            dev[name] = lut[arr]
        elif want == ColumnType.BOOL:
            dev[name] = np.asarray(arr, np.bool_)
        elif want == ColumnType.INT:
            dev[name] = np.asarray(arr, np.int32)
        else:
            dev[name] = np.asarray(arr, np.float32)
        nm = nulls.get(name) if nulls else None
        if nm is not None and nm.any():
            out_nulls[name] = nm
    return dev, (out_nulls or None)


def stream_sink(ctx, sink_stream: str,
                stream_type: StreamType = StreamType.STREAM) -> SinkFn:
    """Sink emitting rows as JSON records onto a stream (the reference's
    internal sink processor, HStore.hs:152-163).

    On the native store the appends go through the async completion
    queue (the reference's async writer, hs_writer.cpp:29-51): the query
    loop overlaps durable sink writes with the next batch's processing,
    bounded in flight. `sink.flush()` is the durability barrier — the
    task calls it before committing a state snapshot, so a checkpoint
    never outruns its emitted rows."""
    logid = ctx.streams.get_logid(sink_stream, stream_type)
    use_async = hasattr(ctx.store, "append_async")
    pending: list = []

    stats = getattr(ctx, "stats", None)

    def sink(rows: list[dict[str, Any]]) -> None:
        if stats is not None and isinstance(rows, columnar.ColumnarEmit):
            try:
                stats.stream_stat_add("change_rows_columnar",
                                      sink_stream, len(rows))
            except Exception:  # noqa: BLE001 — metrics must not kill
                pass           # the emit path
        payloads = None
        if isinstance(rows, columnar.ColumnarEmit) or len(rows) >= 32:
            # steady-state batches of homogeneous flat rows go out as
            # ONE columnar record — per-row protobuf Struct building is
            # the emit stage's entire cost at changelog rates. A
            # ColumnarEmit close batch encodes straight from its
            # columns, so the emitted rows never materialize as dicts
            # on this path at ANY batch size.
            packed = columnar.rows_to_payload(rows, rec.now_ms())
            if packed is not None:
                payloads = [rec.build_record(packed).SerializeToString()]
        if payloads is None:
            payloads = [rec.build_record(row).SerializeToString()
                        for row in rows]
        if use_async:
            while len(pending) >= 8:  # bound in-flight appends
                pending.pop(0).result()
            pending.append(ctx.store.append_async(logid, payloads))
        else:
            ctx.store.append_batch(logid, payloads)

    def flush() -> None:
        while pending:
            pending.pop(0).result()

    sink.flush = flush
    return sink
