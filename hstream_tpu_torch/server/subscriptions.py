"""Subscription runtime: fetch/ack with gap-aware ack ranges.

Reference semantics (Handler.hs:420-718, Handler/Common.hs:119-166):

  * a subscription binds a checkpointed reader to a stream at an offset
  * Fetch returns batches as (RecordId{batch_id=LSN, batch_index}, bytes)
    and records each batch's size in `batchNumMap`; gap records are
    inserted straight into the acked ranges
  * Acknowledge merges acked RecordIds into disjoint ranges using the
    successor function: within a batch the next index, across batches the
    first index of the next *known* LSN (Common.hs:119-166 — the subtle
    bit SURVEY flags as property-test-worthy)
  * when the window's lower bound advances past a range, the checkpoint
    commits at `lower.lsn - 1` (partially acked batches are redelivered
    on resume — at-least-once)

`AckWindow` implements exactly that bookkeeping; `SubscriptionRuntime`
owns reader + window + the StreamingFetch consumer round-robin
(Handler.hs:819-922).
"""

# A copy of hstream_tpu/server/subscriptions.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import bisect
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any

from hstream_tpu_torch.common import locktrace
from hstream_tpu_torch.common.errors import (
    SubscriptionExists,
    SubscriptionNotFound,
)
from hstream_tpu_torch.store.api import LSN_MIN, DataBatch, GapRecord
from hstream_tpu_torch.store.checkpoint import CheckpointedReader


@dataclass(frozen=True, order=True)
class RecId:
    lsn: int
    idx: int


def _expand_columnar(payload: bytes) -> list[bytes] | None:
    """Expand an internal columnar record (query sinks pack a whole
    emitted batch into ONE RAW record — tasks.stream_sink) into per-row
    JSON records for subscription consumers, which speak the reference
    wire protocol and would otherwise see opaque bytes. None = not a
    columnar record, deliver verbatim. The RecId batch_index space and
    the AckWindow's batch size both use the expanded count, so ack
    bookkeeping stays consistent."""
    from hstream_tpu_torch.common import columnar, records as rec

    if b"HSCB" not in payload:  # cheap reject before a protobuf parse
        return None
    try:
        r = rec.parse_record(payload)
        if (r.header.flag != rec.pb.RECORD_FLAG_RAW
                or not columnar.is_columnar(r.payload)):
            return None
        ts, cols, nulls = columnar.decode_columnar_nulls(r.payload)
        # drop_null: masked cells (framed-append null masks) read as
        # fields the producer never sent, like every other consumer
        rows = columnar.to_rows(ts, cols, nulls, drop_null=True)
    except Exception:  # noqa: BLE001 — malformed: deliver verbatim
        return None
    if not rows:
        # an empty expansion would note a size-0 batch, which parks the
        # ack window's lower bound forever; deliver verbatim instead
        return None
    pt = r.header.publish_time_ms
    return [rec.build_record(row, key=r.header.key,
                             publish_time_ms=int(t) if t else pt)
            .SerializeToString()
            for row, t in zip(rows, ts.tolist())]


class AckWindow:
    """Ack-range bookkeeping for one subscription (Common.hs:119-166)."""

    def __init__(self) -> None:
        self.lower: RecId | None = None       # next record needing ack
        self.ranges: list[list[RecId]] = []   # disjoint [start, end], sorted
        self.batch_sizes: dict[int, int] = {}
        self.known_lsns: list[int] = []       # sorted delivered LSNs

    # ---- delivery-side bookkeeping ----
    def note_batch(self, lsn: int, size: int) -> None:
        if lsn not in self.batch_sizes:
            bisect.insort(self.known_lsns, lsn)
        self.batch_sizes[lsn] = size
        if self.lower is None:
            self.lower = RecId(lsn, 0)

    def note_gap(self, lo_lsn: int, hi_lsn: int) -> None:
        """A gap [lo, hi] needs no consumer acks: insert it as an acked
        range covering the endpoints (intermediate LSNs can never be
        delivered individually)."""
        self.note_batch(hi_lsn, 1)
        if lo_lsn != hi_lsn and lo_lsn not in self.batch_sizes:
            bisect.insort(self.known_lsns, lo_lsn)
            self.batch_sizes[lo_lsn] = 1
        if self.lower is None:
            self.lower = RecId(lo_lsn, 0)
        self._insert_range(RecId(lo_lsn, 0), RecId(hi_lsn, 0))

    # ---- successor ----
    def successor(self, rid: RecId) -> RecId | None:
        """The next record id after `rid`, or None when the next LSN has
        not been delivered yet (merge retried later)."""
        size = self.batch_sizes.get(rid.lsn, 1)
        if rid.idx + 1 < size:
            return RecId(rid.lsn, rid.idx + 1)
        i = bisect.bisect_right(self.known_lsns, rid.lsn)
        if i < len(self.known_lsns):
            return RecId(self.known_lsns[i], 0)
        return None

    # ---- acks ----
    def ack(self, rid: RecId) -> None:
        self._insert_range(rid, rid)

    def _adjoins(self, end: RecId, start: RecId) -> bool:
        """True when [.., end] and [start, ..] overlap or are adjacent
        (start == successor(end)); unknown successors defer the merge."""
        if start <= end:
            return True
        s = self.successor(end)
        return s is not None and start <= s

    def _insert_range(self, start: RecId, end: RecId) -> None:
        i = bisect.bisect_left(self.ranges, [start, end])
        self.ranges.insert(i, [start, end])
        if i > 0 and self._adjoins(self.ranges[i - 1][1],
                                   self.ranges[i][0]):
            self.ranges[i - 1][1] = max(self.ranges[i - 1][1],
                                        self.ranges[i][1])
            del self.ranges[i]
            i -= 1
        while (i + 1 < len(self.ranges)
               and self._adjoins(self.ranges[i][1], self.ranges[i + 1][0])):
            self.ranges[i][1] = max(self.ranges[i][1],
                                    self.ranges[i + 1][1])
            del self.ranges[i + 1]

    # ---- window advance ----
    def advance(self) -> int | None:
        """Advance the lower bound over fully-acked prefix ranges.
        Returns the new committable checkpoint LSN (lower.lsn - 1), or
        None if the bound did not move. Ranges that could not merge at
        ack time (successor unknown then) are walked here, since the
        loop re-tests the new first range against the advanced bound."""
        moved = False
        while (self.ranges and self.lower is not None
               and self.ranges[0][0] <= self.lower):
            start, end = self.ranges.pop(0)
            if end < self.lower:
                continue  # stale range from duplicate acks
            nxt = self.successor(end)
            if nxt is None:
                # everything delivered so far is acked: park the bound
                # just past the end; the next delivery re-opens it
                self.lower = max(self.lower, RecId(end.lsn + 1, 0))
                moved = True
                break
            self.lower = max(self.lower, nxt)
            moved = True
        if not moved or self.lower is None:
            return None
        return self.lower.lsn - 1


class Consumer:
    def __init__(self, name: str, credit_window: int = 0):
        self.name = name
        self.queue: "queue.Queue[list[tuple[RecId, bytes]]]" = queue.Queue(
            maxsize=64)
        self.alive = True
        # credit-based delivery: one credit per in-flight record,
        # refilled by this consumer's acks. None = unbounded (legacy).
        from hstream_tpu_torch.flow import CreditWindow

        self.credits = (CreditWindow(credit_window)
                        if credit_window > 0 else None)


class SubscriptionRuntime:
    """Reader + ack window + consumers of one subscription."""

    def __init__(self, ctx, meta: Any):
        self.ctx = ctx
        self.meta = meta  # pb Subscription
        self.sub_id = meta.subscription_id
        self.logid = ctx.streams.get_logid(meta.stream_name)
        self.window = AckWindow()
        # named traced lock: fetch/ack/dispatch/shutdown
        # all rendezvous here — witness-instrumented
        self.lock = locktrace.lock("subscriptions.runtime")
        self._reader: CheckpointedReader | None = None
        self._committed: int = 0
        # streaming-fetch state
        self.consumers: list[Consumer] = []
        self._rr = 0
        self._dispatcher: threading.Thread | None = None
        self._stop = threading.Event()
        # batches reclaimed from dead consumers' queues, redelivered
        # before anything newly fetched (at-least-once while running)
        self._requeue: list[list[tuple[RecId, bytes]]] = []
        self._last_backlog_feed = 0.0

    # ---- reader ------------------------------------------------------------

    def _start_lsn(self) -> int:
        off = self.meta.offset
        which = off.WhichOneof("offset")
        if which == "record_offset":
            return max(off.record_offset.batch_id, LSN_MIN)
        if off.special_offset == 1:  # LATEST
            return self.ctx.store.tail_lsn(self.logid) + 1
        return LSN_MIN  # EARLIEST

    def reader(self) -> CheckpointedReader:
        with self.lock:
            if self._reader is None:
                r = CheckpointedReader(
                    f"subscription-{self.sub_id}",
                    self.ctx.store.new_reader(), self.ctx.ckp_store)
                start = r.start_reading_from_checkpoint(
                    self.logid, self._start_lsn())
                # committed reflects the ACTUAL start position: records
                # before it are not outstanding, so lag (tail -
                # committed) is 0 for a fresh LATEST subscriber instead
                # of the whole log — a benign new subscriber must not
                # feed a phantom backlog into the overload detector
                self._committed = max(self._committed, start - 1)
                self._reader = r
            return self._reader

    # ---- fetch / ack -------------------------------------------------------

    def fetch(self, timeout_ms: int, max_size: int
              ) -> list[tuple[RecId, bytes]]:
        r = self.reader()
        r.set_timeout(int(timeout_ms))
        t0 = time.perf_counter()
        results = r.read(max(int(max_size), 1))
        # columnar expansion OUTSIDE the runtime lock: the
        # decode + per-row re-serialization is the expensive half of a
        # fetch. Log records are immutable, so the shared expansion
        # cache encodes each one ONCE per process and every consumer
        # of the stream reuses the same frame bytes by reference —
        # the encode-once fan-out half of the read plane. Lock hold
        # time shrinks to pure ack-window bookkeeping.
        cache = getattr(self.ctx, "read_cache", None)
        expanded: list[tuple[Any, list[bytes] | None]] = []
        for item in results:
            if not isinstance(item, DataBatch):
                expanded.append((item, None))
                continue
            payloads: list[bytes] = []
            for i, payload in enumerate(item.payloads):
                if cache is not None:
                    frames = cache.expand_frames(
                        self.logid, item.lsn, i, payload,
                        _expand_columnar)
                else:
                    frames = _expand_columnar(payload)
                if frames is None:
                    payloads.append(payload)
                else:
                    payloads.extend(frames)
            expanded.append((item, payloads))
        out: list[tuple[RecId, bytes]] = []
        newest = 0
        with self.lock:
            for item, payloads in expanded:
                if payloads is not None:
                    self.window.note_batch(item.lsn, len(payloads))
                    for i, payload in enumerate(payloads):
                        out.append((RecId(item.lsn, i), payload))
                    if item.append_time_ms > newest:
                        newest = item.append_time_ms
                elif isinstance(item, GapRecord):
                    self.window.note_gap(item.lo_lsn, item.hi_lsn)
            self._maybe_commit()
        if out:
            self._note_delivery(newest, t0)
            stats = getattr(self.ctx, "stats", None)
            if stats is not None:
                try:
                    # per-subscription delivery ladder: the
                    # rate a consumer group actually drains at — both
                    # the unary Fetch and the streaming dispatcher
                    # land here
                    nbytes = sum(len(p) for _r, p in out)
                    stats.stat_add("delivered_records", self.sub_id,
                                   float(len(out)))
                    stats.stat_add("delivered_bytes", self.sub_id,
                                   float(nbytes))
                    # read-side rate of the source stream:
                    # every subscription drain — unary Fetch AND the
                    # streaming dispatcher — is a read of that stream
                    # (the handler no longer double-counts it)
                    stats.note_read(self.meta.stream_name, len(out),
                                    nbytes)
                except Exception:  # noqa: BLE001 — metrics must not
                    pass           # kill delivery
        return out

    def _note_delivery(self, newest_append_ms: int, t0: float) -> None:
        """Freshness + tracing at the delivery boundary:
        append->delivery latency of the newest delivered record (the
        delivery stage of the lag taxonomy), and a `delivery` span
        when the fetching request is sampled. Host arithmetic only;
        never fails a fetch."""
        from hstream_tpu_torch.common import tracing

        stats = getattr(self.ctx, "stats", None)
        if stats is not None and newest_append_ms > 0:
            try:
                lag = max(0.0, time.time() * 1e3 - newest_append_ms)
                stats.observe("freshness_lag_ms", "delivery", lag)
                stats.observe("append_visible_latency_ms", self.sub_id,
                              lag)
            except Exception:  # noqa: BLE001 — metrics must not kill
                pass           # delivery
        tr = getattr(self.ctx, "tracing", None)
        if tr is not None and tr.active:
            sctx = tracing.current_span()
            if sctx is not None:
                trace_id, parent = sctx
                dur_ms = (time.perf_counter() - t0) * 1e3
                try:
                    tr.record_span(
                        self.sub_id, "delivery", trace_id=trace_id,
                        span_id=tracing.new_span_id(),
                        parent_id=parent,
                        t0_ms=time.time() * 1e3 - dur_ms,
                        dur_ms=dur_ms)
                except Exception:  # noqa: BLE001 — span plumbing must
                    pass           # never fail delivery

    def ack(self, rec_ids: list[RecId],
            consumer: "Consumer | None" = None) -> None:
        if rec_ids:
            stats = getattr(self.ctx, "stats", None)
            if stats is not None:
                try:
                    stats.stat_add("acks_received", self.sub_id,
                                   float(len(rec_ids)))
                except Exception:  # noqa: BLE001 — metrics must not
                    pass           # kill the ack path
        with self.lock:
            for rid in rec_ids:
                self.window.ack(rid)
            self._maybe_commit()
            targets = ([consumer] if consumer is not None
                       else list(self.consumers))
        # refill OUTSIDE the runtime lock: the dispatcher blocks on
        # credits while holding nothing, and refill only touches the
        # window's own condition variable. Acks arriving without a
        # consumer (the unary Acknowledge RPC) cannot be attributed, so
        # they conservatively refill every registered consumer — the
        # per-window cap keeps each balance bounded, and a mixed
        # StreamingFetch-delivery/unary-ack client cannot starve itself
        for c in targets:
            if c.credits is not None:
                c.credits.refill(len(rec_ids))

    def _maybe_commit(self) -> None:
        """Caller holds self.lock (fetch/ack call this inside their
        critical section)."""
        ckp = self.window.advance()
        if ckp is not None and ckp > self._committed:
            self._committed = ckp
            if self._reader is not None:
                self._reader.write_checkpoints({self.logid: ckp})

    @property
    def committed_lsn(self) -> int:
        # found by hstream-analyze (lock-guard): _committed is written
        # under self.lock by fetch/ack; an unlocked read here could
        # surface a torn/stale lag to sub-lag admin + the backlog gauge
        with self.lock:
            return self._committed

    def credit_inflight(self) -> int:
        """Delivery credits currently in flight across this
        subscription's consumers (observability: the credit_inflight
        gauge). Unbounded (credits disabled) consumers count 0."""
        with self.lock:
            consumers = list(self.consumers)
        return sum(c.credits.window - c.credits.available
                   for c in consumers if c.credits is not None)

    # ---- streaming fetch (consumer round-robin) ----------------------------

    def register_consumer(self, name: str) -> Consumer:
        flow = getattr(self.ctx, "flow", None)
        c = Consumer(name, getattr(flow, "credit_window", 0) or 0)
        with self.lock:
            self.consumers.append(c)
            if self._dispatcher is None:
                self._dispatcher = threading.Thread(
                    target=self._dispatch_loop,
                    name=f"sub-{self.sub_id}-dispatch", daemon=True)
                self._dispatcher.start()
        return c

    def unregister_consumer(self, c: Consumer) -> None:
        c.alive = False
        with self.lock:
            if c in self.consumers:
                self.consumers.remove(c)
            self._reclaim_locked(c)

    def requeue(self, batch: list[tuple[RecId, bytes]]) -> None:
        """Hand back a delivered-but-unconsumed batch for redelivery
        (e.g. a StreamingFetch handler dying between queue.get and a
        successful yield)."""
        with self.lock:
            self._requeue.append(batch)

    def _reclaim_locked(self, c: Consumer) -> None:
        """Reclaim undelivered batches from a dead consumer's queue for
        redelivery. Caller holds self.lock."""
        while True:
            try:
                self._requeue.append(c.queue.get_nowait())
            except queue.Empty:
                break

    def _feed_backlog_signal(self) -> None:
        """~1 Hz: feed this subscription's lag (tail - committed) to the
        overload detector — the backlog signal of the shed ladder."""
        flow = getattr(self.ctx, "flow", None)
        if flow is None:
            return
        now = time.monotonic()
        if now - self._last_backlog_feed < 1.0:
            return
        with self.lock:
            if self._reader is None:
                return  # no reads yet: _committed is not seeded yet
            committed = self._committed
        self._last_backlog_feed = now
        try:
            tail = self.ctx.store.tail_lsn(self.logid)
            flow.overload.note("sub_backlog",
                               float(max(0, tail - committed)),
                               source=self.sub_id)
        except Exception:  # noqa: BLE001 — monitoring must not kill
            pass           # the dispatcher (e.g. stream being deleted)

    def _dispatch_loop(self) -> None:
        # 10ms low-res poll like the reference's readAndDispatchRecords
        # timer (Handler.hs:819-922), round-robining batches to consumers.
        # A fetched batch is already noted in the AckWindow, so it must
        # never be dropped: a batch that finds no queue slot or no
        # delivery credit is re-offered (rotating consumers) until
        # someone takes it — only then do we fetch more. Otherwise the
        # ack lower bound would stall forever.
        pending: list[tuple[RecId, bytes]] | None = None
        zero_credit_offers = 0  # consecutive offers refused for credit
        while not self._stop.is_set():
            self._feed_backlog_signal()
            with self.lock:
                alive = [c for c in self.consumers if c.alive]
            if not alive:
                if self._stop.wait(0.05):
                    return
                continue
            if pending is None:
                with self.lock:
                    if self._requeue:
                        pending = self._requeue.pop(0)
            if pending is None:
                batch = self.fetch(timeout_ms=10, max_size=64)
                if not batch:
                    continue
                pending = batch
            with self.lock:
                alive = [c for c in self.consumers if c.alive]
                if not alive:
                    continue  # keep pending until a consumer returns
                c = alive[self._rr % len(alive)]
                self._rr += 1
            take = len(pending)
            if c.credits is not None:
                # credit-based delivery: at most the consumer's credit
                # balance goes in flight; zero credit pauses delivery
                # until its acks refill (slow consumers stop inflating
                # server memory). Block on the window only when this is
                # the ONLY consumer — with siblings, rotate immediately
                # so one stalled consumer cannot throttle the healthy
                # ones; a short wait after a full zero-credit rotation
                # keeps the loop from spinning hot
                block = 0.2 if len(alive) == 1 else 0.0
                take = c.credits.take_up_to(len(pending), timeout=block)
                if take == 0:
                    self._note_credit_wait()
                    zero_credit_offers += 1
                    if zero_credit_offers >= len(alive) and block == 0.0:
                        self._stop.wait(0.01)
                    continue  # re-offer (rotated) while they drain
                zero_credit_offers = 0
            chunk = pending[:take]
            try:
                c.queue.put(chunk, timeout=0.2)
            except queue.Full:
                if c.credits is not None:
                    c.credits.refill(take)
                continue  # slow consumer: re-offer to the next one
            pending = pending[take:] or None
            with self.lock:
                if not c.alive:
                    # consumer died around the put: unregister's drain may
                    # have run before the put landed — reclaim anything
                    # stranded in the abandoned queue (at-least-once)
                    self._reclaim_locked(c)

    def _note_credit_wait(self) -> None:
        stats = getattr(self.ctx, "stats", None)
        if stats is not None:
            try:
                stats.stream_stat_add("delivery_credit_waits",
                                      self.meta.stream_name)
            except Exception:  # noqa: BLE001 — stats must not kill
                pass           # delivery

    def shutdown(self) -> None:
        self._stop.set()
        with self.lock:
            for c in self.consumers:
                c.alive = False
            self.consumers.clear()
            dispatcher = self._dispatcher
        # found by hstream-analyze (resource-leak): the dispatcher was
        # signalled but never reaped, so DeleteSubscription could return
        # while the loop was still mid-fetch — racing the checkpoint
        # remove and re-committing into a deleted subscription's store
        # state. Join OUTSIDE the lock (the loop takes self.lock per
        # tick); its waits are all bounded, so 5s covers a full tick.
        if dispatcher is not None \
                and dispatcher is not threading.current_thread():
            dispatcher.join(timeout=5)


class SubscriptionRegistry:
    def __init__(self) -> None:
        self._subs: dict[str, SubscriptionRuntime] = {}
        self._lock = locktrace.lock("subscriptions.registry")

    def create(self, ctx, meta) -> SubscriptionRuntime:
        with self._lock:
            if meta.subscription_id in self._subs:
                raise SubscriptionExists(meta.subscription_id)
            rt = SubscriptionRuntime(ctx, meta)
            self._subs[meta.subscription_id] = rt
            return rt

    def get(self, sub_id: str) -> SubscriptionRuntime:
        with self._lock:
            rt = self._subs.get(sub_id)
        if rt is None:
            raise SubscriptionNotFound(sub_id)
        return rt

    def exists(self, sub_id: str) -> bool:
        with self._lock:
            return sub_id in self._subs

    def remove(self, sub_id: str) -> None:
        with self._lock:
            rt = self._subs.pop(sub_id, None)
        if rt is None:
            raise SubscriptionNotFound(sub_id)
        rt.shutdown()

    def list(self) -> list[SubscriptionRuntime]:
        with self._lock:
            return list(self._subs.values())
