"""Sharded append front: the handler-side half of wire-speed ingest.

The plain Append handler appends synchronously on its gRPC thread —
one fsync-bound store call per RPC, which is why `store_append` benches
at ~93k rec/s while the store's OWN completion-queue path
(``NativeLogStore.append_async``, the reference's async writer shape,
cbits hs_writer.cpp:36-45) sits unused. This front puts every columnar
append behind a small lane array keyed by logid:

* on a store with ``append_async`` (the native C++ completion queue,
  or the replicated store's ack-wait pool) the lane IS that queue —
  submissions return a Future and group-commit / overlap ack waits;
* on any other store (mem://) each lane is one worker thread draining
  a FIFO, so N streams append in parallel while the RPC thread
  validates/wraps the NEXT block instead of waiting out the store.

Ordering: a logid always maps to the same lane (``logid % lanes``) and
lanes are FIFO, so per-stream append order is submission order — the
property the streaming AppendColumnar RPC's record ids rely on. The
caller resolves the returned futures (in order) before answering the
client, so acknowledged appends are durable exactly like the sync path.
"""

# A copy of hstream_tpu/server/appendfront.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Sequence

from hstream_tpu_torch.common import locktrace
from hstream_tpu_torch.store.api import Compression

# a lane worker that cannot keep up holds at most this many pending
# batches before submit() backpressures the RPC thread
LANE_DEPTH = 64


class AppendFront:
    """Append lanes in front of one LogStore (see module docstring)."""

    def __init__(self, store, lanes: int = 2):
        self._store = store
        # native path: the C++ completion queue already pipelines and
        # group-commits; extra Python lanes would only add hops
        self._async = hasattr(store, "append_async")
        self.lanes = 1 if self._async else max(int(lanes), 1)
        self._queues: list[queue.Queue] = []
        self._threads: list[threading.Thread] = []
        self._closed = False
        self.submitted = 0   # batches handed to the front
        self.completed = 0   # batches resolved (ok or error)
        # named traced locks: the lock-order witness sees
        # every acquire when armed; disarmed cost is one attribute
        # read + one branch per acquire (hot-path contract below)
        self._stat_lock = locktrace.lock("appendfront.stat")
        # serializes the closed-check + enqueue against close(): without
        # it a submit racing shutdown could land its item AFTER the
        # close sentinel and leave its Future unresolved forever
        self._submit_lock = locktrace.lock("appendfront.submit")
        # per-lane enqueue locks: backpressure on one lane must not
        # head-of-line-block submissions to the others
        self._lane_locks = locktrace.lock_list("appendfront.lane",
                                               self.lanes)
        if not self._async:
            for i in range(self.lanes):
                q: queue.Queue = queue.Queue(maxsize=LANE_DEPTH)
                t = threading.Thread(target=self._lane_loop, args=(q,),
                                     name=f"append-lane-{i}", daemon=True)
                self._queues.append(q)
                self._threads.append(t)
                t.start()

    # contract: dispatches<=0 fetches<=0
    def submit(self, logid: int, payloads: Sequence[bytes],
               compression: Compression = Compression.NONE
               ) -> "Future[int]":
        """Queue one batch; the Future resolves to its LSN once the
        store has durably accepted it (or to the store's exception).
        No append-time override on this surface: the completion-queue
        path stamps the store's own clock, so offering the knob only on
        the lane fallback would be a path-dependent divergence — event
        time rides the record headers instead (wrap_raw_record)."""
        with self._stat_lock:
            self.submitted += 1
        fut: Future = Future()
        if self._async:
            try:
                with self._submit_lock:
                    if self._closed:
                        raise RuntimeError("append front is closed")
                    inner = self._store.append_async(logid, payloads,
                                                     compression)
            except BaseException:
                # nothing was submitted: the stat must not count a
                # phantom in-flight batch forever
                with self._stat_lock:
                    self.submitted -= 1
                raise
            # chain through an outer future so the completion count is
            # bumped BEFORE any waiter on the result wakes — a caller
            # that resolved every future must observe in_flight == 0
            inner.add_done_callback(lambda f: self._finish(f, fut))
            return fut
        lane = logid % self.lanes
        # per-LANE lock: a lane at depth blocks only its own stream's
        # submitters, not every other lane (and not close()). The
        # sentinel ordering still holds: close() sets _closed BEFORE
        # taking any lane lock, so a False read here means THIS lane's
        # sentinel has not been placed yet and the item lands ahead of
        # it; a stale-False race just means the item is still processed
        # before the worker exits.
        with self._lane_locks[lane]:
            if self._closed:  # analyze: ok lock-guard — ordering via
                # the lane lock, see above; worst case is an accepted
                # item that the draining worker still completes
                with self._stat_lock:
                    self.submitted -= 1
                raise RuntimeError("append front is closed")
            # deliberate per-lane backpressure: a lane at depth blocks
            # ONLY its own stream's submitters on the lane lock; the
            # worker holds no lock while draining, so the put always
            # unblocks at store speed, and close() (which queues
            # behind this lock only for the sentinel insert) is
            # bounded the same way
            # analyze: ok wait-holding — see rationale above
            self._queues[lane].put(
                (logid, payloads, compression, fut))
        return fut

    def _finish(self, inner: "Future[int]", out: Future) -> None:
        with self._stat_lock:
            self.completed += 1
        err = inner.exception()
        if err is not None:
            out.set_exception(err)
        else:
            out.set_result(inner.result())

    def _lane_loop(self, q: queue.Queue) -> None:
        # exits ONLY on the sentinel: an early _closed return could
        # strand an item (and its Future) a racing submit enqueued just
        # before close() flipped the flag — close() always sentinels
        # (the thread is a daemon, so a never-closed front cannot hang
        # process exit)
        while True:
            try:
                item = q.get(timeout=0.5)
            except queue.Empty:
                continue
            if item is None:  # close sentinel
                return
            logid, payloads, compression, fut = item
            try:
                lsn = self._store.append_batch(
                    logid, payloads, compression)
            except BaseException as e:  # noqa: BLE001 — the failure
                # belongs to the submitting RPC, not this worker
                err, lsn = e, None
            else:
                err = None
            # completion counts BEFORE the waiter wakes (stats contract)
            with self._stat_lock:
                self.completed += 1
            if err is not None:
                fut.set_exception(err)
            else:
                fut.set_result(lsn)

    def stats(self) -> dict:
        with self._stat_lock:
            submitted, completed = self.submitted, self.completed
        return {"lanes": self.lanes,
                "async": self._async,
                "submitted": submitted,
                "completed": completed,
                "in_flight": submitted - completed}

    def close(self, timeout: float = 5.0) -> None:
        """Drain the lanes and reap the workers. Pending futures still
        resolve (each lane finishes its queue up to the sentinel)."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
        # _closed is set; each lane's sentinel goes in under ITS lock,
        # so no submit can slip an item behind it
        for q, lk in zip(self._queues, self._lane_locks):
            with lk:
                q.put(None)
        for t in self._threads:
            t.join(timeout=timeout)
