"""Bounded structured event journal: operator-significant transitions.

Counters and gauges answer "how much"; the journal answers "what
happened and when" — the discrete transitions an operator greps for
during an incident: shed-ladder changes, degraded appends, query
adoption/restart/death, snapshot persist failures. The reference keeps
these in unstructured logDebug lines; here they are structured entries
in a fixed-capacity ring, queryable via admin `events` and the
gateway's ``GET /events``.

Entries are dicts: {seq, ts_ms, kind, message, **fields}. `seq` is a
process-monotone cursor so a poller can resume with ``since`` instead
of re-reading the window. The ring drops the oldest entry on overflow —
appending is O(1) and never blocks the subsystem reporting the event.
"""

# A copy of hstream_tpu/stats/events.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any

# The kind vocabulary (the journal's .inc analogue): append() rejects
# unregistered kinds so the queryable surface stays enumerable.
EVENT_KINDS = [
    "shed_level",        # overload ladder transition (admit/defer/reject)
    "degraded_append",   # replicated ack fell short of the quorum
    "follower_down",     # a store follower stopped acking
    "leader_change",     # a follower accepted a new leader id
    "query_adopted",     # boot-time takeover of a dead owner's query
    "query_restarted",   # operator RestartQuery
    "query_died",        # task hit CONNECTION_ABORT
    "snapshot_failed",   # background state persist failed
    "query_restart_scheduled",  # supervisor queued a restart (backoff)
    "crash_loop_open",   # K failures in W seconds -> breaker FAILED
    "snapshot_corrupt",  # restore skipped a corrupt snapshot slot
    "checkpoint_corrupt",  # checkpoint store recovered from bad bytes
    "fault_injected",    # a chaos fault site fired
    "adoption_lost",     # lost the CAS race adopting a query
    "replica_fenced",    # a stale leader was rejected by epoch (or
                         # THIS leader learned it was fenced)
    "replica_promoted",  # a replica was raised to leadership
    "replica_ack_timeout",  # a follower-ack deadline expired; the
                            # append degraded honestly
    "query_stalled",     # the health plane's verdict for a query
                         # crossed into STALLED (backlog with no
                         # watermark progress, crash loop, or a dead
                         # unowned task) — the machine-readable signal
                         # failover adoption and the placer gate on
    "lock_cycle",        # the runtime lock-order witness (locktrace)
                         # saw both directions of a lock pair — a
                         # potential deadlock reported WITHOUT needing
                         # the unlucky schedule (GoodLock)
    "node_load_report",  # periodic per-node load fold (stats/cluster):
                         # per-stream append rates, query health
                         # counts, append-front depth, rss — THE
                         # machine-readable load signal the thousand-
                         # query placer gates on (ROADMAP item 2)
    "placement_decision",  # the placer wrote a decision onto
                           # scheduler/query/*: placed a new query,
                           # live-adopted a lapsed owner's query, or
                           # offered one away in a rebalance — with
                           # the machine-readable reason + scores
    "flightrec_written",   # the flight recorder snapshotted a
                           # postmortem bundle for a query (first
                           # STALLED verdict of an episode, or the
                           # crash-loop breaker opening) — the pointer
                           # an operator follows to GET
                           # /queries/<id>/flightrec
]


class EventJournal:
    """Fixed-capacity ring of structured events; thread-safe."""

    def __init__(self, capacity: int = 1024):
        self.capacity = max(int(capacity), 1)
        self._ring: deque[dict[str, Any]] = deque(maxlen=self.capacity)
        self._seq = 0
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def append(self, kind: str, message: str, **fields: Any) -> int:
        """Record one event; returns its seq. Fields must be
        JSON-serializable (they travel through admin/HTTP as JSON)."""
        if kind not in EVENT_KINDS:
            raise KeyError(f"unregistered event kind {kind!r}")
        entry = {"kind": kind, "message": message,
                 "ts_ms": int(time.time() * 1000), **fields}
        with self._lock:
            self._seq += 1
            entry["seq"] = self._seq
            self._ring.append(entry)
            return self._seq

    @property
    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    def query(self, *, kind: str | None = None, since: int = 0,
              limit: int = 100) -> list[dict[str, Any]]:
        """Newest-last slice of the window: entries with seq > since,
        optionally one kind, capped at the LAST `limit` matches."""
        with self._lock:
            entries = list(self._ring)
        out = [dict(e) for e in entries
               if e["seq"] > since and (kind is None or e["kind"] == kind)]
        return out[-max(int(limit), 1):]
