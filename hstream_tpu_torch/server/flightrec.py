"""Flight recorder: bounded postmortem bundles for distressed queries.

When a query first goes STALLED (the health
plane's transition edge, health.evaluate_query) or its crash-loop
breaker opens (scheduler._open_breaker), the moment an operator wants
the evidence is exactly the moment it starts rotting: the journal ring
overwrites, trace spans recycle, the task dies and takes its counters
with it. The flight recorder snapshots everything the postmortem needs
INTO ONE BUNDLE at the transition edge — last-N journal events, the
query's trace spans, the health verdict with reasons, its stat-ladder
row, the compiled-program inventory, and the HBM arena accounting —
and keeps it in a two-slot per-query rotation that SURVIVES query
deletion (the bundle is the black box; deleting the aircraft must not
shred it).

Served via ``GET /queries/<id>/flightrec`` and ``admin flightrec
<id>``; every write journals a ``flightrec_written`` event carrying
the pointer an operator greps for.

Capture cost discipline: host-side folds only — zero device
dispatches, zero fetches, bounded list copies. Every section is
individually best-effort: a half-torn-down subsystem yields an
``"error"`` marker in that section, never a lost bundle.
"""

# A copy of hstream_tpu/server/flightrec.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Any

# bounds: the bundle is a black box, not an archive
EVENTS_TAIL = 64       # journal entries captured per bundle
SPANS_CAP = 128        # trace spans captured per bundle
PROGRAM_ROWS_CAP = 64  # program-inventory rows captured per bundle
SLOTS_PER_QUERY = 2    # bundle rotation depth per query
MAX_QUERIES = 32       # LRU bound on distinct queries with bundles


class FlightRecorder:
    """Two-slot-per-query rotation of postmortem bundles, LRU-bounded
    across queries; thread-safe. Construction is cheap — the recorder
    holds nothing until the first distress edge fires."""

    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self._lock = threading.Lock()
        # qid -> deque of bundles (newest last); OrderedDict as LRU
        self._slots: "OrderedDict[str, deque[dict[str, Any]]]" = \
            OrderedDict()
        self._seq = 0
        self.written = 0  # total bundles ever recorded

    # ---- capture -----------------------------------------------------------

    def snapshot(self, qid: str, *, trigger: str,
                 health: dict[str, Any] | None = None) -> dict[str, Any]:
        """Capture one bundle for `qid` at a distress edge. `trigger`
        names the edge ("query_stalled" | "crash_loop_open"); `health`
        is the already-computed verdict dict when the caller has one
        (re-evaluating here would re-fire the transition journaling).
        Never raises — a flight recorder that crashes the plane it is
        recording has failed at its one job."""
        ctx = self.ctx
        with self._lock:
            self._seq += 1
            seq = self._seq
        bundle: dict[str, Any] = {
            "query": qid,
            "trigger": trigger,
            "seq": seq,
            "ts_ms": int(time.time() * 1e3),
        }
        if health is not None:
            bundle["health"] = dict(health)
        bundle["events"] = self._capture_events()
        bundle["spans"] = self._capture_spans(qid)
        bundle["stat_ladder"] = self._capture_stat_ladder(qid)
        bundle["programs"] = self._capture_programs()
        bundle["hbm"] = self._capture_hbm(qid)
        with self._lock:
            ring = self._slots.get(qid)
            if ring is None:
                ring = deque(maxlen=SLOTS_PER_QUERY)
                self._slots[qid] = ring
            ring.append(bundle)
            self._slots.move_to_end(qid)
            while len(self._slots) > MAX_QUERIES:
                self._slots.popitem(last=False)
            self.written += 1
            n_slots = len(ring)
        try:
            ctx.events.append(
                "flightrec_written",
                f"flight recorder captured query {qid} "
                f"({trigger}); GET /queries/{qid}/flightrec",
                query=qid, trigger=trigger, seq=seq, slots=n_slots)
        except Exception:  # noqa: BLE001 — journaling is best-effort
            pass
        return bundle

    # ---- per-section capture (each individually best-effort) ---------------

    def _capture_events(self) -> Any:
        try:
            return self.ctx.events.query(limit=EVENTS_TAIL)
        except Exception as e:  # noqa: BLE001
            return {"error": type(e).__name__}

    def _capture_spans(self, qid: str) -> Any:
        try:
            spans = self.ctx.tracing.spans(qid)
            return spans[-SPANS_CAP:]
        except Exception as e:  # noqa: BLE001
            return {"error": type(e).__name__}

    def _capture_stat_ladder(self, qid: str) -> Any:
        """The query's full rate ladder, every query-scope family —
        the `admin stats queries` row frozen at the distress edge."""
        try:
            from hstream_tpu_torch.stats.families import families_for_scope

            out = {}
            for fam in families_for_scope("query"):
                lad = self.ctx.stats.stat_ladder(fam.name, qid)
                out[fam.name] = {k: (round(v, 3)
                                     if isinstance(v, float) else v)
                                 for k, v in lad.items()}
            return out
        except Exception as e:  # noqa: BLE001
            return {"error": type(e).__name__}

    def _capture_programs(self) -> Any:
        try:
            from hstream_tpu_torch.stats.devicecost import PROGRAMS

            return {"summary": PROGRAMS.summary(),
                    "rows": PROGRAMS.rows()[:PROGRAM_ROWS_CAP]}
        except Exception as e:  # noqa: BLE001
            return {"error": type(e).__name__}

    def _capture_hbm(self, qid: str) -> Any:
        try:
            from hstream_tpu_torch.stats.devicecost import (
                backend_hbm_bytes,
                query_hbm_bytes,
            )

            out = query_hbm_bytes(self.ctx, qid)
            backend = backend_hbm_bytes()
            if backend is not None:
                out["backend_bytes_in_use"] = backend
            return out
        except Exception as e:  # noqa: BLE001
            return {"error": type(e).__name__}

    # ---- read surface ------------------------------------------------------

    def bundles(self, qid: str) -> list[dict[str, Any]]:
        """Newest-last bundles for a query (empty when none) — works
        after the query itself is deleted."""
        with self._lock:
            ring = self._slots.get(qid)
            return [dict(b) for b in ring] if ring is not None else []

    def queries(self) -> list[str]:
        """Query ids with at least one bundle, oldest-written first."""
        with self._lock:
            return list(self._slots)

    def summary(self) -> dict[str, Any]:
        with self._lock:
            return {
                "written": self.written,
                "queries": {q: len(r) for q, r in self._slots.items()},
                "slots_per_query": SLOTS_PER_QUERY,
                "max_queries": MAX_QUERIES,
            }
