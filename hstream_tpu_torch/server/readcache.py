"""Read plane: columnar snapshot cache + shared-encode fan-out.

The write path is O(1) dispatches per micro-batch;
this makes the READ path O(1) per close cycle. Two LRU
surfaces share one byte budget:

  * **Snapshot cache** — pull-query results keyed by (view, statement
    text), validated by an exact version tuple: the materialization's
    closed-store counter + the executor's read_version() (engine nonce,
    mutation epoch, close cycles, watermark). N concurrent readers of
    one view cost ONE executor extract + ONE result materialization;
    everyone else is a version-checked hit. The version probe is
    lock-free — every component is a monotone counter bumped AT the
    mutation, so a torn probe yields a spurious miss or a hit
    linearized just before an in-flight mutation, never a stale hit.
    A single-flight latch collapses concurrent misses onto one leader;
    followers consume the leader's cut (which happened after they
    arrived — linearizable).

  * **Expansion cache** — a query sink packs each emitted batch into
    ONE columnar record (tasks.stream_sink); every subscription fetch
    used to re-decode and re-serialize it per consumer. Log records are
    immutable, so the per-row serialized records are cached keyed by
    (logid, lsn, payload index) and every consumer of the stream shares
    the SAME frame bytes by reference — encode once, fan out 10k times.

`--read-max-staleness-ms` additionally age-bounds hits: exactness comes
from the version match, the knob is a freshness SLA backstop (and the
only control for deployments that mutate executors out-of-band). The
budget, hit ratio, and extract counters surface as gauges/counters via
ServerContext.
"""

# A copy of hstream_tpu/server/readcache.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable

from hstream_tpu_torch.common import locktrace
from hstream_tpu_torch.server.views import serve_parts, serve_select_view


class _Entry:
    __slots__ = ("value", "version", "t", "nbytes")

    def __init__(self, value, version, t, nbytes):
        self.value = value
        self.version = version
        self.t = t
        self.nbytes = nbytes


class _Flight:
    """Single-flight latch for one snapshot key: the first miss leads,
    concurrent misses wait and consume the leader's result."""

    __slots__ = ("event", "rows", "ok")

    def __init__(self):
        self.event = threading.Event()
        self.rows = None
        self.ok = False


def _rows_nbytes(rows) -> int:
    """Cheap deterministic size estimate for the byte budget (cells
    priced, strings by length) — budget enforcement needs proportional,
    not exact."""
    total = 64
    for row in rows:
        total += 48
        for k, v in row.items():
            total += 16 + len(k)
            total += len(v) if isinstance(v, str) else 16
    return total


class ReadCache:
    """One process-wide LRU over snapshot + expansion entries.

    `readcache.lru` is a LEAF lock: held only for dict bookkeeping,
    never while taking tasks.state / views.materialization (the compute
    path runs between two separate lock sections) — the locktrace
    witness certifies this at runtime.
    """

    def __init__(self, *, max_bytes: int = 64 << 20,
                 max_staleness_ms: float | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.max_bytes = int(max_bytes)
        self.max_staleness_ms = max_staleness_ms
        self._clock = clock
        self._lock = locktrace.lock("readcache.lru")
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._flights: dict[tuple, _Flight] = {}
        self._bytes = 0
        # counters (host ints; mirrored into gauges/counters by ctx)
        self.hits = 0            # version-valid snapshot hits
        self.shared = 0          # followers served by a flight leader
        self.misses = 0          # snapshot recomputes
        self.bypasses = 0        # unversioned executors (never cached)
        self.extracts = 0        # serves that actually peeked the engine
        self.evictions = 0
        self.invalidations = 0
        self.expand_hits = 0
        self.expand_misses = 0

    # ---- gauges ------------------------------------------------------------

    def nbytes(self) -> int:
        return self._bytes

    def hit_ratio(self) -> float:
        served = self.hits + self.shared + self.misses
        return (self.hits + self.shared) / served if served else 0.0

    def stats(self) -> dict[str, int | float]:
        return {"hits": self.hits, "shared": self.shared,
                "misses": self.misses, "bypasses": self.bypasses,
                "extracts": self.extracts, "evictions": self.evictions,
                "invalidations": self.invalidations,
                "expand_hits": self.expand_hits,
                "expand_misses": self.expand_misses,
                "bytes": self._bytes, "entries": len(self._entries),
                "hit_ratio": self.hit_ratio()}

    # ---- snapshot cache (pull queries) -------------------------------------

    def _fresh(self, ent: _Entry, now: float) -> bool:
        if self.max_staleness_ms is None:
            return True
        return (now - ent.t) * 1000.0 <= self.max_staleness_ms

    # contract: dispatches<=1 fetches<=1
    def serve_view(self, name: str, mat, select, sql: str
                   ) -> tuple[list[dict[str, Any]], str, bool]:
        """Serve a pull query through the cache. Returns (rows, how,
        extracted) with how in {"hit", "shared", "miss", "bypass"};
        `extracted` is True only when THIS call ran an executor peek.
        At most ONE extract runs per (view, statement, version) — the
        close-cycle read contract."""
        key = ("snap", name, sql)
        version = mat.version()
        if version is None:
            # unversioned executor: correctness cannot be proven, so
            # this view never caches (and never goes stale)
            rows = serve_select_view(mat, select)
            with self._lock:
                self.bypasses += 1
                self.extracts += 1
            return rows, "bypass", True
        now = self._clock()
        while True:
            with self._lock:
                ent = self._entries.get(key)
                if ent is not None and ent.version == version \
                        and self._fresh(ent, now):
                    self._entries.move_to_end(key)
                    self.hits += 1
                    return list(ent.value), "hit", False
                flight = self._flights.get(key)
                if flight is None:
                    flight = _Flight()
                    self._flights[key] = flight
                    break  # this thread leads the recompute
            # follower: the leader's snapshot cut happens after this
            # request arrived, so consuming it is linearizable
            flight.event.wait(timeout=30.0)
            if flight.ok:
                with self._lock:
                    self.shared += 1
                return list(flight.rows), "shared", False
            # leader failed or timed out: retry (probe again / lead)
            version = mat.version()
            if version is None:
                rows = serve_select_view(mat, select)
                with self._lock:
                    self.bypasses += 1
                    self.extracts += 1
                return rows, "bypass", True
            now = self._clock()
        try:
            closed, live, got_version, peeked = mat.snapshot_parts(select)
            rows = serve_parts(closed, live, select)
            flight.rows = rows
            flight.ok = True
            with self._lock:
                self.misses += 1
                if peeked:
                    self.extracts += 1
                if got_version is not None:
                    self._store(key, rows, got_version,
                                _rows_nbytes(rows), self._clock())
            return list(rows), "miss", peeked
        finally:
            with self._lock:
                self._flights.pop(key, None)
            flight.event.set()

    def invalidate_view(self, name: str) -> None:
        """Drop every snapshot entry of a view (view deletion — version
        nonces already prevent stale hits; this frees the budget)."""
        with self._lock:
            dead = [k for k in self._entries
                    if k[0] == "snap" and k[1] == name]
            for k in dead:
                self._drop(k)
            self.invalidations += len(dead)

    # ---- expansion cache (subscription fan-out) ----------------------------

    def expand_frames(self, logid: int, lsn: int, idx: int,
                      payload: bytes,
                      expand: Callable[[bytes], list[bytes] | None]
                      ) -> list[bytes] | None:
        """Per-row serialized records of one immutable log payload,
        expanded at most once per process and shared BY REFERENCE with
        every consumer (encode-once fan-out). None (cached too) means
        not-columnar: deliver the payload verbatim."""
        key = ("enc", logid, lsn, idx)
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:
                self._entries.move_to_end(key)
                self.expand_hits += 1
                return ent.value
        value = expand(payload)
        nbytes = (sum(len(b) for b in value) + 64) if value else 96
        with self._lock:
            self.expand_misses += 1
            self._store(key, value, None, nbytes, self._clock())
        return value

    # ---- LRU internals (caller holds self._lock) ---------------------------

    def _store(self, key, value, version, nbytes, t) -> None:
        if key in self._entries:
            self._drop(key)
        if nbytes > self.max_bytes:
            return  # larger than the whole budget: never admit
        self._entries[key] = _Entry(value, version, t, nbytes)
        self._bytes += nbytes
        while self._bytes > self.max_bytes and self._entries:
            old_key, old = self._entries.popitem(last=False)
            self._bytes -= old.nbytes
            self.evictions += 1
            if old_key == key:
                break

    def _drop(self, key) -> None:
        ent = self._entries.pop(key, None)
        if ent is not None:
            self._bytes -= ent.nbytes
