"""Overload detector: EWMA'd load signals -> a graded shed level.

Signals are the ones the repo already produces: pipeline stage
occupancy and reorder-ring depth (engine/pipeline), per-chunk
step latency (server/tasks), and subscription backlog
(server/subscriptions). Each signal keeps per-SOURCE exponentially
weighted moving averages (source = the query task / subscription that
fed the sample) against a (warn, critical) threshold pair; the level is
the worst fresh source of the worst signal:

    ADMIT  (0)  everything flows
    DEFER  (1)  background work (connectors, snapshots, adoption) sheds
    REJECT (2)  user appends are refused with a retry-after hint too

Per-source max aggregation means an overloaded subscription cannot be
averaged away by idle siblings feeding zeros; per-source staleness
means a producer that died at critical (a deleted subscription, a
terminated query) expires on its own clock instead of pinning the
ladder. The EWMA is fast-attack/slow-release: overload is detected
quickly, recovery needs sustained low samples. `level` is a plain int
attribute so hot-path readers take no lock.
"""

# A copy of hstream_tpu/flow/overload.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import threading
import time

ADMIT = 0
DEFER = 1
REJECT = 2

LEVEL_NAMES = {ADMIT: "admit", DEFER: "defer", REJECT: "reject"}

# name -> (warn, critical); reorder_depth is a fraction of ring depth
DEFAULT_SIGNALS: dict[str, tuple[float, float]] = {
    "pipeline_occupancy": (0.85, 0.97),
    "step_latency_ms": (200.0, 1000.0),
    "reorder_depth": (0.75, 1.0),
    "sub_backlog": (10_000.0, 100_000.0),
}

# a source with no fresh samples expires: a producer that died (or went
# idle without feeding zeros) must not pin the shed ladder forever
STALE_AFTER_S = 10.0

_MAX_SOURCES = 64  # prune ceiling per signal (sources churn with tasks)


class _Signal:
    __slots__ = ("warn", "crit", "alpha", "sources")

    def __init__(self, warn: float, crit: float, alpha: float):
        self.warn = warn
        self.crit = crit
        self.alpha = alpha
        # source key -> [ewma value, last-sample clock]
        self.sources: dict[str | None, list[float]] = {}

    def note(self, v: float, source: str | None, now: float) -> None:
        e = self.sources.get(source)
        if e is None:
            e = self.sources[source] = [0.0, now]
        # asymmetric smoothing: attack at alpha, release at alpha/4 —
        # overload is detected quickly but recovery needs sustained low
        # samples, so the shed level cannot flap on a single idle tick
        a = self.alpha if v > e[0] else self.alpha / 4.0
        e[0] += a * (v - e[0])
        e[1] = now
        if len(self.sources) > _MAX_SOURCES:
            cutoff = now - 10.0 * STALE_AFTER_S
            for k in [k for k, s in self.sources.items()
                      if s[1] < cutoff]:
                del self.sources[k]

    def fresh_value(self, now: float, stale_after: float) -> float:
        """Worst EWMA across sources with fresh samples (0.0 if none)."""
        best = 0.0
        for e in self.sources.values():
            if now - e[1] <= stale_after and e[0] > best:
                best = e[0]
        return best

    def level_of(self, value: float) -> int:
        if value >= self.crit:
            return REJECT
        if value >= self.warn:
            return DEFER
        return ADMIT


class OverloadDetector:
    def __init__(self, signals: dict[str, tuple[float, float]] | None = None,
                 *, alpha: float = 0.5, on_change=None,
                 clock=time.monotonic,
                 stale_after_s: float = STALE_AFTER_S):
        self._sigs = {name: _Signal(w, c, alpha)
                      for name, (w, c) in
                      (DEFAULT_SIGNALS if signals is None
                       else signals).items()}
        self._lock = threading.Lock()
        self._on_change = on_change
        self._clock = clock
        self._stale_after = float(stale_after_s)
        self.level = ADMIT  # lock-free hot-path read

    def register(self, name: str, warn: float, crit: float, *,
                 alpha: float = 0.5) -> None:
        with self._lock:
            self._sigs[name] = _Signal(warn, crit, alpha)

    def _level_locked(self, now: float) -> int:
        lvl = ADMIT
        for s in self._sigs.values():
            sl = s.level_of(s.fresh_value(now, self._stale_after))
            if sl > lvl:
                lvl = sl
        return lvl

    def note(self, name: str, value: float,
             source: str | None = None) -> None:
        """Feed one sample from `source` (the query/subscription id);
        recomputes the graded level. Unregistered signal names raise
        (same registry discipline as stats)."""
        cb = None
        now = self._clock()
        with self._lock:
            sig = self._sigs.get(name)
            if sig is None:
                raise KeyError(f"unregistered overload signal {name!r}")
            sig.note(value, source, now)
            lvl = self._level_locked(now)
            if lvl != self.level:
                self.level = lvl
                cb = self._on_change
        if cb is not None:
            cb(lvl)

    def effective_level(self) -> int:
        """The level admission decisions act on: each signal source
        counts only while its own samples are fresh, so a dead producer
        expires instead of pinning the ladder. A stale recompute that
        disagrees writes the level back (and re-fires on_change), so
        the hot-path gate recovers even when no producer ever feeds
        another sample."""
        # deliberate lock-free fast path: the quiet-system gate must
        # cost one attribute read; a stale ADMIT is corrected by the
        # next note(), any non-ADMIT read falls into the locked path
        if self.level == ADMIT:  # analyze: ok lock-guard
            return ADMIT
        now = self._clock()
        cb = None
        with self._lock:
            lvl = self._level_locked(now)
            if lvl != self.level:
                self.level = lvl
                cb = self._on_change
        if cb is not None:
            cb(lvl)
        return lvl

    def status(self) -> dict:
        now = self._clock()
        with self._lock:
            out = {"level": LEVEL_NAMES[self._level_locked(now)],
                   "signals": {}}
            for name, s in self._sigs.items():
                v = s.fresh_value(now, self._stale_after)
                out["signals"][name] = {
                    "value": round(v, 4), "warn": s.warn,
                    "critical": s.crit,
                    "sources": len(s.sources),
                    "level": LEVEL_NAMES[s.level_of(v)]}
            return out
