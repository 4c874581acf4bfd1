"""Token bucket: the rate primitive under every quota.

Reference: LogDevice enforces per-log append quotas with token buckets
below the sequencer (the tier our host-side staging plays here). This
implementation is lock-cheap — one short critical section per call, no
waiting inside the lock — and clock-injectable so tier-1 tests drive it
with a fake clock instead of sleeps.

Admission is peek-then-take: `peek` reports the wait (seconds) until
`n` tokens accrue without consuming anything; `take` deducts
unconditionally and may drive the balance negative ("debt"). Debt makes
sustained admission converge exactly on the configured rate even when
callers charge after the fact (read paths that only know the true count
post-read) or when two admitters race between peek and take.
"""

# A copy of hstream_tpu/flow/bucket.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import threading
import time


class TokenBucket:
    __slots__ = ("rate", "burst", "_tokens", "_t", "_lock", "_clock")

    def __init__(self, rate: float, burst: float | None = None, *,
                 clock=time.monotonic):
        self.rate = float(rate)
        # default burst: one second's worth (never below 1 so a
        # fractional rate can still ever admit a single record)
        self.burst = float(burst if burst is not None
                           else max(self.rate, 1.0))
        self._tokens = self.burst
        self._clock = clock
        self._t = clock()
        self._lock = threading.Lock()

    def _refill_locked(self, now: float) -> None:
        if now > self._t:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t) * self.rate)
        self._t = now

    def peek(self, n: float = 1.0) -> float:
        """Seconds until `n` tokens are available; 0.0 = admissible now.
        A request larger than the whole burst is admissible once the
        bucket is FULL (it then goes into debt via take) — otherwise the
        advertised wait could never come true, since tokens cap at
        burst."""
        target = min(n, self.burst)
        now = self._clock()
        with self._lock:
            self._refill_locked(now)
            if self._tokens >= target:
                return 0.0
            need = target - self._tokens
        if self.rate <= 0.0:
            return float("inf")
        return need / self.rate

    def take(self, n: float = 1.0) -> None:
        """Deduct `n` tokens unconditionally (balance may go negative —
        the debt is repaid by refill before anything else is admitted)."""
        now = self._clock()
        with self._lock:
            self._refill_locked(now)
            self._tokens -= n

    def try_take(self, n: float = 1.0) -> float:
        """peek+take in one critical section: returns 0.0 and consumes
        on admit, else the wait in seconds with nothing consumed.
        Oversize requests (n > burst) admit at a full bucket and go
        into debt, same as peek/take."""
        target = min(n, self.burst)
        now = self._clock()
        with self._lock:
            self._refill_locked(now)
            if self._tokens >= target:
                self._tokens -= n
                return 0.0
            need = target - self._tokens
        if self.rate <= 0.0:
            return float("inf")
        return need / self.rate

    @property
    def tokens(self) -> float:
        with self._lock:
            self._refill_locked(self._clock())
            return self._tokens
