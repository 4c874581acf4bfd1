"""Credit window: per-consumer in-flight bound for push delivery.

Each StreamingFetch consumer carries `window` credits; the dispatcher
takes one credit per delivered record and acks refill them. At zero
credits delivery pauses, so a stalled consumer holds at most its window
of undelivered records server-side — the server's memory per consumer
is bounded no matter how slow the client drains.
"""

# A copy of hstream_tpu/flow/credit.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import threading


class CreditWindow:
    def __init__(self, window: int):
        if window <= 0:
            raise ValueError("credit window must be positive")
        self.window = int(window)
        self._avail = int(window)
        self._cv = threading.Condition()

    @property
    def available(self) -> int:
        # found by hstream-analyze (lock-guard): _avail is mutated
        # under _cv by take_up_to (dispatcher) and refill (ack
        # threads); the unlocked read fed torn in-flight values to the
        # credit_inflight gauge
        with self._cv:
            return self._avail

    def take_up_to(self, n: int, timeout: float = 0.0) -> int:
        """Take up to `n` credits; blocks up to `timeout` for the first
        credit. Returns how many were taken (0 = window exhausted)."""
        with self._cv:
            if self._avail <= 0 and timeout > 0.0:
                self._cv.wait_for(lambda: self._avail > 0, timeout)
            take = min(int(n), self._avail)
            if take > 0:
                self._avail -= take
            return take

    def refill(self, n: int) -> None:
        """Return `n` credits (acks, failed deliveries); capped at the
        window so duplicate acks cannot inflate it."""
        if n <= 0:
            return
        with self._cv:
            self._avail = min(self.window, self._avail + int(n))
            self._cv.notify_all()
