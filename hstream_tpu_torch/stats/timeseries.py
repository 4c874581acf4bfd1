"""MultiLevelTimeSeries: fixed-ring rate ladders (folly's shape).

Reference: every per-stream stat feeds a folly ``MultiLevelTimeSeries``
— a small stack of ring buffers at widening bucket widths plus an
all-time accumulator, so "appends/s over the last minute / 10 minutes /
hour" is one O(levels) read with no per-query scan (stats.h:56-118).
The previous reproduction kept a single dict ring of 1s buckets pruned
by comprehension on the add path — per-add dict churn, one window, and
an O(window) sum per query.

Here each level is a pair of fixed lists (sums, counts) over ``n``
buckets of ``width_s`` seconds. ``add`` is O(1): integer-divide now
into a bucket index, lazily rotate the ring forward (work is bounded by
the ring size and amortizes to O(1) across adds), bump one slot. A
query first rotates to *its* now, then folds the ring — so the value is
EXACTLY "sum of adds whose second lands in the trailing ``n`` bucket
slots aligned to ``width_s``", the property the brute-force tests
recount (tests/test_cluster_stats.py).

Late adds land in their own bucket when it is still inside the ring and
are dropped from the levels (never from the all-time sum/count) once
older than the widest slot — time never flows backwards through a ring.
"""

# A copy of hstream_tpu/stats/timeseries.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import threading
import time

# (bucket seconds, bucket count) per level, narrow -> wide: 60 x 1s,
# 60 x 10s, 60 x 60s — the reference ladder — plus the implicit
# all-time level (sum/count since process start).
DEFAULT_LEVELS = ((1, 60), (10, 60), (60, 60))

# operator-facing names for the default ladder's trailing windows
INTERVALS = {"1min": 0, "10min": 1, "1h": 2}
INTERVAL_NAMES = tuple(INTERVALS)  # declaration order: narrow -> wide


def level_for_window(window_s: float,
                     levels=DEFAULT_LEVELS) -> int:
    """Index of the narrowest level whose trailing window covers
    ``window_s`` seconds (the widest level when none does)."""
    for i, (width, n) in enumerate(levels):
        if width * n >= window_s:
            return i
    return len(levels) - 1


class _Level:
    """One fixed ring: ``n`` buckets of ``width_s`` seconds. The owner
    (MultiLevelTimeSeries) holds the lock; nothing here locks."""

    __slots__ = ("width", "n", "sums", "counts", "cur", "head")

    def __init__(self, width_s: int, n_buckets: int):
        self.width = int(width_s)
        self.n = int(n_buckets)
        self.sums = [0.0] * self.n
        self.counts = [0] * self.n
        # bucket index (seconds // width) the head slot represents;
        # -1 = empty ring (first add claims its bucket without rotating
        # through the whole span since the epoch)
        self.cur = -1
        self.head = 0

    def rotate(self, bucket: int) -> None:
        """Advance the ring so ``bucket`` is the head slot, zeroing
        every slot rolled past. Work is capped at ``n`` slot clears no
        matter how long the series sat idle (a gap wider than the ring
        clears it whole)."""
        if self.cur < 0:
            self.cur = bucket
            return
        steps = bucket - self.cur
        if steps <= 0:
            return
        if steps >= self.n:
            for i in range(self.n):
                self.sums[i] = 0.0
                self.counts[i] = 0
            self.head = 0
        else:
            for _ in range(steps):
                self.head = (self.head + 1) % self.n
                self.sums[self.head] = 0.0
                self.counts[self.head] = 0
        self.cur = bucket

    def add(self, value: float, bucket: int) -> None:
        if bucket >= self.cur or self.cur < 0:
            self.rotate(bucket)
            self.sums[self.head] += value
            self.counts[self.head] += 1
            return
        # late add: its bucket may still be inside the ring
        offset = self.cur - bucket
        if offset < self.n:
            i = (self.head - offset) % self.n
            self.sums[i] += value
            self.counts[i] += 1
        # older than the ring: dropped from this level (all-time
        # accumulation happens in the owner)

    def total(self) -> tuple[float, int]:
        return sum(self.sums), sum(self.counts)


class MultiLevelTimeSeries:
    """Fixed-ring rate ladder + all-time sum/count; thread-safe.

    ``add`` touches one slot per level under one lock — no allocation,
    no dict churn, no pruning pass. Queries (``rate``/``sum``/``avg``/
    ``count``) take a level index or interval name ("1min"/"10min"/
    "1h") and fold that level's ring after rotating it to now.
    """

    __slots__ = ("levels", "total_sum", "total_count", "_lock")

    def __init__(self, levels=DEFAULT_LEVELS):
        self.levels = tuple(_Level(w, n) for w, n in levels)
        self.total_sum = 0.0
        self.total_count = 0
        self._lock = threading.Lock()

    def _level(self, level) -> _Level:
        if isinstance(level, str):
            try:
                level = INTERVALS[level]
            except KeyError:
                raise KeyError(f"unknown interval {level!r} "
                               f"(one of {INTERVAL_NAMES})") from None
        return self.levels[level]

    def add(self, value: float, now: float | None = None) -> None:
        sec = int(now if now is not None else time.time())
        v = float(value)
        with self._lock:
            self.total_sum += v
            self.total_count += 1
            for lv in self.levels:
                lv.add(v, sec // lv.width)

    def sum(self, level=0, now: float | None = None) -> float:
        """Sum of adds over the level's trailing window."""
        sec = int(now if now is not None else time.time())
        lv = self._level(level)
        with self._lock:
            lv.rotate(sec // lv.width)
            return sum(lv.sums)

    def count(self, level=0, now: float | None = None) -> int:
        sec = int(now if now is not None else time.time())
        lv = self._level(level)
        with self._lock:
            lv.rotate(sec // lv.width)
            return sum(lv.counts)

    def avg(self, level=0, now: float | None = None) -> float:
        """Mean add value over the window (0.0 while empty)."""
        sec = int(now if now is not None else time.time())
        lv = self._level(level)
        with self._lock:
            lv.rotate(sec // lv.width)
            s, c = lv.total()
        return s / c if c else 0.0

    def rate(self, level=0, now: float | None = None) -> float:
        """Per-second rate over the level's trailing window."""
        lv = self._level(level)
        return self.sum(level, now) / float(lv.width * lv.n)

    def all_time(self) -> tuple[float, int]:
        """(sum, count) since construction — never windowed."""
        with self._lock:
            return self.total_sum, self.total_count

    def ladder(self, now: float | None = None) -> dict[str, float]:
        """Every interval's per-second rate plus the all-time sum —
        the NodeStatsReport / stream_rate exposition shape."""
        out = {name: self.rate(i, now) for name, i in INTERVALS.items()}
        s, c = self.all_time()
        out["total"] = s
        out["total_count"] = float(c)
        return out
