"""Reusable state-store surface (a copy of
hstream_tpu/engine/statestore.py).

Reference: hstream-processing's Store.hs classes — `KVStore`
(ksGet/ksPut/ksRange/ksDump), `TimestampedKVStore` (tksPut/tksRange),
`SessionStore` (findSessions/ssPut/ssRemove) — the storage vocabulary
its processors build on (Store.hs:55-144,316-409). Here the hot
aggregation state lives in the device lattice instead, so these stores
serve the HOST-side stateful operators: the interval join's two-sided
timestamped store, the stream-table join's last-value table, and any
future host operator needing keyed state.
"""

from __future__ import annotations

import bisect


class TimestampedKVStore:
    """Per-key timestamped rows: key -> (sorted ts list, rows list).
    The reference's TimestampedKVStore tksPut/tksRange
    (Processing/Store.hs). The interval join's side stores use the flat
    batched restatement of this shape (join._FlatIntervalStore); this
    per-key form remains the reusable host-operator surface."""

    def __init__(self) -> None:
        self.by_key: dict[tuple, tuple[list[int], list[dict]]] = {}

    def put(self, key: tuple, ts: int, row: dict) -> None:
        tss, rows = self.by_key.setdefault(key, ([], []))
        i = bisect.bisect_right(tss, ts)
        tss.insert(i, ts)
        rows.insert(i, row)

    def range(self, key: tuple, lo: int, hi: int):
        """Rows with lo <= ts <= hi for this key (tksRange)."""
        ent = self.by_key.get(key)
        if ent is None:
            return []
        tss, rows = ent
        i = bisect.bisect_left(tss, lo)
        j = bisect.bisect_right(tss, hi)
        return list(zip(tss[i:j], rows[i:j]))

    def prune(self, min_ts: int) -> None:
        """Drop rows older than min_ts (bounds state where the
        reference's in-memory store grows forever)."""
        dead = []
        for key, (tss, rows) in self.by_key.items():
            i = bisect.bisect_left(tss, min_ts)
            if i:
                del tss[:i]
                del rows[:i]
            if not tss:
                dead.append(key)
        for key in dead:
            del self.by_key[key]


class LastValueStore:
    """Keyed latest-value table: newest timestamp wins, out-of-order
    older updates never clobber (the stream-table join's TABLE side,
    reference Stream.hs:302-344)."""

    def __init__(self) -> None:
        self.data: dict[tuple, tuple[int, dict]] = {}

    def update(self, key: tuple, ts: int, row) -> None:
        """Store `row` (copied) iff at least as new as the current
        entry — the copy only happens for accepted updates."""
        cur = self.data.get(key)
        if cur is None or ts >= cur[0]:
            self.data[key] = (ts, dict(row))

    def lookup(self, key: tuple) -> dict | None:
        ent = self.data.get(key)
        return None if ent is None else ent[1]

    def __len__(self) -> int:
        return len(self.data)
