"""Window specifications (a copy of hstream_tpu/engine/window.py;
`num_slots` must stay identical, since state carries across).

Reference semantics (hstream-processing Stream/TimeWindows.hs:23-43):
tumbling = hopping with advance == size; grace defaults to 24h; a record
with timestamp ts belongs to every window [s, s+size) with
s in (ts-size, ts] and s ≡ 0 (mod advance). Session windows
(SessionWindows.hs) merge records closer than `gap`.

Device mapping for fixed windows: window with start s occupies lattice
slot (s // advance) mod W, where W = ceil((size+grace)/advance) + 2 covers
every window that can still legally receive records, so a slot is never
reused before the host has closed and reset it.
"""

from __future__ import annotations

from dataclasses import dataclass

DEFAULT_GRACE_MS = 24 * 3600 * 1000


@dataclass(frozen=True)
class TumblingWindow:
    size_ms: int
    grace_ms: int = DEFAULT_GRACE_MS

    @property
    def advance_ms(self) -> int:
        return self.size_ms

    @property
    def windows_per_record(self) -> int:
        return 1


@dataclass(frozen=True)
class HoppingWindow:
    size_ms: int
    advance_ms: int
    grace_ms: int = DEFAULT_GRACE_MS

    def __post_init__(self):
        if self.size_ms % self.advance_ms != 0:
            raise ValueError("hop size must be a multiple of advance")

    @property
    def windows_per_record(self) -> int:
        return self.size_ms // self.advance_ms


@dataclass(frozen=True)
class SessionWindow:
    gap_ms: int
    grace_ms: int = DEFAULT_GRACE_MS


FixedWindow = TumblingWindow | HoppingWindow
WindowSpec = TumblingWindow | HoppingWindow | SessionWindow


def num_slots(w: FixedWindow) -> int:
    """In-flight slot count W for the state lattice."""
    return (w.size_ms + w.grace_ms + w.advance_ms - 1) // w.advance_ms + 2
