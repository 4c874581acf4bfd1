"""FlowGovernor: the one admission-control object the server consults.

Ties together the quota tree (hierarchical token buckets), the overload
detector (graded shed ladder), and the credit-window default for push
delivery. Quotas persist through the CAS-versioned config store under
``flow/quota/<scope>`` so they survive restart and ride store
replication like any other cluster config.

Hot-path contract: when no quota is configured and the detector is at
ADMIT, ``governor.active`` is False and ingress paths skip everything
after one attribute read — no locks, no allocation (the acceptance bar:
unchanged-config throughput within noise).

Shed ladder (overload.ADMIT/DEFER/REJECT):
  * DEFER  — background work (connectors, snapshot cadence, boot-time
    query adoption) is deferred with a retry hint; user traffic flows.
  * REJECT — user appends are refused with RESOURCE_EXHAUSTED + a
    retry-after hint as well. Reads are never shed: draining consumers
    is how backlog-driven overload recovers.
"""

# A copy of hstream_tpu/flow/governor.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import threading
import time

from hstream_tpu_torch.common.errors import ResourceExhausted
from hstream_tpu_torch.common.logger import get_logger
from hstream_tpu_torch.flow.overload import ADMIT, DEFER, REJECT, OverloadDetector
from hstream_tpu_torch.flow.quota import Quota, QuotaTree, validate_scope

log = get_logger("flow")

QUOTA_PREFIX = "flow/quota/"
DEFAULT_CREDIT_WINDOW = 256

WORK_USER = "user"
WORK_BACKGROUND = "background"


class FlowGovernor:
    def __init__(self, *, config=None, stats=None, events=None,
                 clock=time.monotonic,
                 credit_window: int = DEFAULT_CREDIT_WINDOW,
                 defer_ms: int = 200, reject_ms: int = 1000,
                 signals: dict[str, tuple[float, float]] | None = None):
        self._config = config          # VersionedConfigStore | None
        self._stats = stats            # StatsHolder | None
        self._events = events          # stats.events.EventJournal | None
        self.clock = clock
        self.credit_window = int(credit_window)
        self.defer_ms = int(defer_ms)
        self.reject_ms = int(reject_ms)
        self.quotas = QuotaTree(clock)
        self.overload = OverloadDetector(
            signals, clock=clock, on_change=self._on_level_change)
        # per-class shed counters (GIL-atomic bumps; flow-status verb).
        # UNIT: denied admission polls, not distinct work items — a
        # deferred connector re-asks every poll cycle, so during a
        # sustained episode `background` grows at poll rate; read it as
        # "how hard the ladder is pushing back", not "tasks shed"
        self.shed_by_class = {WORK_USER: 0, WORK_BACKGROUND: 0}
        self._mutate = threading.Lock()
        # the one-branch hot-path gate: False => ingress skips the
        # governor entirely (plain attribute read, no locks)
        self.active = False

    def _recompute_active(self) -> None:
        self.active = bool(len(self.quotas)) \
            or self.overload.level != ADMIT

    def _on_level_change(self, lvl: int) -> None:
        self._recompute_active()
        if self._events is not None:
            from hstream_tpu_torch.flow.overload import LEVEL_NAMES

            try:
                self._events.append(
                    "shed_level",
                    f"overload ladder -> {LEVEL_NAMES[lvl]}",
                    level=LEVEL_NAMES[lvl])
            except Exception:  # noqa: BLE001 — journaling must never
                pass           # affect admission decisions

    # ---- admission: user ingress -------------------------------------------

    def admit_append(self, stream: str, n_records: int,
                     n_bytes: int) -> None:
        """Raise ResourceExhausted (with retry-after) when the append
        must be refused; otherwise consume quota and return."""
        if self.overload.effective_level() >= REJECT:
            self.shed_by_class[WORK_USER] += 1
            if self._stats is not None:
                self._stats.stream_stat_add("shed_total", stream)
            raise ResourceExhausted(
                f"server overloaded; append to {stream!r} shed",
                retry_after_ms=self.reject_ms)
        wait = self.quotas.admit_append(stream, n_records, n_bytes)
        if wait > 0.0:
            if self._stats is not None:
                self._stats.stream_stat_add("append_throttled", stream)
            raise ResourceExhausted(
                f"quota exceeded on stream {stream!r}",
                retry_after_ms=self._hint_ms(wait))

    def admit_read(self, stream: str) -> None:
        """Gate one read/fetch call on the stream's read quota (reads
        are never overload-shed — draining reduces backlog)."""
        wait = self.quotas.peek_read(stream)
        if wait > 0.0:
            raise ResourceExhausted(
                f"read quota exceeded on stream {stream!r}",
                retry_after_ms=self._hint_ms(wait))

    @staticmethod
    def _hint_ms(wait_s: float) -> int:
        """Retry hint from a bucket wait, capped at 60s so a pathological
        wait (huge deficit) can never overflow or advertise hours."""
        return max(1, int(min(wait_s, 60.0) * 1000.0) + 1)

    def charge_read(self, stream: str, n_records: int) -> None:
        """Charge the actual record count after a read (debt-based, so
        the sustained read rate converges on the quota)."""
        if n_records > 0:
            self.quotas.charge_read(stream, n_records)

    # ---- admission: background work ----------------------------------------

    def admit_background(self, kind: str = "background") -> float:
        """0.0 = proceed; else the suggested wait in seconds before
        retrying. Background work sheds one ladder rung EARLIER than
        user traffic (at DEFER), so connectors/snapshots/adoption give
        their cycles back before any user append is refused."""
        lvl = self.overload.effective_level()
        if lvl >= DEFER:
            self.shed_by_class[WORK_BACKGROUND] += 1
            hint_ms = self.reject_ms if lvl >= REJECT else self.defer_ms
            return hint_ms / 1000.0
        return 0.0

    # ---- quota configuration (persisted) -----------------------------------

    def set_quota(self, scope: str, quota: Quota) -> Quota:
        validate_scope(scope)
        with self._mutate:
            self._persist(scope, quota.to_bytes())
            self.quotas.set(scope, quota)
            self._recompute_active()
        return quota

    def unset_quota(self, scope: str) -> None:
        validate_scope(scope)
        with self._mutate:
            self._persist(scope, None)
            self.quotas.unset(scope)
            self._recompute_active()

    def get_quota(self, scope: str) -> Quota | None:
        return self.quotas.get(scope)

    def list_quotas(self) -> dict[str, Quota]:
        return self.quotas.scopes()

    def _persist(self, scope: str, value: bytes | None) -> None:
        if self._config is None:
            return
        from hstream_tpu_torch.store.versioned import VersionMismatch

        key = QUOTA_PREFIX + scope
        for _ in range(16):
            cur = self._config.get(key)
            try:
                if value is None:
                    if cur is None:
                        return
                    self._config.delete(key, base_version=cur[0])
                else:
                    self._config.put(
                        key, value,
                        base_version=None if cur is None else cur[0])
                return
            except VersionMismatch:
                continue
        log.warning("quota write for %s kept losing CAS", scope)

    def load(self) -> int:
        """Boot-time restore of persisted quotas; returns how many
        scopes were loaded."""
        if self._config is None:
            return 0
        n = 0
        with self._mutate:
            for key in self._config.keys():
                if not key.startswith(QUOTA_PREFIX):
                    continue
                cur = self._config.get(key)
                if cur is None:
                    continue
                scope = key[len(QUOTA_PREFIX):]
                try:
                    self.quotas.set(scope, Quota.from_bytes(cur[1]))
                    n += 1
                except (ValueError, KeyError):
                    log.warning("ignoring malformed quota %s", scope)
            self._recompute_active()
        return n

    # ---- introspection ------------------------------------------------------

    def status(self) -> dict:
        out = self.overload.status()
        out["active"] = self.active
        out["credit_window"] = self.credit_window
        out["shed"] = dict(self.shed_by_class)
        out["quotas"] = {scope: q.to_json()
                         for scope, q in self.list_quotas().items()}
        return out
