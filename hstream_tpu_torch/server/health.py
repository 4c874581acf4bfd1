"""Per-query health rollup: one machine-readable verdict per query.

The signals already exist — supervisor breaker
state, freshness lag, source backlog, device fallbacks, the overload
shed ladder — but an operator (or the thousand-query placer, ROADMAP
item 2) had to join five surfaces to answer "is this query healthy".
`evaluate_query` folds them into OK / DEGRADED / STALLED with reasons,
served via ``GET /queries/<id>/health``, ``admin health``, and the
``query_health_level`` gauge; crossing into STALLED journals a
``query_stalled`` event — the signal the chaos harness gates on today
and failover adoption gates on next.

Everything reads host-mirror values (executor watermarks, checkpoint
LSNs, counters): a health evaluation costs ZERO device dispatches,
fetches, or recompiles.

Verdict rules (thresholds are ServerContext knobs, see README):

  STALLED   crash-loop breaker open (``crash_loop``); task dead with
            no pending restart (``dead``); status RUNNING but no task
            owns it (``unowned``); or source backlog > 0 with no
            watermark advance for ``health_stalled_ms`` (default
            30000) (``no_progress``).
  DEGRADED  supervisor restart pending (``restart_pending``); device
            kernels degraded to the host path (``device_fallback``);
            overload shed ladder at DEFER or above (``overload``); or
            backlog > 0 with no watermark advance for
            ``health_degraded_ms`` (default 5000) (``lagging``).
  OK        none of the above (TERMINATED queries report OK — stopped
            is not sick).
"""

# A copy of hstream_tpu/server/health.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import threading
import time
from typing import Any

from hstream_tpu_torch.server.persistence import TaskStatus

# default thresholds; ServerContext carries per-server overrides
# (--health-degraded-ms / --health-stalled-ms)
DEGRADED_AFTER_MS = 5_000
STALLED_AFTER_MS = 30_000

LEVELS = {"OK": 0, "DEGRADED": 1, "STALLED": 2}


class HealthTracker:
    """Per-query progress memory: last watermark + when it last
    advanced, and the last verdict (so STALLED transitions journal
    exactly once per episode). Evaluation-time state only — nothing
    here is durable or replicated."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # qid -> (last watermark, wall-ms of last advance/first sight)
        self._progress: dict[str, tuple[int, float]] = {}
        self._verdicts: dict[str, str] = {}

    def note_progress(self, qid: str, watermark: int | None,
                      now_ms: float) -> float:
        """Record the query's watermark; returns ms since it last
        advanced (0.0 on first sight or on an advance)."""
        with self._lock:
            prev = self._progress.get(qid)
            if watermark is None:
                # no executor yet: treat task (re)appearance as progress
                if prev is None:
                    self._progress[qid] = (-1, now_ms)
                    return 0.0
                return now_ms - prev[1]
            if prev is None or watermark > prev[0]:
                self._progress[qid] = (watermark, now_ms)
                return 0.0
            return now_ms - prev[1]

    def transition(self, qid: str, verdict: str) -> str | None:
        """Remember the verdict; returns the PREVIOUS verdict when it
        changed (None otherwise)."""
        with self._lock:
            prev = self._verdicts.get(qid)
            if prev == verdict:
                return None
            self._verdicts[qid] = verdict
            return prev or "OK"

    def forget(self, known: set[str]) -> None:
        """Drop memory of queries that no longer exist."""
        with self._lock:
            for qid in list(self._progress):
                if qid not in known:
                    self._progress.pop(qid, None)
                    self._verdicts.pop(qid, None)


def _executor_watermark(task) -> int | None:
    """The executor's event-time watermark (host attribute reads only)
    — delegates to the task's own fold so the health plane and the
    freshness gauges can never disagree on where the watermark lives."""
    fn = getattr(task, "_event_watermark", None)
    return fn() if fn is not None else None


def _source_backlog(ctx, task) -> int:
    """Unprocessed source LSNs: tail minus the highest processed LSN
    per source log (the task's pending checkpoints, or its attach
    point before anything processed)."""
    backlog = 0
    for logid in getattr(task, "_sources", {}):
        try:
            tail = ctx.store.tail_lsn(logid)
        except Exception:  # noqa: BLE001 — stream being deleted
            continue
        processed = task._pending_ckps.get(logid)
        if processed is None:
            processed = task.attached_lsns.get(logid, 1) - 1
        backlog += max(0, tail - processed)
    return backlog


def evaluate_query(ctx, qid: str, *, now_ms: float | None = None,
                   sup_status: dict | None = None,
                   shed_level: int | None = None) -> dict[str, Any]:
    """One query's health verdict + the evidence it folded. Raises
    QueryNotFound for unknown ids (the endpoint maps it to 404).
    ``sup_status``/``shed_level`` let a sweep (sample_health) snapshot
    the server-wide state ONCE instead of per query."""
    from hstream_tpu_torch.server import scheduler

    info = ctx.persistence.get_query(qid)
    now = time.time() * 1e3 if now_ms is None else float(now_ms)
    tracker: HealthTracker = ctx.health
    degraded_ms = float(getattr(ctx, "health_degraded_ms",
                                DEGRADED_AFTER_MS))
    stalled_ms = float(getattr(ctx, "health_stalled_ms",
                               STALLED_AFTER_MS))
    if sup_status is None:
        sup = getattr(ctx, "supervisor", None)
        sup_status = sup.status() if sup is not None else {}
    breaker_open = qid in sup_status.get("breaker_open", ())
    restart_pending = qid in sup_status.get("pending", {})
    task = ctx.running_queries.get(qid)
    if shed_level is None:
        flow = getattr(ctx, "flow", None)
        shed_level = (flow.overload.effective_level()
                      if flow is not None else 0)

    status = getattr(info.status, "name", str(info.status))
    stalled: list[str] = []
    degraded: list[str] = []
    watermark = wm_lag = None
    backlog = 0
    stuck_ms = 0.0
    fallbacks = late = 0
    shards = 0
    owner = None

    if breaker_open:
        stalled.append("crash_loop")
    if restart_pending:
        degraded.append("restart_pending")
    if info.status in (TaskStatus.CONNECTION_ABORT, TaskStatus.FAILED):
        if not restart_pending and not breaker_open:
            stalled.append("dead")
    elif info.status is TaskStatus.RUNNING and task is None \
            and not restart_pending:
        # no task on THIS server drives a RUNNING query. Ownerless —
        # the state failover adoption exists to clear — ONLY when the
        # scheduler record names this node (or nobody): a query owned
        # by a live peer is that peer's to judge, and marking it
        # STALLED from here would journal false distress on every
        # multi-node scrape. (CREATED is excluded: the launch window
        # between insert_query and task registration is milliseconds.)
        owner = scheduler.assignment(ctx, qid)
        owner_node = (owner or {}).get("node")
        if owner_node is None or owner_node == scheduler.node_name(ctx):
            stalled.append("unowned")
        else:
            # owned by a peer: honor its heartbeat lease. A lapsed
            # heartbeat means the owner crashed without cleanup — the
            # query is STALLED "dead" until an armed placer's sweep
            # adopts it; a FRESH peer heartbeat stays healthy here
            # (regression pin: live peers are never flagged).
            age = scheduler.owner_heartbeat_age_ms(owner)
            lease = int(getattr(ctx, "heartbeat_lease_ms", 10_000))
            if age is not None and age > lease:
                stalled.append("dead")

    if task is not None:
        watermark = _executor_watermark(task)
        if watermark is not None:
            wm_lag = max(0.0, now - watermark)
        backlog = _source_backlog(ctx, task)
        stuck_ms = tracker.note_progress(qid, watermark, now)
        fallbacks = task.engine_total("device_fallbacks")
        late = task.engine_total("late_drops")
        shards = int(getattr(task, "mesh_shards", lambda: 0)() or 0)
        if backlog > 0 and stuck_ms >= stalled_ms:
            stalled.append("no_progress")
        elif backlog > 0 and stuck_ms >= degraded_ms:
            degraded.append("lagging")
        if fallbacks > 0:
            degraded.append("device_fallback")
        if shed_level >= 1:
            degraded.append("overload")

    verdict = ("STALLED" if stalled
               else "DEGRADED" if degraded else "OK")
    reasons = stalled + degraded
    out = {
        "query": qid,
        "verdict": verdict,
        "level": LEVELS[verdict],
        "reasons": reasons,
        "status": status,
        "watermark_ms": watermark,
        "watermark_lag_ms": (None if wm_lag is None
                             else round(wm_lag, 1)),
        "watermark_stuck_ms": round(stuck_ms, 1),
        "backlog": backlog,
        "device_fallbacks": fallbacks,
        "late_drops": late,
        # multi-chip plane: 0 means single-chip execution
        "mesh_shards": shards,
        "shed_level": shed_level,
        "restart_pending": restart_pending,
        "breaker_open": breaker_open,
        "thresholds": {"degraded_after_ms": degraded_ms,
                       "stalled_after_ms": stalled_ms},
    }
    if task is None and owner is not None:
        # owned elsewhere: name the owner so a caller knows which
        # node's health plane is authoritative for this query
        out["owner"] = owner.get("node")
    prev = tracker.transition(qid, verdict)
    if prev is not None and verdict == "STALLED":
        # the machine-readable distress signal: journaled exactly once
        # per episode, queryable via admin events / GET /events
        try:
            ctx.events.append(
                "query_stalled",
                f"query {qid} STALLED ({', '.join(stalled)}); "
                f"backlog {backlog}, watermark stuck "
                f"{stuck_ms / 1e3:.1f}s",
                query=qid, reasons=reasons, backlog=backlog,
                prev_verdict=prev)
        except Exception:  # noqa: BLE001 — journaling is best-effort
            pass
        # the black box: snapshot the postmortem bundle at
        # the SAME edge the distress signal journals on — exactly once
        # per STALLED episode, with the verdict it already computed
        rec = getattr(ctx, "flightrec", None)
        if rec is not None:
            rec.snapshot(qid, trigger="query_stalled", health=out)
    stats = getattr(ctx, "stats", None)
    if stats is not None:
        try:
            stats.gauge_set("query_health_level", qid, LEVELS[verdict])
        except Exception:  # noqa: BLE001 — metrics must not fail health
            pass
    return out


def _sweep_snapshot(ctx) -> tuple[dict, int]:
    """ONE supervisor-status + shed-level snapshot for a whole sweep —
    per-query re-snapshots would take the supervisor lock and re-sort
    its state O(queries) times per scrape."""
    sup = getattr(ctx, "supervisor", None)
    sup_status = sup.status() if sup is not None else {}
    flow = getattr(ctx, "flow", None)
    shed = flow.overload.effective_level() if flow is not None else 0
    return sup_status, shed


def evaluate_all(ctx) -> dict[str, dict[str, Any]]:
    """qid -> health dict for every known query (the admin verb)."""
    out: dict[str, dict[str, Any]] = {}
    sup_status, shed = _sweep_snapshot(ctx)
    for info in ctx.persistence.get_queries():
        try:
            out[info.query_id] = evaluate_query(
                ctx, info.query_id, sup_status=sup_status,
                shed_level=shed)
        except Exception:  # noqa: BLE001 — one sick record must not
            continue       # hide every other query's verdict
    return out


def sample_health(ctx) -> None:
    """Scrape-time sampling (called from prometheus.sample_gauges):
    per-query watermark/lag gauges + the health verdict gauge, with
    stale series dropped when queries go away. Cost is O(queries) host
    reads — never device work."""
    stats = ctx.stats
    now = time.time() * 1e3
    known: set[str] = set()
    live: set[tuple[str, str]] = set()
    try:
        infos = list(ctx.persistence.get_queries())
    except Exception:  # noqa: BLE001 — persistence mid-teardown
        return
    sup_status, shed = _sweep_snapshot(ctx)
    for info in infos:
        qid = info.query_id
        known.add(qid)
        try:
            evaluate_query(ctx, qid, now_ms=now,
                           sup_status=sup_status, shed_level=shed)
            live.add(("query_health_level", qid))
        except Exception:  # noqa: BLE001
            continue
        task = ctx.running_queries.get(qid)
        if task is None:
            continue
        wm = _executor_watermark(task)
        if wm is None:
            continue
        stats.gauge_set("query_watermark_ms", qid, wm)
        stats.gauge_set("query_watermark_lag_ms", qid,
                        max(0.0, now - wm))
        live.add(("query_watermark_ms", qid))
        live.add(("query_watermark_lag_ms", qid))
        # multi-chip plane: the gauge only exists for
        # sharded queries — single-chip queries drop it (absent, not
        # 0) so dashboards can filter on presence
        shards = int(getattr(task, "mesh_shards", lambda: 0)() or 0)
        if shards > 1:
            stats.gauge_set("mesh_shards", qid, shards)
            live.add(("mesh_shards", qid))
    for metric in ("query_watermark_ms", "query_watermark_lag_ms",
                   "query_health_level", "mesh_shards"):
        for label in stats.gauge_labels(metric):
            if (metric, label) not in live:
                stats.gauge_drop(metric, label)
    ctx.health.forget(known)
