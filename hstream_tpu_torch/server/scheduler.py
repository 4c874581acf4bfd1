"""Query->server assignment + self-healing supervision.

The reference is single-process here too (every query runs in the one
server, Handler.hs:373-375); SURVEY's TPU-native column asks for a
scheduler persisting query placement in cluster metadata. This module
records, for every launched query, which server owns it — keyed
``scheduler/query/<qid>`` in the CAS-versioned config store — and lets
a booting server ADOPT queries whose owner is gone (its recorded boot
epoch predates ours; the boot-epoch CAS in ServerContext makes epochs
total-ordered per store). Adoption is itself a CAS, so two racing
successors cannot both take a query.

Liveness at BOOT is epoch-based (single store, one active server at a
time — a successor always boots with a higher epoch). A multi-server
deployment (the placer) adds heartbeats on the same records:
owners re-stamp ``hb_ms`` every placer tick, survivors adopt through
:func:`try_adopt_live` only when the lease lapses (or the record was
explicitly ``offered`` to them by a rebalance), and the CAS adoption
discipline is unchanged — two racing adopters still converge to one
owner. Record schema (JSON under ``scheduler/query/<qid>``)::

    {"node": "server-1@host:port",  # owner (or offer target)
     "epoch": 7,                    # owner's boot epoch (fencing)
     "hb_ms": 1700000000000,        # last owner heartbeat, wall ms
     "state": "owned" | "offered",  # offered = rebalance handoff
     "src": "server-2@..."}         # offering node (offered only)

``hb_ms``/``state`` are additive: records written by older code (or by
servers running with the placer disarmed) carry neither and keep the
pure epoch semantics everywhere.

``QuerySupervisor`` closes the loop the reference leaves
open ("task distribution: none" — and a dead query stays dead): a
query task that dies on an unexpected exception is restarted from its
last snapshot with jittered exponential backoff, and a crash loop (K
deaths inside W seconds) opens a breaker — status FAILED, a
``crash_loop_open`` journal event + gauge — so a deterministic bug
cannot melt the server with restart storms. Restarts are gated
through ``adoption_allowed`` like boot adoption, so they shed at
DEFER under overload.
"""

# A copy of hstream_tpu/server/scheduler.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import json
import random
import threading
import time
from collections import deque

from hstream_tpu_torch.common import locktrace
from hstream_tpu_torch.common.backoff import jittered_backoff
from hstream_tpu_torch.common.logger import get_logger
from hstream_tpu_torch.store.versioned import VersionMismatch

log = get_logger("scheduler")

_PREFIX = "scheduler/query/"


def _key(query_id: str) -> str:
    return _PREFIX + query_id


def node_name(ctx) -> str:
    return f"server-{ctx.server_id}@{ctx.host}:{ctx.port}"


def now_ms() -> int:
    return int(time.time() * 1000)


def _owned_record(ctx) -> bytes:
    """Armed servers stamp ``hb_ms``/``state``; a server with the
    placer disarmed writes the legacy two-field record instead — it
    will never refresh a heartbeat, and a stamp it can't refresh would
    read as a lapsed lease to every armed peer after ``lease_ms``
    (rolling placer enablement would live-adopt queries whose disarmed
    owner is alive and running)."""
    record = {"node": node_name(ctx), "epoch": ctx.boot_epoch}
    placer = getattr(ctx, "placer", None)
    if placer is not None and placer.armed:
        record["hb_ms"] = now_ms()
        record["state"] = "owned"
    return json.dumps(record).encode()


def owner_heartbeat_age_ms(record: dict | None) -> int | None:
    """Milliseconds since the owner last heartbeated this record, or
    None for legacy records that carry no heartbeat (pure epoch
    liveness)."""
    if not record:
        return None
    hb = record.get("hb_ms")
    if hb is None:
        return None
    return max(0, now_ms() - int(hb))


def owner_live(record: dict | None, lease_ms: int) -> bool:
    """True when the record's owner heartbeated within the lease. A
    record without hb_ms is NOT live by this test (legacy records fall
    back to the epoch rule instead)."""
    age = owner_heartbeat_age_ms(record)
    return age is not None and age <= int(lease_ms)


def record_assignment(ctx, query_id: str) -> None:
    """Unconditionally claim a query for this server (fresh launches:
    the creating server owns the query). Armed, the write carries an
    implicit heartbeat — the owner was alive at launch; disarmed it is
    a legacy epoch-only record."""
    value = _owned_record(ctx)
    for _ in range(16):
        cur = ctx.config.get(_key(query_id))
        try:
            ctx.config.put(_key(query_id), value,
                           base_version=None if cur is None else cur[0])
            return
        except VersionMismatch:
            continue
    log.warning("assignment write for %s kept losing CAS", query_id)


def drop_assignment(ctx, query_id: str) -> None:
    cur = ctx.config.get(_key(query_id))
    if cur is None:
        return
    try:
        ctx.config.delete(_key(query_id), base_version=cur[0])
    except VersionMismatch:
        pass  # someone re-claimed it; their record stands


def assignment(ctx, query_id: str) -> dict | None:
    cur = ctx.config.get(_key(query_id))
    if cur is None:
        return None
    try:
        return json.loads(cur[1])
    except ValueError:
        return None


def adoption_allowed(ctx, query_id: str) -> bool:
    """Flow-control gate on boot-time adoption: taking over a dead
    owner's queries is background work, so it sheds at DEFER — before
    any user append is refused. A skipped query keeps its stale owner
    record and stays claimable by the next (healthier) boot."""
    flow = getattr(ctx, "flow", None)
    if flow is None:
        return True
    wait = flow.admit_background("adopt")
    if wait > 0.0:
        log.info("deferring adoption of %s under overload "
                 "(retry in %.1fs)", query_id, wait)
        return False
    return True


def try_adopt(ctx, query_id: str) -> bool:
    """CAS-claim an unowned or dead-owner query at boot. True = this
    server now owns it and should resume it. The claim record follows
    :func:`_owned_record`: armed servers stamp a heartbeat immediately
    (a boot-adopted query must read as live to peers before the first
    placer tick), disarmed servers write the legacy epoch record."""
    cur = ctx.config.get(_key(query_id))
    mine = _owned_record(ctx)
    if cur is None:
        try:
            ctx.config.put(_key(query_id), mine)
            return True
        except VersionMismatch:
            _journal_adoption_lost(ctx, query_id)
            return False
    version, raw = cur
    try:
        owner = json.loads(raw)
    except ValueError:
        owner = {"node": "?", "epoch": 0}
    if int(owner.get("epoch", 0)) >= ctx.boot_epoch:
        # owned under an epoch at least as new as ours: a live peer
        log.info("query %s owned by %s (epoch %s); not adopting",
                 query_id, owner.get("node"), owner.get("epoch"))
        return False
    try:
        ctx.config.put(_key(query_id), mine, base_version=version)
        log.info("adopted query %s from %s (epoch %s -> %s)", query_id,
                 owner.get("node"), owner.get("epoch"), ctx.boot_epoch)
        _journal_adoption(ctx, query_id, owner)
        return True
    except VersionMismatch:
        # a racing successor won the claim: journal the stand-down so
        # an operator can see WHY this server skipped the query
        _journal_adoption_lost(ctx, query_id)
        return False


def _journal_adoption(ctx, query_id: str, owner: dict) -> None:
    events = getattr(ctx, "events", None)
    if events is None:
        return
    try:
        events.append(
            "query_adopted",
            f"query {query_id} adopted from {owner.get('node')} "
            f"(epoch {owner.get('epoch')} -> {ctx.boot_epoch})",
            query=query_id, prev_owner=owner.get("node"),
            epoch=ctx.boot_epoch)
    except Exception:  # noqa: BLE001 — journaling must not block boot
        pass


def _journal_adoption_lost(ctx, query_id: str) -> None:
    events = getattr(ctx, "events", None)
    if events is None:
        return
    try:
        winner = assignment(ctx, query_id) or {}
        events.append(
            "adoption_lost",
            f"lost the adoption race for query {query_id} to "
            f"{winner.get('node')} (epoch {winner.get('epoch')}); "
            f"standing down",
            query=query_id, winner=winner.get("node"),
            epoch=ctx.boot_epoch)
    except Exception:  # noqa: BLE001 — journaling must not block boot
        pass


def heartbeat_assignment(ctx, query_id: str) -> bool:
    """CAS-refresh ``hb_ms`` on a record this node owns. Returns False
    (without writing) ONLY when the record is gone or no longer names
    this node as owner — the caller definitively lost ownership (a
    peer live-adopted it, or an in-flight rebalance offered it away),
    must not resurrect the record, and must self-fence the local task.
    Transient CAS contention is NOT ownership loss: after the retries
    the last read still named this node, so the caller keeps running
    and the next tick refreshes the stamp."""
    me = node_name(ctx)
    for _ in range(4):
        cur = ctx.config.get(_key(query_id))
        if cur is None:
            return False
        version, raw = cur
        try:
            rec = json.loads(raw)
        except ValueError:
            return False
        if rec.get("node") != me or rec.get("state", "owned") != "owned":
            return False
        rec["hb_ms"] = now_ms()
        rec["epoch"] = ctx.boot_epoch
        try:
            ctx.config.put(_key(query_id), json.dumps(rec).encode(),
                           base_version=version)
            return True
        except VersionMismatch:
            continue
    log.warning("heartbeat CAS for %s kept losing; still owned at "
                "last read, retrying next tick", query_id)
    return True


def offer_assignment(ctx, query_id: str, target_node: str) -> bool:
    """Rebalance handoff: CAS the record from owned-by-me to
    ``offered`` naming ``target_node``. The offer carries a fresh
    ``hb_ms`` so the target has one full lease to claim it before any
    other node may take it through lease lapse; ``epoch`` drops to 0
    so a plain boot-time ``try_adopt`` can also claim an orphaned
    offer. Caller must have stopped the local task FIRST — after this
    write the query has no live owner until someone adopts."""
    me = node_name(ctx)
    cur = ctx.config.get(_key(query_id))
    if cur is None:
        return False
    version, raw = cur
    try:
        rec = json.loads(raw)
    except ValueError:
        return False
    if rec.get("node") != me:
        return False
    offer = json.dumps({"node": target_node, "epoch": 0,
                        "hb_ms": now_ms(), "state": "offered",
                        "src": me}).encode()
    try:
        ctx.config.put(_key(query_id), offer, base_version=version)
        return True
    except VersionMismatch:
        return False


def try_adopt_live(ctx, query_id: str, lease_ms: int) -> bool:
    """Runtime (placer) adoption: CAS-claim a query whose owner's
    heartbeat lapsed past ``lease_ms``, or that was explicitly
    ``offered`` to this node by a rebalance. Unlike boot-time
    :func:`try_adopt` this ignores epoch ORDER for heartbeated records
    — a dead owner may well have booted after us — but a record with a
    FRESH heartbeat is never taken, whatever its epoch. Legacy records
    without ``hb_ms`` fall back to the boot epoch rule."""
    cur = ctx.config.get(_key(query_id))
    me = node_name(ctx)
    if cur is None:
        try:
            ctx.config.put(_key(query_id), _owned_record(ctx))
            return True
        except VersionMismatch:
            _journal_adoption_lost(ctx, query_id)
            return False
    version, raw = cur
    try:
        rec = json.loads(raw)
    except ValueError:
        rec = {"node": "?", "epoch": 0}
    state = rec.get("state", "owned")
    if rec.get("node") == me and state == "owned":
        return False  # already mine; nothing to adopt
    offered_to_me = state == "offered" and rec.get("node") == me
    if not offered_to_me:
        age = owner_heartbeat_age_ms(rec)
        if age is None:
            # legacy record: epoch liveness, exactly like boot
            if int(rec.get("epoch", 0)) >= ctx.boot_epoch:
                return False
        elif age <= int(lease_ms):
            return False  # owner (or offer target) is live
    try:
        ctx.config.put(_key(query_id), _owned_record(ctx),
                       base_version=version)
        log.info("live-adopted query %s from %s (%s, hb age %sms)",
                 query_id, rec.get("node"), state,
                 owner_heartbeat_age_ms(rec))
        _journal_adoption(ctx, query_id, rec)
        return True
    except VersionMismatch:
        _journal_adoption_lost(ctx, query_id)
        return False


def assignments(ctx) -> dict[str, dict]:
    """query_id -> owner record (admin/introspection)."""
    out = {}
    for key in ctx.config.keys():
        if not key.startswith(_PREFIX):
            continue
        qid = key[len(_PREFIX):]
        a = assignment(ctx, qid)
        if a is not None:
            out[qid] = a
    return out


# ---- self-healing supervision ----------------------------------------------


class QuerySupervisor:
    """Restart dead query tasks from their last snapshot; open a
    breaker on crash loops.

    State machine per query::

        RUNNING --death--> backoff wait --restart ok--> RUNNING
                    |                         |
                    |                    restart failed (counts as a
                    |                    death; next wait doubles)
                    v
        K deaths in W seconds --> FAILED (breaker open) until an
        operator RestartQuery resets the breaker

    Restarts run on ONE dedicated daemon thread; the wait between
    attempts is a bounded ``Event.wait`` so shutdown is prompt. Backoff
    is jittered exponential (seeded RNG — a chaos run replays the same
    waits), doubling per in-window death: with the default ``BREAKER_K``
    the wait peaks at ``BACKOFF_BASE_S * 2**(BREAKER_K - 2)`` (2s)
    because the breaker opens on the next death — ``BACKOFF_CAP_S``
    only binds when ``BREAKER_K``/``BREAKER_W_S`` are tuned up. Every
    scheduling decision journals
    ``query_restart_scheduled`` so an operator can reconstruct the
    timeline. Restarting is background work: it is gated through
    ``adoption_allowed``, so under overload a restart defers exactly
    like boot-time adoption would."""

    BACKOFF_BASE_S = 0.25
    BACKOFF_CAP_S = 30.0   # reachable only if BREAKER_K is raised
    BACKOFF_JITTER = 0.25
    BREAKER_K = 5          # deaths ...
    BREAKER_W_S = 60.0     # ... within this window open the breaker

    def __init__(self, ctx, *, resume_fn=None, seed: int = 0,
                 clock=time.monotonic):
        self.ctx = ctx
        # set by the servicer once handlers exist (resume = relaunch
        # from snapshot, the same path RestartQuery uses)
        self.resume_fn = resume_fn
        self.clock = clock
        self._rng = random.Random(seed)
        # named traced lock: the supervisor's pending/
        # breaker tables are a cross-object rendezvous (tasks report
        # deaths, handlers cancel, the restart thread dispatches) —
        # exactly where the lock-order witness earns its keep
        self._lock = locktrace.lock("scheduler.supervisor")
        self._wake = threading.Event()
        self._stopped = False
        # qid -> (due monotonic ts, QueryInfo, attempt#)
        self._pending: dict[str, tuple[float, object, int]] = {}
        # restarts currently executing on the supervisor thread:
        # cancel() waits these out so an operator terminate can never
        # be raced by a resurrect (marked at pending-pop time so there
        # is no unmarked window between pop and attempt)
        self._inflight: set[str] = set()
        self._inflight_cv = threading.Condition(self._lock)
        # qid -> recent death timestamps (breaker window)
        self._deaths: dict[str, deque] = {}
        self._breaker_open: set[str] = set()
        self.restarts = 0  # total successful supervisor restarts
        self._thread: threading.Thread | None = None

    # ---- death intake ------------------------------------------------------

    def note_death(self, info, error: BaseException | None = None) -> None:
        """Called (from the dying task's thread, or by a failed restart)
        when a supervised query died unexpectedly. Schedules a restart
        or opens the crash-loop breaker."""
        qid = info.query_id
        from hstream_tpu_torch.common.errors import NotLeaderError

        if isinstance(error, NotLeaderError):
            # leadership loss is NOT a crash loop: this
            # node's store was fenced by a promoted peer, so every
            # restart would die the same way and burn the breaker.
            # Stand down instead — the status write on the fenced
            # store failed, so the replicated record still says
            # RUNNING, and the NEW leader's boot (higher boot epoch
            # over the promoted replica) adopts the query through the
            # normal resume path.
            log.warning(
                "query %s died of leadership loss (%s); standing down "
                "instead of restarting — the promoted leader adopts it",
                qid, error)
            self._journal(
                "replica_fenced",
                f"query {qid} stopped: store leadership lost "
                f"({error}); awaiting adoption by the new leader",
                query=qid, leader_hint=error.leader_hint)
            with self._lock:
                self._forget_locked(qid)
            return
        now = self.clock()
        with self._lock:
            if self._stopped or qid in self._breaker_open:
                return
            window = self._deaths.setdefault(
                qid, deque(maxlen=self.BREAKER_K))
            window.append(now)
            recent = [t for t in window if now - t <= self.BREAKER_W_S]
            opened = len(recent) >= self.BREAKER_K
            if opened:
                self._open_breaker_locked(qid, len(recent))
            else:
                attempt = len(recent)
                delay = self._backoff_locked(attempt)
                self._pending[qid] = (now + delay, info, attempt)
        if opened:
            # the black box: capture the postmortem bundle
            # at the breaker edge — OUTSIDE the supervisor lock, since
            # the capture folds task/stats state behind its own locks
            rec = getattr(self.ctx, "flightrec", None)
            if rec is not None:
                rec.snapshot(qid, trigger="crash_loop_open")
            return
        self._journal(
            "query_restart_scheduled",
            f"query {qid} restart #{attempt} in {delay:.2f}s "
            f"({type(error).__name__ if error else 'resume failure'})",
            query=qid, attempt=attempt, delay_s=round(delay, 3),
            error=type(error).__name__ if error else None)
        self._ensure_thread()
        self._wake.set()

    def _backoff_locked(self, attempt: int) -> float:
        return jittered_backoff(
            attempt - 1, base=self.BACKOFF_BASE_S,
            cap=self.BACKOFF_CAP_S, jitter=self.BACKOFF_JITTER,
            rng=self._rng, floor=0.05)

    def _open_breaker_locked(self, qid: str, deaths: int) -> None:
        self._breaker_open.add(qid)
        self._pending.pop(qid, None)
        log.error("crash loop on query %s (%d deaths in %.0fs); "
                  "breaker OPEN, status FAILED", qid, deaths,
                  self.BREAKER_W_S)
        try:
            from hstream_tpu_torch.server.persistence import TaskStatus

            self.ctx.persistence.set_query_status(qid, TaskStatus.FAILED)
        except Exception:  # noqa: BLE001 — breaker must open even if
            pass           # the status write fails
        self._journal(
            "crash_loop_open",
            f"query {qid} crash-looped ({deaths} deaths in "
            f"{self.BREAKER_W_S:.0f}s); FAILED until operator restart",
            query=qid, deaths=deaths, window_s=self.BREAKER_W_S)
        stats = getattr(self.ctx, "stats", None)
        if stats is not None:
            try:
                stats.gauge_set("crash_loop_open", qid, 1.0)
            except Exception:  # noqa: BLE001
                pass

    # ---- operator surface --------------------------------------------------

    def _forget_locked(self, qid: str) -> None:
        self._deaths.pop(qid, None)
        self._breaker_open.discard(qid)
        self._pending.pop(qid, None)

    def _drop_breaker_gauge(self, qid: str) -> None:
        stats = getattr(self.ctx, "stats", None)
        if stats is not None:
            try:
                stats.gauge_drop("crash_loop_open", qid)
            except Exception:  # noqa: BLE001
                pass

    def reset(self, qid: str) -> None:
        """Forget the death history and close the breaker so
        supervision starts fresh. Non-blocking — callers that must not
        race an executing restart use :meth:`cancel`."""
        with self._lock:
            self._forget_locked(qid)
        self._drop_breaker_gauge(qid)

    def cancel(self, qid: str) -> None:
        """Query terminated/deleted/operator-restarted: drop any
        pending restart, wait out one already executing on the
        supervisor thread, and forget the death history — with no
        window in which the restart loop could dispatch a fresh
        attempt. The caller's terminate/restart thus always runs AFTER
        any resurrect, so the task it finds in running_queries is the
        final one."""
        deadline = time.monotonic() + 30.0
        with self._inflight_cv:
            # pop FIRST so a due pending entry cannot dispatch while
            # we wait; re-pop after each wakeup to drop requeues made
            # by the in-flight attempt (corpse / defer paths)
            self._pending.pop(qid, None)
            while (qid in self._inflight
                   and time.monotonic() < deadline):
                self._inflight_cv.wait(timeout=0.25)
                self._pending.pop(qid, None)
            if qid in self._inflight:
                log.warning("cancel(%s): in-flight supervised restart "
                            "did not finish within 30s", qid)
            # same lock hold as the final inflight/pending check: the
            # loop cannot pop-and-dispatch in between
            self._forget_locked(qid)
        self._drop_breaker_gauge(qid)

    def status(self) -> dict:
        with self._lock:
            now = self.clock()
            # pending sorted by query id: admin
            # output and chaos-test assertions must not depend on
            # dict-insertion order
            return {
                "restarts": self.restarts,
                "pending": {qid: {"due_in_s": round(due - now, 3),
                                  "attempt": attempt}
                            for qid, (due, _i, attempt)
                            in sorted(self._pending.items())},
                "breaker_open": sorted(self._breaker_open),
            }

    def shutdown(self) -> None:
        with self._lock:
            self._stopped = True
            self._pending.clear()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)

    # ---- restart thread ----------------------------------------------------

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None and not self._stopped:
                self._thread = threading.Thread(
                    target=self._restart_loop, name="query-supervisor",
                    daemon=True)
                self._thread.start()

    def _restart_loop(self) -> None:
        while True:
            with self._lock:
                if self._stopped:
                    return
                now = self.clock()
                due = [(qid, info, attempt)
                       for qid, (t, info, attempt)
                       in self._pending.items() if t <= now]
                for qid, _i, _a in due:
                    self._pending.pop(qid, None)
                    self._inflight.add(qid)
                wait = min((t - now for t, _i, _a
                            in self._pending.values()), default=None)
            for qid, info, attempt in due:
                try:
                    self._attempt_restart(qid, info, attempt)
                except Exception as e:  # noqa: BLE001 — this thread is
                    # the singleton supervisor: an escaped bug in one
                    # attempt must count as another death (backoff +
                    # breaker), never kill supervision for every query
                    log.exception("supervised restart attempt for %s "
                                  "blew up", qid)
                    try:
                        self.note_death(info, e)
                    except Exception:  # noqa: BLE001
                        pass
                finally:
                    with self._lock:
                        self._inflight.discard(qid)
                        self._inflight_cv.notify_all()
            # nothing pending: block until a death/requeue wakes us
            # (requeue paths set _wake, so the stale `wait` computed
            # before the attempts above cannot strand a new entry)
            self._wake.wait(timeout=None if wait is None
                            else max(min(wait, 0.5), 0.01))
            self._wake.clear()

    def _attempt_restart(self, qid: str, info, attempt: int) -> None:
        ctx = self.ctx
        from hstream_tpu_torch.server.persistence import TaskStatus

        stale = ctx.running_queries.get(qid)
        if stale is not None:
            if getattr(stale, "error", None) is not None:
                # the dead task is still tearing down (its finally
                # joins reader/persist threads, which can hold it past
                # our backoff) — it pops running_queries last, so retry
                # shortly instead of mistaking the corpse for a live
                # operator-owned task and dropping the restart forever
                with self._lock:
                    if not self._stopped \
                            and qid not in self._breaker_open:
                        self._pending[qid] = (self.clock() + 0.25,
                                              info, attempt)
                self._wake.set()
                return
            return  # an operator beat us to it
        try:
            fresh = ctx.persistence.get_query(qid)
        except Exception:  # noqa: BLE001 — deleted while pending
            return
        if fresh.status in (TaskStatus.TERMINATED, TaskStatus.FAILED):
            return  # terminated (or breaker opened) while pending
        placer = getattr(ctx, "placer", None)
        if placer is not None and placer.armed:
            # live-adoption discipline: while pending, a peer may have
            # adopted this query (our heartbeat lapsed during a long
            # backoff) or a rebalance may have offered it away —
            # restarting anyway would make two live owners
            rec = assignment(ctx, qid)
            if rec is not None and (
                    rec.get("node") != node_name(ctx)
                    or rec.get("state", "owned") != "owned"):
                log.info("dropping restart of %s: record now names "
                         "%s (%s)", qid, rec.get("node"),
                         rec.get("state", "owned"))
                return
        if not adoption_allowed(ctx, qid):
            # overload: defer like boot adoption — same slot, later due
            with self._lock:
                if not self._stopped and qid not in self._breaker_open:
                    self._pending[qid] = (self.clock() + 1.0, info,
                                          attempt)
            self._wake.set()
            return
        resume = self.resume_fn
        if resume is None:
            log.warning("no resume_fn bound; dropping restart of %s",
                        qid)
            return
        try:
            resume(info)
        except Exception as e:  # noqa: BLE001 — a failed restart is
            # another death: backoff doubles, the breaker counts it
            log.exception("supervised restart of %s failed", qid)
            self.note_death(info, e)
            return
        with self._lock:
            # the resumed task may ALREADY have died and opened the
            # breaker (a fault fatal on the first chunk): the breaker
            # writes FAILED under this lock, so checking + writing
            # RUNNING under the same hold totally orders the two —
            # RUNNING can never clobber the breaker's FAILED status
            if qid in self._breaker_open:
                return
            try:
                ctx.persistence.set_query_status(qid, TaskStatus.RUNNING)
            except Exception:  # noqa: BLE001 — the task IS running;
                pass           # status catches up on the next write
            self.restarts += 1
        log.info("supervisor restarted query %s (attempt %d)", qid,
                 attempt)
        stats = getattr(ctx, "stats", None)
        if stats is not None:
            try:
                stats.stream_stat_add("query_restarts", qid)
            except Exception:  # noqa: BLE001 — metrics must not stop
                pass           # the restart

    def _journal(self, kind: str, message: str, **fields) -> None:
        events = getattr(self.ctx, "events", None)
        if events is None:
            return
        try:
            events.append(kind, message, **fields)
        except Exception:  # noqa: BLE001 — journaling is best-effort
            pass
