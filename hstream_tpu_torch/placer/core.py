"""The placer loop: publish, heartbeat, adopt, rebalance.

One daemon thread per armed server (``--placer-interval-ms``). Each
tick:

  1. **publish** this node's load record to ``cluster/nodes/<node>``
     (stats/cluster.publish_node_record) — the cluster-level heartbeat
     every peer's ranking reads;
  2. **heartbeat** the ``scheduler/query/*`` records of queries this
     node owns (running tasks AND tasks the supervisor is about to
     restart — a backoff wait must not read as death to peers); a
     heartbeat that finds the record gone or naming another owner
     means ownership was LOST (a delayed tick let the lease lapse and
     a peer live-adopted) — the loser self-fences: it stops the local
     task crash-style (no snapshot, no status write — the adopter's
     state is the live one) and cancels its supervisor slot, so a
     slow-but-alive owner can never stay a second live owner;
  3. **adopt** queries whose owner's heartbeat lapsed past the lease,
     or that were ``offered`` to this node by a rebalance or a remote
     placement — CAS first (``scheduler.try_adopt_live``: racing
     survivors converge to one owner), then resume from the last
     snapshot; a failed resume goes through the supervisor intake
     so it backs off and breakers like any other death;
  4. **rebalance** when this node's query count skews past the least
     loaded eligible peer: stop one local task WITH a final snapshot
     (``stop(detach=True)`` — status stays RUNNING), then CAS the
     record to ``offered`` naming the target. Never two live owners:
     the local task is dead before the offer is visible, and the offer
     carries a fresh heartbeat so only the target may claim it for one
     full lease.

Every decision journals ``placement_decision`` with a machine-readable
reason and bumps ``placement_decisions``; live adoptions also bump
``queries_adopted``. Disarmed (interval unset), the loop never starts
and none of the records exist — single-server deployments keep the
pure boot-epoch semantics.
"""

# A copy of hstream_tpu/placer/core.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import json
import threading
import time
from collections import deque

from hstream_tpu_torch.common.logger import get_logger
from hstream_tpu_torch.placer.score import node_score, rank_nodes, skip_reason
from hstream_tpu_torch.server import scheduler
from hstream_tpu_torch.stats.cluster import (
    cluster_node_records,
    publish_node_record,
)
from hstream_tpu_torch.store.versioned import VersionMismatch

log = get_logger("placer")

DEFAULT_LEASE_MS = 10_000

# a node must exceed the cluster-min query count by this many queries
# before it offers one away — rebalance hysteresis, so two near-equal
# nodes never ping-pong a query
REBALANCE_MIN_DELTA = 2


class Placer:
    """Placement decisions for one server. Constructed always (admin
    introspection and scrape-time scoring work regardless); the loop
    runs only when armed."""

    def __init__(self, ctx, *, interval_ms: int | None = None,
                 lease_ms: int = DEFAULT_LEASE_MS):
        self.ctx = ctx
        self.interval_ms = interval_ms
        self.lease_ms = int(lease_ms)
        self.armed = bool(interval_ms) and int(interval_ms) > 0
        if self.armed:
            # an owner heartbeats once per tick: a lease shorter than
            # a few ticks makes every healthy owner look dead between
            # heartbeats — continuous spurious live-adoptions. Clamp
            # rather than reject so a misconfigured node still boots.
            min_lease = 3 * int(interval_ms)
            if self.lease_ms < min_lease:
                log.warning(
                    "heartbeat lease %dms < 3x placer interval %dms; "
                    "clamping lease to %dms so a delayed tick cannot "
                    "read as owner death", self.lease_ms,
                    int(interval_ms), min_lease)
                self.lease_ms = min_lease
        # bound by the servicer once handlers exist (same resume path
        # the supervisor and RestartQuery use)
        self.resume_fn = None
        self.last_decision: dict | None = None
        self._decisions: deque[dict] = deque(maxlen=64)
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None
        self.ticks = 0

    # ---- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Called AFTER the port is bound (like LoadReporter.start):
        records must carry the node's real identity."""
        if not self.armed or self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, name="placer",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop_evt.set()
        t = self._thread
        if t is not None and t.ident is not None:
            t.join(timeout=5)

    def _run(self) -> None:
        interval_s = max(int(self.interval_ms) / 1000.0, 0.05)
        self.tick()  # boot-time record: visible to peers immediately
        while not self._stop_evt.wait(interval_s):
            self.tick()

    # ---- one tick ----------------------------------------------------------

    def tick(self) -> None:
        """One full decision pass; every stage fails open so a torn-
        down subsystem mid-shutdown cannot kill the loop."""
        self.ticks += 1
        for stage in (self._publish, self._heartbeat_owned,
                      self._adopt_sweep, self._rebalance):
            if self._stop_evt.is_set():
                return
            try:
                stage()
            except Exception:  # noqa: BLE001 — the loop must survive
                log.exception("placer stage %s failed",
                              stage.__name__)

    def _publish(self) -> None:
        publish_node_record(self.ctx)

    def _heartbeat_owned(self) -> None:
        ctx = self.ctx
        owned = set(getattr(ctx, "running_queries", {}))
        sup = getattr(ctx, "supervisor", None)
        if sup is not None:
            # a query in supervised backoff is still OURS: without the
            # heartbeat a short lease would let a peer adopt it while
            # the local restart is pending — two live owners
            st = sup.status()
            owned.update(st.get("pending", {}))
        for qid in sorted(owned):
            if not scheduler.heartbeat_assignment(ctx, qid):
                # definitive ownership loss (record gone, re-owned by
                # a peer, or offered away): keeping the local task
                # running would make two live owners
                self._self_fence(qid)

    def _self_fence(self, qid: str) -> None:
        """Stop the local task for a query this node no longer owns.
        Crash-mode stop: no final snapshot and no status write — the
        new owner already resumed from the last snapshot and writes
        its own; a stale snapshot or a TERMINATED status from the
        fenced loser would corrupt the adopter's run. The supervisor
        slot is cancelled first so a pending restart cannot resurrect
        the query after the fence."""
        ctx = self.ctx
        rec = scheduler.assignment(ctx, qid)
        sup = getattr(ctx, "supervisor", None)
        if sup is not None:
            sup.cancel(qid)
        task = ctx.running_queries.pop(qid, None)
        if task is not None:
            try:
                if getattr(task, "packed", False):
                    task.stop()  # detach from the shared lattice
                else:
                    task.stop(crash=True)
            except Exception:  # noqa: BLE001 — the fence must stand
                log.exception("self-fence stop of %s failed", qid)
        log.warning("self-fenced query %s: record now names %s (%s)",
                    qid, (rec or {}).get("node"),
                    "missing" if rec is None
                    else rec.get("state", "owned"))
        self._decide("self_fence", qid, target=(rec or {}).get("node"),
                     reason="ownership_lost")

    def _adopt_sweep(self) -> None:
        from hstream_tpu_torch.server.persistence import TaskStatus

        ctx = self.ctx
        if getattr(ctx.store, "fenced_by", None) is not None:
            return  # a fenced store cannot own queries
        me = scheduler.node_name(ctx)
        for info in ctx.persistence.get_queries():
            qid = info.query_id
            if qid in ctx.running_queries:
                continue
            rec = scheduler.assignment(ctx, qid)
            state = (rec or {}).get("state", "owned")
            offered_to_me = (rec is not None and state == "offered"
                             and rec.get("node") == me)
            if info.status == TaskStatus.CREATED and not offered_to_me:
                # mid-launch on its creator — UNLESS the record's
                # heartbeat already lapsed: the creator died before
                # the task registered, or a remote placement's target
                # died before claiming its offer. Any survivor may
                # rescue those; otherwise an orphaned CREATED query
                # would wait for a server reboot while the cluster is
                # live. No record at all (the creator is writing it
                # right now) stays off-limits.
                age = scheduler.owner_heartbeat_age_ms(rec)
                if age is None or age <= self.lease_ms:
                    continue
            if info.status not in (TaskStatus.CREATED,
                                   TaskStatus.RUNNING):
                continue
            if rec is not None and rec.get("node") == me \
                    and state == "owned":
                continue  # already mine: the supervisor's domain
            if rec is not None and rec.get("node") != me \
                    and "hb_ms" not in rec:
                # legacy record (written by a server with the placer
                # disarmed): its owner never heartbeats, so it may be
                # alive RIGHT NOW — the live sweep must not apply the
                # boot-epoch rule to it. Boot-time adoption (where a
                # lower epoch really does mean a dead predecessor)
                # remains the rescue path for these.
                continue
            if not scheduler.adoption_allowed(ctx, qid):
                continue
            if not scheduler.try_adopt_live(ctx, qid, self.lease_ms):
                continue
            reason = "offered" if offered_to_me else (
                "unowned" if rec is None else "lease_lapsed")
            self._count("queries_adopted", qid)
            self._decide("adopt", qid, target=me, reason=reason,
                         prev_owner=(rec or {}).get("node"))
            self._resume_adopted(info)

    def _resume_adopted(self, info) -> None:
        from hstream_tpu_torch.server.persistence import TaskStatus

        ctx = self.ctx
        resume = self.resume_fn
        if resume is None:
            log.warning("adopted %s but no resume_fn bound yet",
                        info.query_id)
            return
        try:
            resume(info)
            ctx.persistence.set_query_status(info.query_id,
                                             TaskStatus.RUNNING)
        except Exception as e:  # noqa: BLE001 — supervisor intake: a
            # failed adoption resume backs off and breakers exactly
            # like a crashed task
            log.exception("resume of adopted query %s failed",
                          info.query_id)
            sup = getattr(ctx, "supervisor", None)
            if sup is not None:
                sup.note_death(info, e)

    def _rebalance(self) -> None:
        from hstream_tpu_torch.server.persistence import TaskStatus

        ctx = self.ctx
        me = scheduler.node_name(ctx)
        local = getattr(ctx, "running_queries", {})
        if len(local) < REBALANCE_MIN_DELTA:
            return
        ranked, _skipped = rank_nodes(cluster_node_records(ctx),
                                      lease_ms=self.lease_ms)
        counts = {node: rec.get("running_queries", 0)
                  for node, rec in cluster_node_records(ctx).items()}
        peers = [(s, n) for s, n in ranked if n != me]
        if not peers:
            return
        target_score, target = peers[0]
        if len(local) - int(counts.get(target, 0)) < REBALANCE_MIN_DELTA:
            return
        # deterministic pick: the newest movable query (highest id) —
        # its state is smallest, so the move costs the least
        for qid in sorted(local, reverse=True):
            task = local.get(qid)
            if task is None or getattr(task, "packed", False):
                continue  # pack members share a lattice; never moved
            rec = scheduler.assignment(ctx, qid)
            if rec is None or rec.get("node") != me \
                    or rec.get("state", "owned") != "owned":
                continue
            try:
                if ctx.persistence.get_query(qid).status \
                        != TaskStatus.RUNNING:
                    continue
            except Exception:  # noqa: BLE001 — deleted mid-sweep
                continue
            self._move(qid, task, target, target_score)
            return  # at most ONE move per tick: re-rank before more

    def _move(self, qid: str, task, target: str,
              target_score: float) -> None:
        ctx = self.ctx
        sup = getattr(ctx, "supervisor", None)
        if sup is not None:
            sup.cancel(qid)  # no resurrect racing the handoff
        ctx.running_queries.pop(qid, None)
        try:
            task.stop(detach=True)  # final snapshot; status RUNNING
        except Exception:  # noqa: BLE001 — a dying task still moves:
            pass           # the target resumes from the last snapshot
        if scheduler.offer_assignment(ctx, qid, target):
            self._decide("rebalance", qid, target=target,
                         reason="load_skew", target_score=target_score)
            return
        # lost the record race: take the query back locally
        log.warning("rebalance offer of %s to %s lost CAS; relaunching "
                    "locally", qid, target)
        scheduler.record_assignment(ctx, qid)
        resume = self.resume_fn
        if resume is not None:
            try:
                resume(ctx.persistence.get_query(qid))
            except Exception:  # noqa: BLE001
                log.exception("local relaunch of %s failed", qid)

    # ---- placement of new queries ------------------------------------------

    def place_for_launch(self, qid: str) -> str | None:
        """Pick the owner for a freshly launched query. None = launch
        locally (disarmed, no eligible peer, or this node won). A
        remote winner gets an ``offered`` record — its placer claims
        and resumes it within one tick."""
        ctx = self.ctx
        me = scheduler.node_name(ctx)
        if not self.armed:
            return None
        publish_node_record(ctx)  # rank with my freshest numbers
        ranked, skipped = rank_nodes(cluster_node_records(ctx),
                                     lease_ms=self.lease_ms)
        if not ranked:
            return None
        score, winner = ranked[0]
        self._decide("place", qid, target=winner, reason="least_loaded",
                     score=score,
                     scores={n: s for s, n in ranked}, skipped=skipped)
        if winner == me:
            return None
        value = json.dumps(
            {"node": winner, "epoch": 0, "hb_ms": scheduler.now_ms(),
             "state": "offered", "src": me}).encode()
        key = "scheduler/query/" + qid
        for _ in range(16):
            cur = ctx.config.get(key)
            try:
                ctx.config.put(key, value, base_version=None
                               if cur is None else cur[0])
                return winner
            except VersionMismatch:
                continue
        return None  # record kept losing CAS: launch locally

    # ---- introspection -----------------------------------------------------

    def scores(self) -> dict[str, float]:
        """node -> score for nodes with a fresh record (stale nodes
        drop off, taking their gauge series with them)."""
        ranked, _ = rank_nodes(cluster_node_records(self.ctx),
                               lease_ms=max(self.lease_ms, 1))
        return {node: score for score, node in ranked}

    def status(self) -> dict:
        ctx = self.ctx
        now = int(time.time() * 1000)
        nodes = {}
        for node, rec in sorted(cluster_node_records(ctx).items()):
            nodes[node] = {
                "score": node_score(rec),
                "skip": skip_reason(rec, lease_ms=self.lease_ms,
                                    now_ms=now),
                "running_queries": rec.get("running_queries", 0),
                "rss_mb": round(rec.get("rss_bytes", 0) / 1e6, 1),
                "dispatch_p99_ms": rec.get("dispatch_p99_ms"),
                "shed_level": rec.get("shed_level", 0),
                "fenced": rec.get("fenced", False),
                "hb_age_ms": max(0, now - int(rec.get("hb_ms", 0))),
            }
        placements = {}
        for qid, rec in sorted(scheduler.assignments(ctx).items()):
            placements[qid] = {
                "node": rec.get("node"),
                "state": rec.get("state", "owned"),
                "epoch": rec.get("epoch"),
                "hb_age_ms": scheduler.owner_heartbeat_age_ms(rec),
            }
        pool = getattr(ctx, "pack_pool", None)
        return {
            "node": scheduler.node_name(ctx),
            "armed": self.armed,
            "interval_ms": self.interval_ms,
            "lease_ms": self.lease_ms,
            "ticks": self.ticks,
            "nodes": nodes,
            "placements": placements,
            "last_decision": self.last_decision,
            "decisions": list(self._decisions),
            "packs": pool.status() if pool is not None else [],
        }

    # ---- bookkeeping -------------------------------------------------------

    def _decide(self, action: str, qid: str, **fields) -> None:
        decision = {"action": action, "query": qid,
                    "node": scheduler.node_name(self.ctx),
                    "ts_ms": int(time.time() * 1000), **fields}
        self.last_decision = decision
        self._decisions.append(decision)
        self._count("placement_decisions", qid)
        events = getattr(self.ctx, "events", None)
        if events is None:
            return
        try:
            events.append(
                "placement_decision",
                f"{action} {qid} -> {fields.get('target')} "
                f"({fields.get('reason')})",
                **decision)
        except Exception:  # noqa: BLE001 — journaling is best-effort
            pass

    def _count(self, metric: str, qid: str) -> None:
        stats = getattr(self.ctx, "stats", None)
        if stats is None:
            return
        try:
            stats.stream_stat_add(metric, qid)
        except Exception:  # noqa: BLE001 — metrics must not gate
            pass           # placement
