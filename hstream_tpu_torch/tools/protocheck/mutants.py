"""Mutation gate: each ownership/replication fix, mechanically reverted.

A model checker that has never seen a violation proves nothing about
itself. Every entry here is a pre-fix copy of one protocol function —
the exact code shape the fix replaced — patched over the port's live
module for one exploration. The gate (``python -m
hstream_tpu_torch.tools.protocheck --mutants``) requires a counterexample trace for
every mutant: if a revert stops producing one, either the invariant
rotted or the scenario no longer reaches the bug, and CI fails.

Two more fixes of that review (the torn pack-attach lock and the
FAILED-status clobber serialization) are THREAD-level races inside one
function; protocheck's actions are atomic whole-function steps, so
those stay certified by the analyzer's lockorder/atomicity passes
instead — see the README "Protocol certification" section.

Reverted bodies are verbatim copies minus the fix (marked
``REVERTED:``); they drift-check against the live functions only
through the gate itself, which is the point.
"""

from __future__ import annotations

import contextlib
import json
import threading
from collections import deque
from dataclasses import dataclass

from hstream_tpu_torch.placer import core as placer_core
from hstream_tpu_torch.server import scheduler
from hstream_tpu_torch.store.versioned import VersionMismatch


@contextlib.contextmanager
def _swap(obj, attr: str, repl):
    orig = getattr(obj, attr)
    setattr(obj, attr, repl)
    try:
        yield
    finally:
        setattr(obj, attr, orig)


@dataclass
class Mutant:
    name: str
    fix: str        # the review fix this reverts
    scenario: str   # scenario expected to produce the counterexample
    kind: str       # "sched" (ownership model) or "replica"
    patch: object   # zero-arg callable returning a context manager


# ---- reverted bodies (scheduler) --------------------------------------------


def _try_adopt_live_no_refusal(ctx, query_id: str, lease_ms: int) -> bool:
    """try_adopt_live without the fresh-heartbeat refusal: any
    non-offered record is claimable on the epoch rule alone."""
    cur = ctx.config.get(scheduler._key(query_id))
    me = scheduler.node_name(ctx)
    if cur is None:
        try:
            ctx.config.put(scheduler._key(query_id),
                           scheduler._owned_record(ctx))
            return True
        except VersionMismatch:
            return False
    version, raw = cur
    try:
        rec = json.loads(raw)
    except ValueError:
        rec = {"node": "?", "epoch": 0}
    state = rec.get("state", "owned")
    if rec.get("node") == me and state == "owned":
        return False
    offered_to_me = state == "offered" and rec.get("node") == me
    if not offered_to_me:
        age = scheduler.owner_heartbeat_age_ms(rec)
        if age is None:
            if int(rec.get("epoch", 0)) >= ctx.boot_epoch:
                return False
        # REVERTED: `elif age <= int(lease_ms): return False` — the
        # fresh-heartbeat refusal
    try:
        ctx.config.put(scheduler._key(query_id),
                       scheduler._owned_record(ctx),
                       base_version=version)
        return True
    except VersionMismatch:
        return False


def _heartbeat_owned_no_fence(self) -> None:
    """_heartbeat_owned that ignores definitive heartbeat failure:
    the slow owner keeps its task — two live owners."""
    ctx = self.ctx
    owned = set(getattr(ctx, "running_queries", {}))
    sup = getattr(ctx, "supervisor", None)
    if sup is not None:
        st = sup.status()
        owned.update(st.get("pending", {}))
    for qid in sorted(owned):
        scheduler.heartbeat_assignment(ctx, qid)
        # REVERTED: `if not ...: self._self_fence(qid)`


def _owned_record_always_stamped(ctx) -> bytes:
    """_owned_record that stamps hb_ms/state even with the placer
    disarmed — the stamp can never refresh, so armed peers misread it
    as a lapsed lease."""
    # REVERTED: the `placer is not None and placer.armed` gate
    return json.dumps({"node": scheduler.node_name(ctx),
                       "epoch": ctx.boot_epoch,
                       "hb_ms": scheduler.now_ms(),
                       "state": "owned"}).encode()


def _adopt_sweep(self, *, legacy_skip: bool, created_rescue: bool
                 ) -> None:
    """_adopt_sweep body with the two reverts toggleable."""
    from hstream_tpu_torch.server.persistence import TaskStatus

    ctx = self.ctx
    if getattr(ctx.store, "fenced_by", None) is not None:
        return
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
            if created_rescue:
                age = scheduler.owner_heartbeat_age_ms(rec)
                if age is None or age <= self.lease_ms:
                    continue
            else:
                # REVERTED: the lapsed-heartbeat rescue of orphaned
                # CREATED queries
                continue
        if info.status not in (TaskStatus.CREATED, TaskStatus.RUNNING):
            continue
        if rec is not None and rec.get("node") == me \
                and state == "owned":
            continue
        if legacy_skip:
            if rec is not None and rec.get("node") != me \
                    and "hb_ms" not in rec:
                continue
        # else REVERTED: the legacy-record (disarmed live peer) skip
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


def _adopt_sweep_no_legacy_skip(self) -> None:
    _adopt_sweep(self, legacy_skip=False, created_rescue=True)


def _adopt_sweep_no_created_rescue(self) -> None:
    _adopt_sweep(self, legacy_skip=True, created_rescue=False)


def _placer_init_unclamped(self, ctx, *, interval_ms=None,
                           lease_ms=placer_core.DEFAULT_LEASE_MS):
    """Placer.__init__ without the lease >= 3x interval clamp."""
    self.ctx = ctx
    self.interval_ms = interval_ms
    self.lease_ms = int(lease_ms)
    self.armed = bool(interval_ms) and int(interval_ms) > 0
    # REVERTED: `if self.lease_ms < 3 * interval_ms: clamp`
    self.resume_fn = None
    self.last_decision = None
    self._decisions = deque(maxlen=64)
    self._stop_evt = threading.Event()
    self._thread = None
    self.ticks = 0


def _heartbeat_assignment_no_owner_check(ctx, query_id: str) -> bool:
    """heartbeat_assignment that refreshes whatever record exists —
    a fenced loser keeps a peer's (or its own stale) lease alive."""
    for _ in range(4):
        cur = ctx.config.get(scheduler._key(query_id))
        if cur is None:
            return False
        version, raw = cur
        try:
            rec = json.loads(raw)
        except ValueError:
            return False
        # REVERTED: `if rec.get("node") != me or state != "owned":
        # return False` — the ownership check before the stamp
        rec["hb_ms"] = scheduler.now_ms()
        rec["epoch"] = ctx.boot_epoch
        try:
            ctx.config.put(scheduler._key(query_id),
                           json.dumps(rec).encode(),
                           base_version=version)
            return True
        except VersionMismatch:
            continue
    return True


# ---- reverted bodies (replica) ----------------------------------------------


def _promote_no_epoch_guard(self, request, context):
    """FollowerService.Promote without the `epoch <= current` refusal:
    a raced or stale second promotion succeeds — epochs can move
    backwards and two leaders coexist."""
    from hstream_tpu_torch.proto import api_pb2 as pb

    with self._lock:
        if self._broken is not None:
            context.abort(None, "broken")
        # REVERTED: `if request.epoch <= self._epoch: return
        # PromoteResponse(ok=False, ...)`
        self._promote_locked(int(request.epoch), request.leader_addr,
                             request.promoted_by or "operator")
        return pb.PromoteResponse(ok=True, epoch=self._epoch,
                                  applied_seq=self.applied_seq,
                                  node_id=self.node_id)


def _replicate_no_duel_resolution(self, request, context):
    """FollowerService.Replicate where a dueling same-epoch promoted
    leader is ALWAYS fenced instead of resolving to the higher node
    id: two leaders at one epoch persist forever."""
    from hstream_tpu_torch.store import replica as replica_mod

    with self._lock:
        if self._broken is not None:
            context.abort(None, f"broken: {self._broken}")
        if request.epoch < self._epoch:
            return self._fenced_response(request)
        if request.epoch > self._epoch:
            self._accept_leader_locked(request)
        elif request.leader_id:
            if self._is_leader and request.leader_id != self.node_id:
                # REVERTED: `if request.leader_id > self.node_id:
                # accept/demote` — dueling promotions never resolve
                return self._fenced_response(request)
            elif self._leader_id is None:
                self._accept_leader_locked(request)
            elif self._leader_id != request.leader_id:
                context.abort(None, "two same-epoch leaders")
        applied = self.applied_seq
        for e in request.entries:
            if e.seq and e.seq != applied + 1:
                break
            replica_mod._apply(self.local, e)
            applied = self.local.append(replica_mod.OPLOG_ID,
                                        replica_mod._encode_entry(e))
        from hstream_tpu_torch.proto import api_pb2 as pb
        return pb.ReplicateResponse(applied_seq=applied,
                                    epoch=self._epoch)


# ---- the registry -----------------------------------------------------------


def _sched_patch(*swaps):
    def make():
        @contextlib.contextmanager
        def cm():
            with contextlib.ExitStack() as s:
                for obj, attr, repl in swaps:
                    s.enter_context(_swap(obj, attr, repl))
                yield
        return cm()
    return make


def _replica_patch(attr, repl):
    def make():
        from hstream_tpu_torch.store.replica import FollowerService
        return _swap(FollowerService, attr, repl)
    return make


MUTANTS: list[Mutant] = [
    Mutant(
        name="fresh-heartbeat-refusal",
        fix="try_adopt_live refuses any record with a fresh "
            "heartbeat, whatever its epoch",
        scenario="kill-2", kind="sched",
        patch=_sched_patch((scheduler, "try_adopt_live",
                            _try_adopt_live_no_refusal))),
    Mutant(
        name="no-self-fence",
        fix="a definitive heartbeat failure self-fences the local "
            "task (double-owner on slow heartbeat)",
        scenario="kill-2", kind="sched",
        patch=_sched_patch((placer_core.Placer, "_heartbeat_owned",
                            _heartbeat_owned_no_fence))),
    Mutant(
        name="disarmed-stamp",
        fix="disarmed servers write legacy records — a stamp they "
            "can never refresh misreads as a lapsed lease",
        scenario="mixed-2", kind="sched",
        patch=_sched_patch((scheduler, "_owned_record",
                            _owned_record_always_stamped))),
    Mutant(
        name="legacy-epoch-adopt",
        fix="the live adopt sweep never applies the epoch rule to "
            "legacy records of (possibly live) disarmed peers",
        scenario="mixed-2", kind="sched",
        patch=_sched_patch((placer_core.Placer, "_adopt_sweep",
                            _adopt_sweep_no_legacy_skip))),
    Mutant(
        name="lease-unclamped",
        fix="the heartbeat lease is clamped to >= 3x the placer "
            "interval so a delayed tick cannot read as owner death",
        scenario="clamp-2", kind="sched",
        patch=_sched_patch((placer_core.Placer, "__init__",
                            _placer_init_unclamped))),
    Mutant(
        name="created-no-rescue",
        fix="orphaned CREATED queries (creator or offer target died) "
            "are rescued once the record's heartbeat lapses",
        scenario="created-2", kind="sched",
        patch=_sched_patch((placer_core.Placer, "_adopt_sweep",
                            _adopt_sweep_no_created_rescue))),
    Mutant(
        name="hb-foreign-write",
        fix="heartbeat_assignment refreshes only records this node "
            "owns — a fenced loser must not keep a lease alive",
        scenario="kill-2", kind="sched",
        patch=_sched_patch((scheduler, "heartbeat_assignment",
                            _heartbeat_assignment_no_owner_check))),
    Mutant(
        name="promote-no-epoch-guard",
        fix="Promote refuses an epoch <= the follower's (a raced "
            "second promotion is a clean refusal, not a second "
            "leader)",
        scenario="replica-2", kind="replica",
        patch=_replica_patch("Promote", _promote_no_epoch_guard)),
    Mutant(
        name="duel-no-resolution",
        fix="dueling same-epoch promoted leaders resolve "
            "deterministically (higher node id wins on contact)",
        scenario="replica-2", kind="replica",
        patch=_replica_patch("Replicate", _replicate_no_duel_resolution)),
]

BY_NAME = {m.name: m for m in MUTANTS}
