"""Multi-host store replication over DCN.

The reference's storage tier is a replicated LogDevice cluster: the
server takes a ``replicate-factor`` flag and the whole cbits layer binds
a store that survives node loss (reference hstream/app/server.hs:83-90,
hstream-store/include/hs_logdevice.h). The embedded store here is
single-node, so this module adds the replication layer:

  * every mutating store op (append/trim/create/remove/meta) becomes an
    entry in a durable **op-log** — a reserved log inside the local
    store itself, so the replication stream is recoverable from disk;
  * the **leader** applies ops locally, then per-follower sender
    threads stream op-log entries IN ORDER over gRPC (DCN); a follower
    response always carries its applied sequence, so a lagging or
    rejoining follower is caught up from the leader's op-log — the
    same path as steady-state replication;
  * **followers** apply entries deterministically to their own local
    store; starting from the same initial state, replicas are
    byte-identical (same LSNs, same segments' logical content);
  * appends ack once ``replication_factor - 1`` followers (or every
    live follower, whichever is fewer) have applied the entry —
    availability over strict durability when nodes are down, with the
    degradation logged (LogDevice instead re-routes to other nodes of
    a larger cluster);
  * reads stay local on any replica (gap semantics are the local
    store's own).

Leadership is **epoch-fenced**: every Replicate/ack carries a
monotone epoch persisted in store meta. ``Promote`` (the admin
``promote`` verb, or an optional lease-timeout auto-promotion gated
behind ``--auto-promote-lease-ms``) raises a follower's epoch and makes
it the leader; from then on every replica rejects entries from any
lower epoch — a partitioned stale leader is *fenced*, its post-
partition appends land nowhere but its own local store, and its
clients get a typed ``NotLeaderError`` carrying the new leader's
address hint. The promotion rule is "most caught up wins": the caller
picks the replica with the highest ``(epoch, applied_seq)`` (node id
as the deterministic tiebreak); a dueling same-epoch promotion
resolves the same way on first contact. The demoted node rejoins as a
follower through the existing catch-up path — unless it applied
local-only entries while partitioned, in which case the divergence
guard halts it loudly for re-bootstrap (those appends were never
quorum-acked).

Idempotent appends ride the same machinery: a producer-stamped entry
(``producer_id``/``producer_seq`` on the replicated ``LogEntry``)
updates a bounded per-producer dedup window *during apply*, on every
replica, so the window is a deterministic function of the op-log and a
retry that straddles a promotion is answered by the new leader with
the original LSN (store/dedup.py).
"""

# A copy of hstream_tpu/store/replica.py; the port imports
# nothing of the JAX package.

from __future__ import annotations

import random
import threading
import time
import uuid
from concurrent import futures
from typing import Sequence

import grpc

from hstream_tpu_torch.common import locktrace
from hstream_tpu_torch.common.backoff import jittered_backoff
from hstream_tpu_torch.common.errors import (
    NotLeaderError,
    ReplicaDivergence,
    StoreIOError,
)
from hstream_tpu_torch.common.faultinject import FAULTS
from hstream_tpu_torch.common.logger import get_logger
from hstream_tpu_torch.proto import api_pb2 as pb
from hstream_tpu_torch.proto.rpc import StoreReplicaStub, add_store_replica_to_server
from hstream_tpu_torch.store import dedup
from hstream_tpu_torch.store.api import Compression, LogAttrs, LogStore

log = get_logger("replica")

# reserved logid holding the replication op-log inside each local store
OPLOG_ID = (1 << 61) + 7

# default follower-ack deadline; per-store override via the
# --replica-ack-timeout-ms flag (ReplicatedStore ack_timeout_s)
_ACK_TIMEOUT_S = 5.0
# idle-leader heartbeat cadence: zero-entry Replicates keep the
# follower's leader lease fresh AND discover fencing promptly (an idle
# stale leader must not linger unfenced until its next real append)
_HEARTBEAT_S = 1.0
# a Replicate request carries op-log entries up to this many payload
# bytes (at least one entry), and a follower takes a message of up to
# _REPLICA_MSG_BYTES: the SQL server takes appends of up to 64 MiB, so
# one entry fits. gRPC's 4 MiB default refused the catch-up of a few
# framed blocks, and the follower stayed down (ROADMAP C).
_REPLICATE_BYTES = 16 << 20
_REPLICA_MSG_BYTES = 80 << 20

# store-meta keys for the replicated leadership state
META_EPOCH = "replica/epoch"
META_LEADER_ID = "replica/leader_id"
META_LEADER_HINT = "replica/leader_hint"
META_IS_LEADER = "replica/is_leader"


def load_epoch(store: LogStore) -> int:
    raw = store.meta_get(META_EPOCH)
    try:
        return int(raw) if raw else 0
    except ValueError:
        return 0


def _store_epoch(store: LogStore, epoch: int) -> None:
    # single-writer plane: only THIS process writes its own follower
    # meta, under _lock, after the caller's epoch ladder decided the
    # value — a CAS loop here could only race itself
    # analyze: ok cas-blind-meta-write
    store.meta_put(META_EPOCH, str(int(epoch)).encode())
# follower reconnect backoff: jittered exponential from _RETRY_S up to
# _RETRY_CAP_S — a flapping follower must not spin the leader's sender
# thread hot; reset only once a Replicate is ACKED (a peer
# that merely accepts connections keeps backing off)
_RETRY_S = 0.2
_RETRY_CAP_S = 5.0
_RETRY_JITTER = 0.25


def _encode_entry(e: pb.LogEntry) -> bytes:
    return e.SerializeToString()


def _decode_entry(b: bytes) -> pb.LogEntry:
    return pb.LogEntry.FromString(b)


def _apply(store: LogStore, e: pb.LogEntry) -> None:
    """Apply one op to a local store. Deterministic AND idempotent:
    every replica applies the same entries in the same order, and
    re-applying an entry after a crash in the apply/log window is a
    no-op (appends are guarded by expect_lsn; the other ops are
    naturally idempotent)."""
    if FAULTS.active:  # chaos probe; one branch when disarmed
        FAULTS.point("store.oplog.apply")
    if e.op == pb.OP_APPEND:
        if e.expect_lsn:
            tail = store.tail_lsn(e.logid)
            if tail >= e.expect_lsn:
                # already applied (crash between apply and log): still
                # (re)record the producer stamp — record() is
                # idempotent and the dedup window must cover every
                # applied entry
                if e.producer_id:
                    dedup.record(store, e.producer_id, e.producer_seq,
                                 e.expect_lsn, len(e.payloads))
                return
            if tail != e.expect_lsn - 1:
                # checked BEFORE mutating: appending first and then
                # discovering the wrong LSN would land garbage that
                # every retry of this entry compounds
                raise ReplicaDivergence(
                    f"replica diverged: log {e.logid} tail is {tail}, "
                    f"entry expects lsn {e.expect_lsn}")
        lsn = store.append_batch(e.logid, list(e.payloads),
                                 Compression(e.compression),
                                 append_time_ms=e.append_time_ms or None)
        if e.expect_lsn and lsn != e.expect_lsn:
            raise ReplicaDivergence(
                f"replica diverged: append to log {e.logid} landed at "
                f"lsn {lsn}, expected {e.expect_lsn}")
        if e.producer_id:
            # the dedup window is maintained AS PART OF applying the
            # entry, on every replica: deterministic from the op-log,
            # so a promoted follower already knows every stamped
            # append its prefix contains
            dedup.record(store, e.producer_id, e.producer_seq,
                         lsn, len(e.payloads))
    elif e.op == pb.OP_TRIM:
        store.trim(e.logid, e.trim_lsn)
    elif e.op == pb.OP_CREATE_LOG:
        if not store.log_exists(e.logid):
            store.create_log(e.logid, LogAttrs(
                replication_factor=e.replication_factor or 1,
                backlog_seconds=e.backlog_seconds))
    elif e.op == pb.OP_REMOVE_LOG:
        if store.log_exists(e.logid):
            store.remove_log(e.logid)
    elif e.op == pb.OP_META_PUT:
        store.meta_put(e.meta_key, e.meta_value)
    elif e.op == pb.OP_META_DELETE:
        store.meta_delete(e.meta_key)
    else:  # unknown op from a newer leader: fail loudly, don't diverge
        raise ValueError(f"unknown replication op {e.op}")


def _stable_node_id(store: LogStore) -> str:
    nid = store.meta_get("replica/node_id")
    if nid is None:
        nid = f"leader-{uuid.uuid4().hex[:10]}".encode()
        # first-boot identity stamp on a store no peer can reach yet
        # (the server opens the store before serving)
        # analyze: ok cas-blind-meta-write
        store.meta_put("replica/node_id", nid)
    return nid.decode()


def _reconcile(store: LogStore) -> None:
    """Crash recovery for the apply/log window: ops are serialized, so
    at most the LAST op-log entry can be logged-but-unapplied (leader
    logs first) — re-apply it; idempotence makes this safe when it DID
    apply."""
    tail = store.tail_lsn(OPLOG_ID)
    if not tail:
        return
    reader = store.new_reader()
    reader.set_timeout(0)
    reader.start_reading(OPLOG_ID, tail, tail)
    for item in reader.read(4):
        if hasattr(item, "payloads"):
            for p in item.payloads:
                e = _decode_entry(p)
                e.seq = item.lsn
                if e.op == pb.OP_APPEND and not e.expect_lsn:
                    # no idempotence marker: re-applying could
                    # duplicate the batch — skipping risks at most one
                    # missing apply, which the seq handshake surfaces
                    log.warning("skipping reconcile of unverifiable "
                                "append at seq %d", e.seq)
                    continue
                _apply(store, e)
    reader.stop_reading(OPLOG_ID)


class _Follower:
    """Leader-side sender for one follower: an in-order stream of
    op-log entries driven by the follower's acked sequence."""

    def __init__(self, addr: str, owner: "ReplicatedStore"):
        self.addr = addr
        self.owner = owner
        self.acked_seq = 0
        self.alive = False
        # set once the first connection attempt has ended, up or down:
        # until then the follower is pending, not down (a fresh
        # leader's first mutations wait for it instead of acking
        # degraded before the sender ever dialled)
        self.tried = False
        # reconnect backoff state: attempt count since the last ACKED
        # Replicate (not merely the last good connect) + the wait the
        # next failure will schedule (tests assert growth and the
        # cap). Jitter is seeded per follower so a chaos run replays
        # the same wait sequence.
        self.connect_attempts = 0
        self.last_backoff_s = 0.0
        self._jitter = random.Random(addr)
        self._thread = threading.Thread(
            target=self._run, name=f"repl-{addr}", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def _backoff(self) -> float:
        """Jittered exponential reconnect wait: base * 2^attempt capped
        at _RETRY_CAP_S, +/- _RETRY_JITTER so a fleet of senders
        doesn't reconnect in lockstep."""
        wait = jittered_backoff(
            self.connect_attempts, base=_RETRY_S, cap=_RETRY_CAP_S,
            jitter=_RETRY_JITTER, rng=self._jitter)
        self.connect_attempts += 1
        self.last_backoff_s = wait
        return wait

    def _run(self) -> None:
        owner = self.owner
        while not owner._stop.is_set():
            if owner.fenced_by is not None:
                # leadership lost: stop streaming (the follower would
                # fence every entry anyway); park on the backoff so
                # close() still tears the thread down promptly
                if owner._stop.wait(self._backoff()):
                    return
                continue
            try:
                if FAULTS.active:  # chaos: provoke a connect failure
                    FAULTS.point("store.follower.connect")
                with grpc.insecure_channel(self.addr) as ch:
                    stub = StoreReplicaStub(ch)
                    info = stub.ReplicaInfo(pb.ReplicaInfoRequest(),
                                            timeout=owner.ack_timeout_s)
                    if info.epoch > owner.epoch:
                        # the cluster moved on without us: fence BEFORE
                        # streaming a single stale entry
                        owner._fence(info.epoch, info.leader_hint)
                        continue
                    self.acked_seq = info.applied_seq
                    if not self.alive:
                        log.info("follower %s up at seq %d", self.addr,
                                 self.acked_seq)
                    self.alive = self.tried = True
                    with owner._cond:
                        owner._cond.notify_all()
                    self._stream(stub)
            except Exception as e:  # noqa: BLE001 — any failure (RPC,
                # local read, decode) must keep the retry loop alive and
                # the follower marked down, never kill the sender thread
                # with alive stuck True
                if self.alive:
                    log.warning("follower %s down: %s", self.addr,
                                e.code() if isinstance(e, grpc.RpcError)
                                else e)
                    journal = getattr(owner, "journal", None)
                    if journal is not None:
                        try:
                            journal.append(
                                "follower_down",
                                f"store follower {self.addr} stopped "
                                f"acking at seq {self.acked_seq}",
                                follower=self.addr,
                                acked_seq=self.acked_seq)
                        except Exception:  # noqa: BLE001
                            pass
                self.alive = False
                self.tried = True
                with owner._cond:
                    owner._cond.notify_all()
                if owner._stop.wait(self._backoff()):
                    return
        self.alive = False

    def _heartbeat(self, stub) -> None:
        """Zero-entry Replicate: refreshes the follower's leader lease
        and discovers fencing even when the leader is idle."""
        if FAULTS.active:  # chaos: lose the heartbeat (lease expiry)
            FAULTS.point("replica.heartbeat.drop")
        owner = self.owner
        resp = stub.Replicate(
            pb.ReplicateRequest(entries=[], leader_id=owner.node_id,
                                epoch=owner.epoch,
                                leader_hint=owner.client_addr),
            timeout=owner.ack_timeout_s)
        if resp.fenced:
            owner._fence(resp.epoch, resp.leader_hint)
            raise StoreIOError("fenced by follower heartbeat")

    def _stream(self, stub) -> None:
        owner = self.owner
        reader = owner.local.new_reader()
        reader.set_timeout(0)
        pos = 0  # next seq the persistent reader is positioned at
        last_send = time.monotonic()
        try:
            while not owner._stop.is_set():
                with owner._cond:
                    while (self.acked_seq >= owner._seq
                           and not owner._stop.is_set()
                           and time.monotonic() - last_send
                           < _HEARTBEAT_S):
                        owner._cond.wait(0.5)
                    if owner._stop.is_set():
                        return
                if self.acked_seq >= owner.oplog_seq:
                    self._heartbeat(stub)
                    last_send = time.monotonic()
                    continue
                want = self.acked_seq + 1
                if pos != want:
                    if pos:
                        reader.stop_reading(OPLOG_ID)
                    reader.start_reading(OPLOG_ID, want)
                    pos = want
                entries = []
                gap_hi = 0
                size = 0
                # an op-log batch at a time, so the reader stops where
                # the request's byte budget does
                while len(entries) < 64 and size < _REPLICATE_BYTES:
                    got = reader.read(1)
                    if not got:
                        break
                    for item in got:
                        if hasattr(item, "payloads"):
                            for p in item.payloads:
                                e = _decode_entry(p)
                                e.seq = item.lsn  # seq IS the op-log LSN
                                entries.append(e)
                                size += len(p)
                        elif hasattr(item, "hi_lsn"):
                            gap_hi = max(gap_hi, item.hi_lsn)
                if gap_hi and (not entries
                               or entries[0].seq != want):
                    # the follower is below the op-log trim point:
                    # catch-up cannot reconstruct those ops. Stop
                    # replicating to it — operator re-bootstraps the
                    # replica from a copy of a live store.
                    log.error(
                        "follower %s needs entries up to seq %d but "
                        "the op-log is trimmed to %d; re-bootstrap "
                        "this replica", self.addr, gap_hi,
                        self.owner.local.trim_point(OPLOG_ID))
                    raise StoreIOError("follower below op-log trim")
                if not entries:
                    continue
                pos = entries[-1].seq + 1
                if FAULTS.active:  # chaos: drop the ack RPC
                    FAULTS.point("store.follower.ack")
                resp = stub.Replicate(
                    pb.ReplicateRequest(entries=entries,
                                        leader_id=owner.node_id,
                                        epoch=owner.epoch,
                                        leader_hint=owner.client_addr),
                    timeout=owner.ack_timeout_s)
                last_send = time.monotonic()
                if resp.fenced:
                    # a higher epoch holds this follower: we are the
                    # stale leader — stop immediately, record who to
                    # redirect clients to, never mark these entries
                    # acked
                    owner._fence(resp.epoch, resp.leader_hint)
                    raise StoreIOError(
                        f"fenced by {self.addr} at epoch {resp.epoch}")
                # the follower's word is authoritative: a lagging
                # applied seq rewinds the stream (e.g. it restarted
                # from older disk)
                self.acked_seq = resp.applied_seq
                # real streaming progress: only now does the reconnect
                # schedule start over — a half-broken peer that answers
                # ReplicaInfo but fails every Replicate must keep
                # backing off, not retry at the floor forever
                self.connect_attempts = 0
                self.last_backoff_s = 0.0
                with owner._cond:
                    owner._cond.notify_all()
        finally:
            if pos:
                reader.stop_reading(OPLOG_ID)


class ReplicatedStore(LogStore):
    """Leader-side LogStore: applies locally + replicates to followers.

    Mutations go through the durable op-log; reads and introspection are
    the local store's. ``append_batch`` blocks until the entry is
    applied on min(replication_factor-1, live followers) replicas."""

    def __init__(self, local: LogStore, followers: Sequence[str], *,
                 replication_factor: int = 2,
                 node_id: str | None = None,
                 ack_timeout_s: float | None = None,
                 client_addr: str = ""):
        self.local = local
        # stable across restarts (persisted in the local store) AND
        # unique per store: a follower rejects entries from a second
        # leader by id, which only works if ids differ between stores
        # but SURVIVE a leader restart
        self.node_id = node_id or _stable_node_id(local)
        self.replication_factor = max(int(replication_factor), 1)
        # follower-ack deadline (--replica-ack-timeout-ms); module
        # default kept monkeypatchable for tests
        self.ack_timeout_s = (float(ack_timeout_s) if ack_timeout_s
                              else _ACK_TIMEOUT_S)
        # leadership epoch: persisted in store meta, so a store
        # promoted while serving as a follower opens here already
        # holding the promoted epoch
        self.epoch = load_epoch(local)
        # (epoch, leader_hint) once a higher epoch fences this leader;
        # every further mutation raises NotLeaderError with the hint
        self.fenced_by: tuple[int, str] | None = None
        self.fenced_appends = 0
        # where clients reach THIS leader (serve() sets host:port);
        # rides every Replicate so followers can hand it out as the
        # leader hint
        self.client_addr = client_addr
        # optional StatsHolder (bound by ServerContext, like journal)
        self.stats = None
        self._stop = threading.Event()
        # condition over a named traced re-entrant lock:
        # the op-log sequence, sender wakeups, and ack waits all
        # rendezvous here — the leader half of the witness graph
        self._cond = threading.Condition(locktrace.rlock("replica.oplog"))
        self._broken: BaseException | None = None
        # durability introspection: status of the most recent acked
        # append ("replicated" | "degraded:followers_down" |
        # "degraded:timeout") + a monotone degraded counter, so callers
        # can assert what an ack actually meant instead of trusting the
        # normal return (a timed-out ack used to look fully
        # replicated)
        self.last_ack_status: str = "replicated"
        self.degraded_appends: int = 0
        # optional event journal (stats.events.EventJournal): the server
        # context attaches one so degraded acks / follower loss become
        # queryable operator events, not just log lines
        self.journal = None
        self._async_pool = futures.ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="repl-ack")
        self._ops_since_trim = 0
        if not local.log_exists(OPLOG_ID):
            local.create_log(OPLOG_ID)
        _reconcile(local)  # crash in the log/apply window: replay last
        self._seq = local.tail_lsn(OPLOG_ID)  # durable across restarts
        self._followers = [_Follower(a, self) for a in followers]
        for f in self._followers:
            f.start()

    # ---- replication core --------------------------------------------------

    def _check_broken(self) -> None:
        if self._broken is not None:
            raise StoreIOError(
                f"replicated store is in a broken state (an op was "
                f"logged but failed to apply locally): {self._broken}")

    def _check_leader(self) -> None:
        """Refuse mutations once fenced: raising BEFORE the local
        log+apply keeps the stale leader's store from diverging
        further, and the hint redirects the caller to the new leader.
        """
        fenced = self.fenced_by
        if fenced is None:
            return
        epoch, hint = fenced
        with self._cond:
            self.fenced_appends += 1
        stats = self.stats
        if stats is not None:
            try:
                stats.stream_stat_add("fenced_appends", "_store")
            except Exception:  # noqa: BLE001 — metrics must not alter
                pass           # the refusal
        raise NotLeaderError(
            f"store leadership lost: fenced by epoch {epoch} "
            f"(this node held epoch {self.epoch})",
            leader_hint=hint or None)

    def _fence(self, epoch: int, leader_hint: str) -> None:
        """A replica answered with a higher epoch: this node is no
        longer the leader. Idempotent; keeps the HIGHEST fencing epoch
        seen (dueling promotions converge on the winner's hint)."""
        with self._cond:
            if self.fenced_by is not None and self.fenced_by[0] >= epoch:
                return
            self.fenced_by = (int(epoch), leader_hint or "")
            self._cond.notify_all()
        log.error("store leader %s FENCED by epoch %d (own epoch %d); "
                  "clients redirected to %r", self.node_id, epoch,
                  self.epoch, leader_hint)
        journal = self.journal
        if journal is not None:
            try:
                journal.append(
                    "replica_fenced",
                    f"leader {self.node_id} (epoch {self.epoch}) fenced "
                    f"by epoch {epoch}; leader hint {leader_hint!r}",
                    epoch=int(epoch), own_epoch=self.epoch,
                    leader_hint=leader_hint or None)
            except Exception:  # noqa: BLE001 — journaling is best-effort
                pass

    def _log_and_apply(self, entry: pb.LogEntry) -> int:
        """The one critical section: durably log the op, apply it
        locally, wake the sender threads. Returns the op's seq.
        Caller holds nothing; broken-state on apply failure."""
        self._check_leader()
        self._check_broken()
        with self._cond:
            return self._log_apply_locked(entry)

    def _log_apply_locked(self, entry: pb.LogEntry) -> int:
        """Caller holds _cond (and has run the leader/broken checks)."""
        if entry.op == pb.OP_APPEND:
            # stamp idempotence + time BEFORE logging, under the
            # lock: replicas must land the append at this LSN with
            # this timestamp
            entry.expect_lsn = self.local.tail_lsn(entry.logid) + 1
            if not entry.append_time_ms:
                entry.append_time_ms = int(time.time() * 1000)
        seq = self.local.append(OPLOG_ID, _encode_entry(entry))
        self._seq = seq
        try:
            _apply(self.local, entry)
        except Exception as e:  # noqa: BLE001
            # the op is durably logged (followers WILL apply it) but
            # this replica didn't: refusing further mutations beats
            # silent divergence
            self._broken = e
            log.error("leader apply failed at seq %d: %s", seq, e)
            raise
        self._cond.notify_all()
        return seq

    def _replicate(self, entry: pb.LogEntry, *, wait: bool = True) -> None:
        seq = self._log_and_apply(entry)
        if wait:
            self._wait_acks(seq)

    def follower_status(self) -> list[dict]:
        """Per-follower liveness/lag plus the store-level ack status on
        every entry, so one call answers both "who is behind" and "was
        the last ack degraded"."""
        # found by hstream-analyze (lock-guard): _seq is written under
        # _cond by _log_and_apply/meta_cas on appender threads; reading
        # it unlocked here could report a lag computed from a stale seq
        seq = self.oplog_seq
        return [{"addr": f.addr, "alive": f.alive,
                 "acked_seq": f.acked_seq,
                 "behind": max(0, seq - f.acked_seq),
                 "last_ack_status": self.last_ack_status,
                 "degraded_appends": self.degraded_appends}
                for f in self._followers]

    def leader_status(self) -> dict:
        """Store-level leadership state for the admin `replicas` verb:
        epoch, fencing, ack-timeout tuning, dedup-window footprint."""
        fenced = self.fenced_by
        return {"node_id": self.node_id, "epoch": self.epoch,
                "fenced": fenced is not None,
                "fenced_by_epoch": fenced[0] if fenced else None,
                "leader_hint": fenced[1] if fenced else None,
                "fenced_appends": self.fenced_appends,
                "ack_timeout_ms": int(self.ack_timeout_s * 1000),
                "dedup_window": dedup.window_size(self.local)}

    def promote_follower(self, target: str, *,
                         leader_addr: str | None = None) -> dict:
        """Planned handoff: promote `target` to epoch+1, fence THIS
        leader immediately (clients get the hint instead of a stale
        ack), and SEAL the remaining followers at the new epoch so
        none of them acks another of this leader's entries during the
        handoff window. The admin `promote` verb rides this; leader-
        death promotion goes straight to the replicas (admin CLI
        ``promote --replicas``)."""
        new_epoch = self.epoch + 1
        hint = leader_addr or target
        with grpc.insecure_channel(target) as ch:
            resp = StoreReplicaStub(ch).Promote(
                pb.PromoteRequest(epoch=new_epoch, leader_addr=hint,
                                  promoted_by=self.node_id),
                timeout=self.ack_timeout_s)
        sealed: list[str] = []
        if resp.ok:
            self._fence(resp.epoch, hint)
            sealed = seal_replicas(
                [f.addr for f in self._followers if f.addr != target],
                epoch=int(resp.epoch), leader_id=resp.node_id,
                leader_hint=hint, timeout=self.ack_timeout_s)
            journal = self.journal
            if journal is not None:
                try:
                    journal.append(
                        "replica_promoted",
                        f"follower {target} promoted to epoch "
                        f"{resp.epoch} by {self.node_id}; this leader "
                        f"is fenced, {len(sealed)} peer(s) sealed",
                        target=target, epoch=int(resp.epoch),
                        applied_seq=int(resp.applied_seq))
                except Exception:  # noqa: BLE001
                    pass
        return {"ok": bool(resp.ok), "epoch": int(resp.epoch),
                "applied_seq": int(resp.applied_seq),
                "node_id": resp.node_id, "target": target,
                "sealed": sealed}

    @property
    def oplog_seq(self) -> int:
        with self._cond:
            return self._seq

    # ---- LogStore: mutations (replicated) ----------------------------------

    def create_log(self, logid: int, attrs: LogAttrs | None = None) -> None:
        a = attrs or LogAttrs()
        self._replicate(pb.LogEntry(
            op=pb.OP_CREATE_LOG, logid=logid,
            replication_factor=a.replication_factor,
            backlog_seconds=a.backlog_seconds))

    def remove_log(self, logid: int) -> None:
        self._replicate(pb.LogEntry(op=pb.OP_REMOVE_LOG, logid=logid))

    def append_batch(self, logid: int, payloads: Sequence[bytes],
                     compression: Compression = Compression.NONE, *,
                     append_time_ms: int | None = None) -> int:
        entry = pb.LogEntry(op=pb.OP_APPEND, logid=logid,
                            payloads=[bytes(p) for p in payloads],
                            compression=compression.value,
                            append_time_ms=append_time_ms or 0)
        seq = self._log_and_apply(entry)
        self._wait_acks(seq)
        self._maybe_trim_oplog()
        return entry.expect_lsn

    def append_batch_dedup(self, logid: int, payloads: Sequence[bytes],
                           compression: Compression = Compression.NONE,
                           *, producer_id: str, producer_seq: int
                           ) -> tuple[int, int, bool]:
        """Producer-stamped append: returns (lsn, n_records,
        was_duplicate). The dedup lookup and the log+apply share ONE
        critical section, and the stamp rides the replicated entry, so
        a racing retry can never double-log and every replica derives
        the same window (store/dedup.py)."""
        self._check_leader()
        self._check_broken()
        entry = pb.LogEntry(op=pb.OP_APPEND, logid=logid,
                            payloads=[bytes(p) for p in payloads],
                            compression=compression.value,
                            producer_id=producer_id,
                            producer_seq=int(producer_seq))
        with self._cond:
            hit = dedup.lookup(self.local, producer_id, producer_seq)
            if hit is not None:
                return hit[0], hit[1], True
            seq = self._log_apply_locked(entry)
        self._wait_acks(seq)
        self._maybe_trim_oplog()
        return entry.expect_lsn, len(payloads), False

    def _maybe_trim_oplog(self) -> None:
        """Reclaim op-log space every so often: entries every follower
        has applied are never needed again (a rejoining follower below
        the trim point is unrecoverable by catch-up and must be
        re-bootstrapped from a copy — the trade LogDevice also makes
        with trimmed logs). A permanently-dead follower pins the op-log
        until the operator removes it from --replicate."""
        self._ops_since_trim += 1
        if self._ops_since_trim < 512 or not self._followers:
            return
        self._ops_since_trim = 0
        if not all(f.alive for f in self._followers):
            return
        low = min(f.acked_seq for f in self._followers)
        if low > self.local.trim_point(OPLOG_ID):
            self.local.trim(OPLOG_ID, low)

    def _wait_acks(self, seq: int) -> str:
        """Wait for the replication quorum; returns the DURABILITY the
        ack actually achieved — "replicated" when `need` followers
        applied the op, else a degraded status ("degraded:
        followers_down" / "degraded:timeout"). A degraded return is
        recorded (last_ack_status, degraded_appends) so callers and
        tests can assert it instead of mistaking availability for full
        replication."""
        status = self._wait_acks_inner(seq)
        # under the lock: async-append pool threads and callers wait
        # acks concurrently, and a lost increment would undercount
        # degraded events exactly when the cluster is degraded
        with self._cond:
            self.last_ack_status = status
            if status != "replicated":
                self.degraded_appends += 1
        if status != "replicated" and self.journal is not None:
            # an expired ack deadline gets its own event kind (the
            # timeout used to only degrade silently); follower-down
            # degradation keeps the generic kind
            kind = ("replica_ack_timeout" if status == "degraded:timeout"
                    else "degraded_append")
            try:
                self.journal.append(
                    kind, f"append acked {status} at seq {seq}",
                    status=status, seq=seq,
                    ack_timeout_ms=int(self.ack_timeout_s * 1000))
            except Exception:  # noqa: BLE001 — journaling must not
                pass           # affect append durability semantics
        return status

    def _wait_acks_inner(self, seq: int) -> str:
        if not self._followers:
            return "replicated"
        need = min(self.replication_factor - 1, len(self._followers))
        if need <= 0:
            return "replicated"
        deadline = time.monotonic() + self.ack_timeout_s
        with self._cond:
            while True:
                acked = sum(1 for f in self._followers
                            if f.acked_seq >= seq)
                if acked >= need:
                    return "replicated"
                live = sum(1 for f in self._followers if f.alive)
                dialled = all(f.tried for f in self._followers)
                if acked >= live and dialled:
                    if live < need:
                        log.warning(
                            "replication degraded: %d/%d followers "
                            "live; seq %d acked by %d", live,
                            len(self._followers), seq, acked)
                        return "degraded:followers_down"
                if time.monotonic() > deadline:
                    log.warning(
                        "replication ack timeout at seq %d (%d/%d)",
                        seq, acked, need)
                    return "degraded:timeout"
                self._cond.wait(0.2)

    def trim(self, logid: int, up_to_lsn: int) -> None:
        self._replicate(pb.LogEntry(op=pb.OP_TRIM, logid=logid,
                                    trim_lsn=up_to_lsn))

    def meta_put(self, key: str, value: bytes) -> None:
        self._replicate(pb.LogEntry(op=pb.OP_META_PUT, meta_key=key,
                                    meta_value=value), wait=False)

    def meta_delete(self, key: str) -> None:
        self._replicate(pb.LogEntry(op=pb.OP_META_DELETE, meta_key=key),
                        wait=False)

    def meta_cas(self, key: str, expected: bytes | None,
                 value: bytes) -> bool:
        # CAS decided on the leader (the single sequencer), replicated
        # as its winning put. CAS + op-log append stay in ONE critical
        # section: two racing winners must log their puts in decision
        # order, or the earlier value would overwrite the later one on
        # every replica.
        self._check_leader()
        self._check_broken()
        with self._cond:
            ok = self.local.meta_cas(key, expected, value)
            if ok:
                seq = self.local.append(OPLOG_ID, _encode_entry(
                    pb.LogEntry(op=pb.OP_META_PUT, meta_key=key,
                                meta_value=value)))
                self._seq = seq
                self._cond.notify_all()
        return ok

    # ---- LogStore: reads/introspection (local) -----------------------------

    def log_exists(self, logid: int) -> bool:
        return self.local.log_exists(logid)

    def list_logs(self) -> list[int]:
        return [l for l in self.local.list_logs() if l != OPLOG_ID]

    def log_attrs(self, logid: int) -> LogAttrs:
        return self.local.log_attrs(logid)

    def tail_lsn(self, logid: int) -> int:
        return self.local.tail_lsn(logid)

    def trim_point(self, logid: int) -> int:
        return self.local.trim_point(logid)

    def find_time(self, logid: int, ts_ms: int) -> int:
        return self.local.find_time(logid, ts_ms)

    def is_log_empty(self, logid: int) -> bool:
        return self.local.is_log_empty(logid)

    def new_reader(self, max_logs: int = 1):
        return self.local.new_reader(max_logs)

    def meta_get(self, key: str) -> bytes | None:
        return self.local.meta_get(key)

    def meta_list(self, prefix: str) -> list[str]:
        return self.local.meta_list(prefix)

    def close(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        for f in self._followers:
            f._thread.join(timeout=2)
        self._async_pool.shutdown(wait=True)
        self.local.close()

    # async append parity with the native store (sink fast path): the
    # local log+apply happens inline (cheap), but the follower-ack wait
    # moves to a pool thread so the caller keeps its bounded-in-flight
    # pipelining instead of serializing on a DCN round trip per batch
    def append_async(self, logid: int, payloads: Sequence[bytes],
                     compression: Compression = Compression.NONE):
        entry = pb.LogEntry(op=pb.OP_APPEND, logid=logid,
                            payloads=[bytes(p) for p in payloads],
                            compression=compression.value)
        seq = self._log_and_apply(entry)
        lsn = entry.expect_lsn

        def waiter() -> int:
            self._wait_acks(seq)
            self._maybe_trim_oplog()
            return lsn

        return self._async_pool.submit(waiter)


def replica_info(addr: str, timeout: float = 2.0):
    """ReplicaInfo from one replica, or None when unreachable."""
    try:
        with grpc.insecure_channel(addr) as ch:
            return StoreReplicaStub(ch).ReplicaInfo(
                pb.ReplicaInfoRequest(), timeout=timeout)
    except grpc.RpcError:
        return None


def best_replica(addrs: Sequence[str], timeout: float = 2.0
                 ) -> tuple[str, tuple[int, int, str]] | None:
    """The most-caught-up reachable replica: highest
    (epoch, applied_seq, node_id) — the promotion rule. Returns
    (addr, key) or None when nothing answers."""
    best: tuple[str, tuple[int, int, str]] | None = None
    for addr in addrs:
        info = replica_info(addr, timeout)
        if info is None:
            continue
        key = (int(info.epoch), int(info.applied_seq), info.node_id)
        if best is None or key > best[1]:
            best = (addr, key)
    return best


def seal_replicas(addrs: Sequence[str], *, epoch: int, leader_id: str,
                  leader_hint: str, timeout: float = 5.0) -> list[str]:
    """Zero-entry Replicate at `epoch` to each replica: the receivers
    accept the new (epoch, leader) binding and from then on reject the
    old leader's entries by epoch. This closes the promotion window in
    which a not-yet-contacted follower would still ACK a stale
    leader's append (an ack the new leader could never honor).
    Best-effort: returns the addrs that acknowledged; an unreachable
    replica is sealed by the new leader's first contact instead."""
    sealed: list[str] = []
    for addr in addrs:
        try:
            with grpc.insecure_channel(addr) as ch:
                StoreReplicaStub(ch).Replicate(
                    pb.ReplicateRequest(entries=[], leader_id=leader_id,
                                        epoch=epoch,
                                        leader_hint=leader_hint),
                    timeout=timeout)
            sealed.append(addr)
        except grpc.RpcError:
            continue
    return sealed


def promote_best(addrs: Sequence[str], *, leader_addr: str | None = None,
                 promoted_by: str = "operator",
                 timeout: float = 5.0) -> dict:
    """Leader-death promotion (admin CLI ``promote --replicas``): pick
    the most-caught-up reachable replica, promote it to
    max(observed epochs) + 1, and seal the remaining reachable
    replicas at that epoch (none of them may ack a resurfacing stale
    leader afterwards). Raises StoreIOError when no replica
    answers."""
    infos = {addr: replica_info(addr, timeout) for addr in addrs}
    live = {a: i for a, i in infos.items() if i is not None}
    if not live:
        raise StoreIOError(f"no replica reachable among {list(addrs)}")
    best_addr = max(live, key=lambda a: (int(live[a].epoch),
                                         int(live[a].applied_seq),
                                         live[a].node_id))
    new_epoch = max(int(i.epoch) for i in live.values()) + 1
    hint = leader_addr or best_addr
    with grpc.insecure_channel(best_addr) as ch:
        resp = StoreReplicaStub(ch).Promote(
            pb.PromoteRequest(epoch=new_epoch, leader_addr=hint,
                              promoted_by=promoted_by),
            timeout=timeout)
    sealed = []
    if resp.ok:
        sealed = seal_replicas(
            [a for a in live if a != best_addr],
            epoch=int(resp.epoch), leader_id=resp.node_id,
            leader_hint=hint, timeout=timeout)
    return {"ok": bool(resp.ok), "target": best_addr,
            "epoch": int(resp.epoch),
            "applied_seq": int(resp.applied_seq),
            "node_id": resp.node_id, "sealed": sealed,
            "unreachable": sorted(set(addrs) - set(live))}


class FollowerService:
    """Follower-side gRPC service: applies in-order entries to the
    local store; always answers with its applied sequence and epoch.

    Epoch fencing: the accepted leader binding is
    ``(epoch, leader_id)``, both durable in store meta. A request from
    a HIGHER epoch always wins (the old leader was deposed — journal
    ``leader_change``, demote self if promoted); a request from a
    LOWER epoch is answered ``fenced=True`` with the current epoch and
    leader hint, and nothing is applied — a partitioned stale leader
    cannot split-brain its followers. Same-epoch conflicts keep the
    original semantics (operator error -> FAILED_PRECONDITION), except
    between two same-epoch PROMOTED leaders (a dueling promotion),
    which resolves deterministically: the lexicographically higher
    node id wins on first contact."""

    def __init__(self, local: LogStore, *, node_id: str = "follower",
                 journal=None, listen_addr: str = "",
                 advertise_addr: str = "",
                 lease_timeout_s: float | None = None,
                 peers: Sequence[str] = ()):
        self.local = local
        self.node_id = node_id
        self.journal = journal  # optional stats.events.EventJournal
        self.listen_addr = listen_addr
        # client-facing address served as the leader hint if THIS
        # replica auto-promotes (where the operator will boot the SQL
        # server over the promoted store); without it the hint falls
        # back to the replica listen addr, which serves StoreReplica,
        # not HStreamApi — a followed client would then fail
        # UNIMPLEMENTED instead of reaching a SQL surface
        self.advertise_addr = advertise_addr
        # named traced lock: epoch/fencing/bind state — the
        # follower half of the replica witness graph
        self._lock = locktrace.lock("replica.follower")
        self._broken: BaseException | None = None
        # the accepted leader binding is DURABLE (store meta): a
        # restarted follower must keep rejecting a stale leader instead
        # of re-accepting whichever connects first after the restart
        raw = local.meta_get(META_LEADER_ID)
        self._leader_id: str | None = (raw.decode() if raw is not None
                                       else None)
        self._epoch = load_epoch(local)
        hint = local.meta_get(META_LEADER_HINT)
        self._leader_hint: str | None = (hint.decode() if hint else None)
        self._is_leader = local.meta_get(META_IS_LEADER) == b"1"
        self._last_leader_contact = time.monotonic()
        self._ops_since_trim = 0
        if not local.log_exists(OPLOG_ID):
            local.create_log(OPLOG_ID)
        _reconcile(local)
        # optional lease-timeout auto-promotion (gated behind the
        # --auto-promote-lease-ms flag): if the accepted leader goes
        # silent past the lease, promote self — but only after
        # checking that no reachable peer is more caught up (highest
        # (epoch, applied_seq, node_id) wins, same rule as admin
        # promote)
        if lease_timeout_s:
            # floor the lease well above the idle-heartbeat cadence:
            # heartbeats go out on a ~1.5s worst-case period (the
            # _HEARTBEAT_S threshold checked on a 0.5s cond poll), so
            # a smaller lease would fence a perfectly healthy idle
            # leader between two heartbeats
            floor = _HEARTBEAT_S * 3
            if lease_timeout_s < floor:
                log.warning(
                    "auto-promote lease %.2fs is below the heartbeat "
                    "floor; clamping to %.2fs", lease_timeout_s, floor)
                lease_timeout_s = floor
        self.lease_timeout_s = lease_timeout_s
        self.peers = [p for p in peers if p]
        self._stop_ev = threading.Event()
        self._lease_thread: threading.Thread | None = None
        if lease_timeout_s:
            self._lease_thread = threading.Thread(
                target=self._lease_loop, name=f"lease-{node_id}",
                daemon=True)
            self._lease_thread.start()

    def close(self) -> None:
        """Stop the lease monitor (serve_follower shutdown path)."""
        self._stop_ev.set()
        t = self._lease_thread
        if t is not None:
            t.join(timeout=5)

    @property
    def applied_seq(self) -> int:
        return self.local.tail_lsn(OPLOG_ID)

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    @property
    def is_leader(self) -> bool:
        with self._lock:
            return self._is_leader

    def _journal_event(self, kind: str, message: str, **fields) -> None:
        if self.journal is None:
            return
        try:
            self.journal.append(kind, message, **fields)
        except Exception:  # noqa: BLE001 — journaling is best-effort
            pass

    def _accept_leader_locked(self, request) -> None:
        """Bind (epoch, leader_id, hint) from an accepted request;
        demotes a promoted self. Caller holds _lock."""
        was = (self._epoch, self._leader_id)
        if request.epoch > self._epoch:
            self._epoch = int(request.epoch)
            _store_epoch(self.local, self._epoch)
        # binding writes below are waived as single-writer: only this
        # follower writes its own durable meta, under _lock, after the
        # Replicate epoch ladder accepted the leader
        self._leader_id = request.leader_id
        self.local.meta_put(META_LEADER_ID, request.leader_id.encode())  # analyze: ok cas-blind-meta-write
        if request.leader_hint:
            self._leader_hint = request.leader_hint
            self.local.meta_put(META_LEADER_HINT,  # analyze: ok cas-blind-meta-write
                                request.leader_hint.encode())
        if self._is_leader:
            self._is_leader = False
            self.local.meta_put(META_IS_LEADER, b"0")  # analyze: ok cas-blind-meta-write
        self._journal_event(
            "leader_change",
            f"replica {self.node_id} accepted leader "
            f"{request.leader_id} at epoch {self._epoch} "
            f"(was {was[1]!r} at epoch {was[0]})",
            leader=request.leader_id, epoch=self._epoch)

    def _fenced_response(self, request) -> "pb.ReplicateResponse":
        """Reject a stale leader's entries by epoch. Caller holds
        _lock."""
        self._journal_event(
            "replica_fenced",
            f"replica {self.node_id} (epoch {self._epoch}) fenced "
            f"stale leader {request.leader_id!r} (epoch "
            f"{request.epoch}); {len(request.entries)} entries "
            f"rejected",
            stale_leader=request.leader_id,
            stale_epoch=int(request.epoch), epoch=self._epoch,
            entries=len(request.entries))
        return pb.ReplicateResponse(
            applied_seq=self.applied_seq, epoch=self._epoch,
            fenced=True, leader_hint=self._leader_hint or "")

    def Replicate(self, request, context):
        if FAULTS.active:  # chaos: network partition — this follower
            # is unreachable from its leader (the RPC fails before the
            # epoch/bind checks, exactly like a dropped link)
            FAULTS.point("replica.partition")
        with self._lock:
            if self._broken is not None:
                context.abort(
                    grpc.StatusCode.INTERNAL,
                    f"replica diverged and refuses entries: "
                    f"{self._broken}")
            if request.epoch < self._epoch:
                # stale leader: reject by epoch, answer with who leads
                # now — nothing below this line runs for its entries
                return self._fenced_response(request)
            if request.epoch > self._epoch:
                self._accept_leader_locked(request)
            elif request.leader_id:
                if self._is_leader \
                        and request.leader_id != self.node_id:
                    # dueling same-epoch promotions: deterministic
                    # winner, no split-brain — higher node id leads,
                    # the other demotes and follows
                    if request.leader_id > self.node_id:
                        self._accept_leader_locked(request)
                    else:
                        return self._fenced_response(request)
                elif self._leader_id is None:
                    self._accept_leader_locked(request)
                elif self._leader_id != request.leader_id:
                    # two same-epoch leaders feeding one follower is
                    # operator error; acking both would silently
                    # diverge them
                    context.abort(
                        grpc.StatusCode.FAILED_PRECONDITION,
                        f"replica already follows "
                        f"{self._leader_id!r}, refusing entries from "
                        f"{request.leader_id!r}")
            self._last_leader_contact = time.monotonic()
            applied = self.applied_seq
            for e in request.entries:
                if e.seq and e.seq != applied + 1:
                    break  # out of order: answer with where we are
                # apply FIRST, log second: a failed apply must not
                # advance applied_seq (= op-log tail), or the leader
                # would skip the op forever and the replica silently
                # diverges. If apply succeeds but the op-log append
                # fails, re-applying on retry WOULD duplicate the op —
                # mark the replica broken (operator re-bootstraps it)
                # rather than diverge quietly either way.
                try:
                    _apply(self.local, e)
                except ReplicaDivergence as exc:
                    # the local store no longer matches the op-log:
                    # latch broken so EVERY further Replicate is
                    # refused with the divergence error (operator
                    # re-bootstraps) — a bare abort would let the
                    # leader retry into the same mismatch forever
                    self._broken = exc
                    log.error("replica %s DIVERGED at seq %d: %s",
                              self.node_id, e.seq, exc)
                    self._journal_event(
                        "replica_fenced",
                        f"replica {self.node_id} halted on divergence "
                        f"at seq {e.seq}: {exc}",
                        seq=int(e.seq))
                    context.abort(grpc.StatusCode.INTERNAL, str(exc))
                except Exception as exc:  # noqa: BLE001
                    log.error("replica %s: apply failed at seq %d: %s",
                              self.node_id, e.seq, exc)
                    context.abort(grpc.StatusCode.INTERNAL,
                                  f"apply failed at seq {e.seq}: {exc}")
                try:
                    applied = self.local.append(OPLOG_ID,
                                                _encode_entry(e))
                except Exception as exc:  # noqa: BLE001
                    self._broken = exc
                    log.error(
                        "replica %s BROKEN: op %d applied but not "
                        "logged: %s", self.node_id, e.seq, exc)
                    context.abort(grpc.StatusCode.INTERNAL,
                                  f"op-log append failed: {exc}")
                self._ops_since_trim += 1
            if self._ops_since_trim >= 512:
                # the follower's op-log only backs _reconcile (last
                # entry) and applied_seq (the tail): reclaim the rest
                self._ops_since_trim = 0
                if applied > 1:
                    self.local.trim(OPLOG_ID, applied - 1)
            return pb.ReplicateResponse(applied_seq=applied,
                                        epoch=self._epoch)

    def ReplicaInfo(self, request, context):
        with self._lock:
            # when leading, the hint is the CLIENT-facing address the
            # promotion recorded (where the SQL server over this store
            # serves), falling back to the replica listen addr
            return pb.ReplicaInfoResponse(
                applied_seq=self.applied_seq, is_leader=self._is_leader,
                node_id=self.node_id, epoch=self._epoch,
                leader_hint=(self._leader_hint or self.advertise_addr
                             or self.listen_addr
                             if self._is_leader
                             else self._leader_hint or ""))

    def ClusterStats(self, request, context):
        """Federation face of a BARE follower process: no
        stats holder lives here, so the report carries the load axes a
        follower has — role, op-log position, rss — keeping the node
        visible in the merged `admin cluster-stats` table instead of
        reading as unreachable."""
        import json as _json
        import time as _time

        from hstream_tpu_torch.stats.cluster import rss_bytes

        with self._lock:
            applied, is_leader = self.applied_seq, self._is_leader
            epoch = self._epoch
        role = "leader" if is_leader else "follower"
        report = {"node": self.node_id, "addr": self.listen_addr,
                  "role": role, "ts_ms": int(_time.time() * 1000),
                  "rss_bytes": rss_bytes(), "running_queries": 0,
                  "append_inflight": 0, "applied_seq": applied,
                  "epoch": epoch, "streams": {}, "queries": {}}
        return pb.ClusterStatsResponse(reports=[pb.NodeStatsReport(
            node=self.node_id, role=role, ts_ms=report["ts_ms"],
            rss_bytes=report["rss_bytes"],
            report=_json.dumps(report))])

    # ---- promotion ---------------------------------------------------------

    def Promote(self, request, context):
        """Raise this replica to leadership at ``request.epoch``. The
        caller (admin promote / lease auto-promotion) is responsible
        for picking the most-caught-up candidate; the epoch guard here
        makes a raced second promotion at the same or a lower epoch a
        clean refusal instead of a second leader."""
        if FAULTS.active:  # chaos: widen the promotion race window
            FAULTS.point("replica.promote.race")
        with self._lock:
            if self._broken is not None:
                context.abort(
                    grpc.StatusCode.INTERNAL,
                    f"replica diverged; refusing promotion: "
                    f"{self._broken}")
            if request.epoch <= self._epoch:
                return pb.PromoteResponse(
                    ok=False, epoch=self._epoch,
                    applied_seq=self.applied_seq, node_id=self.node_id)
            self._promote_locked(int(request.epoch),
                                 request.leader_addr,
                                 request.promoted_by or "operator")
            return pb.PromoteResponse(
                ok=True, epoch=self._epoch,
                applied_seq=self.applied_seq, node_id=self.node_id)

    def _promote_locked(self, epoch: int, leader_addr: str,
                        promoted_by: str) -> None:
        # monotonicity is the CALLER's guard (Promote refuses
        # epoch <= self._epoch before getting here; the lease loop
        # checks the same), so the assignment is bare by design
        self._epoch = epoch  # analyze: ok cas-epoch-nonmonotone
        _store_epoch(self.local, epoch)
        # promotion meta below is waived single-writer: own store,
        # under _lock, behind the caller's epoch guard
        self._is_leader = True
        self.local.meta_put(META_IS_LEADER, b"1")  # analyze: ok cas-blind-meta-write
        self._leader_id = self.node_id
        self.local.meta_put(META_LEADER_ID, self.node_id.encode())  # analyze: ok cas-blind-meta-write
        hint = (leader_addr or self.advertise_addr
                or self.listen_addr or "")
        self._leader_hint = hint or None
        if hint:
            self.local.meta_put(META_LEADER_HINT, hint.encode())  # analyze: ok cas-blind-meta-write
        # a ReplicatedStore later opened over this store must keep this
        # identity, so followers see one continuous leader
        self.local.meta_put("replica/node_id", self.node_id.encode())  # analyze: ok cas-blind-meta-write
        log.warning("replica %s PROMOTED to leader at epoch %d "
                    "(by %s; hint %r)", self.node_id, epoch,
                    promoted_by, hint)
        self._journal_event(
            "replica_promoted",
            f"replica {self.node_id} promoted to leader at epoch "
            f"{epoch} (by {promoted_by})",
            epoch=epoch, promoted_by=promoted_by,
            applied_seq=self.applied_seq)

    # ---- lease-timeout auto-promotion (flag-gated) -------------------------

    def _lease_loop(self) -> None:
        """Flag-gated self-promotion: when the accepted leader goes
        silent past the lease, promote — unless a reachable peer is
        more caught up (it will promote instead; highest
        (epoch, applied_seq, node_id) wins, the same rule the admin
        uses)."""
        lease = float(self.lease_timeout_s or 0)
        step = max(min(lease / 4.0, 1.0), 0.05)
        while not self._stop_ev.wait(step):
            with self._lock:
                if self._is_leader or self._leader_id is None:
                    continue  # nothing to take over yet
                silent = time.monotonic() - self._last_leader_contact
                if silent < lease:
                    continue
                my_epoch, my_seq = self._epoch, self.applied_seq
            # peer probes get a real RPC deadline, NOT the poll step
            # (which bottoms out at 50ms): a healthy more-caught-up
            # peer mistaken for unreachable under momentary jitter
            # would let a LESS caught-up replica seal the group and
            # strand that peer's quorum-acked entries
            best = best_replica(self.peers, timeout=max(step, 1.0))
            if best is not None and best[1] > (my_epoch, my_seq,
                                               self.node_id):
                continue  # a better-placed peer promotes instead
            new_epoch = max(my_epoch,
                            best[1][0] if best else my_epoch) + 1
            promoted = False
            with self._lock:
                if self._is_leader or self._epoch >= new_epoch:
                    continue  # raced: someone already moved the epoch
                if (time.monotonic() - self._last_leader_contact
                        < lease):
                    continue  # the leader came back mid-deliberation
                hint = self.advertise_addr or self.listen_addr
                self._promote_locked(new_epoch, hint, "lease-timeout")
                promoted = True
            if promoted:
                # outside the lock (RPC work): seal the peers at the
                # new epoch so none of them acks the silent leader if
                # it resurfaces mid-takeover
                seal_replicas(self.peers, epoch=new_epoch,
                              leader_id=self.node_id,
                              leader_hint=hint or "",
                              timeout=max(step, 1.0))


def serve_follower(local: LogStore, listen: str, *,
                   node_id: str = "follower",
                   advertise_addr: str = "",
                   lease_timeout_s: float | None = None,
                   peers: Sequence[str] = ()):
    """Start a follower replica service; returns (grpc server, svc).
    ``lease_timeout_s`` arms the flag-gated auto-promotion path;
    ``peers`` are the OTHER replicas consulted before self-promoting
    (most-caught-up wins); ``advertise_addr`` is the client-facing SQL
    address served as the leader hint if this replica promotes."""
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=4),
        options=[("grpc.max_receive_message_length", _REPLICA_MSG_BYTES)])
    svc = FollowerService(local, node_id=node_id, listen_addr=listen,
                          advertise_addr=advertise_addr,
                          lease_timeout_s=lease_timeout_s, peers=peers)
    add_store_replica_to_server(svc, server)
    server.add_insecure_port(listen)
    server.start()
    log.info("store replica follower %s listening on %s", node_id, listen)
    return server, svc


def follower_main(argv=None) -> None:
    """Run a follower store replica node:
    ``python -m hstream_tpu_torch.store.replica --store DIR --listen ADDR``"""
    import argparse
    import signal
    import threading as _threading

    from hstream_tpu_torch.store import open_store

    ap = argparse.ArgumentParser("hstream-tpu-store-replica")
    ap.add_argument("--store", required=True,
                    help="mem:// or a directory for the local store")
    ap.add_argument("--listen", required=True, metavar="HOST:PORT")
    ap.add_argument("--node-id", default="follower")
    ap.add_argument("--auto-promote-lease-ms", type=int, default=None,
                    help="OPT-IN auto-promotion: if the accepted "
                         "leader goes silent for this long, promote "
                         "self to leader (after checking --peers for "
                         "a more caught-up replica); off by default — "
                         "the safe default is operator-driven "
                         "`admin promote`")
    ap.add_argument("--peers", default="", metavar="ADDR,ADDR",
                    help="other replica addresses consulted before "
                         "auto-promotion (most-caught-up wins)")
    ap.add_argument("--advertise-addr", default="", metavar="ADDR",
                    help="client-facing SQL address served as the "
                         "leader hint if this replica auto-promotes "
                         "(where the operator boots the server over "
                         "the promoted store); defaults to --listen, "
                         "which serves StoreReplica only")
    args = ap.parse_args(argv)

    local = open_store(args.store)
    lease = (args.auto_promote_lease_ms / 1000.0
             if args.auto_promote_lease_ms else None)
    server, svc = serve_follower(
        local, args.listen, node_id=args.node_id,
        advertise_addr=args.advertise_addr,
        lease_timeout_s=lease,
        peers=[p.strip() for p in args.peers.split(",") if p.strip()])
    done = _threading.Event()

    def on_signal(signum, frame):
        done.set()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    done.wait()
    server.stop(grace=1)
    svc.close()
    local.close()


if __name__ == "__main__":
    follower_main()
