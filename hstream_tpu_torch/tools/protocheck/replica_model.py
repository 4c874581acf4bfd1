"""Replica epoch/fence model: the real FollowerService under a model
operator.

Two live :class:`FollowerService` instances (the real class from
``store/replica.py``) run over minimal in-memory log stores. The model
operator plays every leader/promoter the protocol can see:

``("promote", i)``        promote follower ``i`` at ``max epoch + 1``
                          (what ``promote_best`` computes)
``("promote-dup", i)``    promote at the CURRENT max epoch — the
                          dueling-promotion race (legal only while
                          ``i``'s own epoch is behind)
``("promote-stale", i)``  promote at an epoch <= follower ``i``'s own:
                          must be a clean refusal
``("replicate", l, i)``   leader identity ``l`` sends one in-order
                          OP_META_PUT entry to follower ``i`` at the
                          leader's promotion epoch
``("seal", l, i)``        same, zero entries — a pure bind/fence probe

Invariants (the replicas' epoch discipline):

* ``r-epoch-monotone`` — a follower's epoch never decreases;
* ``r-fenced-lands`` — a fenced (or refused) request leaves the
  follower's store byte-identical: a fenced writer never lands;
* ``r-stale-accept`` — a request from an epoch below the follower's
  is always fenced/refused;
* ``r-promote-guard`` — ``Promote`` only returns ok for an epoch
  strictly above the follower's;
* ``r-duel`` (convergence) — after every leader contacts every
  follower, at most one follower leads at the max epoch.

Exploration: plain DFS with visited-state dedup (the space is small —
no clocks, no leases); same counterexample/replay contract as the
ownership model.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from hstream_tpu_torch.tools.protocheck.explore import Counterexample, ExploreResult
from hstream_tpu_torch.tools.protocheck.invariants import Violation
from hstream_tpu_torch.tools.protocheck.model import quiet_protocol_logs


class _Abort(Exception):
    def __init__(self, code, msg):
        super().__init__(f"{code}: {msg}")
        self.code = code


class _GrpcCtx:
    """Just enough grpc.ServicerContext for the follower methods."""

    def abort(self, code, msg):
        raise _Abort(code, msg)


class MiniLogStore:
    """The LogStore slice FollowerService + _apply touch, over plain
    dicts so snapshots are cheap copies."""

    def __init__(self):
        self.meta: dict[str, bytes] = {}
        self.logs: dict[int, list[bytes]] = {}

    # meta KV
    def meta_get(self, key):
        return self.meta.get(key)

    def meta_put(self, key, value):
        self.meta[key] = bytes(value)

    def meta_delete(self, key):
        self.meta.pop(key, None)

    # logs (lsn = count appended; trim never runs at model op counts)
    def log_exists(self, logid):
        return logid in self.logs

    def create_log(self, logid, attrs=None):
        self.logs.setdefault(logid, [])

    def remove_log(self, logid):
        self.logs.pop(logid, None)

    def tail_lsn(self, logid):
        return len(self.logs.get(logid, ()))

    def append(self, logid, payload):
        self.logs[logid].append(bytes(payload))
        return len(self.logs[logid])

    def trim(self, logid, upto):  # pragma: no cover — needs 512 ops
        raise NotImplementedError("model op budget keeps logs tiny")

    def snapshot(self):
        return (dict(self.meta),
                {k: list(v) for k, v in self.logs.items()})

    def restore(self, snap):
        meta, logs = snap
        self.meta = dict(meta)
        self.logs = {k: list(v) for k, v in logs.items()}

    def fingerprint(self):
        return (tuple(sorted(self.meta.items())),
                tuple((k, tuple(v))
                      for k, v in sorted(self.logs.items())))


@dataclass
class ReplicaScenario:
    name: str = "replica-2"
    description: str = ("2 followers; promotions (fresh, dueling, "
                        "stale) and in-order replication from every "
                        "promoted leader identity")
    followers: int = 2
    promotes: int = 3   # total successful-promotion budget
    ops: int = 2        # total replicated-entry budget
    depth: int = 7
    convergence: bool = True


class ReplicaModel:
    def __init__(self, scenario: ReplicaScenario):
        from hstream_tpu_torch.store.replica import FollowerService

        self.scenario = scenario
        self.stores = [MiniLogStore() for _ in range(scenario.followers)]
        self.followers = [
            FollowerService(s, node_id=f"r{i + 1}",
                            listen_addr=f"model:{9000 + i}")
            for i, s in enumerate(self.stores)]
        # leader identities: (node_id, epoch) of every successful
        # promotion; a demoted/stale identity keeps sending — that is
        # exactly the partitioned-leader case the fence exists for
        self.leaders: list[tuple[str, int]] = []
        self.promotes_left = scenario.promotes
        self.ops_left = scenario.ops
        self.seq = 0  # distinct meta payloads per replicated op

    # ---- actions -----------------------------------------------------------

    def _max_epoch(self) -> int:
        return max([f.epoch for f in self.followers]
                   + [e for _n, e in self.leaders] + [0])

    def enabled_actions(self) -> list[tuple]:
        acts: list[tuple] = []
        for i, f in enumerate(self.followers):
            if self.promotes_left > 0:
                acts.append(("promote", i))
                if f.epoch < self._max_epoch():
                    acts.append(("promote-dup", i))
            acts.append(("promote-stale", i))
        for li, (lid, epoch) in enumerate(self.leaders):
            for i in range(len(self.followers)):
                acts.append(("seal", li, i))
                if self.ops_left > 0:
                    acts.append(("replicate", li, i))
        return acts

    def execute(self, action: tuple) -> list[Violation]:
        from hstream_tpu_torch.proto import api_pb2 as pb

        kind = action[0]
        out: list[Violation] = []
        if kind.startswith("promote"):
            i = action[1]
            f = self.followers[i]
            pre_epoch = f.epoch
            pre_fp = self.stores[i].fingerprint()
            if kind == "promote":
                epoch = self._max_epoch() + 1
            elif kind == "promote-dup":
                epoch = self._max_epoch()
            else:
                epoch = pre_epoch
            req = pb.PromoteRequest(epoch=epoch,
                                    leader_addr=f"sql:{9100 + i}",
                                    promoted_by="protocheck")
            try:
                resp = f.Promote(req, _GrpcCtx())
                ok = bool(resp.ok)
            except _Abort:
                ok = False
            if ok:
                if epoch <= pre_epoch:
                    out.append(Violation(
                        "r-promote-guard",
                        f"Promote of {f.node_id} at epoch {epoch} "
                        f"succeeded although its epoch was already "
                        f"{pre_epoch}",
                        {"node": f.node_id, "epoch": epoch}))
                self.leaders.append((f.node_id, epoch))
                if kind != "promote-stale":
                    self.promotes_left -= 1
            elif epoch > pre_epoch:  # pragma: no cover — live refuses
                # only stale/dup epochs
                out.append(Violation(
                    "r-promote-guard",
                    f"Promote of {f.node_id} at fresh epoch {epoch} "
                    f"was refused (follower at {pre_epoch})",
                    {"node": f.node_id}))
            out += self._post_checks(i, pre_epoch, pre_fp,
                                     changed_ok=ok)
            return out

        _kind, li, i = action
        lid, epoch = self.leaders[li]
        f = self.followers[i]
        pre_epoch = f.epoch
        pre_fp = self.stores[i].fingerprint()
        req = pb.ReplicateRequest(epoch=epoch, leader_id=lid,
                                  leader_hint=f"sql:{lid}")
        if kind == "replicate":
            self.seq += 1
            req.entries.append(pb.LogEntry(
                op=pb.OP_META_PUT, seq=f.applied_seq + 1,
                meta_key="model/cell",
                meta_value=f"{lid}@{epoch}#{self.seq}".encode()))
        fenced = None
        try:
            resp = f.Replicate(req, _GrpcCtx())
            fenced = bool(resp.fenced)
        except _Abort:
            fenced = None  # refused outright; must not have landed
        if kind == "replicate" and fenced is False:
            self.ops_left -= 1
        if fenced is not False \
                and self.stores[i].fingerprint() != pre_fp:
            out.append(Violation(
                "r-fenced-lands",
                f"{kind} from {lid}@{epoch} to {f.node_id} was "
                f"{'fenced' if fenced else 'refused'} but changed "
                f"the follower's store — a fenced writer landed",
                {"node": f.node_id, "leader": lid, "epoch": epoch}))
        if epoch < pre_epoch and fenced is False:
            out.append(Violation(
                "r-stale-accept",
                f"{f.node_id} (epoch {pre_epoch}) accepted {kind} "
                f"from stale leader {lid}@{epoch}",
                {"node": f.node_id, "leader": lid, "epoch": epoch}))
        out += self._post_checks(i, pre_epoch, pre_fp,
                                 changed_ok=fenced is False)
        return out

    def _post_checks(self, i: int, pre_epoch: int, pre_fp,
                     changed_ok: bool) -> list[Violation]:
        out = []
        f = self.followers[i]
        if f.epoch < pre_epoch:
            out.append(Violation(
                "r-epoch-monotone",
                f"{f.node_id} epoch went BACKWARDS: {pre_epoch} -> "
                f"{f.epoch}",
                {"node": f.node_id, "pre": pre_epoch,
                 "post": f.epoch}))
        if not changed_ok and self.stores[i].fingerprint() != pre_fp \
                and f.epoch == pre_epoch:
            out.append(Violation(
                "r-fenced-lands",
                f"a refused request still changed {f.node_id}'s "
                f"store", {"node": f.node_id}))
        return out

    # ---- convergence -------------------------------------------------------

    def stabilize(self) -> list[Violation]:
        """Every leader identity contacts every follower twice (a
        seal round-trip resolves duels deterministically); then at
        most one follower may lead at the max epoch."""
        from hstream_tpu_torch.proto import api_pb2 as pb

        out: list[Violation] = []
        for _round in range(2):
            for lid, epoch in sorted(self.leaders):
                for i, f in enumerate(self.followers):
                    if f.node_id == lid and f.epoch == epoch \
                            and f.is_leader:
                        continue  # a leader does not follow itself
                    pre_epoch = f.epoch
                    pre_fp = self.stores[i].fingerprint()
                    req = pb.ReplicateRequest(epoch=epoch,
                                              leader_id=lid)
                    try:
                        resp = f.Replicate(req, _GrpcCtx())
                        fenced = bool(resp.fenced)
                    except _Abort:
                        fenced = None
                    if fenced is not False \
                            and self.stores[i].fingerprint() != pre_fp:
                        out.append(Violation(
                            "r-fenced-lands",
                            f"stabilization seal from {lid}@{epoch} "
                            f"was fenced but landed on {f.node_id}",
                            {"node": f.node_id}))
                    if f.epoch < pre_epoch:
                        out.append(Violation(
                            "r-epoch-monotone",
                            f"{f.node_id} epoch went backwards "
                            f"during stabilization",
                            {"node": f.node_id}))
        top = max((f.epoch for f in self.followers), default=0)
        chiefs = [f.node_id for f in self.followers
                  if f.is_leader and f.epoch == top]
        if len(chiefs) > 1:
            out.append(Violation(
                "r-duel",
                f"two leaders at epoch {top} after full contact: "
                f"{chiefs} — dueling promotions never resolved",
                {"epoch": top, "leaders": chiefs}))
        return out

    # ---- snapshot / state key ----------------------------------------------

    def snapshot(self) -> tuple:
        return (
            tuple(s.snapshot() for s in self.stores),
            tuple((f._epoch, f._leader_id, f._leader_hint,
                   f._is_leader, f._broken, f._ops_since_trim)
                  for f in self.followers),
            tuple(self.leaders), self.promotes_left, self.ops_left,
            self.seq)

    def restore(self, snap: tuple) -> None:
        stores, fstates, leaders, promotes, ops, seq = snap
        for s, ss in zip(self.stores, stores):
            s.restore(ss)
        for f, (ep, lid, hint, isl, broken, ops_t) in zip(
                self.followers, fstates):
            f._epoch = ep
            f._leader_id = lid
            f._leader_hint = hint
            f._is_leader = isl
            f._broken = broken
            f._ops_since_trim = ops_t
        self.leaders = list(leaders)
        self.promotes_left = promotes
        self.ops_left = ops
        self.seq = seq

    def state_key(self) -> tuple:
        return (
            tuple((f._epoch, f._leader_id, f._is_leader,
                   f.applied_seq, self.stores[i].fingerprint())
                  for i, f in enumerate(self.followers)),
            tuple(self.leaders), self.promotes_left, self.ops_left)


def explore_replica(scenario: ReplicaScenario | None = None, *,
                    mutant=None, max_depth: int | None = None
                    ) -> ExploreResult:
    """Bounded DFS with visited-state dedup over the replica model."""
    sc = scenario or ReplicaScenario()
    depth_bound = sc.depth if max_depth is None else max_depth
    res = ExploreResult(scenario=sc.name, depth=depth_bound)
    t0 = time.monotonic()
    import contextlib as _ctx
    patch = mutant.patch() if mutant is not None else _ctx.nullcontext()
    trace: list[tuple] = []
    # canonical state -> largest remaining depth it was explored with;
    # a revisit with no more budget left is fully covered (this also
    # absorbs no-op self-loops like refused stale promotions)
    visited: dict[tuple, int] = {}
    conv_checked: set[tuple] = set()

    class _Hit(Exception):
        def __init__(self, v, stabilized):
            self.v = v
            self.stabilized = stabilized

    with quiet_protocol_logs(), patch:
        model = ReplicaModel(sc)

        def conv_check(key):
            if not sc.convergence or key in conv_checked:
                return
            conv_checked.add(key)
            snap = model.snapshot()
            try:
                vs = model.stabilize()
            finally:
                model.restore(snap)
            if vs:
                raise _Hit(vs[0], True)

        def dfs(depth):
            rem = depth_bound - depth
            if rem <= 0:
                return
            key = model.state_key()
            if visited.get(key, -1) >= rem:
                res.pruned_visited += 1
                return
            visited[key] = rem
            for a in model.enabled_actions():
                snap = model.snapshot()
                trace.append(a)
                vs = model.execute(a)
                res.transitions += 1
                if vs:
                    raise _Hit(vs[0], False)
                conv_check(model.state_key())
                dfs(depth + 1)
                model.restore(snap)
                trace.pop()

        try:
            conv_check(model.state_key())
            dfs(0)
        except _Hit as h:
            res.counterexample = Counterexample(
                scenario=sc.name, rule=h.v.rule, message=h.v.message,
                trace=list(trace), stabilized=h.stabilized,
                details=h.v.details,
                mutant=mutant.name if mutant is not None else None)
    res.states = len(visited)
    res.elapsed_s = time.monotonic() - t0
    return res


def replay_replica(trace: list, *, mutant=None, stabilize: bool = False
                   ) -> tuple[list, list]:
    """Re-execute a replica counterexample schedule; returns the final
    step's violations and the per-step state keys."""
    import contextlib as _ctx
    patch = mutant.patch() if mutant is not None else _ctx.nullcontext()
    keys: list = []
    violations: list = []
    with quiet_protocol_logs(), patch:
        model = ReplicaModel(ReplicaScenario())
        keys.append(model.state_key())
        for a in trace:
            violations = model.execute(tuple(a))
            keys.append(model.state_key())
        if stabilize and not violations:
            violations = model.stabilize()
            keys.append(model.state_key())
    return violations, keys
