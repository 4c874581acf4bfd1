"""The node-action model: real protocol code under a virtual clock.

A :class:`Model` is N :class:`Node` harnesses around ONE shared
in-memory CAS config store (the real :class:`VersionedConfigStore`
over a dict meta-KV — the same code path a mem:// or native store
serves in production) plus a shared persistence table, mirroring the
shared-store placer deployment ``tests/test_placer.py`` exercises.

Each enabled action executes one REAL protocol function atomically:

``("hb", i)``      ``Placer._heartbeat_owned`` — heartbeat + self-fence
``("adopt", i)``   ``Placer._adopt_sweep`` — lease-lapse/offer adoption
``("pub", i)``     publish node ``i``'s cluster record (rebalance input)
``("reb", i)``     ``Placer._rebalance`` — offer one query away
``("crash", i)``   node dies: local tasks gone, records stay
``("reboot", i)``  node returns with a fresh (max+1) boot epoch and
                   runs the ``resume_persisted`` adoption sweep
                   (``scheduler.owner_live`` gate + ``try_adopt``)
``("pause", i)``   node stops ticking but its tasks keep running —
                   the zombie-owner window crash can never produce
``("resume", i)``  paused node ticks again
``("skew", i)``    node ``i``'s clock jumps ahead by its configured
                   skew (one-way, budgeted)
``("advance",)``   virtual time advances one quantum for everyone

Budgets (crashes, pauses, reboots, skews, advances) bound the state
space; the scenario registry at the bottom defines the concrete
2-node / 3-node kill, pause, skew, mixed-armed, rebalance and
created-orphan models the CLI and CI run.
"""

from __future__ import annotations

import contextlib
import json
import logging
from dataclasses import dataclass

from hstream_tpu_torch.placer import core as placer_core
from hstream_tpu_torch.placer import score as placer_score
from hstream_tpu_torch.placer.core import Placer
from hstream_tpu_torch.server import scheduler
from hstream_tpu_torch.server.persistence import QueryInfo, TaskStatus
from hstream_tpu_torch.store.versioned import VersionMismatch, VersionedConfigStore

SCHED_PREFIX = "scheduler/query/"
NODE_PREFIX = "cluster/nodes/"

# virtual epoch base: far from zero so ``max(0, now - hb)`` clamps and
# missing-stamp defaults behave exactly as on a wall clock
BASE_MS = 1_000_000_000


@contextlib.contextmanager
def quiet_protocol_logs():
    """The protocol functions journal adoptions/fences via logging;
    under exploration that is millions of lines. Restores the prior
    level on exit — the checker runs inside the test process and must
    not mute the tree's loggers for later tests."""
    root = logging.getLogger("hstream_tpu_torch")
    before = root.level
    root.setLevel(logging.CRITICAL)
    try:
        yield
    finally:
        root.setLevel(before)


class MetaKV:
    """Dict-backed meta-KV with the CAS primitive VersionedConfigStore
    needs — the in-memory stand-in for the store's meta WAL."""

    def __init__(self):
        self.data: dict[str, bytes] = {}

    def meta_get(self, key: str) -> bytes | None:
        return self.data.get(key)

    def meta_put(self, key: str, value: bytes) -> None:
        self.data[key] = bytes(value)

    def meta_cas(self, key: str, expected: bytes | None,
                 new: bytes) -> bool:
        if self.data.get(key) != expected:
            return False
        self.data[key] = bytes(new)
        return True

    def meta_delete(self, key: str) -> None:
        self.data.pop(key, None)

    def meta_list(self, prefix: str) -> list[str]:
        return sorted(k for k in self.data if k.startswith(prefix))


class VirtualClock:
    """Quantized virtual time with per-node skew. ``active`` names the
    node whose action is executing; every ``now_ms()`` the protocol
    code makes during that action reads that node's (skewed) clock."""

    def __init__(self):
        self.true_ms = 0
        self.skew: dict[int, int] = {}
        self.active: int | None = None

    def read(self) -> int:
        return BASE_MS + self.true_ms + self.skew.get(self.active, 0)


class _TimeShim:
    """Replaces a module's ``time`` import: wall-clock reads come from
    the virtual clock, everything else passes through."""

    def __init__(self, clock: VirtualClock, real):
        self._clock = clock
        self._real = real

    def time(self) -> float:
        return self._clock.read() / 1000.0

    def monotonic(self) -> float:
        return self._clock.read() / 1000.0

    def sleep(self, _s) -> None:  # pragma: no cover — never awaited
        pass

    def __getattr__(self, name):
        return getattr(self._real, name)


class ModelTask:
    """Stand-in for a running query task; records how it was stopped
    (crash-fence vs detach-move) for invariant checks."""

    packed = False

    def __init__(self, query_id: str):
        self.query_id = query_id
        self.stopped: str | None = None

    def stop(self, crash: bool = False, detach: bool = False) -> None:
        self.stopped = "crash" if crash else ("detach" if detach
                                              else "stop")


class ModelPersistence:
    """Shared query table (the placer deployment shares one store, so
    every node reads the same persistence — see tests/test_placer.py)."""

    def __init__(self):
        self._queries: dict[str, QueryInfo] = {}

    def add(self, info: QueryInfo) -> None:
        self._queries[info.query_id] = info

    def get_queries(self) -> list[QueryInfo]:
        return [self._queries[k] for k in sorted(self._queries)]

    def get_query(self, query_id: str) -> QueryInfo:
        return self._queries[query_id]

    def set_query_status(self, query_id: str, status: int) -> None:
        self._queries[query_id].status = status

    def statuses(self) -> tuple[tuple[str, int], ...]:
        return tuple((k, self._queries[k].status)
                     for k in sorted(self._queries))


class ModelCtx:
    """The slice of ServerContext the protocol functions read."""

    def __init__(self):
        self.flow = None
        self.events = None
        self.supervisor = None
        self.stats = None
        self.pack_pool = None


class _ModelStore:
    def __init__(self):
        self.fenced_by = None


@dataclass
class NodeSpec:
    armed: bool = True
    skew_ms: int = 0


@dataclass
class QuerySpec:
    qid: str
    owner: int | None = None       # node index that owns + runs it
    status: int = TaskStatus.RUNNING
    offered_to: int | None = None  # initial record is an offer
    src: int = 0                   # offering node for offered records


@dataclass
class Scenario:
    """One bounded model. ``lease_ms`` is the CONFIGURED lease; the
    invariants compute the effective lease max(lease, 3*interval)
    themselves, so a mutant that drops the placer's clamp diverges
    from the spec and is caught."""

    name: str
    description: str
    nodes: tuple = (NodeSpec(), NodeSpec())
    queries: tuple = (QuerySpec("q1", owner=0),)
    interval_ms: int = 1000
    lease_ms: int = 3000
    quantum_ms: int = 2000
    advances: int = 4
    crashes: tuple = ()   # per-node crash budget
    reboots: tuple = ()   # per-node reboot budget
    pauses: tuple = ()    # per-node pause budget
    skews: tuple = ()     # per-node skew-jump budget
    rebalance: bool = False
    depth: int = 10
    convergence: bool = True

    def budget(self, values: tuple, default: int = 0) -> list[int]:
        return [values[i] if i < len(values) else default
                for i in range(len(self.nodes))]

    @property
    def effective_lease_ms(self) -> int:
        return max(int(self.lease_ms), 3 * int(self.interval_ms))

    @property
    def max_skew_spread_ms(self) -> int:
        return max((s.skew_ms for s in self.nodes), default=0)


class Node:
    def __init__(self, model: "Model", idx: int, spec: NodeSpec):
        self.model = model
        self.idx = idx
        self.spec = spec
        self.alive = True
        self.paused = False
        ctx = ModelCtx()
        ctx.server_id = idx + 1
        ctx.host = "model"
        ctx.port = 7000 + idx
        ctx.boot_epoch = idx + 1
        ctx.config = model.config
        ctx.persistence = model.persistence
        ctx.running_queries = {}
        ctx.store = _ModelStore()
        placer = Placer(
            ctx,
            interval_ms=model.scenario.interval_ms if spec.armed else None,
            lease_ms=model.scenario.lease_ms)
        placer.resume_fn = self._resume
        ctx.placer = placer
        ctx.heartbeat_lease_ms = placer.lease_ms
        self.ctx = ctx
        self.name = scheduler.node_name(ctx)

    @property
    def armed(self) -> bool:
        return self.ctx.placer.armed

    @property
    def running(self) -> dict:
        return self.ctx.running_queries

    def _resume(self, info) -> None:
        self.ctx.running_queries[info.query_id] = ModelTask(info.query_id)


class Model:
    """Mutable model state + the action interface the explorer drives.
    Exploration mutates in place; ``snapshot``/``restore`` back out."""

    def __init__(self, scenario: Scenario):
        self.scenario = scenario
        self.kv = MetaKV()
        self.config = VersionedConfigStore(self.kv)
        self.clock = VirtualClock()
        self.persistence = ModelPersistence()
        self.nodes = [Node(self, i, s) for i, s in enumerate(scenario.nodes)]
        self.name_to_idx = {n.name: n.idx for n in self.nodes}
        self.crashes = scenario.budget(scenario.crashes)
        self.reboots = scenario.budget(scenario.reboots)
        self.pauses = scenario.budget(scenario.pauses)
        self.skews = scenario.budget(scenario.skews)
        self.advances_left = scenario.advances
        # qid -> (writer idx, true ms of the record's last write):
        # ground truth for the seizure invariant, independent of the
        # (possibly skewed) hb_ms the record itself carries
        self.truth: dict[str, tuple[int, int]] = {}
        self._build()

    # ---- construction ------------------------------------------------------

    def _build(self) -> None:
        with self.engaged():
            for spec in self.scenario.queries:
                self.persistence.add(QueryInfo(
                    query_id=spec.qid, sql="model", created_time_ms=0,
                    status=spec.status))
                if spec.offered_to is not None:
                    src = self.nodes[spec.src]
                    target = self.nodes[spec.offered_to]
                    with self.acting(src):
                        offer = json.dumps(
                            {"node": target.name, "epoch": 0,
                             "hb_ms": self.clock.read(),
                             "state": "offered",
                             "src": src.name}).encode()
                        self.config.put(SCHED_PREFIX + spec.qid, offer)
                    self.truth[spec.qid] = (src.idx, self.clock.true_ms)
                elif spec.owner is not None:
                    owner = self.nodes[spec.owner]
                    with self.acting(owner):
                        scheduler.record_assignment(owner.ctx, spec.qid)
                    self.truth[spec.qid] = (owner.idx, self.clock.true_ms)
                    if spec.status == TaskStatus.RUNNING:
                        owner.running[spec.qid] = ModelTask(spec.qid)

    # ---- clock plumbing ----------------------------------------------------

    @contextlib.contextmanager
    def engaged(self):
        """Patch the wall clock out of every module the protocol
        reads time through; restore on exit."""
        import time as _time

        saved_now = scheduler.now_ms
        saved_core = placer_core.time
        saved_score = placer_score.time
        shim = _TimeShim(self.clock, _time)
        scheduler.now_ms = self.clock.read
        placer_core.time = shim
        placer_score.time = shim
        try:
            yield self
        finally:
            scheduler.now_ms = saved_now
            placer_core.time = saved_core
            placer_score.time = saved_score

    @contextlib.contextmanager
    def acting(self, node: Node):
        prev = self.clock.active
        self.clock.active = node.idx
        try:
            yield node
        finally:
            self.clock.active = prev

    # ---- actions -----------------------------------------------------------

    def enabled_actions(self) -> list[tuple]:
        acts: list[tuple] = []
        sc = self.scenario
        for i, n in enumerate(self.nodes):
            if n.alive and not n.paused and n.armed:
                acts.append(("hb", i))
                acts.append(("adopt", i))
                if sc.rebalance:
                    acts.append(("pub", i))
                    acts.append(("reb", i))
            if n.alive and self.crashes[i] > 0:
                acts.append(("crash", i))
            if not n.alive and self.reboots[i] > 0:
                acts.append(("reboot", i))
            if n.alive and not n.paused and self.pauses[i] > 0:
                acts.append(("pause", i))
            if n.alive and n.paused:
                acts.append(("resume", i))
            if self.skews[i] > 0 and n.spec.skew_ms:
                acts.append(("skew", i))
        if self.advances_left > 0:
            acts.append(("advance",))
        return acts

    def execute(self, action: tuple) -> None:
        """Run one action against the live protocol code. The caller
        (explorer / invariants) diffs records around this."""
        kind = action[0]
        if kind == "advance":
            self.clock.true_ms += self.scenario.quantum_ms
            self.advances_left -= 1
            return
        i = action[1]
        n = self.nodes[i]
        if kind == "hb":
            with self.acting(n):
                n.ctx.placer._heartbeat_owned()
        elif kind == "adopt":
            with self.acting(n):
                n.ctx.placer._adopt_sweep()
        elif kind == "pub":
            with self.acting(n):
                self._publish(n)
        elif kind == "reb":
            with self.acting(n):
                n.ctx.placer._rebalance()
        elif kind == "crash":
            self.crashes[i] -= 1
            n.alive = False
            n.paused = False
            n.running.clear()
        elif kind == "reboot":
            self.reboots[i] -= 1
            n.alive = True
            n.ctx.boot_epoch = max(m.ctx.boot_epoch
                                   for m in self.nodes) + 1
            with self.acting(n):
                self._boot_adopt(n)
        elif kind == "pause":
            self.pauses[i] -= 1
            n.paused = True
        elif kind == "resume":
            n.paused = False
        elif kind == "skew":
            self.skews[i] = 0
            self.clock.skew[i] = n.spec.skew_ms
        else:  # pragma: no cover — explorer only emits the above
            raise ValueError(f"unknown action {action!r}")

    def _publish(self, n: Node) -> None:
        """Minimal cluster/nodes record: the fields rank_nodes and
        skip_reason read (the full node_record_fields shape needs the
        stats plane; ranking only consumes these axes)."""
        rec = {"node": n.name, "hb_ms": self.clock.read(),
               "running_queries": len(n.running),
               "shed_level": 0, "fenced": False, "health": {}}
        key = NODE_PREFIX + n.name
        value = json.dumps(rec).encode()
        for _ in range(4):
            cur = self.config.get(key)
            try:
                self.config.put(key, value, base_version=None
                                if cur is None else cur[0])
                return
            except VersionMismatch:  # pragma: no cover — atomic model
                continue

    def _boot_adopt(self, n: Node) -> None:
        """Mirror of handlers.resume_persisted's adoption sweep: the
        armed owner_live gate, then the real try_adopt CAS claim."""
        ctx = n.ctx
        for info in self.persistence.get_queries():
            if info.status not in (TaskStatus.RUNNING, TaskStatus.CREATED):
                continue
            if info.query_id in ctx.running_queries:
                continue
            if not scheduler.adoption_allowed(ctx, info.query_id):
                continue  # pragma: no cover — model flow is None
            if ctx.placer.armed:
                rec = scheduler.assignment(ctx, info.query_id)
                if (rec is not None
                        and rec.get("node") != scheduler.node_name(ctx)
                        and scheduler.owner_live(
                            rec, ctx.heartbeat_lease_ms)):
                    continue
            if not scheduler.try_adopt(ctx, info.query_id):
                continue
            n._resume(info)
            self.persistence.set_query_status(info.query_id,
                                              TaskStatus.RUNNING)

    # ---- record access -----------------------------------------------------

    def sched_records(self) -> dict[str, tuple[bytes, dict]]:
        """qid -> (raw value, parsed record) for every live
        scheduler/query key."""
        out: dict[str, tuple[bytes, dict]] = {}
        for key in self.kv.meta_list(self.config.PREFIX + SCHED_PREFIX):
            short = key[len(self.config.PREFIX):]
            cur = self.config.get(short)
            if cur is None:
                continue
            try:
                rec = json.loads(cur[1])
            except ValueError:
                rec = None
            out[short[len(SCHED_PREFIX):]] = (cur[1], rec)
        return out

    def update_truth(self, action: tuple,
                     pre: dict[str, tuple[bytes, dict]],
                     post: dict[str, tuple[bytes, dict]]) -> None:
        """After a node action that rewrote a record, the acting node
        is its writer at the current true time."""
        if action[0] in ("advance", "crash", "pause", "resume", "skew"):
            return
        actor = action[1]
        for qid, (raw, _rec) in post.items():
            if qid not in pre or pre[qid][0] != raw:
                self.truth[qid] = (actor, self.clock.true_ms)

    # ---- snapshot / restore ------------------------------------------------

    def snapshot(self) -> tuple:
        return (
            dict(self.kv.data),
            self.clock.true_ms,
            dict(self.clock.skew),
            self.advances_left,
            tuple(self.crashes), tuple(self.reboots),
            tuple(self.pauses), tuple(self.skews),
            tuple((n.alive, n.paused, n.ctx.boot_epoch,
                   tuple(sorted(n.running))) for n in self.nodes),
            self.persistence.statuses(),
            dict(self.truth),
        )

    def restore(self, snap: tuple) -> None:
        (data, true_ms, skew, advances, crashes, reboots, pauses,
         skews, node_states, statuses, truth) = snap
        self.kv.data = dict(data)
        self.clock.true_ms = true_ms
        self.clock.skew = dict(skew)
        self.advances_left = advances
        self.crashes = list(crashes)
        self.reboots = list(reboots)
        self.pauses = list(pauses)
        self.skews = list(skews)
        for n, (alive, paused, epoch, running) in zip(self.nodes,
                                                      node_states):
            n.alive = alive
            n.paused = paused
            n.ctx.boot_epoch = epoch
            n.ctx.running_queries.clear()
            for qid in running:
                n.ctx.running_queries[qid] = ModelTask(qid)
        for qid, status in statuses:
            self.persistence.set_query_status(qid, status)
        self.truth = dict(truth)

    # ---- canonical state key -----------------------------------------------

    def state_key(self) -> tuple:
        """Behavior-equivalence fingerprint: epochs rank-canonical,
        every timestamp an offset from virtual now (the protocol only
        reads epoch ORDER and stamp AGES), budgets included so a state
        with fewer crashes left is not conflated with a fresh one."""
        now = self.clock.true_ms
        epochs = {n.ctx.boot_epoch for n in self.nodes}
        records = []
        for key in self.kv.meta_list(self.config.PREFIX):
            short = key[len(self.config.PREFIX):]
            cur = self.config.get(short)
            if cur is None:
                records.append((short, None))
                continue
            try:
                rec = json.loads(cur[1])
            except ValueError:
                records.append((short, ("raw", cur[1])))
                continue
            if "epoch" in rec:
                epochs.add(int(rec.get("epoch", 0)))
            records.append((short, rec))
        rank = {e: i for i, e in enumerate(sorted(epochs))}
        canon = []
        for short, rec in records:
            if rec is None or not isinstance(rec, dict):
                canon.append((short, rec))
                continue
            canon.append((short, (
                self.name_to_idx.get(rec.get("node"), rec.get("node")),
                rank.get(int(rec.get("epoch", 0)))
                if "epoch" in rec else None,
                rec.get("state"),
                (int(rec["hb_ms"]) - BASE_MS - now)
                if "hb_ms" in rec else None,
                self.name_to_idx.get(rec.get("src"), rec.get("src")),
                rec.get("running_queries"),
            )))
        return (
            tuple(canon),
            tuple((n.alive, n.paused, rank[n.ctx.boot_epoch],
                   tuple(sorted(n.running))) for n in self.nodes),
            tuple(self.crashes), tuple(self.reboots),
            tuple(self.pauses), tuple(self.skews),
            self.advances_left,
            tuple(sorted(self.clock.skew.items())),
            self.persistence.statuses(),
            tuple(sorted((q, w, t - now)
                         for q, (w, t) in self.truth.items())),
        )

    # ---- independence (sleep sets) -----------------------------------------

    def independent(self, a: tuple, b: tuple) -> bool:
        """Conservative commutation test for sleep-set pruning. Only
        pairs whose record/clock/node footprints are provably disjoint
        commute; everything else is treated as dependent."""
        if a[0] == "advance" or b[0] == "advance":
            return False  # every stamp-reading action races the clock
        if len(a) < 2 or len(b) < 2 or a[1] == b[1]:
            return False  # same node: trivially dependent
        na, nb = self.nodes[a[1]], self.nodes[b[1]]
        # adopt/reb/reboot read (and may write) any query record;
        # crash/skew change inputs adopt reads (liveness, stamps)
        wide = ("adopt", "reb", "reboot", "crash", "skew")
        if a[0] in wide or b[0] in wide:
            return False
        # hb touches the acting node's own running-set records; pub
        # touches the acting node's own cluster record
        if a[0] in ("hb", "pub") and b[0] in ("hb", "pub"):
            if a[0] == "hb" and b[0] == "hb":
                return not (set(na.running) & set(nb.running))
            return True  # hb vs pub / pub vs pub: disjoint key spaces
        # pause/resume only flip the acting node's flags
        if a[0] in ("pause", "resume") or b[0] in ("pause", "resume"):
            return True
        return False

    # ---- convergence oracle ------------------------------------------------

    def stabilize(self) -> None:
        """Deterministic quiescence drive: resume the paused, lapse
        every stale lease, let every armed survivor heartbeat and
        sweep for three rounds. After this, ownership must have
        converged (invariants.check_convergence asserts it)."""
        for n in self.nodes:
            n.paused = False
        if not any(n.alive and n.armed for n in self.nodes):
            return
        lease = self.scenario.effective_lease_ms
        for _ in range(3):
            self.clock.true_ms += lease + self.scenario.quantum_ms
            for n in self.nodes:
                if n.alive and n.armed:
                    with self.acting(n):
                        n.ctx.placer._heartbeat_owned()
            for n in self.nodes:
                if n.alive and n.armed:
                    with self.acting(n):
                        n.ctx.placer._adopt_sweep()
        for n in self.nodes:
            if n.alive and n.armed:
                with self.acting(n):
                    n.ctx.placer._heartbeat_owned()


# ---- scenario registry ------------------------------------------------------

_R = TaskStatus.RUNNING
_C = TaskStatus.CREATED


def _scenarios() -> dict[str, Scenario]:
    out = [
        Scenario(
            name="kill-2",
            description="2 armed nodes, 1 query each; each node may "
                        "crash once and reboot once",
            nodes=(NodeSpec(), NodeSpec()),
            queries=(QuerySpec("q1", owner=0), QuerySpec("q2", owner=1)),
            crashes=(1, 1), reboots=(1, 1), advances=4, depth=11),
        Scenario(
            name="pause-2",
            description="2 armed nodes; a paused owner keeps running "
                        "its task through a lapsed lease (the zombie "
                        "window) and must self-fence on resume",
            nodes=(NodeSpec(), NodeSpec()),
            queries=(QuerySpec("q1", owner=0), QuerySpec("q2", owner=1)),
            pauses=(1, 1), advances=4, depth=11),
        Scenario(
            name="skew-2",
            description="2 armed nodes with a one-way clock jump on "
                        "each; a skewed reader must never seize a "
                        "lease that is fresh in true time",
            nodes=(NodeSpec(skew_ms=1000), NodeSpec(skew_ms=1000)),
            queries=(QuerySpec("q1", owner=0),),
            crashes=(1, 0), reboots=(1, 0), skews=(1, 1),
            advances=4, depth=10),
        Scenario(
            name="kill-3",
            description="3 armed nodes, 2 queries; one crash + reboot "
                        "and one pause across the cluster",
            nodes=(NodeSpec(), NodeSpec(), NodeSpec()),
            queries=(QuerySpec("q1", owner=0), QuerySpec("q2", owner=1)),
            crashes=(1, 0, 0), reboots=(1, 0, 0), pauses=(0, 1, 0),
            advances=3, depth=9),
        Scenario(
            name="mixed-2",
            description="armed node beside a disarmed (legacy-record) "
                        "node: the live sweep must never apply the "
                        "epoch rule to a legacy record",
            nodes=(NodeSpec(armed=False), NodeSpec()),
            queries=(QuerySpec("q1", owner=0), QuerySpec("q2", owner=1)),
            advances=4, depth=10),
        Scenario(
            name="clamp-2",
            description="lease configured below 3x interval: the "
                        "placer's clamp must keep a one-quantum-stale "
                        "owner safe from seizure",
            nodes=(NodeSpec(), NodeSpec()),
            queries=(QuerySpec("q1", owner=0),),
            interval_ms=2000, lease_ms=2000, quantum_ms=2000,
            crashes=(1, 0), reboots=(0, 0), advances=5, depth=10),
        Scenario(
            name="rebalance-2",
            description="3 queries on one node, none on the other: "
                        "publish + rebalance offers must converge to "
                        "single ownership, never two live owners",
            nodes=(NodeSpec(), NodeSpec()),
            queries=(QuerySpec("q1", owner=0), QuerySpec("q2", owner=0),
                     QuerySpec("q3", owner=0)),
            rebalance=True, advances=2, depth=7),
        Scenario(
            name="created-2",
            description="a CREATED query whose offered record's "
                        "target crashes before claiming: survivors "
                        "must rescue it once the offer lapses",
            nodes=(NodeSpec(), NodeSpec()),
            queries=(QuerySpec("q1", owner=None, status=_C,
                               offered_to=1, src=0),
                     QuerySpec("q2", owner=0)),
            crashes=(0, 1), reboots=(0, 0), advances=4, depth=9),
    ]
    return {s.name: s for s in out}


SCENARIOS: dict[str, Scenario] = _scenarios()

# the bounded set CI runs (acceptance: 2-node and 3-node kill/pause/
# skew models, plus the discipline scenarios the mutants need)
DEFAULT_SCENARIOS = ("kill-2", "pause-2", "skew-2", "kill-3",
                     "mixed-2", "clamp-2", "rebalance-2", "created-2")
