"""Co-compile query packing: N compatible queries, ONE dispatch.

Every windowed aggregate compiles to the same lattice program once its
shapes match — that is the pow2-padding trick that already makes cycle
widths share compiled programs. Packing pushes it one level up:
queries with the same *signature* (source stream, window shape, agg
kinds + params, key count, emission mode) run on ONE shared
``QueryExecutor`` whose group key is extended with a synthetic ``__q``
slot column. A member query's rows are tagged with its slot and its
key/agg columns are renamed to canonical positions (``__k0..``,
``__a0..``), so the shared lattice sees one homogeneous row shape —
the 2nd..Nth attached query changes only key VALUES, never a shape,
and compiles nothing (RetraceGuard-pinned in tests/test_packing.py).
Emitted rows demux on ``__q`` back to per-member names and sinks.

Incompatible plans refuse with a typed :class:`PackRefusal` that
EXPLAIN surfaces as a ``PACK:`` line, mirroring the mesh-exclusion
discipline (sql/codegen.mesh_exclusion_reason).

Scope: packing applies to freshly launched queries when the server
runs with ``--pack-queries``; a packed query that is resumed after a
restart comes back as a normal standalone task (its state snapshot
discipline is per-task), so packing never risks the recovery path.
"""

# A copy of hstream_tpu/placer/packing.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import threading
from dataclasses import dataclass

from hstream_tpu_torch.common.logger import get_logger
from hstream_tpu_torch.engine.expr import Col
from hstream_tpu_torch.engine.plan import (
    AggKind,
    AggregateNode,
    AggSpec,
    SourceNode,
)
from hstream_tpu_torch.engine.types import ColumnType, Schema
from hstream_tpu_torch.engine.window import (
    HoppingWindow,
    SessionWindow,
    TumblingWindow,
)

log = get_logger("placer.packing")


@dataclass(frozen=True)
class PackRefusal:
    """Why a plan cannot join a pack (machine-readable: EXPLAIN prints
    ``code``, admin output carries both)."""

    code: str
    detail: str

    def __str__(self) -> str:
        return f"{self.code}: {self.detail}"


def _select_of(plan):
    """The SelectPlan under a lowered statement, or None."""
    from hstream_tpu_torch.sql import plans

    if isinstance(plan, plans.SelectPlan):
        return plan
    if isinstance(plan, plans.CreateBySelectPlan):
        return plan.select
    return None


def pack_signature(plan):
    """The pack-compatibility signature of a lowered plan, or a
    :class:`PackRefusal`. Two plans with equal signatures share one
    compiled lattice; agg INPUT column names and key column names are
    deliberately absent — they canonicalize to positional columns."""
    sel = _select_of(plan)
    if sel is None:
        return PackRefusal("not-a-select",
                           "only stream SELECT queries pack")
    if sel.join is not None:
        return PackRefusal("join",
                           "join state is per-query (two-sided stores)")
    node = sel.node
    if not isinstance(node, AggregateNode):
        return PackRefusal("stateless",
                           "no windowed aggregate state to share")
    if not isinstance(node.child, SourceNode):
        return PackRefusal("filter",
                           "WHERE/projection stages are per-query")
    w = node.window
    if w is None:
        return PackRefusal("unwindowed",
                           "global group-by has no shared close cycle")
    if isinstance(w, TumblingWindow):
        wsig = ("tumbling", int(w.size_ms), int(w.grace_ms))
    elif isinstance(w, HoppingWindow):
        wsig = ("hopping", int(w.size_ms), int(w.advance_ms),
                int(w.grace_ms))
    elif isinstance(w, SessionWindow):
        return PackRefusal("session-window",
                           "session arenas merge per-key gap chains; "
                           "slots would couple unrelated sessions")
    else:
        return PackRefusal("window",
                           f"unpackable window {type(w).__name__}")
    if node.having is not None:
        return PackRefusal("having", "HAVING predicates are per-query")
    for g in node.group_keys:
        if not isinstance(g, Col):
            return PackRefusal("computed-key",
                               "computed group keys are per-query")
    if node.post_projections:
        # pure renames (SELECT k, COUNT(*) AS c) are member-local —
        # untag applies them; anything computed changes row VALUES
        # and would have to run inside the shared lattice
        keys = {g.name for g in node.group_keys}
        outs = {a.out_name for a in node.aggs}
        for _name, e in node.post_projections:
            if not isinstance(e, Col) or (e.name not in keys
                                          and e.name not in outs):
                return PackRefusal(
                    "projection",
                    "computed select items are per-query")
    aggsig = []
    for a in node.aggs:
        if a.input is not None and not isinstance(a.input, Col):
            return PackRefusal("computed-agg-input",
                               f"{a.kind.value} over an expression is "
                               "per-query")
        aggsig.append((a.kind.value, a.quantile, a.k))
    return (node.child.stream, wsig, bool(sel.emit_changes),
            tuple(aggsig), len(node.group_keys))


def signature_text(sig) -> str:
    """Human-readable one-liner for a signature (EXPLAIN/admin)."""
    stream, wsig, changes, aggs, n_keys = sig
    aggtxt = "+".join(a[0] for a in aggs)
    return (f"{stream} {wsig[0]}({'/'.join(str(x) for x in wsig[1:])}ms)"
            f" {aggtxt} keys={n_keys}"
            f" {'changes' if changes else 'final'}")


def _canonical_plan(sig):
    """Synthesize the shared SelectPlan for one signature: group keys
    ``[__q, __k0..]``, aggs over ``__a0..`` outputs ``__o0..``."""
    from hstream_tpu_torch.sql import plans

    stream, wsig, emit_changes, aggsig, n_keys = sig
    if wsig[0] == "tumbling":
        window = TumblingWindow(size_ms=wsig[1], grace_ms=wsig[2])
    else:
        window = HoppingWindow(size_ms=wsig[1], advance_ms=wsig[2],
                               grace_ms=wsig[3])
    keys = [Col("__q")] + [Col(f"__k{i}") for i in range(n_keys)]
    aggs = []
    inferred: dict[str, ColumnType] = {}
    for j, (kind, quantile, k) in enumerate(aggsig):
        akind = AggKind(kind)
        inp = None
        if akind is not AggKind.COUNT_ALL:
            inp = Col(f"__a{j}")
            inferred[f"__a{j}"] = ColumnType.FLOAT
        aggs.append(AggSpec(kind=akind, out_name=f"__o{j}", input=inp,
                            quantile=quantile, k=k))
    node = AggregateNode(child=SourceNode(stream=stream, schema=Schema(())),
                         group_keys=keys, window=window, aggs=aggs)
    return plans.SelectPlan(
        sql=f"<packed {signature_text(sig)}>", source=stream, node=node,
        schema_req=plans.SchemaRequirement(inferred=inferred),
        emit_changes=emit_changes)


class PackMember:
    """One query's seat in a pack group: its slot, the mapping between
    its column names and the canonical positions, its sink, and the
    LSN it attached at (earlier source rows belong to earlier state and
    are not fed for this member)."""

    def __init__(self, qid: str, slot: int, key_cols: list[str],
                 agg_inputs: list[str | None],
                 emits: list[tuple[str, str, int]],
                 sink, attach_lsn: int):
        self.qid = qid
        self.slot = slot
        self._slot_val = str(slot)
        self.key_cols = key_cols
        self.agg_inputs = agg_inputs
        # emitted-row layout: (field name, "key"|"agg", canonical idx)
        # — carries the member's SELECT-list renames
        self.emits = emits
        self.sink = sink
        self.attach_lsn = attach_lsn

    def tag(self, row: dict) -> dict:
        out = {"__q": self._slot_val}
        for i, kc in enumerate(self.key_cols):
            if kc in row:
                out[f"__k{i}"] = row[kc]
        for j, ac in enumerate(self.agg_inputs):
            if ac is not None and ac in row:
                out[f"__a{j}"] = row[ac]
        return out

    def untag(self, row: dict) -> dict:
        out = {}
        for name, kind, idx in self.emits:
            src = f"__k{idx}" if kind == "key" else f"__o{idx}"
            if kind == "key":
                v = row.get(src)
                if v is not None:
                    out[name] = v
            elif src in row:
                out[name] = row[src]
        for k, v in row.items():
            if k == "__q" or k.startswith(("__k", "__o", "__a")):
                continue
            out.setdefault(k, v)  # winStart/winEnd, change markers
        return out


class PackGroup:
    """One signature's shared executor + its attached members. Feeding
    is serialized under the group lock; one ``feed`` call is one
    ``executor.process`` — one dispatch chain for every member."""

    def __init__(self, ctx, sig, *, batch_capacity: int = 4096):
        self.ctx = ctx
        self.sig = sig
        self.plan = _canonical_plan(sig)
        self.batch_capacity = batch_capacity
        self.executor = None
        self.members: dict[str, PackMember] = {}
        self._next_slot = 0
        self._lock = threading.Lock()
        self._runner: _PackRunner | None = None
        self.batches = 0
        self.rows_in = 0

    @property
    def source_stream(self) -> str:
        return self.sig[0]

    def attach(self, qid: str, sel_plan, sink,
               attach_lsn: int) -> PackMember:
        node = sel_plan.node
        key_cols = [g.name for g in node.group_keys]
        out_names = [a.out_name for a in node.aggs]
        if node.post_projections:
            # pure renames (pack_signature already vetted them): emit
            # each projected item from its canonical position
            keyidx = {n: i for i, n in enumerate(key_cols)}
            aggidx = {n: j for j, n in enumerate(out_names)}
            emits = [(name, "key", keyidx[e.name])
                     if e.name in keyidx
                     else (name, "agg", aggidx[e.name])
                     for name, e in node.post_projections]
        else:
            emits = ([(n, "key", i) for i, n in enumerate(key_cols)]
                     + [(n, "agg", j) for j, n in enumerate(out_names)])
        with self._lock:
            member = PackMember(
                qid, self._next_slot, key_cols=key_cols,
                agg_inputs=[a.input.name if a.input is not None else None
                            for a in node.aggs],
                emits=emits, sink=sink, attach_lsn=attach_lsn)
            self._next_slot += 1
            self.members[qid] = member
        return member

    def detach(self, qid: str) -> bool:
        """Remove a member; True when the group is now empty (the pool
        tears it down)."""
        with self._lock:
            self.members.pop(qid, None)
            return not self.members

    def feed(self, rows: list[dict], ts_ms,
             lsn: int | None = None) -> None:
        """One source micro-batch for every member attached at or
        before `lsn`; builds the shared executor on first contact so
        schema inference sees real (tagged) rows. `ts_ms` is one
        timestamp per row (an int applies to the whole batch)."""
        ts_list = ([int(ts_ms)] * len(rows) if isinstance(ts_ms, int)
                   else list(ts_ms))
        with self._lock:
            members = [m for m in self.members.values()
                       if lsn is None or lsn > m.attach_lsn]
            if not members or not rows:
                return
            tagged = [m.tag(r) for m in members for r in rows]
            ts_tagged = [t for _ in members for t in ts_list]
            if self.executor is None:
                from hstream_tpu_torch.sql.codegen import make_executor

                self.executor = make_executor(
                    self.plan, sample_rows=tagged,
                    batch_capacity=self.batch_capacity)
            out = self.executor.process(tagged, ts_tagged)
            self.batches += 1
            self.rows_in += len(tagged)
            self._demux(out)

    def _demux(self, out_rows) -> None:
        if not out_rows:
            return
        per_slot: dict[str, list[dict]] = {}
        for r in out_rows:
            per_slot.setdefault(str(r.get("__q")), []).append(r)
        by_slot = {m._slot_val: m for m in self.members.values()}
        for slot, rows in per_slot.items():
            m = by_slot.get(slot)
            if m is None:
                continue  # member detached with windows still open
            try:
                m.sink([m.untag(r) for r in rows])
            except Exception:  # noqa: BLE001 — one member's sink
                log.exception("pack sink for %s failed", m.qid)

    def status(self) -> dict:
        with self._lock:
            return {
                "signature": signature_text(self.sig),
                "members": sorted(self.members),
                "slots": {qid: m.slot
                          for qid, m in self.members.items()},
                "batches": self.batches,
                "rows_in": self.rows_in,
                "compiled": self.executor is not None,
            }


class _PackRunner:
    """The group's single source reader: tail the source stream and
    feed every batch to the shared executor. One reader + one dispatch
    per micro-batch regardless of member count."""

    def __init__(self, ctx, group: PackGroup):
        self.ctx = ctx
        self.group = group
        self._stop_evt = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"pack-{group.source_stream}")

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop_evt.set()
        self._thread.join(timeout=5)

    def _run(self) -> None:
        from hstream_tpu_torch.common import columnar
        from hstream_tpu_torch.common import records as rec
        from hstream_tpu_torch.store.api import DataBatch

        ctx = self.ctx
        try:
            logid = ctx.streams.get_logid(self.group.source_stream)
            reader = ctx.store.new_reader()
            reader.set_timeout(100)
            reader.start_reading(logid, ctx.store.tail_lsn(logid) + 1)
        except Exception:  # noqa: BLE001 — a torn-down store at boot
            log.exception("pack runner for %s could not start",
                          self.group.source_stream)
            return
        while not self._stop_evt.is_set():
            try:
                items = reader.read(256)
            except Exception:  # noqa: BLE001 — store closing
                return
            if not items:
                continue
            for it in items:
                if not isinstance(it, DataBatch):
                    continue
                rows: list[dict] = []
                ts: list[int] = []
                for p in it.payloads:
                    try:
                        pr = rec.parse_record(p)
                    except Exception:  # noqa: BLE001 — foreign bytes
                        continue
                    t = (int(pr.header.publish_time_ms)
                         or int(it.append_time_ms))
                    crows = columnar.payload_rows(pr.payload)
                    if crows is not None:
                        rows.extend(crows)
                        ts.extend([t] * len(crows))
                        continue
                    row = rec.record_to_dict(pr)
                    if row is not None:
                        rows.append(row)
                        ts.append(t)
                if not rows:
                    continue
                try:
                    self.group.feed(rows, ts, lsn=it.lsn)
                except Exception:  # noqa: BLE001 — one poisoned batch
                    log.exception("pack feed on %s failed",
                                  self.group.source_stream)


class PackMemberTask:
    """The running_queries facade for a packed query: the handler
    surface (terminate, status introspection) without a thread of its
    own. `stop` detaches the member from its group."""

    packed = True
    error: BaseException | None = None
    started = True

    def __init__(self, pool: "PackPool", group: PackGroup,
                 member: PackMember, info):
        self.pool = pool
        self.group = group
        self.member = member
        self.info = info
        self.query_id = member.qid
        self.sink_stream = getattr(info, "sink_stream", None)

    def stop(self, detach: bool = False) -> None:  # noqa: ARG002 — the
        # group's lattice holds shared state; a member leaving never
        # snapshots it (signature matches QueryTask.stop)
        self.pool.detach(self.query_id)

    def status(self) -> dict:
        return {"packed": True,
                "signature": signature_text(self.group.sig),
                "slot": self.member.slot}


class PackPool:
    """All pack groups on one server, keyed by signature. ``manual``
    pools never start reader threads — tests drive ``group.feed``
    directly for determinism."""

    def __init__(self, ctx, *, manual: bool = False,
                 batch_capacity: int = 4096):
        self.ctx = ctx
        self.manual = manual
        self.batch_capacity = batch_capacity
        self.groups: dict[tuple, PackGroup] = {}
        self._runners: dict[tuple, _PackRunner] = {}
        self._by_qid: dict[str, PackGroup] = {}
        self._lock = threading.Lock()

    def try_attach(self, qid: str, plan, sink):
        """Attach a freshly launched query. Returns a
        :class:`PackMemberTask` (caller puts it in running_queries) or
        a :class:`PackRefusal` (caller launches a normal task)."""
        sig = pack_signature(plan)
        if isinstance(sig, PackRefusal):
            return sig
        sel = _select_of(plan)
        try:
            logid = self.ctx.streams.get_logid(sel.source)
            attach_lsn = self.ctx.store.tail_lsn(logid)
        except Exception:  # noqa: BLE001 — source gone mid-launch
            return PackRefusal("source", "source stream unavailable")
        with self._lock:
            # lookup + attach under ONE pool-lock hold (lock order
            # pool -> group, same as detach): a concurrent detach of
            # the group's last member cannot pop the group and stop
            # its runner between our lookup and the attach, which
            # would strand this member on a torn-down group that
            # feeds nobody
            group = self.groups.get(sig)
            created = group is None
            if created:
                group = PackGroup(self.ctx, sig,
                                  batch_capacity=self.batch_capacity)
                self.groups[sig] = group
            member = group.attach(qid, sel, sink, attach_lsn)
            self._by_qid[qid] = group
            if created and not self.manual:
                runner = _PackRunner(self.ctx, group)
                self._runners[sig] = runner
                runner.start()
        log.info("packed query %s into %s (slot %d)", qid,
                 signature_text(sig), member.slot)
        return PackMemberTask(self, group, member, None)

    def detach(self, qid: str) -> None:
        runner = None
        with self._lock:
            # check and act in ONE critical section: a concurrent
            # try_attach to the same signature either sees the group
            # before we empty it (and keeps it alive) or creates a
            # fresh one after we popped it — never a member attached
            # to a torn-down group. Lock order is pool -> group; no
            # path nests them the other way.
            group = self._by_qid.pop(qid, None)
            if group is None:
                return
            if group.detach(qid):
                self.groups.pop(group.sig, None)
                runner = self._runners.pop(group.sig, None)
        if runner is not None:
            runner.stop()

    def member_of(self, qid: str) -> PackGroup | None:
        with self._lock:
            return self._by_qid.get(qid)

    def status(self) -> list[dict]:
        with self._lock:
            groups = list(self.groups.values())
        return [g.status() for g in groups]

    def stop(self) -> None:
        with self._lock:
            runners = list(self._runners.values())
            self._runners.clear()
        for r in runners:
            r.stop()
