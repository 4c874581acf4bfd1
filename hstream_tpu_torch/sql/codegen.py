"""SQL -> plan lowering, and executor construction for a lowered plan
(the port of hstream_tpu/sql/codegen.py: the lowering is a copy; the
executors are the port's).

The reference's `streamCodegen` lowers the refined AST into a processor-
DAG builder per plan type (Codegen.hs:109-117, SELECT pipeline
source -> filter -> map/groupBy -> window aggregate -> having -> sink at
Codegen.hs:532-567, with `AggregateComponents` fused across the select
list at Codegen.hs:387-477). Here SELECT lowers to the engine's logical
plan: a FilterNode chain under an AggregateNode whose AggSpecs are the
fused accumulator planes of one lattice; HAVING and post-aggregate
expressions become host-side row operations.

The port's executors run on the card unless `device="cpu"` is passed,
which selects the plain PyTorch versions of the kernels. With a `mesh`
(hstream_tpu_torch.parallel.make_mesh) a windowed aggregate runs sharded
on the mesh's devices, and so do a session window (its arena key-sharded)
and an interval join (both side stores key-sharded, the inner aggregate
sharded with them). EXPLAIN has no PACK line until the placer's packing
is ported (A9).
"""

from __future__ import annotations

import json

import torch

from hstream_tpu_torch.common.errors import SQLCodegenError
from hstream_tpu_torch.engine.expr import BinOp, Col, Expr, Lit, UnOp
from hstream_tpu_torch.engine.plan import (
    AggKind,
    AggregateNode,
    AggSpec,
    FilterNode,
    ProjectNode,
    SourceNode,
)
from hstream_tpu_torch.engine.types import ColumnType, Schema
from hstream_tpu_torch.engine.window import (
    DEFAULT_GRACE_MS,
    HoppingWindow,
    SessionWindow,
    TumblingWindow,
    WindowSpec,
)
from hstream_tpu_torch.sql import ast, plans
from hstream_tpu_torch.sql.plans import Plan

_AGG_KIND = {
    ast.SetFuncKind.COUNT_ALL: AggKind.COUNT_ALL,
    ast.SetFuncKind.COUNT: AggKind.COUNT,
    ast.SetFuncKind.SUM: AggKind.SUM,
    ast.SetFuncKind.AVG: AggKind.AVG,
    ast.SetFuncKind.MIN: AggKind.MIN,
    ast.SetFuncKind.MAX: AggKind.MAX,
    ast.SetFuncKind.APPROX_COUNT_DISTINCT: AggKind.APPROX_COUNT_DISTINCT,
    ast.SetFuncKind.APPROX_QUANTILE: AggKind.APPROX_QUANTILE,
    ast.SetFuncKind.TOPK: AggKind.TOPK,
    ast.SetFuncKind.TOPKDISTINCT: AggKind.TOPK_DISTINCT,
}

_STRINGY_OPS = {"TO_UPPER", "TO_LOWER", "TRIM", "LTRIM", "RTRIM",
                "STRLEN", "REVERSE", "IS_STR"}


def lower_window(w: ast.WindowExpr | None) -> WindowSpec | None:
    if w is None:
        return None
    grace = w.grace.ms if w.grace is not None else DEFAULT_GRACE_MS
    if w.kind == ast.WindowKind.TUMBLING:
        return TumblingWindow(w.size.ms, grace_ms=grace)
    if w.kind == ast.WindowKind.HOPPING:
        return HoppingWindow(w.size.ms, w.advance.ms, grace_ms=grace)
    return SessionWindow(w.size.ms, grace_ms=grace)


class _SchemaInference:
    """Column type inference from expression context (the reference is
    dynamically typed over JSON; a columnar engine needs device dtypes)."""

    def __init__(self) -> None:
        self.types: dict[str, ColumnType] = {}

    def note(self, col: str, t: ColumnType) -> None:
        prev = self.types.get(col)
        if prev is None or (prev == ColumnType.FLOAT
                            and t == ColumnType.STRING):
            self.types[col] = t
        # STRING evidence wins over FLOAT default; first wins otherwise

    def walk(self, e: Expr, want: ColumnType | None = None) -> None:
        if isinstance(e, Col):
            self.note(e.name, want or ColumnType.FLOAT)
        elif isinstance(e, BinOp):
            if e.op in ("=", "<>"):
                if isinstance(e.left, Lit) and isinstance(e.left.value, str):
                    self.walk(e.right, ColumnType.STRING)
                    return
                if isinstance(e.right, Lit) and isinstance(e.right.value,
                                                           str):
                    self.walk(e.left, ColumnType.STRING)
                    return
            self.walk(e.left, None if e.op in ("AND", "OR") else want)
            self.walk(e.right, None if e.op in ("AND", "OR") else want)
        elif isinstance(e, UnOp):
            self.walk(e.operand,
                      ColumnType.STRING if e.op in _STRINGY_OPS else want)
        elif isinstance(e, ast.SetFunc):
            if e.arg is not None:
                self.walk(e.arg, want)


def _default_name(item: ast.SelectItem, idx: int) -> str:
    if item.alias:
        return item.alias
    return item.text or f"col{idx}"


class _AggCollector:
    """Fuses every aggregate call in the select list / HAVING into one
    deduplicated AggSpec list (the reference's fuseAggregateComponents,
    Codegen.hs:387-477), rewriting expressions to reference the aggregate
    output columns."""

    def __init__(self) -> None:
        self.specs: list[AggSpec] = []
        self._by_key: dict[tuple, str] = {}

    def intern(self, sf: ast.SetFunc) -> Col:
        kind = _AGG_KIND.get(sf.kind)
        if kind is None:
            raise SQLCodegenError(f"aggregate {sf.kind.value} not supported")
        key = (kind, sf.arg, sf.arg2)
        name = self._by_key.get(key)
        if name is None:
            name = sf.text or f"agg{len(self.specs)}"
            # keep names unique even if two distinct aggs share SQL text
            existing = {s.out_name for s in self.specs}
            if name in existing:
                name = f"{name}#{len(self.specs)}"
            quantile = k = None
            if kind == AggKind.APPROX_QUANTILE:
                quantile = float(sf.arg2)
            if kind in (AggKind.TOPK, AggKind.TOPK_DISTINCT):
                k = int(sf.arg2)
            self.specs.append(AggSpec(kind=kind, out_name=name,
                                      input=sf.arg, quantile=quantile,
                                      k=k))
            self._by_key[key] = name
        return Col(name)

    def rewrite(self, e: Expr) -> Expr:
        if isinstance(e, ast.SetFunc):
            return self.intern(e)
        if isinstance(e, BinOp):
            return BinOp(e.op, self.rewrite(e.left), self.rewrite(e.right))
        if isinstance(e, UnOp):
            return UnOp(e.op, self.rewrite(e.operand))
        return e


def _flatten_join_refs(sel: ast.Select) -> ast.Select:
    """For JOIN queries, rewrite stream-qualified column refs
    `s.col` -> flat `s.col` names: the joined rows built by
    engine.join.JoinExecutor carry stream-qualified field names exactly
    like the reference's genJoiner (Internal/Codegen.hs:62-67), so
    downstream expressions address them as ordinary flat columns."""
    refs = [sel.source, sel.join.right]
    resolve: dict[str, str] = {}
    for ref in refs:
        resolve[ref.name] = ref.name
        if ref.alias:
            resolve[ref.alias] = ref.name

    def flat(e):
        if isinstance(e, Col):
            if e.stream is None:
                return e
            name = resolve.get(e.stream)
            if name is None:
                raise SQLCodegenError(
                    f"unknown stream qualifier {e.stream!r}")
            return Col(f"{name}.{e.name}")
        if isinstance(e, BinOp):
            return BinOp(e.op, flat(e.left), flat(e.right))
        if isinstance(e, UnOp):
            return UnOp(e.op, flat(e.operand))
        if isinstance(e, ast.SetFunc):
            return ast.SetFunc(e.kind,
                               flat(e.arg) if e.arg is not None else None,
                               e.arg2, e.text)
        return e

    items = None
    if sel.items is not None:
        items = [ast.SelectItem(flat(i.expr), i.alias, i.text)
                 for i in sel.items]
    return ast.Select(
        items=items, source=sel.source, join=sel.join,
        where=flat(sel.where) if sel.where is not None else None,
        group_by=[flat(g) for g in sel.group_by], window=sel.window,
        having=flat(sel.having) if sel.having is not None else None,
        emit_changes=sel.emit_changes)


def lower_select(sel: ast.Select, sql: str = "") -> plans.SelectPlan:
    """SELECT -> engine plan (aggregate or stateless)."""
    if sel.join is not None:
        sel = _flatten_join_refs(sel)
    infer = _SchemaInference()
    if sel.where is not None:
        infer.walk(sel.where)
    for item in (sel.items or []):
        infer.walk(item.expr)

    window = lower_window(sel.window)
    items = sel.items or []
    has_agg = any(isinstance(sf, ast.SetFunc)
                  for i in items for sf in _walk_setfuncs(i.expr))
    grouped = bool(sel.group_by) or window is not None or has_agg

    source = SourceNode(stream=sel.source.name, schema=None)
    node = source
    if sel.where is not None:
        node = FilterNode(node, sel.where)

    if grouped:
        coll = _AggCollector()
        group_names = [g.name for g in sel.group_by
                       if isinstance(g, Col)]
        # One (name, expr) per select item over the aggregate outputs.
        # When every item is a bare aggregate or plain group column with
        # no alias, the executor's natural emission (key cols + agg
        # outputs) already matches — post projections stay empty. Any
        # alias or computed item forces explicit projection of ALL items
        # so the emitted row carries exactly the selected fields.
        projected: list[tuple[str, Expr]] = []
        natural = True
        for idx, item in enumerate(items):
            rewritten = coll.rewrite(item.expr)
            name = _default_name(item, idx)
            bare_agg = (isinstance(item.expr, ast.SetFunc)
                        and item.alias is None)
            plain_group = (isinstance(item.expr, Col)
                           and item.expr.name in group_names
                           and item.alias is None)
            if not (bare_agg or plain_group):
                natural = False
            projected.append((name, rewritten))
        # Explicit projection must still carry the group-key columns:
        # the reference's emitted row always includes the key (the
        # aggregate output is keyed by it — Codegen.hs:479-521), so
        # `SELECT COUNT(*) AS c ... GROUP BY city` emits city too.
        if not natural:
            covered = {e.name for _, e in projected if isinstance(e, Col)}
            key_proj = [(g, Col(g)) for g in group_names
                        if g not in covered]
            projected = key_proj + projected
        having = None
        if sel.having is not None:
            having = coll.rewrite(sel.having)
        if not coll.specs:
            raise SQLCodegenError(
                "GROUP BY queries need at least one aggregate in SELECT")
        node = AggregateNode(
            child=node,
            group_keys=list(sel.group_by),
            window=window,
            aggs=coll.specs,
            having=having,
            post_projections=[] if natural else projected,
        )
    else:
        exprs = [( _default_name(i, n), i.expr) for n, i in enumerate(items)]
        node = ProjectNode(node, exprs) if items else node

    return plans.SelectPlan(
        sql=sql,
        source=sel.source.name,
        node=node,
        schema_req=plans.SchemaRequirement(inferred=dict(infer.types)),
        emit_changes=sel.emit_changes,
        join=sel.join,
        source_alias=sel.source.alias,
    )


def _walk_setfuncs(e: Expr):
    if isinstance(e, ast.SetFunc):
        yield e
        if e.arg is not None:
            yield from _walk_setfuncs(e.arg)
    elif isinstance(e, BinOp):
        yield from _walk_setfuncs(e.left)
        yield from _walk_setfuncs(e.right)
    elif isinstance(e, UnOp):
        yield from _walk_setfuncs(e.operand)


def stream_codegen(sql: str) -> plans.Plan:
    """Text -> plan (the reference's streamCodegen, Codegen.hs:109-110)."""
    # imported here: engine/__init__ imports this module for
    # make_executor, and the parser imports the engine's expressions
    from hstream_tpu_torch.sql.refine import parse_and_refine

    stmt = parse_and_refine(sql)
    return _codegen(stmt, sql)


def _codegen(stmt: ast.Statement, sql: str) -> plans.Plan:
    if isinstance(stmt, ast.Select):
        if not stmt.emit_changes:
            # pull query against a materialized view (SelectViewPlan,
            # reference Handler.hs:277-325)
            return plans.SelectViewPlan(sql=sql, view=stmt.source.name,
                                        select=stmt)
        return lower_select(stmt, sql)
    if isinstance(stmt, ast.CreateStream):
        if stmt.as_select is not None:
            return plans.CreateBySelectPlan(
                stream=stmt.name,
                select=lower_select(stmt.as_select, sql),
                options=dict(stmt.options))
        return plans.CreatePlan(stream=stmt.name, options=dict(stmt.options))
    if isinstance(stmt, ast.CreateView):
        return plans.CreateViewPlan(view=stmt.name,
                                    select=lower_select(stmt.select, sql))
    if isinstance(stmt, ast.CreateConnector):
        return plans.CreateSinkConnectorPlan(
            name=stmt.name, options=dict(stmt.options),
            if_not_exist=stmt.if_not_exist)
    if isinstance(stmt, ast.Insert):
        if stmt.fields is not None:
            return plans.InsertPlan(
                stream=stmt.stream,
                payload=dict(zip(stmt.fields, stmt.values)),
                raw_payload=None)
        if stmt.json_payload is not None:
            try:
                obj = json.loads(stmt.json_payload)
            except json.JSONDecodeError as e:
                raise SQLCodegenError(f"bad JSON payload: {e}") from e
            if not isinstance(obj, dict):
                raise SQLCodegenError("INSERT JSON payload must be an object")
            return plans.InsertPlan(stream=stmt.stream, payload=obj,
                                    raw_payload=None)
        return plans.InsertPlan(
            stream=stmt.stream, payload=None,
            raw_payload=stmt.binary_payload.encode("utf-8"))
    if isinstance(stmt, ast.Show):
        return plans.ShowPlan(what=stmt.what)
    if isinstance(stmt, ast.Drop):
        return plans.DropPlan(what=stmt.what, name=stmt.name,
                              if_exists=stmt.if_exists)
    if isinstance(stmt, ast.Terminate):
        return plans.TerminatePlan(query_id=stmt.query_id)
    if isinstance(stmt, ast.Explain):
        inner = _codegen(stmt.stmt, sql)
        return plans.ExplainPlan(inner=inner, text=explain_text(inner))
    raise SQLCodegenError(f"cannot lower {type(stmt).__name__}")


def mesh_exclusion_reason(plan: plans.Plan) -> str | None:
    """Why a plan cannot execute over the device mesh (None = shardable).
    One predicate shared by the task runtime's gate and EXPLAIN, so the
    single-chip fallback is always visible (SURVEY §2.3)."""
    if not isinstance(plan, plans.SelectPlan):
        sel = getattr(plan, "select", None)
        if sel is None:
            return "not a SELECT plan"
        plan = sel
    if plan.join is not None and getattr(plan.join, "table", False):
        return ("stream-TABLE JOIN keeps keyed last-value state on the "
                "host; the probe side runs single-chip")
    # interval (stream-stream) joins shard: key-sharded side stores with
    # the fused probe scatter into the sharded aggregate lattice, and
    # session windows shard their chain-merge arena per key shard — only
    # the downstream aggregate's own exclusions remain
    from hstream_tpu_torch.engine.plan import AggKind, AggregateNode

    node = plan.node
    if not isinstance(node, AggregateNode):
        return "stateless plans have no device state to shard"
    if any(a.kind in (AggKind.TOPK, AggKind.TOPK_DISTINCT)
           for a in node.aggs):
        return ("TOPK/TOPK_DISTINCT planes have no elementwise shard "
                "merge; the query runs single-chip")
    return None


def explain_text(plan: plans.Plan) -> str:
    """Render the task topology (reference ExecPlan.hs:80-119)."""
    if isinstance(plan, plans.SelectPlan):
        lines = []
        node = plan.node

        def walk(n, depth):
            pad = "  " * depth
            if isinstance(n, AggregateNode):
                w = n.window
                wtxt = (f" window={type(w).__name__}" if w else "")
                lines.append(
                    f"{pad}AGGREGATE keys={[getattr(g, 'name', '?') for g in n.group_keys]}"
                    f" aggs={[a.out_name for a in n.aggs]}{wtxt}"
                    + (" having" if n.having is not None else "")
                    + (f" [state: lattice {len(n.aggs)} planes]"))
                walk(n.child, depth + 1)
            elif isinstance(n, FilterNode):
                lines.append(f"{pad}FILTER")
                walk(n.child, depth + 1)
            elif isinstance(n, ProjectNode):
                lines.append(f"{pad}PROJECT {[name for name, _ in n.exprs]}")
                walk(n.child, depth + 1)
            elif isinstance(n, SourceNode):
                lines.append(f"{pad}SOURCE stream={n.stream}")

        walk(node, 0)
        if plan.join is not None:
            if getattr(plan.join, "table", False):
                lines.insert(0, f"JOIN TABLE({plan.join.right.name}) "
                                "[keyed last-value]")
            else:
                lines.insert(0, f"JOIN {plan.join.right.name} "
                                f"WITHIN {plan.join.within.ms}ms")
        reason = mesh_exclusion_reason(plan)
        if reason is None:
            nd = torch.cuda.device_count() if torch.cuda.is_available() \
                else 1  # EXPLAIN renders without a card
            lines.append(f"MESH: shardable over {nd} chips "
                         "(data x key) when --mesh is set")
        else:
            lines.append(f"MESH: single-chip — {reason}")
        # co-compile packing eligibility: the typed refusal reason says
        # why a query did not share a lattice (lazy import: placer pulls
        # scheduler, which pulls codegen back)
        from hstream_tpu_torch.placer.packing import (
            PackRefusal,
            pack_signature,
            signature_text,
        )

        sig = pack_signature(plan)
        if isinstance(sig, PackRefusal):
            lines.append(f"PACK: unpackable — {sig.code}: {sig.detail}")
        else:
            lines.append("PACK: packable with --pack-queries — "
                         f"{signature_text(sig)}")
        return "\n".join(lines)
    if isinstance(plan, plans.CreateBySelectPlan):
        return (f"CREATE STREAM {plan.stream} AS\n"
                + explain_text(plan.select))
    if isinstance(plan, plans.CreateViewPlan):
        return f"CREATE VIEW {plan.view} AS\n" + explain_text(plan.select)
    return type(plan).__name__


def emitted_group_cols(node: AggregateNode) -> list[str]:
    """Names under which the group-key columns appear in EMITTED rows.

    Without post projections rows carry the plan column names; with them
    (any aliased/computed select item) a key column emits under the name
    of the first projected item that is exactly that column — e.g.
    `SELECT city AS c ... GROUP BY city` emits the key as "c". Consumers
    keying on emitted rows (materialized views) must use these names."""
    out = []
    for g in node.group_keys:
        if not isinstance(g, Col):
            continue
        name = g.name
        for out_name, e in (node.post_projections or []):
            if isinstance(e, Col) and e.name == g.name:
                name = out_name
                break
        out.append(name)
    return out


def make_executor(plan: plans.SelectPlan, sample_rows=None, *,
                  mesh=None, initial_keys: int = 1024,
                  batch_capacity: int = 4096, device=None):
    """Instantiate the port executor for a lowered SELECT plan.

    `sample_rows` refine schema inference (bind_schema). With `mesh`, the
    aggregation lattice is sharded over it (hstream_tpu_torch.parallel;
    the mesh's devices hold the shards, whatever `device` says), but for
    TOPK, whose planes have no elementwise merge; a session window's arena
    and an interval join's stores key-shard over a key axis above one."""
    if plan.join is not None:
        from hstream_tpu_torch.engine.join import (JoinExecutor,
                                                   TableJoinExecutor)

        # schema inference for the inner executor uses the first JOINED
        # batch (caller sample rows are single-stream shaped)
        if getattr(plan.join, "table", False):
            # TABLE joins keep keyed last-value state on the host
            return TableJoinExecutor(plan, initial_keys=initial_keys,
                                     batch_capacity=batch_capacity,
                                     device=device)
        return JoinExecutor(plan, initial_keys=initial_keys,
                            batch_capacity=batch_capacity, device=device,
                            mesh=mesh)
    node = plan.node
    if isinstance(node, AggregateNode):
        schema = bind_schema(plan, sample_rows)
        if isinstance(node.window, SessionWindow):
            from hstream_tpu_torch.engine.session import SessionExecutor

            return SessionExecutor(node, schema,
                                   emit_changes=plan.emit_changes,
                                   device=device, mesh=mesh)
        if mesh is not None and any(
                a.kind in (AggKind.TOPK, AggKind.TOPK_DISTINCT)
                for a in node.aggs):
            mesh = None  # TOPK planes have no elementwise shard merge
        if mesh is not None:
            from hstream_tpu_torch.parallel import ShardedQueryExecutor

            return ShardedQueryExecutor(
                node, schema, mesh=mesh, emit_changes=plan.emit_changes,
                initial_keys=initial_keys, batch_capacity=batch_capacity)
        from hstream_tpu_torch.engine.executor import QueryExecutor

        return QueryExecutor(node, schema, emit_changes=plan.emit_changes,
                             initial_keys=initial_keys,
                             batch_capacity=batch_capacity, device=device)
    from hstream_tpu_torch.engine.stateless import StatelessExecutor

    return StatelessExecutor(node)


def bind_schema(plan: plans.SelectPlan, sample_rows=None) -> Schema:
    """Concrete device Schema for a lowered plan: inferred types, refined
    by sampling decoded records when provided (numbers -> FLOAT,
    strings -> STRING, bools -> BOOL)."""
    types = dict(plan.schema_req.inferred)
    for row in (sample_rows or []):
        for k, v in row.items():
            if k in types:
                continue
            if isinstance(v, bool):
                types[k] = ColumnType.BOOL
            elif isinstance(v, (int, float)):
                types[k] = ColumnType.FLOAT
            elif isinstance(v, str):
                types[k] = ColumnType.STRING
    # group-key columns referenced by emission must exist in the schema
    # for row decode; give unseen ones STRING
    node = plan.node
    if isinstance(node, AggregateNode):
        for g in node.group_keys:
            if isinstance(g, Col) and g.name not in types:
                types[g.name] = ColumnType.STRING
    return Schema(tuple(types.items()))
