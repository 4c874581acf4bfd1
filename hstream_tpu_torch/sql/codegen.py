"""Executor construction for a lowered SELECT plan (the port of
`make_executor` and `bind_schema`, hstream_tpu/sql/codegen.py:468-537).

The port's executors run on the card unless `device="cpu"` is passed,
which selects the plain PyTorch versions of the kernels. There is no
`mesh`: sharded execution waits for ROADMAP A11.
"""

from __future__ import annotations

from hstream_tpu_torch.engine.expr import Col
from hstream_tpu_torch.engine.plan import AggregateNode
from hstream_tpu_torch.engine.types import ColumnType, Schema
from hstream_tpu_torch.engine.window import SessionWindow
from hstream_tpu_torch.sql import plans


def make_executor(plan: plans.SelectPlan, sample_rows=None, *,
                  initial_keys: int = 1024, batch_capacity: int = 4096,
                  device=None):
    """Instantiate the port executor for a lowered SELECT plan.

    `sample_rows` refine schema inference (bind_schema)."""
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
                            batch_capacity=batch_capacity, device=device)
    node = plan.node
    if isinstance(node, AggregateNode):
        schema = bind_schema(plan, sample_rows)
        if isinstance(node.window, SessionWindow):
            from hstream_tpu_torch.engine.session import SessionExecutor

            return SessionExecutor(node, schema,
                                   emit_changes=plan.emit_changes,
                                   device=device)
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
