"""Stateless query execution: SELECT without aggregation (a copy of
hstream_tpu/engine/stateless.py).

The reference runs these as per-record filter/map processors in the task
DAG (Stream.hs:63-211). Here non-aggregating queries are host-side row
transforms over decoded micro-batches — they carry no device state, and
ingest decode dominates their cost; vectorizing them onto the device
buys nothing until the native columnar ingest path lands.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

from hstream_tpu_torch.common.errors import SQLCodegenError
from hstream_tpu_torch.engine.expr import eval_host
from hstream_tpu_torch.engine.plan import (
    FilterNode,
    PlanNode,
    ProjectNode,
    SourceNode,
)


class StatelessExecutor:
    """Filter + projection over row batches (no window, no state)."""

    def __init__(self, node: PlanNode):
        self.filters = []
        self.projections = None
        n = node
        while not isinstance(n, SourceNode):
            if isinstance(n, ProjectNode):
                if self.projections is not None:
                    raise SQLCodegenError("multiple projection nodes")
                self.projections = n.exprs
                n = n.child
            elif isinstance(n, FilterNode):
                self.filters.append(n.predicate)
                n = n.child
            else:
                raise SQLCodegenError(
                    f"stateless plan cannot contain {type(n).__name__}")
        self.source = n

    def process(self, rows: Sequence[Mapping[str, Any]],
                ts_ms: Sequence[int] | None = None
                ) -> list[dict[str, Any]]:
        out = []
        for row in rows:
            try:
                if any(not eval_host(p, row) for p in self.filters):
                    continue
            except (TypeError, KeyError):
                continue  # NULL operand -> predicate not true (SQL)
            if self.projections is None:
                out.append(dict(row))
            else:
                proj = {}
                for name, expr in self.projections:
                    try:
                        proj[name] = eval_host(expr, row)
                    except (TypeError, KeyError):
                        proj[name] = None
                out.append(proj)
        return out
