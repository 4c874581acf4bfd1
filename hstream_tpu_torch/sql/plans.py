"""The plan ADT produced by SQL codegen.

Mirrors the reference's `HStreamPlan` (hstream-sql Codegen.hs:94-105):
SelectPlan / CreatePlan / CreateBySelectPlan / CreateViewPlan /
CreateSinkConnectorPlan / InsertPlan / DropPlan / ShowPlan /
TerminatePlan / SelectViewPlan / ExplainPlan — lowered here to the
engine's logical plan nodes instead of processor closures.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from hstream_tpu_torch.engine.plan import PlanNode
from hstream_tpu_torch.engine.types import ColumnType
from hstream_tpu_torch.sql import ast


@dataclass(frozen=True)
class SchemaRequirement:
    """Column types the lowered plan needs on device. `inferred` maps a
    column to its type as deduced from expression context (string
    comparisons -> STRING, arithmetic/aggregation -> FLOAT); columns used
    only as group keys stay host-side and are not listed."""

    inferred: dict[str, ColumnType] = field(default_factory=dict)


@dataclass(frozen=True)
class SelectPlan:
    sql: str
    source: str                  # source stream name
    node: PlanNode               # engine logical plan (root)
    schema_req: SchemaRequirement
    emit_changes: bool
    join: ast.JoinClause | None = None
    source_alias: str | None = None   # FROM <source> AS <alias>


@dataclass(frozen=True)
class CreatePlan:
    stream: str
    options: dict[str, Any]


@dataclass(frozen=True)
class CreateBySelectPlan:
    stream: str
    select: SelectPlan
    options: dict[str, Any]


@dataclass(frozen=True)
class CreateViewPlan:
    view: str
    select: SelectPlan


@dataclass(frozen=True)
class CreateSinkConnectorPlan:
    name: str
    options: dict[str, Any]
    if_not_exist: bool


@dataclass(frozen=True)
class InsertPlan:
    stream: str
    payload: dict | None         # decoded JSON object
    raw_payload: bytes | None    # binary insert


@dataclass(frozen=True)
class DropPlan:
    what: str                    # STREAM / VIEW / CONNECTOR
    name: str
    if_exists: bool


@dataclass(frozen=True)
class ShowPlan:
    what: str                    # QUERIES / STREAMS / CONNECTORS / VIEWS


@dataclass(frozen=True)
class TerminatePlan:
    query_id: str | None         # None = TERMINATE ALL


@dataclass(frozen=True)
class SelectViewPlan:
    """Pull query: SELECT ... FROM view [WHERE key = ...] without EMIT
    CHANGES (reference SelectViewPlan, served from materialized state)."""

    sql: str
    view: str
    select: ast.Select


@dataclass(frozen=True)
class ExplainPlan:
    inner: "Plan"
    text: str


Plan = (SelectPlan | CreatePlan | CreateBySelectPlan | CreateViewPlan
        | CreateSinkConnectorPlan | InsertPlan | DropPlan | ShowPlan
        | TerminatePlan | SelectViewPlan | ExplainPlan)
