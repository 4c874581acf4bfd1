"""The continuous-query engine on PyTorch + CUDA (the port of
hstream_tpu.engine).

Records are staged into columnar micro-batches, bit-packed on the host
(transport), copied to the card, decoded and scattered into a dense
window-state lattice `[keys, window-slots, accumulators]` by
hand-written Hopper kernels (lattice, kernels/), and closed by a
host-side watermark with one fused close launch per close cycle. An
EMIT CHANGES query (the default) emits one changelog row per touched
(key, window) per batch, extracted on the card, and resets at each
window end. Non-aggregating queries run on the host (stateless), as do
the host-side keyed stores (statestore). Stream-stream interval joins
keep both sides' sorted stores on the card and step matched pairs
straight into the downstream lattice (join, join_lattice);
stream-table joins keep their table on the host. A running query's
whole state snapshots to one sealed blob and restores into a fresh
executor (snapshot), byte-compatible with the reference's blobs.
Timestamps on the device are int32 milliseconds relative to a per-query
epoch, rebased on the host before the int32 range runs out.
"""

from hstream_tpu_torch.engine.types import ColumnType, Schema, HostBatch
from hstream_tpu_torch.engine.window import (
    TumblingWindow,
    HoppingWindow,
    SessionWindow,
)
from hstream_tpu_torch.engine.plan import (
    AggKind,
    AggSpec,
    PlanNode,
    SourceNode,
    FilterNode,
    ProjectNode,
    AggregateNode,
    JoinNode,
    SinkNode,
)
from hstream_tpu_torch.engine.executor import QueryExecutor
from hstream_tpu_torch.engine.session import SessionExecutor
from hstream_tpu_torch.engine.pipeline import IngestPipeline
from hstream_tpu_torch.engine.stateless import StatelessExecutor
from hstream_tpu_torch.engine.statestore import (
    LastValueStore,
    TimestampedKVStore,
)
from hstream_tpu_torch.engine.join import JoinExecutor, TableJoinExecutor
from hstream_tpu_torch.engine.snapshot import (
    SnapshotCorrupt,
    capture_executor,
    open_blob,
    restore_executor,
    seal_blob,
    serialize_capture,
    snapshot_executor,
)

__all__ = [
    "ColumnType",
    "Schema",
    "HostBatch",
    "TumblingWindow",
    "HoppingWindow",
    "SessionWindow",
    "AggKind",
    "AggSpec",
    "PlanNode",
    "SourceNode",
    "FilterNode",
    "ProjectNode",
    "AggregateNode",
    "JoinNode",
    "SinkNode",
    "QueryExecutor",
    "SessionExecutor",
    "IngestPipeline",
    "StatelessExecutor",
    "TimestampedKVStore",
    "LastValueStore",
    "JoinExecutor",
    "TableJoinExecutor",
    "make_executor",
    "SnapshotCorrupt",
    "capture_executor",
    "serialize_capture",
    "snapshot_executor",
    "restore_executor",
    "seal_blob",
    "open_blob",
]


def __getattr__(name: str):
    # sql.codegen imports the engine (and the SQL AST imports the engine's
    # expressions), so the factory resolves on first use
    if name == "make_executor":
        from hstream_tpu_torch.sql.codegen import make_executor

        return make_executor
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
