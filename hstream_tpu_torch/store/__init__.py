# A copy of hstream_tpu/store/__init__.py; the port imports nothing of the JAX
# package.

from hstream_tpu_torch.store.api import (
    LSN_MIN,
    LSN_MAX,
    Compression,
    DataBatch,
    GapRecord,
    GapType,
    LogAttrs,
    LogStore,
    LogReader,
    CheckpointStore,
)
from hstream_tpu_torch.store.memstore import MemLogStore
from hstream_tpu_torch.store.streams import StreamApi, StreamType
from hstream_tpu_torch.store.checkpoint import (
    MemCheckpointStore,
    FileCheckpointStore,
    LogCheckpointStore,
    CheckpointedReader,
)

__all__ = [
    "LSN_MIN",
    "LSN_MAX",
    "Compression",
    "DataBatch",
    "GapRecord",
    "GapType",
    "LogAttrs",
    "LogStore",
    "LogReader",
    "CheckpointStore",
    "MemLogStore",
    "StreamApi",
    "StreamType",
    "MemCheckpointStore",
    "FileCheckpointStore",
    "LogCheckpointStore",
    "CheckpointedReader",
]


def open_store(uri: str | None = None, *,
               sync_interval_ms: int | None = None,
               segment_bytes: int | None = None) -> LogStore:
    """Open a log store. `None` or "mem://" gives the in-memory backend;
    "file:///path" (or a bare path) opens the native embedded store.
    `sync_interval_ms` tunes the native group-commit fsync cadence,
    `segment_bytes` the segment roll size (ignored by the mem backend)."""
    if uri is None or uri == "mem://":
        return MemLogStore()
    path = uri[len("file://"):] if uri.startswith("file://") else uri
    from hstream_tpu_torch.store.native import NativeLogStore

    kw = {}
    if sync_interval_ms is not None:
        kw["sync_interval_ms"] = sync_interval_ms
    if segment_bytes is not None:
        kw["segment_bytes"] = segment_bytes
    return NativeLogStore(path, **kw)
