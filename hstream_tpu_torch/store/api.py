"""Log-store interface: the frozen API both backends implement.

Capability parity with the reference's store layer (hstream-store):
  * logs addressed by integer logid, records by monotonically increasing LSN
  * batch append: one LSN covers a whole compressed batch
    (cbits/logdevice/hs_writer.cpp batch path)
  * batched reads that surface *gap records* (trims, holes) instead of
    silently skipping (cbits/logdevice/hs_reader.cpp)
  * trim / find_time / is_log_empty / tail_lsn introspection
    (include/hs_logdevice.h)
  * a small metadata KV that the stream namespace tree and versioned
    configs are built on (reference keeps these in LogDevice's logsconfig
    and VersionedConfigStore — hs_logconfigtypes.cpp,
    hs_versioned_config_store.cpp)

Backends: `MemLogStore` (tests, mock-store analogue) and `NativeLogStore`
(C++ embedded segment log via ctypes).
"""

# A copy of hstream_tpu/store/api.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field
from typing import Iterator, Sequence

LSN_MIN = 1
LSN_MAX = (1 << 63) - 1
LSN_INVALID = 0


class Compression(enum.Enum):
    NONE = 0
    ZLIB = 1


class GapType(enum.Enum):
    TRIM = 0      # records below the trim point
    HOLE = 1      # lost records (storage failure)
    DATALOSS = 2


@dataclass(frozen=True)
class DataBatch:
    """One appended batch: a single LSN covering `payloads` records.

    `batch_index` of record i within the batch is simply i; the pair
    (lsn, i) is the stable record address (RecordId in the API plane).
    """

    logid: int
    lsn: int
    payloads: tuple[bytes, ...]
    append_time_ms: int = 0


@dataclass(frozen=True)
class GapRecord:
    logid: int
    gap_type: GapType
    lo_lsn: int
    hi_lsn: int


ReadResult = DataBatch | GapRecord


@dataclass
class LogAttrs:
    replication_factor: int = 1
    backlog_seconds: int = 0  # 0 = keep forever
    extras: dict[str, str] = field(default_factory=dict)


class LogReader:
    """Batched reader over one or more logs.

    Usage: start_reading(logid, from_lsn, until_lsn), then read(max) which
    blocks up to the configured timeout and returns up to `max` items, each
    a DataBatch or a GapRecord (gap semantics preserved from the reference:
    a trimmed range surfaces as GapRecord(TRIM) exactly once).
    """

    def start_reading(self, logid: int, from_lsn: int = LSN_MIN,
                      until_lsn: int = LSN_MAX) -> None:
        raise NotImplementedError

    def stop_reading(self, logid: int) -> None:
        raise NotImplementedError

    def is_reading(self, logid: int) -> bool:
        raise NotImplementedError

    def set_timeout(self, timeout_ms: int) -> None:
        """-1 = block forever; 0 = non-blocking; >0 = max wait."""
        raise NotImplementedError

    def read(self, max_records: int) -> list[ReadResult]:
        raise NotImplementedError


class LogStore:
    """A durable collection of append-only logs + a metadata KV."""

    # ---- log lifecycle ----
    def create_log(self, logid: int, attrs: LogAttrs | None = None) -> None:
        raise NotImplementedError

    def remove_log(self, logid: int) -> None:
        raise NotImplementedError

    def log_exists(self, logid: int) -> bool:
        raise NotImplementedError

    def list_logs(self) -> list[int]:
        raise NotImplementedError

    def log_attrs(self, logid: int) -> LogAttrs:
        raise NotImplementedError

    # ---- append ----
    def append(self, logid: int, payload: bytes,
               compression: Compression = Compression.NONE) -> int:
        """Append one record; returns its LSN (batch of size 1)."""
        return self.append_batch(logid, [payload], compression)

    def append_batch(self, logid: int, payloads: Sequence[bytes],
                     compression: Compression = Compression.NONE, *,
                     append_time_ms: int | None = None) -> int:
        """Append a batch under a single LSN; returns that LSN.
        `append_time_ms` overrides the local wall-clock stamp —
        replication passes the leader's stamp so every replica agrees
        on find_time/backlog answers."""
        raise NotImplementedError

    # ---- introspection ----
    def tail_lsn(self, logid: int) -> int:
        """LSN of the last released record (LSN_INVALID if empty)."""
        raise NotImplementedError

    def trim(self, logid: int, up_to_lsn: int) -> None:
        """Remove records with lsn <= up_to_lsn."""
        raise NotImplementedError

    def trim_point(self, logid: int) -> int:
        raise NotImplementedError

    def find_time(self, logid: int, ts_ms: int) -> int:
        """Smallest LSN whose append time >= ts_ms (tail+1 if none)."""
        raise NotImplementedError

    def is_log_empty(self, logid: int) -> bool:
        raise NotImplementedError

    # ---- reading ----
    def new_reader(self, max_logs: int = 1) -> LogReader:
        raise NotImplementedError

    # ---- metadata KV (namespace tree, versioned configs) ----
    def meta_put(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def meta_get(self, key: str) -> bytes | None:
        raise NotImplementedError

    def meta_delete(self, key: str) -> None:
        raise NotImplementedError

    def meta_list(self, prefix: str) -> list[str]:
        raise NotImplementedError

    def meta_cas(self, key: str, expected: bytes | None, value: bytes) -> bool:
        """Compare-and-set for versioned configs (reference:
        hs_versioned_config_store.cpp). Returns True on success."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class CheckpointStore:
    """Maps (customer_id, logid) -> LSN, the durable consumer progress.

    Reference: three backends (file / RSM log / ZK) in
    cbits/logdevice/hs_checkpoint.cpp; we provide memory / file / log.
    """

    def get(self, customer_id: str, logid: int) -> int | None:
        raise NotImplementedError

    def update(self, customer_id: str, logid: int, lsn: int) -> None:
        self.update_multi(customer_id, {logid: lsn})

    def update_multi(self, customer_id: str, ckps: dict[int, int]) -> None:
        raise NotImplementedError

    def remove(self, customer_id: str) -> None:
        raise NotImplementedError

    def all_for(self, customer_id: str) -> dict[int, int]:
        raise NotImplementedError
