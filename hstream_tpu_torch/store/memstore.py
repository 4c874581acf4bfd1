"""In-memory log store: the default test backend.

Plays the role the reference's MockStreamStore plays for its processing
tests (hstream-processing MockStreamStore.hs:30-160) but implements the
full LogStore interface — including gap records for trims, blocking
readers with timeouts, and the metadata KV — so everything above it
(streams, checkpoints, engine, server) runs unmodified against it.
"""

# A copy of hstream_tpu/store/memstore.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import bisect
import threading
import time
from typing import Sequence

from hstream_tpu_torch.common.errors import LogNotFound, StoreError
from hstream_tpu_torch.common.faultinject import FAULTS
from hstream_tpu_torch.store.api import (
    LSN_INVALID,
    LSN_MAX,
    LSN_MIN,
    Compression,
    DataBatch,
    GapRecord,
    GapType,
    LogAttrs,
    LogReader,
    LogStore,
    ReadResult,
)


class _Log:
    __slots__ = ("attrs", "lsns", "batches", "times", "next_lsn", "trim_lsn")

    def __init__(self, attrs: LogAttrs):
        self.attrs = attrs
        self.lsns: list[int] = []          # sorted LSNs of live batches
        self.batches: dict[int, DataBatch] = {}
        self.times: list[int] = []         # append_time_ms, parallel to lsns
        self.next_lsn = LSN_MIN
        self.trim_lsn = 0                  # highest trimmed LSN


class MemLogStore(LogStore):
    def __init__(self) -> None:
        self._logs: dict[int, _Log] = {}
        self._meta: dict[str, bytes] = {}
        self._lock = threading.RLock()
        self._data_cond = threading.Condition(self._lock)

    # ---- log lifecycle ----
    def create_log(self, logid: int, attrs: LogAttrs | None = None) -> None:
        with self._lock:
            if logid in self._logs:
                raise StoreError(f"log {logid} already exists")
            self._logs[logid] = _Log(attrs or LogAttrs())

    def remove_log(self, logid: int) -> None:
        with self._lock:
            if logid not in self._logs:
                raise LogNotFound(f"log {logid}")
            del self._logs[logid]

    def log_exists(self, logid: int) -> bool:
        with self._lock:
            return logid in self._logs

    def list_logs(self) -> list[int]:
        with self._lock:
            return sorted(self._logs)

    def log_attrs(self, logid: int) -> LogAttrs:
        return self._get(logid).attrs

    def _get(self, logid: int) -> _Log:
        with self._lock:
            log = self._logs.get(logid)
            if log is None:
                raise LogNotFound(f"log {logid}")
            return log

    # ---- append ----
    def append_batch(self, logid: int, payloads: Sequence[bytes],
                     compression: Compression = Compression.NONE, *,
                     append_time_ms: int | None = None) -> int:
        if not payloads:
            raise StoreError("empty batch")
        if FAULTS.active:  # chaos probe; one branch when disarmed
            FAULTS.point("store.append")
        with self._data_cond:
            log = self._get(logid)
            lsn = log.next_lsn
            log.next_lsn += 1
            now = append_time_ms or int(time.time() * 1000)
            log.lsns.append(lsn)
            log.times.append(now)
            log.batches[lsn] = DataBatch(
                logid=logid, lsn=lsn,
                payloads=tuple(bytes(p) for p in payloads),
                append_time_ms=now)
            self._data_cond.notify_all()
            return lsn

    # ---- introspection ----
    def tail_lsn(self, logid: int) -> int:
        with self._lock:
            log = self._get(logid)
            return log.lsns[-1] if log.lsns else LSN_INVALID

    def trim(self, logid: int, up_to_lsn: int) -> None:
        with self._lock:
            log = self._get(logid)
            cut = bisect.bisect_right(log.lsns, up_to_lsn)
            for lsn in log.lsns[:cut]:
                del log.batches[lsn]
            del log.lsns[:cut]
            del log.times[:cut]
            log.trim_lsn = max(log.trim_lsn, up_to_lsn)

    def trim_point(self, logid: int) -> int:
        return self._get(logid).trim_lsn

    def find_time(self, logid: int, ts_ms: int) -> int:
        with self._lock:
            log = self._get(logid)
            i = bisect.bisect_left(log.times, ts_ms)
            if i == len(log.lsns):
                return (log.lsns[-1] + 1) if log.lsns else log.next_lsn
            return log.lsns[i]

    def is_log_empty(self, logid: int) -> bool:
        return self.tail_lsn(logid) == LSN_INVALID

    # ---- reading ----
    def new_reader(self, max_logs: int = 1) -> "MemLogReader":
        return MemLogReader(self)

    # ---- metadata KV ----
    def meta_put(self, key: str, value: bytes) -> None:
        with self._lock:
            self._meta[key] = bytes(value)

    def meta_get(self, key: str) -> bytes | None:
        with self._lock:
            return self._meta.get(key)

    def meta_delete(self, key: str) -> None:
        with self._lock:
            self._meta.pop(key, None)

    def meta_list(self, prefix: str) -> list[str]:
        with self._lock:
            return sorted(k for k in self._meta if k.startswith(prefix))

    def meta_cas(self, key: str, expected: bytes | None, value: bytes) -> bool:
        with self._lock:
            if self._meta.get(key) != expected:
                return False
            self._meta[key] = bytes(value)
            return True


class MemLogReader(LogReader):
    """Reader over MemLogStore logs with blocking reads + gap surfacing."""

    def __init__(self, store: MemLogStore):
        self._store = store
        # logid -> [next_lsn_to_read, until_lsn]
        self._cursors: dict[int, list[int]] = {}
        self._timeout_ms = -1

    def start_reading(self, logid: int, from_lsn: int = LSN_MIN,
                      until_lsn: int = LSN_MAX) -> None:
        self._store._get(logid)  # raise if missing
        self._cursors[logid] = [max(from_lsn, LSN_MIN), until_lsn]

    def stop_reading(self, logid: int) -> None:
        self._cursors.pop(logid, None)

    def is_reading(self, logid: int) -> bool:
        return logid in self._cursors

    def set_timeout(self, timeout_ms: int) -> None:
        self._timeout_ms = timeout_ms

    def _poll_once(self, max_records: int) -> list[ReadResult]:
        out: list[ReadResult] = []
        with self._store._lock:
            for logid, cursor in self._cursors.items():
                nxt, until = cursor
                if nxt > until:
                    continue
                try:
                    log = self._store._get(logid)
                except LogNotFound:
                    continue
                # Surface a trim gap once if the cursor fell below trim point.
                if log.trim_lsn >= nxt:
                    hi = min(log.trim_lsn, until)
                    out.append(GapRecord(logid, GapType.TRIM, nxt, hi))
                    cursor[0] = nxt = hi + 1
                    if len(out) >= max_records:
                        break
                i = bisect.bisect_left(log.lsns, nxt)
                while i < len(log.lsns) and len(out) < max_records:
                    lsn = log.lsns[i]
                    if lsn > until:
                        break
                    out.append(log.batches[lsn])
                    cursor[0] = lsn + 1
                    i += 1
                if len(out) >= max_records:
                    break
        return out

    def read(self, max_records: int) -> list[ReadResult]:
        if FAULTS.active:  # chaos probe; one branch when disarmed
            FAULTS.point("store.read")
        deadline = None
        if self._timeout_ms >= 0:
            deadline = time.monotonic() + self._timeout_ms / 1000.0
        while True:
            out = self._poll_once(max_records)
            if out:
                return out
            with self._store._data_cond:
                # Re-check under the lock to avoid a lost wakeup between
                # _poll_once and wait().
                out = self._poll_once(max_records)
                if out:
                    return out
                if deadline is None:
                    self._store._data_cond.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return []
                    self._store._data_cond.wait(remaining)
