"""Checkpoint stores + checkpointed readers.

Reference capability (cbits/logdevice/hs_checkpoint.cpp, Store/Stream.hs:299-357):
three checkpoint-store backends (file / RSM-log / ZK) mapping
(customer_id, logid) -> LSN, and "checkpointed readers" that bind a reader to
a store so consumption can resume where the last committed checkpoint left
off. We provide memory / file / log backends; the log backend is a tiny
replicated-state-machine over the reserved checkpoint log: each update
appends a JSON delta, state is rebuilt by replay on open, and the log is
compacted with a snapshot + trim once the backlog grows.
"""

# A copy of hstream_tpu/store/checkpoint.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import json
import os
import threading

from hstream_tpu_torch.common.faultinject import FAULTS
from hstream_tpu_torch.common.logger import get_logger
from hstream_tpu_torch.store.api import (
    LSN_MAX,
    LSN_MIN,
    CheckpointStore,
    DataBatch,
    LogReader,
    LogStore,
    ReadResult,
)
from hstream_tpu_torch.store.streams import CHECKPOINT_STORE_LOGID, StreamApi

log = get_logger("checkpoint")


class MemCheckpointStore(CheckpointStore):
    def __init__(self) -> None:
        self._data: dict[str, dict[int, int]] = {}
        self._lock = threading.Lock()

    def get(self, customer_id: str, logid: int) -> int | None:
        with self._lock:
            return self._data.get(customer_id, {}).get(logid)

    def update_multi(self, customer_id: str, ckps: dict[int, int]) -> None:
        with self._lock:
            self._data.setdefault(customer_id, {}).update(ckps)

    def remove(self, customer_id: str) -> None:
        with self._lock:
            self._data.pop(customer_id, None)

    def all_for(self, customer_id: str) -> dict[int, int]:
        with self._lock:
            return dict(self._data.get(customer_id, {}))


class FileCheckpointStore(CheckpointStore):
    """One JSON file per root path; atomic replace on update.

    A truncated or torn file (the atomic replace protects against torn
    *replaces*, not a torn write of a pre-atomic-era file or filesystem
    corruption) must not prevent construction — and therefore server
    boot (ISSUE 8). Recovery degrades to an EMPTY store: readers rewind
    to their fallback start (the trim point), replaying at-least-once
    instead of crashing. The corrupt bytes are preserved next to the
    path (``<path>.corrupt``) and ``load_error`` records what happened
    so the owner can journal a ``checkpoint_corrupt`` event."""

    def __init__(self, path: str):
        self._path = path
        self._lock = threading.Lock()
        self._data: dict[str, dict[str, int]] = {}
        self.load_error: str | None = None
        if os.path.exists(path):
            try:
                with open(path) as f:
                    data = json.load(f)
                if not isinstance(data, dict):
                    raise ValueError(
                        f"checkpoint root is {type(data).__name__}, "
                        f"not an object")
                self._data = data
            except (ValueError, OSError) as e:
                self.load_error = f"{type(e).__name__}: {e}"
                log.error(
                    "checkpoint file %s is corrupt (%s); recovering "
                    "empty — readers rewind to their trim points",
                    path, self.load_error)
                try:
                    os.replace(path, path + ".corrupt")
                except OSError:
                    pass

    def _flush(self) -> None:
        tmp = self._path + ".tmp"
        data = json.dumps(self._data).encode()
        # chaos probe: a torn flush truncates the JSON mid-document
        data = FAULTS.mutate("checkpoint.flush", data)
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path)

    def get(self, customer_id: str, logid: int) -> int | None:
        with self._lock:
            return self._data.get(customer_id, {}).get(str(logid))

    def update_multi(self, customer_id: str, ckps: dict[int, int]) -> None:
        with self._lock:
            cur = self._data.setdefault(customer_id, {})
            for logid, lsn in ckps.items():
                cur[str(logid)] = lsn
            self._flush()

    def remove(self, customer_id: str) -> None:
        with self._lock:
            if self._data.pop(customer_id, None) is not None:
                self._flush()

    def all_for(self, customer_id: str) -> dict[int, int]:
        with self._lock:
            return {int(k): v for k, v in self._data.get(customer_id, {}).items()}


class LogCheckpointStore(CheckpointStore):
    """RSM checkpoint store over the reserved checkpoint log (logid bit 56).

    Each update appends {"c": customer, "k": {logid: lsn}}; remove appends
    {"c": customer, "rm": true}. State = replay of the log. After
    `compact_every` deltas a full snapshot is appended and the log trimmed
    behind it.
    """

    def __init__(self, store: LogStore, *, compact_every: int = 1024):
        self._store = store
        self._logid = CHECKPOINT_STORE_LOGID
        self._lock = threading.Lock()
        self._data: dict[str, dict[int, int]] = {}
        self._deltas = 0
        self._compact_every = compact_every
        # entries the boot replay could not decode/apply (corrupt or
        # torn deltas): skipped loudly instead of failing boot; the
        # ServerContext journals a checkpoint_corrupt event when > 0.
        # A skipped delta can only LOWER a customer's checkpoint, so
        # its reader replays more — at-least-once, never a skip.
        self.replay_skipped = 0
        StreamApi(store).ensure_checkpoint_log()
        self._replay()

    def _replay(self) -> None:
        reader = self._store.new_reader()
        reader.set_timeout(0)
        reader.start_reading(self._logid, LSN_MIN, LSN_MAX)
        while True:
            results = reader.read(256)
            if not results:
                break
            for r in results:
                if not isinstance(r, DataBatch):
                    continue
                for payload in r.payloads:
                    try:
                        self._apply(json.loads(payload))
                    except (ValueError, KeyError, TypeError,
                            AttributeError) as e:
                        self.replay_skipped += 1
                        log.error(
                            "skipping corrupt checkpoint entry at "
                            "lsn %d: %s", r.lsn, e)
        reader.stop_reading(self._logid)

    def _apply(self, entry: dict) -> None:
        if "snap" in entry:
            self._data = {c: {int(k): v for k, v in m.items()}
                          for c, m in entry["snap"].items()}
            return
        customer = entry["c"]
        if entry.get("rm"):
            self._data.pop(customer, None)
        else:
            cur = self._data.setdefault(customer, {})
            for k, v in entry["k"].items():
                cur[int(k)] = v

    def _append(self, entry: dict) -> None:
        data = json.dumps(entry).encode()
        # chaos probe: torn delta write / injected append failure
        data = FAULTS.mutate("checkpoint.flush", data)
        self._store.append(self._logid, data)
        self._deltas += 1
        if self._deltas >= self._compact_every:
            snap = {"snap": {c: {str(k): v for k, v in m.items()}
                             for c, m in self._data.items()}}
            lsn = self._store.append(self._logid, json.dumps(snap).encode())
            self._store.trim(self._logid, lsn - 1)
            self._deltas = 0

    def get(self, customer_id: str, logid: int) -> int | None:
        with self._lock:
            return self._data.get(customer_id, {}).get(logid)

    def update_multi(self, customer_id: str, ckps: dict[int, int]) -> None:
        with self._lock:
            self._data.setdefault(customer_id, {}).update(ckps)
            self._append({"c": customer_id,
                          "k": {str(k): v for k, v in ckps.items()}})

    def remove(self, customer_id: str) -> None:
        with self._lock:
            if self._data.pop(customer_id, None) is not None:
                self._append({"c": customer_id, "rm": True})

    def all_for(self, customer_id: str) -> dict[int, int]:
        with self._lock:
            return dict(self._data.get(customer_id, {}))


class CheckpointedReader:
    """A LogReader bound to a CheckpointStore under a customer id.

    start_reading_from_checkpoint resumes at checkpoint+1 (or the given
    start when none committed); write_checkpoints commits progress
    (reference: newLDRsmCkpReader + writeCheckpoints, Stream.hs:299-357).
    """

    def __init__(self, name: str, reader: LogReader, ckp_store: CheckpointStore):
        self.name = name
        self.reader = reader
        self.ckp_store = ckp_store

    def start_reading_from_checkpoint(self, logid: int,
                                      fallback_from: int = LSN_MIN,
                                      until_lsn: int = LSN_MAX) -> int:
        ckp = self.ckp_store.get(self.name, logid)
        start = fallback_from if ckp is None else ckp + 1
        self.reader.start_reading(logid, start, until_lsn)
        return start

    def start_reading(self, logid: int, from_lsn: int = LSN_MIN,
                      until_lsn: int = LSN_MAX) -> None:
        self.reader.start_reading(logid, from_lsn, until_lsn)

    def stop_reading(self, logid: int) -> None:
        self.reader.stop_reading(logid)

    def set_timeout(self, timeout_ms: int) -> None:
        self.reader.set_timeout(timeout_ms)

    def read(self, max_records: int) -> list[ReadResult]:
        return self.reader.read(max_records)

    def write_checkpoints(self, ckps: dict[int, int]) -> None:
        self.ckp_store.update_multi(self.name, ckps)

    def remove_checkpoints(self) -> None:
        self.ckp_store.remove(self.name)
