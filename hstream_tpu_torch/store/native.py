"""NativeLogStore: ctypes binding over the embedded C++ segment-log store
(cpp/nstore.cpp). Implements the frozen LogStore/LogReader API
(store/api.py) with durable group-commit appends, zlib batch
compression, trim gaps, and a persistent metadata KV.

Blocking reader calls release the GIL (ctypes foreign calls), so a
server thread blocked in read() does not stall Python — the property the
reference gets from Haskell green threads over its FFI
(hstream-store HStream/Store/Internal/Foreign.hs:41-61).

The async append path (AsyncAppender) exposes the C++ completion queue
as concurrent futures: the asyncio-facing analogue of the reference's
append callback + hs_try_putmvar pattern (cbits/logdevice
hs_writer.cpp:36-45).
"""

# A copy of hstream_tpu/store/native.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import ctypes as C
import json
import struct
import threading
from concurrent.futures import Future
from typing import Sequence

from hstream_tpu_torch.common.errors import LogNotFound, StoreError
from hstream_tpu_torch.store.api import (
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
from hstream_tpu_torch.store.build import build

_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = C.CDLL(build())
        lib.ns_open.restype = C.c_void_p
        lib.ns_open.argtypes = [C.c_char_p, C.c_char_p]
        lib.ns_close.argtypes = [C.c_void_p]
        lib.ns_set_sync_interval.argtypes = [C.c_void_p, C.c_int64]
        lib.ns_set_seg_bytes.argtypes = [C.c_void_p, C.c_uint64]
        lib.ns_create_log.argtypes = [C.c_void_p, C.c_uint64, C.c_char_p,
                                      C.c_char_p]
        lib.ns_remove_log.argtypes = [C.c_void_p, C.c_uint64, C.c_char_p]
        lib.ns_log_exists.argtypes = [C.c_void_p, C.c_uint64]
        lib.ns_list_logs.restype = C.c_int64
        lib.ns_list_logs.argtypes = [C.c_void_p, C.POINTER(C.c_uint64),
                                     C.c_int64]
        lib.ns_log_attrs.restype = C.c_int64
        lib.ns_log_attrs.argtypes = [C.c_void_p, C.c_uint64, C.c_char_p,
                                     C.c_int64]
        lib.ns_append_batch.restype = C.c_int64
        lib.ns_append_batch.argtypes = [
            C.c_void_p, C.c_uint64, C.c_char_p, C.POINTER(C.c_uint32),
            C.c_uint32, C.c_int, C.c_int, C.c_char_p, C.c_int64]
        lib.ns_append_async.argtypes = [
            C.c_void_p, C.c_uint64, C.c_char_p, C.POINTER(C.c_uint32),
            C.c_uint32, C.c_int, C.c_uint64]
        lib.ns_poll_completions.restype = C.c_int64
        lib.ns_poll_completions.argtypes = [
            C.c_void_p, C.POINTER(C.c_uint64), C.POINTER(C.c_int64),
            C.c_int64, C.c_int64]
        lib.ns_tail_lsn.restype = C.c_int64
        lib.ns_tail_lsn.argtypes = [C.c_void_p, C.c_uint64]
        lib.ns_trim.argtypes = [C.c_void_p, C.c_uint64, C.c_int64,
                                C.c_char_p]
        lib.ns_trim_point.restype = C.c_int64
        lib.ns_trim_point.argtypes = [C.c_void_p, C.c_uint64]
        lib.ns_find_time.restype = C.c_int64
        lib.ns_find_time.argtypes = [C.c_void_p, C.c_uint64, C.c_int64]
        lib.ns_is_log_empty.argtypes = [C.c_void_p, C.c_uint64]
        lib.ns_meta_put.argtypes = [C.c_void_p, C.c_char_p, C.c_char_p,
                                    C.c_int64]
        lib.ns_meta_get.restype = C.c_int64
        lib.ns_meta_get.argtypes = [C.c_void_p, C.c_char_p, C.c_char_p,
                                    C.c_int64]
        lib.ns_meta_delete.argtypes = [C.c_void_p, C.c_char_p]
        lib.ns_meta_list.restype = C.c_int64
        lib.ns_meta_list.argtypes = [C.c_void_p, C.c_char_p, C.c_char_p,
                                     C.c_int64]
        lib.ns_meta_cas.argtypes = [C.c_void_p, C.c_char_p, C.c_char_p,
                                    C.c_int64, C.c_char_p, C.c_int64]
        lib.ns_reader_new.restype = C.c_void_p
        lib.ns_reader_new.argtypes = [C.c_void_p]
        lib.ns_reader_free.argtypes = [C.c_void_p]
        lib.ns_reader_start.argtypes = [C.c_void_p, C.c_uint64, C.c_int64,
                                        C.c_int64]
        lib.ns_reader_stop.argtypes = [C.c_void_p, C.c_uint64]
        lib.ns_reader_is_reading.argtypes = [C.c_void_p, C.c_uint64]
        lib.ns_reader_set_timeout.argtypes = [C.c_void_p, C.c_int64]
        lib.ns_reader_read.restype = C.c_int64
        lib.ns_reader_read.argtypes = [C.c_void_p, C.c_int64, C.c_char_p,
                                       C.c_int64]
        _lib = lib
        return lib


def _pack_payloads(payloads: Sequence[bytes]):
    lens = (C.c_uint32 * len(payloads))(*[len(p) for p in payloads])
    return b"".join(bytes(p) for p in payloads), lens


class NativeLogStore(LogStore):
    """Durable embedded store rooted at a directory."""

    def __init__(self, root: str, *, sync_interval_ms: int = 2,
                 segment_bytes: int | None = None):
        self.root = str(root)  # observability: segment/WAL size gauges
        self._lib = _load()
        err = C.create_string_buffer(256)
        self._h = self._lib.ns_open(str(root).encode(), err)
        if not self._h:
            raise StoreError(f"open_store({root!r}): "
                             f"{err.value.decode(errors='replace')}")
        self._lib.ns_set_sync_interval(self._h, sync_interval_ms)
        if segment_bytes is not None:
            self._lib.ns_set_seg_bytes(self._h, segment_bytes)
        self._closed = False
        self._appender: AsyncAppender | None = None
        self._appender_lock = threading.Lock()

    # ---- lifecycle ----
    def create_log(self, logid: int, attrs: LogAttrs | None = None) -> None:
        a = attrs or LogAttrs()
        blob = json.dumps({"replication_factor": a.replication_factor,
                           "backlog_seconds": a.backlog_seconds,
                           "extras": a.extras}).encode()
        err = C.create_string_buffer(256)
        if self._lib.ns_create_log(self._h, logid, blob, err) != 0:
            raise StoreError(f"create_log {logid}: {err.value.decode()}")

    def remove_log(self, logid: int) -> None:
        err = C.create_string_buffer(256)
        if self._lib.ns_remove_log(self._h, logid, err) != 0:
            raise LogNotFound(f"log {logid}")

    def log_exists(self, logid: int) -> bool:
        return bool(self._lib.ns_log_exists(self._h, logid))

    def list_logs(self) -> list[int]:
        cap = 1024
        while True:
            out = (C.c_uint64 * cap)()
            n = self._lib.ns_list_logs(self._h, out, cap)
            if n <= cap:
                return sorted(out[i] for i in range(n))
            cap = n

    def log_attrs(self, logid: int) -> LogAttrs:
        cap = 8192
        out = C.create_string_buffer(cap)
        n = self._lib.ns_log_attrs(self._h, logid, out, cap)
        if n < 0:
            raise LogNotFound(f"log {logid}")
        try:
            d = json.loads(out.raw[:n].decode())
        except ValueError:
            d = {}
        return LogAttrs(replication_factor=d.get("replication_factor", 1),
                        backlog_seconds=d.get("backlog_seconds", 0),
                        extras=d.get("extras", {}))

    # ---- append ----
    def append_batch(self, logid: int, payloads: Sequence[bytes],
                     compression: Compression = Compression.NONE, *,
                     append_time_ms: int | None = None) -> int:
        if not payloads:
            raise StoreError("empty batch")
        buf, lens = _pack_payloads(payloads)
        err = C.create_string_buffer(256)
        lsn = self._lib.ns_append_batch(
            self._h, logid, buf, lens, len(payloads),
            1 if compression == Compression.ZLIB else 0, 1, err,
            append_time_ms or 0)
        if lsn < 0:
            msg = err.value.decode()
            if "not found" in msg:
                raise LogNotFound(f"log {logid}")
            raise StoreError(f"append {logid}: {msg}")
        return lsn

    def append_async(self, logid: int, payloads: Sequence[bytes],
                     compression: Compression = Compression.NONE
                     ) -> "Future[int]":
        """Queue an append; the returned future resolves to the LSN after
        the batch is durably written (C++ completion queue)."""
        if self._appender is None:
            # locked: two tasks racing first use must share ONE appender
            # (two would collide token counters on the one C++ queue)
            with self._appender_lock:
                if self._appender is None:
                    self._appender = AsyncAppender(self)
        return self._appender.submit(logid, payloads, compression)

    # ---- introspection ----
    def tail_lsn(self, logid: int) -> int:
        n = self._lib.ns_tail_lsn(self._h, logid)
        if n < 0:
            raise LogNotFound(f"log {logid}")
        return n

    def trim(self, logid: int, up_to_lsn: int) -> None:
        err = C.create_string_buffer(256)
        if self._lib.ns_trim(self._h, logid, up_to_lsn, err) != 0:
            raise LogNotFound(f"log {logid}")

    def trim_point(self, logid: int) -> int:
        n = self._lib.ns_trim_point(self._h, logid)
        if n < 0:
            raise LogNotFound(f"log {logid}")
        return n

    def find_time(self, logid: int, ts_ms: int) -> int:
        n = self._lib.ns_find_time(self._h, logid, ts_ms)
        if n < 0:
            raise LogNotFound(f"log {logid}")
        return n

    def is_log_empty(self, logid: int) -> bool:
        n = self._lib.ns_is_log_empty(self._h, logid)
        if n < 0:
            raise LogNotFound(f"log {logid}")
        return bool(n)

    # ---- reading ----
    def new_reader(self, max_logs: int = 1) -> "NativeLogReader":
        return NativeLogReader(self)

    # ---- metadata KV ----
    def meta_put(self, key: str, value: bytes) -> None:
        self._lib.ns_meta_put(self._h, key.encode(), bytes(value),
                              len(value))

    def meta_get(self, key: str) -> bytes | None:
        cap = 64 * 1024
        while True:
            out = C.create_string_buffer(cap)
            n = self._lib.ns_meta_get(self._h, key.encode(), out, cap)
            if n < 0:
                return None
            if n <= cap:
                return out.raw[:n]
            cap = n

    def meta_delete(self, key: str) -> None:
        self._lib.ns_meta_delete(self._h, key.encode())

    def meta_list(self, prefix: str) -> list[str]:
        cap = 256 * 1024
        while True:
            out = C.create_string_buffer(cap)
            n = self._lib.ns_meta_list(self._h, prefix.encode(), out, cap)
            if n <= cap:
                s = out.raw[:n].decode()
                return s.split("\n") if s else []
            cap = n

    def meta_cas(self, key: str, expected: bytes | None,
                 value: bytes) -> bool:
        exp = b"" if expected is None else bytes(expected)
        explen = -1 if expected is None else len(exp)
        return bool(self._lib.ns_meta_cas(self._h, key.encode(), exp,
                                          explen, bytes(value), len(value)))

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            if self._appender is not None:
                self._appender.close()
            self._lib.ns_close(self._h)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class AsyncAppender:
    """Bridges the C++ append completion queue to concurrent futures
    (awaitable from asyncio via wrap_future)."""

    def __init__(self, store: NativeLogStore):
        self._store = store
        self._lock = threading.Lock()
        self._next_token = 1
        self._futures: dict[int, Future] = {}
        self._stop = False
        self._drainer = threading.Thread(target=self._drain, daemon=True)
        self._drainer.start()

    def submit(self, logid: int, payloads: Sequence[bytes],
               compression: Compression) -> "Future[int]":
        buf, lens = _pack_payloads(payloads)
        fut: Future = Future()
        with self._lock:
            token = self._next_token
            self._next_token += 1
            self._futures[token] = fut
        rc = self._store._lib.ns_append_async(
            self._store._h, logid, buf, lens, len(payloads),
            1 if compression == Compression.ZLIB else 0, token)
        if rc != 0:
            with self._lock:
                self._futures.pop(token, None)
            fut.set_exception(StoreError("store is closing"))
        return fut

    def _drain(self) -> None:
        maxn = 256
        tokens = (C.c_uint64 * maxn)()
        lsns = (C.c_int64 * maxn)()
        while not self._stop:
            n = self._store._lib.ns_poll_completions(
                self._store._h, tokens, lsns, maxn, 100)
            for i in range(n):
                with self._lock:
                    fut = self._futures.pop(tokens[i], None)
                if fut is None:
                    continue
                if lsns[i] > 0:
                    fut.set_result(lsns[i])
                else:
                    fut.set_exception(StoreError("async append failed"))

    def close(self) -> None:
        self._stop = True
        self._drainer.join(timeout=2)
        with self._lock:
            for fut in self._futures.values():
                if not fut.done():
                    fut.set_exception(StoreError("store closed"))
            self._futures.clear()


class NativeLogReader(LogReader):
    def __init__(self, store: NativeLogStore):
        self._store = store
        self._rh = store._lib.ns_reader_new(store._h)
        self._cap = 4 * 1024 * 1024

    def start_reading(self, logid: int, from_lsn: int = LSN_MIN,
                      until_lsn: int = LSN_MAX) -> None:
        if self._store._lib.ns_reader_start(self._rh, logid, from_lsn,
                                            until_lsn) != 0:
            raise LogNotFound(f"log {logid}")

    def stop_reading(self, logid: int) -> None:
        self._store._lib.ns_reader_stop(self._rh, logid)

    def is_reading(self, logid: int) -> bool:
        return bool(self._store._lib.ns_reader_is_reading(self._rh, logid))

    def set_timeout(self, timeout_ms: int) -> None:
        self._store._lib.ns_reader_set_timeout(self._rh, timeout_ms)

    def read(self, max_records: int) -> list[ReadResult]:
        while True:
            buf = C.create_string_buffer(self._cap)
            n = self._store._lib.ns_reader_read(self._rh, max_records, buf,
                                                self._cap)
            if n < 0:
                self._cap = -n
                continue
            return self._parse(buf.raw[:n])

    def _parse(self, data: bytes) -> list[ReadResult]:
        out: list[ReadResult] = []
        off = 0
        while off < len(data):
            kind = data[off]
            off += 1
            if kind == 0:
                logid, lsn, tm, nrecs = struct.unpack_from("<QqqI", data,
                                                           off)
                off += 28
                lens = struct.unpack_from(f"<{nrecs}I", data, off)
                off += 4 * nrecs
                payloads = []
                for ln in lens:
                    payloads.append(data[off:off + ln])
                    off += ln
                out.append(DataBatch(logid=logid, lsn=lsn,
                                     payloads=tuple(payloads),
                                     append_time_ms=tm))
            else:
                logid, gt, lo, hi = struct.unpack_from("<QBqq", data, off)
                off += 25
                out.append(GapRecord(logid, GapType(gt), lo, hi))
        return out

    def __del__(self):
        try:
            self._store._lib.ns_reader_free(self._rh)
        except Exception:
            pass
