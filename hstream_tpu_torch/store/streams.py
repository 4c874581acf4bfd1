"""Stream namespace: stream names <-> logids over the store's metadata KV.

Mirrors the reference's store façade (hstream-store/HStream/Store/Stream.hs):
  * three stream types with distinct path namespaces — stream / view / temp
    (Stream.hs:129-141, 196-199)
  * createStream mints a fresh random logid under the path; name->logid
    lookups are cached (Stream.hs:189-259)
  * the checkpoint-store log lives at a reserved logid with bit 56 set
    (Stream.hs:285-295)
"""

# A copy of hstream_tpu/store/streams.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import enum
import json
import random
import threading

from hstream_tpu_torch.common.errors import StreamExists, StreamNotFound
from hstream_tpu_torch.store.api import LogAttrs, LogStore

CHECKPOINT_STORE_LOGID = 1 << 56  # reserved, outside the random logid range


class StreamType(enum.Enum):
    STREAM = "stream"
    VIEW = "view"
    TEMP = "temp"


_PREFIX = {
    StreamType.STREAM: "/hstream/stream/",
    StreamType.VIEW: "/hstream/view/",
    StreamType.TEMP: "/tmp/hstream/",
}


class StreamApi:
    """Name-level stream operations on top of a LogStore."""

    def __init__(self, store: LogStore):
        self.store = store
        self._logid_cache: dict[str, int] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(name: str, stype: StreamType) -> str:
        return _PREFIX[stype] + name

    # ---- lifecycle ----
    def create_stream(self, name: str, *, replication_factor: int = 1,
                      backlog_seconds: int = 0,
                      stream_type: StreamType = StreamType.STREAM) -> int:
        key = self._key(name, stream_type)
        with self._lock:
            if self.store.meta_get(key) is not None:
                raise StreamExists(f"stream {name}")
            logid = random.randrange(1, 1 << 48)
            while self.store.log_exists(logid):
                logid = random.randrange(1, 1 << 48)
            attrs = LogAttrs(replication_factor=replication_factor,
                             backlog_seconds=backlog_seconds)
            self.store.create_log(logid, attrs)
            meta = {"logid": logid, "replication_factor": replication_factor,
                    "backlog_seconds": backlog_seconds}
            self.store.meta_put(key, json.dumps(meta).encode())
            self._logid_cache[key] = logid
            return logid

    def delete_stream(self, name: str,
                      stream_type: StreamType = StreamType.STREAM) -> None:
        key = self._key(name, stream_type)
        with self._lock:
            logid = self._lookup(key)
            self.store.remove_log(logid)
            self.store.meta_delete(key)
            self._logid_cache.pop(key, None)

    def stream_exists(self, name: str,
                      stream_type: StreamType = StreamType.STREAM) -> bool:
        return self.store.meta_get(self._key(name, stream_type)) is not None

    def find_streams(self, stream_type: StreamType = StreamType.STREAM) -> list[str]:
        prefix = _PREFIX[stream_type]
        return [k[len(prefix):] for k in self.store.meta_list(prefix)]

    def stream_meta(self, name: str,
                    stream_type: StreamType = StreamType.STREAM) -> dict:
        raw = self.store.meta_get(self._key(name, stream_type))
        if raw is None:
            raise StreamNotFound(f"stream {name}")
        return json.loads(raw)

    # ---- logid resolution (cached, like Stream.hs:361-369) ----
    def _lookup(self, key: str) -> int:
        logid = self._logid_cache.get(key)
        if logid is not None:
            return logid
        raw = self.store.meta_get(key)
        if raw is None:
            raise StreamNotFound(key)
        logid = json.loads(raw)["logid"]
        self._logid_cache[key] = logid
        return logid

    def get_logid(self, name: str,
                  stream_type: StreamType = StreamType.STREAM) -> int:
        return self._lookup(self._key(name, stream_type))

    # ---- data plane conveniences ----
    def append(self, name: str, payload: bytes, *,
               stream_type: StreamType = StreamType.STREAM) -> int:
        return self.store.append(self.get_logid(name, stream_type), payload)

    def append_batch(self, name: str, payloads, *,
                     stream_type: StreamType = StreamType.STREAM) -> int:
        return self.store.append_batch(self.get_logid(name, stream_type), payloads)

    def ensure_checkpoint_log(self) -> int:
        """Create the reserved checkpoint-store log if absent; returns logid."""
        if not self.store.log_exists(CHECKPOINT_STORE_LOGID):
            try:
                self.store.create_log(CHECKPOINT_STORE_LOGID, LogAttrs())
            except Exception:
                pass  # raced with another creator
        return CHECKPOINT_STORE_LOGID
