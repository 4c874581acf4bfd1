"""Query / connector metadata persistence.

The reference defines a `Persistence` typeclass with a ZooKeeper znode
tree (`/hstreamdb/hstream/{queries,connectors}/<id>/{sql,createdTime,
type,status}`) and an in-memory IORef instance selected by `--persistent`
(hstream/src/HStream/Server/Persistence.hs:115-256). Here the durable
instance rides the log store's metadata KV — the same KV the stream
namespace uses — so metadata durability follows the store backend
(mem:// = ephemeral, native disk store = durable) with no extra service.
"""

# A copy of hstream_tpu/server/persistence.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field

from hstream_tpu_torch.common.errors import ConnectorNotFound, QueryNotFound
from hstream_tpu_torch.store.api import LogStore


class TaskStatus:
    CREATING = 0
    CREATED = 1
    CREATION_ABORT = 2
    RUNNING = 3
    TERMINATED = 4
    CONNECTION_ABORT = 5
    # crash-loop breaker verdict (QuerySupervisor): K deaths in W
    # seconds — the query stays down until an operator RestartQuery.
    # Rides the wire as a raw value of the open proto3 TaskStatusPB
    # enum (no regenerated descriptor needed).
    FAILED = 6


# query types (reference PersistentQuery createdTime/queryType)
QUERY_PUSH = "push"          # ExecutePushQuery (temp sink, dies with client)
QUERY_STREAM = "stream"      # CREATE STREAM AS SELECT
QUERY_VIEW = "view"          # CREATE VIEW


@dataclass
class QueryInfo:
    query_id: str
    sql: str
    created_time_ms: int
    query_type: str = QUERY_PUSH
    status: int = TaskStatus.CREATED
    sink: str = ""             # sink stream / view name
    extra: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {"sql": self.sql, "createdTime": self.created_time_ms,
                "type": self.query_type, "status": self.status,
                "sink": self.sink, "extra": self.extra}

    @classmethod
    def from_json(cls, query_id: str, d: dict) -> "QueryInfo":
        return cls(query_id=query_id, sql=d["sql"],
                   created_time_ms=d["createdTime"], query_type=d["type"],
                   status=d["status"], sink=d.get("sink", ""),
                   extra=d.get("extra", {}))


@dataclass
class ConnectorInfo:
    connector_id: str
    sql: str                   # CREATE SINK CONNECTOR statement / config
    created_time_ms: int
    status: int = TaskStatus.CREATED

    def to_json(self) -> dict:
        return {"sql": self.sql, "createdTime": self.created_time_ms,
                "status": self.status}

    @classmethod
    def from_json(cls, connector_id: str, d: dict) -> "ConnectorInfo":
        return cls(connector_id=connector_id, sql=d["sql"],
                   created_time_ms=d["createdTime"], status=d["status"])


def now_ms() -> int:
    return int(time.time() * 1000)


class Persistence:
    """The metadata interface (reference Persistence.hs:115-130)."""

    # ---- queries ----
    def insert_query(self, info: QueryInfo) -> None:
        raise NotImplementedError

    def get_query(self, query_id: str) -> QueryInfo:
        raise NotImplementedError

    def get_queries(self) -> list[QueryInfo]:
        raise NotImplementedError

    def set_query_status(self, query_id: str, status: int) -> None:
        raise NotImplementedError

    def remove_query(self, query_id: str) -> None:
        raise NotImplementedError

    # ---- connectors ----
    def insert_connector(self, info: ConnectorInfo) -> None:
        raise NotImplementedError

    def get_connector(self, connector_id: str) -> ConnectorInfo:
        raise NotImplementedError

    def get_connectors(self) -> list[ConnectorInfo]:
        raise NotImplementedError

    def set_connector_status(self, connector_id: str, status: int) -> None:
        raise NotImplementedError

    def remove_connector(self, connector_id: str) -> None:
        raise NotImplementedError


class MemPersistence(Persistence):
    """In-memory instance (reference Persistence.hs:128-190)."""

    def __init__(self) -> None:
        self._queries: dict[str, QueryInfo] = {}
        self._connectors: dict[str, ConnectorInfo] = {}
        self._lock = threading.Lock()

    def insert_query(self, info: QueryInfo) -> None:
        with self._lock:
            self._queries[info.query_id] = info

    def get_query(self, query_id: str) -> QueryInfo:
        with self._lock:
            q = self._queries.get(query_id)
        if q is None:
            raise QueryNotFound(query_id)
        return q

    def get_queries(self) -> list[QueryInfo]:
        with self._lock:
            return list(self._queries.values())

    def set_query_status(self, query_id: str, status: int) -> None:
        self.get_query(query_id).status = status

    def remove_query(self, query_id: str) -> None:
        with self._lock:
            if self._queries.pop(query_id, None) is None:
                raise QueryNotFound(query_id)

    def insert_connector(self, info: ConnectorInfo) -> None:
        with self._lock:
            self._connectors[info.connector_id] = info

    def get_connector(self, connector_id: str) -> ConnectorInfo:
        with self._lock:
            c = self._connectors.get(connector_id)
        if c is None:
            raise ConnectorNotFound(connector_id)
        return c

    def get_connectors(self) -> list[ConnectorInfo]:
        with self._lock:
            return list(self._connectors.values())

    def set_connector_status(self, connector_id: str, status: int) -> None:
        self.get_connector(connector_id).status = status

    def remove_connector(self, connector_id: str) -> None:
        with self._lock:
            if self._connectors.pop(connector_id, None) is None:
                raise ConnectorNotFound(connector_id)


class StorePersistence(Persistence):
    """Durable instance over the log store's metadata KV — the analogue
    of the reference's ZooKeeper znode tree (Persistence.hs:197-256),
    with the same key shape `/hstream/queries/<id>`."""

    _QP = "/hstream/queries/"
    _CP = "/hstream/connectors/"

    def __init__(self, store: LogStore):
        self._store = store
        self._lock = threading.Lock()

    # ---- queries ----
    def insert_query(self, info: QueryInfo) -> None:
        self._store.meta_put(self._QP + info.query_id,
                             json.dumps(info.to_json()).encode())

    def get_query(self, query_id: str) -> QueryInfo:
        raw = self._store.meta_get(self._QP + query_id)
        if raw is None:
            raise QueryNotFound(query_id)
        return QueryInfo.from_json(query_id, json.loads(raw))

    def get_queries(self) -> list[QueryInfo]:
        out = []
        for key in self._store.meta_list(self._QP):
            qid = key[len(self._QP):]
            raw = self._store.meta_get(key)
            if raw is not None:
                out.append(QueryInfo.from_json(qid, json.loads(raw)))
        return out

    def set_query_status(self, query_id: str, status: int) -> None:
        with self._lock:
            info = self.get_query(query_id)
            info.status = status
            self.insert_query(info)

    def remove_query(self, query_id: str) -> None:
        if self._store.meta_get(self._QP + query_id) is None:
            raise QueryNotFound(query_id)
        self._store.meta_delete(self._QP + query_id)

    # ---- connectors ----
    def insert_connector(self, info: ConnectorInfo) -> None:
        self._store.meta_put(self._CP + info.connector_id,
                             json.dumps(info.to_json()).encode())

    def get_connector(self, connector_id: str) -> ConnectorInfo:
        raw = self._store.meta_get(self._CP + connector_id)
        if raw is None:
            raise ConnectorNotFound(connector_id)
        return ConnectorInfo.from_json(connector_id, json.loads(raw))

    def get_connectors(self) -> list[ConnectorInfo]:
        out = []
        for key in self._store.meta_list(self._CP):
            cid = key[len(self._CP):]
            raw = self._store.meta_get(key)
            if raw is not None:
                out.append(ConnectorInfo.from_json(cid, json.loads(raw)))
        return out

    def set_connector_status(self, connector_id: str, status: int) -> None:
        with self._lock:
            info = self.get_connector(connector_id)
            info.status = status
            self.insert_connector(info)

    def remove_connector(self, connector_id: str) -> None:
        if self._store.meta_get(self._CP + connector_id) is None:
            raise ConnectorNotFound(connector_id)
        self._store.meta_delete(self._CP + connector_id)
