"""Connectors: move records between streams and external systems.

Reference surface (hstream-connector):
  * hstoreSourceConnector / hstoreSinkConnector — records in/out of
    streams via checkpointed readers and appends (HStore.hs:119-163)
  * mysqlSinkConnector / clickHouseSinkConnector — flatten the JSON
    payload and issue `INSERT INTO table (cols) VALUES (...)`
    (MySQL.hs:38-48, ClickHouse.hs:36-48)

The source side of hstore is the query-task reader loop
(server/tasks.py); this module provides the SINK side plus the managed
connector task. The relational sink contract (flatten -> INSERT) is
implemented over DB-API so sqlite (stdlib, used in tests) and MySQL /
ClickHouse (optional drivers) share one code path.
"""

# A copy of hstream_tpu/connectors/__init__.py; the port imports
# nothing of the JAX package.

from __future__ import annotations

import threading
import traceback
from typing import Any, Mapping

from hstream_tpu_torch.common import columnar
from hstream_tpu_torch.common import records as rec
from hstream_tpu_torch.common.errors import ServerError
from hstream_tpu_torch.common.logger import get_logger
from hstream_tpu_torch.common.records import flatten_json
from hstream_tpu_torch.server.persistence import TaskStatus
from hstream_tpu_torch.store.api import LSN_MIN, DataBatch
from hstream_tpu_torch.store.checkpoint import CheckpointedReader
from hstream_tpu_torch.store.streams import StreamType

log = get_logger("connectors")


class SinkConnector:
    """writeRecord analogue (Connector.hs:24-38)."""

    def write_records(self, rows: list[Mapping[str, Any]]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class HStoreSinkConnector(SinkConnector):
    """Sink into another stream (HStore.hs:152-163)."""

    def __init__(self, ctx, target_stream: str):
        self.ctx = ctx
        self.logid = ctx.streams.get_logid(target_stream,
                                           StreamType.STREAM)

    def write_records(self, rows: list[Mapping[str, Any]]) -> None:
        payloads = [rec.build_record(dict(r)).SerializeToString()
                    for r in rows]
        self.ctx.store.append_batch(self.logid, payloads)


class DbApiSinkConnector(SinkConnector):
    """Relational sink over a DB-API connection: flatten nested JSON to
    columns and INSERT (the MySQL.hs:38-48 contract)."""

    def __init__(self, conn, table: str, *, paramstyle: str = "qmark"):
        self.conn = conn
        self.table = table
        self.mark = "?" if paramstyle == "qmark" else "%s"
        self._lock = threading.Lock()

    def write_records(self, rows: list[Mapping[str, Any]]) -> None:
        with self._lock:
            cur = self.conn.cursor()
            for row in rows:
                flat = flatten_json(row)
                cols = ", ".join(f'"{c}"' for c in flat)
                marks = ", ".join([self.mark] * len(flat))
                cur.execute(
                    f'INSERT INTO {self.table} ({cols}) VALUES ({marks})',
                    tuple(flat.values()))
            self.conn.commit()

    def close(self) -> None:
        self.conn.close()


def sqlite_sink(path: str, table: str) -> DbApiSinkConnector:
    import sqlite3

    conn = sqlite3.connect(path, check_same_thread=False)
    return DbApiSinkConnector(conn, table, paramstyle="qmark")


def mysql_sink(options: Mapping[str, Any]) -> DbApiSinkConnector:
    try:
        import pymysql  # type: ignore[import-not-found]
    except ImportError as e:
        raise ServerError(
            "MySQL sink requires the pymysql driver, which is not "
            "installed in this environment") from e
    conn = pymysql.connect(
        host=options.get("HOST", "127.0.0.1"),
        port=int(options.get("PORT", 3306)),
        user=options.get("USER", "root"),
        password=str(options.get("PASSWORD", "")),
        database=options["DATABASE"])
    return DbApiSinkConnector(conn, options["TABLE"], paramstyle="format")


def clickhouse_sink(options: Mapping[str, Any]) -> DbApiSinkConnector:
    try:
        from clickhouse_driver import dbapi  # type: ignore[import-not-found]
    except ImportError as e:
        raise ServerError(
            "ClickHouse sink requires clickhouse-driver, which is not "
            "installed in this environment") from e
    conn = dbapi.connect(
        host=options.get("HOST", "127.0.0.1"),
        port=int(options.get("PORT", 9000)),
        user=options.get("USER", "default"),
        password=str(options.get("PASSWORD", "")),
        database=options.get("DATABASE", "default"))
    return DbApiSinkConnector(conn, options["TABLE"], paramstyle="format")


def make_sink(ctx, options: Mapping[str, Any]) -> SinkConnector:
    """Build a sink from CREATE SINK CONNECTOR ... WITH (...) options."""
    kind = str(options.get("TYPE", "")).lower()
    if kind == "hstore":
        return HStoreSinkConnector(ctx, options["TARGET"])
    if kind == "sqlite":
        return sqlite_sink(options["PATH"], options["TABLE"])
    if kind == "mysql":
        return mysql_sink(options)
    if kind == "clickhouse":
        return clickhouse_sink(options)
    raise ServerError(f"unknown connector type {kind!r} (supported: "
                      "hstore, sqlite, mysql, clickhouse)")


class ConnectorTask(threading.Thread):
    """Managed connector: checkpointed reader on the source stream ->
    sink.write_records (the reference forks these exactly like query
    threads, Handler/Common.hs:195-207)."""

    def __init__(self, ctx, connector_id: str, source_stream: str,
                 sink: SinkConnector):
        super().__init__(name=f"connector-{connector_id}", daemon=True)
        self.ctx = ctx
        self.connector_id = connector_id
        self.source_stream = source_stream
        self.sink = sink
        self.error: BaseException | None = None
        self._stop_ev = threading.Event()
        self.logid = ctx.streams.get_logid(source_stream)

    def stop(self, timeout: float = 10.0) -> None:
        self._stop_ev.set()
        if self.is_alive():
            self.join(timeout)

    def run(self) -> None:
        ctx = self.ctx
        try:
            reader = CheckpointedReader(
                f"connector-{self.connector_id}",
                ctx.store.new_reader(), ctx.ckp_store)
            reader.set_timeout(50)
            reader.start_reading_from_checkpoint(self.logid, LSN_MIN)
            ctx.persistence.set_connector_status(self.connector_id,
                                                 TaskStatus.RUNNING)
            flow = getattr(ctx, "flow", None)
            while not self._stop_ev.is_set():
                if flow is not None and flow.active:
                    # connectors are background work: shed this cycle
                    # under overload (DEFER and above) and give the
                    # host back to user traffic
                    wait = flow.admit_background("connector")
                    if wait > 0.0:
                        if self._stop_ev.wait(min(wait, 1.0)):
                            break
                        continue
                results = reader.read(256)
                if not results:
                    continue
                last = 0
                rows = []
                for r in results:
                    if isinstance(r, DataBatch):
                        for payload in r.payloads:
                            pr = rec.parse_record(payload)
                            if pr.header.flag == rec.pb.RECORD_FLAG_RAW:
                                # columnar producer batches flow to
                                # sinks too (same decode as query tasks)
                                crows = columnar.payload_rows(pr.payload)
                                if crows:
                                    rows.extend(crows)
                                elif columnar.is_columnar(pr.payload):
                                    log.warning(
                                        "connector %s: skipping "
                                        "malformed columnar record",
                                        self.connector_id)
                                continue
                            d = rec.record_to_dict(pr)
                            if d is not None:
                                rows.append(d)
                        last = max(last, r.lsn)
                    else:
                        last = max(last, r.hi_lsn)
                if rows:
                    self.sink.write_records(rows)
                reader.write_checkpoints({self.logid: last})
            ctx.persistence.set_connector_status(self.connector_id,
                                                 TaskStatus.TERMINATED)
        except BaseException as e:  # noqa: BLE001
            self.error = e
            log.error("connector %s died: %s\n%s", self.connector_id, e,
                      traceback.format_exc())
            try:
                ctx.persistence.set_connector_status(
                    self.connector_id, TaskStatus.CONNECTION_ABORT)
            except Exception:
                pass
        finally:
            self.sink.close()
            self.ctx.running_connectors.pop(self.connector_id, None)
