"""The port's sink connectors (hstream_tpu_torch/connectors) against the
reference's (hstream_tpu/connectors), through each package's server.

Each case sends both servers (the port's on the CPU) the same requests:
a stream, a `CREATE SINK CONNECTOR ... (type = 'sqlite')` into a table of
its own database, then rows as JSON records or as a columnar record.
Both tables must hold the same rows, the rows that were appended; the
connector is listed and deleted alike. A `hstore` sink copies a stream
into another stream, read back through a pull of a view on each side.
Where the drivers the MySQL and ClickHouse sinks need are not installed,
both packages refuse those sinks with the same ServerError.
"""

from __future__ import annotations

import sqlite3

import grpc
import numpy as np
import pytest

from torch_server import BASE, Pair, poll


@pytest.fixture(scope="module")
def pair():
    p = Pair()
    yield p
    p.close()


def _table(path) -> list[tuple]:
    conn = sqlite3.connect(path)
    try:
        return conn.execute("SELECT a, b FROM t ORDER BY a, b").fetchall()
    finally:
        conn.close()


def _sink(side, tmp_path, name: str, stream: str):
    db = tmp_path / f"{side.m.root}-{name}.db"
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE t (a INTEGER, b TEXT)")
    conn.commit()
    conn.close()
    side.stub.CreateStream(side.pb.Stream(stream_name=stream))
    side.sql(f"CREATE SINK CONNECTOR {name} WITH (type = 'sqlite', "
             f"stream = '{stream}', path = '{db}', table = 't');")
    return db


def _drain(side, db, n: int, name: str) -> list[tuple]:
    return poll(lambda: _table(db), lambda rows: len(rows) == n, 20.0,
                f"{side.m.root}: sink {name}")


def test_sink_connector_sqlite(pair, tmp_path):
    """tests/test_server.py:243: JSON records into a sqlite table."""
    def run(side):
        db = _sink(side, tmp_path, "sc1", "csrc")
        side.append("csrc", [{"a": 1, "b": "x"}, {"a": 2, "b": "y"}],
                    [BASE, BASE + 1])
        rows = _drain(side, db, 2, "sc1")
        listed = [c.id for c in side.stub.ListConnectors(
            side.pb.ListConnectorsRequest()).connectors]
        side.stub.DeleteConnector(side.pb.DeleteConnectorRequest(id="sc1"))
        after = [c.id for c in side.stub.ListConnectors(
            side.pb.ListConnectorsRequest()).connectors]
        return rows, "sc1" in listed, "sc1" in after

    ref, port = pair.each(run)
    assert ref == port
    assert port == ([(1, "x"), (2, "y")], True, False)


def test_columnar_records_reach_connector_sink(pair, tmp_path):
    """tests/test_columnar_ingest.py:158: a columnar record's rows reach
    the sink too."""
    def run(side):
        db = _sink(side, tmp_path, "colsc", "colcsrc")
        side.append_columnar("colcsrc", [BASE, BASE + 1],
                             {"a": np.array([1, 2]), "b": ["x", "y"]})
        rows = _drain(side, db, 2, "colsc")
        side.stub.DeleteConnector(side.pb.DeleteConnectorRequest(id="colsc"))
        return rows

    ref, port = pair.each(run)
    assert ref == port == [(1, "x"), (2, "y")]


def test_sink_of_mixed_records_keeps_order_and_nulls(pair, tmp_path):
    """JSON and columnar records interleaved, a row without `b`: both
    tables hold the same rows, NULL where the column is missing."""
    def run(side):
        db = _sink(side, tmp_path, "mixsc", "mixsrc")
        side.append("mixsrc", [{"a": 5, "b": "j"}, {"a": 6}],
                    [BASE, BASE + 1])
        side.append_columnar("mixsrc", [BASE + 2, BASE + 3, BASE + 4],
                             {"a": np.array([7, 8, 9]),
                              "b": ["c1", "c2", "c3"]})
        rows = _drain(side, db, 5, "mixsc")
        side.stub.DeleteConnector(side.pb.DeleteConnectorRequest(id="mixsc"))
        return rows

    ref, port = pair.each(run)
    assert ref == port
    assert port == [(5, "j"), (6, None), (7, "c1"), (8, "c2"), (9, "c3")]


@pytest.mark.parametrize("kind", ["mysql", "clickhouse", "nosuch"])
def test_unavailable_sinks_refused_alike(pair, kind):
    """A sink whose driver is not installed (or an unknown type) is
    refused by both servers with the same status and message."""
    def run(side):
        side.stub.CreateStream(side.pb.Stream(stream_name=f"u{kind}"))
        with pytest.raises(grpc.RpcError) as ei:
            side.sql(f"CREATE SINK CONNECTOR u{kind} WITH (type = "
                     f"'{kind}', stream = 'u{kind}', database = 'd', "
                     f"table = 't');")
        return ei.value.code(), ei.value.details()

    ref, port = pair.each(run)
    assert ref == port, (ref, port)


def test_hstore_sink_copies_a_stream(pair):
    """type = 'hstore': every record of the source lands in the target
    stream, which a view counts alike on both sides."""
    def run(side):
        side.stub.CreateStream(side.pb.Stream(stream_name="hsrc"))
        side.stub.CreateStream(side.pb.Stream(stream_name="hdst"))
        side.sql("CREATE VIEW hview AS SELECT k, COUNT(*) AS c FROM hdst "
                 "GROUP BY k, TUMBLING (INTERVAL 10 SECOND) "
                 "GRACE BY INTERVAL 0 SECOND;")
        side.task("view-hview")
        side.sql("CREATE SINK CONNECTOR hsc WITH (type = 'hstore', "
                 "stream = 'hsrc', target = 'hdst');")
        side.append("hsrc", [{"k": "a"}, {"k": "b"}, {"k": "a"}],
                    [BASE, BASE + 1, BASE + 2])
        rows = side.view_rows("hview", lambda rs: sum(
            r.get("c", 0) for r in rs) == 3)
        side.stub.DeleteConnector(side.pb.DeleteConnectorRequest(id="hsc"))
        return sorted((r["k"], r["c"]) for r in rows)

    ref, port = pair.each(run)
    assert ref == port == [("a", 2), ("b", 1)]
