"""Shared harness of the port's server parity tests: boot the JAX
package's server and the port's (on the CPU) side by side, send both the
same requests through each package's own stub, and compare the answers.

A `Side` holds one package's server, context, stub and modules. Rows
compare with ids and timestamps left out; keys, window bounds, counts and
HLL estimates exact, float SUM/AVG within rel 1e-6 (torch_parity's
bounds). Waits follow a task's readiness (`task.attached`) or poll a
condition under a deadline that fails the test with a message.
"""

from __future__ import annotations

import importlib
import threading
import time
from types import SimpleNamespace

import grpc
import numpy as np

from torch_parity import assert_rows_equal

BASE = 1_700_000_000_000
PACKAGES = ("hstream_tpu", "hstream_tpu_torch")


def modules(root: str) -> SimpleNamespace:
    """One package's server-facing modules."""
    imp = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return SimpleNamespace(
        root=root, pb=imp("proto.api_pb2"), rpc=imp("proto.rpc"),
        rec=imp("common.records"), columnar=imp("common.columnar"),
        errors=imp("common.errors"), main=imp("server.main"),
        tasks=imp("server.tasks"), context=imp("server.context"),
        store=imp("store"), producer=imp("client.producer"))


class Side:
    """One package's running server and a stub on it."""

    def __init__(self, root: str, uri: str = "mem://", **kw):
        self.m = modules(root)
        self.port_side = root == "hstream_tpu_torch"
        if self.port_side:
            kw.setdefault("device", "cpu")
        self.server, self.ctx = self.m.main.serve("127.0.0.1", 0, uri, **kw)
        self.addr = f"127.0.0.1:{self.ctx.port}"
        self.channel = grpc.insecure_channel(self.addr)
        self.stub = self.m.rpc.HStreamApiStub(self.channel)
        self.pb, self.rec = self.m.pb, self.m.rec

    def close(self) -> None:
        self.channel.close()
        self.server.stop(grace=1)
        self.ctx.shutdown()

    # ---- requests ------------------------------------------------------------

    def sql(self, text: str) -> list[dict]:
        resp = self.stub.ExecuteQuery(self.pb.CommandQuery(stmt_text=text))
        return [self.rec.struct_to_dict(s) for s in resp.result_set]

    def append(self, stream: str, rows, ts):
        req = self.pb.AppendRequest(stream_name=stream)
        for row, t in zip(rows, ts):
            req.records.append(self.rec.build_record(
                row, publish_time_ms=int(t)))
        return self.stub.Append(req)

    def append_columnar(self, stream: str, ts, cols):
        req = self.pb.AppendRequest(stream_name=stream)
        req.records.append(self.rec.build_columnar_record(
            np.asarray(ts, np.int64), cols))
        return self.stub.Append(req)

    def task(self, qid: str, timeout: float = 20.0):
        """The query's task once it is attached to its sources."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            task = self.ctx.running_queries.get(qid)
            if task is not None and task.attached.wait(0.05):
                return task
            if task is None:
                threading.Event().wait(0.01)
        raise AssertionError(
            f"{self.m.root}: query {qid!r} never attached "
            f"(running: {list(self.ctx.running_queries)})")

    def view_rows(self, view: str, pred, timeout: float = 30.0,
                  where: str = "") -> list[dict]:
        """The pull query's rows once `pred(rows)` holds."""
        return poll(lambda: self.sql(f"SELECT * FROM {view}{where};"),
                    pred, timeout, f"{self.m.root}: view {view}")


def has(col: str, value):
    """A pull-query predicate: a row whose `col` is `value` is served.
    Waiting on the row of a stream's last record (a closer in a later
    window) waits until every record before it was processed: the rows
    of a window still open come from the live peek and can be partial."""
    return lambda rows: any(r.get(col) == value for r in rows)


def poll(fetch, pred, timeout: float, what: str):
    """fetch() until pred(result) holds; fails the test at the
    deadline, naming `what` and the last result."""
    deadline = time.monotonic() + timeout
    pause = threading.Event()
    while True:
        got = fetch()
        if pred(got):
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: condition not met within "
                                 f"{timeout} s; last: {got!r}"[:2000])
        pause.wait(0.05)


class Pair:
    """The reference's server (`ref`) and the port's (`port`)."""

    def __init__(self, uri_ref: str = "mem://", uri_port: str = "mem://",
                 **kw):
        self.ref = Side("hstream_tpu", uri_ref, **kw)
        try:
            self.port = Side("hstream_tpu_torch", uri_port, **kw)
        except BaseException:
            self.ref.close()
            raise
        self.sides = (self.ref, self.port)

    def each(self, fn):
        """fn(side) on both sides; their results (ref, port)."""
        return tuple(fn(s) for s in self.sides)

    def close(self) -> None:
        for s in self.sides:
            s.close()


# ---- row comparison ----------------------------------------------------------

IDS = frozenset({"created_time_ms", "createdTime", "created", "id",
                 "query_id", "lsn", "batch_id", "batch_index"})


def strip(rows, drop=IDS):
    return [{k: v for k, v in r.items() if k not in drop} for r in rows]


def sort_key(cols):
    return lambda r: tuple(str(r.get(c)) for c in cols)


def same_rows(ref_rows, port_rows, cols=("winStart",), drop=IDS):
    """Both row sets equal after ids are dropped, ordered by `cols`
    (then by their whole content) on each side."""
    def order(rows):
        rows = strip(rows, drop)
        return sorted(rows, key=lambda r: (sort_key(cols)(r),
                                           repr(sorted(r.items()))))
    assert_rows_equal(order(ref_rows), order(port_rows))


def final_changes(rows, cols):
    """The last change of each (cols) group of a changelog, by group."""
    out = {}
    for r in rows:
        out[tuple(r.get(c) for c in cols)] = r
    return out


def same_finals(ref_rows, port_rows, cols):
    a, b = final_changes(ref_rows, cols), final_changes(port_rows, cols)
    assert set(a) == set(b), (sorted(a), sorted(b))
    keys = sorted(a, key=repr)
    assert_rows_equal([a[k] for k in keys], [b[k] for k in keys])


class PushConsumer:
    """Reads one push query's rows on a thread of its own."""

    def __init__(self, side: Side, sql: str):
        self.side, self.rows, self.error = side, [], None
        self.started = threading.Event()
        self._call = None
        self.thread = threading.Thread(target=self._run, args=(sql,),
                                       daemon=True)
        self.thread.start()

    def _run(self, sql):
        try:
            self._call = self.side.stub.ExecutePushQuery(
                self.side.pb.CommandPushQuery(query_text=sql))
            self.started.set()
            for s in self._call:
                self.rows.append(self.side.rec.struct_to_dict(s))
        except grpc.RpcError as e:
            if e.code() != grpc.StatusCode.CANCELLED:
                self.error = e
        finally:
            self.started.set()

    def wait_rows(self, pred, timeout=30.0):
        return poll(lambda: list(self.rows), pred, timeout,
                    f"{self.side.m.root}: push query")

    def cancel(self):
        if self._call is not None:
            self._call.cancel()
        self.thread.join(15)
