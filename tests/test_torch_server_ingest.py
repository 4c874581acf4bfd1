"""Columnar ingest and checkpoint/resume through the port's server
against the reference's: tests/test_columnar_ingest.py's view cases
(columnar records through Append, the framed blocks of the port's
`client.producer.encode_batch` through AppendColumnar and
AppendColumnarStream), and tests/test_checkpoint_resume.py's server
cases (a crashed task restarted, a graceful server restart and a crashed
server restarted over the same `file://` store), each run on both
servers and compared with an uninterrupted run's rows."""

import numpy as np
import pytest

from torch_server import BASE, Pair, Side, has, poll, same_rows

VIEW = ("CREATE VIEW {v} AS SELECT {k}, COUNT(*) AS c{extra} FROM {src} "
        "{where}GROUP BY {k}, TUMBLING (INTERVAL 10 SECOND) "
        "GRACE BY INTERVAL 0 SECOND;")


@pytest.fixture(scope="module")
def pair():
    p = Pair()
    yield p
    p.close()


def _view(s, v, src, k="k", extra="", where=""):
    s.stub.CreateStream(s.pb.Stream(stream_name=src))
    s.sql(VIEW.format(v=v, k=k, extra=extra, src=src, where=where))
    return s.task(f"view-{v}")


def _closed(rows):
    return [r for r in rows if r.get("winStart") == BASE]


def test_columnar_append_through_view(pair):
    n = 1000
    ts = np.sort(BASE + np.arange(n, dtype=np.int64) % 5000)
    devs = [f"d{i % 4}" for i in range(n)]
    temps = np.where(np.arange(n) % 10 == 0, -1.0,
                     (np.arange(n) % 17) * 0.25 + 0.5).astype(np.float32)

    def run(s):
        _view(s, "colview", "colsrc", k="device",
              extra=", SUM(temp) AS s, AVG(temp) AS a",
              where="WHERE temp > 0 ")
        s.append_columnar("colsrc", ts, {"device": devs, "temp": temps})
        s.append_columnar("colsrc", [BASE + 30_000],
                          {"device": ["zz"],
                           "temp": np.array([1.0], np.float32)})
        return s.view_rows("colview", has("device", "zz"))

    ref, port = pair.each(run)
    same_rows(_closed(ref), _closed(port), cols=("device",))
    exp = {f"d{k}": sum(1 for i in range(n) if i % 4 == k and i % 10)
           for k in range(4)}
    assert {r["device"]: r["c"] for r in _closed(port)} == exp


def test_columnar_mixed_with_json_records(pair):
    def run(s):
        _view(s, "mixview", "mixsrc")
        s.append("mixsrc", [{"k": "a"}], [BASE])
        s.append_columnar("mixsrc", [BASE + 1, BASE + 2], {"k": ["a", "b"]})
        s.append("mixsrc", [{"k": "b"}], [BASE + 3])
        s.append_columnar("mixsrc", [BASE + 30_000], {"k": ["zz"]})
        return s.view_rows("mixview", has("k", "zz"))

    ref, port = pair.each(run)
    same_rows(_closed(ref), _closed(port), cols=("k",))


def test_malformed_columnar_record_is_skipped(pair):
    def run(s):
        task = _view(s, "badview", "badsrc")
        req = s.pb.AppendRequest(stream_name="badsrc")
        req.records.append(s.rec.build_record(s.m.columnar.MAGIC))
        req.records.append(s.rec.build_record(
            s.m.columnar.MAGIC + b"\xff\xff\xff\xff garbage"))
        s.stub.Append(req)
        s.append_columnar("badsrc", [BASE, BASE + 30_000], {"k": ["a", "zz"]})
        rows = s.view_rows("badview", has("k", "zz"))
        return rows, task.is_alive()

    (ref, ref_alive), (port, port_alive) = pair.each(run)
    assert ref_alive and port_alive
    same_rows(_closed(ref), _closed(port), cols=("k",))


def test_float_group_key_consistent_across_formats(pair):
    def run(s):
        _view(s, "fkeyv", "fkey", k="g")
        s.append("fkey", [{"g": 20.1}], [BASE])
        s.append_columnar("fkey", [BASE + 1],
                          {"g": np.array([20.1], np.float32)})
        s.append_columnar("fkey", [BASE + 30_000],
                          {"g": np.array([0.0], np.float32)})
        return s.view_rows("fkeyv", lambda rs: any(
            r["g"] == 0.0 and r["winStart"] > BASE for r in rs))

    ref, port = pair.each(run)
    same_rows(_closed(ref), _closed(port), cols=("g",))
    assert len(_closed(port)) == 1


def test_columnar_numeric_group_key(pair):
    def run(s):
        _view(s, "numcolv", "numcol", k="sensor")
        s.append_columnar("numcol", BASE + np.arange(6, dtype=np.int64),
                          {"sensor": np.array([1, 2, 1, 3, 2, 1])})
        s.append_columnar("numcol", [BASE + 30_000],
                          {"sensor": np.array([9])})
        return s.view_rows("numcolv", has("sensor", 9))

    ref, port = pair.each(run)
    same_rows(_closed(ref), _closed(port), cols=("sensor",))
    assert {r["sensor"]: r["c"] for r in _closed(port)} == {1: 3, 2: 2, 3: 1}


@pytest.mark.parametrize("rpc", ["unary", "stream"])
def test_framed_blocks_through_append_columnar(pair, rpc):
    """The framed blocks of the port's producer (encode_batch, the bytes
    are the reference's) through AppendColumnar or AppendColumnarStream:
    the same record ids' shape, rows and view on both servers, with a
    NULL mask on some temps."""
    rng = np.random.default_rng(7)
    blocks = []
    for b in range(6):
        n = 200
        ts = BASE + b * 2500 + np.sort(rng.integers(0, 2500, n))
        cols = {"device": np.array([f"d{i}" for i in
                                    rng.integers(0, 12, n)], object),
                "temp": np.round(rng.normal(20, 5, n), 1).astype(
                    np.float32)}
        nulls = {"temp": rng.random(n) < 0.1}
        blocks.append((ts, cols, nulls))
    blocks.append((np.array([BASE + 40_000]),
                   {"device": np.array(["zz"], object),
                    "temp": np.array([0.0], np.float32)}, None))
    v, src = f"fv_{rpc}", f"fsrc_{rpc}"

    def run(s):
        _view(s, v, src, k="device", extra=", SUM(temp) AS s, "
              "COUNT(temp) AS n, APPROX_COUNT_DISTINCT(temp) AS d")
        producer = s.m.producer.ColumnarProducer(s.channel, src)
        frames = [s.m.producer.encode_batch(*b) for b in blocks]
        if rpc == "unary":
            resp = [producer.append_frames([f]) for f in frames]
            ids = [len(r.record_ids) for r in resp]
            rows = [r.rows for r in resp]
        else:
            resp = producer.append_stream_frames(iter(frames))
            ids, rows = [len(resp.record_ids)], [resp.rows]
        got = s.view_rows(v, has("device", "zz"))
        return ids, rows, [r for r in got if r["device"] != "zz"]

    ref, port = pair.each(run)
    assert port[:2] == ref[:2]
    same_rows(ref[2], port[2], cols=("winStart", "device"))


def test_producer_encode_batch_matches_the_reference():
    """The port's encode_batch writes the reference's bytes."""
    from hstream_tpu.client.producer import encode_batch as ref_encode
    from hstream_tpu_torch.client.producer import encode_batch

    ts = BASE + np.arange(5, dtype=np.int64)
    cols = {"k": ["a", "b", "a", "c", "b"],
            "v": np.arange(5, dtype=np.float32) * 1.5,
            "n": np.arange(5), "ok": np.arange(5) % 2 == 0}
    nulls = {"v": np.array([0, 1, 0, 0, 1], bool)}
    for kind in ("f32", "f64"):
        assert encode_batch(ts, cols, nulls, float_kind=kind) == \
            ref_encode(ts, cols, nulls, float_kind=kind)


# ---- checkpoint / resume ----------------------------------------------------

def _snapshotted(s, qid):
    return s.ctx.store.meta_get(s.m.tasks.snapshot_key(qid)) is not None


def _kill_restart_flow(s, *, stream, view, restart):
    """Ingest A -> a snapshot covering it -> ingest A2 past the snapshot
    -> crash -> restart -> ingest B; the closed window must hold every
    contribution exactly once. Returns the closed rows."""
    qid = f"view-{view}"
    task = _view(s, view, stream, k="city")
    task.snapshot_interval_ms = 50
    s.append(stream, [{"city": "sf"}, {"city": "sf"}, {"city": "la"}],
             [BASE, BASE + 10, BASE + 20])
    poll(lambda: _snapshotted(s, qid) and s.sql(f"SELECT * FROM {view};"),
         lambda rs: rs and any(r["c"] == 2 for r in rs), 20,
         f"{s.m.root}: snapshot covering A")
    task.snapshot_interval_ms = 10 ** 9
    s.append(stream, [{"city": "sf"}], [BASE + 30])
    s.view_rows(view, lambda rs: any(r["c"] == 3 for r in rs))
    task.stop(crash=True)
    s = restart(s, qid)
    s.task(qid)
    s.append(stream, [{"city": "sf"}], [BASE + 40])
    s.append(stream, [{"city": "zz"}], [BASE + 30_000])
    return s, _closed(s.view_rows(view, has("city", "zz")))


def _restart_query(s, qid):
    s.stub.RestartQuery(s.pb.RestartQueryRequest(id=qid))
    return s


def test_kill_restart_query_task_mem(pair):
    def run(s):
        tasks = s.m.tasks.QueryTask
        tasks.snapshot_interval_ms = 50
        try:
            _, rows = _kill_restart_flow(s, stream="krs", view="krv",
                                         restart=_restart_query)
        finally:
            tasks.snapshot_interval_ms = 1000
        return rows

    ref, port = pair.each(run)
    same_rows(ref, port, cols=("city",))
    assert {r["city"]: r["c"] for r in port} == {"sf": 4, "la": 1}


def test_clean_restart_server_native(tmp_path):
    """A graceful server restart (shutdown detaches: a final snapshot,
    status left RUNNING) over the same file:// store resumes the view,
    on both servers alike."""
    out = []
    for root in ("hstream_tpu", "hstream_tpu_torch"):
        uri = "file://" + str(tmp_path / root)
        s = Side(root, uri)
        try:
            _view(s, "crv", "crs", k="city")
            s.append("crs", [{"city": "sf"}, {"city": "la"}],
                     [BASE, BASE + 10])
            s.view_rows("crv", lambda rs: len(rs) >= 2)
        finally:
            s.close()
        s = Side(root, uri)
        try:
            s.task("view-crv")
            s.append("crs", [{"city": "zz"}], [BASE + 30_000])
            out.append(_closed(s.view_rows("crv", has("city", "zz"))))
        finally:
            s.close()
    same_rows(*out, cols=("city",))
    assert {r["city"]: r["c"] for r in out[1]} == {"sf": 1, "la": 1}


def test_kill_restart_server_native(tmp_path):
    """Crash the task, then restart the whole server over the same
    file:// store: the boot resumes the view from its snapshot, and its
    rows continue exactly as an uninterrupted run's."""
    out = []
    for root in ("hstream_tpu", "hstream_tpu_torch"):
        uri = "file://" + str(tmp_path / root)
        box = {"s": Side(root, uri)}
        tasks = box["s"].m.tasks.QueryTask

        def restart(s, qid):
            s.close()
            box["s"] = Side(root, uri)
            return box["s"]

        tasks.snapshot_interval_ms = 50
        try:
            _s, rows = _kill_restart_flow(box["s"], stream="nks",
                                          view="nkv", restart=restart)
            out.append(rows)
        finally:
            tasks.snapshot_interval_ms = 1000
            box["s"].close()
    # the uninterrupted run: the same records into one view
    s = Side("hstream_tpu_torch")
    try:
        _view(s, "unv", "uns", k="city")
        s.append("uns", [{"city": "sf"}, {"city": "sf"}, {"city": "la"},
                         {"city": "sf"}, {"city": "sf"}],
                 [BASE, BASE + 10, BASE + 20, BASE + 30, BASE + 40])
        s.append("uns", [{"city": "zz"}], [BASE + 30_000])
        whole = _closed(s.view_rows("unv", has("city", "zz")))
    finally:
        s.close()
    same_rows(out[0], out[1], cols=("city",))
    same_rows(whole, out[1], cols=("city",))
