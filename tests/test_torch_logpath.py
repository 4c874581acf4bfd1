"""The durable-log path as a whole, small (chip_smoke.py phase 11 at 40
keys and a few hundred rows a batch): a producer appends columnar
records to a stream in the native segment store, a CheckpointedReader
reads them back, the columnar decoder and the glue the server's query
task runs (a key id per device string, dictionary ids to key ids) feed a
query from SQL text whose WHERE and aggregate inputs use the expression
unaries; at batch RESTART_AT the reader's checkpoint is written and the
query snapshotted, the store closed and reopened, the query restored and
the reader resumed from its checkpoint; then JSON records go through the
native batch decoder into the same query.

The JAX package's store, decoders and executor and the port's (on the
CPU: the kernels' plain versions) each run the whole path; closed rows
are compared with each other, with the port's uninterrupted run and with
numpy. Keys, window bounds, COUNT, MAX(ROUND) and MIN(CEIL) are exact;
SUM and AVG within the float32 order bound (2 n 2^-24 sum|term| for two
summation orders) plus each function's ULP bound per term
(test_torch_expr.ULP; the numpy terms are correctly rounded, so twice
it, against either side).
"""

from __future__ import annotations

import importlib
import random
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_expr import ULP
from torch_native import build_reference_libs

SQL = ("CREATE VIEW stats AS SELECT device, COUNT(*), "
       "SUM(LOG10(ABS(temp) + 1)), AVG(EXP(temp / 50)), MAX(ROUND(temp)), "
       "MIN(CEIL(temp)) FROM sensors WHERE SQRT(ABS(temp)) > 4.0 GROUP BY "
       "device, TUMBLING (INTERVAL 10 SECOND) GRACE BY INTERVAL 0 SECOND;")
AGGS = ("COUNT(*)", "SUM(LOG10(ABS(temp) + 1))", "AVG(EXP(temp / 50))",
        "MAX(ROUND(temp))", "MIN(CEIL(temp))")
T0 = 1_700_000_000_000
KEYS = 40
BLOCK = 128           # rows per columnar record
BLOCKS = 3            # records per batch (one append)
MS_PER_BATCH = 2000
BATCHES = 8           # the first window closes at batch 5
RESTART_AT = 3
JSON_BATCHES = 3      # the last one crosses the second window's end
JSON_ROWS = 150
JSON_MS = 1500        # stream ms per JSON batch


def _pkg(name: str) -> SimpleNamespace:
    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    return SimpleNamespace(
        name=name, store=mod("store"), rec=mod("common.records"),
        col=mod("common.columnar"), jsondec=mod("common.jsondec"),
        sql=mod("sql"), codegen=mod("sql.codegen"),
        snap=mod("engine.snapshot"),
        opts={"device": "cpu"} if name.endswith("_torch") else {})


REF, PORT = _pkg("hstream_tpu"), _pkg("hstream_tpu_torch")
NAMES = [f"d{k}" for k in range(KEYS)]


@pytest.fixture(scope="module", autouse=True)
def _reference_libs():
    build_reference_libs()


def stream(seed: int = 4):
    """Per columnar batch: (ts, device ids, temps); then per JSON batch
    (ts, device ids, temps). One-decimal temps in float32 from
    normal(10, 15): negatives, x.5 halves and sub-threshold values."""
    rng = np.random.default_rng(seed)

    def batch(t_lo: int, n: int, span: int):
        ts = t_lo + np.sort(rng.integers(0, span, n)).astype(np.int64)
        dev = rng.integers(0, KEYS, n).astype(np.int32)
        temp = (np.rint(rng.normal(10, 15, n) * 10).astype(np.float32)
                * np.float32(0.1))
        return ts, dev, temp

    cols = [batch(T0 + b * MS_PER_BATCH, BLOCK * BLOCKS, MS_PER_BATCH)
            for b in range(BATCHES)]
    jsons = [batch(T0 + BATCHES * MS_PER_BATCH + j * JSON_MS, JSON_ROWS,
                   JSON_MS) for j in range(JSON_BATCHES)]
    return cols, jsons


def append_all(pkg, root: str, cols, jsons) -> int:
    """The producer: columnar records (the framed append's RAW shape),
    then JSON records, each batch one append at a pinned time."""
    store = pkg.store.open_store(f"file://{root}")
    random.seed(7)
    sid = pkg.store.StreamApi(store).create_stream("sensors")
    for ts, dev, temp in cols:
        payloads = []
        for i in range(0, len(ts), BLOCK):
            sl = slice(i, i + BLOCK)
            block = pkg.col.encode_columnar(
                ts[sl], {"device": np.array(NAMES)[dev[sl]],
                         "temp": temp[sl]})
            payloads.append(pkg.rec.wrap_raw_record(block, int(ts[sl][-1])))
        store.append_batch(sid, payloads, append_time_ms=int(ts[-1]))
    for ts, dev, temp in jsons:
        store.append_batch(sid, [pkg.rec.build_record(
            {"device": NAMES[d], "temp": float(t)},
            publish_time_ms=int(s)).SerializeToString()
            for s, d, t in zip(ts, dev, temp)], append_time_ms=int(ts[-1]))
    store.close()
    return sid


def glue(ex, ts, cols, nulls):
    """The server's columnar dispatch (hstream_tpu/server/tasks.py
    _columnar_key_ids, _device_columns): device strings to key ids
    through the block's dictionary, temps to float32, NULL masks on."""
    kind, ids, names = cols["device"]
    assert kind == "str"
    lut = np.array([ex.key_id_for((s,)) for s in names], np.int32)
    temp = np.asarray(cols["temp"][1], np.float32)
    m = None if nulls is None else nulls.get("temp")
    return ex.process_columnar(
        lut[ids], ts, {"temp": temp},
        None if m is None or not m.any() else {"temp": m})


def run(pkg, root, sid, restart: bool) -> list[dict]:
    """Read the stream back into the query; with `restart`, snapshot at
    RESTART_AT, reopen the store, restore and resume."""
    plan = pkg.sql.stream_codegen(SQL).select
    sample = [{"device": "d0", "temp": 1.0}]

    def executor():
        return pkg.codegen.make_executor(plan, sample_rows=sample,
                                         initial_keys=64, **pkg.opts)

    def reader(store):
        r = pkg.store.CheckpointedReader(
            "stats", store.new_reader(),
            pkg.store.FileCheckpointStore(root + ".ckp.json"))
        r.set_timeout(0)
        r.start_reading_from_checkpoint(sid)
        return r

    store = pkg.store.open_store(f"file://{root}")
    rd, ex, rows = reader(store), executor(), []
    for b in range(BATCHES + JSON_BATCHES):
        if restart and b == RESTART_AT:
            rd.write_checkpoints({sid: lsn})
            blob = pkg.snap.seal_blob(pkg.snap.snapshot_executor(
                ex, {"lsn": lsn}))
            store.close()
            store = pkg.store.open_store(f"file://{root}")
            ex, extra = pkg.snap.restore_executor(
                plan, pkg.snap.open_blob(blob), **pkg.opts)
            assert extra == {"lsn": lsn}
            rd = reader(store)
        (got,) = rd.read(1)  # one append: the reader counts batches
        lsn = got.lsn
        if b < BATCHES:
            for p in got.payloads:
                v = pkg.rec.peek_columnar_payload(p)
                rows.extend(glue(ex, *pkg.col.decode_columnar_nulls(v)))
        else:
            dts = np.full(len(got.payloads), got.append_time_ms, np.int64)
            ts, cls, cols, nulls = pkg.jsondec.decode_batch(
                list(got.payloads), dts)
            assert (cls == pkg.jsondec.CLS_JSON).all()
            rows.extend(glue(ex, ts, cols, nulls))
    assert rd.read(1 << 20) == []
    store.close()
    return rows


def numpy_reference(cols, jsons) -> dict:
    """(device, winStart) -> (count, sum log10, sum exp, max rint, min
    ceil) of each window that closes (the last JSON batch crosses the
    second window's end: its earlier records still count)."""
    ts = np.concatenate([c[0] for c in cols + jsons])
    dev = np.concatenate([c[1] for c in cols + jsons])
    t = np.concatenate([c[2] for c in cols + jsons])
    closed = (int(ts.max()) - T0) // 10_000  # windows that end by then
    keep = np.sqrt(np.abs(t)) > np.float32(4.0)
    ts, dev, t = ts[keep], dev[keep], t[keep]
    lg = np.log10((np.abs(t) + np.float32(1)).astype(np.float64))
    ex = np.exp((t / np.float32(50)).astype(np.float64))
    win = (ts - T0) // 10_000
    out = {}
    for w in range(closed):
        for k in range(KEYS):
            s = (win == w) & (dev == k)
            if s.any():
                out[(NAMES[k], T0 + w * 10_000)] = (
                    int(s.sum()), lg[s].sum(), ex[s].sum(),
                    float(np.rint(t[s]).max()), float(np.ceil(t[s]).min()))
    return out


def by_cell(rows) -> dict:
    return {(r["device"], r["winStart"]): tuple(r[a] for a in AGGS)
            for r in rows}


def assert_close(got: dict, want: dict, rounding: float) -> None:
    """SUM and AVG within `rounding` x n 2^-24 x sum|term| (the order
    bound) plus the terms' ULP bounds; the rest exact."""
    assert sorted(got) == sorted(want)
    u = 2.0 ** -24
    for cell, (n, lg, ex_, mx, mn) in want.items():
        gn, glg, gavg, gmx, gmn = got[cell]
        assert (gn, gmx, gmn) == (n, mx, mn), cell
        tol = (rounding * n * u + 2 * ULP["LOG10"] * 2 * u) * lg
        assert abs(glg - lg) <= tol, (cell, glg, lg, tol)
        tol = (rounding * n * u + 2 * ULP["EXP"] * 2 * u) * ex_ / n
        assert abs(gavg - ex_ / n) <= tol, (cell, gavg, ex_ / n, tol)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cols, jsons = stream()
    out = {"ref": numpy_reference(cols, jsons)}
    for pkg in (REF, PORT):
        root = str(tmp_path_factory.mktemp(pkg.name) / "store")
        sid = append_all(pkg, root, cols, jsons)
        out[pkg.name] = run(pkg, root, sid, restart=True)
    root = str(tmp_path_factory.mktemp("plain") / "store")
    sid = append_all(PORT, root, cols, jsons)
    out["uninterrupted"] = run(PORT, root, sid, restart=False)
    return out


def test_closed_rows_match_numpy_in_both_packages(runs):
    want = runs["ref"]
    assert len({w for _, w in want}) == 2 and len(want) > KEYS
    for name in (REF.name, PORT.name, "uninterrupted"):
        rows = runs[name]
        assert all(r["winEnd"] - r["winStart"] == 10_000 for r in rows)
        assert_close(by_cell(rows), want, rounding=1.0)


def test_the_port_matches_the_reference_and_its_uninterrupted_run(runs):
    port = by_cell(runs[PORT.name])
    for other in (by_cell(runs[REF.name]), by_cell(runs["uninterrupted"])):
        assert sorted(port) == sorted(other)
        for cell, (n, lg, avg, mx, mn) in other.items():
            assert port[cell][0] == n and port[cell][3:] == (mx, mn)
            assert port[cell][1] == pytest.approx(lg, rel=2e-6 + n * 2**-23)
            assert port[cell][2] == pytest.approx(avg,
                                                  rel=2e-6 + n * 2**-23)
