"""The port's record plumbing against the JAX package's: the record codec
(common/records.py, common/idgen.py), the native JSON batch decoder
(common/jsondec.py over engine/cpp/jsondec.cpp, each package built from
its own source), the columnar codec and the framed append blocks
(common/columnar.py, common/colframe.py), and the protobuf messages
(proto/api_pb2.py), which both packages register in the one default
descriptor pool.

Every case feeds the same bytes, made from a numpy seed, to both
packages and wants the same result: equal messages, dicts, arrays,
dictionaries and record classes. The build of a native library is safe
across processes (common/nativebuild.py): the last case builds one from
two processes at once.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import shutil

import numpy as np
import pytest

import hstream_tpu.common as jcommon
from hstream_tpu.common import colframe as jframe
from hstream_tpu.common import columnar as jcol
from hstream_tpu.common import jsondec as jdec
from hstream_tpu.common import records as jrec
from hstream_tpu.common.errors import InvalidFrame as JInvalidFrame
from hstream_tpu.proto import api_pb2 as jpb

import hstream_tpu_torch.common as tcommon
from hstream_tpu_torch.common import colframe as tframe
from hstream_tpu_torch.common import columnar as tcol
from hstream_tpu_torch.common import jsondec as tdec
from hstream_tpu_torch.common import nativebuild
from hstream_tpu_torch.common import records as trec
from hstream_tpu_torch.common.errors import InvalidFrame as TInvalidFrame
from hstream_tpu_torch.proto import api_pb2 as tpb

from torch_native import build_reference_libs

T0 = 1_700_000_000_000


@pytest.fixture(scope="module", autouse=True)
def _reference_libs():
    build_reference_libs()


# ---- tests/test_common.py, through both packages ---------------------------

@pytest.mark.parametrize("m,pb", [(jcommon, jpb), (tcommon, tpb)],
                         ids=["ref", "port"])
def test_record_json_roundtrip(m, pb):
    rec = m.build_record({"temp": 25, "name": "dev1", "ok": True, "x": 1.5},
                         key="k1", attributes={"a": "b"},
                         publish_time_ms=T0)
    data = rec.SerializeToString()
    back = m.parse_record(data)
    assert back.header.flag == pb.RECORD_FLAG_JSON
    assert back.header.key == "k1"
    assert back.header.attributes["a"] == "b"
    assert back.header.publish_time_ms == T0
    d = m.record_to_dict(back)
    assert d == {"temp": 25, "name": "dev1", "ok": True, "x": 1.5}
    assert isinstance(d["temp"], int)  # integral floats decode to int
    other = jcommon if m is tcommon else tcommon
    assert other.build_record(
        {"temp": 25, "name": "dev1", "ok": True, "x": 1.5}, key="k1",
        attributes={"a": "b"}, publish_time_ms=T0).SerializeToString() \
        == data


@pytest.mark.parametrize("m,pb", [(jcommon, jpb), (tcommon, tpb)],
                         ids=["ref", "port"])
def test_record_raw(m, pb):
    rec = m.build_record(b"\x00\x01binary", publish_time_ms=T0)
    assert rec.header.flag == pb.RECORD_FLAG_RAW
    assert m.record_to_dict(rec) is None
    assert rec.payload == b"\x00\x01binary"


@pytest.mark.parametrize("m", [jcommon, tcommon], ids=["ref", "port"])
def test_flatten_json(m):
    assert m.flatten_json({"a": {"b": {"c": 1}, "d": 2}, "e": [1, 2]}) == {
        "a.b.c": 1, "a.d": 2, "e": [1, 2]}


@pytest.mark.parametrize("m", [jcommon, tcommon], ids=["ref", "port"])
def test_gen_unique(m):
    ids = [m.gen_unique() for _ in range(1000)]
    assert len(set(ids)) == 1000
    assert all(i > 0 for i in ids)


def test_the_common_packages_export_the_same_names():
    assert tcommon.__all__ == jcommon.__all__


def test_raw_splice_and_columnar_peek_match():
    """The framed append path's record bytes: wrap_raw_record splices a
    header around a columnar payload; both packages give the same bytes
    and find the same payload in them."""
    ts = T0 + np.arange(300, dtype=np.int64)
    rng = np.random.default_rng(3)
    cols = {"device": np.array([f"d{k}" for k in rng.integers(0, 9, 300)]),
            "temp": rng.normal(20, 5, 300).astype(np.float32)}
    payload = jcol.encode_columnar(ts, cols)
    assert tcol.encode_columnar(ts, cols) == payload
    wrapped = jrec.wrap_raw_record(payload, int(ts[-1]))
    assert trec.wrap_raw_record(payload, int(ts[-1])) == wrapped
    assert bytes(trec.peek_columnar_payload(wrapped)) == payload
    assert trec.peek_columnar_payload(
        trec.build_record({"a": 1}).SerializeToString()) is None
    whole = trec.build_columnar_record(ts, cols)
    assert whole.SerializeToString() == \
        jrec.build_columnar_record(ts, cols).SerializeToString()
    assert trec.record_bytes(whole) == jrec.record_bytes(whole)


# ---- the native JSON batch decoder ------------------------------------------

def json_payloads(seed: int, n: int) -> tuple[list[bytes], np.ndarray]:
    """Record bytes of every class the decoder knows: flat JSON rows
    (numbers, strings, bools, nulls, missing fields, a column whose type
    changes), nested and list values, RAW records (columnar and not),
    records without a publish time, and bad bytes."""
    rng = np.random.default_rng(seed)
    out: list[bytes] = []
    for i in range(n):
        kind = rng.integers(0, 20)
        t = int(T0 + rng.integers(0, 100_000))
        if kind == 0:
            out.append(jrec.build_record(
                {"device": "d1", "nested": {"a": 1}},
                publish_time_ms=t).SerializeToString())
        elif kind == 1:
            out.append(jrec.build_record(
                {"device": "d2", "arr": [1, 2]},
                publish_time_ms=t).SerializeToString())
        elif kind == 2:
            payload = jcol.encode_columnar(
                np.array([t], np.int64),
                {"temp": np.array([1.5], np.float32)})
            out.append(jrec.wrap_raw_record(payload, t))
        elif kind == 3:
            out.append(jrec.build_record(
                b"\x00opaque", publish_time_ms=t).SerializeToString())
        elif kind == 4:
            out.append(bytes(rng.integers(0, 256, 9).astype(np.uint8)))
        elif kind == 5:
            out.append(jrec.build_record(
                {"device": 7, "temp": "hot"},  # type conflicts
                publish_time_ms=t).SerializeToString())
        else:
            row = {"device": f"d{rng.integers(0, 40)}",
                   "temp": float(np.float32(rng.normal(20, 5))),
                   "ok": bool(rng.integers(0, 2))}
            if kind == 6:
                row["temp"] = None
            elif kind == 7:
                del row["ok"]
            elif kind == 8:
                row["count"] = int(rng.integers(-5, 5))
            rec = jrec.build_record(row, publish_time_ms=t)
            if kind == 9:
                rec.header.publish_time_ms = 0  # takes the default ts
            out.append(rec.SerializeToString())
    return out, T0 - 1 - np.arange(n, dtype=np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_jsondec_decode_batch_matches(seed):
    payloads, dts = json_payloads(seed, 400)
    want = jdec.decode_batch(payloads, dts)
    got = tdec.decode_batch(payloads, dts)
    assert want is not None and got is not None
    assert tdec.SO != jdec.SO and "hstream_tpu_torch" in tdec.SO
    (wts, wcls, wcols, wnulls), (gts, gcls, gcols, gnulls) = want, got
    np.testing.assert_array_equal(gts, wts)
    np.testing.assert_array_equal(gcls, wcls)
    assert set(np.unique(gcls)) == {tdec.CLS_JSON, tdec.CLS_RAW,
                                    tdec.CLS_PY}
    assert list(gcols) == list(wcols) and list(gnulls) == list(wnulls)
    for name in wcols:
        (wk, wa, wd), (gk, ga, gd) = wcols[name], gcols[name]
        assert (gk, gd) == (wk, wd), name
        np.testing.assert_array_equal(ga, wa)
        np.testing.assert_array_equal(gnulls[name], wnulls[name])
    # decoded JSON rows are the Python decode's
    sel = np.nonzero(gcls == tdec.CLS_JSON)[0]
    for i in sel[:50]:
        d = trec.record_to_dict(trec.parse_record(payloads[i]))
        for name, (kind, arr, dic) in gcols.items():
            if gnulls[name][i]:
                assert d.get(name) is None
            elif kind == "str":
                assert dic[arr[i]] == d[name]
            else:
                assert arr[i] == d[name]


def test_jsondec_builds_from_the_ports_own_source():
    assert tdec.SRC.endswith(os.path.join("hstream_tpu_torch", "engine",
                                          "cpp", "jsondec.cpp"))
    with open(tdec.SRC, "rb") as a, open(jdec.SRC, "rb") as b:
        assert a.read() == b.read()
    assert tdec.load() is not None and os.path.exists(tdec.SO)


# ---- columnar blocks and frames ---------------------------------------------

def columnar_case(seed: int):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 500))
    ts = T0 + np.sort(rng.integers(0, 10_000, n)).astype(np.int64)
    cols = {"device": [f"d{k}" for k in rng.integers(0, 30, n)],
            "temp": rng.normal(20, 5, n).astype(np.float32),
            "seq": rng.integers(-1 << 40, 1 << 40, n),
            "ok": rng.integers(0, 2, n).astype(np.bool_)}
    nulls = {"temp": rng.random(n) < 0.1, "device": rng.random(n) < 0.05}
    return ts, cols, nulls


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_columnar_and_frame_round_trips(seed):
    ts, cols, nulls = columnar_case(seed)
    payload = tcol.encode_columnar(ts, cols, nulls=nulls)
    assert payload == jcol.encode_columnar(ts, cols, nulls=nulls)
    frame = tframe.encode_frame(payload)
    assert frame == jframe.encode_frame(payload)
    view, n, last = tframe.open_block(frame)
    assert (n, last) == (len(ts), int(ts[-1])) == jframe.open_block(frame)[1:]
    gts, gcols, gnulls = tcol.decode_columnar_nulls(view)
    wts, wcols, wnulls = jcol.decode_columnar_nulls(payload)
    np.testing.assert_array_equal(gts, ts)
    np.testing.assert_array_equal(gts, wts)
    for name, (kind, arr, d) in wcols.items():
        gk, ga, gd = gcols[name]
        assert (gk, gd) == (kind, d)
        np.testing.assert_array_equal(ga, arr)
    for name in nulls:
        np.testing.assert_array_equal(gnulls[name], nulls[name])
        np.testing.assert_array_equal(gnulls[name], wnulls[name])
    assert tcol.to_rows(gts, gcols, gnulls, drop_null=True) == \
        jcol.to_rows(wts, wcols, wnulls, drop_null=True)


@pytest.mark.parametrize("cut", ["short", "magic", "version", "truncated",
                                 "crc"])
def test_bad_frames_are_refused_alike(cut):
    ts, cols, nulls = columnar_case(9)
    frame = bytearray(jframe.encode_frame(jcol.encode_columnar(ts, cols)))
    if cut == "short":
        frame = frame[:7]
    elif cut == "magic":
        frame[0] ^= 0xFF
    elif cut == "version":
        frame[4] = 9
    elif cut == "truncated":
        frame = frame[:-3]
    else:
        frame[-1] ^= 0x01
    with pytest.raises(JInvalidFrame) as want:
        jframe.open_block(bytes(frame))
    with pytest.raises(TInvalidFrame) as got:
        tframe.open_block(bytes(frame))
    assert str(got.value) == str(want.value)


# ---- protobuf messages ------------------------------------------------------

def test_both_api_pb2_modules_coexist_and_parse_each_others_bytes():
    assert tpb.DESCRIPTOR.serialized_pb == jpb.DESCRIPTOR.serialized_pb
    assert tpb.HStreamRecord is jpb.HStreamRecord  # one pool, one class
    rec = trec.build_record({"a": 1.5, "s": "x"}, key="k",
                            publish_time_ms=T0)
    back = jpb.HStreamRecord.FromString(rec.SerializeToString())
    assert jrec.record_to_dict(back) == {"a": 1.5, "s": "x"}
    req = jpb.AppendRequest(stream_name="s")
    req.records.append(rec)
    again = tpb.AppendRequest.FromString(req.SerializeToString())
    assert again == req and again.records[0].header.key == "k"


# ---- native builds from several processes -----------------------------------

def _build_and_load(src: str, so: str, q) -> None:
    import ctypes

    try:
        path = nativebuild.build_so(src, so, opt="-O0")
        ctypes.CDLL(path)
        q.put(("ok", os.getpid()))
    except Exception as e:  # noqa: BLE001 — reported to the parent
        q.put(("error", repr(e)))


def test_two_processes_build_one_library_at_once(tmp_path):
    """Test workers that build the same library at once each write a
    temporary file of their own and rename it over the library: each
    loads a whole file, and no temporary file is left behind."""
    src = str(tmp_path / "jsondec.cpp")
    shutil.copy(tdec.SRC, src)
    so = str(tmp_path / "libjsondec.so")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_build_and_load, args=(src, so, q))
             for _ in range(3)]
    for p in procs:
        p.start()
    got = [q.get(timeout=120) for _ in procs]
    for p in procs:
        p.join(30)
        assert not p.is_alive()
    assert [g[0] for g in got] == ["ok"] * 3, got
    assert os.path.exists(so)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
