"""ctypes binding for the native batch record decoder (engine/cpp/
jsondec.cpp): a whole appended batch of HStreamRecord payloads ->
columnar arrays in one C++ pass.

Feeds the server's JSON ingest (server/tasks._ingest_results): per-record
protobuf + Struct decode in Python costs ~8us/record — at changelog
rates that IS the query loop (SURVEY §7 "protobuf decode + key
dictionary off the critical path"). Falls back to None when no
toolchain is available; callers keep the pure-Python path.
"""

# A copy of hstream_tpu/common/jsondec.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import ctypes as C
import os
import threading
from typing import Any

import numpy as np

from hstream_tpu_torch.common.nativebuild import build_so

_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_DIR, "engine", "cpp", "jsondec.cpp")
SO = os.path.join(_DIR, "engine", "cpp", "libjsondec.so")

_lock = threading.Lock()
_lib: C.CDLL | None = None
_tried = False

_p_u8 = C.POINTER(C.c_uint8)
_p_i32 = C.POINTER(C.c_int32)
_p_i64 = C.POINTER(C.c_int64)
_p_f64 = C.POINTER(C.c_double)

# record classes (jsondec.cpp)
CLS_JSON = 0   # decoded into columns
CLS_RAW = 1    # RAW-flagged record: route by payload magic in Python
CLS_PY = 2     # Python fallback (nested values, type conflicts, bad bytes)


def load() -> C.CDLL | None:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = C.CDLL(build_so(SRC, SO, opt="-O3"))
        except Exception:
            return None
        lib.jd_scan.argtypes = [_p_u8, _p_i64, C.c_int64, _p_i64,
                                _p_i64, _p_u8]
        lib.jd_scan.restype = C.c_void_p
        lib.jd_ncols.argtypes = [C.c_void_p]
        lib.jd_ncols.restype = C.c_int64
        lib.jd_col_meta.argtypes = [C.c_void_p, C.c_int64, C.c_char_p,
                                    _p_i32, _p_i32, _p_i32, _p_i64]
        lib.jd_col_data.argtypes = [C.c_void_p, C.c_int64, _p_f64,
                                    _p_i32, _p_u8, _p_u8]
        lib.jd_dict_data.argtypes = [C.c_void_p, C.c_int64, _p_u8,
                                     _p_i32]
        lib.jd_free.argtypes = [C.c_void_p]
        _lib = lib
        return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctype)


def decode_batch(payloads: list[bytes], default_ts: np.ndarray):
    """Batch-decode appended record payloads.

    Returns (ts i64[n], cls u8[n], cols, nulls) where cols maps column
    name -> (kind, array, dict|None) in the decode_columnar shape
    (kinds: "f64" | "str" | "bool") and nulls maps name -> bool[n]
    missing/null mask. None when the native library is unavailable.
    Rows with cls != CLS_JSON have null entries in every column; the
    caller routes them to the Python path by class.
    """
    lib = load()
    if lib is None:
        return None
    n = len(payloads)
    offs = np.zeros(n + 1, np.int64)
    for i, p in enumerate(payloads):
        offs[i + 1] = offs[i] + len(p)
    buf = b"".join(payloads)
    ts = np.empty(n, np.int64)
    cls = np.empty(n, np.uint8)
    dts = np.ascontiguousarray(default_ts, np.int64)
    h = lib.jd_scan(C.cast(C.c_char_p(buf), _p_u8), _ptr(offs, _p_i64),
                    n, _ptr(dts, _p_i64), _ptr(ts, _p_i64),
                    _ptr(cls, _p_u8))
    try:
        cols: dict[str, Any] = {}
        nulls: dict[str, np.ndarray] = {}
        name_buf = C.create_string_buffer(256)
        name_len = C.c_int32()
        ctype = C.c_int32()
        ndict = C.c_int32()
        dict_bytes = C.c_int64()
        for i in range(lib.jd_ncols(h)):
            lib.jd_col_meta(h, i, name_buf, C.byref(name_len),
                            C.byref(ctype), C.byref(ndict),
                            C.byref(dict_bytes))
            name = name_buf.raw[:name_len.value].decode("utf-8",
                                                        "replace")
            t = ctype.value
            msk = np.empty(n, np.uint8)
            if t == 1:  # string
                sids = np.empty(n, np.int32)
                lib.jd_col_data(h, i, None, _ptr(sids, _p_i32), None,
                                _ptr(msk, _p_u8))
                nd = ndict.value
                concat = np.empty(max(dict_bytes.value, 1), np.uint8)
                lens = np.empty(max(nd, 1), np.int32)
                lib.jd_dict_data(h, i, _ptr(concat, _p_u8),
                                 _ptr(lens, _p_i32))
                d: list[str] = []
                off = 0
                raw = concat.tobytes()
                for j in range(nd):
                    ln = int(lens[j])
                    d.append(raw[off:off + ln].decode("utf-8", "replace"))
                    off += ln
                cols[name] = ("str", sids, d)
            elif t == 2:  # bool
                bools = np.empty(n, np.uint8)
                lib.jd_col_data(h, i, None, None, _ptr(bools, _p_u8),
                                _ptr(msk, _p_u8))
                cols[name] = ("bool", bools.astype(np.bool_), None)
            else:  # num, or -1 == all-null (shape as num)
                nums = np.empty(n, np.float64)
                lib.jd_col_data(h, i, _ptr(nums, _p_f64), None, None,
                                _ptr(msk, _p_u8))
                cols[name] = ("f64", nums, None)
            nulls[name] = msk.astype(np.bool_)
    finally:
        lib.jd_free(h)
    return ts, cls, cols, nulls
