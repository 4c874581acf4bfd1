"""ctypes binding of the kernels' C interface (csrc/hs_kernels.h).

The structures below mirror the header field for field (ctypes lays them
out with the same C alignment rules). `lib()` builds and loads the
library on first use; `check()` turns a launch's cudaError_t into an
exception, the counterpart of C10_CUDA_KERNEL_LAUNCH_CHECK for a library
bound without PyTorch's headers.
"""

from __future__ import annotations

import ctypes as C
import threading

import torch

MAX_STREAMS = 16
MAX_AGGS = 16

ENC_CODES = {"bp": 0, "bpd": 1, "bool1": 2, "dec": 3, "rawf": 4, "rawi": 5}
(AGG_COUNT_ALL, AGG_SUM, AGG_AVG, AGG_MIN, AGG_MAX, AGG_HLL, AGG_COUNT,
 AGG_QUANT, AGG_TOPK, AGG_TOPK_DISTINCT) = range(10)
CLOSE_EXTRACT_RESET, CLOSE_EXTRACT, CLOSE_RESET = range(3)  # close modes
SCATTER_GLOBAL, SCATTER_PRIVATE, SCATTER_CLUSTER = range(3)  # scatter modes
VTYPES = {torch.float32: 0, torch.int32: 1, torch.bool: 2}
EXPR_MAX_COLS = 16
EXPR_MAX_PROGS = MAX_AGGS + 1
EXPR_MAX_OPS = 256


class Stream(C.Structure):
    _fields_ = [("word_off", C.c_int64), ("enc", C.c_int32),
                ("bits", C.c_int32), ("base", C.c_int32),
                ("inv_scale", C.c_float), ("out", C.c_void_p)]


class DecodeArgs(C.Structure):
    _fields_ = [("words", C.c_void_p), ("cap", C.c_int32),
                ("n", C.c_int32), ("n_streams", C.c_int32),
                ("valid_stream", C.c_int32), ("delta_stream", C.c_int32),
                ("valid_out", C.c_void_p), ("block_sums", C.c_void_p),
                ("s", Stream * MAX_STREAMS)]


class ExprOp(C.Structure):
    _fields_ = [("op", C.c_int32), ("arg", C.c_int32)]


class ExprProg(C.Structure):
    _fields_ = [("first", C.c_int32), ("n_ops", C.c_int32),
                ("out_type", C.c_int32), ("where", C.c_int32),
                ("out", C.c_void_p)]


class ExprArgs(C.Structure):
    _fields_ = [("n", C.c_int32), ("n_cols", C.c_int32),
                ("n_progs", C.c_int32),
                ("col_type", C.c_int32 * EXPR_MAX_COLS),
                ("cols", C.c_void_p * EXPR_MAX_COLS),
                ("valid", C.c_void_p),
                ("progs", ExprProg * EXPR_MAX_PROGS),
                ("ops", ExprOp * EXPR_MAX_OPS)]


class ScatterAgg(C.Structure):
    _fields_ = [("kind", C.c_int32), ("vtype", C.c_int32),
                ("values", C.c_void_p), ("nulls", C.c_void_p),
                ("plane", C.c_void_p), ("plane_n", C.c_void_p),
                ("width", C.c_int32)]


class ScatterArgs(C.Structure):
    _fields_ = [("key", C.c_void_p), ("ts", C.c_void_p),
                ("valid", C.c_void_p), ("cap", C.c_int32),
                ("n_keys", C.c_int32), ("n_slots", C.c_int32),
                ("n_per", C.c_int32), ("advance", C.c_int32),
                ("size_grace", C.c_int32), ("watermark", C.c_int32),
                ("track_touched", C.c_int32), ("hll_p", C.c_int32),
                ("q_min", C.c_float), ("q_gamma", C.c_float),
                ("count", C.c_void_p), ("slot_start", C.c_void_p),
                ("touched", C.c_void_p), ("locks", C.c_void_p),
                ("mode", C.c_int32), ("blocks", C.c_int32),
                ("n_aggs", C.c_int32), ("a", ScatterAgg * MAX_AGGS)]


class CloseAgg(C.Structure):
    _fields_ = [("kind", C.c_int32), ("width", C.c_int32),
                ("plane_width", C.c_int32), ("init", C.c_float),
                ("q", C.c_float), ("plane", C.c_void_p),
                ("plane_n", C.c_void_p)]


class Finalize(C.Structure):
    _fields_ = [("hll_p", C.c_int32), ("hll_am2", C.c_float),
                ("q_min", C.c_float), ("q_gamma", C.c_float),
                ("q_half_gamma", C.c_float), ("n_aggs", C.c_int32),
                ("a", CloseAgg * MAX_AGGS)]


class CloseArgs(C.Structure):
    _fields_ = [("n_keys", C.c_int32), ("n_slots", C.c_int32),
                ("n_sel", C.c_int32), ("mode", C.c_int32),
                ("out_rows", C.c_int32), ("slot", C.c_int32),
                ("slots", C.c_void_p), ("count", C.c_void_p),
                ("slot_start", C.c_void_p), ("touched", C.c_void_p),
                ("out", C.c_void_p), ("done", C.c_void_p),
                ("f", Finalize)]


class UnpackArgs(C.Structure):
    _fields_ = [("packed", C.c_void_p), ("cap", C.c_int32),
                ("n_bool", C.c_int32), ("n_null", C.c_int32),
                ("valid", C.c_void_p),
                ("bool_row", C.c_int32 * EXPR_MAX_COLS),
                ("bool_out", C.c_void_p * EXPR_MAX_COLS),
                ("null_out", C.c_void_p * MAX_AGGS)]


class TouchedArgs(C.Structure):
    _fields_ = [("n_keys", C.c_int32), ("n_slots", C.c_int32),
                ("max_out", C.c_int32), ("out_rows", C.c_int32),
                ("count", C.c_void_p), ("slot_start", C.c_void_p),
                ("touched", C.c_void_p), ("out", C.c_void_p),
                ("block_counts", C.c_void_p), ("cells", C.c_void_p),
                ("f", Finalize)]


SESSION_SENT = 1 << 22
SESS_RECORD, SESS_SEGMENT = range(2)  # session fold modes


class SessPlane(C.Structure):
    _fields_ = [("kind", C.c_int32), ("width", C.c_int32),
                ("src", C.c_void_p), ("src_n", C.c_void_p),
                ("out", C.c_void_p), ("out_n", C.c_void_p),
                ("seg", C.c_void_p), ("seg_n", C.c_void_p),
                ("vtype", C.c_int32), ("null_bit", C.c_int32),
                ("values", C.c_void_p)]


class SessionArgs(C.Structure):
    _fields_ = [("cap", C.c_int32), ("nb", C.c_int32), ("mode", C.c_int32),
                ("gap", C.c_int32), ("close_cut", C.c_int32),
                ("delta", C.c_int32), ("hll_p", C.c_int32),
                ("q_min", C.c_float), ("q_gamma", C.c_float),
                ("code", C.c_void_p), ("t0", C.c_void_p),
                ("t1", C.c_void_p), ("b_code", C.c_void_p),
                ("b_t0", C.c_void_p), ("b_t1", C.c_void_p),
                ("b_flags", C.c_void_p), ("out_code", C.c_void_p),
                ("out_t0", C.c_void_p), ("out_t1", C.c_void_p),
                ("scratch", C.c_void_p), ("n_planes", C.c_int32),
                ("p", SessPlane * MAX_AGGS)]


class SessExtractArgs(C.Structure):
    _fields_ = [("cap", C.c_int32), ("n_sel", C.c_int32),
                ("slots", C.c_void_p), ("code", C.c_void_p),
                ("out", C.c_void_p), ("f", Finalize)]


JOIN_SENT = 1 << 22
JOIN_MAX_FEED = 16
JOIN_MAX_NULLS = 16
JOIN_MAX_REFS = 64
JOIN_PACK, JOIN_FEED = range(2)                      # probe modes
JOIN_SRC = {"m": 0, "o": 1, "both": 2, "both_o": 3}  # feed sources
JOIN_TAG = {"f32": 0, "i32": 1, "bool": 2}           # feed column types


class JoinRef(C.Structure):
    _fields_ = [("src", C.c_int32), ("jm", C.c_int32), ("jo", C.c_int32)]


class JoinFeedCol(C.Structure):
    _fields_ = [("ref", JoinRef), ("tag", C.c_int32), ("out", C.c_void_p)]


class JoinNull(C.Structure):
    _fields_ = [("first", C.c_int32), ("count", C.c_int32),
                ("out", C.c_void_p)]


class JoinProbeArgs(C.Structure):
    _fields_ = [("cap", C.c_int32), ("bcap", C.c_int32), ("n", C.c_int32),
                ("within", C.c_int32), ("cutoff", C.c_int32),
                ("match_cap", C.c_int32), ("mode", C.c_int32),
                ("n_cols_mine", C.c_int32), ("n_cols_other", C.c_int32),
                ("batch", C.c_void_p), ("o_code", C.c_void_p),
                ("o_ts", C.c_void_p), ("o_flags", C.c_void_p),
                ("o_cols", C.c_void_p), ("packed", C.c_void_p),
                ("ts_off", C.c_int32), ("kid", C.c_void_p),
                ("ts", C.c_void_p), ("valid", C.c_void_p),
                ("n_feed", C.c_int32),
                ("feed", JoinFeedCol * JOIN_MAX_FEED),
                ("n_nulls", C.c_int32), ("nulls", JoinNull * JOIN_MAX_NULLS),
                ("filter_first", C.c_int32), ("filter_count", C.c_int32),
                ("refs", JoinRef * JOIN_MAX_REFS), ("scratch", C.c_void_p)]


class JoinInsertArgs(C.Structure):
    _fields_ = [("cap", C.c_int32), ("bcap", C.c_int32), ("n", C.c_int32),
                ("n_cols", C.c_int32), ("code", C.c_void_p),
                ("ts", C.c_void_p), ("flags", C.c_void_p),
                ("cols", C.c_void_p), ("batch", C.c_void_p),
                ("out_code", C.c_void_p), ("out_ts", C.c_void_p),
                ("out_flags", C.c_void_p), ("out_cols", C.c_void_p)]


class JoinEvictSide(C.Structure):
    _fields_ = [("n_cols", C.c_int32), ("code", C.c_void_p),
                ("ts", C.c_void_p), ("flags", C.c_void_p),
                ("cols", C.c_void_p), ("out_code", C.c_void_p),
                ("out_ts", C.c_void_p), ("out_flags", C.c_void_p),
                ("out_cols", C.c_void_p)]


class JoinEvictArgs(C.Structure):
    _fields_ = [("cap", C.c_int32), ("cutoff", C.c_int32),
                ("delta", C.c_int32), ("s", JoinEvictSide * 2),
                ("n_out", C.c_void_p), ("scratch", C.c_void_p)]


_lock = threading.Lock()
_lib: C.CDLL | None = None


def lib() -> C.CDLL:
    """The kernel library, built (engine/kernels/build.py) on first use."""
    global _lib
    with _lock:
        if _lib is None:
            from hstream_tpu_torch.engine.kernels.build import build

            dll = C.CDLL(build().path)
            for fn, args in (("hs_decode", [C.POINTER(DecodeArgs)]),
                             ("hs_expr", [C.POINTER(ExprArgs)]),
                             ("hs_scatter", [C.POINTER(ScatterArgs)]),
                             ("hs_topk", [C.POINTER(ScatterArgs)]),
                             ("hs_close", [C.POINTER(CloseArgs)]),
                             ("hs_close_slot", [C.POINTER(CloseArgs)]),
                             ("hs_unpack", [C.POINTER(UnpackArgs)]),
                             ("hs_touched", [C.POINTER(TouchedArgs)]),
                             ("hs_session_step", [C.POINTER(SessionArgs)]),
                             ("hs_session_merge", [C.POINTER(SessionArgs)]),
                             ("hs_session_extract",
                              [C.POINTER(SessExtractArgs)]),
                             ("hs_join_probe", [C.POINTER(JoinProbeArgs)]),
                             ("hs_join_insert", [C.POINTER(JoinInsertArgs)]),
                             ("hs_join_evict", [C.POINTER(JoinEvictArgs)])):
                getattr(dll, fn).argtypes = args + [C.c_void_p]
                getattr(dll, fn).restype = C.c_int
            dll.hs_rebase.argtypes = [C.c_void_p, C.c_int32, C.c_int32,
                                      C.c_void_p]
            dll.hs_rebase.restype = C.c_int
            dll.hs_session_remap.argtypes = [C.c_void_p, C.c_int32,
                                             C.c_void_p, C.c_int32,
                                             C.c_int32, C.c_void_p]
            dll.hs_session_remap.restype = C.c_int
            dll.hs_session_scratch_bytes.argtypes = [C.c_int32, C.c_int32]
            dll.hs_session_scratch_bytes.restype = C.c_int64
            for fn in ("hs_join_probe_scratch_bytes",
                       "hs_join_evict_scratch_bytes"):
                getattr(dll, fn).argtypes = [C.c_int32]
                getattr(dll, fn).restype = C.c_int64
            dll.hs_touched_blocks.argtypes = [C.c_int32]
            dll.hs_touched_blocks.restype = C.c_int
            dll.hs_error_string.argtypes = [C.c_int]
            dll.hs_error_string.restype = C.c_char_p
            _lib = dll
        return _lib


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, kernel: str) -> None:
    if err != 0:
        msg = lib().hs_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({err})")


def ptr(t: torch.Tensor) -> int:
    """Device pointer of a contiguous CUDA tensor."""
    if not t.is_cuda or not t.is_contiguous():
        raise ValueError("kernel arguments must be contiguous CUDA tensors")
    return t.data_ptr()
