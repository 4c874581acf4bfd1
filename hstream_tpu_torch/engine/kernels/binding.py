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

MAX_AGGS = 64      # aggregates of one query (HS_MAX_AGGS)
MAX_COLS = 64      # distinct input columns of one query (HS_MAX_COLS)
MAX_STREAMS = 3 + MAX_COLS + MAX_AGGS   # key, ts, __valid, columns, NULLs

ENC_CODES = {"bp": 0, "bpd": 1, "bool1": 2, "dec": 3, "rawf": 4, "rawi": 5}
(AGG_COUNT_ALL, AGG_SUM, AGG_AVG, AGG_MIN, AGG_MAX, AGG_HLL, AGG_COUNT,
 AGG_QUANT, AGG_TOPK, AGG_TOPK_DISTINCT) = range(10)
CLOSE_EXTRACT_RESET, CLOSE_EXTRACT, CLOSE_RESET = range(3)  # close modes
SCATTER_GLOBAL, SCATTER_PRIVATE, SCATTER_CLUSTER = range(3)  # scatter modes
TOPK_GLOBAL, TOPK_PRIVATE = range(2)  # top-k modes
TOPK_PRIVATE_THREADS, TOPK_GLOBAL_THREADS, TOPK_PER = 1024, 256, 4
DECODE_THREADS, DECODE_PER = 256, 4   # the wire decode's blocks
VTYPES = {torch.float32: 0, torch.int32: 1, torch.bool: 2}
EXPR_MAX_COLS = MAX_COLS   # one argument block's tables (launch_plan
EXPR_MAX_PROGS = 17        # splits a program set past them)
EXPR_MAX_OPS = 256   # instructions of a block
EXPR_MAX_SLOTS = 15  # spill slots a program may use (shared memory)
EXPR_PER = 8         # consecutive records a thread of the expression kernel


class Stream(C.Structure):
    _fields_ = [("word_off", C.c_int64), ("enc", C.c_int32),
                ("bits", C.c_int32), ("base", C.c_int32),
                ("inv_scale", C.c_float), ("out", C.c_void_p)]


class DecodeArgs(C.Structure):
    _fields_ = [("words", C.c_void_p), ("cap", C.c_int32),
                ("n", C.c_int32), ("n_streams", C.c_int32),
                ("valid_stream", C.c_int32), ("delta_stream", C.c_int32),
                ("blocks", C.c_int32), ("tiles", C.c_int32),
                ("delta_warps", C.c_int32),
                ("valid_out", C.c_void_p), ("status", C.c_void_p),
                ("epoch", C.c_uint32), ("s", Stream * MAX_STREAMS)]


class ExprOp(C.Structure):
    _fields_ = [("op", C.c_int32), ("arg", C.c_int32)]


class ExprProg(C.Structure):
    _fields_ = [("first", C.c_int32), ("n_ops", C.c_int32),
                ("out_type", C.c_int32), ("where", C.c_int32),
                ("out", C.c_void_p)]


class ExprArgs(C.Structure):
    _fields_ = [("n", C.c_int32), ("n_cols", C.c_int32),
                ("n_progs", C.c_int32), ("n_slots", C.c_int32),
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


class Divisor(C.Structure):
    _fields_ = [("m", C.c_uint32), ("shift", C.c_int32)]


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
                ("bounds", C.c_void_p), ("epoch", C.c_uint32),
                ("mode", C.c_int32), ("blocks", C.c_int32),
                ("adv_div", Divisor), ("slot_div", Divisor),
                ("n_aggs", C.c_int32), ("a", ScatterAgg * MAX_AGGS)]


# the key-sharded join's scatter over a table of partials (scatter.cu
# hs_scatter_table)
SCATTER_TABLE, SCATTER_TABLE_PTRS, SCATTER_PLACES = 16, 1024, 64


class ScatterPart(C.Structure):
    _fields_ = [("count", C.c_void_p), ("slot_start", C.c_void_p),
                ("touched", C.c_void_p)]


class ScatterPlanes(C.Structure):
    _fields_ = [("plane", C.c_void_p), ("plane_n", C.c_void_p)]


class ScatterTable(C.Structure):
    _fields_ = [("n_data", C.c_int32), ("n_key", C.c_int32),
                ("n_parts", C.c_int32), ("q0", C.c_int32),
                ("n_q", C.c_int32), ("data_div", Divisor),
                ("key_div", Divisor),
                ("place", C.c_int32 * SCATTER_PLACES),
                ("p", ScatterPart * SCATTER_TABLE),
                ("pp", ScatterPlanes * SCATTER_TABLE_PTRS)]


class CloseAgg(C.Structure):
    _fields_ = [("kind", C.c_int32), ("width", C.c_int32),
                ("plane_width", C.c_int32), ("init", C.c_float),
                ("q", C.c_float), ("row", C.c_int32), ("plane", C.c_void_p),
                ("plane_n", C.c_void_p)]


class Finalize(C.Structure):
    _fields_ = [("hll_p", C.c_int32), ("hll_am2", C.c_float),
                ("q_min", C.c_float), ("q_gamma", C.c_float),
                ("q_half_gamma", C.c_float), ("n_aggs", C.c_int32),
                ("a", CloseAgg * MAX_AGGS)]


CLOSE_THREADS = 256   # the close kernel's blocks (lattice.close_plan)
CLOSE_INLINE = 16     # slots a close passes by value in `sel`


class CloseArgs(C.Structure):
    _fields_ = [("n_keys", C.c_int32), ("n_slots", C.c_int32),
                ("n_sel", C.c_int32), ("mode", C.c_int32),
                ("out_rows", C.c_int32), ("slot", C.c_int32),
                ("lanes", C.c_int32), ("sel", C.c_int32 * CLOSE_INLINE),
                ("slots", C.c_void_p), ("count", C.c_void_p),
                ("slot_start", C.c_void_p), ("touched", C.c_void_p),
                ("out", C.c_void_p), ("done", C.c_void_p),
                ("f", Finalize)]


UNPACK_KEYS = 16    # key columns of one block unpack (HS_UNPACK_KEYS)
PART_COUNT, PART_SLOT_START, PART_TOUCHED = range(3)  # partial table planes


class UnpackArgs(C.Structure):
    _fields_ = [("packed", C.c_void_p), ("cap", C.c_int32),
                ("n_bool", C.c_int32), ("n_null", C.c_int32),
                ("valid", C.c_void_p),
                ("bool_row", C.c_int32 * MAX_COLS),
                ("bool_out", C.c_void_p * MAX_COLS),
                ("null_out", C.c_void_p * MAX_AGGS),
                ("pitch", C.c_int64), ("n_key_out", C.c_int32),
                ("key_sub", C.c_int32 * UNPACK_KEYS),
                ("key_out", C.c_void_p)]


TOUCHED_STAGED, TOUCHED_ONE = range(2)  # touched extract modes
TOUCHED_ONE_CELLS = 4096
TOUCHED_ONE_ROWS = 512


class TouchedArgs(C.Structure):
    _fields_ = [("n_keys", C.c_int32), ("n_slots", C.c_int32),
                ("max_out", C.c_int32), ("out_rows", C.c_int32),
                ("mode", C.c_int32), ("has_sketch", C.c_int32),
                ("count", C.c_void_p), ("slot_start", C.c_void_p),
                ("touched", C.c_void_p), ("out", C.c_void_p),
                ("scratch", C.c_void_p), ("cells", C.c_void_p),
                ("fill", C.c_void_p), ("ticket", C.c_void_p),
                ("status", C.c_void_p), ("f", Finalize)]


class Parts(C.Structure):
    _fields_ = [("n_data", C.c_int32), ("n_key", C.c_int32),
                ("local_keys", C.c_int32), ("n_planes", C.c_int32),
                ("tab", C.c_void_p)]


class MergedCloseArgs(C.Structure):
    _fields_ = [("c", CloseArgs), ("parts", Parts)]


class MergedTouchedArgs(C.Structure):
    _fields_ = [("t", TouchedArgs), ("parts", Parts)]


MERGE_SUM, MERGE_MIN, MERGE_MAX = range(3)   # shard_merge kinds
MERGE_I32, MERGE_F32, MERGE_I8, MERGE_U8 = range(4)   # their types
MERGE_DTYPES = {torch.int32: MERGE_I32, torch.float32: MERGE_F32,
                torch.int8: MERGE_I8, torch.bool: MERGE_U8}


MERGE_THREADS, MERGE_PER = 256, 2   # the snapshot merge's blocks
MERGE_CHUNKS = MERGE_THREADS * MERGE_PER   # 16-byte chunks a block
MERGE_PLANES = 3 + 2 * MAX_AGGS     # a partial's planes at most


class MergeSeg(C.Structure):
    _fields_ = [("bytes", C.c_int64), ("out_off", C.c_int64),
                ("block0", C.c_int32), ("plane", C.c_int32),
                ("shard", C.c_int32), ("kind", C.c_int32),
                ("dtype", C.c_int32), ("vec", C.c_int32)]


class ShardMergeArgs(C.Structure):
    _fields_ = [("n_seg", C.c_int32), ("n_blocks", C.c_int32),
                ("seg", C.c_void_p), ("block_seg", C.c_void_p),
                ("parts", Parts), ("out", C.c_void_p * MERGE_PLANES)]


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


# a table of key shards a launch (HsSessGroupArgs): the mesh's key shards,
# the shards a launch and their plane pointer sets
SESS_MAX_SHARDS, SESS_GROUP, SESS_GROUP_PTRS = 64, 16, 903


class SessDesc(C.Structure):
    _fields_ = [("kind", C.c_int32), ("width", C.c_int32),
                ("vtype", C.c_int32), ("null_bit", C.c_int32),
                ("values", C.c_void_p), ("seg", C.c_void_p),
                ("seg_n", C.c_void_p)]


class SessShard(C.Structure):
    _fields_ = [("code", C.c_void_p), ("t0", C.c_void_p),
                ("t1", C.c_void_p), ("out_code", C.c_void_p),
                ("out_t0", C.c_void_p), ("out_t1", C.c_void_p)]


class SessPlanePtrs(C.Structure):
    _fields_ = [("src", C.c_void_p), ("src_n", C.c_void_p),
                ("out", C.c_void_p), ("out_n", C.c_void_p)]


class SessGroupArgs(C.Structure):
    _fields_ = [("cap", C.c_int32), ("nb", C.c_int32), ("mode", C.c_int32),
                ("gap", C.c_int32), ("close_cut", C.c_int32),
                ("delta", C.c_int32), ("n_shards", C.c_int32),
                ("n_group", C.c_int32), ("qbits", C.c_int32),
                ("hll_p", C.c_int32), ("q_min", C.c_float),
                ("q_gamma", C.c_float), ("b_code", C.c_void_p),
                ("b_t0", C.c_void_p), ("b_t1", C.c_void_p),
                ("b_flags", C.c_void_p), ("scratch", C.c_void_p),
                ("n_planes", C.c_int32),
                ("pos", C.c_int32 * SESS_MAX_SHARDS),
                ("d", SessDesc * MAX_AGGS),
                ("sh", SessShard * SESS_GROUP),
                ("pp", SessPlanePtrs * SESS_GROUP_PTRS)]


SESS_INLINE = 7424   # slots a session extract passes by value


class SessExtractArgs(C.Structure):
    _fields_ = [("cap", C.c_int32), ("n_sel", C.c_int32),
                ("n_live", C.c_int32), ("slots", C.c_void_p),
                ("code", C.c_void_p), ("out", C.c_void_p), ("f", Finalize),
                ("sel", C.c_int32 * SESS_INLINE)]


# the key-sharded remap's table on the card: a row of REMAP_WORDS int64
# words a shard (HS_REMAP_*)
REMAP_ADDR, REMAP_CAP, REMAP_HEAD, REMAP_Q0, REMAP_WORDS = range(5)

# the key-sharded extract's table (HsSessExtractTable): shards a table,
# pieces (grid rows) a table, its 32-bit words (4 a shard's aggregate of
# plane pointers, then the inline slot prefixes)
SESS_XT_SHARDS, SESS_XT_PIECES, SESS_XT_WORDS = 16, 32, 7218


class SessXtPiece(C.Structure):
    _fields_ = [("code", C.c_void_p), ("out", C.c_void_p),
                ("place", C.c_int32), ("n_live", C.c_int32),
                ("sel0", C.c_int32), ("j0", C.c_int32),
                ("n_warps", C.c_int32)]


class SessExtractTable(C.Structure):
    _fields_ = [("cap", C.c_int32), ("n_sel", C.c_int32),
                ("n_group", C.c_int32), ("n_pieces", C.c_int32),
                ("slots", C.c_void_p), ("f", Finalize),
                ("pc", SessXtPiece * SESS_XT_PIECES),
                ("words", C.c_int32 * SESS_XT_WORDS)]


JOIN_SENT = 1 << 22
JOIN_MAX_FEED = 16
JOIN_MAX_NULLS = 16
JOIN_MAX_REFS = 64
JOIN_PACK, JOIN_FEED = range(2)                      # probe modes
PROBE_AUTO, PROBE_WINDOW, PROBE_WHOLE = range(3)     # probe branches
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
                ("branch", C.c_int32),
                ("n_cols_mine", C.c_int32), ("n_cols_other", C.c_int32),
                ("batch", C.c_void_p), ("o_code", C.c_void_p),
                ("o_ts", C.c_void_p), ("o_flags", C.c_void_p),
                ("o_cols", C.c_void_p), ("packed", C.c_void_p),
                ("pitch", C.c_int32), ("ts_off", C.c_int32), ("kid", C.c_void_p),
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
                ("out_flags", C.c_void_p), ("out_cols", C.c_void_p),
                ("scratch", C.c_void_p)]


# the key-sharded join's table launches (join_group.cu, the table entries
# of join_probe.cu and join_insert.cu)
JOIN_MAX_SHARDS, JOIN_GROUP, JOIN_GROUP_TILE = 64, 16, 256


class JoinGroupArgs(C.Structure):
    _fields_ = [("bcap", C.c_int32), ("n", C.c_int32),
                ("n_shards", C.c_int32), ("n_group", C.c_int32),
                ("pos", C.c_int32 * JOIN_MAX_SHARDS),
                ("batch", C.c_void_p), ("grouping", C.c_void_p)]


class JoinTableShard(C.Structure):
    _fields_ = [("code", C.c_void_p), ("ts", C.c_void_p),
                ("flags", C.c_void_p), ("cols", C.c_void_p),
                ("out_code", C.c_void_p), ("out_ts", C.c_void_p),
                ("out_flags", C.c_void_p), ("out_cols", C.c_void_p),
                ("at", C.c_int32)]


class JoinTable(C.Structure):
    _fields_ = [("n_group", C.c_int32), ("grouping", C.c_void_p),
                ("totals", C.c_void_p),
                ("sh", JoinTableShard * JOIN_GROUP)]


class JoinEvictSide(C.Structure):
    _fields_ = [("n_cols", C.c_int32), ("code", C.c_void_p),
                ("ts", C.c_void_p), ("flags", C.c_void_p),
                ("cols", C.c_void_p), ("out_code", C.c_void_p),
                ("out_ts", C.c_void_p), ("out_flags", C.c_void_p),
                ("out_cols", C.c_void_p)]


JOIN_EVICT_THREADS, JOIN_EVICT_PER = 256, 8   # the eviction's tiles


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
                             ("hs_session_step_group",
                              [C.POINTER(SessGroupArgs)]),
                             ("hs_session_merge_group",
                              [C.POINTER(SessGroupArgs)]),
                             ("hs_session_extract",
                              [C.POINTER(SessExtractArgs)]),
                             ("hs_session_extract_table",
                              [C.POINTER(SessExtractTable)]),
                             ("hs_join_probe", [C.POINTER(JoinProbeArgs)]),
                             ("hs_join_insert", [C.POINTER(JoinInsertArgs)]),
                             ("hs_join_evict", [C.POINTER(JoinEvictArgs)]),
                             ("hs_join_group", [C.POINTER(JoinGroupArgs)]),
                             ("hs_join_probe_table",
                              [C.POINTER(JoinProbeArgs),
                               C.POINTER(JoinTable)]),
                             ("hs_join_insert_table",
                              [C.POINTER(JoinInsertArgs),
                               C.POINTER(JoinTable)]),
                             ("hs_scatter_table",
                              [C.POINTER(ScatterArgs),
                               C.POINTER(ScatterTable)]),
                             ("hs_close_merged",
                              [C.POINTER(MergedCloseArgs)]),
                             ("hs_close_slot_merged",
                              [C.POINTER(MergedCloseArgs)]),
                             ("hs_touched_merged",
                              [C.POINTER(MergedTouchedArgs)]),
                             ("hs_shard_merge", [C.POINTER(ShardMergeArgs)])):
                getattr(dll, fn).argtypes = args + [C.c_void_p]
                getattr(dll, fn).restype = C.c_int
            dll.hs_rebase.argtypes = [C.c_void_p, C.c_int32, C.c_int32,
                                      C.c_void_p]
            dll.hs_rebase.restype = C.c_int
            dll.hs_empty.argtypes = [C.c_void_p]
            dll.hs_empty.restype = C.c_int
            dll.hs_session_remap.argtypes = [C.c_void_p, C.c_int32,
                                             C.c_void_p, C.c_int32,
                                             C.c_int32, C.c_void_p]
            dll.hs_session_remap.restype = C.c_int
            dll.hs_session_remap_table.argtypes = [C.c_void_p, C.c_int32,
                                                   C.c_void_p, C.c_int32,
                                                   C.c_int64, C.c_void_p]
            dll.hs_session_remap_table.restype = C.c_int
            dll.hs_session_scratch_bytes.argtypes = [C.c_int32, C.c_int32]
            dll.hs_session_scratch_bytes.restype = C.c_int64
            dll.hs_session_group_scratch_bytes.argtypes = [C.c_int32] * 3
            dll.hs_session_group_scratch_bytes.restype = C.c_int64
            dll.hs_join_probe_scratch_bytes.argtypes = [C.c_int32] * 2
            dll.hs_join_probe_scratch_bytes.restype = C.c_int64
            dll.hs_join_insert_scratch_bytes.argtypes = [C.c_int32] * 2
            dll.hs_join_insert_scratch_bytes.restype = C.c_int64
            dll.hs_join_group_bytes.argtypes = [C.c_int32] * 2
            dll.hs_join_group_bytes.restype = C.c_int64
            dll.hs_join_probe_table_scratch_bytes.argtypes = [C.c_int32] * 3
            dll.hs_join_probe_table_scratch_bytes.restype = C.c_int64
            dll.hs_join_insert_table_scratch_bytes.argtypes = [C.c_int32] * 2
            dll.hs_join_insert_table_scratch_bytes.restype = C.c_int64
            dll.hs_join_evict_scratch_bytes.argtypes = [C.c_int32]
            dll.hs_join_evict_scratch_bytes.restype = C.c_int64
            dll.hs_touched_scratch_bytes.argtypes = [C.c_int32] * 3
            dll.hs_touched_scratch_bytes.restype = C.c_int64
            dll.hs_touched_merged_scratch_bytes.argtypes = [C.c_int32] * 4
            dll.hs_touched_merged_scratch_bytes.restype = C.c_int64
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
