"""Columnar batch payload: the high-throughput producer format.

A RAW-flagged HStreamRecord whose payload starts with the HSCB1 magic
carries a whole COLUMN-oriented event batch: one i64 timestamp array
plus named columns (f32 / i64 / bool / dictionary-encoded strings).
Appending one columnar record per micro-batch skips per-event protobuf
and JSON entirely — the server's query tasks detect the magic and feed
the columns straight into the jitted lattice step (engine ingest
contract), the path the 10M events/s target is specified against.

The reference's wire is one protobuf per event (BuildRecord.hs:28-70);
this is the TPU-first divergence SURVEY §7 prescribes ("protobuf decode
+ key dictionary off the critical path — columnar staging").

Layout: MAGIC | u32 header_len | header JSON | ts i64[n] | col bytes...
        | null-mask bytes (u8[n] per masked column, ISSUE 12)...
header: {"n": int, "cols": [[name, kind], ...], "dicts": {name: [str]},
         "nulls": [name, ...]}        # optional; names masks in order
kinds: "f32" | "i64" | "bool" | "str" (i32 ids into header dict)

The optional per-column null masks carry missing/NULL cells on the
wire (the framed append path's staging layout): a masked cell behaves
exactly like a field a per-record producer never sent. Payloads
without the "nulls" header key are the legacy layout — old producers
and old decoders interoperate unchanged.
"""

# A copy of hstream_tpu/common/columnar.py; the port imports nothing of the JAX
# package. The sink-side encoders (ColumnarEmit.to_payload, rows_to_payload,
# payload_rows) are ported with the server's sinks (ROADMAP A5b).

from __future__ import annotations

import json
from collections.abc import Sequence
from typing import Any, Mapping

import numpy as np

MAGIC = b"HSCB1\x00"

_KIND_DTYPE = {"f32": np.float32, "f64": np.float64, "i64": np.int64,
               "bool": np.uint8, "str": np.int32}


def is_columnar(payload: bytes) -> bool:
    return payload[: len(MAGIC)] == MAGIC


def encode_columnar(ts_ms: np.ndarray,
                    cols: Mapping[str, np.ndarray | list],
                    *, float_kind: str = "f32",
                    nulls: Mapping[str, np.ndarray] | None = None
                    ) -> bytes:
    """Columns -> payload bytes. String columns (lists or object/str
    arrays) are dictionary-encoded; numeric arrays are cast to
    f32/i64/bool. float_kind="f64" keeps float columns at full double
    precision (sink emission of host-finalized aggregates). `nulls`
    (name -> bool[n]) marks missing cells; masks ride after the column
    bytes and decode back via decode_columnar_nulls."""
    ts = np.ascontiguousarray(ts_ms, np.int64)
    n = len(ts)
    meta_cols: list[list[str]] = []
    dicts: dict[str, list[str]] = {}
    bufs: list[bytes] = [ts.tobytes()]
    for name, v in cols.items():
        arr = np.asarray(v)
        if arr.dtype.kind in ("U", "S", "O"):
            uniq, inv = np.unique(arr.astype(str), return_inverse=True)
            dicts[name] = uniq.tolist()
            data = inv.astype(np.int32)
            kind = "str"
        elif arr.dtype.kind == "b":
            data = arr.astype(np.uint8)
            kind = "bool"
        elif arr.dtype.kind in ("i", "u"):
            data = arr.astype(np.int64)
            kind = "i64"
        else:
            kind = float_kind
            data = arr.astype(_KIND_DTYPE[kind])
        if len(data) != n:
            raise ValueError(f"column {name!r} length {len(data)} != {n}")
        meta_cols.append([name, kind])
        bufs.append(np.ascontiguousarray(data).tobytes())
    meta = {"n": n, "cols": meta_cols, "dicts": dicts}
    if nulls:
        mask_names = []
        for name, m in nulls.items():
            if name not in cols:
                raise ValueError(
                    f"null mask for unknown column {name!r}")
            m = np.asarray(m, np.bool_)
            if len(m) != n:
                raise ValueError(
                    f"null mask {name!r} length {len(m)} != {n}")
            mask_names.append(name)
            bufs.append(np.ascontiguousarray(m, np.uint8).tobytes())
        meta["nulls"] = mask_names
    header = json.dumps(meta, separators=(",", ":")).encode()
    out = bytearray(MAGIC)
    out += np.uint32(len(header)).tobytes()
    out += header
    for b in bufs:
        out += b
    return bytes(out)


def decode_columnar_nulls(payload) -> tuple[np.ndarray, dict[str, Any],
                                            dict[str, np.ndarray] | None]:
    """payload -> (ts i64[n], {name: (kind, array, dict|None)},
    {name: bool[n]} | None).

    Arrays are zero-copy views into the payload where alignment allows;
    accepts bytes or a memoryview (the framed append path hands the
    frame's payload view straight in). Every declared size is checked
    against the actual bytes BEFORE any array is built — a forged or
    torn payload fails here, not deep inside the engine."""
    if not is_columnar(payload):
        raise ValueError("not a columnar payload")
    off = len(MAGIC)
    if len(payload) < off + 4:
        raise ValueError("truncated columnar header")
    hlen = int(np.frombuffer(payload, np.uint32, 1, off)[0])
    off += 4
    if len(payload) - off < hlen:
        raise ValueError("columnar header shorter than declared")
    try:
        header = json.loads(bytes(payload[off: off + hlen]))
    except ValueError as e:
        raise ValueError(f"bad columnar header JSON: {e}") from None
    off += hlen
    n = header["n"]
    # forged headers must fail HERE, not deep inside the engine: a
    # negative n would make frombuffer read "the rest", a giant n would
    # over-read; both are rejected by explicit bounds checks
    if not isinstance(n, int) or n < 0:
        raise ValueError(f"bad columnar n={n!r}")
    mask_names = header.get("nulls") or []
    col_names = [name for name, _kind in header["cols"]]
    if not isinstance(mask_names, list) \
            or not set(mask_names) <= set(col_names):
        raise ValueError("null masks name unknown columns")
    need = 8 * n + len(mask_names) * n
    for _, kind in header["cols"]:
        if kind not in _KIND_DTYPE:
            raise ValueError(f"unknown column kind {kind!r}")
        need += np.dtype(_KIND_DTYPE[kind]).itemsize * n
    if len(payload) - off < need:
        raise ValueError("columnar payload shorter than header claims")
    ts = np.frombuffer(payload, np.int64, n, off)
    off += 8 * n
    cols: dict[str, Any] = {}
    for name, kind in header["cols"]:
        dt = _KIND_DTYPE[kind]
        arr = np.frombuffer(payload, dt, n, off)
        off += arr.itemsize * n
        if kind == "bool":
            arr = arr.astype(np.bool_)
        d = header["dicts"].get(name)
        if kind == "str":
            if not isinstance(d, list):
                raise ValueError(f"string column {name!r} missing dict")
            if n and (int(arr.min()) < 0 or int(arr.max()) >= len(d)):
                raise ValueError(
                    f"string column {name!r} ids out of dict range")
        cols[name] = (kind, arr, d)
    nulls: dict[str, np.ndarray] | None = None
    if mask_names:
        nulls = {}
        for name in mask_names:
            nulls[name] = np.frombuffer(payload, np.uint8, n,
                                        off).astype(np.bool_)
            off += n
    if off != len(payload):
        # exact-bounds contract: trailing undeclared bytes mean either
        # a corrupt/forged block or a NEWER layout this decoder does
        # not understand — refusing beats silently misreading it (an
        # extension section ignored as junk could change row meaning,
        # exactly what unread null masks would have done)
        raise ValueError(
            f"columnar payload longer than header claims "
            f"({len(payload) - off} trailing bytes)")
    return ts, cols, nulls


def decode_columnar(payload) -> tuple[np.ndarray, dict[str, Any]]:
    """Legacy 2-tuple decode (ts, cols) — null masks, if any, dropped;
    null-aware consumers use decode_columnar_nulls."""
    ts, cols, _nulls = decode_columnar_nulls(payload)
    return ts, cols


def validate_block(payload) -> tuple[int, int]:
    """Bounds-check one columnar block withOUT materializing a single
    row: header sizes vs actual bytes, column kinds, string dict
    ranges, null-mask coverage (all via the zero-copy decode). Returns
    (n_rows, last_ts_ms). Raises ValueError on anything malformed —
    the ingress door (colframe.open_block) maps that to the typed
    INVALID_ARGUMENT refusal. Empty blocks are refused: an append of
    zero rows is a producer bug, not a no-op."""
    ts, _cols, _nulls = decode_columnar_nulls(payload)
    n = int(len(ts))
    if n == 0:
        raise ValueError("empty columnar block (n=0)")
    return n, int(ts[-1])


def to_rows(ts: np.ndarray, cols: dict,
            nulls: Mapping[str, np.ndarray] | None = None,
            *, drop_null: bool = False) -> list[dict[str, Any]]:
    """Materialize decoded columns back into per-row dicts (consumers
    that need row shape: joins, sessions, connectors, push-query
    streaming). `nulls` marks missing/null cells -> None. f64 columns
    (native JSON decode, sink emission) intify integral values, matching
    records.record_to_dict's Struct number decoding.

    drop_null=True omits null-masked cells from the row dicts instead of
    carrying explicit Nones — the shape the per-record decode path
    produces for a heterogeneous batch (a record never mentions columns
    it doesn't carry), so executors see the same rows regardless of how
    the producer batched its appends."""
    host = {}
    masks = {}
    for name, (kind, arr, d) in cols.items():
        if kind == "str":
            vals = [d[int(i)] for i in arr]
        elif kind == "f64":
            vals = [int(v) if v.is_integer() else v
                    for v in arr.tolist()]
        else:
            vals = arr.tolist()
        nm = nulls.get(name) if nulls else None
        if nm is not None and nm.any():
            if drop_null:
                masks[name] = nm.tolist()
            else:
                vals = [None if isnull else v
                        for v, isnull in zip(vals, nm.tolist())]
        host[name] = vals
    names = list(host)
    if not names:
        # empty-payload records still ARE records: n empty dicts, like
        # the per-record decode path (record_to_dict returns {})
        return [{} for _ in range(len(ts))]
    rows = [dict(zip(names, vals))
            for vals in zip(*(host[c] for c in names))]
    for name, mask in masks.items():
        for row, isnull in zip(rows, mask):
            if isnull:
                del row[name]
    return rows


class ColumnarEmit(Sequence):
    """A batch of emitted aggregate rows kept COLUMNAR until the wire.

    The window-close path finalizes whole slot columns on device; this
    carries the result as named columns (numpy arrays, or object arrays
    for strings / TOPK lists) instead of N per-row dicts. Consumers that
    can stay columnar (the stream sink's columnar record, the native
    codec) read `.cols` directly; everything else sees
    a lazy Sequence of per-row dicts identical to the legacy list shape
    (len / bool / iterate / index / extend-into-a-list all work), so the
    row materialization happens at most once, at the first row-shaped
    consumer — ideally the wire boundary.
    """

    __slots__ = ("cols", "n", "_rows")

    def __init__(self, cols: Mapping[str, Any], n: int):
        self.cols = dict(cols)
        self.n = int(n)
        self._rows: list[dict[str, Any]] | None = None

    def __len__(self) -> int:
        return self.n

    def rows(self) -> list[dict[str, Any]]:
        """Materialize (and cache) the per-row dict view."""
        if self._rows is None:
            names = list(self.cols)
            if not names:
                self._rows = [{} for _ in range(self.n)]
            else:
                pyd = [v.tolist() if isinstance(v, np.ndarray) else list(v)
                       for v in self.cols.values()]
                self._rows = [dict(zip(names, vals))
                              for vals in zip(*pyd)]
        return self._rows

    def __getitem__(self, i):
        return self.rows()[i]

    def __iter__(self):
        return iter(self.rows())

    # list-concat ergonomics: emitted batches historically were plain
    # lists, so `acc += ex.process(...)` and `rows + more` must keep
    # working when either side is a columnar batch (materializes —
    # callers that care use extend_rows to stay columnar)
    def __add__(self, other):
        return self.rows() + list(other)

    def __radd__(self, other):
        return list(other) + self.rows()

    def __repr__(self) -> str:
        return (f"ColumnarEmit(n={self.n}, "
                f"cols={list(self.cols)})")


def extend_rows(acc, rows):
    """Accumulate emitted row batches across pipeline stages while
    keeping a LONE ColumnarEmit columnar: acc is None | list |
    ColumnarEmit; returns the new accumulator. Only when a second batch
    arrives does the first materialize into a plain list — the common
    case (one close cycle per drain) reaches the sink columnar."""
    if rows is None or len(rows) == 0:
        return acc
    if acc is None or (isinstance(acc, list) and not acc):
        return rows
    if not isinstance(acc, list):
        acc = list(acc)
    acc.extend(rows)
    return acc
