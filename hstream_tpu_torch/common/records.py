"""Record codec and JSON helpers.

Mirrors the capability of the reference's record plumbing
(common/HStream/Utils/BuildRecord.hs:28-70 builds/parses `HStreamRecord`
protobufs with a publish timestamp; common/HStream/Utils.hs:42-55 flattens
nested JSON for connector sinks). Payloads flagged JSON carry a serialized
`google.protobuf.Struct`.
"""

# A copy of hstream_tpu/common/records.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import time
from typing import Any, Mapping

from google.protobuf import struct_pb2

from hstream_tpu_torch.proto import api_pb2 as pb


def now_ms() -> int:
    return int(time.time() * 1000)


def dict_to_struct(d: Mapping[str, Any]) -> struct_pb2.Struct:
    s = struct_pb2.Struct()
    # Struct.update handles nested dicts/lists/scalars.
    s.update(d)
    return s


def _value_to_py(v: struct_pb2.Value) -> Any:
    kind = v.WhichOneof("kind")
    if kind == "null_value":
        return None
    if kind == "number_value":
        n = v.number_value
        return int(n) if float(n).is_integer() else n
    if kind == "string_value":
        return v.string_value
    if kind == "bool_value":
        return v.bool_value
    if kind == "struct_value":
        return struct_to_dict(v.struct_value)
    if kind == "list_value":
        return [_value_to_py(x) for x in v.list_value.values]
    return None


def struct_to_dict(s: struct_pb2.Struct) -> dict[str, Any]:
    """Struct -> plain dict, decoding integral floats back to ints."""
    return {k: _value_to_py(v) for k, v in s.fields.items()}


def build_record(
    payload: Mapping[str, Any] | bytes,
    *,
    key: str = "",
    attributes: Mapping[str, str] | None = None,
    publish_time_ms: int | None = None,
) -> pb.HStreamRecord:
    """Build an HStreamRecord. A mapping payload is encoded as a JSON Struct;
    bytes are carried raw."""
    if isinstance(payload, (bytes, bytearray)):
        flag = pb.RECORD_FLAG_RAW
        body = bytes(payload)
    else:
        flag = pb.RECORD_FLAG_JSON
        body = dict_to_struct(payload).SerializeToString()
    header = pb.HStreamRecordHeader(
        flag=flag,
        publish_time_ms=now_ms() if publish_time_ms is None else publish_time_ms,
        key=key,
    )
    if attributes:
        header.attributes.update(attributes)
    return pb.HStreamRecord(header=header, payload=body)


def build_columnar_record(ts_ms, cols, *, key: str = "") -> pb.HStreamRecord:
    """One RAW record carrying a whole columnar event batch (the
    high-throughput producer path — common/columnar.py)."""
    from hstream_tpu_torch.common import columnar

    payload = columnar.encode_columnar(ts_ms, cols)
    last = int(ts_ms[-1]) if len(ts_ms) else None
    return build_record(payload, key=key, publish_time_ms=last)


def parse_record(data: bytes) -> pb.HStreamRecord:
    return pb.HStreamRecord.FromString(data)


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _splice_record(header_bytes: bytes, payload) -> bytes:
    """Serialized HStreamRecord from an already-serialized header and
    raw payload bytes: field 1 (header submessage) + field 2 (payload
    bytes), spliced by hand so the — possibly megabytes-large — payload
    is never walked by protobuf. Parses identically to
    HStreamRecord(header=..., payload=...).SerializeToString()."""
    if not len(payload):
        return b"\x0a" + _varint(len(header_bytes)) + header_bytes
    # one join so the payload is copied exactly once (a bytearray
    # build would copy it again at the final bytes() conversion)
    return b"".join((b"\x0a", _varint(len(header_bytes)), header_bytes,
                     b"\x12", _varint(len(payload)), payload))


def wrap_raw_record(payload, publish_time_ms: int) -> bytes:
    """One RAW record's wire bytes around an existing payload (the
    framed append path: the validated columnar block goes to the store
    with ONE header serialize + one memcpy — no protobuf round-trip)."""
    header = pb.HStreamRecordHeader(
        flag=pb.RECORD_FLAG_RAW,
        publish_time_ms=int(publish_time_ms)).SerializeToString()
    return _splice_record(header, payload)


# payloads below this take the plain SerializeToString path: the splice
# only pays off once the payload memcpy dominates the message walk
_SPLICE_MIN_PAYLOAD = 4096


def _read_uvarint(mv, off: int) -> tuple[int, int]:
    val = 0
    shift = 0
    while True:
        b = mv[off]
        off += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, off
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


# contract: dispatches<=0 fetches<=0
def peek_columnar_payload(data) -> memoryview | None:
    """Zero-copy view of the columnar payload inside a serialized
    RAW-flagged HStreamRecord, or None when the record is anything else
    (or the quick walk can't be sure — the caller falls back to the
    full protobuf parse). The read-side half of the wire-speed ingest
    contract (ISSUE 12): a columnar record travels socket -> store ->
    staging ring without protobuf ever walking its megabytes — at
    bunched columnar arrival the per-record parse plus the batch
    classifier walk were ~40% of the task thread's time."""
    mv = memoryview(data)
    end = len(mv)
    header = None
    payload = None
    off = 0
    try:
        while off < end:
            tag = mv[off]
            off += 1
            if tag == 0x0A:    # field 1: header submessage
                ln, off = _read_uvarint(mv, off)
                header = mv[off:off + ln]
                off += ln
            elif tag == 0x12:  # field 2: payload bytes
                ln, off = _read_uvarint(mv, off)
                payload = mv[off:off + ln]
                off += ln
            else:
                return None    # unexpected field: not ours to judge
    except (IndexError, ValueError):
        return None
    if off != end or payload is None:
        return None
    from hstream_tpu_torch.common import columnar

    if not columnar.is_columnar(payload):
        return None
    if header is not None and len(header):
        # the header is tiny — confirm the RAW flag the long way so a
        # JSON record whose Struct bytes open with the magic can't
        # masquerade as a column batch
        try:
            h = pb.HStreamRecordHeader.FromString(bytes(header))
        except Exception:  # noqa: BLE001 — undecodable: full parse
            return None
        if h.flag != pb.RECORD_FLAG_RAW:
            return None
    return payload


def record_bytes(r: pb.HStreamRecord, *, default_ts: int | None = None
                 ) -> bytes:
    """Wire bytes for an incoming record, stamping `default_ts` into
    the header ONLY when the record carries no publish time (the Append
    satellite, ISSUE 12): an already-stamped record is never mutated,
    and large payloads (columnar batches) are spliced around a
    header-only serialize instead of re-walked whole."""
    if default_ts is not None and not r.header.publish_time_ms:
        r.header.publish_time_ms = default_ts
    if len(r.payload) < _SPLICE_MIN_PAYLOAD:
        return r.SerializeToString()
    return _splice_record(r.header.SerializeToString(), r.payload)


def payload_to_struct(rec: pb.HStreamRecord) -> struct_pb2.Struct | None:
    """Decode a JSON-flagged record's payload; None for raw records."""
    if rec.header.flag != pb.RECORD_FLAG_JSON:
        return None
    return struct_pb2.Struct.FromString(rec.payload)


def record_to_dict(rec: pb.HStreamRecord) -> dict[str, Any] | None:
    s = payload_to_struct(rec)
    return None if s is None else struct_to_dict(s)


def flatten_json(d: Mapping[str, Any], *, sep: str = ".") -> dict[str, Any]:
    """Flatten nested objects: {"a": {"b": 1}} -> {"a.b": 1}.

    Used by relational sinks (MySQL/ClickHouse) which need flat columns,
    matching the reference's flattening of nested JSON objects."""
    out: dict[str, Any] = {}
    for k, v in d.items():
        if isinstance(v, Mapping):
            for kk, vv in flatten_json(v, sep=sep).items():
                out[f"{k}{sep}{kk}"] = vv
        else:
            out[k] = v
    return out
