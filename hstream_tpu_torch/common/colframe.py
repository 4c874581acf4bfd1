"""Framed columnar append blocks: the wire-speed ingest fast path.

The protobuf Append path costs one full ``HStreamRecord`` parse on the
gRPC boundary plus one re-``SerializeToString()`` per record before the
bytes reach the store — at columnar batch sizes (megabytes per
micro-batch) that host staging work, not the engine, bounds the served
ingest rate (BENCH_r05: kernel 22.6M ev/s, served 1.04M). The framed
path ships the staging layout itself: the client encodes exactly the
columnar block the encode workers already consume (``HSCB1``: ts vector
+ named fixed-width columns + null masks, ``common/columnar.py``),
wrapped in a 13-byte frame the server can bounds-check WITHOUT
materializing a single row. The server's whole job is: check the frame,
check the block's declared sizes against its actual bytes, splice a
precomputed record header around the payload (one memcpy — no protobuf
walk), and hand the bytes to the append front.

Frame layout (little-endian)::

    MAGIC "HSAF" | u8 version | u32 payload_len | u32 crc32(payload)
    | payload (one HSCB1 columnar block)

The version byte gates evolution: a frame with an unknown version is a
typed INVALID_ARGUMENT refusal, never a guess. ``payload_len`` must
match the remaining bytes EXACTLY — a truncated (torn) or overlong
frame is refused before any byte is appended. The CRC catches torn
writes that happen to preserve the length (the ``faultinject`` torn
schedule cuts mid-payload); integrity is checked at the ingress door so
a corrupt frame can never become a partially-ingested batch.
"""

# A copy of hstream_tpu/common/colframe.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import struct
import zlib

from hstream_tpu_torch.common.errors import InvalidFrame

FRAME_MAGIC = b"HSAF"
FRAME_VERSION = 1
# MAGIC(4) + version(1) + payload_len(4) + crc32(4)
FRAME_HEADER_LEN = 13

_HEAD = struct.Struct("<4sBII")


def encode_frame(payload: bytes) -> bytes:
    """Wrap one columnar block (``columnar.encode_columnar`` bytes) in
    the append frame. The producer-side half of the wire format."""
    payload = bytes(payload)
    return _HEAD.pack(FRAME_MAGIC, FRAME_VERSION, len(payload),
                      zlib.crc32(payload)) + payload


# contract: dispatches<=0 fetches<=0
def open_frame(frame: bytes) -> memoryview:
    """Validate a frame and return a zero-copy view of its payload.

    Every malformed shape — short header, wrong magic, unknown version,
    truncated/overlong body, CRC mismatch — raises the typed
    ``InvalidFrame`` (gRPC INVALID_ARGUMENT): the contract is refuse
    loudly at the door, never a partial ingest."""
    mv = memoryview(frame)
    if len(mv) < FRAME_HEADER_LEN:
        raise InvalidFrame(
            f"frame shorter than the {FRAME_HEADER_LEN}-byte header "
            f"({len(mv)} bytes)")
    magic, version, plen, crc = _HEAD.unpack_from(mv, 0)
    if magic != FRAME_MAGIC:
        raise InvalidFrame(f"bad frame magic {bytes(magic)!r}")
    if version != FRAME_VERSION:
        raise InvalidFrame(
            f"unsupported frame version {version} "
            f"(this server speaks version {FRAME_VERSION})")
    body = mv[FRAME_HEADER_LEN:]
    if len(body) != plen:
        kind = "truncated" if len(body) < plen else "overlong"
        raise InvalidFrame(
            f"{kind} frame: header declares {plen} payload bytes, "
            f"{len(body)} present")
    if zlib.crc32(body) != crc:
        raise InvalidFrame("frame CRC mismatch (torn or corrupt bytes)")
    return body


# contract: dispatches<=0 fetches<=0
def open_block(frame: bytes) -> tuple[memoryview, int, int]:
    """Frame -> (payload view, n_rows, last_ts_ms), fully validated:
    the frame envelope (open_frame) AND the embedded columnar block's
    declared sizes (columnar.validate_block). The ONE door every framed
    append passes through — after this returns, the payload is exactly
    the columnar record the query tasks already decode."""
    from hstream_tpu_torch.common import columnar

    payload = open_frame(frame)
    try:
        n, last_ts = columnar.validate_block(payload)
    except (ValueError, KeyError, TypeError) as e:
        raise InvalidFrame(f"bad columnar block: {e}") from e
    return payload, n, last_ts
