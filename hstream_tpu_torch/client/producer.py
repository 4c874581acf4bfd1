"""ColumnarProducer: the client half of the framed append fast path.

A high-throughput producer should ship the server the exact staging
layout its encode workers consume — one framed columnar block per
micro-batch (``common/colframe.py``) — instead of N protobuf records
the server would parse and re-serialize. Two RPC shapes:

* ``append(ts, cols)`` — one unary ``AppendColumnar`` carrying one (or
  a few) framed blocks; simplest integration, one RPC per call.
* ``append_stream(batches)`` — ONE client-streaming
  ``AppendColumnarStream`` call carrying many micro-batches; the
  server validates/appends each message as it arrives (overlapping
  the next message's receive with the previous append's fsync through
  its append front) and answers once with every block's record id.
  Co-located producers use this to stop paying per-call gRPC overhead.

Usage::

    p = ColumnarProducer("127.0.0.1:6570", "sensors")
    p.append(ts_ms, {"device": devs, "temp": temps})
    p.append_stream((ts, cols) for ...)       # or (ts, cols, nulls)
    p.close()
"""

# A copy of hstream_tpu/client/producer.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

from typing import Any, Iterable, Iterator, Mapping

import grpc
import numpy as np

from hstream_tpu_torch.common import colframe, columnar
from hstream_tpu_torch.proto import api_pb2 as pb
from hstream_tpu_torch.proto.rpc import HStreamApiStub

# blocks per streaming request message: enough to amortize message
# overhead, small enough to stay far under the gRPC message cap even
# at megabyte blocks
STREAM_BLOCKS_PER_MSG = 4


def encode_batch(ts_ms, cols: Mapping[str, Any],
                 nulls: Mapping[str, np.ndarray] | None = None,
                 *, float_kind: str = "f32") -> bytes:
    """One framed wire block from numpy columns (+ optional per-column
    null masks) — the exact bytes ``AppendColumnar`` carries."""
    return colframe.encode_frame(
        columnar.encode_columnar(ts_ms, cols, nulls=nulls,
                                 float_kind=float_kind))


class ColumnarProducer:
    """One stream's framed-append producer over one channel."""

    def __init__(self, addr_or_channel, stream: str):
        if isinstance(addr_or_channel, str):
            self.channel = grpc.insecure_channel(addr_or_channel)
            self._owns_channel = True
        else:
            self.channel = addr_or_channel
            self._owns_channel = False
        self.stub = HStreamApiStub(self.channel)
        self.stream = stream

    def close(self) -> None:
        if self._owns_channel:
            self.channel.close()

    # ---- unary -----------------------------------------------------------

    def append(self, ts_ms, cols: Mapping[str, Any],
               nulls: Mapping[str, np.ndarray] | None = None):
        """Encode one micro-batch and append it in one unary RPC.
        Returns the AppendColumnarResponse (record_ids, rows)."""
        return self.append_frames([encode_batch(ts_ms, cols, nulls)])

    def append_frames(self, frames: Iterable[bytes]):
        """Append pre-encoded framed blocks (one store batch each)."""
        return self.stub.AppendColumnar(pb.AppendColumnarRequest(
            stream_name=self.stream, blocks=list(frames)))

    # ---- streaming -------------------------------------------------------

    def append_stream(self, batches: Iterable[tuple]):
        """One AppendColumnarStream call over many micro-batches.
        `batches` yields (ts, cols) or (ts, cols, nulls) tuples; returns
        the aggregate AppendColumnarResponse (one record id per block,
        in submission order)."""
        return self.stub.AppendColumnarStream(
            self._requests(encode_batch(*b) for b in batches))

    def append_stream_frames(self, frames: Iterable[bytes]):
        """Streaming append of pre-encoded framed blocks."""
        return self.stub.AppendColumnarStream(self._requests(frames))

    def _requests(self, frames: Iterable[bytes]
                  ) -> Iterator[pb.AppendColumnarRequest]:
        pending: list[bytes] = []
        for f in frames:
            pending.append(f)
            if len(pending) >= STREAM_BLOCKS_PER_MSG:
                yield pb.AppendColumnarRequest(stream_name=self.stream,
                                               blocks=pending)
                pending = []
        if pending:
            yield pb.AppendColumnarRequest(stream_name=self.stream,
                                           blocks=pending)
