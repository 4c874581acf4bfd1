"""Generated protobuf messages for the HStreamApi surface.

`api_pb2` is generated from `api.proto` by `protoc --python_out`; the
generated file is checked in so tests do not require protoc. Regenerate
with:  protoc --python_out=hstream_tpu_torch/proto --proto_path=hstream_tpu_torch/proto api.proto
"""

# A copy of hstream_tpu/proto/__init__.py; the port imports nothing of the JAX
# package.

from hstream_tpu_torch.proto import api_pb2

__all__ = ["api_pb2"]
