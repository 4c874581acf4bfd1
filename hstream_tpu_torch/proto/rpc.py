"""gRPC service glue generated dynamically from the proto descriptor.

The image has `protoc` but not the grpc python plugin, so instead of
checked-in *_pb2_grpc.py stubs the servicer registration and client stub
are built from `api_pb2.DESCRIPTOR` at import time — same wire format,
same `/hstream.tpu.HStreamApi/<Method>` paths a generated stub would use
(reference service surface: HStreamApi.proto:13-84, 35 RPCs).
"""

# A copy of hstream_tpu/proto/rpc.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import grpc
from google.protobuf import message_factory

from hstream_tpu_torch.proto import api_pb2

SERVICE_NAME = "hstream.tpu.HStreamApi"

_SERVICE = api_pb2.DESCRIPTOR.services_by_name["HStreamApi"]


def _serializer(cls):
    return lambda msg: msg.SerializeToString()


def method_names() -> list[str]:
    return [m.name for m in _SERVICE.methods]


def add_service_to_server(service_desc, servicer, server) -> None:
    """Register `servicer` (one method per RPC name) for any service
    descriptor on a grpc.Server."""
    full_name = service_desc.full_name
    handlers = {}
    for m in service_desc.methods:
        in_cls = message_factory.GetMessageClass(m.input_type)
        out_cls = message_factory.GetMessageClass(m.output_type)
        behavior = getattr(servicer, m.name)
        deser = in_cls.FromString
        ser = _serializer(out_cls)
        if m.client_streaming and m.server_streaming:
            h = grpc.stream_stream_rpc_method_handler(behavior, deser, ser)
        elif m.server_streaming:
            h = grpc.unary_stream_rpc_method_handler(behavior, deser, ser)
        elif m.client_streaming:
            h = grpc.stream_unary_rpc_method_handler(behavior, deser, ser)
        else:
            h = grpc.unary_unary_rpc_method_handler(behavior, deser, ser)
        handlers[m.name] = h
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(full_name, handlers),))


class ServiceStub:
    """Client stub for any service descriptor (same wire paths a
    generated stub would use)."""

    def __init__(self, service_desc, channel: grpc.Channel):
        for m in service_desc.methods:
            in_cls = message_factory.GetMessageClass(m.input_type)
            out_cls = message_factory.GetMessageClass(m.output_type)
            path = f"/{service_desc.full_name}/{m.name}"
            ser = _serializer(in_cls)
            deser = out_cls.FromString
            if m.client_streaming and m.server_streaming:
                fn = channel.stream_stream(path, request_serializer=ser,
                                           response_deserializer=deser)
            elif m.server_streaming:
                fn = channel.unary_stream(path, request_serializer=ser,
                                          response_deserializer=deser)
            elif m.client_streaming:
                fn = channel.stream_unary(path, request_serializer=ser,
                                          response_deserializer=deser)
            else:
                fn = channel.unary_unary(path, request_serializer=ser,
                                         response_deserializer=deser)
            setattr(self, m.name, fn)


REPLICA_SERVICE = api_pb2.DESCRIPTOR.services_by_name["StoreReplica"]


def add_store_replica_to_server(servicer, server) -> None:
    add_service_to_server(REPLICA_SERVICE, servicer, server)


class StoreReplicaStub(ServiceStub):
    def __init__(self, channel: grpc.Channel):
        super().__init__(REPLICA_SERVICE, channel)


def add_hstream_api_to_server(servicer, server) -> None:
    """Register `servicer` (an object with one method per RPC name) on a
    grpc.Server."""
    add_service_to_server(_SERVICE, servicer, server)


class HStreamApiStub(ServiceStub):
    """Client stub: one callable per RPC, built from the descriptor."""

    def __init__(self, channel: grpc.Channel):
        super().__init__(_SERVICE, channel)
