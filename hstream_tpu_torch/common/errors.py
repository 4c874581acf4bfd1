"""Exception hierarchy for hstream-tpu.

The reference maps low-level store error codes to a typed exception table
(hstream-store/HStream/Store/Exception.hs) and catches them at the server
boundary into gRPC statuses (hstream/src/HStream/Server/Exception.hs:27-50).
We keep a compact hierarchy with the same separation: store errors, SQL
errors, server/user errors — each knows its gRPC status code. The port
adds two of its own: NotPortedError and DeviceUnavailable.
"""

# A copy of hstream_tpu/common/errors.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import grpc


class HStreamError(Exception):
    grpc_status = grpc.StatusCode.INTERNAL

    def __init__(self, message: str = ""):
        super().__init__(message)
        self.message = message


# ---- store -----------------------------------------------------------------

class StoreError(HStreamError):
    pass


class StreamNotFound(StoreError):
    grpc_status = grpc.StatusCode.NOT_FOUND


class StreamExists(StoreError):
    grpc_status = grpc.StatusCode.ALREADY_EXISTS


class LogNotFound(StoreError):
    grpc_status = grpc.StatusCode.NOT_FOUND


class CheckpointNotFound(StoreError):
    grpc_status = grpc.StatusCode.NOT_FOUND


class StoreIOError(StoreError):
    pass


class ReplicaDivergence(StoreIOError):
    """A replica's local store no longer matches the op-log it is
    asked to apply (an append would land at the wrong LSN). The
    replica halts loudly and refuses further entries — an operator
    re-bootstraps it from a copy of a live store; drifting quietly is
    never an option."""


class NotLeaderError(StoreError):
    """This node no longer leads the replicated store (fenced by a
    higher epoch). The NOT_LEADER contract: rides UNAVAILABLE — the
    one status that means "not here, maybe elsewhere" — with the new
    leader's address attached twice, as an ``x-leader-hint``
    trailing-metadata entry at the gRPC boundary and a
    ``not_leader leader_hint=ADDR`` token in the message text.
    Clients follow the hint with jittered backoff
    (client/retry.HINTED_RETRYABLE_CODES) instead of failing the
    statement; a bare UNAVAILABLE (mid-call transport drop, no hint)
    stays non-retryable at that layer."""

    grpc_status = grpc.StatusCode.UNAVAILABLE

    def __init__(self, message: str = "",
                 leader_hint: str | None = None):
        if leader_hint:
            message = f"{message} (not_leader leader_hint={leader_hint})"
        super().__init__(message)
        self.leader_hint = leader_hint


class DuplicateAppend(StoreError):
    """A producer-stamped append whose seq fell behind the bounded
    dedup window: the original may already be stored, so re-appending
    could duplicate — refused loudly instead."""

    grpc_status = grpc.StatusCode.ALREADY_EXISTS


# ---- SQL -------------------------------------------------------------------

class SQLError(HStreamError):
    grpc_status = grpc.StatusCode.INVALID_ARGUMENT

    def __init__(self, message: str, pos: tuple[int, int] | None = None):
        super().__init__(message)
        self.pos = pos  # (line, column), 1-based

    def __str__(self) -> str:
        if self.pos:
            return f"{self.message} at line {self.pos[0]}, column {self.pos[1]}"
        return self.message


class SQLParseError(SQLError):
    pass


class SQLValidateError(SQLError):
    pass


class SQLCodegenError(SQLError):
    pass


# ---- server ----------------------------------------------------------------

class ServerError(HStreamError):
    pass


class InvalidFrame(ServerError):
    """A framed columnar append block failed validation at the ingress
    door — bad magic/version, truncated or overlong body, CRC mismatch,
    or an embedded columnar block whose declared sizes don't fit its
    bytes. The refusal contract: typed INVALID_ARGUMENT
    before ANY byte reaches the store, never a partial ingest."""

    grpc_status = grpc.StatusCode.INVALID_ARGUMENT


class SubscriptionNotFound(ServerError):
    grpc_status = grpc.StatusCode.NOT_FOUND


class SubscriptionExists(ServerError):
    grpc_status = grpc.StatusCode.ALREADY_EXISTS


class QueryNotFound(ServerError):
    grpc_status = grpc.StatusCode.NOT_FOUND


class ViewNotFound(ServerError):
    grpc_status = grpc.StatusCode.NOT_FOUND


class ConnectorNotFound(ServerError):
    grpc_status = grpc.StatusCode.NOT_FOUND


class QueryTerminated(ServerError):
    grpc_status = grpc.StatusCode.ABORTED


class ResourceExhausted(ServerError):
    """Admission refused by flow control (quota or overload shed). The
    retry-after hint rides both the message text (retry_after_ms=N) and
    — at the gRPC boundary — a `retry-after-ms` trailing-metadata entry,
    so any client can back off without a custom status proto."""

    grpc_status = grpc.StatusCode.RESOURCE_EXHAUSTED

    def __init__(self, message: str = "",
                 retry_after_ms: int | None = None):
        if retry_after_ms is not None:
            retry_after_ms = max(1, int(retry_after_ms))
            message = f"{message} (retry_after_ms={retry_after_ms})"
        super().__init__(message)
        self.retry_after_ms = retry_after_ms


# ---- the port's own -----------------------------------------------------------

class NotPortedError(SQLCodegenError, NotImplementedError):
    """A feature whose port has not landed yet; the message names the
    ROADMAP queue item that carries it (e.g. A11). At the gRPC boundary
    it reads UNIMPLEMENTED."""

    grpc_status = grpc.StatusCode.UNIMPLEMENTED

    def __init__(self, what: str, item: str):
        super().__init__(f"{what} is not ported yet (ROADMAP {item})")
        self.item = item


class DeviceUnavailable(HStreamError, RuntimeError):
    """The caller asked for the card and there is none. The port never
    carries on on the CPU in its place."""

    grpc_status = grpc.StatusCode.FAILED_PRECONDITION
