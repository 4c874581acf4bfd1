"""Exception classes the engine, the SQL front end and the log store
raise (a copy of the part of hstream_tpu/common/errors.py they need,
with its hierarchy, without the gRPC status table, which belongs to the
server), plus the port's own two errors.
"""

from __future__ import annotations


class HStreamError(Exception):
    def __init__(self, message: str = ""):
        super().__init__(message)
        self.message = message


class StoreError(HStreamError):
    """A storage-layer error (a corrupt snapshot blob derives from it)."""


class StreamNotFound(StoreError):
    pass


class StreamExists(StoreError):
    pass


class LogNotFound(StoreError):
    pass


class DuplicateAppend(StoreError):
    """A producer-stamped append whose seq fell behind the bounded
    dedup window: the original may already be stored, so re-appending
    could duplicate — refused loudly instead."""


class ServerError(HStreamError):
    pass


class ResourceExhausted(ServerError):
    """Admission refused by flow control (quota or overload shed). The
    retry-after hint rides the message text (retry_after_ms=N), so any
    client can back off without a custom status proto."""

    def __init__(self, message: str = "",
                 retry_after_ms: int | None = None):
        if retry_after_ms is not None:
            retry_after_ms = max(1, int(retry_after_ms))
            message = f"{message} (retry_after_ms={retry_after_ms})"
        super().__init__(message)
        self.retry_after_ms = retry_after_ms


class InvalidFrame(ServerError):
    """A framed columnar append block failed validation: bad magic or
    version, truncated or overlong body, CRC mismatch, or an embedded
    columnar block whose declared sizes don't fit its bytes."""


class SQLError(HStreamError):
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


class NotPortedError(SQLCodegenError, NotImplementedError):
    """A plan feature whose port has not landed yet; the message names
    the ROADMAP queue item that carries it (e.g. A6)."""

    def __init__(self, what: str, item: str):
        super().__init__(f"{what} is not ported yet (ROADMAP {item})")
        self.item = item


class DeviceUnavailable(HStreamError, RuntimeError):
    """The caller asked for the card and there is none. The port never
    carries on on the CPU in its place."""
