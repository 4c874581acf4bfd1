"""Structured logging for hstream-tpu.

The reference uses a leveled, colored builder logger (common/HStream/Logger.hs);
here we configure the stdlib logger once with the same spirit: level control via
HSTREAM_LOG_LEVEL, compact single-line format with timestamps.

Request correlation (ISSUE 3): handlers bind the caller's request id
(gRPC metadata `x-request-id`, stamped by the client/gateway) into a
contextvar; a logging filter threads it into every record emitted while
the request runs, so one grep over the server log follows one request
across client -> gateway -> handler -> task launch.
"""

# A copy of hstream_tpu/common/logger.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import contextlib
import contextvars
import logging
import os
import sys

_FORMAT = "%(asctime)s.%(msecs)03d %(levelname).1s %(name)s%(rid)s: " \
          "%(message)s"
_DATEFMT = "%H:%M:%S"

# the gRPC metadata key correlation ids travel under (client and
# gateway stamp it; handlers read it) — defined here so every layer
# shares one spelling
REQUEST_ID_KEY = "x-request-id"

_configured = False

# the active request's correlation id ("" outside any request)
_request_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "hstream_request_id", default="")


def set_request_id(rid: str | None):
    """Bind the current context's correlation id; returns the reset
    token (pass to reset_request_id when the request finishes)."""
    return _request_id.set(rid or "")


def reset_request_id(token) -> None:
    _request_id.reset(token)


def current_request_id() -> str:
    return _request_id.get()


@contextlib.contextmanager
def request_context(rid: str | None):
    """Scope a correlation id over a block (handler body)."""
    token = set_request_id(rid)
    try:
        yield
    finally:
        reset_request_id(token)


class _RequestIdFilter(logging.Filter):
    """Stamps `rid` (" [rid=...]" or "") onto every record so the
    format string can always reference it."""

    def filter(self, record: logging.LogRecord) -> bool:
        rid = _request_id.get()
        record.rid = f" [rid={rid}]" if rid else ""
        return True


def get_logger(name: str) -> logging.Logger:
    global _configured
    if not _configured:
        level = os.environ.get("HSTREAM_LOG_LEVEL", "INFO").upper()
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, _DATEFMT))
        # on the HANDLER, not the logger: logger-level filters skip
        # records propagated up from child loggers; handler filters see
        # every record they format
        handler.addFilter(_RequestIdFilter())
        root = logging.getLogger("hstream_tpu_torch")
        root.addHandler(handler)
        root.setLevel(getattr(logging, level, logging.INFO))
        root.propagate = False
        _configured = True
    return logging.getLogger(f"hstream_tpu_torch.{name}")
