"""Client-side resilience: jittered backoff honoring retry-after.

When the server refuses work with RESOURCE_EXHAUSTED it attaches a
retry-after hint twice: a `retry-after-ms` trailing-metadata entry and
a ``retry_after_ms=N`` token in the status message (so even clients
that drop metadata can parse it). `RetryPolicy.call` retries only the
statuses `RETRYABLE_CODES` classifies as duplication-safe (flow-control
refusals, issued before any work — every other status, including
mid-call transport drops, is explicitly NON_RETRYABLE), sleeping

  * ``hint * (1 + U[0, 0.5))`` when the server sent a hint — the hint
    is a floor, the jitter spreads the herd, or
  * full-jitter exponential backoff ``U[0, min(max, base * 2^attempt))``
    when it did not,

for at most `attempts` tries. Sleep/rng are injectable so tier-1 tests
drive convergence with a fake clock and zero wall-clock sleeps.

Leader failover: a fenced store leader refuses mutations
with UNAVAILABLE carrying the NEW leader's address twice — an
``x-leader-hint`` trailing-metadata entry and a ``not_leader
leader_hint=ADDR`` token in the message. UNAVAILABLE stays
non-retryable in general (a mid-call transport drop may have landed a
mutation), but WITH a hint the refusal was issued before any work, so
`RetryPolicy.call` follows it: the caller passes ``on_leader_hint``
(rebind your channel/stub to the hinted address) and the policy
retries with the same jittered backoff instead of failing the
statement (`HINTED_RETRYABLE_CODES`).
"""

# A copy of hstream_tpu/client/retry.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import random
import re
import time

import grpc

RETRY_AFTER_KEY = "retry-after-ms"
_RETRY_AFTER_RE = re.compile(r"retry_after_ms=(\d+)")
LEADER_HINT_KEY = "x-leader-hint"
_LEADER_HINT_RE = re.compile(r"not_leader leader_hint=([^\s)]+)")

# Retryability classification of every status the server emits (the
# analyzer's errcontract pass keeps this table honest in both
# directions: emitted ⊆ classified, retried ⊆ emitted ∪ transport).
#
# Retryable: the refusal is issued BEFORE any work happens, so
# re-sending the identical request is duplication-safe.
#   RESOURCE_EXHAUSTED  flow-control refusal (quota / overload shed);
#                       the server attaches a retry-after hint
# Non-retryable: re-sending cannot help, or could double-apply.
#   NOT_FOUND / ALREADY_EXISTS / INVALID_ARGUMENT — caller errors
#   FAILED_PRECONDITION — state conflict (e.g. a replica already bound
#                       to another leader); needs operator action
#   INTERNAL            server-side failure; retrying re-runs the
#                       failure and can duplicate side effects
#   ABORTED             the operation was terminated on purpose
#   UNAVAILABLE         transport drop — possibly MID-CALL, after a
#                       mutation landed but before its response; the
#                       server has no request-id dedup, so a blind
#                       resend can append the same records twice.
#                       Blanket retry is unsafe at this layer; an
#                       application that knows its call is idempotent
#                       retries it itself.
RETRYABLE_CODES = frozenset({
    grpc.StatusCode.RESOURCE_EXHAUSTED,
})
NON_RETRYABLE_CODES = frozenset({
    grpc.StatusCode.NOT_FOUND,
    grpc.StatusCode.ALREADY_EXISTS,
    grpc.StatusCode.INVALID_ARGUMENT,
    grpc.StatusCode.FAILED_PRECONDITION,
    grpc.StatusCode.INTERNAL,
    grpc.StatusCode.ABORTED,
    grpc.StatusCode.UNAVAILABLE,
    # the port's NotPortedError: the same call fails the same way
    grpc.StatusCode.UNIMPLEMENTED,
})
# Statuses retryable ONLY when the error carries a leader hint (the
# NOT_LEADER contract): the refusal is issued before any work, and the
# hint names where to send the retry. The BARE form of each code stays
# in NON_RETRYABLE_CODES — without the hint an UNAVAILABLE may be a
# mid-call transport drop whose mutation landed. The errcontract pass
# enforces both halves (hinted ⊆ non-retryable-bare, hinted ⊆ emitted).
HINTED_RETRYABLE_CODES = frozenset({
    grpc.StatusCode.UNAVAILABLE,
})


def is_retryable(code) -> bool:
    """Classify a grpc.StatusCode; unknown codes are non-retryable."""
    return code in RETRYABLE_CODES


def retry_after_ms_from_error(e: grpc.RpcError) -> int | None:
    """The server's retry-after hint in ms, or None: trailing metadata
    first, message text as the fallback."""
    try:
        md = e.trailing_metadata() or ()
    except Exception:  # noqa: BLE001 — not all RpcErrors carry it
        md = ()
    for k, v in md:
        if k == RETRY_AFTER_KEY:
            try:
                return int(v)
            except ValueError:
                break
    try:
        details = e.details() or ""
    except Exception:  # noqa: BLE001
        details = str(e)
    m = _RETRY_AFTER_RE.search(details)
    return int(m.group(1)) if m else None


def leader_hint_from_error(e: grpc.RpcError) -> str | None:
    """The new leader's address from a NOT_LEADER refusal, or None:
    trailing metadata first, message token as the fallback."""
    try:
        md = e.trailing_metadata() or ()
    except Exception:  # noqa: BLE001 — not all RpcErrors carry it
        md = ()
    for k, v in md:
        if k == LEADER_HINT_KEY and v:
            return str(v)
    try:
        details = e.details() or ""
    except Exception:  # noqa: BLE001
        details = str(e)
    m = _LEADER_HINT_RE.search(details)
    return m.group(1) if m else None


class RetryPolicy:
    """Bounded retry of retryable statuses with jittered backoff."""

    def __init__(self, attempts: int = 6, base_ms: float = 50.0,
                 max_ms: float = 5000.0, *, sleep=None, rng=None):
        self.attempts = max(int(attempts), 1)
        self.base_ms = float(base_ms)
        self.max_ms = float(max_ms)
        self._sleep = time.sleep if sleep is None else sleep
        self._rng = random.Random() if rng is None else rng
        self.retries = 0  # total retries performed over this policy
        self.leader_follows = 0  # retries that followed a leader hint

    def next_delay_ms(self, attempt: int,
                      hint_ms: int | None = None) -> float:
        if hint_ms is not None:
            return hint_ms * (1.0 + 0.5 * self._rng.random())
        cap = min(self.max_ms, self.base_ms * (1 << attempt))
        return max(1.0, cap * self._rng.random())

    def call(self, fn, *args, on_leader_hint=None, **kwargs):
        """Call `fn`, retrying retryable statuses. `on_leader_hint`
        (optional) makes a NOT_LEADER refusal — a HINTED_RETRYABLE
        status carrying a leader hint — followable: the callback
        receives the hinted address (rebind your channel/stub there)
        and the call retries with the same jittered backoff. Without
        the callback, hinted errors surface like any non-retryable."""
        for attempt in range(self.attempts):
            try:
                return fn(*args, **kwargs)
            except grpc.RpcError as e:
                code = None
                try:
                    code = e.code()
                except Exception:  # noqa: BLE001
                    pass
                hint = None
                if (on_leader_hint is not None
                        and code in HINTED_RETRYABLE_CODES):
                    hint = leader_hint_from_error(e)
                if ((not is_retryable(code) and hint is None)
                        or attempt == self.attempts - 1):
                    raise
                self.retries += 1
                if hint is not None:
                    self.leader_follows += 1
                    on_leader_hint(hint)
                delay = self.next_delay_ms(
                    attempt, retry_after_ms_from_error(e))
                self._sleep(delay / 1000.0)
        raise AssertionError("unreachable")  # loop always returns/raises
