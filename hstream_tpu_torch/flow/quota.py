"""Hierarchical quota tree: cluster -> tenant -> stream.

Scopes are strings: ``"cluster"``, ``"tenant/<ns>"``, ``"stream/<name>"``.
A stream's tenant is its namespace prefix — the part before the first
``/`` or ``.`` in the stream name (``acme/orders`` and ``acme.events``
both belong to tenant ``acme``; an unseparated name has no tenant
level). Admission walks stream -> tenant -> cluster and every
configured level must admit; the reported retry-after is the slowest
level's.

The tree itself is read-mostly: admission fetches nodes with plain dict
gets (GIL-atomic), mutation holds a lock and swaps whole nodes, so the
hot path takes no tree-level lock.
"""

# A copy of hstream_tpu/flow/quota.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import json
import threading
import time
from dataclasses import asdict, dataclass

from hstream_tpu_torch.flow.bucket import TokenBucket

SCOPE_CLUSTER = "cluster"

_QUOTA_FIELDS = ("records_per_s", "bytes_per_s", "read_records_per_s",
                 "burst_records", "burst_bytes")


@dataclass(frozen=True)
class Quota:
    """Limits of one scope; None = unlimited on that axis. Burst
    defaults to one second's worth of the matching rate. Every set
    field must be positive — a zero rate is not "block everything", it
    is a config error (use stream deletion or ACLs to block)."""

    records_per_s: float | None = None
    bytes_per_s: float | None = None
    read_records_per_s: float | None = None
    burst_records: float | None = None
    burst_bytes: float | None = None

    def __post_init__(self) -> None:
        for field in _QUOTA_FIELDS:
            v = getattr(self, field)
            if v is not None and (v != v or v <= 0.0):  # NaN or <= 0
                raise ValueError(
                    f"quota {field} must be positive, got {v!r}")
        # a burst without its rate builds no bucket — refuse the no-op
        # instead of letting the operator believe a cap exists
        if self.burst_records is not None and self.records_per_s is None:
            raise ValueError("burst_records needs records_per_s")
        if self.burst_bytes is not None and self.bytes_per_s is None:
            raise ValueError("burst_bytes needs bytes_per_s")
        if all(getattr(self, f) is None for f in _QUOTA_FIELDS):
            raise ValueError("quota must set at least one limit")

    def to_json(self) -> dict:
        return {k: v for k, v in asdict(self).items() if v is not None}

    @classmethod
    def from_json(cls, d: dict) -> "Quota":
        unknown = set(d) - set(_QUOTA_FIELDS)
        if unknown:
            raise ValueError(f"unknown quota field(s) {sorted(unknown)}")
        return cls(**{k: (None if d[k] is None else float(d[k]))
                      for k in d})

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Quota":
        return cls.from_json(json.loads(raw))

    def to_bytes(self) -> bytes:
        return json.dumps(self.to_json(), sort_keys=True).encode()


def tenant_of(stream: str) -> str | None:
    """Namespace prefix of a stream name, or None when unseparated."""
    cut = min((i for i in (stream.find("/"), stream.find("."))
               if i > 0), default=-1)
    return stream[:cut] if cut > 0 else None


def validate_scope(scope: str) -> str:
    if scope == SCOPE_CLUSTER:
        return scope
    kind, _, name = scope.partition("/")
    if kind in ("tenant", "stream") and name:
        return scope
    raise ValueError(
        f"bad quota scope {scope!r}: use 'cluster', 'tenant/<ns>' "
        f"or 'stream/<name>'")


class _Node:
    """Buckets of one scope (built whole, swapped atomically)."""

    __slots__ = ("quota", "records", "bytes", "reads")

    def __init__(self, quota: Quota, clock):
        self.quota = quota
        self.records = (None if quota.records_per_s is None else
                        TokenBucket(quota.records_per_s,
                                    quota.burst_records, clock=clock))
        self.bytes = (None if quota.bytes_per_s is None else
                      TokenBucket(quota.bytes_per_s,
                                  quota.burst_bytes, clock=clock))
        self.reads = (None if quota.read_records_per_s is None else
                      TokenBucket(quota.read_records_per_s, clock=clock))


class QuotaTree:
    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._nodes: dict[str, _Node] = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._nodes)

    # ---- configuration ----
    def set(self, scope: str, quota: Quota) -> None:
        validate_scope(scope)
        with self._lock:
            self._nodes[scope] = _Node(quota, self._clock)

    def unset(self, scope: str) -> None:
        with self._lock:
            self._nodes.pop(scope, None)

    def get(self, scope: str) -> Quota | None:
        node = self._nodes.get(scope)
        return None if node is None else node.quota

    def scopes(self) -> dict[str, Quota]:
        with self._lock:
            return {s: n.quota for s, n in self._nodes.items()}

    # ---- admission ----
    def _walk(self, stream: str) -> list[_Node]:
        nodes = []
        n = self._nodes.get(f"stream/{stream}")
        if n is not None:
            nodes.append(n)
        ns = tenant_of(stream)
        if ns is not None:
            n = self._nodes.get(f"tenant/{ns}")
            if n is not None:
                nodes.append(n)
        n = self._nodes.get(SCOPE_CLUSTER)
        if n is not None:
            nodes.append(n)
        return nodes

    def admit_append(self, stream: str, n_records: int,
                     n_bytes: int) -> float:
        """0.0 = admitted (tokens consumed at every level), else the
        retry-after in seconds (nothing consumed). Peek-then-take: a
        race between the phases at worst drives a bucket into debt,
        which later refills repay — sustained rate still converges."""
        nodes = self._walk(stream)
        wait = 0.0
        for node in nodes:
            if node.records is not None:
                wait = max(wait, node.records.peek(n_records))
            if node.bytes is not None:
                wait = max(wait, node.bytes.peek(n_bytes))
        if wait > 0.0:
            return wait
        for node in nodes:
            if node.records is not None:
                node.records.take(n_records)
            if node.bytes is not None:
                node.bytes.take(n_bytes)
        return 0.0

    def peek_read(self, stream: str) -> float:
        """Wait until ONE read token is available at every configured
        level (reads charge after the fact via charge_read)."""
        wait = 0.0
        for node in self._walk(stream):
            if node.reads is not None:
                wait = max(wait, node.reads.peek(1.0))
        return wait

    def charge_read(self, stream: str, n_records: int) -> None:
        for node in self._walk(stream):
            if node.reads is not None:
                node.reads.take(n_records)
