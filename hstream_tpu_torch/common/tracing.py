"""First-class step tracing (SURVEY §5.1).

The reference has no tracing at all — its closest artifact is a
logDebug inside the poll loop (Processor.hs:131-133). Here every query
task records per-batch stage timings (decode, key-encode, device step,
emission, snapshot) into a bounded ring per query, cheap enough to stay
always-on: one perf_counter pair per stage, no allocation beyond the
ring slot.

`trace_span(tracer, stage)` is the instrumentation point;
`QueryTracer.summary()` aggregates count/total/mean/p50/p95 per stage
for the admin surface (admin CLI `trace` command, HTTP /queries/<id>).
`torch_profiler(log_dir)` wraps torch.profiler for deep device profiles
(a trace file in `log_dir`) when an operator asks for one.

Cross-component trace spans: `SpanCollector` keeps bounded per-scope
rings of completed spans (trace id + span id + parent), exported as
Chrome trace-event JSON. The trace id IS the request id (propagated
client -> gateway -> handler), so one sampled request's journey — RPC
handler, append-front stages, the query task's pipeline stages,
subscription delivery — shares one id. Disarmed cost is ONE attribute
read + one branch (`collector.active`, the FlowGovernor / FAULTS
discipline); the sampling decision is a deterministic hash of the trace
id so every component agrees without coordination.

`kernel_family` scopes the engine's kernel dispatches (step, close,
session, probe): a dispatch observer's host time, the device-time
sampler (stats/devicecost.DEVICE_TIME) and the attribution of
recompiles. The recompile counter counts the port's own compiles
(`note_compile`): a build or load of the kernel library and a miss in
the engine's program factories.
"""

# A copy of hstream_tpu/common/tracing.py; the port imports nothing of the JAX
# package. Its jax hooks have torch twins: jax_profiler is torch_profiler,
# and the recompile counter listens to the port's compiles, not to
# jax.monitoring.

from __future__ import annotations

import contextlib
import contextvars
import functools
import os
import threading
import time
import uuid
import zlib
from collections import defaultdict, deque, OrderedDict

from hstream_tpu_torch.stats.devicecost import DEVICE_TIME as _DEVICE_TIME
from hstream_tpu_torch.stats.devicecost import PROGRAMS as _PROGRAMS
from hstream_tpu_torch.stats.devicecost import shape_key as _shape_key


class QueryTracer:
    """Bounded per-stage duration rings for one query.

    `observer(stage, seconds)` (optional) is invoked on every record —
    the hook the stats holder's stage-latency histograms ride, so the
    rings stay self-contained while /metrics sees every span.
    `request_id` carries the correlation id of the request that created
    the query, surfaced by summary() / admin trace."""

    def __init__(self, capacity: int = 512, *, observer=None):
        self._cap = capacity
        self._rings: dict[str, deque[float]] = defaultdict(
            lambda: deque(maxlen=capacity))
        self._counts: dict[str, int] = defaultdict(int)
        self._totals: dict[str, float] = defaultdict(float)
        self._lock = threading.Lock()
        self._observer = observer
        self.request_id: str | None = None
        # cross-component trace binding: when the request
        # that created this query was SAMPLED, every completed stage
        # timing also lands as a span in the collector's per-query
        # ring, under the creating request's trace id. Unbound cost:
        # one attribute read + one branch per record().
        self._spans: "SpanCollector | None" = None
        self._span_scope: str | None = None
        self._trace_id: str | None = None
        self._parent_span: str = ""

    def bind_trace(self, collector: "SpanCollector", *, scope: str,
                   trace_id: str, parent_id: str = "") -> None:
        """Attach this tracer's stage timings to a sampled trace: spans
        land in `collector` under `scope` (the query id), parented on
        the creating request's handler span."""
        self._span_scope = scope
        self._trace_id = trace_id
        self._parent_span = parent_id
        self._spans = collector

    def record(self, stage: str, seconds: float) -> None:
        with self._lock:
            self._rings[stage].append(seconds)
            self._counts[stage] += 1
            self._totals[stage] += seconds
        if self._observer is not None:
            try:
                self._observer(stage, seconds)
            except Exception:  # noqa: BLE001 — observers are metrics
                pass           # plumbing; never fail the traced stage
        spans = self._spans
        if spans is not None:
            try:
                dur_ms = seconds * 1e3
                spans.record_span(
                    self._span_scope, stage,
                    trace_id=self._trace_id, span_id=new_span_id(),
                    parent_id=self._parent_span,
                    t0_ms=time.time() * 1e3 - dur_ms, dur_ms=dur_ms)
            except Exception:  # noqa: BLE001 — span plumbing must
                pass           # never fail the traced stage

    def summary(self) -> dict[str, dict[str, float]]:
        """stage -> {count, total_ms, mean_ms, p50_ms, p95_ms} over the
        ring (percentiles) and lifetime (count/total)."""
        out: dict[str, dict[str, float]] = {}
        with self._lock:
            for stage, ring in self._rings.items():
                if not ring:
                    continue
                xs = sorted(ring)
                n = len(xs)
                out[stage] = {
                    "count": self._counts[stage],
                    "total_ms": round(self._totals[stage] * 1e3, 3),
                    "mean_ms": round(
                        self._totals[stage] / self._counts[stage] * 1e3,
                        3),
                    "p50_ms": round(xs[n // 2] * 1e3, 3),
                    "p95_ms": round(xs[min(n - 1, (n * 95) // 100)] * 1e3,
                                    3),
                }
        if self.request_id:
            out["request"] = {"id": self.request_id}
        return out


@contextlib.contextmanager
def trace_span(tracer: QueryTracer | None, stage: str):
    """Time a stage into the tracer; no-op when tracer is None."""
    if tracer is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        tracer.record(stage, time.perf_counter() - t0)


# ---- cross-component trace spans --------------------------------

# gRPC metadata / HTTP header keys the trace context travels under.
# The trace id itself rides the existing x-request-id; only the parent
# span id needs a new key.
TRACE_ID_KEY = "x-trace-id"
PARENT_SPAN_KEY = "x-parent-span"

# THE declared stage vocabulary: every span name / trace_span stage /
# append-stage literal must come from this set. The analyzer registry
# pass cross-checks call sites against it (a renamed stage would
# otherwise silently orphan its stage_latency_ms series and its spans).
TRACE_STAGES = frozenset({
    # query-task pipeline stages (QueryTracer rings + stage_latency_ms)
    "decode", "key_encode", "step", "emit", "snapshot", "close",
    # framed-append stages (handlers.APPEND_STAGES)
    "append_decode", "append_admit", "append_handoff", "append_store",
    # RPC entry span + the freshness lag taxonomy (freshness_lag_ms
    # stage labels double as span names where a span exists)
    "rpc", "ingest", "engine", "delivery",
})

# kernel dispatch families (per-family dispatch histograms + recompile
# attribution) — also cross-checked by the analyzer registry pass
KERNEL_FAMILIES = frozenset({"step", "close", "probe", "session"})


def new_span_id() -> str:
    return uuid.uuid4().hex[:12]


# the active span (trace_id, span_id) of the current request, bound by
# the handler wrapper so nested instrumentation (append stages,
# subscription delivery) can parent its spans without plumbing
_span_ctx: "contextvars.ContextVar[tuple[str, str] | None]" = \
    contextvars.ContextVar("hstream_span", default=None)


def current_span() -> tuple[str, str] | None:
    """(trace_id, span_id) of the active sampled request, or None."""
    return _span_ctx.get()


@contextlib.contextmanager
def span_scope(trace_id: str, span_id: str):
    token = _span_ctx.set((trace_id, span_id))
    try:
        yield
    finally:
        _span_ctx.reset(token)


class SpanCollector:
    """Bounded per-scope rings of completed spans + the sampling knob.

    A scope is the unit of export: a query id (`GET
    /queries/<id>/trace`), a stream name (append-path spans), or a
    subscription id (delivery spans). Rings are bounded per scope AND
    the scope set itself is LRU-bounded, so a client looping over
    random stream names cannot grow the collector without bound.

    `active` is a plain attribute (False at sample rate 0) — the
    disarmed hot-path cost is one attribute read + one branch, the
    FlowGovernor / FAULTS discipline; `bench.py --smoke` gates that
    arming the collector compiles nothing."""

    def __init__(self, sample_rate: float = 0.0, *,
                 ring_capacity: int = 512, max_scopes: int = 256):
        self.sample_rate = max(0.0, min(float(sample_rate), 1.0))
        self.active = self.sample_rate > 0.0
        self._cap = int(ring_capacity)
        self._max_scopes = int(max_scopes)
        self._rings: "OrderedDict[str, deque]" = OrderedDict()
        self._lock = threading.Lock()

    def sampled(self, trace_id: str) -> bool:
        """Deterministic per-trace sampling decision: every component
        hashing the same trace id reaches the same verdict, so a trace
        is recorded whole or not at all."""
        if not self.active or not trace_id:
            return False
        if self.sample_rate >= 1.0:
            return True
        return (zlib.crc32(trace_id.encode()) % 10_000
                < self.sample_rate * 10_000)

    def record_span(self, scope: str, stage: str, *, trace_id: str,
                    span_id: str, parent_id: str = "",
                    t0_ms: float, dur_ms: float, **attrs) -> None:
        """Append one completed span to the scope's ring. `t0_ms` is
        wall epoch milliseconds; attrs must be JSON-serializable."""
        span = {"stage": stage, "trace_id": trace_id,
                "span_id": span_id, "parent_id": parent_id,
                "t0_ms": round(float(t0_ms), 3),
                "dur_ms": round(float(dur_ms), 3)}
        if attrs:
            span["attrs"] = attrs
        with self._lock:
            ring = self._rings.get(scope)
            if ring is None:
                while len(self._rings) >= self._max_scopes:
                    self._rings.popitem(last=False)  # LRU scope bound
                ring = deque(maxlen=self._cap)
                self._rings[scope] = ring
            else:
                self._rings.move_to_end(scope)
            ring.append(span)

    def spans(self, scope: str) -> list[dict]:
        with self._lock:
            ring = self._rings.get(scope)
            return list(ring) if ring is not None else []

    def scopes(self) -> list[str]:
        with self._lock:
            return sorted(self._rings)

    def export_chrome(self, scope: str) -> dict:
        """The scope's ring as Chrome trace-event JSON (load in
        chrome://tracing or Perfetto): complete ("ph": "X") events,
        microsecond timestamps, trace/span ids in args."""
        events = []
        for s in self.spans(scope):
            events.append({
                "name": s["stage"],
                "cat": "hstream",
                "ph": "X",
                "ts": round(s["t0_ms"] * 1000.0, 1),   # us
                "dur": max(round(s["dur_ms"] * 1000.0, 1), 1),
                "pid": 1,
                "tid": scope,
                "args": {"trace_id": s["trace_id"],
                         "span_id": s["span_id"],
                         "parent_id": s["parent_id"],
                         **s.get("attrs", {})},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---- kernel dispatch families ------------------------------------------------
#
# One thread-local scope names the kernel family currently being
# dispatched on this thread. The port's compiles (a kernel-library build,
# a program-factory miss) run synchronously inside the first call, so
# `note_compile` reads the scope to attribute a recompile to the factory
# family that triggered it — RetraceGuard's count otherwise collapses
# everything into one undifferentiated number.

_family_tls = threading.local()


def current_kernel_family() -> str | None:
    return getattr(_family_tls, "name", None)


@contextlib.contextmanager
def kernel_family(family: str, observer=None, *, ready=None):
    """Scope a kernel dispatch under a family name. When `observer`
    (a callable (family, seconds)) is set, the dispatch's host time
    lands there — the per-family dispatch-time histograms ride this.
    Cost with no observer: two thread-local attribute writes.

    `ready` — a zero-arg callable returning the dispatch's live device
    tensors — opts the site into the device-time sampler: on a
    deterministically sampled dispatch a CUDA event goes onto the
    tensors' stream before the body and another after it, and the
    pair's elapsed time lands in `kernel_device_ms{family}` (the wall
    clock on the CPU): the scope's span on the device's timeline, the
    host's launch path inside it included, not the kernels alone
    (stats.devicecost). Disarmed cost is one attribute read + one branch
    (the FAULTS / FlowGovernor discipline); the disarmed sampler
    records zero state."""
    prev = getattr(_family_tls, "name", None)
    _family_tls.name = family
    mark = None
    if (ready is not None and _DEVICE_TIME.active
            and _DEVICE_TIME.tick(family)):
        try:
            mark = _DEVICE_TIME.fence(ready)
        except Exception:  # noqa: BLE001 — sampling must never fail
            mark = None        # a dispatch
    t0 = time.perf_counter() if observer is not None else 0.0
    try:
        yield
    finally:
        _family_tls.name = prev
        if mark is not None:
            try:
                _DEVICE_TIME.measure(family, mark)
            except Exception:  # noqa: BLE001 — sampling must never
                pass           # fail a dispatch
        if observer is not None:
            try:
                observer(family, time.perf_counter() - t0)
            except Exception:  # noqa: BLE001 — observers are metrics
                pass           # plumbing; never fail a dispatch


@contextlib.contextmanager
def torch_profiler(log_dir: str):
    """Deep device profile around a block: torch.profiler over the CPU
    and, where the process has a card, CUDA activity, written into
    `log_dir` as a trace file (TensorBoard's format,
    `*.pt.trace.json`) when the block ends. Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


# ---- recompile guard -----------------------------------------------------------
#
# The hot-path contracts (one step launch per batch, one close launch per
# cycle, lru_cache'd program factories) all cash out as ONE observable:
# steady-state batches compile ZERO new programs. RetraceGuard checks
# the outcome at runtime by counting the port's compiles, each reported
# through `note_compile`:
#
# * the kernel library's build or load (engine/kernels/build.py
#   `build()`, once per process);
# * a miss in the engine's program factories, all lru_caches:
#   `lattice.compiled` (a query's step and close programs),
#   `expr.lower` (an expression's register form) and `expr.launch_plan`
#   (a program set's argument blocks). Helpers such as
#   `lattice.divisor` or `transport.sm_count` are not programs and do
#   not count.
#
# The reference listens to jax.monitoring's backend-compile event
# instead; the stats it feeds (kernel_recompiles per stream,
# factory_recompiles per family) are the same.

_active_guards: set["RetraceGuard"] = set()
_guard_lock = threading.Lock()
# weakrefs: a ServerContext torn down mid-process (tests spin up many)
# must not be kept alive by the process-wide counter
_stats_sinks: list[tuple[object, str]] = []  # (weakref to holder, stream)


def note_compile() -> None:
    """Count one of the port's compiles in every active guard and stats
    sink."""
    with _guard_lock:
        guards = list(_active_guards)
        sinks = list(_stats_sinks)
    for g in guards:
        g._bump()
    if not sinks:
        return
    # stream attribution: a compile seen while a NAMED guard is active
    # counts against that guard's stream (the query/bench scope being
    # driven), not the sink's default "_process" pseudo-stream
    names = sorted({g.name for g in guards if g.name})
    # factory attribution: compiles run synchronously inside the
    # triggering call, so the dispatching thread's kernel_family scope
    # names the factory family
    family = current_kernel_family()
    dead = []
    for ref, stream in sinks:
        stats = ref()
        if stats is None:
            dead.append((ref, stream))
            continue
        try:
            for target in (names or [stream]):
                stats.stream_stat_add("kernel_recompiles", target)
            if family:
                stats.stream_stat_add("factory_recompiles", family)
        except Exception:  # noqa: BLE001 — monitoring must
            pass           # never break a compile
    if dead:
        with _guard_lock:
            for ent in dead:
                if ent in _stats_sinks:
                    _stats_sinks.remove(ent)


def compile_site(name: str):
    """Decorator of a program factory (under its lru_cache): each call
    that reaches it — a cache miss — counts one compile (note_compile)
    and lands one row in the compiled-program inventory
    (stats.devicecost.PROGRAMS) under `name`, keyed by the arguments,
    with the body's host milliseconds."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            note_compile()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _PROGRAMS.record(name, _shape_key(args, kwargs),
                             (time.perf_counter() - t0) * 1e3)
            return out
        return wrapped
    return deco


def install_recompile_counter(stats, stream: str = "_process") -> None:
    """Bump the `kernel_recompiles` per-stream counter on every compile
    of the port in this process — the /metrics face of the retrace
    contract. Idempotent per (holder, stream)."""
    import weakref

    with _guard_lock:
        if not any(ref() is stats and s == stream
                   for ref, s in _stats_sinks):
            _stats_sinks.append((weakref.ref(stats), stream))


class RetraceGuard:
    """Counts the port's compiles while active.

    Usage (tests, bench):

        with RetraceGuard() as g:
            for batch in batches:
                ex.process_columnar(...)
        assert g.count == 0   # steady state must not recompile

    `count` is exact: one per compile anywhere in the process while the
    guard is active (guards are process-global, like the compiles they
    observe — do not run two guarded regions concurrently and expect
    per-region attribution). A factory's cache hit is no compile.

    `name` (optional) attributes compiles observed while this guard is
    active to that stream in every installed stats sink — the query id
    or bench scope being driven — instead of the sink's default
    `_process` pseudo-stream."""

    def __init__(self, name: str | None = None):
        self.count = 0
        self.name = name
        self._lock = threading.Lock()

    def _bump(self) -> None:
        with self._lock:
            self.count += 1

    def __enter__(self) -> "RetraceGuard":
        with _guard_lock:
            _active_guards.add(self)
        return self

    def __exit__(self, *exc) -> None:
        with _guard_lock:
            _active_guards.discard(self)
