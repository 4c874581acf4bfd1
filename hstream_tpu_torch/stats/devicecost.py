"""The device cost plane.

A copy of hstream_tpu/stats/devicecost.py; the port imports nothing of
the JAX package. Its three pieces:

* **HBM arena accounting** — `plane_bytes` folds a {name: tensor}
  mapping into per-plane bytes (`nbytes` is shape metadata: no launch,
  no copy), which the executors' `device_plane_bytes()` return;
  `sample_device_gauges` folds them per query and per plane into the
  `device_hbm_bytes` / `device_arena_bytes` gauges at scrape time, plus
  a process total cross-checked against the caching allocator's own
  count (`torch.cuda.memory_allocated`, where the reference reads the
  backend's `memory_stats()`). On the CPU the backend gauge is absent,
  as the reference's is on a backend without memory stats.

* **Compiled-program inventory** — `PROGRAMS` keeps one row per
  distinct program the port compiles. The reference wraps jax's compile
  funnel; the port's compiles are its own and all report through
  `common.tracing.note_compile`: the kernel library's build or load
  (`engine/kernels/build.py`, once a process) and a miss of the program
  factories `lattice.compiled`, `expr.lower` and `expr.launch_plan`.
  A row keeps the reference's fields: the kernel family (the
  dispatching thread's `kernel_family` scope — factories run
  synchronously inside the triggering call), the shape key (crc32 of
  the factory's arguments, which carry every shape), the factory's
  name, compile count and milliseconds. `flops` and `bytes_accessed`
  stay None: nothing here has XLA's cost analysis.

* **Per-dispatch device time** — `DEVICE_TIME` is the deterministic
  1/N sampler `common.tracing.kernel_family` consults. The reference
  fences with `jax.block_until_ready` before and after the body
  (devicecost.py:311-327). Here, on the card, a sampled dispatch
  records a CUDA event on the stream its kernels launch on (PyTorch's
  current stream of the tensors' device: the kernels' wrappers launch
  there, never on the executors' copy streams) before the body and
  another after it, waits on the second only then, and records the
  events' elapsed milliseconds. Work already queued on the stream
  finishes before the first event, so it is not counted; no dispatch
  that is not sampled waits on anything. On the CPU it takes the wall
  clock around the body. Disarmed cost is ONE attribute read + one
  branch, and the disarmed sampler records ZERO state.

  What a sample reads is the span of the dispatch scope on the
  device's timeline, as the reference's fenced wall time is: the
  kernels, and the host's launch path between them whenever the card
  waits on it. It is not the kernels' own device time. While the
  launch path inside a scope is longer than its kernels (a window step
  on the H100: ~0.41 ms of host path, ~0.05 ms of kernels), a kernel
  change barely moves the family's reading; per-kernel device time
  comes from the profiler (`common.tracing.torch_profiler`).
"""

from __future__ import annotations

import threading
import time
import weakref
import zlib
from collections import OrderedDict, deque
from typing import NamedTuple

import torch

# ---- HBM arena accounting ---------------------------------------------------


# contract: dispatches<=0 fetches<=0
def plane_bytes(planes) -> dict[str, int]:
    """Per-plane device bytes of a {name: tensor} mapping — `nbytes` is
    shape metadata, so the walk costs zero launches and zero transfers
    however large the arenas are."""
    out: dict[str, int] = {}
    for name, arr in dict(planes).items():
        nb = getattr(arr, "nbytes", None)
        if nb:
            out[str(name)] = int(nb)
    return out


def backend_hbm_bytes(device=None) -> int | None:
    """Bytes the caching allocator holds in tensors on the card
    (`torch.cuda.memory_allocated`), or None where there is none to
    read: a CPU device, a process with no card, or one that has not
    touched the card yet (a scrape never starts a CUDA context). The
    cross-check axis for the per-plane fold: the two agree up to the
    tensors outside the arenas (staging buffers, kernel scratch)."""
    try:
        if device is not None and torch.device(device).type != "cuda":
            return None
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return None
        return int(torch.cuda.memory_allocated(device)) or None
    except Exception:  # noqa: BLE001 — accounting must never throw
        return None


def sample_device_gauges(ctx) -> None:
    """Scrape-time fold of every live query's arena bytes into the
    device gauges (called from prometheus.sample_gauges under the
    scrape lock). Cost is O(live planes) attribute reads — zero device
    work — and stale per-query series are swept like every other
    query-labeled gauge."""
    stats = ctx.stats
    tasks = dict(getattr(ctx, "running_queries", {}))
    live: set[tuple[str, str]] = set()
    total = 0
    for qid, task in tasks.items():
        fn = getattr(task, "device_plane_bytes", None)
        if fn is None:
            continue
        try:
            planes = fn()
        except Exception:  # noqa: BLE001 — a task tearing down mid-
            continue       # scrape must not fail the scrape
        q_total = 0
        for plane, nb in sorted(planes.items()):
            key = f"{qid}/{plane}"
            stats.gauge_set("device_arena_bytes", key, nb)
            live.add(("device_arena_bytes", key))
            q_total += nb
        stats.gauge_set("device_hbm_bytes", qid, q_total)
        live.add(("device_hbm_bytes", qid))
        total += q_total
    from hstream_tpu_torch.stats.prometheus import _drop_stale

    _drop_stale(stats, ("device_arena_bytes", "device_hbm_bytes"), live)
    stats.gauge_set("device_hbm_total_bytes", "", total)
    backend = backend_hbm_bytes(getattr(ctx, "device", None))
    if backend is not None:
        stats.gauge_set("device_hbm_backend_bytes", "", backend)


def query_hbm_bytes(ctx, qid: str) -> dict:
    """{total, planes} for one query — the flight recorder's HBM page
    and the admin surface's per-query answer."""
    task = dict(getattr(ctx, "running_queries", {})).get(qid)
    fn = getattr(task, "device_plane_bytes", None) if task else None
    if fn is None:
        return {"total": 0, "planes": {}}
    try:
        planes = {k: int(v) for k, v in sorted(fn().items())}
    except Exception:  # noqa: BLE001
        return {"total": 0, "planes": {}}
    return {"total": sum(planes.values()), "planes": planes}


# ---- compiled-program inventory ---------------------------------------------


def shape_key(*parts) -> str:
    """crc32 of a compile's arguments (their repr carries every shape,
    dtype and literal): two compiles of equal arguments share a key."""
    return f"{zlib.crc32(repr(parts).encode()):08x}"


class ProgramInventory:
    """Process-wide catalog of every program the port compiled, keyed
    by shape key — two compiles of the same arguments share one row; a
    new shape is a new row. Bounded LRU: past MAX_ROWS the oldest row
    folds into the `evicted` count rather than growing without bound.

    Rows are kept once `install()` ran (the server's context calls it),
    as the reference keeps them once its compile-funnel wrapper is in
    place. The port has no funnel to wrap: `common.tracing.note_compile`
    reports every compile to `record`, so `install` cannot fail."""

    MAX_ROWS = 512

    def __init__(self):
        self._rows: "OrderedDict[str, dict]" = OrderedDict()
        self._lock = threading.Lock()
        self._installed = False
        self.evicted = 0

    def install(self) -> bool:
        """Start keeping rows (idempotent). Always True."""
        with self._lock:
            self._installed = True
            return True

    def record(self, name: str, key: str, compile_ms: float) -> None:
        """One compile of program `name` with shape key `key`, which
        took `compile_ms` on the host (the factory's body; the kernel
        library's nvcc build or load)."""
        if not self._installed:
            return
        from hstream_tpu_torch.common.tracing import current_kernel_family

        family = current_kernel_family()
        now_ms = time.time() * 1e3
        with self._lock:
            row = self._rows.get(key)
            if row is None:
                while len(self._rows) >= self.MAX_ROWS:
                    self._rows.popitem(last=False)
                    self.evicted += 1
                row = {"shape_key": key, "name": name or "?",
                       "family": family or "", "compiles": 0,
                       "compile_ms": 0.0, "flops": None,
                       "bytes_accessed": None,
                       "first_unix_ms": round(now_ms, 1)}
                self._rows[key] = row
            else:
                self._rows.move_to_end(key)
            row["compiles"] += 1
            row["compile_ms"] = round(row["compile_ms"] + compile_ms, 3)
            if family:
                row["family"] = family
            row["last_unix_ms"] = round(now_ms, 1)

    def rows(self) -> list[dict]:
        """Newest-compiled last (the LRU order), each row a plain
        JSON-ready dict."""
        with self._lock:
            return [dict(r) for r in self._rows.values()]

    def summary(self) -> dict:
        with self._lock:
            rows = list(self._rows.values())
            return {
                "programs": len(rows),
                "evicted": self.evicted,
                "installed": self._installed,
                "total_compile_ms": round(
                    sum(r["compile_ms"] for r in rows), 3),
                "total_compiles": sum(r["compiles"] for r in rows),
            }


PROGRAMS = ProgramInventory()


# ---- per-dispatch device time -----------------------------------------------


def _device_of(values) -> torch.device | None:
    """The device of the first tensor in a tensor, mapping or sequence
    (nested), or None when there is none."""
    if isinstance(values, torch.Tensor):
        return values.device
    if isinstance(values, dict):
        values = list(values.values())
    if isinstance(values, (list, tuple)):
        for v in values:
            dev = _device_of(v)
            if dev is not None:
                return dev
    return None


class Mark(NamedTuple):
    """The pre-body half of a sampled dispatch: the wall clock, and on
    the card the start event and the stream it was recorded on."""
    t0: float
    start: "torch.cuda.Event | None"
    stream: "torch.cuda.Stream | None"


class DeviceTimeSampler:
    """Deterministic 1/N device-time sampling for kernel_family scopes.

    `active` is a plain attribute (False while disarmed) — the
    disarmed hot-path cost inside `kernel_family` is one attribute
    read + one branch, and the disarmed sampler holds ZERO state (no
    tick counters, no sample rings). Armed, every Nth dispatch per
    family is measured (a CUDA event pair on the card, the wall clock
    on the CPU); the milliseconds land in the bounded per-family rings
    (bench attribution) and in every registered stats sink's
    `kernel_device_ms{family}` histogram. A sample spans the dispatch
    scope on the device's timeline (the host's launch path inside the
    scope and the kernels), not the kernels alone: see the module's
    docstring."""

    MAX_SAMPLES = 256

    def __init__(self):
        self.active = False
        self.rate = 0
        self._counts: dict[str, int] = {}
        self._samples: dict[str, deque] = {}
        self._sinks: list = []  # weakrefs: torn-down holders must die
        self._lock = threading.Lock()

    def arm(self, rate: int) -> None:
        with self._lock:
            self.rate = max(1, int(rate))
            self.active = True

    def disarm(self) -> None:
        with self._lock:
            self.active = False
            self.rate = 0

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._samples.clear()

    def add_sink(self, stats) -> None:
        with self._lock:
            if not any(ref() is stats for ref in self._sinks):
                self._sinks.append(weakref.ref(stats))

    # contract: dispatches<=0 fetches<=0
    def tick(self, family: str) -> bool:
        """The deterministic sampling decision: true on every Nth
        dispatch of the family. Only ever called armed."""
        with self._lock:
            c = self._counts.get(family, 0) + 1
            self._counts[family] = c
            return self.rate > 0 and c % self.rate == 0

    # contract: dispatches<=0 fetches<=0
    def fence(self, ready) -> Mark:
        """Mark the start of a sampled dispatch. `ready()` gives the
        dispatch's live tensors (read now, after any earlier dispatch
        replaced them); on the card a timing event goes onto the
        current stream of their device, behind the work queued there."""
        dev = _device_of(ready())
        if dev is not None and dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            return Mark(time.perf_counter(), start, stream)
        return Mark(time.perf_counter(), None, None)

    # contract: dispatches<=0 fetches<=1
    def measure(self, family: str, mark: Mark) -> None:
        """Post-body half of a sampled dispatch: on the card, record the
        end event on the same stream, wait for it and take the pair's
        elapsed milliseconds; on the CPU, the wall clock since the
        mark."""
        if mark.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(mark.stream)
            end.synchronize()
            ms = mark.start.elapsed_time(end)
        else:
            ms = (time.perf_counter() - mark.t0) * 1e3
        self.record(family, ms)

    # contract: dispatches<=0 fetches<=0
    def record(self, family: str, ms: float) -> None:
        with self._lock:
            ring = self._samples.get(family)
            if ring is None:
                ring = deque(maxlen=self.MAX_SAMPLES)
                self._samples[family] = ring
            ring.append(float(ms))
            sinks = list(self._sinks)
        dead = []
        for ref in sinks:
            stats = ref()
            if stats is None:
                dead.append(ref)
                continue
            try:
                stats.observe("kernel_device_ms", family, float(ms))
            except Exception:  # noqa: BLE001 — metrics plumbing must
                pass           # never fail a dispatch
        if dead:
            with self._lock:
                for ref in dead:
                    if ref in self._sinks:
                        self._sinks.remove(ref)

    def state(self) -> dict:
        """Everything the sampler remembers — the disarmed-witness
        gate asserts this is empty after a disarmed run."""
        with self._lock:
            return {"counts": dict(self._counts),
                    "samples": {k: len(v)
                                for k, v in self._samples.items()}}

    def samples(self, family: str) -> list[float]:
        """The family's ring of sampled milliseconds, oldest first."""
        with self._lock:
            return list(self._samples.get(family, ()))

    def percentiles(self) -> dict[str, dict[str, float]]:
        """family -> {count, p50, p99} over the bounded sample rings
        (the bench's device_time_ms attribution)."""
        out: dict[str, dict[str, float]] = {}
        with self._lock:
            rings = {k: sorted(v) for k, v in self._samples.items() if v}
        for fam, xs in rings.items():
            n = len(xs)
            out[fam] = {
                "count": n,
                "p50": round(xs[n // 2], 4),
                "p99": round(xs[min(n - 1, (n * 99) // 100)], 4),
            }
        return out


DEVICE_TIME = DeviceTimeSampler()
