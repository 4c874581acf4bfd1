"""Runtime lock-order witness: named locks, held-sets, cycle reports.

The static `lockorder` pass proves the acquisition orders it can SEE
are acyclic — but call chains it cannot type (callbacks, ctx objects
threaded through parameters, native readers) and instance-level
inversions (two locks of one class taken in both orders on different
objects) are invisible to any AST. GoodLock (Havelund) and the kernel's
lockdep close that gap at runtime: maintain each thread's held-set,
grow a global lock-order graph on every acquire-while-holding, and
report a POTENTIAL deadlock the moment the second edge direction
appears — no need for the unlucky schedule that actually deadlocks.

``TracedLock`` is a named wrapper around ``threading.Lock``/``RLock``
adopted by the high-risk subsystems (append front, supervisor,
replica, subscriptions, gateway, query tasks). Names are lock ROLES
(lockdep "lock classes"): every instance of a subsystem shares one
node, so the graph stays small and order rules read like the
documentation ("tasks.state before views.materialization").

Disarmed cost is the FAULTS / FlowGovernor discipline: ``acquire``
pays one attribute read + one branch per registry (LOCKTRACE and
FAULTS) and delegates straight to the inner lock — no held-set, no
graph, no timing. Arm with ``HSTREAM_LOCKTRACE=1`` / server
``--locktrace`` / ``admin locks --arm``; then every acquire maintains
the held-set and graph, ``lock_wait_ms``/``lock_hold_ms`` histograms
and the ``lock_contention`` counter feed /metrics, a detected cycle
journals a ``lock_cycle`` event, and ``admin locks`` renders the
per-lock ledger.

Every traced acquire is also a fault site ``lock.acquire.<name>`` —
the seeded interleaving perturber (``faultinject`` ``yield:N[:SEED]``
schedules) injects deterministic scheduler yields exactly where the
witness watches, so the chaos scenarios explore adversarial
interleavings with the deadlock detector armed.

Semantics notes (unit-tested):

  * re-entrant acquisition of one RLock instance adds no edge and no
    double entry (depth-counted per thread);
  * same-NAME different-instance nesting adds no edge either — a
    self-edge on a lock class needs instance identity to mean
    anything, and the static pass already skips it for the same
    reason;
  * ``threading.Condition(TracedLock(...))`` stays fully traced: the
    condition releases/reacquires through the wrapper, so the held-set
    correctly excludes the lock while waiting.
"""

# A copy of hstream_tpu/common/locktrace.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import os
import threading
import time

from hstream_tpu_torch.common.faultinject import FAULTS
from hstream_tpu_torch.common.logger import get_logger

log = get_logger("locktrace")

ENV_VAR = "HSTREAM_LOCKTRACE"
SITE_PREFIX = "lock.acquire."


class LockTraceRegistry:
    """Process-wide witness state: per-thread held stacks, the
    lock-order graph, per-lock accounting, and reported cycles.

    ``active`` is a plain attribute read unlocked on the hot path
    (same idiom as ``FAULTS.active``); all mutation happens under the
    registry's own plain (untraced) lock."""

    def __init__(self) -> None:
        self.active = False
        self._mu = threading.Lock()
        self._tls = threading.local()
        # held-set generation: disarm() bumps it, and _held() discards
        # any thread's stack tagged with an older generation — so an
        # acquire that straddled a disarm can never leave a stale
        # holder that fabricates edges after a re-arm
        self._gen = 0
        # src name -> {dst names}; witness per edge (first occurrence)
        self._edges: dict[str, set[str]] = {}
        self._witness: dict[tuple[str, str], dict] = {}
        self._cycles: list[dict] = []
        self._cycle_keys: set[frozenset] = set()
        # name -> {"acquires": n, "contentions": n}
        self._counts: dict[str, dict[str, int]] = {}
        self._stats = None   # StatsHolder (bound by ServerContext)
        self._events = None  # EventJournal

    # ---- configuration -----------------------------------------------------

    def bind(self, *, stats=None, events=None) -> None:
        if stats is not None:
            self._stats = stats
        if events is not None:
            self._events = events

    def arm(self) -> None:
        self.active = True
        log.warning("lock-order witness armed")

    def disarm(self) -> None:
        """Disarm and forget: graph, witnesses, counts, cycles. Held
        stacks of live threads are dropped too (generation bump — a
        stack tagged pre-disarm is discarded at its next use), so a
        later re-arm starts from scratch: mid-critical-section arming
        tolerates missing outer holders, which only costs edges, never
        fabricates false ones."""
        with self._mu:
            self.active = False
            self._gen += 1
            self._edges.clear()
            self._witness.clear()
            self._cycles.clear()
            self._cycle_keys.clear()
            self._counts.clear()
        self._tls = threading.local()

    def load_env(self, env: str | None = None) -> bool:
        raw = (env if env is not None
               else os.environ.get(ENV_VAR, "")).strip().lower()
        if raw in ("1", "true", "on", "yes"):
            self.arm()
            return True
        return False

    # ---- witness core ------------------------------------------------------

    def _held(self) -> list:
        ent = getattr(self._tls, "held", None)
        if ent is None or ent[0] != self._gen:
            ent = (self._gen, [])
            self._tls.held = ent
        return ent[1]

    def note_acquire(self, lock: "TracedLock", wait_s: float,
                     contended: bool) -> None:
        """Armed-path bookkeeping after the inner lock is taken."""
        # re-check under no lock: an acquire that passed the wrapper's
        # gate just before a disarm must not record into the fresh
        # state (its release will run disarmed and never pair up)
        if not self.active:
            return
        held = self._held()
        for ent in held:
            if ent[0] is lock:
                ent[2] += 1  # re-entrant: depth only, no edge
                return
        name = lock.name
        new_cycle = None
        with self._mu:
            c = self._counts.setdefault(
                name, {"acquires": 0, "contentions": 0})
            c["acquires"] += 1
            if contended:
                c["contentions"] += 1
            for ent in held:
                src = ent[0].name
                if src == name:
                    continue  # same lock class on another instance
                outs = self._edges.setdefault(src, set())
                if name in outs:
                    continue
                outs.add(name)
                self._witness[(src, name)] = {
                    "thread": threading.current_thread().name,
                    "holding": [e[0].name for e in held],
                }
                ring = self._find_cycle(src, name)
                if ring is not None:
                    key = frozenset(n for e in ring for n in e)
                    if key not in self._cycle_keys:
                        self._cycle_keys.add(key)
                        new_cycle = {
                            "ring": [list(e) for e in ring],
                            "witness": {f"{a}->{b}": self._witness[(a, b)]
                                        for a, b in ring},
                        }
                        self._cycles.append(new_cycle)
        held.append([lock, time.perf_counter(), 1])
        stats = self._stats
        if stats is not None:
            try:
                stats.observe("lock_wait_ms", name, wait_s * 1e3)
                if contended:
                    stats.stream_stat_add("lock_contention", name)
            except Exception:  # noqa: BLE001 — metrics plumbing must
                pass           # never fail an acquire
        if new_cycle is not None:
            self._report_cycle(new_cycle)

    def note_release(self, lock: "TracedLock") -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lock:
                held[i][2] -= 1
                if held[i][2] > 0:
                    return
                t0 = held[i][1]
                del held[i]
                stats = self._stats
                if stats is not None:
                    try:
                        stats.observe("lock_hold_ms", lock.name,
                                      (time.perf_counter() - t0) * 1e3)
                    except Exception:  # noqa: BLE001
                        pass
                return
        # release of a lock acquired before arming: nothing tracked

    def _find_cycle(self, src: str, dst: str
                    ) -> list[tuple[str, str]] | None:
        """Caller holds self._mu. The edge src->dst was just added:
        a path dst ->* src closes a ring."""
        prev: dict[str, str | None] = {dst: None}
        queue = [dst]
        while queue:
            cur = queue.pop(0)
            if cur == src:
                break
            for nxt in sorted(self._edges.get(cur, ())):
                if nxt not in prev:
                    prev[nxt] = cur
                    queue.append(nxt)
        if src not in prev:
            return None
        chain = [src]
        cur = src
        while prev[cur] is not None:
            cur = prev[cur]
            chain.append(cur)
        chain.reverse()  # dst, ..., src
        return [(src, dst)] + [(chain[i], chain[i + 1])
                               for i in range(len(chain) - 1)]

    def _report_cycle(self, cycle: dict) -> None:
        ring = cycle["ring"]
        ring_str = " -> ".join([e[0] for e in ring] + [ring[0][0]])
        log.error("POTENTIAL DEADLOCK: lock-order cycle %s "
                  "(witness: %s)", ring_str, cycle["witness"])
        events = self._events
        if events is not None:
            try:
                events.append(
                    "lock_cycle",
                    f"lock-order cycle detected: {ring_str}",
                    ring=ring_str, witness=cycle["witness"])
            except Exception:  # noqa: BLE001 — journaling must never
                pass           # alter witness behavior

    # ---- introspection -----------------------------------------------------

    def edge_count(self) -> int:
        with self._mu:
            return sum(len(v) for v in self._edges.values())

    def cycles(self) -> list[dict]:
        with self._mu:
            return [dict(c) for c in self._cycles]

    def status(self) -> dict:
        """The `admin locks` payload: armed state, per-lock counters
        (+ wait/hold percentiles when a StatsHolder is bound), the
        order graph, and any cycle reports. The percentiles come from
        the bound holder's histograms and are PROCESS-LIFETIME
        cumulative — disarm forgets the graph and counts but does not
        rewind /metrics (histograms are monotone by contract)."""
        with self._mu:
            counts = {n: dict(c) for n, c in self._counts.items()}
            edges = {a: sorted(b) for a, b in self._edges.items() if b}
            cycles = [dict(c) for c in self._cycles]
        stats = self._stats
        locks: dict[str, dict] = {}
        for name, c in sorted(counts.items()):
            row = dict(c)
            if stats is not None:
                for metric, key in (("lock_wait_ms", "wait"),
                                    ("lock_hold_ms", "hold")):
                    for q in (50, 99):
                        try:
                            v = stats.histogram_percentile(
                                metric, name, q)
                        except Exception:  # noqa: BLE001
                            v = None
                        row[f"{key}_p{q}_ms"] = (round(v, 3)
                                                 if v is not None
                                                 else None)
            locks[name] = row
        return {"armed": self.active, "locks": locks,
                "edges": edges, "cycles": cycles}


LOCKTRACE = LockTraceRegistry()


class TracedLock:
    """Named lock wrapper; see the module docstring. Use the
    :func:`lock` / :func:`rlock` constructors."""

    def __init__(self, name: str, *, reentrant: bool = False):
        # _reentrant FIRST: __getattr__ reads it, and it must resolve
        # before any other attribute lookup can fall through
        self._reentrant = reentrant
        self.name = name
        self.site = SITE_PREFIX + name
        self._inner = (threading.RLock() if reentrant
                       else threading.Lock())

    # contract: dispatches<=0 fetches<=0
    def acquire(self, blocking: bool = True, timeout: float = -1
                ) -> bool:
        # the seeded interleaving perturber hooks every traced acquire
        # (one attribute read + one branch when no faults are armed)
        if FAULTS.active:
            FAULTS.point(self.site)
        if not LOCKTRACE.active:
            return self._inner.acquire(blocking, timeout)
        if not blocking:
            got = self._inner.acquire(False)
            if got:
                LOCKTRACE.note_acquire(self, 0.0, contended=False)
            return got
        t0 = time.perf_counter()
        contended = False
        if not self._inner.acquire(False):
            contended = True
            if not self._inner.acquire(True, timeout):
                return False
        LOCKTRACE.note_acquire(self, time.perf_counter() - t0,
                               contended=contended)
        return True

    # contract: dispatches<=0 fetches<=0
    def release(self) -> None:
        # note BEFORE the inner release: the hold ends when the owner
        # decides to let go, and noting after would race the next
        # owner's acquire bookkeeping for this thread's entry
        if LOCKTRACE.active:
            LOCKTRACE.note_release(self)
        self._inner.release()

    def __enter__(self) -> "TracedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        inner_locked = getattr(self._inner, "locked", None)
        return inner_locked() if inner_locked is not None else False

    # Condition-protocol forwarding, REENTRANT wrappers only. A
    # Condition over an RLock must see a real _release_save /
    # _acquire_restore / _is_owned (recursion counts); a PLAIN lock
    # must NOT expose them — Condition probes the attributes at
    # construction (try/except AttributeError) and falls back to the
    # wrapper's traced acquire/release, so existence is conditional
    # via __getattr__, not methods that raise at call time.
    def __getattr__(self, name: str):
        if self._reentrant:
            if name == "_release_save":
                return self._traced_release_save
            if name == "_acquire_restore":
                return self._traced_acquire_restore
            if name == "_is_owned":
                return self._inner._is_owned
        raise AttributeError(name)

    def _traced_release_save(self):
        # the wait window drops the held-set entry (the lock really is
        # released while waiting — edges formed then would be false)
        if LOCKTRACE.active:
            LOCKTRACE.note_release(self)
        return self._inner._release_save()

    def _traced_acquire_restore(self, state) -> None:
        self._inner._acquire_restore(state)
        if LOCKTRACE.active:
            LOCKTRACE.note_acquire(self, 0.0, contended=False)


def lock(name: str) -> TracedLock:
    """Named traced mutex (threading.Lock semantics)."""
    return TracedLock(name)


def rlock(name: str) -> TracedLock:
    """Named traced re-entrant mutex (threading.RLock semantics)."""
    return TracedLock(name, reentrant=True)


def lock_list(name: str, n: int) -> list[TracedLock]:
    """A lock FAMILY sharing one name (e.g. append-front lanes)."""
    return [TracedLock(name) for _ in range(max(int(n), 1))]
