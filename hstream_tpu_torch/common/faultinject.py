"""Deterministic fault injection: named sites, seeded schedules.

Production log/stream systems gate replication and recovery changes
behind a chaos harness (LogDevice's failure simulations, Kafka's
Trogdor): every failure mode the recovery code claims to handle must be
*provokable on demand*, deterministically, in a test. Before this
module the tree had exactly one injection point (``stop(crash=True)``);
everything else — torn snapshot writes, follower flaps, corrupt
checkpoint files, device activation failures — could only happen for
real.

A **fault site** is a named host-side probe compiled into the code
path it guards::

    from hstream_tpu_torch.common.faultinject import FAULTS
    ...
    if FAULTS.active:                  # one-branch no-op when inactive
        FAULTS.point("store.append")   # may raise / delay

``FAULTS.active`` is a plain attribute that is False unless at least
one site is armed — the same hot-path discipline as
``FlowGovernor.active`` (ingress pays one attribute read + one branch,
no locks, no allocation). Torn-write sites use ``mutate`` which
passes bytes through unchanged when inactive::

    blob = FAULTS.mutate("snapshot.persist", blob)

Schedules are **deterministic**: fail-Nth counts invocations; the
probability schedule draws from a per-site ``random.Random(seed)``;
torn-write truncation picks its cut point from the same seeded stream.
Re-running a chaos test with the same seed injects the same faults at
the same hits.

Spec grammar (env var ``HSTREAM_FAULTS``, admin ``fault-set``, tests):

    fail:N            raise InjectedFault on the Nth hit (1-based), once
    fail:N:K          raise on hits N, N+1, ... N+K-1 (K consecutive)
    prob:P[:SEED]     raise with probability P per hit (seeded RNG)
    delay:MS[:N]      sleep MS milliseconds on every hit (or only hit N)
    torn:N[:SEED]     mutate(): truncate the Nth write at a seeded point
    yield:N[:SEED]    interleaving perturber (ISSUE 14): on ~1/N of
                      hits (seeded RNG, deterministic decision stream)
                      sleep a seeded sub-millisecond jitter — a forced
                      scheduler yield that explores adversarial thread
                      interleavings at the site; armed at the
                      lock.acquire.* sites with the locktrace witness,
                      this is the seeded schedule-perturbation harness

``HSTREAM_FAULTS="store.append=fail:3;snapshot.persist=torn:2:7"``
arms two sites for the whole process. The registry is process-global
(fault sites live in layers that never see a ServerContext); a
ServerContext binds its event journal so every injection lands as a
``fault_injected`` event.

Instrumented sites (the registry accepts any name; these exist today):

    store.append            leader/local append path (memstore)
    store.read              reader poll (memstore)
    store.oplog.apply       replica op application (leader + follower)
    store.follower.connect  leader-side sender (re)connect to a follower
    store.follower.ack      leader-side Replicate RPC entry
    replica.heartbeat.drop  leader-side idle heartbeat (lease expiry)
    replica.partition       follower-side Replicate entry: the follower
                            is unreachable from its leader (the RPC
                            fails before the epoch/bind checks)
    replica.promote.race    follower-side Promote entry (widens the
                            dueling-promotion race window)
    snapshot.persist        operator-state blob write (mutate: torn)
    snapshot.restore        operator-state blob read at task start
    checkpoint.flush        checkpoint store write (mutate: torn)
    device.dispatch         staged lattice step dispatch
    device.fetch            deferred close/changelog D2H drain
    device.activate         device-join / fused-close kernel activation
    device.session.dispatch session step / extract kernel dispatch
    device.session.activate session arena activation + host migration
    task.step               query-task ingest of one read chunk
    rpc.handler             unary gRPC handler entry
    lock.acquire.<name>     every TracedLock acquire (common/locktrace):
                            one site per lock ROLE — appendfront.submit,
                            scheduler.supervisor, tasks.state, ... —
                            the natural home of yield: schedules
"""

# A copy of hstream_tpu/common/faultinject.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

import os
import random
import threading
import time

from hstream_tpu_torch.common.errors import ServerError
from hstream_tpu_torch.common.logger import get_logger

log = get_logger("faultinject")

ENV_VAR = "HSTREAM_FAULTS"


class InjectedFault(ServerError):
    """Raised by an armed fail/prob fault site. Subclasses ServerError
    so the gRPC boundary maps it to INTERNAL like any other server
    fault (the error-contract pass already admits that status)."""

    def __init__(self, site: str, hit: int):
        super().__init__(f"injected fault at site {site!r} (hit {hit})")
        self.site = site
        self.hit = hit


class _Site:
    """One armed site: parsed schedule + hit/injection accounting."""

    __slots__ = ("name", "spec", "kind", "arg", "count", "seed",
                 "hits", "injected", "_rng")

    def __init__(self, name: str, spec: str):
        self.name = name
        self.spec = spec
        parts = spec.split(":")
        self.kind = parts[0]
        self.hits = 0
        self.injected = 0
        if self.kind == "fail":
            if len(parts) < 2:
                raise ValueError(f"fail needs N: {spec!r}")
            self.arg = int(parts[1])          # first failing hit
            self.count = int(parts[2]) if len(parts) > 2 else 1
            self.seed = 0
            self._rng = None
        elif self.kind == "prob":
            if len(parts) < 2:
                raise ValueError(f"prob needs P: {spec!r}")
            p = float(parts[1])
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"prob P out of [0,1]: {spec!r}")
            self.arg = p
            self.seed = int(parts[2]) if len(parts) > 2 else 0
            self.count = 0
            self._rng = random.Random(self.seed)
        elif self.kind == "delay":
            if len(parts) < 2:
                raise ValueError(f"delay needs MS: {spec!r}")
            self.arg = float(parts[1]) / 1000.0
            self.count = int(parts[2]) if len(parts) > 2 else 0  # 0=all
            self.seed = 0
            self._rng = None
        elif self.kind == "torn":
            if len(parts) < 2:
                raise ValueError(f"torn needs N: {spec!r}")
            self.arg = int(parts[1])
            self.seed = int(parts[2]) if len(parts) > 2 else 0
            self.count = 1
            self._rng = random.Random(self.seed)
        elif self.kind == "yield":
            if len(parts) < 2:
                raise ValueError(f"yield needs N: {spec!r}")
            n = int(parts[1])
            if n < 1:
                raise ValueError(f"yield N must be >= 1: {spec!r}")
            self.arg = n
            self.seed = int(parts[2]) if len(parts) > 2 else 0
            self.count = 0
            self._rng = random.Random(self.seed)
        else:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(fail/prob/delay/torn/yield)")

    def fire(self) -> tuple[str, float] | None:
        """Advance the schedule one point() hit. Returns None (no
        fault), ("fail", 0) to raise, or ("delay", seconds) to sleep.
        Torn schedules only advance on mutate() (a site may host both
        a point and a mutate probe; their hit counts must not blend)."""
        if self.kind == "torn":
            return None
        self.hits += 1
        if self.kind == "fail":
            if self.arg <= self.hits < self.arg + self.count:
                self.injected += 1
                return ("fail", 0.0)
        elif self.kind == "prob":
            if self._rng.random() < self.arg:
                self.injected += 1
                return ("fail", 0.0)
        elif self.kind == "delay":
            if self.count == 0 or self.hits == self.count:
                self.injected += 1
                return ("delay", self.arg)
        elif self.kind == "yield":
            # two seeded draws per hit: the 1/N decision, then the
            # jitter magnitude — one deterministic stream per spec, so
            # a seed replays the same perturbation SEQUENCE even when
            # threads race for the next decision
            r = self._rng.random()
            jitter = self._rng.random()
            if r < 1.0 / self.arg:
                self.injected += 1
                return ("yield", jitter * 0.002)
        return None

    def tear(self, data: bytes) -> bytes | None:
        """Advance one mutate() write hit; returns truncated bytes when
        this is the scheduled torn write, else None."""
        if self.kind != "torn":
            return None
        self.hits += 1
        if self.hits != self.arg:
            return None
        self.injected += 1
        if len(data) <= 1:
            return b""
        # seeded cut point in the middle half so the tear is neither a
        # trivially-empty file nor a nearly-complete one
        lo = max(1, len(data) // 4)
        hi = max(lo + 1, (3 * len(data)) // 4)
        return data[:self._rng.randrange(lo, hi)]

    def status(self) -> dict:
        return {"spec": self.spec, "hits": self.hits,
                "injected": self.injected}


class FaultRegistry:
    """Process-wide registry of armed fault sites.

    Hot-path contract: with no sites armed, ``active`` is False and an
    instrumented site costs one attribute read + one branch. Arming any
    site flips ``active``; ``point``/``mutate`` then take the registry
    lock (fault runs are test/debug runs — injection determinism beats
    contention here)."""

    def __init__(self) -> None:
        self._sites: dict[str, _Site] = {}
        self._lock = threading.Lock()
        self._events = None  # EventJournal bound by ServerContext
        self.active = False

    # ---- configuration -----------------------------------------------------

    def arm(self, site: str, spec: str) -> None:
        """Arm (or re-arm, resetting counters) one site."""
        s = _Site(site, spec)
        with self._lock:
            self._sites[site] = s
            self.active = True
        log.warning("fault site %s armed: %s", site, spec)

    def disarm(self, site: str | None = None) -> None:
        """Disarm one site (or every site when None)."""
        with self._lock:
            if site is None:
                self._sites.clear()
            else:
                self._sites.pop(site, None)
            self.active = bool(self._sites)

    def bind_events(self, events) -> None:
        """Attach an event journal; every injection appends a
        ``fault_injected`` event (best-effort)."""
        self._events = events

    def load_env(self, env: str | None = None) -> int:
        """Arm sites from ``HSTREAM_FAULTS`` (or an explicit spec
        string); returns how many sites were armed. Malformed entries
        are skipped loudly — a typo'd chaos run must not boot clean."""
        raw = env if env is not None else os.environ.get(ENV_VAR, "")
        n = 0
        for ent in raw.split(";"):
            ent = ent.strip()
            if not ent:
                continue
            site, _, spec = ent.partition("=")
            try:
                self.arm(site.strip(), spec.strip())
                n += 1
            except ValueError as e:
                log.error("ignoring malformed fault spec %r: %s", ent, e)
        return n

    def status(self) -> dict:
        with self._lock:
            return {name: s.status()
                    for name, s in sorted(self._sites.items())}

    # ---- injection ---------------------------------------------------------

    def point(self, site: str) -> None:
        """One probe hit. Raises InjectedFault or sleeps per the armed
        schedule; a no-op for unarmed sites. Callers on hot paths guard
        with ``if FAULTS.active``."""
        # deliberate unlocked fast-path read (one stale branch at
        # worst), same idiom as FlowGovernor.active
        # analyze: ok lock-guard — hot-path gate read
        if not self.active:
            return
        with self._lock:
            s = self._sites.get(site)
            fired = s.fire() if s is not None else None
        if fired is None:
            return
        kind, arg = fired
        if kind == "delay":
            self._journal(site, s, "delay")
            time.sleep(arg)
            return
        if kind == "yield":
            # no journal: a perturbation run yields thousands of times
            # and the journal ring must keep the interesting events
            time.sleep(arg)
            return
        self._journal(site, s, "fail")
        raise InjectedFault(site, s.hits)

    def mutate(self, site: str, data: bytes) -> bytes:
        """Torn-write probe: pass bytes through, truncated at the
        scheduled hit. Identity when inactive/unarmed."""
        # analyze: ok lock-guard — deliberate unlocked fast-path read
        if not self.active:
            return data
        with self._lock:
            s = self._sites.get(site)
            torn = s.tear(data) if s is not None else None
        if torn is None:
            return data
        self._journal(site, s, "torn")
        log.warning("fault site %s: torn write %d -> %d bytes",
                    site, len(data), len(torn))
        return torn

    def _journal(self, site: str, s: _Site, what: str) -> None:
        events = self._events
        if events is None:
            return
        try:
            events.append("fault_injected",
                          f"fault {what} injected at {site} "
                          f"(hit {s.hits}, spec {s.spec})",
                          site=site, fault=what, hit=s.hits)
        except Exception:  # noqa: BLE001 — journaling must never alter
            pass           # injection behavior


# the process singleton every instrumented site reaches
FAULTS = FaultRegistry()
