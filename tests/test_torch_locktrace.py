"""The runtime lock-order witness (common/locktrace.py), through both
packages: every case of tests/test_locktrace.py runs once against the
JAX package's copy and once against the port's (`p`, parametrised), on
each package's own process-global LOCKTRACE and FAULTS registries.

GoodLock semantics on the TracedLock wrapper: cycle detection fires on
an order inversion WITHOUT needing the unlucky schedule, re-entrant
RLocks and same-name lock families never false-positive, a Condition
over a traced lock keeps the held-set truthful across waits, the
disarmed wrapper records nothing, and the seeded `yield:` perturber
replays deterministically.
"""

from __future__ import annotations

import importlib
import threading
import time
from types import SimpleNamespace

import pytest

PACKAGES = ("hstream_tpu", "hstream_tpu_torch")


def _package(root: str) -> SimpleNamespace:
    locktrace = importlib.import_module(f"{root}.common.locktrace")
    return SimpleNamespace(
        locktrace=locktrace,
        LOCKTRACE=locktrace.LOCKTRACE,
        TracedLock=locktrace.TracedLock,
        FAULTS=importlib.import_module(f"{root}.common.faultinject").FAULTS,
        StatsHolder=importlib.import_module(f"{root}.stats").StatsHolder,
        EventJournal=importlib.import_module(
            f"{root}.stats.events").EventJournal)


@pytest.fixture(params=PACKAGES)
def p(request):
    """One package's witness, fresh: LOCKTRACE is process-global, so
    every test starts and ends disarmed with no residual graph (and no
    armed fault sites)."""
    pkg = _package(request.param)
    pkg.LOCKTRACE.disarm()
    pkg.FAULTS.disarm()
    yield pkg
    pkg.LOCKTRACE.disarm()
    pkg.FAULTS.disarm()
    pkg.LOCKTRACE.bind(stats=None, events=None)


def test_cycle_detection_fires_on_inversion_without_deadlock(p):
    """A -> B in one section, B -> A in a later one: the second edge
    direction closes the ring and reports a POTENTIAL deadlock even
    though this single thread never deadlocks (the GoodLock point)."""
    events = p.EventJournal()
    p.LOCKTRACE.bind(events=events)
    p.LOCKTRACE.arm()
    a = p.locktrace.lock("t.a")
    b = p.locktrace.lock("t.b")
    with a:
        with b:
            pass
    assert p.LOCKTRACE.cycles() == []
    with b:
        with a:
            pass
    cycles = p.LOCKTRACE.cycles()
    assert len(cycles) == 1
    ring = cycles[0]["ring"]
    assert sorted(tuple(e) for e in ring) == [("t.a", "t.b"),
                                              ("t.b", "t.a")]
    # the witness names the thread and the full held stack per edge
    wit = cycles[0]["witness"]
    assert set(wit) == {"t.a->t.b", "t.b->t.a"}
    assert all("thread" in w and "holding" in w for w in wit.values())
    # journaled exactly once as a lock_cycle event
    kinds = [e["kind"] for e in events.query(limit=100)]
    assert kinds.count("lock_cycle") == 1
    # the SAME inversion again does not re-report (edge already known)
    with b:
        with a:
            pass
    assert len(p.LOCKTRACE.cycles()) == 1


def test_reentrant_rlock_no_false_positive(p):
    """Re-entering one RLock instance adds no edge (no self-cycle),
    and depth counting pairs releases correctly."""
    p.LOCKTRACE.arm()
    r = p.locktrace.rlock("t.r")
    other = p.locktrace.lock("t.o")
    with r:
        with r:           # re-entrant: depth only
            with other:
                pass
    assert p.LOCKTRACE.cycles() == []
    st = p.LOCKTRACE.status()
    assert st["edges"] == {"t.r": ["t.o"]}
    # fully released: a fresh thread can take (and release) it
    grabbed = []

    def grab():
        if r.acquire(timeout=1):
            grabbed.append(True)
            r.release()

    t = threading.Thread(target=grab)
    t.start()
    t.join()
    assert grabbed == [True]


def test_same_name_family_nesting_adds_no_edge(p):
    """Two instances of one lock ROLE nested (append-front lanes) add
    no self-edge — instance identity is not class identity."""
    p.LOCKTRACE.arm()
    lanes = p.locktrace.lock_list("t.lane", 2)
    with lanes[0]:
        with lanes[1]:
            pass
    assert p.LOCKTRACE.edge_count() == 0
    assert p.LOCKTRACE.cycles() == []


def test_disarmed_wrapper_records_nothing(p):
    """Disarmed contract: nested acquires leave NO graph, NO counts,
    NO cycles — the one-attribute-read + one-branch path."""
    a = p.locktrace.lock("t.da")
    b = p.locktrace.lock("t.db")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    assert p.LOCKTRACE.edge_count() == 0
    st = p.LOCKTRACE.status()
    assert st["locks"] == {} and st["cycles"] == []
    assert not st["armed"]


def test_wait_hold_histograms_and_contention_counter(p):
    """Bound StatsHolder: a contended acquire counts lock_contention
    and lands in lock_wait_ms; every release lands in lock_hold_ms."""
    stats = p.StatsHolder()
    p.LOCKTRACE.bind(stats=stats)
    p.LOCKTRACE.arm()
    lk = p.locktrace.lock("t.cont")
    held = threading.Event()
    release = threading.Event()

    def holder():
        with lk:
            held.set()
            release.wait(5)

    t = threading.Thread(target=holder)
    t.start()
    assert held.wait(5)
    got = []

    def contender():
        with lk:
            got.append(True)

    t2 = threading.Thread(target=contender)
    t2.start()
    time.sleep(0.05)
    release.set()
    t.join(5)
    t2.join(5)
    assert got == [True]
    assert stats.stream_stat_get("lock_contention", "t.cont") == 1
    hists = stats.histograms_snapshot()
    assert ("lock_wait_ms", "t.cont") in hists
    hold = hists[("lock_hold_ms", "t.cont")]
    assert hold.count == 2  # holder + contender both released
    # the ledger surfaces percentiles when stats are bound
    row = p.LOCKTRACE.status()["locks"]["t.cont"]
    assert row["acquires"] == 2 and row["contentions"] == 1
    assert row["wait_p50_ms"] is not None
    assert row["hold_p50_ms"] is not None


def test_condition_over_traced_lock_releases_during_wait(p):
    """threading.Condition(TracedLock): wait() really releases the
    wrapper (another thread acquires it mid-wait), the held-set drops
    the entry, and notify wakes the waiter — semantics preserved."""
    p.LOCKTRACE.arm()
    lk = p.locktrace.lock("t.cv")
    cv = threading.Condition(lk)
    state = {"woke": False}
    waiting = threading.Event()

    def waiter():
        with cv:
            waiting.set()
            cv.wait(timeout=5)
            state["woke"] = True

    t = threading.Thread(target=waiter)
    t.start()
    assert waiting.wait(5)
    # the waiter is inside wait(): the lock must be takeable NOW
    assert lk.acquire(timeout=2)
    lk.release()
    with cv:
        cv.notify_all()
    t.join(5)
    assert state["woke"]
    assert p.LOCKTRACE.cycles() == []


def test_condition_over_traced_rlock_wait_notify(p):
    """The re-entrant wrapper forwards the Condition protocol
    (_release_save/_acquire_restore/_is_owned) to the inner RLock."""
    p.LOCKTRACE.arm()
    cv = threading.Condition(p.locktrace.rlock("t.rcv"))
    woke = threading.Event()

    def waiter():
        with cv:
            cv.wait(timeout=5)
            woke.set()

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cv:
        cv.notify_all()
    t.join(5)
    assert woke.is_set()


def test_rearm_after_disarm_starts_fresh(p):
    p.LOCKTRACE.arm()
    a = p.locktrace.lock("t.fa")
    b = p.locktrace.lock("t.fb")
    with a:
        with b:
            pass
    assert p.LOCKTRACE.edge_count() == 1
    p.LOCKTRACE.disarm()
    p.LOCKTRACE.arm()
    assert p.LOCKTRACE.edge_count() == 0
    with b:
        with a:
            pass
    # the PRIOR direction was forgotten with the disarm: no cycle
    assert p.LOCKTRACE.cycles() == []


def test_disarm_straddling_acquire_leaves_no_stale_holder(p):
    """A thread that passes the wrapper's armed
    gate just before a disarm must not leave a stale held-set entry —
    its release runs disarmed and would never pair up, and every lock
    the thread takes after a re-arm would appear falsely nested under
    the ghost holder. note_acquire re-checks `active`, and the
    generation bump discards any stack that straddled the boundary."""
    p.LOCKTRACE.arm()
    a = p.locktrace.lock("t.sa")
    b = p.locktrace.lock("t.sb")
    a.acquire()           # held entry recorded while armed
    p.LOCKTRACE.disarm()    # gen bump: the recorded stack is stale
    a.release()           # disarmed release: note_release skipped
    p.LOCKTRACE.arm()
    # the ghost holder must be gone: taking b then a in the "wrong"
    # order relative to the ghost must create NO edge from t.sa
    with b:
        pass
    st = p.LOCKTRACE.status()
    assert st["edges"] == {} and st["cycles"] == []
    # and the direct shape: note_acquire entered while disarmed
    # records nothing even if the gate was passed before the flip
    p.LOCKTRACE.disarm()
    p.LOCKTRACE.note_acquire(a, 0.0, contended=False)
    p.LOCKTRACE.arm()
    with b:
        pass
    st = p.LOCKTRACE.status()
    assert st["edges"] == {} and st["cycles"] == []


def test_yield_perturber_is_seeded_and_deterministic(p):
    """yield:N[:SEED] injects the same decision stream per seed; every
    traced acquire is a lock.acquire.<name> fault site."""
    lk = p.locktrace.lock("t.y")

    def run(seed):
        p.FAULTS.disarm()
        p.FAULTS.arm(lk.site, f"yield:3:{seed}")
        for _ in range(60):
            with lk:
                pass
        st = p.FAULTS.status()[lk.site]
        return st["hits"], st["injected"]

    h1, i1 = run(7)
    h2, i2 = run(7)
    h3, i3 = run(11)
    assert (h1, i1) == (h2, i2) == (60, i1)
    assert i1 > 0  # ~1/3 of 60 hits yield; a zero means the schedule
    #                never fired and the perturber is dead
    assert h3 == 60  # different seed: same hit count, its own stream


def test_yield_rejects_bad_n(p):
    with pytest.raises(ValueError):
        p.FAULTS.arm("x", "yield:0")
    with pytest.raises(ValueError):
        p.FAULTS.arm("x", "yield")

