"""Protocol certification of the port (hstream_tpu_torch/tools/protocheck).

The port's copy of the explicit-state model checker drives the port's
placer, scheduler, persistence, versioned store and replica through the
same bounded interleavings as the reference's checker drives the JAX
package's. Pinned here, as tests/test_protocheck.py pins them for the
reference:

* the port's live tree passes every scenario's invariants;
* the mutation gate has teeth: every reverted fix, patched over the
  port's module, yields a counterexample;
* counterexample traces are deterministic, serializable schedules;
* the chaos schedules of tests/test_chaos.py replay the bug under the
  mutant and run clean on the port's live tree.

And one more: both checkers, each over its own package, explore the same
number of states and transitions with the same verdict in every default
scenario. The replica model drives the follower's Replicate and Promote,
where the packages agree; the one replication difference ROADMAP C
records (the port's leader counts a follower not yet dialled as pending,
the reference's as down) is on the leader's ack wait, which no action of
the model reaches, so its counts are equal too.
"""

from __future__ import annotations

import functools
import json

import pytest

from hstream_tpu_torch.tools.protocheck.explore import (Counterexample,
                                                         explore, replay)
from hstream_tpu_torch.tools.protocheck.model import (DEFAULT_SCENARIOS,
                                                       SCENARIOS, Model)
from hstream_tpu_torch.tools.protocheck.mutants import BY_NAME, MUTANTS
from hstream_tpu_torch.tools.protocheck.replica_model import (
    MiniLogStore, ReplicaModel, ReplicaScenario, explore_replica,
    replay_replica)


@functools.lru_cache(maxsize=None)
def _live(name: str):
    """The port's live exploration of one scenario, run once for the
    module (the certification and the parity test read it)."""
    if name == "replica-2":
        return explore_replica(ReplicaScenario())
    return explore(SCENARIOS[name])


# ---- live-tree certification ----------------------------------------------

_FAST = [n for n in DEFAULT_SCENARIOS
         if n in ("skew-2", "mixed-2", "clamp-2", "created-2")]
_SLOW = [n for n in DEFAULT_SCENARIOS if n not in _FAST]


@pytest.mark.parametrize("name", _FAST)
def test_live_tree_certified_fast_scenarios(name):
    res = _live(name)
    assert res.ok, (
        f"{name}: the port violates {res.counterexample.rule}: "
        f"{res.counterexample.message}\n"
        f"trace: {res.counterexample.trace}")
    assert res.states > 5


@pytest.mark.parametrize("name", _SLOW)
def test_live_tree_certified_deep_scenarios(name):
    res = _live(name)
    assert res.ok, (
        f"{name}: the port violates {res.counterexample.rule}: "
        f"{res.counterexample.message}\n"
        f"trace: {res.counterexample.trace}")
    assert res.states > 100
    assert res.elapsed_s < 30


def test_live_tree_replica_model_certified():
    res = _live("replica-2")
    assert res.ok, (
        f"replica model violates {res.counterexample.rule}: "
        f"{res.counterexample.message}")
    assert res.states > 100


# ---- mutation gate ---------------------------------------------------------


def test_gate_covers_at_least_five_reverted_fixes():
    assert len(MUTANTS) >= 5
    assert len({m.name for m in MUTANTS}) == len(MUTANTS)


@pytest.mark.parametrize("name", sorted(BY_NAME))
def test_mutant_yields_counterexample(name):
    m = BY_NAME[name]
    if m.kind == "replica":
        res = explore_replica(ReplicaScenario(), mutant=m)
    else:
        res = explore(SCENARIOS[m.scenario], mutant=m)
    assert not res.ok, (
        f"mutant {name} (reverts: {m.fix}) went UNNOTICED over "
        f"{res.states} states — the checker lost the invariant that "
        f"certifies this fix")
    ce = res.counterexample
    assert ce.mutant == name
    assert ce.rule and ce.message


def test_mutants_patch_the_port_and_restore_it():
    """A mutant swaps the port's function (never the reference's) and
    leaves no residue: after a mutant run the live attributes are back
    and a live exploration is still clean."""
    import hstream_tpu_torch.server.scheduler as sched
    from hstream_tpu_torch.store.replica import FollowerService

    before = sched.try_adopt_live
    seen = []
    m = BY_NAME["fresh-heartbeat-refusal"]
    with m.patch():
        seen.append(sched.try_adopt_live)
    assert seen[0] is not before
    res = explore(SCENARIOS["kill-2"], mutant=m)
    assert not res.ok
    assert sched.try_adopt_live is before
    promote = FollowerService.Promote
    with BY_NAME["promote-no-epoch-guard"].patch():
        assert FollowerService.Promote is not promote
    assert FollowerService.Promote is promote
    assert explore(SCENARIOS["clamp-2"]).ok


def test_exploration_restores_the_port_logger_level():
    """quiet_protocol_logs mutes the port's root logger during a run and
    must restore it for the tests after this module."""
    import logging

    root = logging.getLogger("hstream_tpu_torch")
    before = root.level
    explore(SCENARIOS["clamp-2"])
    explore_replica(ReplicaScenario())
    assert root.level == before


# ---- counterexample replay determinism ------------------------------------


def test_trace_replays_deterministically():
    m = BY_NAME["fresh-heartbeat-refusal"]
    res = explore(SCENARIOS[m.scenario], mutant=m)
    ce = res.counterexample
    v1, k1, _ = replay(SCENARIOS[m.scenario], ce.trace, mutant=m)
    v2, k2, _ = replay(SCENARIOS[m.scenario], ce.trace, mutant=m)
    assert v1 and v1[0].rule == ce.rule
    assert k1 == k2
    v_live, _, _ = replay(SCENARIOS[m.scenario], ce.trace)
    assert not v_live


def test_stabilized_counterexample_replays_with_convergence():
    m = BY_NAME["legacy-epoch-adopt"]
    res = explore(SCENARIOS[m.scenario], mutant=m)
    ce = res.counterexample
    assert ce.stabilized
    vs, _, _ = replay(SCENARIOS[m.scenario], ce.trace, mutant=m,
                      stabilize=True)
    assert vs and vs[0].rule == ce.rule


def test_replica_trace_replays_deterministically():
    m = BY_NAME["promote-no-epoch-guard"]
    res = explore_replica(ReplicaScenario(), mutant=m)
    ce = res.counterexample
    v1, k1 = replay_replica(ce.trace, mutant=m, stabilize=ce.stabilized)
    v2, k2 = replay_replica(ce.trace, mutant=m, stabilize=ce.stabilized)
    assert v1 and v1[0].rule == ce.rule
    assert k1 == k2
    v_live, _ = replay_replica(ce.trace, stabilize=ce.stabilized)
    assert not v_live


def test_counterexample_json_round_trip():
    m = BY_NAME["lease-unclamped"]
    ce = explore(SCENARIOS[m.scenario], mutant=m).counterexample
    back = Counterexample.from_json(json.loads(json.dumps(ce.to_json())))
    assert back.trace == ce.trace
    assert (back.rule, back.scenario, back.mutant) == \
        (ce.rule, ce.scenario, ce.mutant)
    vs, _, _ = replay(SCENARIOS[back.scenario], back.trace, mutant=m,
                      stabilize=back.stabilized)
    assert vs and vs[0].rule == back.rule


def test_timeline_renders_every_step():
    m = BY_NAME["fresh-heartbeat-refusal"]
    ce = explore(SCENARIOS[m.scenario], mutant=m).counterexample
    _vs, keys, steps = replay(SCENARIOS[m.scenario], ce.trace,
                              mutant=m, timeline=True)
    assert len(steps) == len(ce.trace) + 1
    assert steps[0]["action"] == "initial"
    for st in steps:
        assert {"action", "clock_ms", "nodes", "records"} <= set(st)
        for n in st["nodes"]:
            assert {"name", "alive", "epoch", "running"} <= set(n)
    assert len(keys) == len(steps)


# ---- model soundness spot-checks ------------------------------------------


def test_snapshot_restore_is_exact():
    model = Model(SCENARIOS["kill-2"])
    with model.engaged():
        k0 = model.state_key()
        snap = model.snapshot()
        for a in (("advance",), ("crash", 0), ("adopt", 1)):
            pre = model.sched_records()
            model.execute(a)
            model.update_truth(a, pre, model.sched_records())
        assert model.state_key() != k0
        model.restore(snap)
        assert model.state_key() == k0


def test_state_key_is_translation_invariant():
    model = Model(SCENARIOS["pause-2"])
    with model.engaged():
        def hb_all():
            for i in (0, 1):
                a = ("hb", i)
                pre = model.sched_records()
                model.execute(a)
                model.update_truth(a, pre, model.sched_records())
        hb_all()
        k1 = model.state_key()
        pre = model.sched_records()
        model.execute(("advance",))
        model.update_truth(("advance",), pre, model.sched_records())
        hb_all()
        k2 = model.state_key()
        strip = [i for i, (a, b) in enumerate(zip(k1, k2)) if a != b]
        assert len(strip) == 1


def test_minilogstore_matches_contract():
    s = MiniLogStore()
    assert not s.log_exists(7)
    s.create_log(7)
    assert s.tail_lsn(7) == 0
    assert s.append(7, b"x") == 1
    s.meta_put("k", b"v")
    assert s.meta_get("k") == b"v"
    snap = s.snapshot()
    s.append(7, b"y")
    s.meta_delete("k")
    s.restore(snap)
    assert s.tail_lsn(7) == 1 and s.meta_get("k") == b"v"


def test_replica_model_runs_the_ports_follower_service():
    from hstream_tpu_torch.store.replica import FollowerService

    model = ReplicaModel(ReplicaScenario())
    assert all(isinstance(f, FollowerService) for f in model.followers)
    assert all(type(f).__module__ == "hstream_tpu_torch.store.replica"
               for f in model.followers)
    assert not model.execute(("promote", 0))
    assert model.followers[0].is_leader
    assert model.followers[0].epoch == 1
    assert not model.execute(("promote-dup", 1))
    assert not model.stabilize()
    leaders = [f.node_id for f in model.followers if f.is_leader]
    assert leaders == ["r2"]


def test_the_model_drives_the_ports_protocol_modules():
    """Every protocol module the checker reaches is the port's."""
    from hstream_tpu_torch.tools.protocheck import model, mutants

    for mod in (model.placer_core, model.placer_score, model.scheduler,
                mutants.placer_core, mutants.scheduler):
        assert mod.__name__.startswith("hstream_tpu_torch."), mod
    assert model.VersionedConfigStore.__module__ == \
        "hstream_tpu_torch.store.versioned"
    assert model.QueryInfo.__module__.startswith("hstream_tpu_torch.")


# ---- the chaos schedules (tests/test_chaos.py), on the port ---------------

PROTOCHECK_SCHEDULES = [
    ("fresh-heartbeat-refusal", "kill-2",
     [("adopt", 0)], "seizure-fresh-lease", False),
    ("lease-unclamped", "clamp-2",
     [("crash", 0), ("advance",), ("advance",), ("adopt", 1)],
     "seizure-fresh-lease", False),
    ("created-no-rescue", "created-2",
     [("crash", 1)], "convergence-offer", True),
]


@pytest.mark.parametrize(
    "mutant,scenario,schedule,rule,stabilized",
    PROTOCHECK_SCHEDULES, ids=[s[0] for s in PROTOCHECK_SCHEDULES])
def test_protocheck_schedule_replays_bug_and_live_fix(
        mutant, scenario, schedule, rule, stabilized):
    m = BY_NAME[mutant]
    v1, k1, _ = replay(SCENARIOS[scenario], schedule, mutant=m,
                       stabilize=stabilized)
    v2, k2, _ = replay(SCENARIOS[scenario], schedule, mutant=m,
                       stabilize=stabilized)
    assert v1 and v1[0].rule == rule, (mutant, [str(v) for v in v1])
    assert k1 == k2
    v_live, _, _ = replay(SCENARIOS[scenario], schedule,
                          stabilize=stabilized)
    assert not v_live, (mutant, [str(v) for v in v_live])


def test_the_chaos_schedules_are_the_references():
    from test_chaos import PROTOCHECK_SCHEDULES as REF

    assert PROTOCHECK_SCHEDULES == REF


# ---- parity with the reference's checker ----------------------------------


@pytest.mark.parametrize("name", list(DEFAULT_SCENARIOS) + ["replica-2"])
def test_both_checkers_explore_the_same_space(name):
    """Each checker over its own package: equal states, transitions,
    depth and verdict."""
    from tools.protocheck.explore import explore as ref_explore
    from tools.protocheck.model import SCENARIOS as REF_SCENARIOS
    from tools.protocheck.replica_model import (
        ReplicaScenario as RefReplicaScenario,
        explore_replica as ref_explore_replica)

    if name == "replica-2":
        ref = ref_explore_replica(RefReplicaScenario())
    else:
        ref = ref_explore(REF_SCENARIOS[name])
    mine = _live(name)
    assert (mine.states, mine.transitions, mine.depth, mine.ok) == \
        (ref.states, ref.transitions, ref.depth, ref.ok)
    assert (mine.pruned_visited, mine.pruned_sleep) == \
        (ref.pruned_visited, ref.pruned_sleep)
