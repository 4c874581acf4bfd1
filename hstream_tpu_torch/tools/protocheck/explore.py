"""Bounded exhaustive exploration with DPOR-style pruning.

Depth-first search over the model's action interleavings:

* **visited-state dedup** — the canonical state key (epoch-ranked,
  time-translated) maps to the set of actions already executed from
  that state; a revisit only runs the residue, so every reachable
  state executes every enabled action exactly once across the run;
* **sleep sets** — an action independent of everything executed since
  it was last deferred is skipped (its effect is a commuted copy of an
  executed transition); independence is the conservative footprint
  test in ``Model.independent``;
* **convergence oracle** — every distinct state additionally runs the
  deterministic stabilization drive on a snapshot and asserts
  ``check_convergence``.

On violation the explorer stops with a :class:`Counterexample`: the
exact action schedule from the initial state, replayable (and
deterministic — ``replay`` re-executes it step by step, which is also
how ``tests/test_chaos.py`` turns traces into chaos schedules and how
``--explain`` renders the per-step record/owner timeline).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

from hstream_tpu_torch.tools.protocheck import invariants
from hstream_tpu_torch.tools.protocheck.model import Model, Scenario, quiet_protocol_logs


@dataclass
class Counterexample:
    scenario: str
    rule: str
    message: str
    trace: list
    stabilized: bool  # violation surfaced in the stabilization drive
    details: dict = field(default_factory=dict)
    mutant: str | None = None

    def to_json(self) -> dict:
        return {"scenario": self.scenario, "rule": self.rule,
                "message": self.message,
                "trace": [list(a) for a in self.trace],
                "stabilized": self.stabilized, "details": self.details,
                "mutant": self.mutant}

    @classmethod
    def from_json(cls, d: dict) -> "Counterexample":
        return cls(scenario=d["scenario"], rule=d["rule"],
                   message=d["message"],
                   trace=[tuple(a) for a in d["trace"]],
                   stabilized=bool(d.get("stabilized")),
                   details=d.get("details", {}),
                   mutant=d.get("mutant"))


@dataclass
class ExploreResult:
    scenario: str
    states: int = 0
    transitions: int = 0
    pruned_sleep: int = 0
    pruned_visited: int = 0
    depth: int = 0
    elapsed_s: float = 0.0
    counterexample: Counterexample | None = None

    @property
    def ok(self) -> bool:
        return self.counterexample is None


class _Found(Exception):
    def __init__(self, violation: invariants.Violation, trace: list,
                 stabilized: bool):
        super().__init__(violation.message)
        self.violation = violation
        self.trace = trace
        self.stabilized = stabilized


def explore(scenario: Scenario, *, mutant=None,
            max_depth: int | None = None,
            convergence: bool | None = None) -> ExploreResult:
    """Exhaustively explore one scenario; stop at the first violation.
    ``mutant`` is an entry from ``mutants.MUTANTS`` whose
    patch is held for the whole run (including model construction)."""
    depth_bound = scenario.depth if max_depth is None else max_depth
    check_conv = (scenario.convergence if convergence is None
                  else convergence)
    res = ExploreResult(scenario=scenario.name, depth=depth_bound,
                        counterexample=None)
    t0 = time.monotonic()
    patch = mutant.patch() if mutant is not None \
        else contextlib.nullcontext()
    trace: list[tuple] = []
    # canonical state -> largest remaining depth it was explored with;
    # revisiting with less (or equal) budget adds nothing — this also
    # absorbs no-op self-loop transitions without burning depth
    visited: dict[tuple, int] = {}
    conv_checked: set[tuple] = set()

    with quiet_protocol_logs(), patch:
        model = Model(scenario)
        with model.engaged():
            def conv_check(key: tuple) -> None:
                if not check_conv or key in conv_checked:
                    return
                conv_checked.add(key)
                snap = model.snapshot()
                try:
                    model.stabilize()
                    vs = invariants.check_convergence(model)
                finally:
                    model.restore(snap)
                if vs:
                    raise _Found(vs[0], list(trace), True)

            def dfs(depth: int, sleep: frozenset) -> None:
                rem = depth_bound - depth
                if rem <= 0:
                    return
                key = model.state_key()
                if visited.get(key, -1) >= rem:
                    res.pruned_visited += 1
                    return
                visited[key] = rem
                executed_here: list[tuple] = []
                for a in model.enabled_actions():
                    if a in sleep:
                        res.pruned_sleep += 1
                        continue
                    snap = model.snapshot()
                    pre = model.sched_records()
                    model.execute(a)
                    post = model.sched_records()
                    trace.append(a)
                    vs = invariants.check_transition(model, a, pre,
                                                     post)
                    model.update_truth(a, pre, post)
                    vs += invariants.check_state(model)
                    res.transitions += 1
                    if vs:
                        raise _Found(vs[0], list(trace), False)
                    child_key = model.state_key()
                    conv_check(child_key)
                    child_sleep = frozenset(
                        b for b in set(sleep) | set(executed_here)
                        if model.independent(b, a))
                    dfs(depth + 1, child_sleep)
                    model.restore(snap)
                    trace.pop()
                    executed_here.append(a)

            try:
                vs = invariants.check_state(model)
                if vs:
                    raise _Found(vs[0], [], False)
                conv_check(model.state_key())
                dfs(0, frozenset())
            except _Found as f:
                res.counterexample = Counterexample(
                    scenario=scenario.name, rule=f.violation.rule,
                    message=f.violation.message, trace=f.trace,
                    stabilized=f.stabilized,
                    details=f.violation.details,
                    mutant=mutant.name if mutant is not None else None)
    res.states = len(visited)
    res.elapsed_s = time.monotonic() - t0
    return res


def replay(scenario: Scenario, trace: list, *, mutant=None,
           stabilize: bool = False, timeline: bool = False
           ) -> tuple[list, list, list]:
    """Re-execute a counterexample schedule step by step on a fresh
    model. Returns (violations, state_keys, timeline_steps) — the
    violations of the FINAL step (plus convergence when ``stabilize``),
    one canonical state key per step (replay-determinism witness), and
    the per-step record/owner timeline when requested."""
    patch = mutant.patch() if mutant is not None \
        else contextlib.nullcontext()
    violations: list = []
    keys: list = []
    steps: list = []
    with quiet_protocol_logs(), patch:
        model = Model(scenario)
        with model.engaged():
            violations = invariants.check_state(model)
            keys.append(model.state_key())
            if timeline:
                steps.append(_timeline_step(model, None))
            for a in trace:
                a = tuple(a)
                pre = model.sched_records()
                model.execute(a)
                post = model.sched_records()
                violations = invariants.check_transition(
                    model, a, pre, post)
                model.update_truth(a, pre, post)
                violations += invariants.check_state(model)
                keys.append(model.state_key())
                if timeline:
                    steps.append(_timeline_step(model, a))
            if stabilize and not violations:
                model.stabilize()
                violations = invariants.check_convergence(model)
                keys.append(model.state_key())
                if timeline:
                    steps.append(_timeline_step(model, ("stabilize",)))
    return violations, keys, steps


def render_action(action: tuple | None, model: Model | None = None
                  ) -> str:
    if action is None:
        return "initial"
    if len(action) == 1:
        return action[0]
    name = (model.nodes[action[1]].name if model is not None
            else f"node{action[1]}")
    return f"{action[0]}({name})"


def _timeline_step(model: Model, action: tuple | None) -> dict:
    records = {}
    for qid, (_raw, rec) in sorted(model.sched_records().items()):
        if not isinstance(rec, dict):
            records[qid] = {"raw": True}
            continue
        entry = {"node": rec.get("node"),
                 "state": rec.get("state", "owned"),
                 "epoch": rec.get("epoch")}
        if "hb_ms" in rec:
            entry["hb_age_ms"] = (model.clock.true_ms
                                  - model.truth.get(qid, (0, 0))[1])
        if rec.get("src"):
            entry["src"] = rec.get("src")
        records[qid] = entry
    return {
        "action": render_action(action, model),
        "clock_ms": model.clock.true_ms,
        "nodes": [{"name": n.name, "alive": n.alive,
                   "paused": n.paused, "armed": n.armed,
                   "epoch": n.ctx.boot_epoch,
                   "skew_ms": model.clock.skew.get(n.idx, 0),
                   "running": sorted(n.running)}
                  for n in model.nodes],
        "records": records,
    }
