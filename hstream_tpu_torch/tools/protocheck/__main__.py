"""CLI: ``python -m hstream_tpu_torch.tools.protocheck``.

Default run explores every registered scenario (ownership/failover
models + the replica epoch model) against the LIVE protocol code and
fails on any invariant violation. ``--mutants`` runs the mutation
gate: every mechanically reverted ownership/replication fix must yield a
counterexample, proving the checker can actually see the bugs those
fixes closed. The last counterexample is persisted to
``.protocheck-torch-last.json``; ``--explain`` replays it as a per-step
record/owner timeline.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

LAST_CE_PATH = ".protocheck-torch-last.json"


def _save_ce(ce, repo: str) -> None:
    try:
        with open(os.path.join(repo, LAST_CE_PATH), "w",
                  encoding="utf-8") as f:
            json.dump(ce.to_json(), f, indent=1)
    except OSError:
        pass


def _fmt_result(r) -> str:
    mark = "ok " if r.ok else "FAIL"
    return (f"  {mark} {r.scenario:<12} states={r.states:<7} "
            f"transitions={r.transitions:<8} depth<={r.depth} "
            f"pruned(visited={r.pruned_visited} "
            f"sleep={r.pruned_sleep}) {r.elapsed_s:.1f}s")


def run_live(names: list[str], depth: int | None, out: list) -> bool:
    from hstream_tpu_torch.tools.protocheck.explore import explore
    from hstream_tpu_torch.tools.protocheck.model import SCENARIOS
    from hstream_tpu_torch.tools.protocheck.replica_model import (ReplicaScenario,
                                                explore_replica)

    ok = True
    for name in names:
        if name == "replica-2":
            r = explore_replica(ReplicaScenario(), max_depth=depth)
        else:
            r = explore(SCENARIOS[name], max_depth=depth)
        out.append(r)
        print(_fmt_result(r))
        if not r.ok:
            ok = False
            ce = r.counterexample
            print(f"       counterexample [{ce.rule}]: {ce.message}")
            for i, a in enumerate(ce.trace):
                print(f"         {i + 1}. {tuple(a)}")
    return ok


def run_mutants(which: list[str] | None, out: list) -> bool:
    from hstream_tpu_torch.tools.protocheck.explore import explore
    from hstream_tpu_torch.tools.protocheck.model import SCENARIOS
    from hstream_tpu_torch.tools.protocheck.mutants import BY_NAME, MUTANTS
    from hstream_tpu_torch.tools.protocheck.replica_model import (ReplicaScenario,
                                                explore_replica)

    todo = MUTANTS if not which else [BY_NAME[n] for n in which]
    ok = True
    for m in todo:
        if m.kind == "replica":
            r = explore_replica(ReplicaScenario(), mutant=m)
        else:
            r = explore(SCENARIOS[m.scenario], mutant=m)
        out.append(r)
        if r.ok:
            ok = False
            print(f"  FAIL {m.name:<24} NOT CAUGHT "
                  f"(scenario {m.scenario}, states={r.states}, "
                  f"{r.elapsed_s:.1f}s) — reverting '{m.fix}' went "
                  f"unnoticed")
        else:
            ce = r.counterexample
            print(f"  ok   {m.name:<24} caught by {ce.rule} after "
                  f"{len(ce.trace)} steps ({r.elapsed_s:.1f}s)")
    return ok


def explain(repo: str) -> int:
    path = os.path.join(repo, LAST_CE_PATH)
    if not os.path.exists(path):
        print("no saved counterexample (.protocheck-torch-last.json); run "
              "the checker first")
        return 2
    from hstream_tpu_torch.tools.protocheck.explore import Counterexample
    with open(path, encoding="utf-8") as f:
        ce = Counterexample.from_json(json.load(f))
    mutant = None
    if ce.mutant:
        from hstream_tpu_torch.tools.protocheck.mutants import BY_NAME
        mutant = BY_NAME[ce.mutant]
    print(f"scenario {ce.scenario}"
          + (f" under mutant {ce.mutant}" if ce.mutant else "")
          + f" — violates {ce.rule}"
          + (" (during stabilization)" if ce.stabilized else ""))
    print(f"  {ce.message}\n")
    if ce.scenario == "replica-2":
        _explain_replica(ce, mutant)
        return 0
    from hstream_tpu_torch.tools.protocheck.explore import replay
    from hstream_tpu_torch.tools.protocheck.model import SCENARIOS
    _vs, _keys, steps = replay(SCENARIOS[ce.scenario], ce.trace,
                               mutant=mutant,
                               stabilize=ce.stabilized, timeline=True)
    for i, st in enumerate(steps):
        print(f"step {i}: {st['action']}  (t={st['clock_ms']}ms)")
        for n in st["nodes"]:
            flags = []
            if not n["alive"]:
                flags.append("DOWN")
            if n["paused"]:
                flags.append("paused")
            if not n["armed"]:
                flags.append("disarmed")
            if n["skew_ms"]:
                flags.append(f"skew{n['skew_ms']:+d}ms")
            print(f"    {n['name']:<22} epoch={n['epoch']} "
                  f"running={n['running']}"
                  + (f"  [{' '.join(flags)}]" if flags else ""))
        for qid, rec in st["records"].items():
            if rec.get("raw"):
                print(f"    {qid}: <unparseable record>")
                continue
            bits = [f"{rec['state']} by {rec['node']}",
                    f"epoch={rec['epoch']}"]
            if "hb_age_ms" in rec:
                bits.append(f"hb_age={rec['hb_age_ms']}ms")
            if "src" in rec:
                bits.append(f"src={rec['src']}")
            print(f"    {qid}: " + "  ".join(bits))
        print()
    return 0


def _explain_replica(ce, mutant) -> None:
    from hstream_tpu_torch.tools.protocheck.replica_model import replay_replica
    _vs, keys = replay_replica(ce.trace, mutant=mutant,
                               stabilize=ce.stabilized)
    actions = ["initial"] + [str(tuple(a)) for a in ce.trace]
    if ce.stabilized:
        actions.append("stabilize")
    for i, key in enumerate(keys):
        fstates, leaders = key[0], key[1]
        print(f"step {i}: {actions[i] if i < len(actions) else '?'}")
        for epoch, lid, isl, seq, _fp in fstates:
            role = "LEADER" if isl else f"follows {lid!r}"
            print(f"    epoch={epoch} applied={seq} {role}")
        if leaders:
            print(f"    promoted identities: {list(leaders)}")
        print()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="hstream_tpu_torch.tools.protocheck",
        description="exhaustive state-space check of the ownership/"
                    "failover and replica-epoch protocols")
    ap.add_argument("--scenario", action="append",
                    help="run only this scenario (repeatable)")
    ap.add_argument("--depth", type=int, default=None,
                    help="override the per-scenario depth bound")
    ap.add_argument("--mutants", action="store_true",
                    help="mutation gate: every reverted fix must "
                         "yield a counterexample")
    ap.add_argument("--mutant", action="append",
                    help="gate only this mutant (repeatable; implies "
                         "--mutants)")
    ap.add_argument("--explain", action="store_true",
                    help="replay the last saved counterexample as a "
                         "per-step timeline")
    ap.add_argument("--json", action="store_true",
                    help="emit machine-readable results on stdout")
    ap.add_argument("--repo", default=".",
                    help="repo root (for the saved counterexample)")
    args = ap.parse_args(argv)

    if args.explain:
        return explain(args.repo)

    from hstream_tpu_torch.tools.protocheck.model import SCENARIOS

    names = args.scenario or (list(SCENARIOS) + ["replica-2"])
    for n in names:
        if n not in SCENARIOS and n != "replica-2":
            ap.error(f"unknown scenario {n!r} (have: "
                     f"{', '.join(list(SCENARIOS) + ['replica-2'])})")

    t0 = time.monotonic()
    results: list = []
    ok = True
    if args.mutants or args.mutant:
        print("mutation gate (each reverted fix must be caught):")
        ok = run_mutants(args.mutant, results) and ok
    else:
        print("live-tree exploration:")
        ok = run_live(names, args.depth, results) and ok

    # persist the most interesting counterexample for --explain:
    # a live-tree violation beats a mutant-gate one
    last_ce = None
    for r in results:
        if r.counterexample is not None:
            if last_ce is None or r.counterexample.mutant is None:
                last_ce = r.counterexample
    if last_ce is not None:
        _save_ce(last_ce, args.repo)
        print(f"\nlast counterexample saved to {LAST_CE_PATH}; "
              f"run with --explain for the timeline")

    elapsed = time.monotonic() - t0
    if args.json:
        print(json.dumps({
            "ok": ok, "elapsed_s": round(elapsed, 2),
            "results": [{
                "scenario": r.scenario, "states": r.states,
                "transitions": r.transitions, "depth": r.depth,
                "elapsed_s": round(r.elapsed_s, 2),
                "mutant": (r.counterexample.mutant
                           if r.counterexample else None),
                "violation": (r.counterexample.rule
                              if r.counterexample else None),
            } for r in results]}))
    else:
        verdict = "CERTIFIED" if ok else "VIOLATIONS FOUND"
        if args.mutants or args.mutant:
            verdict = ("MUTATION GATE PASSED" if ok
                       else "MUTATION GATE FAILED")
        print(f"\n{verdict} — {len(results)} run(s) in {elapsed:.1f}s")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
