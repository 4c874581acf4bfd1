"""hstream-analyze over the port: the repo's AST static analysis, run
over `hstream_tpu_torch` and its two drivers (`chip_smoke.py`, `ab.py`).

This is the port's own copy of `tools/analyze` (which scans the JAX
package and stays as it is). The passes that check host code are
carried unchanged; the ones that named the reference's files name the
port's; `dispatch` recognises the port's idioms (kernel wrappers,
torch fetches); the passes and rules whose object is jax (`jit`,
`shard_map`, donation) are not carried, and `DROPPED_RULES` says why for
each. Rules carried:

  locks        lock-guard / lock-order   guarded-attribute discipline
  lockorder    lockorder-cycle           whole-program lock-acquisition
                                         graph is acyclic
  atomicity    atomicity-check-act       a guarded read's decision may
                                         not outlive its critical section
  waitholding  wait-holding              no join/result/wait/queue
                                         blocking under an unrelated lock
  blocking     blocking-hot              no unbounded blocking in gRPC
                                         handlers, the Prometheus scrape
                                         path, or worker loops
  dispatch     dispatch-budget / dispatch-sync
                                         `# contract: dispatches<=N
                                         fetches<=M` budgets hold; no
                                         bare device syncs in the hot
                                         files
  retrace      retrace-uncached-jit / retrace-shape-key
                                         program factories are memoized
                                         and keyed by padded sizes
  overflow     overflow-*                int32 narrows of time/seq
                                         values are guarded
  errcontract  err-*                     gRPC status <-> HTTP mapping <->
                                         client retry classification
  lifecycle    resource-leak             threads/executors are joined
  registry     registry-*                metric/event registries match
                                         call sites both directions
  casdiscipline, timeunit                CAS writes and time units

Every file a pass names (its `PATHS`) must be in the loaded tree: a
full run reports `analyze-path` for one that is not, so a pass never
checks nothing without saying so.

Waivers: `# analyze: ok <rule>[,<rule>...]` on the line (or on a
comment-only line right above it), or a bare `# analyze: ok`, marks a
reviewed exception. Baseline: `baseline.json` beside this file holds
grandfathered findings keyed (rule, path, message); it is EMPTY — keep
it that way.

Run from the repo root:

    python -m hstream_tpu_torch.tools.analyze [--only locks,registry]
        [--json] [--list-rules] [--stats]
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

# production code the passes scan: the port and its two drivers (as
# bench.py is the reference's); tests are excluded on purpose (they
# deliberately exercise error paths, fake blocking, etc.)
SCAN_ROOTS = ("hstream_tpu_torch", "chip_smoke.py", "ab.py")
# skipped directories (repo-relative, whole path components): the
# generated protobuf output, the analyzer itself, the kernels' build
SKIP_DIRS = ("hstream_tpu_torch/proto", "hstream_tpu_torch/tools/analyze",
             "hstream_tpu_torch/engine/kernels/_build")
SKIP_PARTS = ("__pycache__",)

BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "baseline.json")

_WAIVER_RE = re.compile(r"#\s*analyze:\s*ok\b\s*([\w\-, ]*)")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str      # repo-relative, forward slashes
    line: int
    message: str

    def key(self) -> tuple[str, str, str]:
        """Baseline identity: line numbers drift, messages don't."""
        return (self.rule, self.path, self.message)

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class SourceFile:
    """One parsed source file shared by every pass: path, text, AST,
    and the per-line waiver map."""

    def __init__(self, path: str, rel: str, text: str):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=self.rel)
        # line -> set of waived rules ("*" = all)
        self.waivers: dict[int, set[str]] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _WAIVER_RE.search(line)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            waived = rules or {"*"}
            self.waivers.setdefault(i, set()).update(waived)
            if line.lstrip().startswith("#"):
                # comment-only line: the waiver covers the next line too
                self.waivers.setdefault(i + 1, set()).update(waived)

    def waived(self, line: int, rule: str) -> bool:
        w = self.waivers.get(line, ())
        return "*" in w or rule in w


def _skipped(rel: str) -> bool:
    """True for a path under a SKIP_DIRS directory or with a SKIP_PARTS
    component (a match of whole components, never of a substring)."""
    rel = rel.replace(os.sep, "/")
    if any(p in SKIP_PARTS for p in rel.split("/")):
        return True
    return any(rel == d or rel.startswith(d + "/") for d in SKIP_DIRS)


def load_tree(repo: str = REPO) -> list[SourceFile]:
    files: list[SourceFile] = []
    for root in SCAN_ROOTS:
        p = os.path.join(repo, root)
        paths = [p] if os.path.isfile(p) else sorted(
            os.path.join(dirpath, f)
            for dirpath, _dirs, names in os.walk(p)
            for f in names if f.endswith(".py"))
        for path in paths:
            rel = os.path.relpath(path, repo)
            if _skipped(rel):
                continue
            with open(path, encoding="utf-8") as f:
                files.append(SourceFile(path, rel, f.read()))
    return files


def all_passes() -> dict[str, object]:
    """name -> pass module, in canonical order."""
    from hstream_tpu_torch.tools.analyze.passes import (
        atomicity,
        blocking,
        casdiscipline,
        dispatch,
        errcontract,
        lifecycle,
        lockorder,
        locks,
        overflow,
        registry,
        retrace,
        timeunit,
        waitholding,
    )

    return {m.NAME: m for m in
            (locks, lockorder, atomicity, waitholding, blocking,
             dispatch, retrace, overflow, errcontract, lifecycle,
             registry, casdiscipline, timeunit)}


# The reference's rules that have no object in the port, with why. Each
# is listed by --list-rules; none is dropped without a line here.
DROPPED_RULES = {
    "jax-impure": (
        "pass purity: the port traces nothing — no jax.jit or "
        "shard_map, so no host effect can freeze at trace time; its "
        "device code is CUDA, built by nvcc"),
    "jax-donated-reuse": (
        "pass purity: the port donates no buffer — its steps update "
        "the planes in place by design, and the wire words stay "
        "valid after the launch"),
    "shardmap-collective": (
        "pass shardmap: the port has no shard_map and no collectives; "
        "a mesh is one launch a card over a table of its shards "
        "(parallel/lattice.py)"),
    "shardmap-callback": (
        "pass shardmap: no shard_map body exists to hold a host "
        "callback; a fetch on a mesh path is budgeted by dispatch's "
        "contracts like any other"),
    "shardmap-axis": (
        "pass shardmap: no mesh axis names exist to misspell; shards "
        "are indexed (d, k) by integers"),
    "retrace-traced-branch": (
        "pass retrace: no Python function is traced, so a host branch "
        "on an argument is plain control flow"),
    "retrace-static-arg": (
        "pass retrace: no static_argnums/static_argnames exist; a "
        "program factory's arguments are lru_cache keys, which "
        "retrace-shape-key checks"),
}


PATH_RULE = "analyze-path"
PATH_DOC = (
    "a pass names a file (a path constant in its PATHS) that the loaded "
    "tree does not hold — it would check nothing there without saying "
    "so; repoint the constant")


def _path_line(mod, path: str) -> tuple[str, int]:
    """(repo-relative file, line) of the pass module's mention of
    `path`, for the analyze-path finding."""
    fn = mod.__file__
    rel = os.path.relpath(fn, REPO).replace(os.sep, "/")
    try:
        with open(fn, encoding="utf-8") as f:
            for i, line in enumerate(f, start=1):
                if f'"{path}"' in line:
                    return rel, i
    except OSError:
        pass
    return rel, 1


def missing_paths(files: list[SourceFile],
                  passes: dict[str, object]) -> list[Finding]:
    """An analyze-path finding for every file a selected pass names that
    `files` does not hold."""
    have = {f.rel for f in files}
    out: list[Finding] = []
    for name, mod in passes.items():
        for path in getattr(mod, "PATHS", ()):
            if path not in have:
                rel, line = _path_line(mod, path)
                out.append(Finding(
                    PATH_RULE, rel, line,
                    f"pass {name} names {path}, which the loaded tree "
                    f"does not hold"))
    return out


def rule_passes() -> dict[str, str]:
    """rule id -> owning pass name (the --json `pass` field: CI
    annotators group/route findings by pass without re-deriving the
    mapping)."""
    return {rid: name for name, mod in all_passes().items()
            for rid in mod.RULES}


def load_baseline(path: str = BASELINE_PATH) -> set[tuple[str, str, str]]:
    if not os.path.exists(path):
        return set()
    with open(path, encoding="utf-8") as f:
        entries = json.load(f)
    return {(e["rule"], e["path"], e["message"]) for e in entries}


def write_baseline(findings: list[Finding], path: str = BASELINE_PATH,
                   keep_rules: set[str] | None = None) -> None:
    """Write the baseline. `keep_rules`: rule ids whose EXISTING entries
    are preserved verbatim — used when only a subset of passes ran, so
    `--only X --write-baseline` cannot drop other passes' entries."""
    entries = [{"rule": f.rule, "path": f.path, "message": f.message}
               for f in findings]
    if keep_rules and os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            entries.extend(e for e in json.load(f)
                           if e["rule"] in keep_rules)
    entries.sort(key=lambda e: (e["rule"], e["path"], e["message"]))
    with open(path, "w", encoding="utf-8") as f:
        json.dump(entries, f, indent=1)
        f.write("\n")


def run_passes(files: list[SourceFile], only: list[str] | None = None,
               repo: str = REPO
               ) -> tuple[list[Finding], dict[str, str]]:
    """Run the (selected) passes; returns (unwaived findings, rule docs
    of every selected pass), with every file a selected pass names that
    `files` lacks reported as an analyze-path finding."""
    passes = all_passes()
    if only:
        unknown = [n for n in only if n not in passes]
        if unknown:
            raise SystemExit(
                f"unknown pass(es) {unknown}; valid: {sorted(passes)}")
        passes = {n: passes[n] for n in only}
    by_rel = {f.rel: f for f in files}
    rules: dict[str, str] = {}
    out: list[Finding] = []
    # (path, line) -> rules actually suppressed there, for the
    # stale-waiver audit below
    suppressed: dict[tuple[str, int], set[str]] = {}
    for mod in passes.values():
        rules.update(mod.RULES)
        for finding in mod.run(files, repo):
            src = by_rel.get(finding.path)
            if src is not None and src.waived(finding.line, finding.rule):
                suppressed.setdefault(
                    (finding.path, finding.line), set()).add(finding.rule)
                continue
            out.append(finding)
    out.extend(_dead_waivers(files, set(rules), suppressed,
                             all_selected=only is None))
    rules[WAIVER_DEAD_RULE] = WAIVER_DEAD_DOC
    out.extend(missing_paths(files, passes))
    rules[PATH_RULE] = PATH_DOC
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out, rules


WAIVER_DEAD_RULE = "waiver-dead"
WAIVER_DEAD_DOC = (
    "an `# analyze: ok` waiver that suppressed nothing in this run — "
    "the code it excused was fixed or moved, and a stale waiver is a "
    "standing license for the next regression at that site; delete "
    "the comment (waiver-dead findings cannot themselves be waived)")


def _dead_waivers(files: list[SourceFile], selected_rules: set[str],
                  suppressed: dict[tuple[str, int], set[str]],
                  all_selected: bool) -> list[Finding]:
    """The stale-waiver audit: every waiver comment must still suppress
    at least one finding of every rule it names. Scoped to the passes
    that ran — a waiver naming an unselected pass's rule is skipped,
    and BARE waivers (`# analyze: ok` with no rule list) are only
    auditable when every pass ran."""
    out: list[Finding] = []
    for src in files:
        for i, line in enumerate(src.lines, start=1):
            m = _WAIVER_RE.search(line)
            if not m:
                continue
            named = {r.strip() for r in m.group(1).split(",")
                     if r.strip()}
            # a comment-only waiver line covers the next line too
            covered = ({i, i + 1} if line.lstrip().startswith("#")
                       else {i})
            hits: set[str] = set()
            for ln in covered:
                hits |= suppressed.get((src.rel, ln), set())
            if not named:
                if all_selected and not hits:
                    out.append(Finding(
                        WAIVER_DEAD_RULE, src.rel, i,
                        "bare waiver suppresses nothing — delete it"))
                continue
            for rule in sorted(named & selected_rules):
                if rule not in hits:
                    out.append(Finding(
                        WAIVER_DEAD_RULE, src.rel, i,
                        f"waiver for {rule} suppresses nothing — the "
                        f"excused finding is gone; delete the waiver"))
    return out


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        "python -m hstream_tpu_torch.tools.analyze",
        description="static analysis of the port (see "
                    "hstream_tpu_torch/tools/analyze)")
    ap.add_argument("--only", default=None,
                    help="comma-separated pass names "
                         "(locks,lockorder,atomicity,waitholding,"
                         "blocking,dispatch,retrace,overflow,"
                         "errcontract,lifecycle,registry,"
                         "casdiscipline,timeunit)")
    ap.add_argument("--stats", action="store_true",
                    help="emit per-rule finding counts (incl. baselined)")
    ap.add_argument("--json", action="store_true",
                    help="emit NEW findings as one JSON array of "
                         "{rule,path,line,message} records (CI "
                         "annotation tooling); exit code unchanged")
    ap.add_argument("--baseline", default=BASELINE_PATH,
                    help="baseline file (default hstream_tpu_torch/tools/"
                         "analyze/baseline.json)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="grandfather every current finding into "
                         "the baseline file")
    ap.add_argument("--list-rules", action="store_true",
                    help="print every rule id + doc and exit")
    ap.add_argument("--repo", default=REPO, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    only = ([n.strip() for n in args.only.split(",") if n.strip()]
            if args.only else None)
    if args.list_rules:
        # rule docs come straight from the pass modules — nothing runs
        passes = all_passes()
        for name in (only or passes):
            if name not in passes:
                raise SystemExit(f"unknown pass {name!r}; "
                                 f"valid: {sorted(passes)}")
            for rid, doc in sorted(passes[name].RULES.items()):
                print(f"{rid}: {doc}")
        if only is None:
            # the framework-level audits ride every full run
            print(f"{WAIVER_DEAD_RULE}: {WAIVER_DEAD_DOC}")
            print(f"{PATH_RULE}: {PATH_DOC}")
            for rid, why in sorted(DROPPED_RULES.items()):
                print(f"{rid}: not carried — {why}")
        return 0

    files = load_tree(args.repo)
    findings, rules = run_passes(files, only, args.repo)
    baseline = load_baseline(args.baseline)
    if args.write_baseline:
        # with --only, entries owned by the passes that did NOT run
        # survive the rewrite untouched
        ran = set(rules)
        all_rules: set[str] = set()
        for mod in all_passes().values():
            all_rules |= set(mod.RULES)
        write_baseline(findings, args.baseline,
                       keep_rules=all_rules - ran)
        print(f"analyze: baselined {len(findings)} finding(s)")
        return 0
    new = [f for f in findings if f.key() not in baseline]
    grandfathered = len(findings) - len(new)

    if args.json:
        # machine output only: one array of finding records, so CI
        # annotators never have to scrape the human report. Each
        # record carries its owning pass, and the array order is a
        # total order over the record fields — deterministic for CI
        # annotation diffing, so consumers stop re-sorting
        owners = rule_passes()
        ordered = sorted(new, key=lambda f: (f.path, f.line, f.rule,
                                             f.message))
        print(json.dumps([{"pass": owners.get(f.rule, "?"),
                           "rule": f.rule, "path": f.path,
                           "line": f.line, "message": f.message}
                          for f in ordered]))
        return 1 if new else 0

    if args.stats:
        counts: dict[str, int] = {}
        for f in findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        print("analyze: per-rule finding counts "
              "(before baseline subtraction)")
        for rid in sorted(set(counts) | set(rules)):
            print(f"  {rid:>20}: {counts.get(rid, 0)}")

    if new:
        print(f"analyze: {len(new)} new finding(s)"
              + (f" ({grandfathered} baselined)" if grandfathered else ""))
        for f in new:
            print(f"  {f}")
        print("\nrule docs (fired rules):")
        for rid in sorted({f.rule for f in new}):
            print(f"  {rid}: {rules.get(rid, '?')}")
        print("\nwaive a reviewed exception with `# analyze: ok <rule>` "
              "on (or right above) the line;\ngrandfather pre-existing "
              "findings with `python -m hstream_tpu_torch.tools.analyze "
              "--write-baseline`.")
        return 1
    npass = len(only) if only else len(all_passes())
    print(f"analyze: OK ({npass} pass(es), {len(files)} files"
          + (f", {grandfathered} baselined finding(s))" if grandfathered
             else ", no findings)"))
    return 0
