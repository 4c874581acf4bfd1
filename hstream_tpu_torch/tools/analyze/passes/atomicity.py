"""Check-then-act pass.

The `lock-guard` rule proves every ACCESS to guarded state holds the
guard — but a correctly-locked read whose DECISION executes after
release is still a race: the supervisor's corpse/cancel bugs (a
review caught them by hand) were exactly this shape — read a task's
status under the lock, release, then re-take the lock and mutate based
on the now-stale verdict.

`atomicity-check-act` flags the statically recognizable core of that
bug class, per class (reusing the locks pass's ownership inference):

  1. a local is assigned from a read of a guarded attribute inside
     `with self.<lock>:`;
  2. after the block exits, that local is the test (or part of the
     test) of an `if`/`while` OUTSIDE any block holding the guard;
  3. the taken branch writes an attribute guarded by the SAME lock —
     directly, or under a RE-acquired `with self.<lock>:`.

Step 3's re-acquired form is the one `lock-guard` cannot see: every
individual access is locked, yet check and act run in different
critical sections. Suppressions encode the repo's correct idioms:

  * a branch whose re-acquired block RE-CHECKS guarded state (an
    `if`/`while` test inside the `with` that reads any attribute the
    lock guards) is the check-twice idiom — clean;
  * a read variable only RETURNED / reported (never branching into a
    guarded write) is the snapshot idiom — clean;
  * `__init__` and caller-holds (`*_locked`) methods are exempt, like
    the locks pass.
"""

from __future__ import annotations

import ast

from hstream_tpu_torch.tools.analyze import Finding
from hstream_tpu_torch.tools.analyze.passes import class_methods, walk_classes
from hstream_tpu_torch.tools.analyze.passes.locks import _lock_attrs, _runs_locked

NAME = "atomicity"

RULES = {
    "atomicity-check-act": (
        "a guarded read's decision executes after the lock is "
        "released: the branch re-acquires the lock (or writes "
        "unguarded) and mutates guarded state based on a stale "
        "verdict — check and act must share one critical section"),
}


# container mutators: calling one of these ON a guarded attribute is a
# write to the guarded state, exactly like a plain store
_MUTATORS = frozenset({
    "pop", "append", "add", "remove", "clear", "discard", "update",
    "insert", "extend", "setdefault", "popitem", "put", "appendleft",
    "popleft"})


def _self_attr_accesses(fn: ast.FunctionDef, lock_attrs: set[str]):
    """(attr, is_write, held-locks) triples for one method, with
    WRITES broadened over the locks pass: subscript stores
    (`self.X[k] = v`), deletes, and container mutator calls
    (`self.X.pop(...)`) count — check-then-act races live in exactly
    those container updates. Nested defs are skipped."""
    out: list[tuple[str, bool, frozenset[str]]] = []
    skip: set[int] = set()
    for sub in ast.walk(fn):
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)) and sub is not fn:
            for inner in ast.walk(sub):
                skip.add(id(inner))

    def attr_of(node: ast.AST) -> str | None:
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and node.attr not in lock_attrs):
            return node.attr
        return None

    def scan_expr(node: ast.AST, held: tuple[str, ...]) -> None:
        for sub in ast.walk(node):
            if id(sub) in skip:
                continue
            a = attr_of(sub)
            if a is not None:
                write = isinstance(sub.ctx, (ast.Store, ast.Del))
                out.append((a, write, frozenset(held)))
            elif isinstance(sub, ast.Subscript) and \
                    isinstance(sub.ctx, (ast.Store, ast.Del)):
                a = attr_of(sub.value)
                if a is not None:
                    out.append((a, True, frozenset(held)))
            elif isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr in _MUTATORS:
                a = attr_of(sub.func.value)
                if a is not None:
                    out.append((a, True, frozenset(held)))

    def walk(stmts, held: tuple[str, ...]):
        for stmt in stmts:
            if id(stmt) in skip or isinstance(
                    stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(stmt, ast.With):
                taken = list(held)
                for item in stmt.items:
                    scan_expr(item.context_expr, held)
                    e = item.context_expr
                    if (isinstance(e, ast.Attribute)
                            and isinstance(e.value, ast.Name)
                            and e.value.id == "self"
                            and e.attr in lock_attrs):
                        taken.append(e.attr)
                walk(stmt.body, tuple(taken))
            elif isinstance(stmt, (ast.If, ast.While)):
                scan_expr(stmt.test, held)
                walk(stmt.body, held)
                walk(stmt.orelse, held)
            elif isinstance(stmt, ast.For):
                scan_expr(stmt.iter, held)
                scan_expr(stmt.target, held)
                walk(stmt.body, held)
                walk(stmt.orelse, held)
            elif isinstance(stmt, ast.Try):
                walk(stmt.body, held)
                for h in stmt.handlers:
                    walk(h.body, held)
                walk(stmt.orelse, held)
                walk(stmt.finalbody, held)
            else:
                scan_expr(stmt, held)

    walk(fn.body, ())
    return out


def infer_guards_broad(cls: ast.ClassDef
                       ) -> tuple[set[str], dict[str, set[str]], dict]:
    """Per-class guard inference with container-write recognition:
    attr guarded by L when (broadly) WRITTEN under L and touched under
    L in >= 2 methods — the locks-pass rule over richer writes."""
    lock_attrs = _lock_attrs(cls)
    if not lock_attrs:
        return set(), {}, {}
    methods = {m.name: m for m in class_methods(cls)}
    locked_in: dict[tuple[str, str], set[str]] = {}
    written_under: dict[str, set[str]] = {}
    for name, fn in methods.items():
        under_all = frozenset(lock_attrs) if _runs_locked(fn) else None
        for attr, is_write, held in _self_attr_accesses(fn, lock_attrs):
            for lock in (under_all or held):
                locked_in.setdefault((attr, lock), set()).add(name)
                if is_write:
                    written_under.setdefault(attr, set()).add(lock)
    guards: dict[str, set[str]] = {}
    for (attr, lock), ms in locked_in.items():
        if len(ms) >= 2 and lock in written_under.get(attr, ()):
            guards.setdefault(attr, set()).add(lock)
    return lock_attrs, guards, methods


def _guarded_reads(expr: ast.AST, guards: dict[str, set[str]],
                   held: set[str]) -> set[str]:
    """Attrs read in `expr` that are guarded by a currently-held lock."""
    out: set[str] = set()
    for node in ast.walk(expr):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and isinstance(node.ctx, ast.Load)
                and guards.get(node.attr, set()) & held):
            out.add(node.attr)
    return out


def _names_in(expr: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(expr) if isinstance(n, ast.Name)}


class _Method(ast.NodeVisitor):
    """Single linear walk of one method tracking (a) the held-lock
    stack, (b) locals carrying guarded reads, (c) branch tests on
    those locals outside the guard."""

    def __init__(self, src, cls_name, fn, guards, lock_attrs):
        self.src = src
        self.cls_name = cls_name
        self.fn = fn
        self.guards = guards
        self.lock_attrs = lock_attrs
        self.held: list[str] = []
        # var -> (guarded attr, lock held at the read, read line)
        self.carriers: dict[str, tuple[str, str, int]] = {}
        self.findings: list[Finding] = []
        for stmt in fn.body:
            self.visit(stmt)

    def visit_FunctionDef(self, node):  # noqa: N802 — own scope
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def visit_With(self, node: ast.With):  # noqa: N802
        taken = []
        for item in node.items:
            d = item.context_expr
            attr = None
            if (isinstance(d, ast.Attribute)
                    and isinstance(d.value, ast.Name)
                    and d.value.id == "self"
                    and d.attr in self.lock_attrs):
                attr = d.attr
            if attr is not None:
                self.held.append(attr)
                taken.append(attr)
        for stmt in node.body:
            self.visit(stmt)
        for _ in taken:
            self.held.pop()

    def visit_Assign(self, node: ast.Assign):  # noqa: N802
        held = set(self.held)
        reads = _guarded_reads(node.value, self.guards, held)
        targets = [t.id for t in node.targets
                   if isinstance(t, ast.Name)]
        for t in targets:
            if reads and held:
                attr = sorted(reads)[0]
                lock = sorted(self.guards[attr] & held)[0]
                self.carriers[t] = (attr, lock, node.lineno)
            else:
                self.carriers.pop(t, None)  # rebound: stops carrying
        self.generic_visit(node)

    def _branch_acts(self, body: list[ast.stmt], lock: str) -> bool:
        """Does the branch write state guarded by `lock` — directly
        (unguarded) or under a re-acquired `with self.<lock>:` that
        does NOT re-check guarded state first?"""
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.With):
                    reacquires = any(
                        isinstance(i.context_expr, ast.Attribute)
                        and isinstance(i.context_expr.value, ast.Name)
                        and i.context_expr.value.id == "self"
                        and i.context_expr.attr == lock
                        for i in node.items)
                    if not reacquires:
                        continue
                    rechecks = any(
                        isinstance(sub, (ast.If, ast.While))
                        and _guarded_reads(sub.test, self.guards,
                                           {lock})
                        for w in node.body for sub in ast.walk(w))
                    if rechecks:
                        continue
                    if self._writes_guarded(node, lock):
                        return True
                elif (isinstance(node, ast.Attribute)
                      and isinstance(node.ctx, (ast.Store, ast.Del))
                      and isinstance(node.value, ast.Name)
                      and node.value.id == "self"
                      and lock in self.guards.get(node.attr, ())):
                    return True  # unguarded direct write
        return False

    def _writes_guarded(self, tree: ast.AST, lock: str) -> bool:
        for node in ast.walk(tree):
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.ctx, (ast.Store, ast.Del))
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "self"
                    and lock in self.guards.get(node.attr, ())):
                return True
            # container mutation: self._pending.pop(...), .append(...)
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute):
                base = node.func.value
                if (isinstance(base, ast.Attribute)
                        and isinstance(base.value, ast.Name)
                        and base.value.id == "self"
                        and lock in self.guards.get(base.attr, ())
                        and node.func.attr in (
                            "pop", "append", "add", "remove", "clear",
                            "discard", "update", "insert", "extend",
                            "setdefault", "popitem", "put")):
                    return True
        return False

    def _check_test(self, node) -> None:
        if self.held:
            return  # decision still under some lock of the class
        for name in _names_in(node.test):
            hit = self.carriers.get(name)
            if hit is None:
                continue
            attr, lock, read_line = hit
            branches = [node.body] + ([node.orelse] if node.orelse
                                      else [])
            if any(self._branch_acts(b, lock) for b in branches):
                self.findings.append(Finding(
                    "atomicity-check-act", self.src.rel, node.lineno,
                    f"{self.cls_name}.{self.fn.name}: decision on "
                    f"'{name}' (read of '{attr}' under "
                    f"'{lock}' at a released critical section) acts "
                    f"on '{lock}'-guarded state after release — "
                    f"check and act are two critical sections"))
                break

    def visit_If(self, node: ast.If):  # noqa: N802
        self._check_test(node)
        self.generic_visit(node)

    def visit_While(self, node: ast.While):  # noqa: N802
        self._check_test(node)
        self.generic_visit(node)


def run(files, repo) -> list[Finding]:
    out: list[Finding] = []
    for src in files:
        for cls in walk_classes(src.tree):
            lock_attrs, guards, methods = infer_guards_broad(cls)
            if not guards:
                continue
            for name, fn in methods.items():
                if name == "__init__" or _runs_locked(fn):
                    continue
                out.extend(_Method(src, cls.name, fn, guards,
                                   lock_attrs).findings)
    return out
