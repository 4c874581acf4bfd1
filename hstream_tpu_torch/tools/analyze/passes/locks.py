"""Lock-discipline pass (RacerD-style ownership inference, per class).

lock-guard — infer each class's guarded-attribute set from its own
majority idiom, PER LOCK: an attribute is guarded by lock L when it is
WRITTEN at least once inside a `with self.L:` block and touched inside
`with self.L:` blocks in >= 2 distinct methods (so one incidental
locked access doesn't promote an attribute). Any access not holding a
guarding lock — including one holding only some OTHER lock of the
class — is a finding. Exemptions encode the repo's conventions:

  * `__init__` (the object is not shared yet);
  * methods whose name ends in `_locked` or whose docstring says the
    caller holds the lock — they run under the caller's critical
    section, so their accesses count as guarded for inference AND are
    never flagged;
  * lock attributes themselves (acquiring `self._lock` is not an access
    to guarded state).

lock-order — methods that nest two `with self.<lock>` acquisitions
define an order edge (outer -> inner) for the class; two methods with
contradictory edges (A->B somewhere, B->A elsewhere) can deadlock under
the right interleaving. Both sites are flagged.
"""

from __future__ import annotations

import ast
import re

from hstream_tpu_torch.tools.analyze import Finding
from hstream_tpu_torch.tools.analyze.passes import class_methods, dotted, walk_classes

NAME = "locks"

RULES = {
    "lock-guard": (
        "attribute written under `with self.<lock>` and locked under "
        "that same lock in >=2 methods is guarded by it; accessing it "
        "without holding a guarding lock (even under another lock) "
        "races the locked writers"),
    "lock-order": (
        "two methods of one class acquire the same two locks in "
        "opposite nesting order — a deadlock under the right "
        "interleaving"),
}

# attribute names that look like locks: threading.Lock/RLock/Condition
# holders by convention (self._lock, self.lock, self._cond, ...)
_LOCKISH = re.compile(r"(^|_)(lock|cond|cv|mutex|mutate)$|_lock$|_cv$")

_HELD_DOC = re.compile(r"caller holds|holding (self|the) lock|"
                       r"lock (is )?held", re.I)


def _lock_attrs(cls: ast.ClassDef) -> set[str]:
    """Attributes of `cls` that are used as locks (appear as `with
    self.X:` anywhere) or are assigned a Lock/RLock/Condition in any
    method."""
    by_name: set[str] = set()
    by_type: set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.With):
            for item in node.items:
                d = dotted(item.context_expr)
                if d and d.startswith("self.") and d.count(".") == 1:
                    by_name.add(d.split(".", 1)[1])
        elif isinstance(node, ast.Assign):
            v = node.value
            if isinstance(v, ast.Call):
                cn = dotted(v.func) or ""
                leaf = cn.split(".")[-1]
                # locktrace factories: named traced locks
                # are locks for every inference purpose
                if leaf in ("Lock", "RLock", "Condition", "Semaphore",
                            "BoundedSemaphore", "TracedLock") or \
                        cn in ("locktrace.lock", "locktrace.rlock",
                               "locktrace.lock_list"):
                    for tgt in node.targets:
                        d = dotted(tgt)
                        if d and d.startswith("self."):
                            by_type.add(d.split(".", 1)[1])
    # a `with self.X:` target is a lock iff it LOOKS like one (the name
    # check keeps accidental context managers out); an attribute
    # assigned a Lock/Condition is one regardless of name
    return {a for a in by_name if _LOCKISH.search(a)} | by_type


def _runs_locked(fn: ast.FunctionDef) -> bool:
    """Method documented to run under the caller's lock."""
    if fn.name.endswith("_locked"):
        return True
    doc = ast.get_docstring(fn) or ""
    return bool(_HELD_DOC.search(doc))


class _MethodScan(ast.NodeVisitor):
    """Classify every `self.X` access in one method as locked (inside a
    `with self.<lock>:` block) or not. Nested function defs are skipped
    — they run on other threads/contexts with their own discipline."""

    def __init__(self, lock_attrs: set[str], fn: ast.FunctionDef):
        self.lock_attrs = lock_attrs
        # (attr, line, is_write, held locks at the access)
        self.accesses: list[tuple[str, int, bool, frozenset[str]]] = []
        self.with_stack: list[list[str]] = []  # lock names per With
        self.order_edges: list[tuple[str, str, int]] = []
        self._fn = fn
        for stmt in fn.body:
            self.visit(stmt)

    def visit_FunctionDef(self, node):  # noqa: N802 — skip nested defs
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def visit_With(self, node: ast.With):  # noqa: N802
        held = []
        for item in node.items:
            d = dotted(item.context_expr)
            if d and d.startswith("self.") and d.count(".") == 1:
                attr = d.split(".", 1)[1]
                if attr in self.lock_attrs:
                    held.append(attr)
                    for outer in [a for frame in self.with_stack
                                  for a in frame]:
                        if outer != attr:
                            self.order_edges.append(
                                (outer, attr, node.lineno))
        for item in node.items:
            self.visit(item.context_expr)
            if item.optional_vars:
                self.visit(item.optional_vars)
        self.with_stack.append(held)
        for stmt in node.body:
            self.visit(stmt)
        self.with_stack.pop()

    def visit_Attribute(self, node: ast.Attribute):  # noqa: N802
        if (isinstance(node.value, ast.Name) and node.value.id == "self"
                and node.attr not in self.lock_attrs):
            is_write = isinstance(node.ctx, (ast.Store, ast.Del))
            held = frozenset(a for frame in self.with_stack
                             for a in frame)
            self.accesses.append(
                (node.attr, node.lineno, is_write, held))
        self.generic_visit(node)


def infer_guards(cls: ast.ClassDef
                 ) -> tuple[set[str], dict[str, set[str]], dict]:
    """(lock attrs, attr -> guarding locks, method scans) for one
    class — the per-class ownership inference, shared with the
    atomicity pass."""
    lock_attrs = _lock_attrs(cls)
    if not lock_attrs:
        return set(), {}, {}
    methods = list(class_methods(cls))
    scans = {m.name: (_MethodScan(lock_attrs, m), m) for m in methods}

    # inference is PER LOCK: the guarding lock of an attribute is the
    # one it is written under and accessed under in >= 2 methods — an
    # access holding only some OTHER lock still races the real guard.
    # A "caller holds the lock" method can't name which lock: its
    # accesses credit every lock of the class.
    locked_in: dict[tuple[str, str], set[str]] = {}  # (attr,lock)->methods
    written_under: dict[str, set[str]] = {}          # attr -> locks
    for name, (scan, fn) in scans.items():
        under_all = frozenset(lock_attrs) if _runs_locked(fn) else None
        for attr, _line, is_write, held in scan.accesses:
            for lock in (under_all or held):
                locked_in.setdefault((attr, lock), set()).add(name)
                if is_write:
                    written_under.setdefault(attr, set()).add(lock)
    guards: dict[str, set[str]] = {}  # attr -> inferred guarding locks
    for (attr, lock), ms in locked_in.items():
        if len(ms) >= 2 and lock in written_under.get(attr, ()):
            guards.setdefault(attr, set()).add(lock)
    return lock_attrs, guards, scans


def _scan_class(src, cls: ast.ClassDef) -> list[Finding]:
    lock_attrs, guards, scans = infer_guards(cls)
    if not lock_attrs:
        return []

    out: list[Finding] = []
    for name, (scan, fn) in scans.items():
        if name == "__init__" or _runs_locked(fn):
            continue
        for attr, line, is_write, held in scan.accesses:
            locks_for = guards.get(attr)
            if locks_for and not (held & locks_for):
                kind = "write to" if is_write else "read of"
                wrong = (f" while holding only {sorted(held)}"
                         if held else "")
                out.append(Finding(
                    "lock-guard", src.rel, line,
                    f"{cls.name}.{name}: unguarded {kind} '{attr}'"
                    f"{wrong} (guarded by {sorted(locks_for)})"))

    # lock-order: contradictory edges across the class
    edges: dict[tuple[str, str], int] = {}
    for name, (scan, _fn) in scans.items():
        for a, b, line in scan.order_edges:
            edges.setdefault((a, b), line)
    # both sites are flagged with their own line; the MESSAGE (a
    # baseline key) stays line-free so drift cannot resurrect it
    for (a, b), line in sorted(edges.items()):
        if (b, a) in edges and a < b:
            out.append(Finding(
                "lock-order", src.rel, line,
                f"{cls.name}: locks '{a}' and '{b}' are acquired in "
                f"both orders"))
            out.append(Finding(
                "lock-order", src.rel, edges[(b, a)],
                f"{cls.name}: locks '{b}' and '{a}' are acquired in "
                f"both orders"))
    return out


def run(files, repo) -> list[Finding]:
    out: list[Finding] = []
    for src in files:
        for cls in walk_classes(src.tree):
            out.extend(_scan_class(src, cls))
    return out
