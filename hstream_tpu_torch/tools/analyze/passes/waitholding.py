"""Waiting-while-holding pass.

A thread that blocks on an EVENT — a worker joining, a future
resolving, a queue draining — while holding an unrelated mutex couples
the lock's critical section to another thread's progress. If that
other thread ever needs the held lock (directly, or transitively), the
system deadlocks; even when it doesn't, every contender stalls for the
full wait. This is the shape of the gateway-rebind and append-front
close hazards that review rounds fixed one at a time — the pass
makes the discipline structural.

`wait-holding` flags, inside any `with <lock>:` region (self-attr
locks, lock-list members, module-global locks — recognition shared
with the lockorder pass via conc.py):

  * `X.join()` where X is thread-like (assigned `threading.Thread`,
    or named like one — thread/worker/dispatcher/sender);
  * `X.result()` where X is future-like (fut/future names, or a var
    assigned from `.submit(...)`);
  * `X.wait()` where X is NOT the held lock itself and not a
    condition constructed over a held lock (`Condition(self._lock)`
    waited under `self._lock` RELEASES it — that is the condition
    idiom, never flagged);
  * blocking `X.get(...)`/`X.put(...)` on queue-typed attributes or
    queue-ish names (`*_nowait` variants are non-blocking and exempt).

A bounded timeout does NOT exempt the call — contenders still stall
for the bound, and a bound that papers over a deadlock is exactly the
failure mode the chaos scenarios provoke. Deliberate bounded waits
carry `# analyze: ok wait-holding` with a rationale.
"""

from __future__ import annotations

import ast
import re

from hstream_tpu_torch.tools.analyze import Finding
from hstream_tpu_torch.tools.analyze.passes import call_name, dotted
from hstream_tpu_torch.tools.analyze.passes import conc

NAME = "waitholding"

RULES = {
    "wait-holding": (
        "a join/result/wait/queue-get/put executes while holding a "
        "lock the waited-on work does not own — the critical section "
        "is coupled to another thread's progress (deadlock if that "
        "thread ever needs the held lock; a stall for everyone "
        "otherwise)"),
}

_THREADISH = re.compile(
    r"(^|_)(thread|threads|worker|workers|dispatcher|sender|t)$")
_FUTUREISH = re.compile(r"(^|_)(fut|futs|future|futures|f)$")
_QUEUEISH = re.compile(r"(^|_)(queue|queues|q|inbox|outbox)$|_q$")


def _attr_of_self(expr: ast.AST) -> str | None:
    if (isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"):
        return expr.attr
    return None


def _submit_locals(fn: ast.FunctionDef) -> set[str]:
    """Locals assigned from `.submit(...)` / `Future()` — futures."""
    out: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Call):
            leaf = (call_name(node.value) or "").split(".")[-1]
            if leaf in ("submit", "Future"):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
    return out


class _FnWalk(ast.NodeVisitor):
    def __init__(self, src, fn, cls, prog):
        self.src = src
        self.fn = fn
        self.cls = cls
        self.prog = prog
        self.local_types = conc.fn_local_types(fn, cls, prog)
        self.future_locals = _submit_locals(fn)
        self.held: list[str] = []          # lock nodes
        self.held_attrs: list[str] = []    # raw self-attr names held
        self.findings: list[Finding] = []
        self.where = (f"{cls.name}.{fn.name}" if cls is not None
                      else fn.name)
        for stmt in fn.body:
            self.visit(stmt)

    def visit_FunctionDef(self, node):  # noqa: N802 — own thread/scope
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def visit_With(self, node: ast.With):  # noqa: N802
        taken = 0
        for item in node.items:
            self.visit(item.context_expr)
            n = conc.with_lock_node(item.context_expr, self.cls,
                                    self.src.rel, self.prog,
                                    self.local_types)
            if n is not None:
                self.held.append(n)
                attr = _attr_of_self(item.context_expr)
                self.held_attrs.append(attr or "")
                taken += 1
        for stmt in node.body:
            self.visit(stmt)
        for _ in range(taken):
            self.held.pop()
            self.held_attrs.pop()

    # ---- call classification ----

    def _target_is_held(self, base: ast.AST) -> bool:
        """The wait target IS (or wraps) a held lock: `cv.wait()` under
        `with cv:`, or a Condition aliased onto a held lock."""
        attr = _attr_of_self(base)
        if attr is not None and self.cls is not None:
            node = self.cls.lock_node(attr)
            if node in self.held:
                return True
            alias = self.cls.cond_alias.get(attr, attr)
            if any(self.cls.cond_alias.get(h, h) == alias
                   for h in self.held_attrs if h):
                return True
            return False
        d = dotted(base)
        if d and "." not in d:
            mod = f"{conc._module_stem(self.src.rel)}:{d}"
            return mod in self.held
        return False

    def _queueish(self, base: ast.AST) -> bool:
        attr = _attr_of_self(base)
        if attr is not None and self.cls is not None and \
                attr in self.cls.queue_attrs:
            return True
        name = attr
        if name is None:
            d = dotted(base)
            name = d.split(".")[-1] if d else None
        if name is None and isinstance(base, ast.Subscript):
            inner = dotted(base.value)
            name = inner.split(".")[-1] if inner else None
        if name is None:
            return False
        if self.local_types.get(name) in ("Queue", "SimpleQueue",
                                          "LifoQueue", "PriorityQueue"):
            return True
        return bool(_QUEUEISH.search(name))

    def _threadish(self, base: ast.AST) -> bool:
        attr = _attr_of_self(base)
        if attr is not None and self.cls is not None and \
                attr in self.cls.thread_attrs:
            return True
        name = attr or (dotted(base) or "").split(".")[-1]
        if not name:
            return False
        if self.local_types.get(name) in ("Thread", "Timer"):
            return True
        return bool(_THREADISH.search(name))

    def _futureish(self, base: ast.AST) -> bool:
        name = _attr_of_self(base) or (dotted(base) or "").split(".")[-1]
        if not name:
            return False
        if name in self.future_locals:
            return True
        return bool(_FUTUREISH.search(name))

    def visit_Call(self, node: ast.Call):  # noqa: N802
        if self.held and isinstance(node.func, ast.Attribute):
            leaf = node.func.attr
            base = node.func.value
            hit = None
            if leaf == "join" and self._threadish(base):
                hit = "join() on a worker thread"
            elif leaf == "result" and self._futureish(base):
                hit = "result() on a future"
            elif leaf == "wait" and not self._target_is_held(base):
                # waiting on the held condition releases it — the
                # condition idiom; anything else blocks while holding
                hit = "wait() on an unrelated event/condition"
            elif leaf in ("get", "put") and self._queueish(base):
                hit = f"blocking {leaf}() on a queue"
            if hit is not None:
                self.findings.append(Finding(
                    "wait-holding", self.src.rel, node.lineno,
                    f"{self.where}: {hit} while holding "
                    f"{sorted(set(self.held))} — the critical section "
                    f"blocks on another thread's progress"))
        self.generic_visit(node)


def run(files, repo) -> list[Finding]:
    prog = conc.build_program(files)
    out: list[Finding] = []
    for src in files:
        jobs = []
        for info in prog.classes:
            if info.rel != src.rel:
                continue
            jobs.extend((m, info) for m in info.methods.values())
        jobs.extend((f, None)
                    for f in prog.module_funcs.get(src.rel, {}).values())
        for fn, cls in jobs:
            out.extend(_FnWalk(src, fn, cls, prog).findings)
    return out
