"""Whole-program lock-order pass.

The per-class `lock-order` rule catches a contradictory nesting only
when BOTH acquisitions sit in one class. The deadlocks that matter in
this tree span objects: the task holds `state_lock` and calls into the
supervisor (whose `_lock` guards the pending table), while some other
path takes the supervisor's lock first and reaches back into the task.
Neither class sees anything wrong alone — the cycle only exists in the
whole-program lock-acquisition graph. That graph is exactly what
GoodLock/lockdep maintain at runtime; this pass constructs it
statically, the RacerD way (compositional per-function summaries, then
a global check):

  nodes  lock classes — `ClassName.attr` for `self.<attr>` locks
         (condition variables collapse onto the lock they wrap, lock
         LISTS get one family node), `module:NAME` for module globals;
  edges  A -> B when some function acquires B while holding A, either
         by `with` nesting in one body or because a call made under A
         reaches a function whose transitive acquire summary contains
         B (call resolution through constructor-typed attributes, the
         unique program-wide attribute owner, and the `ctx` lexicon —
         see passes/conc.py).

`lockorder-cycle` flags every edge of a cycle with the full witness
ring in the message. A deliberate ordering gets a waiver on ANY edge
of the cycle (a reviewed rationale on one edge breaks the ring — the
pass suppresses the whole cycle, so the other edges don't nag).

Same-node edges are skipped (re-entrant RLocks and instance-to-
instance nesting of one lock class need runtime identity — the
locktrace witness owns that half).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass

from hstream_tpu_torch.tools.analyze import Finding
from hstream_tpu_torch.tools.analyze.passes import conc

NAME = "lockorder"

RULES = {
    "lockorder-cycle": (
        "the whole-program lock-acquisition graph (with-nesting plus "
        "cross-class call edges) contains a cycle — a potential "
        "deadlock under the right interleaving; every edge of the "
        "cycle is flagged with the witness ring"),
}


@dataclass
class _Edge:
    src: str
    dst: str
    rel: str      # witness file
    line: int     # witness line
    where: str    # "Class.method" / "module.fn"
    how: str      # human description of the acquisition


class _FnWalk(ast.NodeVisitor):
    """Collect order edges from one function: nested `with` blocks and
    calls made while holding (callee summaries supply the inner
    locks). Nested defs are skipped — they run on other threads."""

    def __init__(self, src, fn, cls, prog):
        self.src = src
        self.fn = fn
        self.cls = cls
        self.prog = prog
        self.local_types = conc.fn_local_types(fn, cls, prog)
        self.held: list[str] = []
        self.edges: list[_Edge] = []
        self.where = (f"{cls.name}.{fn.name}" if cls is not None
                      else fn.name)
        for stmt in fn.body:
            self.visit(stmt)

    def visit_FunctionDef(self, node):  # noqa: N802 — own thread/scope
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def _emit(self, dst: str, line: int, how: str) -> None:
        for held in self.held:
            if held != dst:
                self.edges.append(_Edge(
                    held, dst, self.src.rel, line, self.where, how))

    def visit_With(self, node: ast.With):  # noqa: N802
        taken: list[str] = []
        for item in node.items:
            self.visit(item.context_expr)
            n = conc.with_lock_node(item.context_expr, self.cls,
                                    self.src.rel, self.prog,
                                    self.local_types)
            if n is not None:
                self._emit(n, node.lineno, f"with-nested acquire of "
                                           f"'{n}'")
                self.held.append(n)
                taken.append(n)
        for stmt in node.body:
            self.visit(stmt)
        for _ in taken:
            self.held.pop()

    def visit_Call(self, node: ast.Call):  # noqa: N802
        if self.held:
            tgt = conc.resolve_call(node, self.cls, self.src.rel,
                                    self.prog, self.local_types)
            if tgt is not None and id(tgt) != id(self.fn):
                inner = self.prog.acquires.get(id(tgt), set())
                name = (ast.unparse(node.func)
                        if hasattr(ast, "unparse") else "<call>")
                for dst in sorted(inner):
                    self._emit(dst, node.lineno,
                               f"call {name}() acquires '{dst}'")
        self.generic_visit(node)


def _collect_edges(files, prog) -> dict[tuple[str, str], _Edge]:
    edges: dict[tuple[str, str], _Edge] = {}
    for src in files:
        jobs: list[tuple[ast.FunctionDef, object]] = []
        for info in prog.classes:
            if info.rel != src.rel:
                continue
            jobs.extend((m, info) for m in info.methods.values())
        jobs.extend((f, None)
                    for f in prog.module_funcs.get(src.rel, {}).values())
        for fn, cls in jobs:
            for e in _FnWalk(src, fn, cls, prog).edges:
                # first witness wins; sorted job order keeps it stable
                edges.setdefault((e.src, e.dst), e)
    return edges


def _cycles(edges: dict[tuple[str, str], _Edge]
            ) -> list[list[_Edge]]:
    """Minimal witness cycles: for each edge a->b with a path b->..->a,
    the ring [a->b, b->.., ..->a] found by BFS. Each cycle is reported
    once, keyed by its node set."""
    adj: dict[str, list[str]] = {}
    for (a, b) in edges:
        adj.setdefault(a, []).append(b)
    for outs in adj.values():
        outs.sort()
    seen_rings: set[frozenset[str]] = set()
    out: list[list[_Edge]] = []
    for (a, b) in sorted(edges):
        # BFS from b back to a
        prev: dict[str, str] = {b: ""}
        queue = [b]
        while queue:
            cur = queue.pop(0)
            if cur == a:
                break
            for nxt in adj.get(cur, ()):
                if nxt not in prev:
                    prev[nxt] = cur
                    queue.append(nxt)
        if a not in prev:
            continue
        # prev chains a <- ... <- b; rebuild the b -> .. -> a path
        chain = [a]
        cur = a
        while cur != b:
            cur = prev[cur]
            chain.append(cur)
        chain.reverse()          # b, ..., a
        ring = [(a, b)] + [(chain[i], chain[i + 1])
                           for i in range(len(chain) - 1)]
        key = frozenset(n for pair in ring for n in pair)
        if key in seen_rings:
            continue
        seen_rings.add(key)
        out.append([edges[p] for p in ring])
    return out


def run(files, repo) -> list[Finding]:
    prog = conc.build_program(files)
    edges = _collect_edges(files, prog)
    by_rel = {f.rel: f for f in files}
    out: list[Finding] = []
    for ring in _cycles(edges):
        # a waiver on ANY edge of the cycle is a reviewed rationale
        # that breaks the ring: suppress the whole cycle
        if any(by_rel[e.rel].waived(e.line, "lockorder-cycle")
               for e in ring if e.rel in by_rel):
            continue
        ring_str = " -> ".join([e.src for e in ring] + [ring[0].src])
        for e in ring:
            out.append(Finding(
                "lockorder-cycle", e.rel, e.line,
                f"lock-order cycle {ring_str}; this edge: "
                f"{e.where} {e.how} while holding '{e.src}'"))
    return out
