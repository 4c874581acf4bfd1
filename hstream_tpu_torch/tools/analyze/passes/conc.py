"""Shared whole-program concurrency model.

The per-class lock inference of the `locks` pass cannot see the bug
classes that killed availability in the chaos scenarios: lock-order
cycles that span OBJECTS (task holds its state lock and calls into the
supervisor, whose lock some other path takes first), check-then-act
races where a guarded read's decision outlives the critical section,
and waiting-while-holding. All three need one thing the per-class
passes don't build: a program-wide index of who owns which locks and
which callee a dotted call lands in.

This module builds that index once per analyzer run:

  * every class's lock attributes (same recognition as the locks pass:
    `with self.X:` on lock-ish names, or attrs assigned
    Lock/RLock/Condition/Semaphore — plus LISTS of locks, the
    append-front lane-lock shape, recognized by construction);
  * condition aliases: `self.C = threading.Condition(self.L)` means
    acquiring C IS acquiring L — the graph must not split one mutex
    into two nodes;
  * attribute/variable types from constructor calls
    (`self.front = AppendFront(...)`) so `self.front.submit()` resolves
    to a FunctionDef; a one-entry name lexicon types the repo's
    pervasive `ctx` convention (ServerContext), and an attribute whose
    type no constructor names falls back to the unique program-wide
    owner of that attribute name;
  * module-level locks (`_lock = threading.Lock()` globals);
  * per-function transitive lock-acquisition summaries (fixpoint over
    the resolvable call graph) — the callee-closure idea of the
    shardmap/overflow passes, lifted from one module to the program.

Lock node identity is the CLASS-scoped name (`QueryTask.state_lock`,
`jsondec:_lock` for module globals): all instances of a class share a
node, the lockdep "lock class" discipline — an order inversion between
two instances of the same class is real, but modeling it needs
instance identity no static pass has, so same-node edges are skipped.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field

from hstream_tpu_torch.tools.analyze.passes import call_name, dotted

# attribute names that look like locks (the locks pass's convention)
LOCKISH = re.compile(r"(^|_)(lock|cond|cv|mutex|mutate)$|_lock$|_cv$")

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore", "TracedLock"}
# named-lock factories from common/locktrace (lowercase, so outside
# the CamelCase constructor convention): full dotted names
_LOCK_FACTORIES = {"locktrace.lock", "locktrace.rlock"}
_LOCK_LIST_FACTORIES = {"locktrace.lock_list"}
_QUEUE_CTORS = {"Queue", "SimpleQueue", "LifoQueue", "PriorityQueue"}
_THREAD_CTORS = {"Thread", "Timer"}

# the repo's pervasive parameter/attribute naming conventions, used as
# a typing fallback exactly like the dispatch pass's device-name
# lexicon: `ctx` is always the ServerContext
NAME_TYPE_LEXICON = {"ctx": "ServerContext"}


def _ctor_leaf(value: ast.AST) -> str | None:
    """'AppendFront' for `AppendFront(...)` / `mod.AppendFront(...)`;
    None for anything that is not a plain constructor-looking call."""
    if not isinstance(value, ast.Call):
        return None
    name = call_name(value)
    if not name:
        return None
    leaf = name.split(".")[-1]
    # constructors are CamelCase by convention; a lowercase call is a
    # factory whose return type we cannot name
    return leaf if leaf[:1].isupper() else None


def _is_lock_ctor(value: ast.AST) -> bool:
    if not isinstance(value, ast.Call):
        return False
    name = call_name(value) or ""
    return name.split(".")[-1] in _LOCK_CTORS \
        or name in _LOCK_FACTORIES


def _is_lock_list(value: ast.AST) -> bool:
    """`[threading.Lock() for ...]` / `[Lock(), Lock()]` /
    `locktrace.lock_list(...)` — a lock FAMILY (the append-front
    lane-lock shape)."""
    if isinstance(value, ast.Call) and \
            (call_name(value) or "") in _LOCK_LIST_FACTORIES:
        return True
    elts: list[ast.AST] = []
    if isinstance(value, ast.ListComp):
        elts = [value.elt]
    elif isinstance(value, (ast.List, ast.Tuple)):
        elts = list(value.elts)
    return bool(elts) and all(_is_lock_ctor(e) for e in elts)


@dataclass
class ClassInfo:
    name: str
    rel: str                      # module file, repo-relative
    node: ast.ClassDef = None     # type: ignore[assignment]
    methods: dict[str, ast.FunctionDef] = field(default_factory=dict)
    lock_attrs: set[str] = field(default_factory=set)
    lock_list_attrs: set[str] = field(default_factory=set)
    cond_alias: dict[str, str] = field(default_factory=dict)
    attr_types: dict[str, str] = field(default_factory=dict)
    queue_attrs: set[str] = field(default_factory=set)
    thread_attrs: set[str] = field(default_factory=set)

    def lock_node(self, attr: str) -> str:
        """Graph node for `self.<attr>` (condition aliases collapse
        onto the lock they wrap; lock lists get a `[]` family node)."""
        attr = self.cond_alias.get(attr, attr)
        if attr in self.lock_list_attrs:
            return f"{self.name}.{attr}[]"
        return f"{self.name}.{attr}"


@dataclass
class Program:
    classes: list[ClassInfo] = field(default_factory=list)
    by_name: dict[str, list[ClassInfo]] = field(default_factory=dict)
    module_funcs: dict[str, dict[str, ast.FunctionDef]] = \
        field(default_factory=dict)
    module_locks: dict[str, set[str]] = field(default_factory=dict)
    # (id of FunctionDef) -> transitive set of lock nodes it acquires
    acquires: dict[int, set[str]] = field(default_factory=dict)
    # (id of FunctionDef) -> owning ClassInfo / module rel
    fn_class: dict[int, ClassInfo | None] = field(default_factory=dict)
    fn_module: dict[int, str] = field(default_factory=dict)
    # attr name -> ctor types assigned to it ANYWHERE in the program
    # (self.X = Ctor(...) in classes, plus cross-object `obj.X = t`
    # where t's constructor is known — handlers wiring `mat.task =
    # task` is what types views' `task` attribute)
    global_attr_types: dict[str, set[str]] = field(default_factory=dict)

    def class_named(self, name: str) -> ClassInfo | None:
        cands = self.by_name.get(name, [])
        return cands[0] if len(cands) == 1 else None

    def attr_type(self, cls: ClassInfo | None, attr: str) -> str | None:
        """Type of `.attr` on an instance of `cls` — the class's own
        constructor assignment first, then the unique program-wide
        owner of that attribute name (so `ctx.supervisor` types even
        when `ctx` reached us untyped)."""
        if cls is not None:
            t = cls.attr_types.get(attr)
            if t is not None:
                return t
        types = self.global_attr_types.get(attr, set())
        return next(iter(types)) if len(types) == 1 else None


def _module_stem(rel: str) -> str:
    return os.path.basename(rel).rsplit(".", 1)[0]


def _scan_class(cls: ast.ClassDef, rel: str) -> ClassInfo:
    info = ClassInfo(name=cls.name, rel=rel, node=cls)
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            info.methods[node.name] = node
    for node in ast.walk(cls):
        if isinstance(node, ast.With):
            for item in node.items:
                d = dotted(item.context_expr)
                if d and d.startswith("self.") and d.count(".") == 1:
                    attr = d.split(".", 1)[1]
                    if LOCKISH.search(attr):
                        info.lock_attrs.add(attr)
        elif isinstance(node, ast.Assign):
            v = node.value
            leaf = _ctor_leaf(v)
            for tgt in node.targets:
                d = dotted(tgt)
                if not (d and d.startswith("self.")
                        and d.count(".") == 1):
                    continue
                attr = d.split(".", 1)[1]
                if _is_lock_ctor(v):
                    info.lock_attrs.add(attr)
                    if leaf == "Condition" and v.args:
                        wrapped = dotted(v.args[0])
                        if wrapped and wrapped.startswith("self."):
                            info.cond_alias[attr] = \
                                wrapped.split(".", 1)[1]
                elif leaf in _QUEUE_CTORS:
                    info.queue_attrs.add(attr)
                elif leaf in _THREAD_CTORS:
                    info.thread_attrs.add(attr)
                elif leaf is not None:
                    info.attr_types[attr] = leaf
                if _is_lock_list(v):
                    info.lock_attrs.add(attr)
                    info.lock_list_attrs.add(attr)
    return info


def _scan_module_locks(tree: ast.Module) -> set[str]:
    out: set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign):
            if _is_lock_ctor(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
    return out


# one-entry memo: lockorder and waitholding both build the model for
# the same file list in one analyzer run, and the fixpoint acquire
# summaries are the expensive half of either pass. Keyed on the file
# OBJECT identities; the cached entry holds strong references to
# those objects, so their ids cannot be recycled while the key is
# comparable (a different list of different SourceFiles misses).
_memo: dict = {"key": None, "files": None, "prog": None}


def build_program(files) -> Program:
    key = tuple(id(f) for f in files)
    if _memo["key"] == key:
        return _memo["prog"]
    prog = _build_program(files)
    _memo.update(key=key, files=list(files), prog=prog)
    return prog


def _build_program(files) -> Program:
    prog = Program()
    for src in files:
        prog.module_locks[src.rel] = _scan_module_locks(src.tree)
        funcs: dict[str, ast.FunctionDef] = {}
        for node in src.tree.body:
            if isinstance(node, ast.FunctionDef):
                funcs[node.name] = node
                prog.fn_class[id(node)] = None
                prog.fn_module[id(node)] = src.rel
        prog.module_funcs[src.rel] = funcs
        for node in ast.walk(src.tree):
            if isinstance(node, ast.ClassDef):
                info = _scan_class(node, src.rel)
                prog.classes.append(info)
                prog.by_name.setdefault(node.name, []).append(info)
                for m in info.methods.values():
                    prog.fn_class[id(m)] = info
                    prog.fn_module[id(m)] = src.rel
    for info in prog.classes:
        for attr, t in info.attr_types.items():
            prog.global_attr_types.setdefault(attr, set()).add(t)
    # cross-object wiring: `obj.attr = t` where t was constructed in
    # the same function (`task = QueryTask(...); mat.task = task`)
    for src in files:
        for fn in ast.walk(src.tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            ctor_locals = local_ctor_types(fn)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Assign):
                    continue
                vtype = _ctor_leaf(node.value)
                if vtype is None and isinstance(node.value, ast.Name):
                    vtype = ctor_locals.get(node.value.id)
                if vtype is None:
                    continue
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and \
                            not (isinstance(t.value, ast.Name)
                                 and t.value.id == "self"):
                        prog.global_attr_types.setdefault(
                            t.attr, set()).add(vtype)
    _compute_acquires(prog)
    return prog


# ---- lock nodes held/acquired in one function -------------------------------


def chain_class(tokens: list[str], cls: ClassInfo | None,
                prog: Program,
                local_types: dict[str, str] | None) -> ClassInfo | None:
    """ClassInfo an attribute chain lands on (`self.a.b` -> type of b;
    `task` -> local/lexicon type), or None when a hop breaks."""
    if not tokens:
        return None
    head = tokens[0]
    if head == "self":
        cur = cls
    else:
        tname = (local_types or {}).get(head) \
            or NAME_TYPE_LEXICON.get(head)
        cur = prog.class_named(tname) if tname else None
        if cur is None and len(tokens) == 1:
            return None
    for tok in tokens[1:]:
        if cur is None and tok in NAME_TYPE_LEXICON:
            cur = prog.class_named(NAME_TYPE_LEXICON[tok])
            continue
        tname = prog.attr_type(cur, tok)
        cur = prog.class_named(tname) if tname else None
        if cur is None:
            return None
    return cur


def with_lock_node(item_expr: ast.AST, cls: ClassInfo | None,
                   module_rel: str, prog: Program,
                   local_types: dict[str, str] | None = None
                   ) -> str | None:
    """Graph node for one `with <expr>:` item, or None when the
    context manager is not a recognized lock. Resolves `self.X`,
    module globals, lock-family members (`self._lane_locks[i]`), and
    typed chains (`task.state_lock` where `task` types to a class
    owning that lock)."""
    d = dotted(item_expr)
    if d:
        parts = d.split(".")
        if parts[0] == "self" and len(parts) == 2 and cls is not None:
            attr = parts[1]
            if attr in cls.lock_attrs:
                return cls.lock_node(attr)
            return None
        if len(parts) == 1 and \
                d in prog.module_locks.get(module_rel, ()):
            return f"{_module_stem(module_rel)}:{d}"
        if len(parts) >= 2:
            owner = chain_class(parts[:-1], cls, prog, local_types)
            if owner is not None and parts[-1] in owner.lock_attrs:
                return owner.lock_node(parts[-1])
        return None
    # `with self._lane_locks[i]:` — a member of a lock family
    if isinstance(item_expr, ast.Subscript):
        base = dotted(item_expr.value)
        if base and base.startswith("self.") and base.count(".") == 1 \
                and cls is not None:
            attr = base.split(".", 1)[1]
            if attr in cls.lock_list_attrs:
                return cls.lock_node(attr)
    return None


def direct_acquires(fn: ast.FunctionDef, cls: ClassInfo | None,
                    module_rel: str, prog: Program,
                    local_types: dict[str, str] | None = None
                    ) -> set[str]:
    out: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.With):
            for item in node.items:
                n = with_lock_node(item.context_expr, cls, module_rel,
                                   prog, local_types)
                if n is not None:
                    out.add(n)
    return out


# ---- call resolution --------------------------------------------------------


def local_ctor_types(fn: ast.FunctionDef) -> dict[str, str]:
    """Local variables assigned from constructor calls inside `fn`."""
    out: dict[str, str] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            leaf = _ctor_leaf(node.value)
            if leaf is not None:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = leaf
    return out


def fn_local_types(fn: ast.FunctionDef, cls: ClassInfo | None,
                   prog: Program) -> dict[str, str]:
    """Constructor-typed locals plus attribute-chain snapshots
    (`task = self.task` types the local from the attribute)."""
    out = local_ctor_types(fn)
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, (ast.Attribute, ast.Name)):
            d = dotted(node.value)
            if not d:
                continue
            parts = d.split(".")
            tname: str | None = None
            if len(parts) == 1:
                tname = NAME_TYPE_LEXICON.get(parts[0])
            else:
                owner = chain_class(parts[:-1], cls, prog, out)
                # attr_type falls back to the unique program-wide
                # owner even when the chain itself stayed untyped
                tname = prog.attr_type(owner, parts[-1])
            if tname is not None:
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id not in out:
                        out[t.id] = tname
    return out


def resolve_call(call: ast.Call, cls: ClassInfo | None,
                 module_rel: str, prog: Program,
                 local_types: dict[str, str]) -> ast.FunctionDef | None:
    """FunctionDef a dotted/bare call lands in, or None when the chain
    cannot be typed. Resolution is deliberately conservative: a broken
    hop gives up rather than guessing."""
    name = call_name(call)
    if not name:
        return None
    parts = name.split(".")
    method = parts[-1]
    chain = parts[:-1]
    if not chain:
        # bare call: module-level function in the same module
        return prog.module_funcs.get(module_rel, {}).get(method)
    cur = chain_class(chain, cls, prog, local_types)
    if cur is None:
        return None
    return cur.methods.get(method)


def _compute_acquires(prog: Program) -> None:
    """Fixpoint: transitive lock nodes each function acquires through
    `with` blocks plus every resolvable callee."""
    fns: list[tuple[ast.FunctionDef, ClassInfo | None, str]] = []
    for info in prog.classes:
        for m in info.methods.values():
            fns.append((m, info, info.rel))
    for rel, funcs in prog.module_funcs.items():
        for f in funcs.values():
            fns.append((f, None, rel))
    types_of: dict[int, dict[str, str]] = {
        id(fn): fn_local_types(fn, cls, prog) for fn, cls, _rel in fns}
    for fn, cls, rel in fns:
        prog.acquires[id(fn)] = direct_acquires(
            fn, cls, rel, prog, types_of[id(fn)])
    # resolve call targets once
    calls: dict[int, set[int]] = {}
    for fn, cls, rel in fns:
        local_types = types_of[id(fn)]
        targets: set[int] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                tgt = resolve_call(node, cls, rel, prog, local_types)
                if tgt is not None and id(tgt) != id(fn):
                    targets.add(id(tgt))
        calls[id(fn)] = targets
    changed = True
    while changed:
        changed = False
        for fn, _cls, _rel in fns:
            acc = prog.acquires[id(fn)]
            before = len(acc)
            for tid in calls[id(fn)]:
                acc |= prog.acquires.get(tid, set())
            if len(acc) != before:
                changed = True
