"""Dispatch/fetch budget pass, over the port.

The hot-path invariants — one step launch per batch, and one close
launch plus at most one device->host fetch per close cycle or join
micro-batch — are worth an order of magnitude between kernel-only and
end-to-end throughput, and nothing structural keeps them: one stray
`.cpu()` in a drain or one per-window fetch loop silently reintroduces a
round trip per item. This pass makes the budgets declared and checked.

Contract comments bind a budget to a function, on the line directly
above its `def` (above any decorators) or on the `def` line itself:

    # contract: dispatches<=1 fetches<=1
    def _close_windows(self, starts): ...

`dispatch-budget` then checks the body statically:

  * a recognized dispatch or fetch inside a `for`/`while` loop blows ANY
    finite budget — unless the loop is the sanctioned shape-group
    stacking idiom (iterating a `by_shape` grouping, which fetches once
    per buffer shape, the repo's batched-drain pattern);
  * the static call-site count (branch-aware: `if`/`else` arms take the
    max, early-returning arms split the tail) must fit the budget.

Budgets count a function's own call sites, as the reference's pass
does: a helper that launches or fetches carries a contract of its own
(`_refresh_counts`, `_reprobe_wider`), and a call to it is not counted
again in its caller. The exception is a helper whose contract ends in
`inline`:

    # contract: dispatches<=1 fetches<=0 inline
    def _launch_step(self, ...): ...

Its sites are its callers': each call counts as the helper's budget in
the calling contract (so a second call, or the call in a loop, breaks
the caller's budget), and a call from an unannotated hot-file function
whose budget fetches is a `dispatch-sync`. The port marks so the
helpers it split out of the reference's inline launches and waits
(`_launch_step`, `_device_stage`), so that the reference's budgets on
their callers still bind. Recognised are `self.m(...)` for a method of
the same class and `f(...)` for a function of the same module.

`dispatch-sync` flags device syncs in UNANNOTATED functions of the hot
files (`HOT_PATH_FILES`): every legitimate drain point carries a
contract (which both sanctions and budgets it), so a bare sync is either
a new drain that needs a budget or a hot-path regression.

Recognition over the port (the reference recognised jax idioms):

  dispatches  a call to a kernel wrapper or a device program. The set is
              derived from the package's source, so it cannot rot: a
              kernel wrapper is a module-level function that bumps its
              own launch counter (`f.launches += n`) or checks a launch
              through the kernel binding (`kb.check(...)`,
              engine/kernels/binding.py); a device program is a
              module-level function that calls a wrapper or another
              program (`lattice.step_encoded`, `close_slots`). Calls are
              recognised through a module alias (`sl.session_step(...)`)
              or a name the file imports or defines. Also: names bound
              from kernel factories (`self.X = self._count_close_kernel(
              fns.extract_slot)`), attributes of a `lattice.compiled(...)`
              bundle, and the device methods (derived the same way) of a
              `ShardedLattice` / `ShardedJoinLattice` /
              `ShardedSessionLattice` held in `self.X`, in a local, or in
              a dict under the key the file stores it at (`sjl =
              dev.get("sjl")`).
  fetches     `.cpu()`, `.item()`, `.to("cpu")`, `torch.cuda.synchronize()`,
              an event's or a stream's `.synchronize()`, `.block_until_ready()`;
              `.numpy()` / `.tolist()` of a local assigned from a dispatch
              or a torch allocation on a device; `np.asarray(x)` where x
              is such a local or device-named (packed/buf/words/state/
              dev/stacked...); inside a contract function every bare
              `np.asarray(name)` counts (contract paths are device
              paths). A method chained on a fetch is the same copy
              (`x.cpu().numpy()` counts once), and `np.asarray(x, dtype)`
              is a host-typed conversion, never a fetch.
"""

from __future__ import annotations

import ast
import re

from hstream_tpu_torch.tools.analyze import Finding
from hstream_tpu_torch.tools.analyze.passes import call_name, dotted

NAME = "dispatch"

RULES = {
    "dispatch-budget": (
        "function declaring `# contract: dispatches<=N fetches<=M` "
        "exceeds it statically — a kernel dispatch or device fetch in "
        "an unsanctioned loop, or more call sites than the budget"),
    "dispatch-sync": (
        "device->host sync in an unannotated hot-file function — every "
        "sanctioned drain point declares a `# contract:` budget; a bare "
        "sync is a hot-path regression"),
    "dispatch-contract-syntax": (
        "unparseable `# contract:` comment (`dispatches<=N fetches<=M`, "
        "optionally followed by `inline`) — a typo here silently "
        "un-checks the budget"),
}

PACKAGE = "hstream_tpu_torch/"

# the kernel/executor layer dispatch-sync polices (contract functions
# are budget-checked instead; everything else in the repo is host code
# where .tolist() and np.asarray are routine)
HOT_PATH_FILES = (
    "hstream_tpu_torch/engine/lattice.py",
    "hstream_tpu_torch/engine/executor.py",
    "hstream_tpu_torch/engine/join.py",
    "hstream_tpu_torch/engine/pipeline.py",
    "hstream_tpu_torch/engine/session.py",
    "hstream_tpu_torch/parallel/executor.py",
    "hstream_tpu_torch/parallel/lattice.py",
    # the files that drive the kernels: their wrappers launch, and a
    # sync there would tax every launch
    "hstream_tpu_torch/engine/session_lattice.py",
    "hstream_tpu_torch/engine/join_lattice.py",
    "hstream_tpu_torch/engine/transport.py",
    # the framed append path: host-only by contract — its hot functions
    # declare dispatches<=0 fetches<=0, and any device sync creeping
    # into the ingest door is a regression
    "hstream_tpu_torch/common/colframe.py",
    "hstream_tpu_torch/server/appendfront.py",
    # the traced-lock wrapper sits inside every instrumented drain path:
    # a device sync creeping into acquire/release would tax every
    # critical section in the server
    "hstream_tpu_torch/common/locktrace.py",
    # the device cost plane: HBM accounting runs at scrape time against
    # live executors and the device-time sampler sits inside every
    # kernel_family scope — each hook declares its budget (the
    # sampler's measure is the ONLY sanctioned sync)
    "hstream_tpu_torch/stats/devicecost.py",
    # the read plane: serve_view sits on every pull query — its budget
    # is one extract dispatch + one fetch per cache miss, and a bare
    # sync creeping into the hit path would tax every reader
    "hstream_tpu_torch/server/readcache.py",
)
# the files this pass names (the framework checks the tree holds them)
BINDING_FILE = "hstream_tpu_torch/engine/kernels/binding.py"
PATHS = HOT_PATH_FILES + (BINDING_FILE,)
_BINDING_MODULE = "hstream_tpu_torch.engine.kernels.binding"

# factories whose RESULT is a kernel callable
KERNEL_FACTORIES = {"_count_close_kernel"}
# factories returning a NAMESPACE of kernels: every attribute of a
# `compiled(...)` bundle is a kernel; of a sharded lattice, its device
# methods are
KERNEL_NAMESPACE_FACTORIES = {"compiled", "ShardedLattice",
                              "ShardedJoinLattice",
                              "ShardedSessionLattice"}
_BUNDLE_FACTORIES = {"compiled"}

# device-value lexicon: identifier stems that name device tensors in
# this codebase (packed extract buffers, wire words, lattice state)
_DEVICE_NAME_RE = re.compile(
    r"(^|_)(packed|buf|bufs|words|state|dev|device|stacked)($|_|s$)")

_CONTRACT_RE = re.compile(r"#\s*contract:\s*(.+)$")
_BUDGET_RE = re.compile(r"^(dispatches|fetches)<=(\d+)$")

# loop-iterable source text marking the sanctioned shape-group
# stacking idiom (one fetch per buffer shape)
_SHAPE_GROUP_TOKENS = ("by_shape",)

# methods that copy to the host or wait for the card whatever their
# receiver, and those that do only on a value known to be on the card
_FETCH_METHODS = {"cpu", "item", "synchronize", "block_until_ready"}
_HOST_VIEW_METHODS = {"numpy", "tolist"}


def _parse_contract(text: str) -> dict[str, int] | None:
    """{'dispatches': N, 'fetches': M} (either optional, plus
    'inline': 1 for a trailing `inline`) or None on a syntax error."""
    out: dict[str, int] = {}
    toks = text.split()
    if toks and toks[-1] == "inline":
        toks.pop()
        out["inline"] = 1
    for tok in toks:
        m = _BUDGET_RE.match(tok)
        if not m:
            return None
        out[m.group(1)] = int(m.group(2))
    return out if len(out) > out.get("inline", 0) else None


def _contract_of(src, fn: ast.FunctionDef):
    """(budgets, comment_line) for a contract bound to `fn`, or
    (None, line) on a malformed comment, or (None, None)."""
    def_line = src.lines[fn.lineno - 1] if fn.lineno <= len(src.lines) \
        else ""
    m = _CONTRACT_RE.search(def_line)
    if m is not None:
        return _parse_contract(m.group(1)), fn.lineno
    first = min([fn.lineno] + [d.lineno for d in fn.decorator_list])
    i = first - 1  # 1-based line above
    while i >= 1:
        line = src.lines[i - 1].strip()
        if not line.startswith("#"):
            break
        m = _CONTRACT_RE.search(line)
        if m is not None:
            return _parse_contract(m.group(1)), i
        i -= 1
    return None, None


# ---- the device set, derived from the source -------------------------------


def _module_of(rel: str) -> str:
    """Dotted module path of a repo-relative file."""
    mod = rel[:-3].replace("/", ".")
    return mod[:-len(".__init__")] if mod.endswith(".__init__") else mod


def _binding_aliases(tree: ast.Module) -> set[str]:
    out: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == _BINDING_MODULE and a.asname:
                    out.add(a.asname)
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                if f"{node.module}.{a.name}" == _BINDING_MODULE:
                    out.add(a.asname or a.name)
    return out


def _own_nodes(fn: ast.FunctionDef):
    """The nodes of `fn`'s body, nested defs and lambdas left out."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _launches(fn: ast.FunctionDef, kb: set[str]) -> bool:
    """True for a kernel wrapper: it bumps its own launch counter or
    checks a launch through the kernel binding."""
    for node in ast.walk(fn):
        if (isinstance(node, ast.AugAssign)
                and isinstance(node.target, ast.Attribute)
                and node.target.attr == "launches"
                and isinstance(node.target.value, ast.Name)
                and node.target.value.id == fn.name):
            return True
        if isinstance(node, ast.Call):
            name = call_name(node) or ""
            if "." in name and name.rsplit(".", 1)[0] in kb \
                    and name.rsplit(".", 1)[1] == "check":
                return True
    return False


class _FileScope:
    """What a call in one file can name: (module, name) targets through
    its module aliases, its imported names and its module-level defs."""

    def __init__(self, src):
        self.module = _module_of(src.rel)
        pkg = self.module if src.rel.endswith("__init__.py") \
            else self.module.rpartition(".")[0]
        self.aliases: dict[str, str] = {}   # alias -> module
        self.names: dict[str, tuple[str, str]] = {}
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.aliases[a.asname] = a.name
                    else:
                        top = a.name.split(".")[0]
                        self.aliases[top] = top
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    parts = pkg.split(".")
                    parts = parts[:len(parts) - node.level + 1]
                    base = ".".join(parts + ([base] if base else []))
                for a in node.names:
                    bound = a.asname or a.name
                    # `from pkg import x`: x is a module or a name
                    self.aliases[bound] = f"{base}.{a.name}"
                    self.names[bound] = (base, a.name)
        self.defs = {n.name: (self.module, n.name) for n in src.tree.body
                     if isinstance(n, ast.FunctionDef)}

    def target(self, call: ast.Call) -> tuple[str, str] | None:
        func = call.func
        if isinstance(func, ast.Name):
            return self.defs.get(func.id) or self.names.get(func.id)
        if isinstance(func, ast.Attribute) and \
                isinstance(func.value, ast.Name) and \
                func.value.id in self.aliases:
            return (self.aliases[func.value.id], func.attr)
        return None

    def calls_device(self, call: ast.Call,
                     device: set[tuple[str, str]]) -> bool:
        return self.target(call) in device


def _package_files(files):
    return [f for f in files if f.rel.startswith(PACKAGE)
            and not f.rel.startswith(PACKAGE + "tools/")]


def _scope(src) -> _FileScope:
    """The file's scope, built once per parsed file."""
    scope = getattr(src, "_dispatch_scope", None)
    if scope is None:
        scope = _FileScope(src)
        src._dispatch_scope = scope
    return scope


def kernel_wrappers(files) -> set[tuple[str, str]]:
    """(module, name) of the package's kernel wrappers: module-level
    functions that launch (own launch counter, or a launch checked
    through the binding)."""
    out: set[tuple[str, str]] = set()
    for src in _package_files(files):
        if "launches" not in src.text and "binding" not in src.text:
            continue
        kb = _binding_aliases(src.tree)
        mod = _module_of(src.rel)
        for node in src.tree.body:
            if isinstance(node, ast.FunctionDef) and _launches(node, kb):
                out.add((mod, node.name))
    return out


def device_functions(files) -> set[tuple[str, str]]:
    """Kernel wrappers plus device programs: module-level functions of
    the package that call a wrapper or another program, and a package's
    re-exports of them (to a fixpoint)."""
    device = kernel_wrappers(files)
    # (module, name) -> the (module, name) targets its body calls
    calls: dict[tuple[str, str], set] = {}
    for src in _package_files(files):
        scope = _scope(src)
        for node in src.tree.body:
            if isinstance(node, ast.FunctionDef):
                calls[(scope.module, node.name)] = {
                    t for t in (scope.target(sub) for sub in _own_nodes(node)
                                if isinstance(sub, ast.Call))
                    if t is not None}
        if src.rel.endswith("__init__.py"):
            for bound, target in scope.names.items():
                calls.setdefault((scope.module, bound), set()).add(target)
    changed = True
    while changed:
        changed = False
        for fn, targets in calls.items():
            if fn not in device and targets & device:
                device.add(fn)
                changed = True
    return device


def namespace_methods(files, device: set[tuple[str, str]]) -> set[str]:
    """Device methods of the sharded lattice classes: methods that call a
    device function or another device method of their class."""
    out: set[str] = set()
    for src in _package_files(files):
        scope = _scope(src)
        for cls in ast.walk(src.tree):
            if not isinstance(cls, ast.ClassDef) or \
                    cls.name not in KERNEL_NAMESPACE_FACTORIES:
                continue
            methods = [m for m in cls.body
                       if isinstance(m, ast.FunctionDef)]
            mine: set[str] = set()
            changed = True
            while changed:
                changed = False
                for m in methods:
                    if m.name in mine:
                        continue
                    for sub in _own_nodes(m):
                        if not isinstance(sub, ast.Call):
                            continue
                        name = call_name(sub) or ""
                        if scope.calls_device(sub, device) or (
                                name.startswith("self.")
                                and name.count(".") == 1
                                and name.split(".")[1] in mine):
                            mine.add(m.name)
                            changed = True
                            break
            out |= mine
    return out


# ---- per-class and per-function recognition --------------------------------


def _factory_leaf(rhs: ast.AST) -> str | None:
    if isinstance(rhs, ast.Call):
        return (call_name(rhs) or "").split(".")[-1]
    return None


def _namespace_keys(tree: ast.Module) -> set[str]:
    """Dict keys under which the file stores a namespace object
    (`{"sjl": sjl, ...}` with `sjl = ShardedJoinLattice(...)`, or
    `d["ssl"] = ShardedSessionLattice(...)`)."""
    out: set[str] = set()
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        ns_vars: set[str] = set()
        for stmt in ast.walk(fn):
            if isinstance(stmt, ast.Assign) and \
                    _factory_leaf(stmt.value) in KERNEL_NAMESPACE_FACTORIES:
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        ns_vars.add(t.id)
                    elif isinstance(t, ast.Subscript) and \
                            isinstance(t.slice, ast.Constant) and \
                            isinstance(t.slice.value, str):
                        out.add(t.slice.value)
        for node in ast.walk(fn):
            if isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if isinstance(k, ast.Constant) and \
                            isinstance(k.value, str) and \
                            isinstance(v, ast.Name) and v.id in ns_vars:
                        out.add(k.value)
    return out


def _keyed_lookup(rhs: ast.AST) -> str | None:
    """'k' for `<x>["k"]` or `<x>.get("k")`."""
    if isinstance(rhs, ast.Subscript) and \
            isinstance(rhs.slice, ast.Constant) and \
            isinstance(rhs.slice.value, str):
        return rhs.slice.value
    if isinstance(rhs, ast.Call) and isinstance(rhs.func, ast.Attribute) \
            and rhs.func.attr == "get" and rhs.args and \
            isinstance(rhs.args[0], ast.Constant) and \
            isinstance(rhs.args[0].value, str):
        return rhs.args[0].value
    return None


def _namespaces(fn: ast.FunctionDef, ns_keys: set[str]
                ) -> tuple[set[str], set[str]]:
    """(bundle vars, sharded-lattice vars) bound in `fn`: dotted names
    (`fns`, `self._sharded`) holding a `compiled(...)` bundle or a
    sharded lattice."""
    bundles: set[str] = set()
    sharded: set[str] = set()
    for stmt in ast.walk(fn):
        if not isinstance(stmt, ast.Assign):
            continue
        leaf = _factory_leaf(stmt.value)
        key = _keyed_lookup(stmt.value)
        for t in stmt.targets:
            d = dotted(t)
            if d is None:
                continue
            if leaf in _BUNDLE_FACTORIES:
                bundles.add(d)
            elif leaf in KERNEL_NAMESPACE_FACTORIES or key in ns_keys:
                sharded.add(d)
    return bundles, sharded


def _class_kernel_attrs(cls: ast.ClassDef, ns_keys: set[str]
                        ) -> tuple[set[str], set[str]]:
    """(kernel attrs, sharded-lattice attrs) of `self` assigned anywhere
    in the class: `self.X = <kernel factory>(...)`, `self.X =
    fns.extract_slots` of a bundle or a sharded lattice's method, and
    `self.X = ShardedLattice(...)`."""
    kernels: set[str] = set()
    sharded: set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.FunctionDef):
            continue
        bundles, shard_vars = _namespaces(node, ns_keys)
        for stmt in ast.walk(node):
            if not isinstance(stmt, ast.Assign):
                continue
            rhs = stmt.value
            leaf = _factory_leaf(rhs)
            base = dotted(rhs.value) if isinstance(rhs, ast.Attribute) \
                else None
            for t in stmt.targets:
                if not (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    continue
                if leaf in KERNEL_FACTORIES:
                    kernels.add(t.attr)
                elif f"self.{t.attr}" in shard_vars:
                    sharded.add(t.attr)
                elif base is not None and (base in bundles
                                           or base in shard_vars):
                    kernels.add(t.attr)
    return kernels, sharded


def _local_kernel_names(fn: ast.FunctionDef) -> set[str]:
    """Local names bound from kernel factories inside `fn`."""
    out: set[str] = set()
    for stmt in ast.walk(fn):
        if isinstance(stmt, ast.Assign) and \
                _factory_leaf(stmt.value) in KERNEL_FACTORIES:
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


class _Ctx:
    """What one function's calls are recognised against."""

    def __init__(self, scope: _FileScope, device: set[tuple[str, str]],
                 ns_methods: set[str], kernel_attrs: set[str],
                 sharded_attrs: set[str], fn: ast.FunctionDef,
                 ns_keys: set[str], method_budgets: dict[str, dict],
                 module_budgets: dict[str, dict]):
        self.scope = scope
        self.method_budgets = method_budgets
        self.module_budgets = module_budgets
        self.device = device
        self.ns_methods = ns_methods
        self.kernel_attrs = kernel_attrs
        self.local_kernels = _local_kernel_names(fn)
        bundles, sharded = _namespaces(fn, ns_keys)
        self.bundles = bundles
        self.sharded = sharded | {f"self.{a}" for a in sharded_attrs}
        self.device_locals = _device_locals(fn, self)

    def callee_budget(self, call: ast.Call) -> dict[str, int] | None:
        """The `inline` contract of the called function, for `self.m(...)`
        of the same class or `f(...)` of the same module."""
        func = call.func
        if isinstance(func, ast.Name):
            return self.module_budgets.get(func.id)
        if isinstance(func, ast.Attribute) and \
                isinstance(func.value, ast.Name) and func.value.id == "self":
            return self.method_budgets.get(func.attr)
        return None

    def is_dispatch(self, call: ast.Call) -> bool:
        name = call_name(call) or ""
        if not name:
            return False
        if isinstance(call.func, ast.Name) and \
                name in self.local_kernels:
            return True
        if self.scope.calls_device(call, self.device):
            return True
        base, _, leaf = name.rpartition(".")
        if base == "self":
            return leaf in self.kernel_attrs
        if base in self.bundles:
            return True
        return base in self.sharded and leaf in self.ns_methods


def _device_locals(fn: ast.FunctionDef, ctx: _Ctx) -> set[str]:
    """Local names assigned (incl. tuple-unpacked) from a dispatch or a
    torch call placing a tensor on a device — device values by
    construction."""
    out: set[str] = set()

    def _is_device_call(v: ast.AST) -> bool:
        if not isinstance(v, ast.Call):
            return False
        name = call_name(v) or ""
        if name.startswith("torch.") and any(
                kw.arg == "device" and not (
                    isinstance(kw.value, ast.Constant)
                    and kw.value.value == "cpu")
                for kw in v.keywords):
            return True
        return ctx.is_dispatch(v)

    for stmt in ast.walk(fn):
        if isinstance(stmt, ast.Assign) and _is_device_call(stmt.value):
            for t in stmt.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        out.add(n.id)
        elif isinstance(stmt, (ast.For, ast.comprehension)):
            if _mentions_device(stmt.iter, out):
                for n in ast.walk(stmt.target):
                    if isinstance(n, ast.Name):
                        out.add(n.id)
    return out


def _mentions_device(node: ast.AST, device_locals: set[str]) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            if sub.id in device_locals or \
                    _DEVICE_NAME_RE.search(sub.id):
                return True
        elif isinstance(sub, ast.Attribute):
            if _DEVICE_NAME_RE.search(sub.attr):
                return True
    return False


def _to_cpu(call: ast.Call) -> bool:
    """`.to("cpu")`, `.to(device="cpu")`, `.to(torch.device("cpu"))`."""
    vals = list(call.args) + [kw.value for kw in call.keywords
                              if kw.arg == "device"]
    for v in vals:
        if isinstance(v, ast.Constant) and v.value == "cpu":
            return True
        if isinstance(v, ast.Call) and \
                (call_name(v) or "").endswith("device") and v.args and \
                isinstance(v.args[0], ast.Constant) and \
                v.args[0].value == "cpu":
            return True
    return False


def _chained_on_fetch(call: ast.Call, device_locals, in_contract) -> bool:
    """True when the receiver already is a fetch (`x.cpu().numpy()`:
    one copy, counted at `.cpu()`)."""
    recv = call.func.value if isinstance(call.func, ast.Attribute) \
        else None
    while recv is not None:
        if isinstance(recv, ast.Call):
            if _is_fetch(recv, device_locals, in_contract):
                return True
            recv = recv.func.value if isinstance(recv.func,
                                                 ast.Attribute) else None
        elif isinstance(recv, (ast.Attribute, ast.Subscript)):
            recv = recv.value
        else:
            return False
    return False


def _is_fetch(call: ast.Call, device_locals: set[str],
              in_contract: bool) -> bool:
    name = call_name(call) or ""
    leaf = name.split(".")[-1] if name else (
        call.func.attr if isinstance(call.func, ast.Attribute) else "")
    if not isinstance(call.func, ast.Attribute):
        return False
    if leaf in _FETCH_METHODS:
        return not _chained_on_fetch(call, device_locals, in_contract)
    if leaf == "to" and _to_cpu(call):
        return not _chained_on_fetch(call, device_locals, in_contract)
    if leaf in _HOST_VIEW_METHODS and not call.args:
        # only of a value known to be on the card: the dict of device
        # state (`dev[...]`) also holds the host mirrors
        if _chained_on_fetch(call, device_locals, in_contract):
            return False
        return any(isinstance(n, ast.Name) and n.id in device_locals
                   for n in ast.walk(call.func.value))
    if leaf == "asarray" and name.split(".")[0] in ("np", "numpy"):
        if any(kw.arg == "dtype" for kw in call.keywords) \
                or len(call.args) > 1:
            return False  # host-typed conversion, the repo's idiom
        if not call.args:
            return False
        arg = call.args[0]
        if isinstance(arg, (ast.List, ast.Tuple, ast.Constant)):
            return False  # literal -> host construction
        if in_contract:
            return True  # contract paths are device paths
        return _mentions_device(arg, device_locals)
    return False


def _terminates(body: list[ast.stmt]) -> bool:
    """True when the block always leaves: it ends in a return, raise,
    continue or break, also one inside a closing `with`."""
    if not body:
        return False
    if isinstance(body[-1], ast.With):
        return _terminates(body[-1].body)
    return isinstance(body[-1], (ast.Return, ast.Raise, ast.Continue,
                                 ast.Break))


class _Budget:
    """Branch-aware static (dispatches, fetches) counter that also
    reports loop violations."""

    def __init__(self, ctx: _Ctx, in_contract: bool):
        self.ctx = ctx
        self.in_contract = in_contract
        self.loop_findings: list[tuple[int, str, str]] = []

    def _expr_sites(self, node: ast.AST | None) -> tuple[int, int]:
        """(dispatches, fetches) in one expression subtree."""
        if node is None:
            return 0, 0
        d = f = 0
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            callee = self.ctx.callee_budget(sub)
            if callee is not None:
                # an inline helper's sites are the caller's; a budget
                # key it leaves open counts as none
                d += callee.get("dispatches", 0)
                f += callee.get("fetches", 0)
            elif self.ctx.is_dispatch(sub):
                d += 1
            elif _is_fetch(sub, self.ctx.device_locals, self.in_contract):
                f += 1
        return d, f

    def _stmt_sites(self, stmt: ast.stmt) -> tuple[int, int]:
        """(dispatches, fetches) in one statement's OWN expressions:
        compound statements contribute only their header (test / iter /
        with-items) — their bodies are counted recursively by count()."""
        if isinstance(stmt, (ast.If, ast.While)):
            return self._expr_sites(stmt.test)
        if isinstance(stmt, ast.For):
            return self._expr_sites(stmt.iter)
        if isinstance(stmt, ast.With):
            d = f = 0
            for item in stmt.items:
                d2, f2 = self._expr_sites(item.context_expr)
                d += d2
                f += f2
            return d, f
        if isinstance(stmt, (ast.Try, ast.FunctionDef)):
            return 0, 0
        return self._expr_sites(stmt)

    def _loop_sanctioned(self, loop) -> bool:
        if not isinstance(loop, ast.For):
            return False
        try:
            text = ast.unparse(loop.iter)
        except Exception:  # noqa: BLE001 — unparse is best-effort
            text = ""
        return any(tok in text for tok in _SHAPE_GROUP_TOKENS)

    def count(self, stmts: list[ast.stmt]) -> tuple[int, int]:
        if not stmts:
            return 0, 0
        head, rest = stmts[0], stmts[1:]
        hd, hf = self._stmt_sites(head)
        if isinstance(head, ast.If):
            bd, bf = self.count(head.body)
            od, of_ = self.count(head.orelse)

            rd, rf = self.count(rest)
            if _terminates(head.body):
                return (hd + max(bd, od + rd), hf + max(bf, of_ + rf))
            if _terminates(head.orelse):
                return (hd + max(od, bd + rd), hf + max(of_, bf + rf))
            return (hd + max(bd, od) + rd, hf + max(bf, of_) + rf)
        if isinstance(head, (ast.For, ast.While)):
            bd, bf = self.count(head.body)
            od, of_ = self.count(head.orelse)
            if (bd or bf) and not self._loop_sanctioned(head):
                kind = "dispatch" if bd else "fetch"
                try:
                    it = ast.unparse(head.iter) \
                        if isinstance(head, ast.For) else "while"
                except Exception:  # noqa: BLE001
                    it = "loop"
                self.loop_findings.append((head.lineno, kind, it))
            rd, rf = self.count(rest)
            return hd + bd + od + rd, hf + bf + of_ + rf
        if isinstance(head, (ast.With, ast.Try)):
            bodies = [head.body]
            if isinstance(head, ast.Try):
                bodies += [h.body for h in head.handlers]
                bodies += [head.orelse, head.finalbody]
            bd = bf = 0
            for b in bodies:
                d2, f2 = self.count(b)
                bd += d2
                bf += f2
            rd, rf = self.count(rest)
            return hd + bd + rd, hf + bf + rf
        if isinstance(head, ast.FunctionDef):
            rd, rf = self.count(rest)
            return rd, rf  # nested def: counted when IT is annotated
        rd, rf = self.count(rest)
        return hd + rd, hf + rf


def _class_of(tree: ast.Module) -> dict[int, ast.ClassDef]:
    """FunctionDef id -> the class it is a method of."""
    out: dict[int, ast.ClassDef] = {}
    for cls in ast.walk(tree):
        if isinstance(cls, ast.ClassDef):
            for node in cls.body:
                if isinstance(node, ast.FunctionDef):
                    out[id(node)] = cls
    return out


def _inline_budgets(src, fns) -> dict[str, dict]:
    """name -> contract of each function in `fns` whose contract is
    `inline`."""
    out: dict[str, dict] = {}
    for fn in fns:
        if isinstance(fn, ast.FunctionDef):
            budgets, _line = _contract_of(src, fn)
            if budgets is not None and budgets.get("inline"):
                out[fn.name] = budgets
    return out


def _functions(files):
    """(src, fn, budgets, comment line, ctx) of every function the pass
    looks at: those with a contract, and every function of a hot file."""
    device = device_functions(files)
    ns_methods = namespace_methods(files, device)
    for src in files:
        scope = _scope(src)
        ns_keys = (_namespace_keys(src.tree)
                   if any(f in src.text for f in KERNEL_NAMESPACE_FACTORIES)
                   else set())
        owner = _class_of(src.tree)
        class_info = {id(node): (_class_kernel_attrs(node, ns_keys),
                                 _inline_budgets(src, node.body))
                      for node in ast.walk(src.tree)
                      if isinstance(node, ast.ClassDef)}
        module_budgets = _inline_budgets(src, src.tree.body)
        hot = src.rel in HOT_PATH_FILES
        for fn in ast.walk(src.tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            budgets, cline = _contract_of(src, fn)
            if budgets is None and cline is None and not hot:
                continue  # nothing to check here
            cls = owner.get(id(fn))
            (kernels, sharded), methods = class_info.get(
                id(cls), ((set(), set()), {}))
            ctx = _Ctx(scope, device, ns_methods, kernels, sharded, fn,
                       ns_keys, methods, module_budgets)
            yield src, fn, budgets, cline, ctx


def contract_sites(files) -> dict[tuple[str, str], tuple[int, int]]:
    """(file, function) -> the (dispatches, fetches) the pass counts
    against each contract of the tree."""
    out: dict[tuple[str, str], tuple[int, int]] = {}
    for src, fn, budgets, _cline, ctx in _functions(files):
        if budgets is not None:
            out[(src.rel, fn.name)] = _Budget(ctx, in_contract=True).count(
                fn.body)
    return out


def run(files, repo) -> list[Finding]:
    out: list[Finding] = []
    for src, fn, budgets, cline, ctx in _functions(files):
        if cline is not None and budgets is None:
            out.append(Finding(
                "dispatch-contract-syntax", src.rel, cline,
                f"contract comment on {fn.name} does not parse — "
                f"expected `# contract: dispatches<=N fetches<=M`"))
            continue
        if budgets is not None:
            b = _Budget(ctx, in_contract=True)
            d, f = b.count(fn.body)
            for line, kind, it in b.loop_findings:
                out.append(Finding(
                    "dispatch-budget", src.rel, line,
                    f"{fn.name}: {kind} inside a loop over {it} — "
                    f"the per-cycle budget cannot hold"))
            nd = budgets.get("dispatches")
            if nd is not None and d > nd:
                out.append(Finding(
                    "dispatch-budget", src.rel, fn.lineno,
                    f"{fn.name}: {d} static dispatch site(s) "
                    f"exceed the declared dispatches<={nd}"))
            nf = budgets.get("fetches")
            if nf is not None and f > nf:
                out.append(Finding(
                    "dispatch-budget", src.rel, fn.lineno,
                    f"{fn.name}: {f} static fetch site(s) exceed "
                    f"the declared fetches<={nf}"))
        else:
            for sub in _own_nodes(fn):
                if not isinstance(sub, ast.Call):
                    continue
                callee = ctx.callee_budget(sub)
                if (callee.get("fetches", 0) if callee is not None
                        else _is_fetch(sub, ctx.device_locals, False)):
                    out.append(Finding(
                        "dispatch-sync", src.rel, sub.lineno,
                        f"{fn.name}: device sync "
                        f"{call_name(sub) or '.' + sub.func.attr}() "
                        f"without a "
                        f"`# contract:` budget — annotate the "
                        f"drain or move the sync off the hot path"))
    return out
