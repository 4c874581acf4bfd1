"""Resource-lifecycle pass.

`resource-leak` — every `threading.Thread` / `ThreadPoolExecutor` /
`Timer` a class stores on `self` must be joined / shut down / cancelled
on some reachable teardown path. Daemon flags don't excuse the leak: a
daemon thread caught mid device-fetch at interpreter teardown aborts
the process (the repo learned this in QueryTask.run), and an
unreclaimed dispatcher keeps touching subsystems its owner already
released.

Detection is the tree's own idiom: an attribute is considered cleaned
up when some function in the same MODULE calls `.join()` /
`.shutdown()` / `.cancel()` on a RECEIVER that references the
attribute — directly (`self._pool.shutdown()`, `f._thread.join()`) or
through a one-step alias (`t = self._thread; t.join(...)`,
`for t in self._threads: t.join(...)`). Credit flows only from the
call's receiver, so an unrelated `os.path.join(...)` or `sep.join(...)`
in the same function cannot launder a leak. `run()` methods of Thread
subclasses are exempt as creators — a thread doesn't own itself.
"""

from __future__ import annotations

import ast

from hstream_tpu_torch.tools.analyze import Finding
from hstream_tpu_torch.tools.analyze.passes import class_methods, dotted, walk_classes

NAME = "lifecycle"

RULES = {
    "resource-leak": (
        "Thread/ThreadPoolExecutor/Timer stored on self is never "
        "joined/shut down/cancelled by any function in the module — "
        "no reachable teardown path"),
}

_SPAWN_TYPES = {"Thread", "ThreadPoolExecutor", "ProcessPoolExecutor",
                "Timer"}
_CLEANUP_CALLS = {"join", "shutdown", "cancel"}
# receiver roots whose join/cancel are not resource teardown
_NOT_RESOURCE_ROOTS = {"os", "posixpath", "ntpath", "shutil", "str"}


def _spawn_attrs(cls: ast.ClassDef) -> dict[str, tuple[int, str]]:
    """self-attributes assigned a spawned resource anywhere in the
    class: attr -> (line, type name). List-of-threads assignments
    (comprehensions containing a Thread(...) call) count too."""
    out: dict[str, tuple[int, str]] = {}
    for method in class_methods(cls):
        for node in ast.walk(method):
            if not isinstance(node, ast.Assign):
                continue
            spawned = None
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Call):
                    leaf = (dotted(sub.func) or "").split(".")[-1]
                    if leaf in _SPAWN_TYPES:
                        spawned = leaf
                        break
            if spawned is None:
                continue
            for t in node.targets:
                d = dotted(t)
                if d and d.startswith("self.") and d.count(".") == 1:
                    out.setdefault(d.split(".", 1)[1],
                                   (node.lineno, spawned))
    return out


def _attrs_in(node: ast.AST) -> set[str]:
    return {n.attr for n in ast.walk(node) if isinstance(n, ast.Attribute)}


def _cleaned_attrs(tree: ast.Module) -> set[str]:
    """Attribute names some function tears down: the receiver of a
    join/shutdown/cancel call references the attribute, directly or
    via a one-step alias (assignment / for-loop binding)."""
    cleaned: set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        # one-step aliases: name -> attrs referenced by its source expr
        alias: dict[str, set[str]] = {}
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                    and isinstance(sub.targets[0], ast.Name):
                alias.setdefault(sub.targets[0].id,
                                 set()).update(_attrs_in(sub.value))
            elif isinstance(sub, ast.For) and isinstance(sub.target,
                                                         ast.Name):
                alias.setdefault(sub.target.id,
                                 set()).update(_attrs_in(sub.iter))
        for sub in ast.walk(node):
            if not (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in _CLEANUP_CALLS):
                continue
            receiver = sub.func.value
            root = (dotted(receiver) or "").split(".")[0]
            if root in _NOT_RESOURCE_ROOTS:
                continue  # os.path.join & friends: not teardown
            cleaned |= _attrs_in(receiver)
            if root in alias:
                cleaned |= alias[root]
    return cleaned


def run(files, repo) -> list[Finding]:
    out: list[Finding] = []
    for src in files:
        cleaned = _cleaned_attrs(src.tree)
        for cls in walk_classes(src.tree):
            for attr, (line, typ) in sorted(_spawn_attrs(cls).items()):
                if attr not in cleaned:
                    out.append(Finding(
                        "resource-leak", src.rel, line,
                        f"{cls.name}.{attr} holds a {typ} that no "
                        f"function in this module joins/shuts down"))
    return out
