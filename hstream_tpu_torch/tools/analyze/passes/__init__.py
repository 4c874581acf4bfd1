"""Analysis passes. Each module exports NAME (pass id), RULES
(rule id -> one-line doc), and run(files, repo) -> list[Finding]."""

from __future__ import annotations

import ast

# ---- shared AST helpers ----------------------------------------------------


def dotted(node: ast.AST) -> str | None:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> str | None:
    """Dotted name of a call target ('time.sleep', 'self._in.get')."""
    return dotted(call.func)


def has_timeout(call: ast.Call, min_positional: int) -> bool:
    """True when the call passes a bound: a `timeout=`/`wait=False`
    keyword or at least `min_positional` positional args (e.g.
    Event.wait(0.5), Thread.join(5))."""
    for kw in call.keywords:
        if kw.arg == "timeout":
            return True
        if kw.arg == "wait":  # ThreadPoolExecutor.shutdown(wait=False)
            return isinstance(kw.value, ast.Constant) \
                and kw.value.value is False
    return len(call.args) >= min_positional


def class_methods(cls: ast.ClassDef):
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def walk_classes(tree: ast.Module):
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            yield node
