"""Retrace discipline pass, over the port.

The port's compile unit is a program factory: an lru_cache'd function
decorated `@compile_site(name)` (`lattice.compiled`, `expr.lower`,
`expr.launch_plan`), where a cache miss counts one compile
(`common/tracing.note_compile`, RetraceGuard) and one row of the
compiled-program inventory. The repo keeps steady-state recompiles at
ZERO with two idioms the reference's jit wrappers also needed: factories
are memoized, and every shape-bearing argument is padded to a sticky
power of two so varying batch/cycle widths converge on a few programs.
Two of the reference's four rules keep their object here:

  retrace-uncached-jit  a `compile_site` factory that is not memoized:
                        a `@compile_site(...)` def without an lru_cache
                        / cache decorator above it, or `compile_site`
                        applied inside a plain (per-call) function —
                        either way every call is a compile. The
                        sanctioned shapes are lru_cache-decorated
                        factories, `build_*`/`mk_*`/`_build*`
                        constructors, `_compile` and `__init__`.
  retrace-shape-key     a memoized program factory called with a raw
                        `len(<batch-like>)` — unpadded shape keys
                        compile one program per distinct size; route
                        through round_up_pow2 / the sticky-cap helpers.

Not carried (the port traces no Python function):
`retrace-traced-branch` (a host branch on an argument is plain control
flow) and `retrace-static-arg` (no static_argnums exist; a factory's
arguments are its cache key, which retrace-shape-key checks). The
framework lists both under --list-rules.
"""

from __future__ import annotations

import ast

from hstream_tpu_torch.tools.analyze import Finding
from hstream_tpu_torch.tools.analyze.passes import call_name, dotted

NAME = "retrace"

RULES = {
    "retrace-uncached-jit": (
        "compile_site program factory without an lru_cache (or applied "
        "inside a per-call function) — every call is a compile; "
        "memoize it like lattice.compiled"),
    "retrace-shape-key": (
        "memoized program factory called with a raw len() of a batch "
        "value — unpadded shape keys defeat the pow2-padding compile "
        "cache"),
}

_SANCTIONED_PREFIXES = ("build_", "_build", "mk_")
_SANCTIONED_NAMES = {"_compile", "__init__", "compiled"}

# in-tree memoized kernel factories (by leaf name) whose arguments are
# compile-cache keys; module-local lru_cache'd defs are added per file
_KNOWN_FACTORIES = {"compiled", "lower", "launch_plan", "divisor",
                     "sm_count"}

_BATCHISH = ("batch", "batches", "rows", "codes", "kids", "matches",
             "keys", "vals", "records", "ts")


def _is_compile_site(name: str | None) -> bool:
    return bool(name) and name.split(".")[-1] == "compile_site"


def _is_cached_factory_def(fn: ast.FunctionDef) -> bool:
    for dec in fn.decorator_list:
        d = dec.func if isinstance(dec, ast.Call) else dec
        name = (dotted(d) or "").split(".")[-1]
        if name in ("lru_cache", "cache"):
            return True
    return False


def _sanctioned(fn: ast.FunctionDef) -> bool:
    if _is_cached_factory_def(fn):
        return True
    if fn.name in _SANCTIONED_NAMES:
        return True
    return fn.name.startswith(_SANCTIONED_PREFIXES)


def _enclosers(tree: ast.Module) -> dict[int, list[ast.FunctionDef]]:
    """node id -> chain of enclosing FunctionDefs (outermost first)."""
    out: dict[int, list[ast.FunctionDef]] = {}

    def visit(node: ast.AST, chain: list[ast.FunctionDef]) -> None:
        for child in ast.iter_child_nodes(node):
            nxt = chain
            if isinstance(child, ast.FunctionDef):
                out[id(child)] = chain
                nxt = chain + [child]
            else:
                out[id(child)] = chain
            visit(child, nxt)

    visit(tree, [])
    return out


def _uncached_jit(src) -> list[Finding]:
    out: list[Finding] = []
    chains = _enclosers(src.tree)
    for node in ast.walk(src.tree):
        if isinstance(node, ast.FunctionDef):
            for i, dec in enumerate(node.decorator_list):
                d = dec.func if isinstance(dec, ast.Call) else dec
                if not _is_compile_site(dotted(d)):
                    continue
                chain = chains.get(id(node), [])
                # the cache must sit ABOVE compile_site: only a miss
                # may reach it
                cached = any(
                    (dotted(c.func if isinstance(c, ast.Call) else c)
                     or "").split(".")[-1] in ("lru_cache", "cache")
                    for c in node.decorator_list[:i])
                if not cached:
                    out.append(Finding(
                        "retrace-uncached-jit", src.rel, dec.lineno,
                        f"@compile_site factory {node.name} has no "
                        f"lru_cache above it — every call is a compile; "
                        f"memoize it"))
                elif chain and not any(_sanctioned(f) for f in chain):
                    out.append(Finding(
                        "retrace-uncached-jit", src.rel, dec.lineno,
                        f"@compile_site {node.name} constructed inside "
                        f"{chain[-1].name}() — a per-call factory starts "
                        f"with an empty cache every call"))
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Call) and \
                _is_compile_site(call_name(node.func)):
            # compile_site("x")(fn): a factory built at the call site
            chain = chains.get(id(node), [])
            if chain and not any(_sanctioned(f) for f in chain):
                out.append(Finding(
                    "retrace-uncached-jit", src.rel, node.lineno,
                    f"compile_site(...) applied inside "
                    f"{chain[-1].name}() — a per-call factory compiles "
                    f"on every call; memoize via an lru_cache factory"))
    return out


def _shape_keys(src) -> list[Finding]:
    factories = set(_KNOWN_FACTORIES)
    for node in ast.walk(src.tree):
        if isinstance(node, ast.FunctionDef) and \
                _is_cached_factory_def(node):
            factories.add(node.name)
    out: list[Finding] = []
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call):
            continue
        leaf = (call_name(node) or "").split(".")[-1]
        if leaf not in factories:
            continue
        for arg in node.args:
            if not (isinstance(arg, ast.Call)
                    and isinstance(arg.func, ast.Name)
                    and arg.func.id == "len" and arg.args):
                continue
            inner = arg.args[0]
            name = (dotted(inner) or "").split(".")[-1].lower()
            if any(tok == name or name.endswith("_" + tok)
                   for tok in _BATCHISH):
                out.append(Finding(
                    "retrace-shape-key", src.rel, arg.lineno,
                    f"{leaf}(... len({dotted(inner)}) ...) keys the "
                    f"compile cache on a raw size — pad via "
                    f"round_up_pow2 / a sticky cap"))
    return out


def run(files, repo) -> list[Finding]:
    out: list[Finding] = []
    for src in files:
        out.extend(_uncached_jit(src))
        out.extend(_shape_keys(src))
    return out
