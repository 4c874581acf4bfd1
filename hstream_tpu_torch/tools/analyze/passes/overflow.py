"""Dtype-overflow pass for time/sequence identifiers.

Device time is int32 milliseconds relative to a host-managed epoch;
absolute stream time is int64. The safe order of operations is
SUBTRACT IN int64, RANGE-CHECK, THEN NARROW — the epoch-rebase helpers
(`_maybe_rebase`, `_ensure_epoch`, `lattice.rebase`) and the
`(1 << 31)` span guards exist so the narrow can never wrap. The two
ways the discipline silently breaks:

  overflow-ts-arith   arithmetic on an ALREADY-int32-cast timestamp
                      (`ts.astype(np.int32) - epoch`): the subtraction
                      itself wraps long before any later guard can
                      see it. Narrow after the int64 arithmetic, never
                      before.
  overflow-narrowing  an int64->int32 narrow of a time/seq value
                      (`.astype(np.int32)` / `np.int32(...)`) in a
                      host function with NO overflow guard in scope —
                      no `(1 << 31)`/`2**31` comparison, no
                      rebase-threshold reference, no clip, and no call
                      into a `*rebase*`/`_ensure_epoch` helper. Past
                      2^31 ms (~24.8 days of relative time) the value
                      silently goes negative and every window/probe
                      bound derived from it is wrong.

Jitted kernels are exempt: device code COMPUTES in the rebased int32
space by design; the host guards the boundary. The port traces no
Python (its device code is CUDA), so `_jitted_functions` finds nothing
in its tree; it stays so the pass reads any source text as the
reference's pass does. Identifier matching is
token-based (`ts`, `time`, `epoch`, `seq`, `lsn`, `watermark`, `wm`,
`start(s)`, plus short `*ts` forms like `bts`/`jts`), so `stats` or
`counts` never match.
"""

from __future__ import annotations

import ast

from hstream_tpu_torch.tools.analyze import Finding
from hstream_tpu_torch.tools.analyze.passes import call_name, dotted

NAME = "overflow"

RULES = {
    "overflow-ts-arith": (
        "arithmetic on an int32-cast timestamp — the operation wraps "
        "before any guard can fire; do the arithmetic in int64, "
        "range-check, then narrow"),
    "overflow-narrowing": (
        "int64->int32 narrow of a time/seq identifier in a host "
        "function with no overflow guard (no (1<<31) check, rebase "
        "reference, or clip) — wraps silently past ~24.8 days of "
        "relative time"),
}

_TOKENS = {"ts", "time", "timestamp", "epoch", "seq", "lsn",
           "watermark", "wm", "start", "starts"}
_GUARD_NAME_PARTS = ("rebase", "_ensure_epoch", "_join_bounds")
_EXEMPT_FN_PARTS = ("rebase", "_join_bounds", "_ensure_epoch")


def _jitted_functions(tree: ast.Module):
    """Yield (FunctionDef, how) for functions compiled by jit/shard_map:
    decorated directly, via partial(jax.jit, ...), or passed by name to
    a jit/shard_map call anywhere in the module."""
    defs_by_name: dict[str, list[ast.FunctionDef]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            defs_by_name.setdefault(node.name, []).append(node)

    def is_jit_name(name: str | None) -> bool:
        return bool(name) and (name.split(".")[-1] in ("jit", "shard_map")
                               or name.endswith(".pjit"))

    seen: set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            for dec in node.decorator_list:
                d = dec.func if isinstance(dec, ast.Call) else dec
                name = dotted(d)
                inner = None
                if isinstance(dec, ast.Call) and name and \
                        name.split(".")[-1] == "partial" and dec.args:
                    inner = dotted(dec.args[0])
                if is_jit_name(name) or is_jit_name(inner):
                    if id(node) not in seen:
                        seen.add(id(node))
                        yield node, "decorator"
        elif isinstance(node, ast.Call) and is_jit_name(call_name(node)):
            args = list(node.args)
            # jax.jit(shard_map(f, ...)) — unwrap nested compile calls
            while args and isinstance(args[0], ast.Call) \
                    and is_jit_name(call_name(args[0])):
                args = list(args[0].args)
            if args and isinstance(args[0], ast.Name):
                for fn in defs_by_name.get(args[0].id, ()):
                    if id(fn) not in seen:
                        seen.add(id(fn))
                        yield fn, "jit call"


def _ts_ish(name: str | None) -> bool:
    if not name:
        return False
    for ident in name.split("."):
        for part in ident.lower().split("_"):
            if part in _TOKENS:
                return True
            if part.endswith("ts") and 0 < len(part) <= 3:
                return True  # bts / jts / sts
    return False


def _mentions_ts(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and _ts_ish(sub.id):
            return True
        if isinstance(sub, ast.Attribute) and _ts_ish(sub.attr):
            return True
        if isinstance(sub, ast.Constant) and \
                isinstance(sub.value, str) and _ts_ish(sub.value):
            return True  # dict keys: dev["t0"] is epoch state
        if isinstance(sub, ast.Subscript):
            sl = sub.slice
            if isinstance(sl, ast.Constant) and sl.value == "t0":
                return True
    return False


def _int32_cast(node: ast.AST) -> ast.expr | None:
    """The operand being narrowed to int32, or None.

    Shapes: X.astype(np.int32 | 'int32'), np.int32(X), jnp.int32(X),
    np.asarray(X, np.int32) / np.asarray(X, dtype=np.int32)."""
    if not isinstance(node, ast.Call):
        return None
    # the receiver of .astype can be ANY expression ((a - b).astype):
    # read the attribute name directly, not via the dotted-chain helper
    attr = node.func.attr if isinstance(node.func, ast.Attribute) \
        else None
    name = call_name(node) or ""
    leaf = name.split(".")[-1]

    def _is_i32(e: ast.AST) -> bool:
        d = dotted(e)
        if d and d.split(".")[-1] == "int32":
            return True
        return isinstance(e, ast.Constant) and e.value == "int32"

    if attr == "astype" and node.args and _is_i32(node.args[0]):
        return node.func.value
    if leaf == "int32" and name.split(".")[0] in ("np", "numpy",
                                                  "jnp") and node.args:
        return node.args[0]
    if leaf in ("asarray", "array") and node.args:
        if len(node.args) > 1 and _is_i32(node.args[1]):
            return node.args[0]
        for kw in node.keywords:
            if kw.arg == "dtype" and _is_i32(kw.value):
                return node.args[0]
    return None


def _has_guard(fn: ast.FunctionDef) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.BinOp) and \
                isinstance(node.op, ast.LShift):
            # `1 << 31` / `1 << 30` — the span-guard idiom
            if isinstance(node.left, ast.Constant) and \
                    isinstance(node.right, ast.Constant) and \
                    node.right.value in (30, 31):
                return True
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Pow):
            if isinstance(node.right, ast.Constant) and \
                    node.right.value in (30, 31):
                return True
        if isinstance(node, (ast.Name, ast.Attribute)):
            d = dotted(node) or ""
            leaf = d.split(".")[-1].lower()
            if "rebase" in leaf or leaf in ("clip",):
                return True
        if isinstance(node, ast.Call):
            leaf = (call_name(node) or "").split(".")[-1].lower()
            if any(p in leaf for p in ("rebase", "clip")) or \
                    leaf == "_ensure_epoch":
                return True
    return False


def run(files, repo) -> list[Finding]:
    out: list[Finding] = []
    for src in files:
        jitted = {id(fn) for fn, _how in _jitted_functions(src.tree)}
        # transitive closure: a helper called by bare name from a
        # jitted function executes traced too (pack_extract_rows and
        # friends ARE device code, just not jit-wrapped themselves)
        defs_by_name: dict[str, list[ast.FunctionDef]] = {}
        for node in ast.walk(src.tree):
            if isinstance(node, ast.FunctionDef):
                defs_by_name.setdefault(node.name, []).append(node)
        changed = True
        while changed:
            changed = False
            for node in ast.walk(src.tree):
                if not isinstance(node, ast.FunctionDef) or \
                        id(node) not in jitted:
                    continue
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Call) and \
                            isinstance(sub.func, ast.Name):
                        for d in defs_by_name.get(sub.func.id, ()):
                            if id(d) not in jitted:
                                jitted.add(id(d))
                                changed = True
        jitted_nodes: set[int] = set()
        for node in ast.walk(src.tree):
            if isinstance(node, ast.FunctionDef) and id(node) in jitted:
                for sub in ast.walk(node):
                    jitted_nodes.add(id(sub))
        for fn in ast.walk(src.tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            if id(fn) in jitted or id(fn) in jitted_nodes:
                continue  # device code: int32 space by design
            if any(p in fn.name for p in _EXEMPT_FN_PARTS):
                continue  # THE sanctioned boundary helpers
            guarded = _has_guard(fn)
            own: list[ast.AST] = []
            nested: set[int] = set()
            for node in ast.walk(fn):
                if isinstance(node, ast.FunctionDef) and node is not fn:
                    for inner in ast.walk(node):
                        nested.add(id(inner))
            for node in ast.walk(fn):
                if id(node) in nested or id(node) in jitted_nodes:
                    continue
                own.append(node)
            in_arith: set[int] = set()
            for node in own:
                # arith ON a cast: (x.astype(int32) - y) wraps inside
                if isinstance(node, ast.BinOp) and \
                        isinstance(node.op, (ast.Add, ast.Sub)):
                    for side in (node.left, node.right):
                        op = _int32_cast(side)
                        if op is not None and _mentions_ts(op):
                            in_arith.add(id(side))
                            out.append(Finding(
                                "overflow-ts-arith", src.rel,
                                node.lineno,
                                f"{fn.name}: int32-cast timestamp in "
                                f"+/- arithmetic — narrow AFTER the "
                                f"int64 arithmetic, not before"))
            for node in own:
                if id(node) in in_arith:
                    continue  # already reported as arith-on-cast
                # bare narrow without a guard in scope
                op = _int32_cast(node)
                if op is not None and _mentions_ts(op) and not guarded:
                    out.append(Finding(
                        "overflow-narrowing", src.rel, node.lineno,
                        f"{fn.name}: int32 narrow of a time/seq value "
                        f"with no overflow guard in the function — "
                        f"add a (1<<31) span check or route through "
                        f"the rebase helpers"))
    return out
