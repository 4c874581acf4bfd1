"""Millisecond/second unit mixing.

The protocol plane measures time in integer MILLISECONDS
(`hb_ms`, `lease_ms`, `created_time_ms`, `now_ms()`), the stdlib
measures in float SECONDS (`time.time()`, `time.monotonic()`,
`timeout_s`, `lease_timeout_s`). Both conventions are fine; an
expression combining them without a conversion is not — a lease
compared against `time.time()` is off by 1000x and every owner reads
as dead (or never dead). The convention is spelled in the suffix, so
the mix is statically visible:

  timeunit-mix   a single arithmetic (+/-) or comparison expression
                 with one operand in ms (identifier suffix `_ms`/
                 `_msec`, or bare `ms`) and another in seconds
                 (suffix `_s`/`_sec`/`_secs`/`_seconds`, bare
                 `seconds`, or a direct `time.time()`/
                 `time.monotonic()` call) and NO recognized conversion
                 factor (1000 / 1000.0 / 1e3 / 0.001) anywhere in the
                 expression.

Conversions like `time.time() * 1e3 - dur_ms` pass (the factor is in
the expression); genuinely mixed-unit code has no factor to find.
"""

from __future__ import annotations

import ast

from hstream_tpu_torch.tools.analyze import Finding
from hstream_tpu_torch.tools.analyze.passes import call_name

NAME = "timeunit"

RULES = {
    "timeunit-mix": (
        "arithmetic or comparison mixing a *_ms operand with a "
        "seconds operand (*_s / *_sec / time.time() / "
        "time.monotonic()) without a 1000/1e3/0.001 conversion "
        "factor in the expression — off by 1000x"),
}

_MS_SUFFIXES = {"ms", "msec", "msecs"}
_S_SUFFIXES = {"s", "sec", "secs", "seconds"}
_S_CALLS = {"time.time", "time.monotonic"}
_FACTORS = {1000, 1000.0, 1e3, 0.001}


def _unit_of_ident(ident: str) -> str | None:
    last = ident.lower().split("_")[-1]
    if last in _MS_SUFFIXES:
        return "ms"
    if last in _S_SUFFIXES and "_" in ident or ident == "seconds":
        # bare names like `stats`/`args` must not read as seconds:
        # the s-suffix only counts after an underscore (`timeout_s`)
        return "s"
    return None


def _units(node: ast.AST) -> set[str]:
    """Units mentioned anywhere inside one operand subtree."""
    units: set[str] = set()
    for sub in ast.walk(node):
        ident = None
        if isinstance(sub, ast.Name):
            ident = sub.id
        elif isinstance(sub, ast.Attribute):
            ident = sub.attr
        elif isinstance(sub, ast.Call):
            name = call_name(sub)
            if name and name.rsplit(".", 1)[-1] in ("time", "monotonic") \
                    and name in _S_CALLS:
                units.add("s")
            continue
        if ident:
            u = _unit_of_ident(ident)
            if u:
                units.add(u)
    return units


def _has_factor(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) \
                and isinstance(sub.value, (int, float)) \
                and not isinstance(sub.value, bool) \
                and sub.value in _FACTORS:
            return True
    return False


def run(files, repo) -> list[Finding]:
    out: list[Finding] = []
    for src in files:
        flagged: set[int] = set()
        for node in ast.walk(src.tree):
            if isinstance(node, ast.BinOp) \
                    and isinstance(node.op, (ast.Add, ast.Sub)):
                operands = [node.left, node.right]
            elif isinstance(node, ast.Compare):
                operands = [node.left] + list(node.comparators)
            else:
                continue
            if node.lineno in flagged:
                continue
            per_op = [_units(o) for o in operands]
            has_ms = any("ms" in u for u in per_op)
            has_s = any(u == {"s"} for u in per_op)
            if not (has_ms and has_s):
                continue
            if _has_factor(node):
                continue
            flagged.add(node.lineno)
            kind = ("comparison" if isinstance(node, ast.Compare)
                    else "arithmetic")
            out.append(Finding(
                "timeunit-mix", src.rel, node.lineno,
                f"{kind} mixes millisecond and second operands with "
                f"no conversion factor in the expression"))
    return out
