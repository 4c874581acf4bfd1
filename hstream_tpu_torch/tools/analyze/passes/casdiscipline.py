"""CAS/epoch/lease discipline for the ownership and replica protocols.

The coordination state — `scheduler/query/*` ownership records,
`cluster/nodes/*` health records, the versioned-config `vcs/*` plane,
and the replica `replica/*` epoch/leader binding — is multi-writer by
design: every server races CAS claims against its peers. The protocol
survives exactly because every write follows three idioms, and each
rule here flags the write shapes that broke (or would have broken)
the replication and ownership fixes:

  cas-blind-meta-write    a raw `meta_put`/`meta_delete` on a protocol
                          key: last-writer-wins on a multi-writer key
                          silently undoes a concurrent CAS claim. All
                          protocol keys flow through `meta_cas` (or the
                          VersionedConfigStore over it); the follower's
                          single-writer epoch plane is the reviewed
                          exception (waived in store/replica.py).
  cas-put-foreign-version a versioned `config.put`/`config.delete`
                          whose `base_version` does not derive from a
                          `config.get` read in the SAME function: a
                          cached or guessed version turns the CAS into
                          a blind overwrite of whatever raced in
                          between the stale read and the write.
  cas-epoch-nonmonotone   an epoch field assigned from something other
                          than a monotone source (`max(...)`, `+ 1`,
                          `load_epoch`, `boot_epoch`) in a function
                          with no epoch comparison guard: fencing is
                          sound only while epochs never move backwards.
  cas-lease-raw           a heartbeat-age comparison against raw
                          `interval`-derived arithmetic instead of a
                          lease identifier: the placer CLAMPS the lease
                          to >= 3x its tick interval at construction,
                          and any age test that re-derives its own
                          bound from the interval bypasses the clamp
                          (the exact bug of the live-adopt before its fix).
"""

from __future__ import annotations

import ast

from hstream_tpu_torch.tools.analyze import Finding
from hstream_tpu_torch.tools.analyze.passes import dotted

NAME = "casdiscipline"

RULES = {
    "cas-blind-meta-write": (
        "raw meta_put/meta_delete on a protocol key (scheduler/, "
        "cluster/, vcs/, replica/ or a META_* constant) — "
        "last-writer-wins on a multi-writer key; route it through "
        "meta_cas / the versioned store, or waive the reviewed "
        "single-writer planes"),
    "cas-put-foreign-version": (
        "versioned put/delete whose base_version does not derive from "
        "a config.get read in the same function — a stale or guessed "
        "version makes the CAS overwrite concurrent claims blindly"),
    "cas-epoch-nonmonotone": (
        "epoch field assigned from a non-monotone source in a "
        "function without an epoch comparison guard — fencing is "
        "sound only while epochs never decrease"),
    "cas-lease-raw": (
        "heartbeat-age compared against raw interval arithmetic "
        "instead of the (clamped) lease — re-deriving the bound from "
        "the interval bypasses the 3x-interval lease clamp"),
}

# key prefixes that make a meta key coordination state
_PROTOCOL_PREFIXES = ("scheduler/", "cluster/", "vcs/", "replica/")
# receivers that are VersionedConfigStore instances by convention
_CONFIG_RECV = ("config",)


def _is_protocol_key(node: ast.AST) -> bool:
    """True when the key expression names coordination state: a string
    constant (anywhere in the expression — f-strings, `prefix + qid`
    concatenations) starting with a protocol prefix, or a META_*
    module constant."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            if sub.value.startswith(_PROTOCOL_PREFIXES):
                return True
    name = dotted(node)
    if name:
        last = name.rsplit(".", 1)[-1]
        if last.startswith("META_"):
            return True
    return False


def _config_recv(call: ast.Call, method: str) -> bool:
    if not isinstance(call.func, ast.Attribute) \
            or call.func.attr != method:
        return False
    recv = dotted(call.func.value)
    if recv is None:
        return False
    last = recv.rsplit(".", 1)[-1].lstrip("_")
    return last in _CONFIG_RECV


def _functions(tree: ast.Module):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _tainted_names(fn: ast.AST) -> set[str]:
    """Names whose value derives from a same-function `config.get`
    read. Seed: assignment targets of `<recv>.get(...)` calls on a
    config receiver. Propagate: any assignment whose RHS mentions a
    tainted name taints its targets (covers `version, raw = cur` and
    `v = cur[0]`)."""
    tainted: set[str] = set()

    def targets_of(stmt: ast.Assign) -> list[str]:
        out = []
        for t in stmt.targets:
            for sub in ast.walk(t):
                if isinstance(sub, ast.Name):
                    out.append(sub.id)
        return out

    assigns = [s for s in ast.walk(fn) if isinstance(s, ast.Assign)]
    for s in assigns:
        if isinstance(s.value, ast.Call) \
                and _config_recv(s.value, "get"):
            tainted.update(targets_of(s))
    # fixpoint propagation (assignment chains are short)
    for _ in range(4):
        grew = False
        for s in assigns:
            if any(isinstance(sub, ast.Name) and sub.id in tainted
                   for sub in ast.walk(s.value)):
                for name in targets_of(s):
                    if name not in tainted:
                        tainted.add(name)
                        grew = True
        if not grew:
            break
    return tainted


_EPOCH_MONO_CALLS = ("max", "load_epoch")


def _epoch_target(node: ast.AST) -> bool:
    """An lvalue that is a protocol epoch field: `x._epoch`, `x.epoch`
    in a protocol module, or `rec["epoch"]`."""
    if isinstance(node, ast.Attribute):
        return node.attr in ("epoch", "_epoch")
    if isinstance(node, ast.Subscript):
        sl = node.slice
        return isinstance(sl, ast.Constant) and sl.value == "epoch"
    return False


def _mentions(node: ast.AST, tokens: set[str]) -> bool:
    for sub in ast.walk(node):
        ident = None
        if isinstance(sub, ast.Name):
            ident = sub.id
        elif isinstance(sub, ast.Attribute):
            ident = sub.attr
        elif isinstance(sub, ast.Constant) \
                and isinstance(sub.value, str):
            ident = sub.value
        if ident and tokens & set(ident.lower().split("_")):
            return True
    return False


def _module_is_protocol(tree: ast.Module) -> bool:
    """The epoch rule only applies to modules touching the REPLICATION
    / ownership epoch plane (load_epoch, boot_epoch, META_EPOCH); the
    engine's `epoch` is a timestamp base, not a fencing token."""
    for sub in ast.walk(tree):
        ident = None
        if isinstance(sub, ast.Name):
            ident = sub.id
        elif isinstance(sub, ast.Attribute):
            ident = sub.attr
        if ident in ("load_epoch", "boot_epoch", "META_EPOCH"):
            return True
    return False


def _has_epoch_guard(fn: ast.AST) -> bool:
    for sub in ast.walk(fn):
        if not isinstance(sub, ast.Compare):
            continue
        if any(isinstance(op, (ast.Lt, ast.LtE, ast.Gt, ast.GtE))
               for op in sub.ops):
            if _mentions(sub, {"epoch"}):
                return True
    return False


def _epoch_rhs_monotone(value: ast.AST) -> bool:
    for sub in ast.walk(value):
        if isinstance(sub, ast.Call):
            name = dotted(sub.func)
            if name and name.rsplit(".", 1)[-1] in _EPOCH_MONO_CALLS:
                return True
        if isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Add):
            return True  # epoch bump: cur + 1
        if isinstance(sub, (ast.Name, ast.Attribute)):
            ident = sub.id if isinstance(sub, ast.Name) else sub.attr
            if "boot_epoch" in ident:
                return True
    return False


_AGE_TOKENS = {"age", "hb"}
_INTERVAL_TOKENS = {"interval"}


def run(files, repo) -> list[Finding]:
    out: list[Finding] = []
    for src in files:
        protocol_module = _module_is_protocol(src.tree)

        # ---- cas-blind-meta-write ----------------------------------
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call) \
                    or not isinstance(node.func, ast.Attribute):
                continue
            if node.func.attr not in ("meta_put", "meta_delete"):
                continue
            if not node.args or not _is_protocol_key(node.args[0]):
                continue
            key = dotted(node.args[0])
            if key is None:
                key_const = next(
                    (s.value for s in ast.walk(node.args[0])
                     if isinstance(s, ast.Constant)
                     and isinstance(s.value, str)), "?")
                key = repr(key_const)
            out.append(Finding(
                "cas-blind-meta-write", src.rel, node.lineno,
                f"raw {node.func.attr} on protocol key {key} — "
                f"multi-writer coordination keys go through meta_cas "
                f"or the versioned store"))

        # ---- cas-put-foreign-version / cas-epoch-nonmonotone /
        # ---- cas-lease-raw (per function) --------------------------
        for fn in _functions(src.tree):
            tainted = None  # computed lazily per function
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and (
                        _config_recv(node, "put")
                        or _config_recv(node, "delete")):
                    base = next((kw.value for kw in node.keywords
                                 if kw.arg == "base_version"), None)
                    if base is None and node.func.attr == "delete" \
                            and len(node.args) >= 2:
                        base = node.args[1]
                    if base is None:
                        continue  # create-only put: CAS by absence
                    if isinstance(base, ast.Constant) \
                            and base.value is None:
                        continue
                    if tainted is None:
                        tainted = _tainted_names(fn)
                    names = [s.id for s in ast.walk(base)
                             if isinstance(s, ast.Name)]
                    if not names or any(n not in tainted
                                        for n in names):
                        bad = [n for n in names if n not in tainted]
                        out.append(Finding(
                            "cas-put-foreign-version", src.rel,
                            node.lineno,
                            f"base_version of {node.func.attr} does "
                            f"not derive from a config.get read in "
                            f"this function"
                            + (f" (foreign: {', '.join(sorted(set(bad)))})"
                               if bad else " (constant version)")))

                if protocol_module and isinstance(
                        node, (ast.Assign, ast.AugAssign)):
                    targets = (node.targets
                               if isinstance(node, ast.Assign)
                               else [node.target])
                    if not any(_epoch_target(t) for t in targets):
                        continue
                    if isinstance(node, ast.AugAssign):
                        monotone = isinstance(node.op, ast.Add)
                    else:
                        monotone = _epoch_rhs_monotone(node.value)
                    if not monotone and not _has_epoch_guard(fn):
                        out.append(Finding(
                            "cas-epoch-nonmonotone", src.rel,
                            node.lineno,
                            f"epoch assigned in {fn.name} from a "
                            f"non-monotone source with no epoch "
                            f"comparison guard in scope — fencing "
                            f"breaks if an epoch can move backwards"))

                if isinstance(node, ast.Compare):
                    sides = [node.left] + list(node.comparators)
                    age_side = any(_mentions(s, _AGE_TOKENS)
                                   and not _mentions(s, _INTERVAL_TOKENS)
                                   for s in sides)
                    ivl_side = any(_mentions(s, _INTERVAL_TOKENS)
                                   for s in sides)
                    if age_side and ivl_side:
                        out.append(Finding(
                            "cas-lease-raw", src.rel, node.lineno,
                            "heartbeat age compared against raw "
                            "interval arithmetic — use the clamped "
                            "lease (placer clamps lease_ms to >= 3x "
                            "interval at construction)"))
    return out
