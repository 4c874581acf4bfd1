"""Error-contract pass: server-emitted gRPC statuses, the gateway's
HTTP mapping, and the client's retry classification must agree.

The emitted set is computed from the tree, both ways the server emits:

  * typed errors — every `HStreamError` subclass in common/errors.py
    (its `grpc_status`, resolved through the class hierarchy) that is
    actually `raise`d somewhere in production code (handlers catch
    HStreamError at the boundary and abort with that status);
  * explicit `context.abort(grpc.StatusCode.X, ...)` literals.

Contracts checked:

  err-http        every emitted status has an explicit HTTP mapping in
                  http_gateway's `_STATUS` table (500-by-default hides
                  contract drift: a new status silently becomes a 500);
  err-retry-class every emitted status is classified retryable or not
                  in client/retry.py (RETRYABLE_CODES ∪
                  NON_RETRYABLE_CODES);
  err-dead-retry  every status the client retries on is actually
                  emitted server-side (or is transport-generated:
                  UNAVAILABLE / DEADLINE_EXCEEDED / CANCELLED, which
                  the gRPC runtime raises without server code);
  err-hinted-*    the NOT_LEADER contract: an error class
                  that carries a ``leader_hint`` rides a status the
                  client follows ONLY when the hint is present
                  (HINTED_RETRYABLE_CODES). Three directions: every
                  hint-carrying class's status is in the hinted set
                  (else failover fails the statement instead of
                  following), every hinted code is emitted by some
                  hint-carrying class (no dead hint-follow paths), and
                  every hinted code stays in NON_RETRYABLE_CODES so
                  its BARE form — a mid-call transport drop that may
                  have landed a mutation — is never blanket-retried.
"""

from __future__ import annotations

import ast

from hstream_tpu_torch.tools.analyze import Finding
from hstream_tpu_torch.tools.analyze.passes import dotted

NAME = "errcontract"

RULES = {
    "err-http": (
        "gRPC status emitted by the server has no explicit HTTP "
        "mapping in http_gateway._STATUS"),
    "err-retry-class": (
        "gRPC status emitted by the server is neither in "
        "client.retry.RETRYABLE_CODES nor NON_RETRYABLE_CODES"),
    "err-dead-retry": (
        "client retries a status code no server path emits "
        "(transport-generated codes are exempt)"),
    "err-hinted-unclassified": (
        "status emitted by a leader-hint-carrying error class is not "
        "in client.retry.HINTED_RETRYABLE_CODES (failover would fail "
        "the statement instead of following the hint)"),
    "err-dead-hint": (
        "HINTED_RETRYABLE_CODES contains a status no hint-carrying "
        "error class emits"),
    "err-hinted-bare": (
        "hinted-retryable status is missing from NON_RETRYABLE_CODES "
        "— its bare (hintless) form could be blanket-retried, which "
        "can double-apply a mutation landed by a mid-call drop"),
}

PACKAGE = "hstream_tpu_torch/"
ERRORS_FILE = "hstream_tpu_torch/common/errors.py"
GATEWAY_FILE = "hstream_tpu_torch/http_gateway/__init__.py"
RETRY_FILE = "hstream_tpu_torch/client/retry.py"
# the files this pass names (the framework checks the tree holds them)
PATHS = (ERRORS_FILE, GATEWAY_FILE, RETRY_FILE)

# codes the gRPC runtime itself produces; the client may retry them
# without any server-side abort existing
TRANSPORT_CODES = {"UNAVAILABLE", "DEADLINE_EXCEEDED", "CANCELLED"}


def _status_of(node: ast.AST) -> str | None:
    """'RESOURCE_EXHAUSTED' from a grpc.StatusCode.X expression."""
    d = dotted(node)
    if d and ".StatusCode." in f".{d}":
        return d.rsplit(".", 1)[1]
    return None


def _error_classes(tree: ast.Module) -> dict[str, str]:
    """class name -> resolved grpc status, following single-module
    inheritance; HStreamError defaults INTERNAL."""
    own: dict[str, str | None] = {}
    bases: dict[str, list[str]] = {}
    for node in tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        bases[node.name] = [b.id for b in node.bases
                            if isinstance(b, ast.Name)]
        status = None
        for stmt in node.body:
            if isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    if isinstance(t, ast.Name) and t.id == "grpc_status":
                        status = _status_of(stmt.value)
        own[node.name] = status

    def resolve(name: str, depth: int = 0) -> str:
        if depth > 10 or name not in own:
            return "INTERNAL"
        if own[name]:
            return own[name]  # type: ignore[return-value]
        for b in bases.get(name, ()):
            if b in own:
                return resolve(b, depth + 1)
        return "INTERNAL"

    return {name: resolve(name) for name in own}


def _hint_classes(tree: ast.Module) -> set[str]:
    """Error classes that carry a leader hint: any method assigns
    ``self.leader_hint`` (the NOT_LEADER shape)."""
    out: set[str] = set()
    for node in tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        for sub in ast.walk(node):
            if (isinstance(sub, ast.Attribute)
                    and isinstance(sub.ctx, ast.Store)
                    and sub.attr == "leader_hint"
                    and isinstance(sub.value, ast.Name)
                    and sub.value.id == "self"):
                out.add(node.name)
                break
    return out


def _emitted(files, classes: dict[str, str], *,
             include_aborts: bool = True) -> dict[str, tuple[str, int]]:
    """status -> one representative (path, line) where it is emitted.
    `include_aborts=False` restricts to raises of `classes` (the
    hinted-contract check scopes emission to hint-carrying classes)."""
    out: dict[str, tuple[str, int]] = {}
    for src in files:
        if not src.rel.startswith(PACKAGE):
            continue
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Raise) and node.exc is not None:
                exc = node.exc
                name = (dotted(exc.func) if isinstance(exc, ast.Call)
                        else dotted(exc))
                leaf = (name or "").split(".")[-1]
                if leaf in classes:
                    out.setdefault(classes[leaf], (src.rel, node.lineno))
            elif include_aborts and isinstance(node, ast.Call):
                cn = dotted(node.func) or ""
                if cn.endswith(".abort") and node.args:
                    st = _status_of(node.args[0])
                    if st is not None:
                        out.setdefault(st, (src.rel, node.lineno))
    return out


def _gateway_map(src) -> tuple[set[str], int]:
    codes: set[str] = set()
    line = 1
    for node in src.tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "_STATUS"
                for t in node.targets):
            line = node.lineno
            if isinstance(node.value, ast.Dict):
                for k in node.value.keys:
                    st = _status_of(k) if k is not None else None
                    if st:
                        codes.add(st)
    return codes, line


def _retry_sets(src) -> tuple[dict[str, set[str]], int]:
    out: dict[str, set[str]] = {"RETRYABLE_CODES": set(),
                                "NON_RETRYABLE_CODES": set(),
                                "HINTED_RETRYABLE_CODES": set()}
    line = 1
    for node in src.tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id in out:
                    line = node.lineno
                    for sub in ast.walk(node.value):
                        st = _status_of(sub)
                        if st:
                            out[t.id].add(st)
    return out, line


# NOTE: messages are baseline keys (rule, path, message) — they name the
# emitting FILE but never a line number, so unrelated edits shifting a
# line cannot resurrect a grandfathered finding.


def run(files, repo) -> list[Finding]:
    by_rel = {f.rel: f for f in files}
    errors = by_rel.get(ERRORS_FILE)
    gateway = by_rel.get(GATEWAY_FILE)
    retry = by_rel.get(RETRY_FILE)
    if errors is None or gateway is None or retry is None:
        return []  # fixture runs without the real tree
    classes = _error_classes(errors.tree)
    emitted = _emitted(files, classes)
    http_codes, http_line = _gateway_map(gateway)
    retry_sets, retry_line = _retry_sets(retry)
    classified = retry_sets["RETRYABLE_CODES"] \
        | retry_sets["NON_RETRYABLE_CODES"]

    out: list[Finding] = []
    for st, (path, _line) in sorted(emitted.items()):
        if st not in http_codes:
            out.append(Finding(
                "err-http", GATEWAY_FILE, http_line,
                f"status {st} (emitted in {path}) has no "
                f"HTTP mapping in _STATUS"))
        if st not in classified:
            out.append(Finding(
                "err-retry-class", RETRY_FILE, retry_line,
                f"status {st} (emitted in {path}) is not "
                f"classified retryable/non-retryable"))
    for st in sorted(retry_sets["RETRYABLE_CODES"]):
        if st not in emitted and st not in TRANSPORT_CODES:
            out.append(Finding(
                "err-dead-retry", RETRY_FILE, retry_line,
                f"client retries {st} but no server path emits it"))
    # the NOT_LEADER hinted contract: statuses followable
    # only WITH a leader hint agree with the hint-carrying classes
    hinted = retry_sets["HINTED_RETRYABLE_CODES"]
    hint_emitted = _emitted(
        files, {c: s for c, s in classes.items()
                if c in _hint_classes(errors.tree)},
        include_aborts=False)
    for st, (path, _line) in sorted(hint_emitted.items()):
        if st not in hinted:
            out.append(Finding(
                "err-hinted-unclassified", RETRY_FILE, retry_line,
                f"status {st} (hint-carrying, emitted in {path}) is "
                f"not in HINTED_RETRYABLE_CODES"))
    for st in sorted(hinted):
        if st not in hint_emitted:
            out.append(Finding(
                "err-dead-hint", RETRY_FILE, retry_line,
                f"client follows hints on {st} but no hint-carrying "
                f"error class emits it"))
        if st not in retry_sets["NON_RETRYABLE_CODES"]:
            out.append(Finding(
                "err-hinted-bare", RETRY_FILE, retry_line,
                f"hinted status {st} must stay in NON_RETRYABLE_CODES "
                f"(bare form may follow a landed mutation)"))
    return out
