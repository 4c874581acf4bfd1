"""Blocking-in-hot-path pass.

Hot contexts (inferred from the tree's own structure, not a hand list):

  * gRPC handler methods — PascalCase methods of classes whose name
    ends in `Servicer` or `Service` (the wire surface; a blocked
    handler pins one of the server's worker threads);
  * the Prometheus scrape path — every top-level function of
    `hstream_tpu_torch/stats/prometheus.py` (scrapes run on monitoring
    cadence and must stay O(live subsystems));
  * worker loops — `run()` methods of `threading.Thread` subclasses
    and any function named `*_loop` (they own a latency budget per
    tick; an unbounded block stalls the whole pipeline stage).

Flagged inside a hot context (`blocking-hot`):

  * `time.sleep(...)` — poll with a timed Event.wait instead;
  * `subprocess.*` / `os.system` / `os.popen`;
  * file/dir I/O: builtin `open`, `os.walk`, `os.scandir`,
    `os.listdir`, `os.path.getsize`, `shutil.*`;
  * socket construction/connect;
  * unbounded waits: `.acquire()`, `.join()`, `.result()`, `.get()`,
    `.put()`, `.wait()` with no timeout argument.

Nested `def`s inside a hot function are skipped — they execute on
other threads (callbacks, drain threads) with their own context.

Carve-out: ``time.sleep`` inside methods of classes whose
name ends in ``Supervisor`` is sanctioned — a supervisor's dedicated
restart thread OWNS its latency budget; backoff sleeps between restart
attempts are the mechanism, not a stall. Every other blocking call in
a supervisor is still flagged.
"""

from __future__ import annotations

import ast

from hstream_tpu_torch.tools.analyze import Finding
from hstream_tpu_torch.tools.analyze.passes import call_name, has_timeout, walk_classes

NAME = "blocking"

RULES = {
    "blocking-hot": (
        "blocking call (sleep / subprocess / file I/O / unbounded "
        "acquire-join-result-get-wait) inside a gRPC handler, the "
        "Prometheus scrape path, or a worker loop"),
}

_SCRAPE_FILE = "hstream_tpu_torch/stats/prometheus.py"
# the files this pass names (the framework checks the tree holds them)
PATHS = (_SCRAPE_FILE,)

# dotted-call suffixes that block outright
_HARD_BLOCK = {
    "time.sleep": "time.sleep",
    "os.system": "os.system",
    "os.popen": "os.popen",
    "os.walk": "directory walk",
    "os.scandir": "directory scan",
    "os.listdir": "directory listing",
    "os.path.getsize": "file stat",
    "socket.create_connection": "socket connect",
}
_HARD_PREFIX = ("subprocess.", "shutil.")

# method names that block unless a timeout bounds them; value = how
# many positional args imply a bound (Event.wait(0.5) -> 1)
_UNBOUNDED = {"acquire": 1, "join": 1, "result": 1, "get": 1, "put": 2,
              "wait": 1}
# receivers whose .get/.put/.join are not queue/thread waits
_SAFE_RECV_SUFFIX = (".headers", ".environ", "os.environ", "kwargs",
                     "args")


def _thread_subclasses(files) -> set[tuple[str, str]]:
    """(rel, class name) of every threading.Thread subclass."""
    out = set()
    for src in files:
        for cls in walk_classes(src.tree):
            for base in cls.bases:
                name = (base.attr if isinstance(base, ast.Attribute)
                        else base.id if isinstance(base, ast.Name)
                        else "")
                if name == "Thread":
                    out.add((src.rel, cls.name))
    return out


def _hot_functions(src, thread_classes):
    """Yield (fn, why, allow_sleep) for every hot context in one
    file; allow_sleep marks supervisor backoff threads (carve-out)."""
    if src.rel == _SCRAPE_FILE:
        for node in src.tree.body:
            if isinstance(node, ast.FunctionDef):
                yield node, "prometheus scrape path", False
    for cls in walk_classes(src.tree):
        servicer = cls.name.endswith(("Servicer", "Service"))
        threaded = (src.rel, cls.name) in thread_classes
        # supervisor restart threads own their latency budget: backoff
        # sleeps between restart attempts are sanctioned
        supervisor = cls.name.endswith("Supervisor")
        for node in cls.body:
            if not isinstance(node, ast.FunctionDef):
                continue
            if servicer and node.name[:1].isupper():
                yield node, f"gRPC handler {cls.name}.{node.name}", False
            elif threaded and node.name == "run":
                yield node, f"worker loop {cls.name}.run", supervisor
            elif node.name.endswith("_loop"):
                yield (node, f"worker loop {cls.name}.{node.name}",
                       supervisor)
    for node in src.tree.body:
        if isinstance(node, ast.FunctionDef) \
                and node.name.endswith("_loop") and src.rel != _SCRAPE_FILE:
            yield node, f"worker loop {node.name}", False


class _BlockScan(ast.NodeVisitor):
    def __init__(self, src, why: str, allow_sleep: bool = False):
        self.src = src
        self.why = why
        self.allow_sleep = allow_sleep
        self.findings: list[Finding] = []

    def visit_FunctionDef(self, node):  # noqa: N802 — other threads
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def visit_Call(self, node: ast.Call):  # noqa: N802
        name = call_name(node) or ""
        leaf = name.split(".")[-1]
        hit: str | None = None
        if name == "time.sleep" and self.allow_sleep:
            hit = None  # supervisor backoff carve-out
        elif name in _HARD_BLOCK:
            hit = _HARD_BLOCK[name]
        elif name.startswith(_HARD_PREFIX):
            hit = name
        elif name == "open" or name.endswith(".open"):
            hit = "file open"
        elif leaf in _UNBOUNDED and "." in name:
            # string ``sep.join`` literals never parse as dotted Name
            # chains (dotted() needs a Name root), so only real waits
            # reach this branch
            recv = name.rsplit(".", 1)[0]
            if (not has_timeout(node, _UNBOUNDED[leaf])
                    and not recv.endswith(_SAFE_RECV_SUFFIX)):
                hit = f"unbounded {leaf}()"
        if hit is not None:
            self.findings.append(Finding(
                "blocking-hot", self.src.rel, node.lineno,
                f"{hit} via {name or leaf}(...) in {self.why}"))
        self.generic_visit(node)


def run(files, repo) -> list[Finding]:
    thread_classes = _thread_subclasses(files)
    out: list[Finding] = []
    for src in files:
        seen: set[int] = set()
        for fn, why, allow_sleep in _hot_functions(src, thread_classes):
            if id(fn) in seen:
                continue
            seen.add(id(fn))
            scan = _BlockScan(src, why, allow_sleep)
            for stmt in fn.body:
                scan.visit(stmt)
            out.extend(scan.findings)
    return out
