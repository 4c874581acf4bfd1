"""Materialized views: registry, materialization store, pull queries.

Reference: each grouped query registers its `Materialized` state in a
global `groupbyStores` IORef (Handler/Common.hs:74-76); a pull query
(`SELECT ... FROM view WHERE k = ...` without EMIT CHANGES) serializes
the key, dumps the state store, filters by key, and for fixed windows
groups rows by winStart with "winStart = .../winEnd = ..." labels
(Handler.hs:277-325).

Here a view's query task runs with emit_changes=False, so process()
returns only CLOSED windows — those append to the materialization's
bounded closed-row store — while the live (open-window) half is the
executor's peek(). A pull query serves closed + live rows with the WHERE
filter and projection applied host-side; winStart/winEnd ride along as
structured fields (richer than the reference's string labels).
"""

# A copy of hstream_tpu/server/views.py; the port imports nothing of the JAX
# package.

from __future__ import annotations

from collections import OrderedDict
from typing import Any

import numpy as np

from hstream_tpu_torch.common import locktrace
from hstream_tpu_torch.common.columnar import ColumnarEmit
from hstream_tpu_torch.common.errors import ViewNotFound
from hstream_tpu_torch.engine.expr import (
    BinOp,
    Col,
    Lit,
    eval_host,
    eval_host_vec,
)
from hstream_tpu_torch.sql import ast


class Materialization:
    """Closed-window rows (bounded, newest kept) + live peek.

    `group_cols` are the plan's actual GROUP BY columns: closed rows are
    keyed on (winStart, group values) so distinct keys of ANY type —
    numeric included — stay distinct. A view over a stateless select has
    no group identity; every row is kept under a sequence key.
    """

    def __init__(self, *, group_cols: list[str] | None = None,
                 max_closed_rows: int = 100_000):
        self._group_cols = group_cols
        self._closed: OrderedDict[tuple, dict[str, Any]] = OrderedDict()
        self._max = max_closed_rows
        self._seq = 0
        # named traced lock: the canonical order is
        # tasks.state BEFORE views.materialization (sink under the
        # task's lock; snapshot takes state_lock first for the same
        # reason) — the armed witness certifies it at runtime
        self._lock = locktrace.lock("views.materialization")
        self.task = None  # set by the owner; .executor gives live state
        # closed-store mutation counter: combined with the
        # executor's read_version this makes an exact validity key for
        # the read cache. Bumped under self._lock; probed lock-free (a
        # torn probe can only cause a spurious cache miss).
        self._version = 0

    def _row_key(self, row: dict[str, Any]) -> tuple:
        # (window, group identity): last write per (winStart, key cols)
        if self._group_cols is None:
            self._seq += 1
            return ("#seq", self._seq)
        return (row.get("winStart"),
                tuple(row.get(c) for c in self._group_cols))

    def add_closed(self, rows: list[dict[str, Any]]) -> None:
        # `rows` may be a columnar close batch (common.columnar
        # ColumnarEmit): the view store is a row-shaped boundary (pull
        # queries serve dicts), so iterating materializes the row view
        # once — cached on the batch, shared with any other row-shaped
        # consumer of the same emission.
        with self._lock:
            changed = False
            for row in rows:
                key = self._row_key(row)
                self._closed.pop(key, None)
                self._closed[key] = row
                changed = True
            while len(self._closed) > self._max:
                self._closed.popitem(last=False)
            if changed:
                self._version += 1

    def dump(self) -> list[dict[str, Any]]:
        """Closed rows in insertion order — rides in the query task's
        operator-state snapshot so the view survives restarts."""
        with self._lock:
            return list(self._closed.values())

    def load(self, rows: list[dict[str, Any]]) -> None:
        self.add_closed(rows)

    def snapshot(self) -> list[dict[str, Any]]:
        task = self.task
        if task is None:
            with self._lock:
                return list(self._closed.values())
        # state_lock around BOTH halves (closed copy + live peek), in the
        # same order the task thread takes them (state_lock -> mat._lock
        # via sink): a window closing between the two reads would
        # otherwise appear in neither half
        with task.state_lock:
            with self._lock:
                rows = list(self._closed.values())
            ex = task.executor
            if ex is not None and hasattr(ex, "peek"):
                rows.extend(ex.peek())
        return rows

    def version(self) -> tuple | None:
        """Lock-free validity probe for the read cache:
        equal tuples guarantee an identical snapshot. Every component
        is a monotone counter bumped AT the mutation, so a torn read
        can only produce a miss or a hit linearized just before an
        in-flight mutation — never a stale hit. None = this view's
        executor has no read versioning; never cache it."""
        task = self.task
        ex = getattr(task, "executor", None) if task is not None else None
        if ex is None:
            # analyze: ok lock-guard — deliberate lock-free monotone probe
            return (self._version, None)
        rv = getattr(ex, "read_version", None)
        if rv is None:
            return None
        exv = rv()
        if exv is None:
            return None
        # analyze: ok lock-guard — deliberate lock-free monotone probe
        return (self._version, exv)

    def snapshot_parts(self, select: ast.Select | None = None
                       ) -> tuple[list[dict[str, Any]], Any,
                                  tuple | None, bool]:
        """One consistent cut of (closed rows, live batch, version,
        peeked) under the task's state lock — the read cache stores the
        version alongside the served result so hits are exact.

        With `select`, the closed-only fast path applies:
        a WHERE that bounds winEnd strictly below every
        live window's earliest possible winEnd is served from the
        materialization store alone — zero executor dispatches — which
        in device mode means the arena is never extracted at all."""
        task = self.task
        if task is None:
            with self._lock:
                return list(self._closed.values()), [], None, False
        with task.state_lock:
            with self._lock:
                closed = list(self._closed.values())
                mver = self._version
            ex = task.executor
            live: Any = []
            peeked = False
            if ex is not None and hasattr(ex, "peek"):
                if not _skip_live(ex, select):
                    live = ex.peek()
                    peeked = True
                rv = getattr(ex, "read_version", None)
                exv = rv() if rv is not None else None
                version = None if exv is None else (mver, exv)
            else:
                version = (mver, None)
        return closed, live, version, peeked


class ViewRegistry:
    """view name -> Materialization (the groupbyStores analogue)."""

    def __init__(self) -> None:
        self._views: dict[str, Materialization] = {}
        self._lock = locktrace.lock("views.registry")

    def register(self, name: str, mat: Materialization) -> None:
        with self._lock:
            self._views[name] = mat

    def get(self, name: str) -> Materialization:
        with self._lock:
            mat = self._views.get(name)
        if mat is None:
            raise ViewNotFound(name)
        return mat

    def remove(self, name: str) -> None:
        with self._lock:
            self._views.pop(name, None)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._views)


def _closed_only_bound(select: ast.Select | None
                       ) -> tuple[float, bool] | None:
    """Tightest upper bound some AND-level WHERE conjunct puts on
    winEnd: (bound, strict) for `winEnd < lit` / `winEnd <= lit` (either
    operand order), None when the WHERE does not bound winEnd. Any row
    violating the conjunct is dropped by the filter regardless of the
    rest of the predicate, so a peek whose every row violates it can be
    skipped exactly."""
    if select is None or select.where is None:
        return None
    flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}
    best: tuple[float, bool] | None = None
    stack = [select.where]
    while stack:
        e = stack.pop()
        if isinstance(e, BinOp) and e.op == "AND":
            stack.extend((e.left, e.right))
            continue
        if not isinstance(e, BinOp) or e.op not in flip:
            continue
        op, lhs, rhs = e.op, e.left, e.right
        if isinstance(rhs, Col) and isinstance(lhs, Lit):
            op, lhs, rhs = flip[op], rhs, lhs
        if not (isinstance(lhs, Col) and lhs.name == "winEnd"
                and lhs.stream is None and isinstance(rhs, Lit)
                and isinstance(rhs.value, (int, float))
                and not isinstance(rhs.value, bool)):
            continue
        if op in ("<", "<="):
            cand = (float(rhs.value), op == "<")
            # tighter = smaller bound; strict beats non-strict at equal
            if best is None or (cand[0], not cand[1]) < (best[0],
                                                         not best[1]):
                best = cand
    return best


def _skip_live(ex, select: ast.Select | None) -> bool:
    """True when the live (peek) half provably contributes nothing to
    this SELECT: the WHERE bounds winEnd below the earliest winEnd any
    live window could emit. Live rows WITHOUT a winEnd field (windowless
    aggregates) fail the winEnd conjunct too (NULL comparison -> not
    true), so a None live_min_win_end also skips."""
    bound = _closed_only_bound(select)
    if bound is None:
        return False
    fn = getattr(ex, "live_min_win_end", None)
    if fn is None:
        return False
    lo = fn()
    if lo is None:
        return True
    val, strict = bound
    return lo >= val if strict else lo > val


def filter_rows(rows: list[dict[str, Any]],
                select: ast.Select) -> list[dict[str, Any]]:
    """WHERE evaluation shared by view pull queries and LDQuery-lite
    virtual tables (NULL operand -> predicate not true, SQL rules)."""
    if select.where is None:
        return rows
    kept = []
    for row in rows:
        try:
            if eval_host(select.where, row):
                kept.append(row)
        except (TypeError, KeyError):
            continue
    return kept


def project_rows(rows: list[dict[str, Any]], select: ast.Select,
                 keep_meta: tuple[str, ...] = ()) -> list[dict[str, Any]]:
    """SELECT-list projection shared by the same two paths; * keeps
    rows as-is. `keep_meta` names ride along when present (the view
    path keeps window bounds)."""
    if select.items is None:
        return rows
    out = []
    for row in rows:
        proj: dict[str, Any] = {}
        for idx, item in enumerate(select.items):
            name = item.alias or item.text or f"col{idx}"
            try:
                proj[name] = eval_host(item.expr, row)
            except (TypeError, KeyError):
                proj[name] = None
        for meta in keep_meta:
            if meta in row:
                proj[meta] = row[meta]
        out.append(proj)
    return out


def _select_emit_cols(emit: ColumnarEmit,
                      select: ast.Select) -> list[dict[str, Any]]:
    """Columnwise WHERE + projection over a live peek batch — one
    vectorized pass instead of a per-row interpreter walk (the
    `_postprocess_cols` discipline from the close path). Raises for the
    exact per-row fallback on any op/NULL the vector evaluator does not
    cover."""
    cols, n = emit.cols, emit.n
    if select.where is not None:
        keep = np.broadcast_to(
            np.asarray(eval_host_vec(select.where, cols), np.bool_),
            (n,))
        if not keep.all():
            cols = {k: np.asarray(v)[keep] for k, v in cols.items()}
            n = int(keep.sum())
            if n == 0:
                return []
    if select.items is None:
        return list(ColumnarEmit(cols, n))
    projected: dict[str, Any] = {}
    for idx, item in enumerate(select.items):
        name = item.alias or item.text or f"col{idx}"
        v = eval_host_vec(item.expr, cols)
        projected[name] = np.broadcast_to(np.asarray(v), (n,)) \
            if np.ndim(v) == 0 else np.asarray(v)
    for meta in ("winStart", "winEnd"):
        if meta in cols:
            projected[meta] = np.asarray(cols[meta])
    return list(ColumnarEmit(projected, n))


def _select_emit(emit, select: ast.Select) -> list[dict[str, Any]]:
    """WHERE + projection over the live half: columnwise when the peek
    stayed columnar, whole-batch per-row fallback (exact SQL NULL /
    missing-field semantics) on anything the vector path cannot prove
    identical."""
    if isinstance(emit, ColumnarEmit):
        if emit.n == 0:
            return []
        try:
            return _select_emit_cols(emit, select)
        except Exception:  # noqa: BLE001 — host-only op / NULLs:
            pass           # exact per-row semantics below
    rows = filter_rows(list(emit), select)
    return project_rows(rows, select, keep_meta=("winStart", "winEnd"))


def serve_parts(closed: list[dict[str, Any]], live,
                select: ast.Select) -> list[dict[str, Any]]:
    """Filter + project both halves, then the fixed-window slicing sort
    (stable, so closed-before-live order at equal winStart matches the
    legacy concat pipeline exactly)."""
    out = project_rows(filter_rows(closed, select), select,
                       keep_meta=("winStart", "winEnd"))
    out.extend(_select_emit(live, select))
    out.sort(key=lambda r: (r.get("winStart") or 0))
    return out


def serve_select_view(mat: Materialization,
                      select: ast.Select) -> list[dict[str, Any]]:
    """Execute a pull query against a materialization
    (reference Handler.hs:277-325: key filter + fixed-window slicing)."""
    closed, live, _version, _peeked = mat.snapshot_parts(select)
    return serve_parts(closed, live, select)
