"""Columnar emission (a copy of ColumnarEmit and extend_rows from
hstream_tpu/common/columnar.py).

The wire codec of that module (encode_columnar, to_payload) belongs to
the server's sinks and is ported with them (ROADMAP A5).
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import Any, Mapping

import numpy as np


class ColumnarEmit(Sequence):
    """A batch of emitted aggregate rows kept COLUMNAR until the wire.

    The window-close path finalizes whole slot columns on device; this
    carries the result as named columns (numpy arrays, or object arrays
    for strings / TOPK lists) instead of N per-row dicts. Consumers that
    can stay columnar (the stream sink's columnar record, the native
    codec) read `.cols` directly; everything else sees
    a lazy Sequence of per-row dicts identical to the legacy list shape
    (len / bool / iterate / index / extend-into-a-list all work), so the
    row materialization happens at most once, at the first row-shaped
    consumer — ideally the wire boundary.
    """

    __slots__ = ("cols", "n", "_rows")

    def __init__(self, cols: Mapping[str, Any], n: int):
        self.cols = dict(cols)
        self.n = int(n)
        self._rows: list[dict[str, Any]] | None = None

    def __len__(self) -> int:
        return self.n

    def rows(self) -> list[dict[str, Any]]:
        """Materialize (and cache) the per-row dict view."""
        if self._rows is None:
            names = list(self.cols)
            if not names:
                self._rows = [{} for _ in range(self.n)]
            else:
                pyd = [v.tolist() if isinstance(v, np.ndarray) else list(v)
                       for v in self.cols.values()]
                self._rows = [dict(zip(names, vals))
                              for vals in zip(*pyd)]
        return self._rows

    def __getitem__(self, i):
        return self.rows()[i]

    def __iter__(self):
        return iter(self.rows())

    # list-concat ergonomics: emitted batches historically were plain
    # lists, so `acc += ex.process(...)` and `rows + more` must keep
    # working when either side is a columnar batch (materializes —
    # callers that care use extend_rows to stay columnar)
    def __add__(self, other):
        return self.rows() + list(other)

    def __radd__(self, other):
        return list(other) + self.rows()

    def __repr__(self) -> str:
        return (f"ColumnarEmit(n={self.n}, "
                f"cols={list(self.cols)})")


def extend_rows(acc, rows):
    """Accumulate emitted row batches across pipeline stages while
    keeping a LONE ColumnarEmit columnar: acc is None | list |
    ColumnarEmit; returns the new accumulator. Only when a second batch
    arrives does the first materialize into a plain list — the common
    case (one close cycle per drain) reaches the sink columnar."""
    if rows is None or len(rows) == 0:
        return acc
    if acc is None or (isinstance(acc, list) and not acc):
        return rows
    if not isinstance(acc, list):
        acc = list(acc)
    acc.extend(rows)
    return acc
