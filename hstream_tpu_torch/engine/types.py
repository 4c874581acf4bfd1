"""Columnar record batches: the host<->device data format (a copy of
hstream_tpu/engine/types.py).

JSON records (dicts decoded from HStreamRecord payloads) are staged into
fixed-capacity columnar batches. Numeric fields become float32/int32
columns; strings are dictionary-encoded to int32 ids against a per-field
host dictionary (device code only ever compares ids). Batch capacity is
rounded up to a power of two so kernels see a handful of shapes.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import numpy as np


class ColumnType(enum.Enum):
    FLOAT = "float"    # float32 on device
    INT = "int"        # int32 on device
    BOOL = "bool"
    STRING = "string"  # dictionary-encoded int32 ids


_NP_DTYPE = {
    ColumnType.FLOAT: np.float32,
    ColumnType.INT: np.int32,
    ColumnType.BOOL: np.bool_,
    ColumnType.STRING: np.int32,
}


@dataclass(frozen=True)
class Schema:
    """Ordered field name -> type mapping for one stream."""

    fields: tuple[tuple[str, ColumnType], ...]

    @staticmethod
    def of(**kw: ColumnType) -> "Schema":
        return Schema(tuple(kw.items()))

    def names(self) -> list[str]:
        return [n for n, _ in self.fields]

    def type_of(self, name: str) -> ColumnType:
        for n, t in self.fields:
            if n == name:
                return t
        raise KeyError(name)

    def has(self, name: str) -> bool:
        return any(n == name for n, _ in self.fields)


class StringDictionary:
    """Per-field host dictionary: string value <-> dense int32 id."""

    def __init__(self) -> None:
        self._to_id: dict[str, int] = {}
        self._values: list[str] = []

    def encode(self, value: str) -> int:
        i = self._to_id.get(value)
        if i is None:
            i = len(self._values)
            self._to_id[value] = i
            self._values.append(value)
        return i

    def lookup(self, value: str) -> int:
        """Encode without inserting; -1 when unseen (for literal compares)."""
        return self._to_id.get(value, -1)

    def decode(self, idx: int) -> str:
        return self._values[idx]

    def __len__(self) -> int:
        return len(self._values)


def canon_key(key: tuple) -> tuple:
    """Canonicalize a group-key tuple: float values round-trip through
    float32 so JSON-producer rows (python floats) and columnar batches
    (f32 columns) agree on group identity — 20.1 and f32(20.1) must be
    ONE group, not two."""
    if any(isinstance(v, float) for v in key):
        return tuple(float(np.float32(v)) if isinstance(v, float) else v
                     for v in key)
    return key


def round_up_pow2(n: int, lo: int = 256) -> int:
    cap = lo
    while cap < n:
        cap *= 2
    return cap


@dataclass
class HostBatch:
    """A columnar batch on host, padded to `capacity` rows.

    `ts_ms` carries absolute epoch milliseconds (int64, host only); the
    executor converts to device-relative int32 before the jitted step.
    """

    schema: Schema
    capacity: int
    n: int
    ts_ms: np.ndarray                     # int64 [capacity]
    valid: np.ndarray                     # bool  [capacity]
    cols: dict[str, np.ndarray]           # per field, [capacity]
    nulls: dict[str, np.ndarray]          # per field, bool [capacity], True=missing

    @staticmethod
    def from_rows(schema: Schema, rows: Sequence[Mapping[str, Any]],
                  ts_ms: Sequence[int],
                  dicts: Mapping[str, StringDictionary],
                  capacity: int | None = None) -> "HostBatch":
        n = len(rows)
        cap = capacity or round_up_pow2(n)
        valid = np.zeros(cap, dtype=np.bool_)
        valid[:n] = True
        ts = np.zeros(cap, dtype=np.int64)
        ts[:n] = np.asarray(ts_ms, dtype=np.int64)
        cols: dict[str, np.ndarray] = {}
        nulls: dict[str, np.ndarray] = {}
        for name, ctype in schema.fields:
            arr = np.zeros(cap, dtype=_NP_DTYPE[ctype])
            null = np.zeros(cap, dtype=np.bool_)
            if ctype == ColumnType.STRING:
                d = dicts[name]
                for i, row in enumerate(rows):
                    v = row.get(name)
                    if v is None:
                        arr[i] = -1
                        null[i] = True
                    else:
                        arr[i] = d.encode(str(v))
            else:
                for i, row in enumerate(rows):
                    v = row.get(name)
                    if v is None or not isinstance(v, (int, float, bool)):
                        null[i] = True
                    else:
                        arr[i] = v
            cols[name] = arr
            nulls[name] = null
        return HostBatch(schema=schema, capacity=cap, n=n, ts_ms=ts,
                         valid=valid, cols=cols, nulls=nulls)
