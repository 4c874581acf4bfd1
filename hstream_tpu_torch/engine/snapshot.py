"""Operator-state snapshots: serialize / restore executor state (the port
of hstream_tpu/engine/snapshot.py).

The FULL operator state of a running query — lattice planes, key
dictionary, string dictionaries, epoch/watermark/open windows, session
state, join side-stores — serializes to one blob, so a restarted query
resumes exactly where the snapshot was taken (the reference checkpoints
only reader positions and re-aggregates from them).

Wire format, byte-compatible with the reference both ways: a single .npz
container; entry "__meta__" is UTF-8 JSON (uint8 array), the remaining
entries are numpy arrays referenced from the meta (the lattice planes as
"s/<plane>" with the reference's names and dtypes). Nested executors (a
join's inner aggregate) embed their own npz blob as a uint8 array. A blob
written to storage is sealed (magic + crc32 + length), so a torn or
bit-rotted write is detected at restore.

Unlike the reference's jax arrays, the port's planes are updated in place
by every step, close and rebase. So `capture_executor` clones each plane
on the stream the steps run on (after every step already queued there),
and the capture stays the state of the moment it was taken while later
steps run; `serialize_capture` fetches the clones. Restore installs the
planes on the executor's device (convert.state_from_numpy) into an
executor built by its constructor, which already made its staging
buffers, streams and counters. Sharded executors (the reference's
`mesh`, `_merge_partials` / `_scatter_state`) wait for ROADMAP A11.
"""

from __future__ import annotations

import io
import json
import math
import struct
import zlib
from typing import Any

import numpy as np
import torch

from hstream_tpu_torch.common.errors import (
    NotPortedError,
    SQLCodegenError,
    StoreError,
)
from hstream_tpu_torch.engine.types import ColumnType, Schema, StringDictionary

SNAPSHOT_VERSION = 1

# ---- CRC-sealed blob framing ------------------------------------------------

SEAL_MAGIC = b"HSNP1\x00"
_SEAL_HEADER = len(SEAL_MAGIC) + 8  # + u32 crc + u32 length


class SnapshotCorrupt(StoreError):
    """A sealed snapshot blob failed its integrity check."""


def seal_blob(blob: bytes) -> bytes:
    """Frame a snapshot blob with magic + crc32 + length."""
    return (SEAL_MAGIC
            + struct.pack("<II", zlib.crc32(blob) & 0xFFFFFFFF,
                          len(blob))
            + blob)


def open_blob(data: bytes) -> bytes:
    """Verify and unwrap a sealed blob. Legacy blobs (pre-seal raw npz,
    which always starts with the zip magic ``PK``) pass through
    unverified. Raises SnapshotCorrupt on truncation or checksum
    mismatch."""
    if data.startswith(b"PK"):
        return data  # legacy unsealed npz
    if not data.startswith(SEAL_MAGIC):
        raise SnapshotCorrupt(
            f"snapshot blob has neither seal nor npz magic "
            f"({data[:6]!r})")
    if len(data) < _SEAL_HEADER:
        raise SnapshotCorrupt("snapshot blob truncated inside header")
    crc, length = struct.unpack_from("<II", data, len(SEAL_MAGIC))
    blob = data[_SEAL_HEADER:]
    if len(blob) != length:
        raise SnapshotCorrupt(
            f"snapshot blob truncated: {len(blob)} of {length} bytes")
    if (zlib.crc32(blob) & 0xFFFFFFFF) != crc:
        raise SnapshotCorrupt("snapshot blob checksum mismatch")
    return blob


# ---- tagged JSON for scalars JSON cannot carry ------------------------------

def _enc(v: Any) -> Any:
    if isinstance(v, np.ndarray):
        return {"__nd__": v.dtype.str, "d": v.tolist()}
    if isinstance(v, tuple):
        return {"__tp__": [_enc(x) for x in v]}
    if isinstance(v, float) and math.isinf(v):
        return {"__inf__": 1 if v > 0 else -1}
    if isinstance(v, dict):
        return {k: _enc(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_enc(x) for x in v]
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


def _dec(v: Any) -> Any:
    if isinstance(v, dict):
        if "__nd__" in v:
            return np.asarray(v["d"], dtype=np.dtype(v["__nd__"]))
        if "__tp__" in v:
            return tuple(_dec(x) for x in v["__tp__"])
        if "__inf__" in v:
            return math.inf if v["__inf__"] > 0 else -math.inf
        return {k: _dec(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_dec(x) for x in v]
    return v


def _pack(meta: dict, arrays: dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    meta_bytes = np.frombuffer(json.dumps(meta).encode("utf-8"),
                               dtype=np.uint8)
    np.savez(buf, __meta__=meta_bytes, **arrays)
    return buf.getvalue()


def _unpack(blob: bytes) -> tuple[dict, dict[str, np.ndarray]]:
    with np.load(io.BytesIO(blob)) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode("utf-8"))
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return meta, arrays


def _host(v: Any) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.cpu().numpy()
    return np.asarray(v)


# ---- executor dispatch ------------------------------------------------------

def capture_executor(ex, extra: dict | None = None
                     ) -> tuple[dict, dict[str, Any]]:
    """Phase 1: take a CONSISTENT capture of an executor's state, cheap
    enough to run under the executor's state lock: the lattice planes
    are cloned on the card (ordered after the steps already queued, no
    host sync), host structures are copied or encoded. The device->host
    fetch and the npz packing happen in serialize_capture()."""
    from hstream_tpu_torch.engine.executor import QueryExecutor
    from hstream_tpu_torch.engine.join import JoinExecutor, TableJoinExecutor
    from hstream_tpu_torch.engine.session import SessionExecutor
    from hstream_tpu_torch.engine.stateless import StatelessExecutor

    if isinstance(ex, QueryExecutor):
        meta, arrays = _lattice_state(ex)
    elif isinstance(ex, SessionExecutor):
        meta, arrays = _session_state(ex), {}
    elif isinstance(ex, TableJoinExecutor):
        meta, arrays = _table_join_state(ex)
    elif isinstance(ex, JoinExecutor):
        meta, arrays = _join_state(ex)
    elif isinstance(ex, StatelessExecutor):
        meta, arrays = {"kind": "stateless"}, {}
    else:
        raise SQLCodegenError(
            f"cannot snapshot {type(ex).__name__}")
    meta["version"] = SNAPSHOT_VERSION
    meta["extra"] = extra or {}
    return meta, arrays


def serialize_capture(meta: dict, arrays: dict[str, Any]) -> bytes:
    """Phase 2: heavy serialization of a capture (no lock needed)."""
    return _pack(meta, {k: _host(v) for k, v in arrays.items()})


def snapshot_executor(ex, extra: dict | None = None) -> bytes:
    """Serialize any executor's state to bytes. `extra` (JSON-able, e.g.
    the read checkpoints this state corresponds to) rides in the blob so
    the state/checkpoint pair is one atomic write."""
    meta, arrays = capture_executor(ex, extra)
    return serialize_capture(meta, arrays)


def restore_executor(plan, blob: bytes, *, initial_keys: int = 1024,
                     batch_capacity: int = 4096, mesh=None, device=None):
    """Rebuild an executor from a snapshot blob for a lowered SELECT plan,
    on `device` (the card unless "cpu" is given). Returns (executor,
    extra). A `mesh` (restore into a sharded executor) is not ported."""
    if mesh is not None:
        raise NotPortedError("sharded restore (mesh=)", "A11")
    meta, arrays = _unpack(blob)
    ver = meta.get("version")
    if ver != SNAPSHOT_VERSION:
        raise SQLCodegenError(
            f"snapshot format version {ver!r} != supported "
            f"{SNAPSHOT_VERSION}; refusing to deserialize")
    kind = meta["kind"]
    if kind == "tablejoin":
        ex = _restore_table_join(plan, meta, arrays,
                                 initial_keys=initial_keys,
                                 batch_capacity=batch_capacity,
                                 device=device)
    elif kind == "join":
        ex = _restore_join(plan, meta, arrays, initial_keys=initial_keys,
                           batch_capacity=batch_capacity, device=device)
    elif kind == "lattice":
        ex = _restore_lattice(plan.node, meta, arrays,
                              batch_capacity=batch_capacity, device=device)
    elif kind == "session":
        ex = _restore_session(plan.node, meta, device=device)
    elif kind == "stateless":
        from hstream_tpu_torch.engine.stateless import StatelessExecutor

        ex = StatelessExecutor(plan.node)
    else:
        raise SQLCodegenError(f"unknown snapshot kind {kind!r}")
    return ex, meta.get("extra", {})


# ---- lattice (QueryExecutor) ------------------------------------------------

def _lattice_state(ex) -> tuple[dict, dict[str, torch.Tensor]]:
    if ex._pending_closes:
        raise SQLCodegenError(
            "snapshot with deferred closes pending; drain_closed() first")
    if ex._pending_changes or ex._drain_futs:
        # the touched mask was already cleared on the device: the queued
        # extracts (and any in-flight async drains) are the ONLY copy of
        # those change rows
        raise SQLCodegenError(
            "snapshot with deferred changes pending; flush_changes() "
            "first")
    meta = {
        "kind": "lattice",
        "n_keys": ex.spec.n_keys,
        "batch_capacity": ex.batch_capacity,
        "epoch": ex.epoch,
        "watermark_abs": ex.watermark_abs,
        "emit_changes": ex.emit_changes,
        "open": [[s, ow.slot] for s, ow in sorted(ex._open.items())],
        "key_rev": [_enc(k) for k in ex._key_rev],
        "dicts": {name: list(d._values) for name, d in ex.dicts.items()},
        "null_sticky": sorted(ex._null_sticky),
        "schema": [[n, t.value] for n, t in ex.schema.fields],
    }
    # the planes change in place under later steps: clone them on the
    # current stream, behind every step already queued there
    arrays = {f"s/{k}": v.clone() for k, v in ex.state.items()}
    return meta, arrays


def _restore_lattice(node, meta, arrays, *, batch_capacity: int = 4096,
                     device=None):
    from hstream_tpu_torch.engine import convert
    from hstream_tpu_torch.engine.executor import QueryExecutor, _OpenWindow

    schema = Schema(tuple((n, ColumnType(t)) for n, t in meta["schema"]))
    cap = meta.get("batch_capacity", batch_capacity)
    ex = QueryExecutor(node, schema, emit_changes=meta["emit_changes"],
                       initial_keys=meta["n_keys"], batch_capacity=cap,
                       device=device)
    # __init__ re-encodes string literals deterministically (same node,
    # same schema => same dictionary prefix), so overwriting the dict
    # contents with the snapshot's (literals + runtime values, in the
    # original insertion order) keeps compiled literal ids consistent.
    for name, values in meta["dicts"].items():
        d = StringDictionary()
        for v in values:
            d.encode(v)
        ex.dicts[name] = d
    ex._key_rev = [tuple(_dec(k)) for k in meta["key_rev"]]
    ex._key_ids = {k: i for i, k in enumerate(ex._key_rev)}
    ex.epoch = meta["epoch"]
    ex.watermark_abs = meta["watermark_abs"]
    ex._open = {s: _OpenWindow(start_abs=s, slot=slot)
                for s, slot in meta["open"]}
    ex._null_sticky = set(meta["null_sticky"])
    canonical = {k[len("s/"):]: v
                 for k, v in arrays.items() if k.startswith("s/")}
    state = convert.state_from_numpy(canonical, ex.device)
    if set(state) != set(ex.state) or any(
            (state[k].shape, state[k].dtype)
            != (ex.state[k].shape, ex.state[k].dtype) for k in state):
        raise SQLCodegenError(
            "snapshot lattice planes do not match this plan's lattice")
    ex.state = state
    ex.read_epoch += 1
    return ex


# ---- session ----------------------------------------------------------------

def _session_state(ex) -> dict:
    if ex._pending_closes:
        # the deferred extract buffers are the ONLY copy of those
        # closed-session rows (mirror entries already retired)
        raise SQLCodegenError(
            "snapshot with deferred session closes pending; "
            "drain_closed() first")
    # device-resident sessions serialize through the host-format view
    # (one fetch per plane + acc decode); restore rebuilds the host
    # engine and the device path re-activates and re-migrates on the
    # next batch, like the join store
    src = ex._host_sessions_view() if ex._dev is not None else ex.sessions
    sessions = [
        {"k": _enc(key),
         "s": [{"a": s.start, "b": s.end, "acc": _enc(s.accs)}
               for s in sess_list]}
        for key, sess_list in src.items()
    ]
    return {
        "kind": "session",
        "watermark": ex.watermark,
        "emit_changes": ex.emit_changes,
        "schema": [[n, t.value] for n, t in ex.schema.fields],
        "sessions": sessions,
    }


def _restore_session(node, meta, device=None):
    """The blob holds the host view: the restored executor starts on the
    host engine and its device path activates (migrating these sessions
    into a fresh arena) on the next batch."""
    from hstream_tpu_torch.engine.session import SessionExecutor, _Session

    schema = Schema(tuple((n, ColumnType(t)) for n, t in meta["schema"]))
    ex = SessionExecutor(node, schema, emit_changes=meta["emit_changes"],
                         device=device)
    ex.watermark = meta["watermark"]
    for ent in meta["sessions"]:
        key = tuple(_dec(ent["k"]))
        ex.sessions[key] = [
            _Session(start=s["a"], end=s["b"], accs=_dec(s["acc"]))
            for s in ent["s"]]
    return ex


# ---- stream-table join ------------------------------------------------------

def _table_join_state(ex) -> tuple[dict, dict[str, np.ndarray]]:
    meta = {
        "kind": "tablejoin",
        "batch_capacity": ex._batch_capacity,
        "table": [{"k": _enc(key), "t": ts, "r": row}
                  for key, (ts, row) in ex.table.items()],
    }
    arrays = {}
    if ex._inner is not None:
        arrays["i/blob"] = np.frombuffer(snapshot_executor(ex._inner),
                                         dtype=np.uint8)
    return meta, arrays


def _restore_table_join(plan, meta, arrays, *, initial_keys: int,
                        batch_capacity: int, device=None):
    from hstream_tpu_torch.engine.join import TableJoinExecutor

    ex = TableJoinExecutor(plan, initial_keys=initial_keys,
                           batch_capacity=meta.get("batch_capacity",
                                                   batch_capacity),
                           device=device)
    for ent in meta["table"]:
        ex.table[tuple(_dec(ent["k"]))] = (int(ent["t"]), ent["r"])
    if "i/blob" in arrays:
        inner, _ = restore_executor(ex._inner_plan,
                                    arrays["i/blob"].tobytes(),
                                    initial_keys=initial_keys,
                                    batch_capacity=batch_capacity,
                                    device=ex.device)
        ex._inner = inner
        ex._apply_inner_tuning()
    return ex


# ---- interval join ----------------------------------------------------------

def _join_state(ex) -> tuple[dict, dict[str, np.ndarray]]:
    if ex._staged or ex._pending_matches:
        # coalesced matches / deferred device match buffers live outside
        # the inner executor's state; the owning runtime must
        # flush_staged() (sinking the emitted rows) before a snapshot
        raise SQLCodegenError(
            "snapshot with coalesced join matches staged; "
            "flush_staged() first")

    def dump_store(store):
        return [{"k": _enc(key), "t": tss, "r": rows}
                for key, (tss, rows) in store.by_key.items()]

    # device-resident stores serialize through the host view (fetch +
    # row reconstruction from the packed needed columns); restore
    # refills the host stores and the device re-activates and
    # re-migrates on the next batch
    stores = ex._host_store_view()
    meta = {
        "kind": "join",
        "batch_capacity": ex._batch_capacity,
        "watermark": ex.watermark,
        "stores": {side: dump_store(st) for side, st in stores.items()},
    }
    arrays = {}
    if ex._inner is not None:
        inner_blob = snapshot_executor(ex._inner)
        arrays["i/blob"] = np.frombuffer(inner_blob, dtype=np.uint8)
    return meta, arrays


def _restore_join(plan, meta, arrays, *, initial_keys: int,
                  batch_capacity: int, device=None):
    from hstream_tpu_torch.engine.join import JoinExecutor

    ex = JoinExecutor(plan, initial_keys=initial_keys,
                      batch_capacity=meta.get("batch_capacity",
                                              batch_capacity),
                      device=device)
    ex.watermark = meta["watermark"]
    for side, ents in meta["stores"].items():
        codes: list[int] = []
        tss: list[int] = []
        rows: list = []
        for ent in ents:
            key = tuple(_dec(ent["k"]))
            c = ex._jcode.get(key)
            if c is None:
                c = len(ex._jcode_rev)
                ex._jcode[key] = c
                ex._jcode_rev.append(key)
            for t, r in zip(ent["t"], ent["r"]):
                codes.append(c)
                tss.append(int(t))
                rows.append(r)
        if not codes:
            continue
        code_a = np.asarray(codes, np.int64)
        ts_a = np.asarray(tss, np.int64)
        rows_a = np.empty(len(rows), object)
        rows_a[:] = rows
        order = np.lexsort((ts_a, code_a))
        ex._stores[side].insert_sorted(code_a[order], ts_a[order],
                                       rows_a[order])
    if "i/blob" in arrays:
        inner, _ = restore_executor(ex._inner_plan,
                                    arrays["i/blob"].tobytes(),
                                    initial_keys=initial_keys,
                                    batch_capacity=batch_capacity,
                                    device=ex.device)
        ex._inner = inner
        ex._apply_inner_tuning()
    return ex
