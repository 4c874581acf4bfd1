"""Carrying state across between the JAX package and the port.

This system runs no model, so its "weights" are a running query's
position: the lattice planes, the epoch, the watermark, the open windows
and the group-key dictionary. A JAX executor's state read out as numpy
(`{k: np.asarray(v) for k, v in ex.state.items()}`) has the port's plane
names and layouts already; these functions move it onto a device and
back, and `adopt` installs a whole position into a port executor, so
both engines fed the same next batches emit the same rows.

For session windows, `session_state` reads a session executor's position
(the JAX package's in device mode, or the port's) as numpy and Python
values — the arena planes, the interval mirror, the code and string
dictionaries, the epoch, the watermark and the last close cycle's
watermark — without importing either package, and `adopt_session` /
`session_from` install it into a port SessionExecutor.

For the interval join, `join_state` reads a device-mode JoinExecutor's
position (both sides' stores, the join epoch, live counts, match width,
eviction mark, the join-key code dictionary and its key-id table, both
host shadows, the watermark, the observed fields and the inner window
executor's position), and `adopt_join` / `join_from` install it into a
port JoinExecutor.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np
import torch

_DTYPES = (np.int8, np.bool_, np.int32, np.float32)


def state_from_numpy(arrays: Mapping[str, np.ndarray],
                     device: str | torch.device) -> dict[str, torch.Tensor]:
    """Numpy planes (int8 HLL registers, bool touched, int32 counts,
    COUNT(col) planes, quantile bins and slot_start, float32 accumulators
    and TOPK values) -> the port's state on `device`."""
    out = {}
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        if arr.dtype not in _DTYPES:
            raise ValueError(f"plane {name}: unexpected dtype {arr.dtype}")
        out[name] = torch.from_numpy(np.array(arr, copy=True)).to(device)
    return out


def state_to_numpy(state: Mapping[str, torch.Tensor]
                   ) -> dict[str, np.ndarray]:
    """The port's state -> numpy planes (the reverse of state_from_numpy)."""
    return {k: v.detach().cpu().numpy().copy() for k, v in state.items()}


def adopt(ex, arrays: Mapping[str, np.ndarray], *, epoch: int | None,
          watermark_abs: int, open_windows: Mapping[int, int],
          keys: Iterable[tuple]) -> None:
    """Install a running query's position into a fresh port executor
    `ex`: state planes, epoch, watermark, open windows (start_abs ->
    slot) and the key dictionary, in id order."""
    from hstream_tpu_torch.engine.executor import _OpenWindow

    keys = list(keys)
    while ex.spec.n_keys < len(keys):
        ex._grow_keys()
    state = state_from_numpy(arrays, ex.device)
    if set(state) != set(ex.state) or any(
            (state[k].shape, state[k].dtype)
            != (ex.state[k].shape, ex.state[k].dtype) for k in state):
        raise ValueError("state planes do not match this executor's plan")
    ex.state = state
    ex.epoch = epoch
    ex.watermark_abs = watermark_abs
    ex._open = {s: _OpenWindow(start_abs=s, slot=slot)
                for s, slot in open_windows.items()}
    ex._key_ids = {}
    ex._key_rev = []
    for k in keys:
        ex.key_id_for(k)


def session_state(src) -> dict:
    """The position of a device-mode session executor as numpy and Python
    values. Deferred closes must be drained first: their packed buffers
    are the only copy of those rows."""
    dev = getattr(src, "_dev", None)
    if dev is None:
        raise ValueError("session_state: the executor is not in device mode")
    if src.has_pending_closes():
        raise ValueError("session_state: drain the deferred closes first")

    def host(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)

    return {
        "arena": {k: np.array(host(v), copy=True)
                  for k, v in dev["arena"].items()},
        "mir_code": np.array(dev["mir_code"], np.int64),
        "mir_t0": np.array(dev["mir_t0"], np.int64),
        "mir_t1": np.array(dev["mir_t1"], np.int64),
        "mir_live": np.array(dev["mir_live"], np.bool_),
        "code_rev": list(src._code_rev),
        "strings": {name: [d.decode(i) for i in range(len(d))]
                    for name, d in src.dicts.items()},
        "epoch": src.epoch,
        "watermark": int(src.watermark),
        "closed_wm": int(src._closed_wm),
        "late_drops": int(src.late_drops),
    }


def adopt_session(ex, state: Mapping) -> None:
    """Install a session executor's position (session_state) into a fresh
    port SessionExecutor `ex` built from the same plan: its device path
    activates with the carried arena and mirror."""
    from hstream_tpu_torch.engine import session_lattice as sl

    if ex._dev is not None or ex.sessions:
        raise ValueError("adopt_session: the executor is not fresh")
    for name, values in state["strings"].items():
        d = ex.dicts[name]
        for v in values:
            d.encode(v)
    plan = ex._plan_device()
    if plan is None:
        raise ValueError(f"adopt_session: this plan stays on the host "
                         f"({ex._device_refusal})")
    arena = state["arena"]
    cap = int(arena["code"].shape[0])
    want = sl.session_plane_np(plan["spec"], cap)
    if set(arena) != set(want) or any(
            (arena[k].shape, arena[k].dtype) != (want[k].shape, want[k].dtype)
            for k in want):
        raise ValueError("adopt_session: arena planes do not match this "
                         "executor's plan")
    ex._dev = {
        "spec": plan["spec"], "layout": plan["layout"],
        "null_refs": plan["null_refs"], "mode": plan["mode"],
        "progs": plan["progs"], "cap": cap,
        "arena": state_from_numpy(arena, ex.device),
        "spare": sl.init_session_arena(plan["spec"], cap, ex.device),
        "mir_code": np.array(state["mir_code"], np.int64),
        "mir_t0": np.array(state["mir_t0"], np.int64),
        "mir_t1": np.array(state["mir_t1"], np.int64),
        "mir_live": np.array(state["mir_live"], np.bool_),
    }
    ex._code_rev = [tuple(k) for k in state["code_rev"]]
    ex._code_of = {k: i for i, k in enumerate(ex._code_rev)}
    ex._raw_memo = {}
    ex._code_cols_cache = (-1, [])
    ex.epoch = state["epoch"]
    ex.watermark = state["watermark"]
    ex._closed_wm = state["closed_wm"]
    ex.late_drops = state["late_drops"]
    ex.read_epoch += 1


def session_from(src, node, schema, *, device=None, **kw):
    """A port SessionExecutor for the port plan `node` over `schema` that
    continues where the device-mode session executor `src` stands."""
    from hstream_tpu_torch.engine.session import SessionExecutor

    ex = SessionExecutor(node, schema, device=device, **kw)
    adopt_session(ex, session_state(src))
    return ex


def _host(v) -> np.ndarray:
    """A JAX array, a tensor or an array-like as a numpy copy."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy().copy()
    return np.array(v, copy=True)


def join_state(src) -> dict:
    """The position of a device-mode JoinExecutor (the JAX package's or
    the port's) as numpy and Python values. Staged matches, deferred
    match buffers and deferred changes must be flushed first
    (`src.flush_changes()`): they are the only copy of those rows."""
    dev = getattr(src, "_dev", None)
    if dev is None:
        raise ValueError("join_state: the executor is not in device mode")
    if src.has_pending_changes():
        raise ValueError("join_state: flush the pending changes first")
    src._refresh_counts()
    inner = src._inner
    shadows = {}
    for side, sh in dev["shadow"].items():
        shadows[side] = {"code": np.array(sh.code, np.int64),
                         "ts": np.array(sh.ts, np.int64), "t0": sh.t0}
    return {
        "stores": {side: {k: _host(v) for k, v in st.items()}
                   for side, st in dev["stores"].items()},
        "lay": {side: [tuple(e) for e in dev["lay"][side]]
                for side in ("l", "r")},
        "cap": int(dev["cap"]), "t0": dev["t0"], "n": dict(dev["n"]),
        "match_cap": int(dev["match_cap"]),
        "evict_cutoff": int(dev["evict_cutoff"]),
        "shadow": shadows,
        "jcode_rev": list(src._jcode_rev),
        "kid_lut": np.array(src._kid_lut, np.int32),
        "watermark": int(src.watermark),
        "fields": {side: sorted(f) for side, f in src._fields.items()},
        "join_stats": dict(src.join_stats),
        "inner": {
            "state": {k: _host(v) for k, v in inner.state.items()},
            "schema": [(name, t.name) for name, t in inner.schema.fields],
            "strings": {name: [d.decode(i) for i in range(len(d))]
                        for name, d in inner.dicts.items()},
            "epoch": inner.epoch,
            "watermark_abs": int(inner.watermark_abs),
            "open_windows": {int(s): int(w.slot)
                             for s, w in inner._open.items()},
            "keys": list(inner._key_rev),
        },
    }


def adopt_join(ex, state: Mapping) -> None:
    """Install a join's position (join_state) into a fresh port
    JoinExecutor `ex` built from the same plan: its inner window executor
    is built over the carried schema, and its device path activates with
    the carried stores and shadows."""
    from hstream_tpu_torch.engine.executor import QueryExecutor
    from hstream_tpu_torch.engine.join import _FlatIntervalStore
    from hstream_tpu_torch.engine.types import ColumnType, Schema

    if ex._dev is not None or ex._inner is not None:
        raise ValueError("adopt_join: the executor is not fresh")
    ist = state["inner"]
    schema = Schema(tuple((name, ColumnType[t]) for name, t in ist["schema"]))
    plan = ex._inner_plan
    inner = QueryExecutor(plan.node, schema, emit_changes=plan.emit_changes,
                          initial_keys=ex._initial_keys,
                          batch_capacity=ex._batch_capacity,
                          device=ex.device)
    for name, values in ist["strings"].items():
        for v in values:
            inner.dicts[name].encode(v)
    adopt(inner, ist["state"], epoch=ist["epoch"],
          watermark_abs=ist["watermark_abs"],
          open_windows=ist["open_windows"], keys=ist["keys"])
    ex._inner = inner
    ex._apply_inner_tuning()
    ex._fields = {side: set(f) for side, f in state["fields"].items()}
    ex._jcode_rev[:] = [tuple(k) for k in state["jcode_rev"]]
    ex._jcode.clear()
    ex._jcode.update({k: i for i, k in enumerate(ex._jcode_rev)})
    ex._kid_lut = np.array(state["kid_lut"], np.int32)
    ex.watermark = state["watermark"]
    fast = ex._fast_info()
    if fast is None or not ex._activate_device(fast):
        raise ValueError("adopt_join: this plan stays on the host path")
    dev = ex._dev
    if {s: [tuple(e) for e in v] for s, v in dev["lay"].items()} \
            != state["lay"]:
        raise ValueError("adopt_join: the column layouts differ")
    dev["cap"] = state["cap"]
    dev["t0"] = state["t0"]
    dev["n"] = dict(state["n"])
    dev["match_cap"] = state["match_cap"]
    dev["evict_cutoff"] = state["evict_cutoff"]
    dev["stores"] = {side: {k: torch.from_numpy(np.array(v, np.int32))
                            .to(ex.device) for k, v in st.items()}
                     for side, st in state["stores"].items()}
    for side, sh in state["shadow"].items():
        st = _FlatIntervalStore(ex._jcode_rev)
        st.code, st.ts, st.t0 = sh["code"].copy(), sh["ts"].copy(), sh["t0"]
        st.rows = np.empty(len(st.code), object)
        if st.t0 is not None:
            st.comp = st.code * st.SPAN + (st.ts - st.t0)
        dev["shadow"][side] = st
    ex.join_stats.update(state["join_stats"])


def join_from(src, plan, *, device=None, **kw):
    """A port JoinExecutor for the port plan `plan` that continues where
    the device-mode join `src` stands (flush its changes first)."""
    from hstream_tpu_torch.engine.join import JoinExecutor

    ex = JoinExecutor(plan, device=device, **kw)
    adopt_join(ex, join_state(src))
    return ex
