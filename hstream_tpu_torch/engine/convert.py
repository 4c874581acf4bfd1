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
