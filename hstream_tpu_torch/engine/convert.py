"""Carrying state across between the JAX package and the port.

This system runs no model, so its "weights" are a running query's
position: the lattice planes, the epoch, the watermark, the open windows
and the group-key dictionary. A JAX executor's state read out as numpy
(`{k: np.asarray(v) for k, v in ex.state.items()}`) has the port's plane
names and layouts already; these functions move it onto a device and
back, and `adopt` installs a whole position into a port executor, so
both engines fed the same next batches emit the same rows.
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
