"""The window-state lattice: device state, the micro-batch step and the
fused window close (the port of hstream_tpu/engine/lattice.py).

    state[plane][key_id, slot, ...]     slot = (win_start // advance) % W

State is a dict[str, torch.Tensor] with the reference's plane names and
layouts (count i32 [K,W], slot_start i32 [W], touched bool [K,W],
a{i}_{kind} planes, HLL registers int8 [K,W,m]), so a state read out of
the JAX executor carries across unchanged (engine/convert.py).

Where the reference's jitted programs donated the state buffer
(lattice.py:805-829), the port updates the state tensors IN PLACE: the
step, the close's reset and the rebase mutate the dict's tensors and
return nothing new.

Each device program of the reference is a hand-written Hopper kernel
here (engine/kernels/csrc), reached through a wrapper that launches it
when the state lies on the card and counts the launch, and runs the
plain PyTorch version in this module only when the state lies on the
CPU:

  scatter_step  <- build_step_fn            (kernels/csrc/scatter.cu)
  close_slots   <- build_extract_reset_slots / build_extract_slots /
                   build_reset_slots        (kernels/csrc/close.cu)
  rebase        <- rebase                   (kernels/csrc/rebase.cu)

and transport.decode_batch for the wire decode (kernels/csrc/decode.cu).

Aggregates of this slice: COUNT(*), SUM, AVG, MIN, MAX and
APPROX_COUNT_DISTINCT over bare columns. COUNT(col), APPROX_QUANTILE,
TOPK, TOPK_DISTINCT and computed inputs raise NotPortedError (A6).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from hstream_tpu_torch.common.errors import NotPortedError
from hstream_tpu_torch.engine import transport
from hstream_tpu_torch.engine.expr import Col, compile_device
from hstream_tpu_torch.engine.kernels import binding as kb
from hstream_tpu_torch.engine.kernels.binding import (
    CLOSE_EXTRACT,
    CLOSE_EXTRACT_RESET,
    CLOSE_RESET,
)
from hstream_tpu_torch.engine.plan import AggKind, AggSpec
from hstream_tpu_torch.engine.sketches import (
    HLLConfig,
    QuantileConfig,
    _alpha,
    hll_estimate,
    hll_update_indices,
)
from hstream_tpu_torch.engine.window import FixedWindow, num_slots

EMPTY_START = -(1 << 31)  # slot_start sentinel for "slot unoccupied"

# the aggregate kinds of this slice, and their codes in the kernels
_KERNEL_KIND = {AggKind.COUNT_ALL: kb.AGG_COUNT_ALL, AggKind.SUM: kb.AGG_SUM,
                AggKind.AVG: kb.AGG_AVG, AggKind.MIN: kb.AGG_MIN,
                AggKind.MAX: kb.AGG_MAX,
                AggKind.APPROX_COUNT_DISTINCT: kb.AGG_HLL}


@dataclass(frozen=True)
class LatticeSpec:
    """Static configuration of one query's lattice."""

    n_keys: int
    window: FixedWindow | None          # None = windowless global group-by
    aggs: tuple[AggSpec, ...]
    hll: HLLConfig = HLLConfig()
    qcfg: QuantileConfig = QuantileConfig()
    # changelog tracking (EMIT CHANGES): when False the per-batch
    # `touched` store is skipped
    track_touched: bool = True

    @property
    def n_slots(self) -> int:
        return 1 if self.window is None else num_slots(self.window)

    @property
    def windows_per_record(self) -> int:
        return 1 if self.window is None else self.window.windows_per_record


def _plane_name(i: int, agg: AggSpec) -> str:
    return f"a{i}_{agg.kind.value}"


def _check_kind(agg: AggSpec) -> None:
    if agg.kind not in _KERNEL_KIND:
        raise NotPortedError(f"aggregate {agg.kind.value.upper()}", "A6")


def agg_width(agg: AggSpec) -> int:
    """Values per key this aggregate emits (1 for every ported kind)."""
    _check_kind(agg)
    return 1


def init_value(agg: AggSpec) -> float:
    if agg.kind == AggKind.MIN:
        return float("inf")
    if agg.kind == AggKind.MAX:
        return float("-inf")
    return 0.0


def init_state(spec: LatticeSpec, device: torch.device | str
               ) -> dict[str, torch.Tensor]:
    K, W = spec.n_keys, spec.n_slots
    z = dict(device=device)
    state = {
        "count": torch.zeros((K, W), dtype=torch.int32, **z),
        "slot_start": torch.full((W,), EMPTY_START, dtype=torch.int32, **z),
        "touched": torch.zeros((K, W), dtype=torch.bool, **z),
    }
    for i, agg in enumerate(spec.aggs):
        _check_kind(agg)
        name = _plane_name(i, agg)
        if agg.kind == AggKind.COUNT_ALL:
            continue  # aliases the built-in `count` plane (same mask)
        if agg.kind == AggKind.APPROX_COUNT_DISTINCT:
            state[name] = torch.zeros((K, W, spec.hll.m), dtype=torch.int8,
                                      **z)
            continue
        state[name] = torch.full((K, W), init_value(agg),
                                 dtype=torch.float32, **z)
        if agg.kind == AggKind.AVG:
            state[name + "_n"] = torch.zeros((K, W), dtype=torch.int32, **z)
    return state


def agg_input_columns(spec: LatticeSpec) -> tuple[str | None, ...]:
    """The column each aggregate reads (None for COUNT(*)). Computed
    inputs need the device expression compiler, which raises (A6)."""
    cols: list[str | None] = []
    for agg in spec.aggs:
        if agg.input is None:
            cols.append(None)
        elif isinstance(agg.input, Col):
            cols.append(agg.input.name)
        else:
            compile_device(agg.input, None)
    return tuple(cols)


def plane_merge_kinds(spec: LatticeSpec) -> dict[str, str]:
    """Monoid merge op per state plane ("sum" | "min" | "max")."""
    kinds = {"count": "sum", "touched": "max", "slot_start": "max"}
    for i, agg in enumerate(spec.aggs):
        _check_kind(agg)
        name = _plane_name(i, agg)
        if agg.kind == AggKind.COUNT_ALL:
            continue  # no own plane
        if agg.kind == AggKind.MIN:
            kinds[name] = "min"
        elif agg.kind in (AggKind.MAX, AggKind.APPROX_COUNT_DISTINCT):
            kinds[name] = "max"
        else:
            kinds[name] = "sum"
            if agg.kind == AggKind.AVG:
                kinds[name + "_n"] = "sum"
    return kinds


def grow_keys(state: dict[str, torch.Tensor], spec: LatticeSpec,
              new_n_keys: int) -> dict[str, torch.Tensor]:
    """Pad every keyed plane from K to new_n_keys with its identity
    (host-driven, rare: an eager pad, as in the reference)."""
    extra = new_n_keys - spec.n_keys
    out = {}
    for k, v in state.items():
        if k == "slot_start":
            out[k] = v
            continue
        fill = (float("inf") if k.endswith("_min")
                else float("-inf") if k.endswith("_max") else 0)
        pad = torch.full((extra,) + tuple(v.shape[1:]), fill, dtype=v.dtype,
                         device=v.device)
        out[k] = torch.cat([v, pad])
    return out


# ---- the micro-batch step ----------------------------------------------------

def _aggs_with_planes(spec: LatticeSpec):
    """(name, agg, input column) for every aggregate with its own plane."""
    cols = agg_input_columns(spec)
    for i, agg in enumerate(spec.aggs):
        if agg.kind != AggKind.COUNT_ALL:
            yield _plane_name(i, agg), agg, cols[i]


def scatter_step_ref(spec: LatticeSpec, state: dict[str, torch.Tensor],
                     watermark: int, key_ids: torch.Tensor, ts: torch.Tensor,
                     valid: torch.Tensor,
                     cols: Mapping[str, torch.Tensor]) -> None:
    """Plain PyTorch step (build_step_fn semantics, lattice.py:138-255 in
    the reference), in place: per record its `n_per` window starts, the
    late mask, the slot; then count-add, slot_start-max, touched-set and
    the aggregate updates. Rows are walked in record-major order, so the
    float sums on the CPU add in the reference's order."""
    K, W = spec.n_keys, spec.n_slots
    n_per = spec.windows_per_record
    win = spec.window
    dev = ts.device
    B = key_ids.shape[0]
    if win is None:
        starts = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        in_range = torch.ones((B, 1), dtype=torch.bool, device=dev)
        slots = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    else:
        adv = win.advance_ms
        latest = ts - torch.remainder(ts, adv)          # floor mod
        offs = torch.arange(n_per, dtype=torch.int32, device=dev) * adv
        starts = latest[:, None] - offs[None, :]         # [B, n_per]
        late = (starts + (win.size_ms + win.grace_ms)) <= int(watermark)
        in_range = ~late & (starts >= 0)
        slots = torch.remainder(
            torch.div(starts, adv, rounding_mode="floor"), W).long()
    ok_slot = valid[:, None] & in_range
    keys = key_ids[:, None].expand(B, starts.shape[1])
    ok = (ok_slot & (keys >= 0) & (keys < K)).reshape(-1)

    sel = ok_slot.reshape(-1)
    state["slot_start"].scatter_reduce_(
        0, slots.reshape(-1)[sel], starts.reshape(-1)[sel], "amax")
    cell = (keys.long() * W + slots).reshape(-1)[ok]
    state["count"].view(-1).index_put_(
        (cell,), torch.ones_like(cell, dtype=torch.int32), accumulate=True)
    if spec.track_touched:
        state["touched"].view(-1)[cell] = True
    rec = torch.arange(B, device=dev)[:, None].expand(B, starts.shape[1])
    rec = rec.reshape(-1)[ok]
    for name, agg, col in _aggs_with_planes(spec):
        v = cols[col][rec]
        iok = (torch.isfinite(v) if v.dtype == torch.float32
               else torch.ones_like(v, dtype=torch.bool))
        c, v = cell[iok], v[iok]
        plane = state[name].view(-1)
        if agg.kind == AggKind.APPROX_COUNT_DISTINCT:
            reg, rank = hll_update_indices(v, spec.hll)
            plane.scatter_reduce_(0, c * spec.hll.m + reg,
                                  rank.to(torch.int8), "amax")
            continue
        vf = v.to(torch.float32)
        if agg.kind in (AggKind.SUM, AggKind.AVG):
            plane.index_put_((c,), vf, accumulate=True)
            if agg.kind == AggKind.AVG:
                state[name + "_n"].view(-1).index_put_(
                    (c,), torch.ones_like(c, dtype=torch.int32),
                    accumulate=True)
        else:
            plane.scatter_reduce_(
                0, c, vf, "amin" if agg.kind == AggKind.MIN else "amax")


def _scatter_cuda(spec: LatticeSpec, state, watermark: int, key_ids, ts,
                  valid, cols) -> None:
    win = spec.window
    args = kb.ScatterArgs()
    args.key, args.ts, args.valid = kb.ptr(key_ids), kb.ptr(ts), kb.ptr(valid)
    if not (key_ids.dtype == ts.dtype == torch.int32
            and valid.dtype == torch.bool):
        raise ValueError("scatter: key/ts must be int32, valid bool")
    args.cap = key_ids.shape[0]
    args.n_keys, args.n_slots = spec.n_keys, spec.n_slots
    args.n_per = spec.windows_per_record
    if win is not None:
        if win.size_ms + win.grace_ms >= 1 << 31:
            raise ValueError("window size + grace exceeds int32 ms")
        args.advance = win.advance_ms
        args.size_grace = win.size_ms + win.grace_ms
    args.watermark = int(watermark)
    args.track_touched = int(spec.track_touched)
    args.hll_p = spec.hll.precision
    for name in ("count", "slot_start", "touched"):
        if state[name].device != key_ids.device:
            raise ValueError(f"state plane {name} is not on {key_ids.device}")
    args.count = kb.ptr(state["count"])
    args.slot_start = kb.ptr(state["slot_start"])
    args.touched = kb.ptr(state["touched"])
    g = 0
    for name, agg, col in _aggs_with_planes(spec):
        if g == kb.MAX_AGGS:
            raise ValueError(f"more than {kb.MAX_AGGS} aggregates")
        v = cols[col]
        if v.dtype not in kb.VTYPES or v.shape[0] != args.cap:
            raise ValueError(f"scatter: unsupported input column {col}")
        a = args.a[g]
        a.kind, a.vtype = _KERNEL_KIND[agg.kind], kb.VTYPES[v.dtype]
        a.values = kb.ptr(v)
        a.plane = kb.ptr(state[name])
        if agg.kind == AggKind.AVG:
            a.plane_n = kb.ptr(state[name + "_n"])
        g += 1
    args.n_aggs = g
    kb.check(kb.lib().hs_scatter(ctypes.byref(args), kb.stream_of(ts)),
             "scatter_aggregate")


def scatter_step(spec: LatticeSpec, state: dict[str, torch.Tensor],
                 watermark: int, key_ids: torch.Tensor, ts: torch.Tensor,
                 valid: torch.Tensor,
                 cols: Mapping[str, torch.Tensor]) -> None:
    """Fold one decoded batch into the state, in place: the
    scatter-aggregate kernel on the card, scatter_step_ref on the CPU."""
    if key_ids.device.type == "cpu":
        scatter_step_ref(spec, state, watermark, key_ids, ts, valid, cols)
        return
    _scatter_cuda(spec, state, watermark, key_ids, ts, valid, cols)
    scatter_step.launches += 1


scatter_step.launches = 0  # wrapper calls that launched the kernel


def step_encoded(spec: LatticeSpec, state: dict[str, torch.Tensor],
                 watermark: int, n: int, bases, words: torch.Tensor,
                 combo, cap: int) -> None:
    """One micro-batch from the wire: decode, then scatter, in place
    (compiled_encoded_step, lattice.py:805-829 in the reference)."""
    key_ids, ts, valid, cols = transport.decode_batch(words, combo, cap, n,
                                                      bases)
    scatter_step(spec, state, watermark, key_ids, ts, valid, cols)


# ---- the fused close ---------------------------------------------------------


def pad_slots(slots) -> np.ndarray:
    """Slot-index vector padded (with -1) to a power of two, so close
    cycles of varying width share a handful of shapes."""
    p = 1
    while p < len(slots):
        p *= 2
    out = np.full(p, -1, np.int32)
    out[:len(slots)] = slots
    return out


def stack_pow2(bufs: list[torch.Tensor]) -> torch.Tensor:
    """torch.stack with the depth padded to a power of two (zero-filled
    tail buffers decode as zero rows)."""
    p = 1
    while p < len(bufs):
        p *= 2
    bufs = list(bufs) + [torch.zeros_like(bufs[0])] * (p - len(bufs))
    return torch.stack(bufs)


def pack_extract_rows(spec: LatticeSpec, count: torch.Tensor,
                      win_start: torch.Tensor,
                      outs: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Stack (count, win_start, finalized agg outputs) into ONE int32
    buffer [2 + rows, ...] (float outputs bitcast), so a close is one
    fetch."""
    rows = [count.to(torch.int32),
            win_start.to(torch.int32).expand_as(count)]
    rows.extend(outs[agg.out_name].to(torch.float32).view(torch.int32)
                for agg in spec.aggs)
    return torch.stack(rows)


def finalize_column(spec: LatticeSpec, cols: Mapping[str, torch.Tensor]
                    ) -> dict[str, torch.Tensor]:
    """Finalize slot columns {plane: [K, P, ...]} -> {out_name: [K, P]
    float32} (finalize_column, lattice.py:411-436 in the reference)."""
    outs = {}
    count = cols["count"]
    for i, agg in enumerate(spec.aggs):
        name = _plane_name(i, agg)
        if agg.kind == AggKind.COUNT_ALL:
            outs[agg.out_name] = count.to(torch.float32)
        elif agg.kind == AggKind.AVG:
            n = cols[name + "_n"].to(torch.float32)
            outs[agg.out_name] = cols[name] / torch.clamp(n, min=1.0)
        elif agg.kind == AggKind.APPROX_COUNT_DISTINCT:
            outs[agg.out_name] = hll_estimate(cols[name], spec.hll)
        elif agg.kind in (AggKind.MIN, AggKind.MAX):
            outs[agg.out_name] = torch.where(count > 0, cols[name],
                                             torch.zeros_like(cols[name]))
        else:
            outs[agg.out_name] = cols[name]
    return outs


def extract_slots_ref(spec: LatticeSpec, state: dict[str, torch.Tensor],
                      slots: torch.Tensor) -> torch.Tensor:
    """Plain extract of the slot columns named by `slots` (padding < 0
    gives all-zero rows) -> packed int32 [P, 2+rows, K]
    (_extract_slots_packed, lattice.py:606-621 in the reference)."""
    valid = slots >= 0
    safe = torch.where(valid, slots, 0).long()
    col = {k: v[:, safe] for k, v in state.items()
           if k not in ("slot_start", "touched")}
    outs = finalize_column(spec, col)
    packed = pack_extract_rows(spec, col["count"],
                               state["slot_start"][safe][None, :], outs)
    packed = packed.permute(2, 0, 1)                    # [P, rows, K]
    return torch.where(valid[:, None, None], packed,
                       torch.zeros_like(packed)).contiguous()


def reset_slots_ref(spec: LatticeSpec, state: dict[str, torch.Tensor],
                    slots: torch.Tensor) -> None:
    """Plain reset of the slots named by `slots` (padding < 0 resets
    nothing), in place (_reset_slots_tree, lattice.py:586-603)."""
    rs = slots[slots >= 0].long()
    for i, agg in enumerate(spec.aggs):
        if agg.kind == AggKind.COUNT_ALL:
            continue  # no own plane; `count` below resets it
        name = _plane_name(i, agg)
        state[name][:, rs] = init_value(agg)
        if agg.kind == AggKind.AVG:
            state[name + "_n"][:, rs] = 0
    state["count"][:, rs] = 0
    state["touched"][:, rs] = False
    state["slot_start"][rs] = EMPTY_START


def _close_cuda(spec: LatticeSpec, state, slots: torch.Tensor, mode: int
                ) -> torch.Tensor | None:
    K, P = spec.n_keys, slots.shape[0]
    if spec.hll.precision < 2:
        raise ValueError("close kernel needs HLL precision >= 2")
    args = kb.CloseArgs()
    args.n_keys, args.n_slots, args.n_sel, args.mode = \
        K, spec.n_slots, P, mode
    args.hll_p = spec.hll.precision
    m = spec.hll.m
    args.hll_am2 = _alpha(m) * m * m
    args.slots = kb.ptr(slots)
    args.count = kb.ptr(state["count"])
    args.slot_start = kb.ptr(state["slot_start"])
    args.touched = kb.ptr(state["touched"])
    if len(spec.aggs) > kb.MAX_AGGS:
        raise ValueError(f"more than {kb.MAX_AGGS} aggregates")
    for g, agg in enumerate(spec.aggs):
        _check_kind(agg)
        a = args.a[g]
        a.kind, a.init = _KERNEL_KIND[agg.kind], init_value(agg)
        if agg.kind != AggKind.COUNT_ALL:
            a.plane = kb.ptr(state[_plane_name(g, agg)])
        if agg.kind == AggKind.AVG:
            a.plane_n = kb.ptr(state[_plane_name(g, agg) + "_n"])
    args.n_aggs = len(spec.aggs)
    out = None
    if mode != CLOSE_RESET:
        out = torch.empty((P, 2 + len(spec.aggs), K), dtype=torch.int32,
                          device=slots.device)
        args.out = out.data_ptr()
    done = torch.zeros(P, dtype=torch.int32, device=slots.device)
    args.done = done.data_ptr()
    kb.check(kb.lib().hs_close(ctypes.byref(args), kb.stream_of(slots)),
             "fused_close")
    return out


def close_slots(spec: LatticeSpec, state: dict[str, torch.Tensor],
                slots: np.ndarray, mode: int = CLOSE_EXTRACT_RESET
                ) -> torch.Tensor | None:
    """The fused close over a padded slot vector (host int32 [P], < 0 =
    padding), one launch: CLOSE_EXTRACT_RESET returns the packed int32
    [P, 2+rows, K] buffer and resets those slots in place, from pre-reset
    values; CLOSE_EXTRACT only extracts (peek); CLOSE_RESET only resets
    and returns None. The close kernel on the card, the plain versions
    on the CPU."""
    slots = np.asarray(slots, np.int32)
    live = slots[slots >= 0]
    if (live >= spec.n_slots).any():
        raise ValueError("close: slot index out of range")
    if mode != CLOSE_EXTRACT and len(np.unique(live)) != len(live):
        raise ValueError("close: a slot named twice would be read after "
                         "its reset")
    dev = state["count"].device
    slots_t = torch.from_numpy(slots).to(dev)
    if dev.type == "cpu":
        packed = None
        if mode != CLOSE_RESET:
            packed = extract_slots_ref(spec, state, slots_t)
        if mode != CLOSE_EXTRACT:
            reset_slots_ref(spec, state, slots_t)
        return packed
    out = _close_cuda(spec, state, slots_t, mode)
    close_slots.launches += 1
    return out


close_slots.launches = 0  # wrapper calls that launched the kernel


def unpack_extract_rows(spec: LatticeSpec, packed: np.ndarray):
    """(count [K], win_start [K], {name: [K] f32}) from one slot's
    packed rows."""
    outs = {agg.out_name: packed[2 + i].view(np.float32)
            for i, agg in enumerate(spec.aggs)}
    return packed[0], packed[1], outs


def gather_extract_batch(spec: LatticeSpec, packed: np.ndarray,
                         widx: np.ndarray, kids: np.ndarray):
    """Columnar gather over a fetched extract buffer [P, 2+rows, K]: for
    the selected (window, key) pairs, {out_name: [n] f64}."""
    return {agg.out_name: np.ascontiguousarray(
                packed[widx, 2 + i, kids]).view(np.float32).astype(
                np.float64)
            for i, agg in enumerate(spec.aggs)}


# ---- rebase ------------------------------------------------------------------

def rebase_ref(state: dict[str, torch.Tensor], delta: int) -> None:
    """Plain rebase, in place: slot_start -= delta where occupied."""
    ss = state["slot_start"]
    ss.copy_(torch.where(ss != EMPTY_START, ss - int(delta), ss))


def rebase(state: dict[str, torch.Tensor], delta: int) -> None:
    """Shift device-relative time by -delta (the host re-anchored the
    epoch), in place: the rebase kernel on the card, rebase_ref on the
    CPU."""
    ss = state["slot_start"]
    if ss.device.type == "cpu":
        rebase_ref(state, delta)
        return
    kb.check(kb.lib().hs_rebase(kb.ptr(ss), ss.shape[0], int(delta),
                                kb.stream_of(ss)), "rebase")
    rebase.launches += 1


rebase.launches = 0  # wrapper calls that launched the kernel
