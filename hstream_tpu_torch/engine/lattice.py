"""The window-state lattice: device state, the micro-batch step, the
fused window close and the changelog extract (the port of
hstream_tpu/engine/lattice.py).

    state[plane][key_id, slot, ...]     slot = (win_start // advance) % W

State is a dict[str, torch.Tensor] with the reference's plane names and
layouts (count i32 [K,W], slot_start i32 [W], touched bool [K,W],
a{i}_{kind} planes: f32 / i32 [K,W], HLL registers int8 [K,W,m],
quantile bins i32 [K,W,n_bins], TOPK values f32 [K,W,k]), so a state read
out of the JAX executor carries across unchanged (engine/convert.py).

Where the reference's jitted programs donated the state buffer
(lattice.py:805-829), the port updates the state tensors IN PLACE: the
step, the close's reset, the changelog extract's clear and the rebase
mutate the dict's tensors.

Each device program of the reference is a hand-written Hopper kernel
here (engine/kernels/csrc), reached through a wrapper that launches it
when the state lies on the card and counts the launch, and runs the
plain PyTorch version in this module only when the state lies on the
CPU:

  expr.eval_programs <- the step's filter / value fns (kernels/csrc/expr.cu)
  scatter_step    <- build_step_fn            (kernels/csrc/scatter.cu)
  topk_step       <- _topk_step               (kernels/csrc/topk.cu)
  unpack          <- unpack_batch_device, the decode of build_step_packed
                                              (kernels/csrc/unpack.cu)
  close_slots     <- build_extract_reset_slots / build_extract_slots
                                              (kernels/csrc/close.cu)
  reset_slots     <- build_reset_slots        (close.cu, reset-only mode)
  extract_slot    <- build_extract_slot       (close.cu, hs_close_slot)
  reset_slot      <- build_reset_slot         (close.cu, hs_close_slot)
  extract_touched <- build_extract_touched    (kernels/csrc/touched.cu)
  rebase          <- rebase                   (kernels/csrc/rebase.cu)

and transport.decode_batch for the wire decode (kernels/csrc/decode.cu).
`compiled()` bundles a query's programs as the reference's
CompiledLattice does: `step` over the packed int32 transport
(step_packed: unpack, then the step's kernels), the per-slot close and
the fused close, reset and changelog extract.
Every aggregate kind of the reference's fixed-window lattice is here:
COUNT(*), COUNT(col), SUM, AVG, MIN, MAX, APPROX_COUNT_DISTINCT,
APPROX_QUANTILE, TOPK and TOPK_DISTINCT, over bare columns or computed
inputs, with SQL NULL and non-finite inputs masked per aggregate.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass
from typing import Callable, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from hstream_tpu_torch.common.errors import SQLCodegenError
from hstream_tpu_torch.common.tracing import compile_site
from hstream_tpu_torch.engine import transport
from hstream_tpu_torch.engine.expr import (
    Col,
    DeviceProgram,
    Expr,
    compile_device,
    eval_programs,
    ftz,
)
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
    quantile_bin,
    quantile_estimate,
)
from hstream_tpu_torch.engine.types import ColumnType
from hstream_tpu_torch.engine.window import FixedWindow, num_slots

EMPTY_START = -(1 << 31)  # slot_start sentinel for "slot unoccupied"

# the aggregate kinds and their codes in the kernels
_KERNEL_KIND = {AggKind.COUNT_ALL: kb.AGG_COUNT_ALL, AggKind.SUM: kb.AGG_SUM,
                AggKind.AVG: kb.AGG_AVG, AggKind.MIN: kb.AGG_MIN,
                AggKind.MAX: kb.AGG_MAX,
                AggKind.APPROX_COUNT_DISTINCT: kb.AGG_HLL,
                AggKind.COUNT: kb.AGG_COUNT,
                AggKind.APPROX_QUANTILE: kb.AGG_QUANT,
                AggKind.TOPK: kb.AGG_TOPK,
                AggKind.TOPK_DISTINCT: kb.AGG_TOPK_DISTINCT}
_TOPK_KINDS = (AggKind.TOPK, AggKind.TOPK_DISTINCT)


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


def agg_width(agg: AggSpec) -> int:
    """Values per key this aggregate emits (k for TOPK, else 1)."""
    if agg.kind not in _KERNEL_KIND:
        raise NotImplementedError(f"agg {agg.kind}")
    if agg.kind in _TOPK_KINDS:
        if agg.k is None or agg.k < 1:
            raise ValueError(f"{agg.kind.value} needs k >= 1, got {agg.k}")
        return agg.k
    return 1


def _plane_width(spec: LatticeSpec, agg: AggSpec) -> int:
    """Values per (key, slot) cell of the aggregate's plane."""
    if agg.kind == AggKind.APPROX_COUNT_DISTINCT:
        return spec.hll.m
    if agg.kind == AggKind.APPROX_QUANTILE:
        return spec.qcfg.n_bins
    return agg_width(agg)


def init_value(agg: AggSpec) -> float:
    if agg.kind == AggKind.MIN:
        return float("inf")
    if agg.kind in (AggKind.MAX,) + _TOPK_KINDS:
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
        agg_width(agg)
        name = _plane_name(i, agg)
        if agg.kind == AggKind.COUNT_ALL:
            continue  # aliases the built-in `count` plane (same mask)
        if agg.kind == AggKind.COUNT:
            state[name] = torch.zeros((K, W), dtype=torch.int32, **z)
        elif agg.kind == AggKind.APPROX_COUNT_DISTINCT:
            state[name] = torch.zeros((K, W, spec.hll.m), dtype=torch.int8,
                                      **z)
        elif agg.kind == AggKind.APPROX_QUANTILE:
            state[name] = torch.zeros((K, W, spec.qcfg.n_bins),
                                      dtype=torch.int32, **z)
        elif agg.kind in _TOPK_KINDS:
            # the k largest values, sorted descending, -inf padded
            state[name] = torch.full((K, W, agg_width(agg)),
                                     float("-inf"), dtype=torch.float32, **z)
        else:
            state[name] = torch.full((K, W), init_value(agg),
                                     dtype=torch.float32, **z)
            if agg.kind == AggKind.AVG:
                state[name + "_n"] = torch.zeros((K, W), dtype=torch.int32,
                                                 **z)
    return state


def agg_input_columns(spec: LatticeSpec) -> tuple[str | None, ...]:
    """The column each aggregate reads: None for COUNT(*), the column's
    name for a bare column, and "__in_a{i}" for a computed input (the
    column the step's expression program writes, step_programs)."""
    return tuple(None if agg.input is None
                 else agg.input.name if isinstance(agg.input, Col)
                 else f"__in_a{i}"
                 for i, agg in enumerate(spec.aggs))


def null_key(i: int) -> str:
    """The decoded column that flags aggregate i's SQL NULL inputs (the
    reference's `__null_a{i}` wire stream; absent = no NULLs)."""
    return f"__null_a{i}"


def check_device_caps(aggs: Sequence[AggSpec], columns) -> None:
    """Refuse, when a query is created and on every device, what one
    launch's argument blocks cannot hold (kernels/csrc/hs_kernels.h):
    more than MAX_AGGS aggregates, or more than MAX_COLS distinct input
    columns read by its WHERE and aggregate inputs (the wire carries a
    stream each, and one NULL stream an aggregate). The reference traces
    any number; this refusal is a deliberate difference (ROADMAP C)."""
    if len(aggs) > kb.MAX_AGGS:
        raise SQLCodegenError(f"{len(aggs)} aggregates: the device takes "
                              f"at most {kb.MAX_AGGS} a query")
    if len(columns) > kb.MAX_COLS:
        raise SQLCodegenError(f"{len(columns)} input columns: the device "
                              f"takes at most {kb.MAX_COLS} a query")


StepPrograms = tuple[tuple[DeviceProgram, "str | None"], ...]


def step_programs(spec: LatticeSpec, schema,
                  filter_expr: Expr | None) -> StepPrograms:
    """The expression programs of a query's step: the WHERE mask (paired
    with None) and one program per computed aggregate input (paired with
    its "__in_a{i}" column), compiled once (the reference traces the same
    functions into its step, lattice.py:759-789 compile_agg_inputs)."""
    progs = []
    if filter_expr is not None:
        prog = compile_device(filter_expr, schema)
        if prog.dtype != "bool":
            raise SQLCodegenError("WHERE predicate is not boolean")
        progs.append((prog, None))
    for i, agg in enumerate(spec.aggs):
        if isinstance(agg.input, Col):
            if not schema.has(agg.input.name):
                raise SQLCodegenError(f"unknown column {agg.input.name}")
        elif agg.input is not None:
            progs.append((compile_device(agg.input, schema),
                          f"__in_a{i}"))
    return tuple(progs)


def plane_merge_kinds(spec: LatticeSpec) -> dict[str, str]:
    """Monoid merge op per state plane ("sum" | "min" | "max" | "topk")."""
    kinds = {"count": "sum", "touched": "max", "slot_start": "max"}
    for i, agg in enumerate(spec.aggs):
        name = _plane_name(i, agg)
        if agg.kind == AggKind.COUNT_ALL:
            continue  # no own plane
        if agg.kind == AggKind.MIN:
            kinds[name] = "min"
        elif agg.kind in (AggKind.MAX, AggKind.APPROX_COUNT_DISTINCT):
            kinds[name] = "max"
        elif agg.kind in _TOPK_KINDS:
            # NOT elementwise: merging two top-k planes needs concat+sort
            kinds[name] = "topk"
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
    fills = {_plane_name(i, a): init_value(a)
             for i, a in enumerate(spec.aggs)}
    out = {}
    for k, v in state.items():
        if k == "slot_start":
            out[k] = v
            continue
        pad = torch.full((extra,) + tuple(v.shape[1:]), fills.get(k, 0),
                         dtype=v.dtype, device=v.device)
        out[k] = torch.cat([v, pad])
    return out


# ---- the micro-batch step ---------------------------------------------------

def _record_cells(spec: LatticeSpec, watermark: int, key_ids: torch.Tensor,
                  ts: torch.Tensor, valid: torch.Tensor):
    """(starts [B, n_per], slots [B, n_per], ok_slot [B, n_per], cell [M],
    rec [M]): each record's windows, and the (record, window) pairs that
    land in a cell of the lattice, record-major (build_step_fn's masks,
    lattice.py:175-196 in the reference)."""
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
    cell = (keys.long() * W + slots).reshape(-1)[ok]
    rec = torch.arange(B, device=dev)[:, None].expand(B, starts.shape[1])
    return starts, slots, ok_slot, cell, rec.reshape(-1)[ok]


def _agg_values(i: int, col: torch.Tensor, cols, rec: torch.Tensor):
    """(values, counts-mask) of aggregate i's input over the records
    `rec`: an input counts when it is not SQL NULL and, for float32,
    finite (lattice.py:213-222)."""
    v = col[rec]
    iok = (torch.isfinite(v) if v.dtype == torch.float32
           else torch.ones_like(v, dtype=torch.bool))
    nulls = cols.get(null_key(i))
    if nulls is not None:
        iok = iok & ~nulls[rec]
    return v, iok


def scatter_step_ref(spec: LatticeSpec, state: dict[str, torch.Tensor],
                     watermark: int, key_ids: torch.Tensor, ts: torch.Tensor,
                     valid: torch.Tensor,
                     cols: Mapping[str, torch.Tensor]) -> None:
    """Plain PyTorch step (build_step_fn semantics, lattice.py:138-255 in
    the reference) for every aggregate but TOPK (topk_step_ref), in
    place: per record its `n_per` window starts, the late mask, the
    slot; then count-add, slot_start-max, touched-set and the aggregate
    updates. Rows are walked in record-major order, so the float sums on
    the CPU add in the reference's order."""
    starts, slots, ok_slot, cell, rec = _record_cells(
        spec, watermark, key_ids, ts, valid)
    sel = ok_slot.reshape(-1)
    state["slot_start"].scatter_reduce_(
        0, slots.reshape(-1)[sel], starts.reshape(-1)[sel], "amax")
    state["count"].view(-1).index_put_(
        (cell,), torch.ones_like(cell, dtype=torch.int32), accumulate=True)
    if spec.track_touched:
        state["touched"].view(-1)[cell] = True
    in_cols = agg_input_columns(spec)
    for i, agg in enumerate(spec.aggs):
        if agg.kind == AggKind.COUNT_ALL or agg.kind in _TOPK_KINDS:
            continue
        v, iok = _agg_values(i, cols[in_cols[i]], cols, rec)
        c, v = cell[iok], ftz(v[iok])
        plane = state[_plane_name(i, agg)].view(-1)
        ones = torch.ones_like(c, dtype=torch.int32)
        if agg.kind == AggKind.COUNT:
            plane.index_put_((c,), ones, accumulate=True)
        elif agg.kind == AggKind.APPROX_COUNT_DISTINCT:
            reg, rank = hll_update_indices(v, spec.hll)
            plane.scatter_reduce_(0, c * spec.hll.m + reg,
                                  rank.to(torch.int8), "amax")
        elif agg.kind == AggKind.APPROX_QUANTILE:
            b = quantile_bin(v, spec.qcfg).long()
            plane.index_put_((c * spec.qcfg.n_bins + b,), ones,
                             accumulate=True)
        elif agg.kind in (AggKind.SUM, AggKind.AVG):
            plane.index_put_((c,), v.to(torch.float32), accumulate=True)
            # the sums flushed once here; XLA (and the kernel's atomics)
            # flush every partial sum
            plane[c] = ftz(plane[c])
            if agg.kind == AggKind.AVG:
                state[_plane_name(i, agg) + "_n"].view(-1).index_put_(
                    (c,), ones, accumulate=True)
        else:
            plane.scatter_reduce_(
                0, c, v.to(torch.float32),
                "amin" if agg.kind == AggKind.MIN else "amax")


def _step_args(spec: LatticeSpec, state, watermark: int, key_ids, ts, valid,
               cols, aggs: Sequence[int]) -> kb.ScatterArgs:
    """The scatter / top-k kernels' arguments for the aggregates `aggs`."""
    win = spec.window
    if not (key_ids.dtype == ts.dtype == torch.int32
            and valid.dtype == torch.bool):
        raise ValueError("step: key/ts must be int32, valid bool")
    args = kb.ScatterArgs()
    args.key, args.ts, args.valid = kb.ptr(key_ids), kb.ptr(ts), kb.ptr(valid)
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
    args.q_min, args.q_gamma = spec.qcfg.min_value, spec.qcfg.gamma_log
    for name in ("count", "slot_start", "touched"):
        if state[name].device != key_ids.device:
            raise ValueError(f"state plane {name} is not on {key_ids.device}")
    args.count = kb.ptr(state["count"])
    args.slot_start = kb.ptr(state["slot_start"])
    args.touched = kb.ptr(state["touched"])
    if len(aggs) > kb.MAX_AGGS:
        raise ValueError(f"more than {kb.MAX_AGGS} aggregates")
    in_cols = agg_input_columns(spec)
    for g, i in enumerate(aggs):
        agg = spec.aggs[i]
        v = cols[in_cols[i]]
        if v.dtype not in kb.VTYPES or v.shape[0] != args.cap:
            raise ValueError(f"step: unsupported input column {in_cols[i]}")
        a = args.a[g]
        a.kind, a.vtype = _KERNEL_KIND[agg.kind], kb.VTYPES[v.dtype]
        a.values = kb.ptr(v)
        nulls = cols.get(null_key(i))
        if nulls is not None:
            if nulls.dtype != torch.bool or nulls.shape[0] != args.cap:
                raise ValueError(f"step: bad null mask {null_key(i)}")
            a.nulls = kb.ptr(nulls)
        name = _plane_name(i, agg)
        a.plane = kb.ptr(state[name])
        if agg.kind == AggKind.AVG:
            a.plane_n = kb.ptr(state[name + "_n"])
        a.width = _plane_width(spec, agg)
    args.n_aggs = len(aggs)
    return args


# the block-private scatter's shared-memory budget: the H100's 227 KB a
# block, less 1 KB for the kernel's static shared memory (scatter.cu)
SCATTER_SMEM_LIMIT = 232_448 - 1024
_SM_SMEM = 233_472          # shared memory of one SM, 1 KB of it per block
H100_SMS = transport.H100_SMS
SCATTER_CLUSTER = 8         # blocks a cluster in the cluster mode
_PRIVATE_KINDS = (AggKind.COUNT, AggKind.SUM, AggKind.AVG, AggKind.MIN,
                  AggKind.MAX)


class ScatterPlan(NamedTuple):
    mode: int         # kb.SCATTER_PRIVATE, _CLUSTER or _GLOBAL
    blocks: int       # grid size


def scatter_smem_bytes(spec: LatticeSpec) -> int:
    """A block's shared memory in the block-private branches: count, the
    COUNT, SUM, AVG (sum and _n), MIN and MAX planes ([K, W] int32 /
    float32 each) and slot_start [W] (scatter.cu private_words)."""
    planes = 1 + sum(2 if a.kind == AggKind.AVG else 1
                     for a in spec.aggs if a.kind in _PRIVATE_KINDS)
    return 4 * (spec.n_keys * spec.n_slots * planes + spec.n_slots)


def scatter_plan(spec: LatticeSpec, cap: int, n_sms: int = H100_SMS,
                 mode: int | None = None) -> ScatterPlan:
    """The scatter kernel's branch for a batch of `cap` records, chosen
    by the spec's size: block-private when its planes
    (scatter_smem_bytes) fit in a block's shared memory, with one or two
    blocks per SM (as many as fit) and at least 2048 records a block;
    where a record has several windows (HOP), whose panes each fan out to
    several window cells, in whole clusters of SCATTER_CLUSTER blocks
    that reduce their planes together before they flush. Else every
    update a global atomic, one thread per (record, window). `mode`
    forces a branch (a block-private one only where the planes fit)."""
    smem = scatter_smem_bytes(spec)
    fits = smem <= SCATTER_SMEM_LIMIT
    if mode is None:
        mode = (kb.SCATTER_GLOBAL if not fits
                else kb.SCATTER_PRIVATE if spec.windows_per_record == 1
                else kb.SCATTER_CLUSTER)
    if mode == kb.SCATTER_GLOBAL:
        return ScatterPlan(mode, max(1, -(-cap * spec.windows_per_record
                                          // 256)))
    if not fits:
        raise ValueError(f"scatter: {smem} B of planes exceed a block's "
                         f"shared memory")
    per_sm = 2 if 2 * (smem + 1024) <= _SM_SMEM else 1
    blocks = max(1, min(per_sm * n_sms, -(-cap // 2048)))
    if mode == kb.SCATTER_CLUSTER:
        blocks = SCATTER_CLUSTER * max(1, blocks // SCATTER_CLUSTER)
    return ScatterPlan(mode, blocks)


def scatter_step(spec: LatticeSpec, state: dict[str, torch.Tensor],
                 watermark: int, key_ids: torch.Tensor, ts: torch.Tensor,
                 valid: torch.Tensor, cols: Mapping[str, torch.Tensor],
                 mode: int | None = None) -> None:
    """Fold one decoded batch into the state (every aggregate but TOPK),
    in place: the scatter-aggregate kernel on the card, in scatter_plan's
    branch (`mode` forces one), scatter_step_ref on the CPU."""
    if key_ids.device.type == "cpu":
        scatter_step_ref(spec, state, watermark, key_ids, ts, valid, cols)
        return
    aggs = [i for i, a in enumerate(spec.aggs)
            if a.kind != AggKind.COUNT_ALL and a.kind not in _TOPK_KINDS]
    args = _step_args(spec, state, watermark, key_ids, ts, valid, cols, aggs)
    args.mode, args.blocks = scatter_plan(
        spec, args.cap, transport.sm_count(key_ids.device), mode)
    kb.check(kb.lib().hs_scatter(ctypes.byref(args), kb.stream_of(ts)),
             "scatter_aggregate")
    scatter_step.launches += 1


scatter_step.launches = 0  # wrapper calls that launched the kernel


@functools.lru_cache(maxsize=None)
def divisor(d: int) -> tuple[int, int]:
    """(m, shift) with x // d == (x * m) >> shift for 0 <= x < 2^31, for
    a divisor 1 <= d < 2^31: shift = 31 + ceil(log2 d), m = ceil(2^shift
    / d) < 2^32 (Granlund and Montgomery 1994, Theorem 4.2). The top-k
    kernel divides by the window advance and the slot count so
    (record.cuh fdiv, which takes a negative x as ~(~x // d))."""
    if not 1 <= d < 1 << 31:
        raise ValueError(f"divisor {d} outside [1, 2^31)")
    shift = 31 + (d - 1).bit_length()
    return -(-(1 << shift) // d), shift


def _order_key(v: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 keys in the total order the reference's sort uses
    (-0.0 below +0.0)."""
    bits = v.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def topk_fold(plane: torch.Tensor, cell: torch.Tensor, vals: torch.Tensor,
              distinct: bool) -> torch.Tensor:
    """The plain top-k fold: the plane [K, W, k] after adding `vals` at
    the flat cells `cell`. One sort of (cell ascending, value descending)
    over the batch and the stored values, then each cell's first k
    (TOPK) or first k distinct values (TOPK_DISTINCT), as _topk_step,
    lattice.py:258-301 in the reference, gives. The value is ranked and
    compared flushed, as the reference's float compares flush it (a
    subnormal ranks as the zero of its sign; +0.0, -0.0 and the
    subnormals are one distinct value, kept as the first of them), and
    stored with its own bits; among values that rank alike the larger
    bits come first (the reference's unstable sort has no one order
    there: ROADMAP C)."""
    K, W, k = plane.shape
    dev = plane.device
    cand_cell = torch.cat([cell.long(), torch.arange(
        K * W, device=dev).repeat_interleave(k)])
    cand_val = torch.cat([vals.to(torch.float32), plane.reshape(-1)])
    flushed = ftz(cand_val)
    order = torch.argsort(-_order_key(cand_val))         # the bits, then
    desc = (1 << 31) - 1 - _order_key(flushed[order])    # in [0, 2^32)
    order = order[torch.sort((cand_cell[order] << 32) | desc,
                             stable=True).indices]
    sc, sv = cand_cell[order], cand_val[order]
    idx = torch.arange(sc.shape[0], device=dev)
    first = torch.ones_like(sc, dtype=torch.bool)
    first[1:] = sc[1:] != sc[:-1]
    if distinct:
        fv = flushed[order]
        newv = first.clone()
        newv[1:] |= fv[1:] != fv[:-1]
        c = torch.cumsum(newv.long(), 0)
        base = torch.cummax(torch.where(first, c - newv.long(), 0), 0).values
        rank = torch.where(newv, c - 1 - base, k)
    else:
        rank = idx - torch.cummax(torch.where(first, idx, 0), 0).values
    keep = rank < k
    out = torch.full_like(plane, float("-inf"))
    out.view(-1)[sc[keep] * k + rank[keep]] = sv[keep]
    return out


def topk_step_ref(spec: LatticeSpec, state: dict[str, torch.Tensor],
                  watermark: int, key_ids: torch.Tensor, ts: torch.Tensor,
                  valid: torch.Tensor,
                  cols: Mapping[str, torch.Tensor]) -> None:
    """Plain TOPK / TOPK_DISTINCT step, in place (topk_fold per plane)."""
    _, _, _, cell, rec = _record_cells(spec, watermark, key_ids, ts, valid)
    in_cols = agg_input_columns(spec)
    for i, agg in enumerate(spec.aggs):
        if agg.kind not in _TOPK_KINDS:
            continue
        v, iok = _agg_values(i, cols[in_cols[i]], cols, rec)
        name = _plane_name(i, agg)
        state[name].copy_(topk_fold(state[name], cell[iok], v[iok],
                                    agg.kind == AggKind.TOPK_DISTINCT))


# the block-private top-k's shared memory: the H100's 227 KB a block
TOPK_SMEM_LIMIT = 232_448


class TopkPlan(NamedTuple):
    mode: int         # kb.TOPK_PRIVATE or kb.TOPK_GLOBAL
    blocks: int       # grid size


def topk_smem_bytes(spec: LatticeSpec) -> int:
    """A block's shared memory in the block-private top-k: per [K, W]
    cell a lock word, a list entry and, per TOPK / TOPK_DISTINCT
    aggregate, a mask word, then the list's count; then per aggregate its
    copy of the k values; each part 16-byte aligned (topk.cu
    private_words)."""
    cells = spec.n_keys * spec.n_slots
    ks = [a.k for a in spec.aggs if a.kind in _TOPK_KINDS]
    words = -(-(cells * (2 + len(ks)) + 1) // 4) * 4
    return 4 * (words + sum(-(-cells * k // 4) * 4 for k in ks))


def topk_plan(spec: LatticeSpec, cap: int, n_sms: int = H100_SMS,
              mode: int | None = None) -> TopkPlan:
    """The top-k kernel's branch for a batch of `cap` records, by the
    spec's size: block-private when its planes (topk_smem_bytes) fit in
    a block's shared memory and no k exceeds 32 (a cell's bit mask), one
    block of TOPK_PRIVATE_THREADS an SM; else global, up to eight blocks
    of TOPK_GLOBAL_THREADS an SM. A thread takes TOPK_PER records at a
    time; no grid is larger than the batch needs. `mode` forces a branch
    (the private one only where the planes fit)."""
    smem = topk_smem_bytes(spec)
    fits = smem <= TOPK_SMEM_LIMIT and all(
        a.k <= 32 for a in spec.aggs if a.kind in _TOPK_KINDS)
    if mode is None:
        mode = kb.TOPK_PRIVATE if fits else kb.TOPK_GLOBAL
    if mode == kb.TOPK_PRIVATE and not fits:
        raise ValueError(f"top-k: the planes ({smem} B) or a k over 32 do "
                         f"not fit a block's shared memory and masks")
    threads, per_sm = ((kb.TOPK_PRIVATE_THREADS, 1)
                       if mode == kb.TOPK_PRIVATE
                       else (kb.TOPK_GLOBAL_THREADS, 8))
    need = -(-cap // (threads * kb.TOPK_PER))
    return TopkPlan(mode, max(1, min(per_sm * n_sms, need)))


_locks: dict[tuple, torch.Tensor] = {}
_locks_mutex = threading.Lock()


def _cell_locks(device: torch.device, n_cells: int) -> torch.Tensor:
    """A zeroed int32 lock per cell for the top-k kernel, which leaves
    every lock released, so one buffer per device and size serves every
    launch."""
    with _locks_mutex:
        t = _locks.get((device, n_cells))
        if t is None:
            t = _locks[(device, n_cells)] = torch.zeros(
                n_cells, dtype=torch.int32, device=device)
        return t


_bounds: dict[tuple, torch.Tensor] = {}
_epoch = [0]


def _topk_bounds(device: torch.device, n: int) -> tuple[torch.Tensor, int]:
    """(the block-private top-k's bound words, int64 [n] per device and
    size, zeroed when made; this launch's epoch). Each launch tags its
    bounds with a new epoch and reads only its own, so the buffer is
    never cleared; when the 32-bit epoch would wrap, every buffer is
    zeroed and the count starts again."""
    with _locks_mutex:
        _epoch[0] += 1
        if _epoch[0] >= 1 << 32:
            _epoch[0] = 1
            for t in _bounds.values():
                t.zero_()
        t = _bounds.get((device, n))
        if t is None:
            t = _bounds[(device, n)] = torch.zeros(n, dtype=torch.int64,
                                                   device=device)
        return t, _epoch[0]


def topk_step(spec: LatticeSpec, state: dict[str, torch.Tensor],
              watermark: int, key_ids: torch.Tensor, ts: torch.Tensor,
              valid: torch.Tensor, cols: Mapping[str, torch.Tensor],
              mode: int | None = None) -> None:
    """Fold one decoded batch into the TOPK / TOPK_DISTINCT planes, in
    place: the top-k kernel on the card, in topk_plan's branch (`mode`
    forces one), topk_step_ref on the CPU."""
    aggs = [i for i, a in enumerate(spec.aggs) if a.kind in _TOPK_KINDS]
    if not aggs:
        return
    if key_ids.device.type == "cpu":
        topk_step_ref(spec, state, watermark, key_ids, ts, valid, cols)
        return
    args = _step_args(spec, state, watermark, key_ids, ts, valid, cols, aggs)
    args.locks = kb.ptr(_cell_locks(key_ids.device,
                                    spec.n_keys * spec.n_slots))
    if spec.window is not None:
        args.adv_div.m, args.adv_div.shift = divisor(spec.window.advance_ms)
        args.slot_div.m, args.slot_div.shift = divisor(spec.n_slots)
    args.mode, args.blocks = topk_plan(
        spec, args.cap, transport.sm_count(key_ids.device), mode)
    if args.mode == kb.TOPK_PRIVATE:
        bounds, args.epoch = _topk_bounds(
            key_ids.device, len(aggs) * spec.n_keys * spec.n_slots)
        args.bounds = kb.ptr(bounds)
    kb.check(kb.lib().hs_topk(ctypes.byref(args), kb.stream_of(ts)),
             "topk_fold")
    topk_step.launches += 1


topk_step.launches = 0  # wrapper calls that launched the kernel


def step_decoded(spec: LatticeSpec, state: dict[str, torch.Tensor],
                 watermark: int, key_ids, ts, valid,
                 cols: dict[str, torch.Tensor],
                 progs: StepPrograms = ()) -> None:
    """One decoded micro-batch, in place: the WHERE mask and computed
    inputs `progs` (step_programs; the expression kernel, launched only
    when there are any), then the scatter, then the top-k fold (only when
    the query has TOPK)."""
    eval_programs(progs, cols, valid)
    scatter_step(spec, state, watermark, key_ids, ts, valid, cols)
    topk_step(spec, state, watermark, key_ids, ts, valid, cols)


def step_encoded(spec: LatticeSpec, state: dict[str, torch.Tensor],
                 watermark: int, n: int, bases, words: torch.Tensor, combo,
                 cap: int, progs: StepPrograms = ()) -> None:
    """One micro-batch from the wire: decode, then step_decoded, in place
    (compiled_encoded_step, lattice.py:805-829 in the reference)."""
    key_ids, ts, valid, cols = transport.decode_batch(words, combo, cap, n,
                                                      bases)
    step_decoded(spec, state, watermark, key_ids, ts, valid, cols, progs)


# ---- the packed batch transport (lattice.py:304-385) ------------------------
#
# One int32 buffer [3 + n_cols, B] per micro-batch:
#   row 0: key ids        row 1: ts (relative ms)
#   row 2: flag bits — bit 0 valid, bit 1+j = NULL mask of the j-th
#          aggregate that has an input
#   row 3+i: the i-th needed column (f32 bits / i32 / bool as 0-1)
# The layout is a tuple of (column name, "f32" | "i32" | "bool"). The
# host packer numbers the masks over every entry of `null_masks`, None
# included, and the unpacker over the aggregates that have a mask only:
# the two disagree when a maskless aggregate (COUNT(*)) comes before a
# masked one. Both are the reference's loops, copied as they are.

ColLayout = tuple[tuple[str, str], ...]

_LAYOUT_TAG = {ColumnType.FLOAT: "f32", ColumnType.INT: "i32",
               ColumnType.BOOL: "bool", ColumnType.STRING: "i32"}


def layout_tag(ctype: ColumnType) -> str:
    return _LAYOUT_TAG[ctype]


def pack_batch_host(capacity: int, n: int, key_ids, ts_rel, valid,
                    cols: Mapping[str, np.ndarray],
                    null_masks: list[np.ndarray | None],
                    layout: ColLayout, out: np.ndarray | None = None
                    ) -> np.ndarray:
    """Assemble the packed int32 batch on the host (vectorized copies).
    `valid` may be None (all n records valid); `out`, when given, is the
    int32 [3 + len(layout), capacity] buffer to fill (a pinned staging
    buffer), else one is allocated."""
    shape = (3 + len(layout), capacity)
    if out is None:
        buf = np.zeros(shape, dtype=np.int32)
    else:
        if out.shape != shape or out.dtype != np.int32:
            raise ValueError("pack_batch_host: bad out buffer")
        buf = out
        buf[:, n:] = 0
    buf[0, :n] = key_ids[:n]
    buf[1, :n] = ts_rel[:n]
    if valid is None:
        flags = np.ones(n, dtype=np.int32)  # bit0: valid
    else:
        flags = valid[:n].astype(np.int32)
    for j, nm in enumerate(null_masks):
        if nm is not None:
            flags |= nm[:n].astype(np.int32) << (1 + j)
    buf[2, :n] = flags
    for i, (name, tag) in enumerate(layout):
        src = cols[name]
        if tag == "f32":
            buf[3 + i, :n] = src[:n].astype(np.float32, copy=False).view(
                np.int32)
        elif tag == "bool":
            buf[3 + i, :n] = src[:n].astype(np.int32)
        else:
            buf[3 + i, :n] = src[:n]
    return buf


def unpack_batch(packed: torch.Tensor, layout: ColLayout, null_keys):
    """Plain unpack: (key ids, ts, valid, cols) from a packed buffer,
    views of its rows (f32 rows reinterpreted), bool columns and NULL
    masks as bool tensors; `null_keys` names the mask of each aggregate
    (None where it has no input), as unpack_batch_device does."""
    flags = packed[2]
    valid = (flags & 1) != 0
    cols: dict[str, torch.Tensor] = {}
    for i, (name, tag) in enumerate(layout):
        row = packed[3 + i]
        if tag == "f32":
            cols[name] = row.view(torch.float32)
        elif tag == "bool":
            cols[name] = row != 0
        else:
            cols[name] = row
    for j, nk in enumerate(nk for nk in null_keys if nk is not None):
        cols[nk] = ((flags >> (1 + j)) & 1) != 0
    return packed[0], packed[1], valid, cols


def _unpack_cuda(packed: torch.Tensor, layout: ColLayout, null_keys):
    cap = packed.shape[1]
    args = kb.UnpackArgs()
    args.packed, args.cap = kb.ptr(packed), cap

    def byte_col() -> torch.Tensor:
        return torch.empty(cap, dtype=torch.bool, device=packed.device)

    valid = byte_col()
    args.valid = valid.data_ptr()
    cols: dict[str, torch.Tensor] = {}
    n_bool = 0
    for i, (name, tag) in enumerate(layout):
        row = packed[3 + i]
        if tag == "f32":
            cols[name] = row.view(torch.float32)
        elif tag == "i32":
            cols[name] = row
        else:
            if n_bool == kb.MAX_COLS:
                raise ValueError(f"more than {kb.MAX_COLS} bool columns")
            cols[name] = byte_col()
            args.bool_row[n_bool] = 3 + i
            args.bool_out[n_bool] = cols[name].data_ptr()
            n_bool += 1
    keys = [nk for nk in null_keys if nk is not None]
    if len(keys) > kb.MAX_AGGS:
        raise ValueError(f"more than {kb.MAX_AGGS} NULL masks")
    for j, nk in enumerate(keys):
        cols[nk] = byte_col()
        args.null_out[j] = cols[nk].data_ptr()
    args.n_bool, args.n_null = n_bool, len(keys)
    kb.check(kb.lib().hs_unpack(ctypes.byref(args), kb.stream_of(packed)),
             "unpack")
    return packed[0], packed[1], valid, cols


def unpack(packed: torch.Tensor, layout: ColLayout, null_keys):
    """(key ids, ts, valid, cols) of a packed batch: key ids, times, f32
    and i32 columns are views of its rows; valid, the bool columns and
    the NULL masks are one-byte columns written by the unpack kernel on
    the card, by unpack_batch on the CPU."""
    if (packed.dtype != torch.int32 or packed.dim() != 2
            or packed.shape[0] != 3 + len(layout)
            or not packed.is_contiguous()):
        raise ValueError("unpack: packed must be a contiguous int32 "
                         "[3 + n_cols, B] buffer")
    if packed.device.type == "cpu":
        return unpack_batch(packed, layout, null_keys)
    out = _unpack_cuda(packed, layout, null_keys)
    unpack.launches += 1
    return out


unpack.launches = 0  # wrapper calls that launched the kernel


def step_packed(spec: LatticeSpec, state: dict[str, torch.Tensor],
                watermark: int, packed: torch.Tensor, layout: ColLayout,
                null_keys, progs: StepPrograms = ()) -> None:
    """One micro-batch over the packed transport, in place: unpack, then
    step_decoded (build_step_packed, lattice.py:374-385 in the
    reference)."""
    key_ids, ts, valid, cols = unpack(packed, layout, null_keys)
    step_decoded(spec, state, watermark, key_ids, ts, valid, cols, progs)


# ---- finalize and pack ------------------------------------------------------


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


def out_rows(spec: LatticeSpec) -> int:
    """Rows the aggregates take in a packed buffer (k for TOPK)."""
    return sum(agg_width(a) for a in spec.aggs)


def finalize_column(spec: LatticeSpec, cols: Mapping[str, torch.Tensor]
                    ) -> dict[str, torch.Tensor]:
    """Finalize cell columns {plane: [..., width]} -> {out_name: [...]
    float32, or [..., k] for TOPK} (finalize_column, lattice.py:411-436
    in the reference)."""
    outs = {}
    count = cols["count"]
    for i, agg in enumerate(spec.aggs):
        name = _plane_name(i, agg)
        if agg.kind == AggKind.COUNT_ALL:
            outs[agg.out_name] = count.to(torch.float32)
        elif agg.kind == AggKind.AVG:
            n = cols[name + "_n"].to(torch.float32)
            outs[agg.out_name] = ftz(cols[name] / torch.clamp(n, min=1.0))
        elif agg.kind == AggKind.APPROX_COUNT_DISTINCT:
            outs[agg.out_name] = hll_estimate(cols[name], spec.hll)
        elif agg.kind == AggKind.APPROX_QUANTILE:
            outs[agg.out_name] = quantile_estimate(
                cols[name], agg.quantile or 0.5, spec.qcfg)
        elif agg.kind in (AggKind.MIN, AggKind.MAX):
            outs[agg.out_name] = torch.where(count > 0, cols[name],
                                             torch.zeros_like(cols[name]))
        elif agg.kind in _TOPK_KINDS:
            outs[agg.out_name] = cols[name]  # [..., k] pass-through
        else:
            outs[agg.out_name] = cols[name].to(torch.float32)
    return outs


def _agg_out_rows(spec: LatticeSpec, outs) -> list[torch.Tensor]:
    """Finalized outputs as bitcast int32 rows, k rows for a width-k
    aggregate (_agg_out_rows, lattice.py:439-448); the inverse is
    _unpack_agg_rows."""
    rows = []
    for agg in spec.aggs:
        o = outs[agg.out_name].to(torch.float32)
        if agg.kind in _TOPK_KINDS:
            rows.extend(o[..., j].contiguous().view(torch.int32)
                        for j in range(agg_width(agg)))
        else:
            rows.append(o.contiguous().view(torch.int32))
    return rows


def _unpack_agg_rows(spec: LatticeSpec, rows2d: np.ndarray):
    """int32 rows -> {name: [N] or [N, k] f32} (lattice.py:451-465)."""
    outs = {}
    row = 0
    for agg in spec.aggs:
        w = agg_width(agg)
        if agg.kind in _TOPK_KINDS:
            outs[agg.out_name] = np.stack(
                [rows2d[row + j].view(np.float32) for j in range(w)],
                axis=1)
        else:
            outs[agg.out_name] = rows2d[row].view(np.float32)
        row += w
    return outs


def pack_extract_rows(spec: LatticeSpec, count: torch.Tensor,
                      win_start: torch.Tensor,
                      outs: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Stack (count, win_start, finalized agg rows) into ONE int32 buffer
    [2 + rows, ...] (float outputs bitcast), so a close is one fetch."""
    rows = [count.to(torch.int32),
            win_start.to(torch.int32).expand_as(count)]
    rows.extend(_agg_out_rows(spec, outs))
    return torch.stack(rows)


def _finalize_args(spec: LatticeSpec, state) -> kb.Finalize:
    """The finalize half of the close and changelog kernels' arguments."""
    if spec.hll.precision < 2:
        raise ValueError("finalize kernels need HLL precision >= 2")
    if len(spec.aggs) > kb.MAX_AGGS:
        raise ValueError(f"more than {kb.MAX_AGGS} aggregates")
    f = kb.Finalize()
    m = spec.hll.m
    f.hll_p, f.hll_am2 = spec.hll.precision, _alpha(m) * m * m
    q = spec.qcfg
    f.q_min, f.q_gamma, f.q_half_gamma = (q.min_value, q.gamma_log,
                                          0.5 * q.gamma_log)
    row = 0
    for g, agg in enumerate(spec.aggs):
        a = f.a[g]
        a.kind, a.init = _KERNEL_KIND[agg.kind], init_value(agg)
        a.width, a.plane_width = agg_width(agg), _plane_width(spec, agg)
        a.q = agg.quantile or 0.5
        a.row, row = row, row + a.width
        if agg.kind != AggKind.COUNT_ALL:
            a.plane = kb.ptr(state[_plane_name(g, agg)])
        if agg.kind == AggKind.AVG:
            a.plane_n = kb.ptr(state[_plane_name(g, agg) + "_n"])
    f.n_aggs = len(spec.aggs)
    return f


# ---- the fused close --------------------------------------------------------


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


_SKETCH_KINDS = (AggKind.APPROX_COUNT_DISTINCT, AggKind.APPROX_QUANTILE)


def close_cell_bytes(spec: LatticeSpec) -> int:
    """The bytes one (key, slot) cell holds in the aggregates' planes."""
    return sum(_plane_width(spec, agg) * (
        1 if agg.kind == AggKind.APPROX_COUNT_DISTINCT else 4)
        + (4 if agg.kind == AggKind.AVG else 0)
        for agg in spec.aggs if agg.kind != AggKind.COUNT_ALL)


def close_plan(spec: LatticeSpec, mode: int) -> int:
    """The close kernel's lanes a key (csrc/close.cu): a warp where it
    finalizes a sketch (HLL, quantile: the estimates are warp
    reductions) or resets a cell of 256 bytes or more (16-byte stores
    over the cell), else one thread a key. A block holds
    kb.CLOSE_THREADS // lanes keys of one slot."""
    sketch = any(agg.kind in _SKETCH_KINDS for agg in spec.aggs)
    if (sketch and mode != CLOSE_RESET) or close_cell_bytes(spec) >= 256:
        return 32
    return 1


_done_mutex = threading.Lock()
_done: dict = {}


def _close_done(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The per-slot tile counters of the extract-and-reset closes on one
    device and stream, int32 [>= n], zeroed when made: the last tile of
    each slot sets its counter back to 0, so they stay zero from launch
    to launch (no fill before each one)."""
    with _done_mutex:
        buf = _done.get((device, stream))
        if buf is None or buf.numel() < n:
            buf = _done[(device, stream)] = torch.zeros(
                max(n, 64), dtype=torch.int32, device=device)
        return buf


def _close_args(spec: LatticeSpec, state, mode: int) -> kb.CloseArgs:
    """The close kernels' arguments but the slots and the output."""
    args = kb.CloseArgs()
    args.n_keys, args.n_slots, args.mode = spec.n_keys, spec.n_slots, mode
    args.lanes = close_plan(spec, mode)
    args.out_rows = 2 + out_rows(spec)
    args.f = _finalize_args(spec, state)
    args.count = kb.ptr(state["count"])
    args.slot_start = kb.ptr(state["slot_start"])
    args.touched = kb.ptr(state["touched"])
    return args


def _close_cuda(spec: LatticeSpec, state, slots: np.ndarray, mode: int
                ) -> torch.Tensor | None:
    K, P = spec.n_keys, len(slots)
    dev = state["count"].device
    args = _close_args(spec, state, mode)
    args.n_sel = P
    if P <= kb.CLOSE_INLINE:   # by value in the arguments: no upload
        args.sel[:P] = [int(x) for x in slots]
    else:
        slots_t = torch.from_numpy(slots).to(dev)
        args.slots = kb.ptr(slots_t)
    out = None
    if mode != CLOSE_RESET:
        out = torch.empty((P, args.out_rows, K), dtype=torch.int32,
                          device=dev)
        args.out = out.data_ptr()
    stream = kb.stream_of(state["count"])
    if mode == CLOSE_EXTRACT_RESET:
        args.done = _close_done(dev, stream, P).data_ptr()
    kb.check(kb.lib().hs_close(ctypes.byref(args), stream), "fused_close")
    return out


def _checked_slots(spec: LatticeSpec, slots, mode: int) -> np.ndarray:
    slots = np.asarray(slots, np.int32)
    live = slots[slots >= 0]
    if (live >= spec.n_slots).any():
        raise ValueError("close: slot index out of range")
    if mode != CLOSE_EXTRACT and len(np.unique(live)) != len(live):
        raise ValueError("close: a slot named twice would be read after "
                         "its reset")
    return slots


def close_slots(spec: LatticeSpec, state: dict[str, torch.Tensor],
                slots: np.ndarray, mode: int = CLOSE_EXTRACT_RESET
                ) -> torch.Tensor | None:
    """The fused close over a padded slot vector (host int32 [P], < 0 =
    padding), one launch: CLOSE_EXTRACT_RESET returns the packed int32
    [P, 2+rows, K] buffer and resets those slots in place, from pre-reset
    values; CLOSE_EXTRACT only extracts (peek); CLOSE_RESET is
    reset_slots. The close kernel on the card, the plain versions on the
    CPU."""
    if mode == CLOSE_RESET:
        reset_slots(spec, state, slots)
        return None
    slots = _checked_slots(spec, slots, mode)
    if state["count"].device.type == "cpu":
        slots_t = torch.from_numpy(slots)
        packed = extract_slots_ref(spec, state, slots_t)
        if mode != CLOSE_EXTRACT:
            reset_slots_ref(spec, state, slots_t)
        return packed
    out = _close_cuda(spec, state, slots, mode)
    close_slots.launches += 1
    if mode == CLOSE_EXTRACT:
        close_slots.extract_launches += 1
    return out


close_slots.launches = 0  # wrapper calls that launched the kernel
close_slots.extract_launches = 0  # of those, extract-only ones (peek, B3)


def reset_slots(spec: LatticeSpec, state: dict[str, torch.Tensor],
                slots: np.ndarray) -> None:
    """Reset the slots of a padded slot vector without extracting, in
    place (build_reset_slots, lattice.py:654-664: an EMIT CHANGES close,
    whose changelog already carried the final values): the close kernel's
    reset-only mode on the card, reset_slots_ref on the CPU."""
    slots = _checked_slots(spec, slots, CLOSE_RESET)
    if state["count"].device.type == "cpu":
        reset_slots_ref(spec, state, torch.from_numpy(slots))
        return
    _close_cuda(spec, state, slots, CLOSE_RESET)
    reset_slots.launches += 1


reset_slots.launches = 0  # wrapper calls that launched the kernel


# ---- the per-slot close ------------------------------------------------------


def extract_slot_ref(spec: LatticeSpec, state: dict[str, torch.Tensor],
                     slot: int) -> torch.Tensor:
    """Plain extract of one slot column -> packed int32 [2+rows, K]
    (build_extract_slot, lattice.py:529-544 in the reference)."""
    col = {k: v[:, slot] for k, v in state.items()
           if k not in ("slot_start", "touched")}
    outs = finalize_column(spec, col)
    return pack_extract_rows(spec, col["count"], state["slot_start"][slot],
                             outs)


def reset_slot_ref(spec: LatticeSpec, state: dict[str, torch.Tensor],
                   slot: int) -> None:
    """Plain reset of one slot column, in place (build_reset_slot,
    lattice.py:547-563)."""
    for i, agg in enumerate(spec.aggs):
        if agg.kind == AggKind.COUNT_ALL:
            continue  # no own plane; `count` below resets it
        name = _plane_name(i, agg)
        state[name][:, slot] = init_value(agg)
        if agg.kind == AggKind.AVG:
            state[name + "_n"][:, slot] = 0
    state["count"][:, slot] = 0
    state["touched"][:, slot] = False
    state["slot_start"][slot] = EMPTY_START


def _one_slot(spec: LatticeSpec, slot) -> int:
    slot = int(slot)
    if not 0 <= slot < spec.n_slots:
        raise ValueError(f"slot {slot} out of range [0, {spec.n_slots})")
    return slot


def _close_slot_cuda(spec: LatticeSpec, state, slot: int, mode: int
                     ) -> torch.Tensor | None:
    args = _close_args(spec, state, mode)
    args.n_sel, args.slot = 1, slot
    out = None
    if mode == CLOSE_EXTRACT:
        out = torch.empty((args.out_rows, spec.n_keys), dtype=torch.int32,
                          device=state["count"].device)
        args.out = out.data_ptr()
    kb.check(kb.lib().hs_close_slot(ctypes.byref(args),
                                    kb.stream_of(state["count"])),
             "close_slot")
    return out


def extract_slot(spec: LatticeSpec, state: dict[str, torch.Tensor],
                 slot) -> torch.Tensor:
    """Finalize one slot column -> packed int32 [2+rows, K] (the layout
    of pack_extract_rows), one launch of the close kernel's per-slot
    entry in extract mode; extract_slot_ref on the CPU."""
    slot = _one_slot(spec, slot)
    if state["count"].device.type == "cpu":
        return extract_slot_ref(spec, state, slot)
    out = _close_slot_cuda(spec, state, slot, CLOSE_EXTRACT)
    extract_slot.launches += 1
    return out


extract_slot.launches = 0  # wrapper calls that launched the kernel


def reset_slot(spec: LatticeSpec, state: dict[str, torch.Tensor],
               slot) -> None:
    """Reset one slot column of every plane, in place, one launch of the
    close kernel's per-slot entry in reset mode; reset_slot_ref on the
    CPU."""
    slot = _one_slot(spec, slot)
    if state["count"].device.type == "cpu":
        reset_slot_ref(spec, state, slot)
        return
    _close_slot_cuda(spec, state, slot, CLOSE_RESET)
    reset_slot.launches += 1


reset_slot.launches = 0  # wrapper calls that launched the kernel


def unpack_extract_rows(spec: LatticeSpec, packed: np.ndarray):
    """(count [K], win_start [K], {name: [K] or [K, k] f32}) from one
    slot's packed rows."""
    return packed[0], packed[1], _unpack_agg_rows(spec, packed[2:])


def gather_extract_batch(spec: LatticeSpec, packed: np.ndarray,
                         widx: np.ndarray, kids: np.ndarray):
    """Columnar gather over a fetched extract buffer [P, 2+rows, K]: for
    the selected (window, key) pairs, {out_name: [n] f64 or [n, k] f32}
    (gather_extract_batch, lattice.py:506-526)."""
    outs: dict[str, np.ndarray] = {}
    row = 2
    for agg in spec.aggs:
        w = agg_width(agg)
        if agg.kind in _TOPK_KINDS:
            outs[agg.out_name] = np.stack(
                [np.ascontiguousarray(packed[widx, row + j, kids])
                 .view(np.float32) for j in range(w)], axis=1)
        else:
            outs[agg.out_name] = np.ascontiguousarray(
                packed[widx, row, kids]).view(np.float32).astype(np.float64)
        row += w
    return outs


# ---- the changelog extract (EMIT CHANGES) -----------------------------------


def touched_max_out(spec: LatticeSpec, batch_capacity: int) -> int:
    """Columns of a changelog extract: the touched-pair space, capped by
    what one batch can touch (the reference's executor.py:313-314)."""
    return min(batch_capacity * spec.windows_per_record,
               spec.n_keys * spec.n_slots)


def pack_touched_rows(spec: LatticeSpec, n, kidx: torch.Tensor,
                      win_start: torch.Tensor, outs, max_out: int
                      ) -> torch.Tensor:
    """ONE int32 buffer [3 + rows, max_out]: row0 col0 = n, row1 = key
    ids, row2 = win starts, rows 3+ = bitcast float agg outputs, k rows
    for a width-k aggregate (pack_touched_rows, lattice.py:675-683)."""
    row0 = torch.zeros(max_out, dtype=torch.int32, device=kidx.device)
    row0[0] = n
    rows = [row0, kidx.to(torch.int32), win_start.to(torch.int32)]
    rows.extend(_agg_out_rows(spec, outs))
    return torch.stack(rows)


def unpack_touched_rows(spec: LatticeSpec, packed: np.ndarray):
    """(n, kidx [n], win_start [n], {name: [n] or [n, k] f32})."""
    n = int(packed[0, 0])
    outs = _unpack_agg_rows(spec, packed[3:, :n])
    return n, packed[1, :n], packed[2, :n], outs


def extract_touched_ref(spec: LatticeSpec, state: dict[str, torch.Tensor],
                        max_out: int) -> torch.Tensor:
    """Plain changelog extract (build_extract_touched, lattice.py:
    693-720): every touched (key, slot) cell in jnp.nonzero's order,
    finalized and packed; columns past n hold the nonzero fill (cell
    (0, 0)). Clears `touched` in place."""
    K, W = spec.n_keys, spec.n_slots
    flat = state["touched"].reshape(-1)
    hit = torch.nonzero(flat).reshape(-1)
    n = int(hit.shape[0])
    cells = torch.zeros(max_out, dtype=torch.int64, device=flat.device)
    cells[:min(n, max_out)] = hit[:max_out]
    col = {k: v.reshape((K * W,) + tuple(v.shape[2:]))[cells]
           for k, v in state.items() if k not in ("slot_start", "touched")}
    outs = finalize_column(spec, col)
    valid = torch.arange(max_out, device=flat.device) < n
    win = torch.where(valid, state["slot_start"][cells % W],
                      torch.zeros_like(cells, dtype=torch.int32))
    packed = pack_touched_rows(spec, n, cells // W, win, outs, max_out)
    state["touched"].zero_()
    return packed


def touched_plan(spec: LatticeSpec, max_out: int,
                 mode: int | None = None) -> int:
    """The touched extract's mode: one launch (kb.TOUCHED_ONE) for a
    lattice of at most 4096 cells whose rows fit its shared memory, else
    the staged scan and finalize (kb.TOUCHED_STAGED). `mode` forces one;
    forcing the single launch where it does not fit raises ValueError."""
    fits = (spec.n_keys * spec.n_slots <= kb.TOUCHED_ONE_CELLS
            and 3 + out_rows(spec) <= kb.TOUCHED_ONE_ROWS)
    if mode is None:
        return kb.TOUCHED_ONE if fits else kb.TOUCHED_STAGED
    if mode == kb.TOUCHED_ONE and not fits:
        raise ValueError("touched extract: the single launch takes at most "
                         f"{kb.TOUCHED_ONE_CELLS} cells and "
                         f"{kb.TOUCHED_ONE_ROWS} rows")
    if mode not in (kb.TOUCHED_ONE, kb.TOUCHED_STAGED):
        raise ValueError(f"touched extract: unknown mode {mode}")
    return mode


def _touched_cuda(spec: LatticeSpec, state, max_out: int,
                  mode: int | None) -> torch.Tensor:
    dev = state["count"].device
    args = kb.TouchedArgs()
    args.n_keys, args.n_slots, args.max_out = \
        spec.n_keys, spec.n_slots, max_out
    args.out_rows = 3 + out_rows(spec)
    args.mode = touched_plan(spec, max_out, mode)
    args.has_sketch = any(a.kind in (AggKind.APPROX_COUNT_DISTINCT,
                                     AggKind.APPROX_QUANTILE)
                          for a in spec.aggs)
    args.f = _finalize_args(spec, state)
    args.count = kb.ptr(state["count"])
    args.slot_start = kb.ptr(state["slot_start"])
    args.touched = kb.ptr(state["touched"])
    out = torch.empty((args.out_rows, max_out), dtype=torch.int32,
                      device=dev)
    args.out = out.data_ptr()
    scratch = torch.empty(kb.lib().hs_touched_scratch_bytes(
        spec.n_keys * spec.n_slots, max_out, args.out_rows),
        dtype=torch.uint8, device=dev)
    args.scratch = scratch.data_ptr()
    kb.check(kb.lib().hs_touched(ctypes.byref(args), kb.stream_of(out)),
             "touched_extract")
    return out


def extract_touched(spec: LatticeSpec, state: dict[str, torch.Tensor],
                    max_out: int, mode: int | None = None) -> torch.Tensor:
    """The changelog extract: packed int32 [3 + rows, max_out] of every
    (key, slot) cell touched since the last call, with `touched` cleared,
    in one wrapper call: the touched-extract kernels on the card (one
    launch for a lattice of at most 4096 cells; else a one-pass scan and
    a finalize, and a pass for the HLL and quantile estimates;
    touched_plan, `mode` forces one), extract_touched_ref on the CPU."""
    if state["count"].device.type == "cpu":
        return extract_touched_ref(spec, state, max_out)
    out = _touched_cuda(spec, state, max_out, mode)
    extract_touched.launches += 1
    return out


extract_touched.launches = 0  # wrapper calls that launched the kernel


# ---- rebase -----------------------------------------------------------------

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


# ---- the compiled bundle (lattice.py:750-803) --------------------------------


def compile_agg_inputs(spec: LatticeSpec, schema) -> tuple[
        list[tuple[DeviceProgram | None, str | None]], tuple[str | None, ...]]:
    """Each aggregate's input program and NULL-mask column key (None for
    COUNT(*)), as compile_agg_inputs (lattice.py:750-765) gives them."""
    agg_inputs: list[tuple[DeviceProgram | None, str | None]] = []
    null_keys: list[str | None] = []
    for i, agg in enumerate(spec.aggs):
        if agg.input is None:
            agg_inputs.append((None, None))
            null_keys.append(None)
        else:
            key = null_key(i)
            agg_inputs.append((compile_device(agg.input, schema), key))
            null_keys.append(key)
    return agg_inputs, tuple(null_keys)


class CompiledLattice(NamedTuple):
    """A query's lattice programs with the reference's signatures (state
    in, state out). The port's programs update the state in place, so
    each callable that returns a state returns the dict it was given,
    updated; a bundle holds no state of its own."""

    step: Callable                 # (state, watermark, packed) -> state
    extract_slot: Callable         # (state, slot) -> [2+rows, K]
    reset_slot: Callable           # (state, slot) -> state
    extract_reset_slots: Callable  # (state, slots) -> (state, [P, 2+rows, K])
    extract_slots: Callable        # (state, slots) -> [P, 2+rows, K] (peek)
    reset_slots: Callable          # (state, slots) -> state
    extract_touched: Callable      # (state) -> (state, [3+rows, max_out])
    null_keys: tuple[str | None, ...]  # per agg: the __null_a{i} column


@functools.lru_cache(maxsize=512)
@compile_site("lattice.compiled")
def compiled(spec: LatticeSpec, schema, filter_expr: Expr | None,
             max_out: int, layout: ColLayout) -> CompiledLattice:
    """Shared, cached compilation of a query's lattice programs for a
    (spec, schema, filter, layout): executors of the same shape share
    one bundle (compiled, lattice.py:768-803 in the reference). String
    literals must be pre-encoded (expr.encode_strings). A miss counts
    as one compile (common/tracing.RetraceGuard) and one row of the
    compiled-program inventory."""
    _agg_inputs, null_keys = compile_agg_inputs(spec, schema)
    progs = step_programs(spec, schema, filter_expr)

    def step(state, watermark, packed):
        step_packed(spec, state, watermark, packed, layout, null_keys,
                    progs)
        return state

    def extract_slot_fn(state, slot):
        return extract_slot(spec, state, slot)

    def reset_slot_fn(state, slot):
        reset_slot(spec, state, slot)
        return state

    def extract_reset_slots(state, slots):
        return state, close_slots(spec, state, slots, CLOSE_EXTRACT_RESET)

    def extract_slots(state, slots):
        return close_slots(spec, state, slots, CLOSE_EXTRACT)

    def reset_slots_fn(state, slots):
        reset_slots(spec, state, slots)
        return state

    def extract_touched_fn(state):
        return state, extract_touched(spec, state, max_out)

    return CompiledLattice(
        step=step, extract_slot=extract_slot_fn, reset_slot=reset_slot_fn,
        extract_reset_slots=extract_reset_slots,
        extract_slots=extract_slots, reset_slots=reset_slots_fn,
        extract_touched=extract_touched_fn, null_keys=null_keys)
