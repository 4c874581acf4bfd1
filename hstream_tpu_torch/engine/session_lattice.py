"""The session-window lattice: the open-session arena and its four device
programs (the port of the session half of hstream_tpu/engine/lattice.py,
:1180-1568). Batches arrive over the packed record transport, which lives
in engine/lattice.py as in the reference (:304-371).

Open sessions live in an ARENA of slots (key code, t0, t1, accumulator
planes) sorted by (code, t0); empty and evicted slots hold the sentinel
code 2^22. Each micro-batch sorts (arena entries + batch entries) by
(code, start), breaks chains at a code change or where start passes the
running end + gap, and folds each chain into one slot of a FRESH arena:
merge and compaction are the same fold. The port keeps two arenas per
executor and ping-pongs between them (the reference builds a new one
functionally per batch). All times are int32 ms relative to the host's
epoch.

Each program is a hand-written Hopper kernel (engine/kernels/csrc),
reached through a wrapper that launches it when its tensors lie on the
card and counts the launch in `.launches`, and runs the plain PyTorch
version in this module only when they lie on the CPU:

  session_step    <- session_step_kernel     (csrc/session_step.cu)
  session_merge   <- session_merge_kernel    (csrc/session_merge.cu)
  session_extract <- session_extract_kernel  (csrc/session_extract.cu)
  session_remap   <- session_remap_kernel    (csrc/session_remap.cu)

The step and the merge share their sort + segmented-scan core
(csrc/session_chain.cuh; plain: chain_slots). A computed aggregate input
is evaluated by the expression kernel first (session_inputs ->
expr.eval_programs), as the window step does.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from hstream_tpu_torch.engine.expr import (
    Col,
    DeviceProgram,
    compile_device,
    eval_programs,
    ftz,
)
from hstream_tpu_torch.engine.kernels import binding as kb
from hstream_tpu_torch.engine.lattice import (  # noqa: F401 — the packed
    _KERNEL_KIND,                                # transport, re-exported
    ColLayout,
    _plane_name,
    layout_tag,
    pack_batch_host,
    unpack_batch,
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

# ---- the arena (lattice.py:1180-1296) ---------------------------------------

SESSION_SENT_CODE = kb.SESSION_SENT  # == JOIN_SENT_CODE, 1 << 22
_SESSION_NEG = -(1 << 30)            # the scan's "minus infinity"
_I32_MAX = (1 << 31) - 1


@dataclass(frozen=True)
class SessionSpec:
    """Static configuration of the session programs."""

    aggs: tuple[AggSpec, ...]
    hll: HLLConfig = HLLConfig()
    qcfg: QuantileConfig = QuantileConfig()


def session_plane_names(spec: SessionSpec) -> list[str]:
    """The plane of each aggregate: aggregates with the same (kind, input)
    share one plane (p50 and p99 of one column keep one histogram); the
    first such aggregate owns it, and only the owner updates it."""
    seen: dict = {}
    out: list[str] = []
    for i, agg in enumerate(spec.aggs):
        key = (agg.kind, agg.input)
        name = seen.get(key)
        if name is None:
            name = _plane_name(i, agg)
            seen[key] = name
        out.append(name)
    return out


def _owners(spec: SessionSpec) -> list[tuple[int, str, AggSpec]]:
    """(agg index, plane name, agg) of each plane's owner, in order."""
    done: set[str] = set()
    out = []
    for i, (name, agg) in enumerate(zip(session_plane_names(spec),
                                        spec.aggs)):
        if name not in done:
            done.add(name)
            out.append((i, name, agg))
    return out


def session_plane_np(spec: SessionSpec, cap: int) -> dict[str, np.ndarray]:
    """Empty arena planes on the host (numpy), identities in every slot."""
    arena: dict[str, np.ndarray] = {
        "code": np.full(cap, SESSION_SENT_CODE, np.int32),
        "t0": np.zeros(cap, np.int32),
        "t1": np.zeros(cap, np.int32),
    }
    for _i, name, agg in _owners(spec):
        if agg.kind in (AggKind.COUNT_ALL, AggKind.COUNT):
            arena[name] = np.zeros(cap, np.int32)
        elif agg.kind == AggKind.SUM:
            arena[name] = np.zeros(cap, np.float32)
        elif agg.kind == AggKind.AVG:
            arena[name] = np.zeros(cap, np.float32)
            arena[name + "_n"] = np.zeros(cap, np.int32)
        elif agg.kind == AggKind.MIN:
            arena[name] = np.full(cap, np.inf, np.float32)
        elif agg.kind == AggKind.MAX:
            arena[name] = np.full(cap, -np.inf, np.float32)
        elif agg.kind == AggKind.APPROX_COUNT_DISTINCT:
            arena[name] = np.zeros((cap, spec.hll.m), np.int8)
        elif agg.kind == AggKind.APPROX_QUANTILE:
            arena[name] = np.zeros((cap, spec.qcfg.n_bins), np.int32)
        else:
            raise NotImplementedError(f"session agg {agg.kind}")
    return arena


def init_session_arena(spec: SessionSpec, cap: int,
                       device: str | torch.device) -> dict[str, torch.Tensor]:
    """One empty arena on `device` (from session_plane_np, so the
    per-kind dtype and identity table lives in one place)."""
    return {k: torch.from_numpy(v).to(device)
            for k, v in session_plane_np(spec, cap).items()}


def grow_session_arena(spec: SessionSpec, arena: Mapping[str, torch.Tensor],
                       new_cap: int) -> dict[str, torch.Tensor]:
    """Every plane padded to new_cap, identities in the tail."""
    dev = arena["code"].device
    fresh = init_session_arena(spec, new_cap, dev)
    for k, v in arena.items():
        fresh[k][:v.shape[0]] = v
    return fresh


# ---- inputs -----------------------------------------------------------------

SessionPrograms = tuple[tuple[DeviceProgram, str], ...]


def session_programs(spec: SessionSpec, schema) -> SessionPrograms:
    """One expression program per computed aggregate input (its column
    "__in_a{i}"), compiled once; bare columns are read straight from the
    packed rows."""
    return tuple((compile_device(agg.input, schema), f"__in_a{i}")
                 for i, name, agg in _owners(spec)
                 if agg.input is not None and not isinstance(agg.input, Col))


def null_keys(spec: SessionSpec) -> tuple[str | None, ...]:
    """Each aggregate's NULL-mask column name (None without an input)."""
    return tuple(None if a.input is None else f"__null_a{i}"
                 for i, a in enumerate(spec.aggs))


def session_inputs(spec: SessionSpec, layout: ColLayout,
                   packed: torch.Tensor, progs: SessionPrograms = ()
                   ) -> tuple[torch.Tensor | None, ...]:
    """Each aggregate's input column over a packed batch (None for
    COUNT(*) and for a plane it does not own): a bare column's packed row
    (f32 reinterpreted; an int or bool row as int32), or the column a
    computed input's program writes (the expression kernel on the card,
    one launch for all programs)."""
    rows = {name: 3 + i for i, (name, _tag) in enumerate(layout)}
    tags = dict(layout)
    computed: dict[str, torch.Tensor] = {}
    if progs:
        _codes, _ts, valid, cols = unpack_batch(packed, layout, ())
        eval_programs(progs, cols, valid)
        computed = cols
    out: list[torch.Tensor | None] = [None] * len(spec.aggs)
    for i, _name, agg in _owners(spec):
        if agg.input is None:
            continue
        if isinstance(agg.input, Col):
            row = packed[rows[agg.input.name]]
            out[i] = (row.view(torch.float32)
                      if tags[agg.input.name] == "f32" else row)
        else:
            out[i] = computed[f"__in_a{i}"]
    return tuple(out)


# ---- plain versions ---------------------------------------------------------

def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value of its low 32 bits, as int64."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def chain_slots(code: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
                gap: int, cap: int) -> torch.Tensor:
    """The plain sort + segmented scan (_session_chain_slots,
    lattice.py:1298-1324): per entry, the slot of its chain in the fresh
    arena, or cap for a sentinel. Codes outside [0, 2^22) count as the
    sentinel, as in the kernel."""
    code = code.to(torch.int64)
    code = torch.where((code >= 0) & (code < SESSION_SENT_CODE), code,
                       SESSION_SENT_CODE)
    start = start.to(torch.int64)
    end = end.to(torch.int64)
    key = (code << 32) | (start + (1 << 31))
    order = torch.sort(key, stable=True).indices
    sc, ss, se = code[order], start[order], end[order]
    m = sc.shape[0]
    newrun = torch.ones(m, dtype=torch.bool, device=sc.device)
    newrun[1:] = sc[1:] != sc[:-1]
    # the running max of end within each code: codes sort ascending, so
    # shifting each code's ends into its own band of width 2^33 makes
    # one cummax restart at every code change
    band = sc << 33
    runmax = torch.cummax(band + (se + (1 << 31)), 0).values - band \
        - (1 << 31)
    prev = torch.empty_like(runmax)
    prev[0] = _SESSION_NEG
    prev[1:] = runmax[:-1]
    brk = newrun | (ss > _wrap32(prev + int(gap)))
    cid = torch.cumsum(brk.to(torch.int64), 0) - 1
    slot = torch.where(sc < SESSION_SENT_CODE, cid, cap)
    dest = torch.empty(m, dtype=torch.int64, device=sc.device)
    dest[order] = slot
    return dest


def _retired(arena, close_cut: int, delta: int):
    """The arena's entries after the retire-then-shift: (code, t0, t1)
    int64, the sentinel where not live."""
    code = arena["code"].to(torch.int64)
    alive = ((code >= 0) & (code < SESSION_SENT_CODE)
             & (arena["t1"] > int(close_cut)))
    t0 = torch.where(alive, _wrap32(arena["t0"].to(torch.int64)
                                    - int(delta)), 0)
    t1 = torch.where(alive, _wrap32(arena["t1"].to(torch.int64)
                                    - int(delta)), 0)
    return torch.where(alive, code, SESSION_SENT_CODE), t0, t1


def _fill_identities(spec: SessionSpec, out: dict[str, torch.Tensor]):
    """The fold's starting arena: every accumulator plane at its identity
    (session_plane_np's), the code the sentinel, and t0 / t1 the
    identities of their min / max (empty slots get 0 / 0 after the
    fold)."""
    for k, v in session_plane_np(spec, 1).items():
        out[k].copy_(torch.from_numpy(v).expand_as(out[k]))
    out["t0"].fill_(_I32_MAX)
    out["t1"].fill_(_SESSION_NEG)


def _fold_times(out, d: torch.Tensor, code, t0, t1) -> None:
    out["code"].scatter_reduce_(0, d, code.to(torch.int32), "amin")
    out["t0"].scatter_reduce_(0, d, t0.to(torch.int32), "amin")
    out["t1"].scatter_reduce_(0, d, t1.to(torch.int32), "amax")


def _fold_rows(spec: SessionSpec, out, src: Mapping[str, torch.Tensor],
               d: torch.Tensor, sel: torch.Tensor) -> None:
    """Row merges of the planes of `src` (rows `sel`) into slots `d`."""
    for _i, name, agg in _owners(spec):
        names = [name] if agg.kind != AggKind.AVG else [name, name + "_n"]
        for nm in names:
            rows = src[nm][sel]
            if agg.kind in (AggKind.MIN, AggKind.MAX,
                            AggKind.APPROX_COUNT_DISTINCT):
                op = "amin" if agg.kind == AggKind.MIN else "amax"
                idx = d.view((-1,) + (1,) * (rows.dim() - 1)).expand_as(rows)
                out[nm].scatter_reduce_(0, idx, rows, op)
            else:  # counts, sums, histograms: additive
                out[nm].index_add_(0, d, rows)


def _flush_planes(spec: SessionSpec, out) -> None:
    """The SUM / AVG / MIN / MAX planes flushed of subnormals, as the
    reference's float adds and min/max flush them (once here, after the
    fold)."""
    for _i, name, agg in _owners(spec):
        if agg.kind in (AggKind.SUM, AggKind.AVG, AggKind.MIN, AggKind.MAX):
            out[name].copy_(ftz(out[name]))


def _empty_fixup(out) -> None:
    empty = out["code"] >= SESSION_SENT_CODE
    out["t0"].masked_fill_(empty, 0)
    out["t1"].masked_fill_(empty, 0)


def _fold_old_arena(spec, arena, out, dest, cap, close_cut, delta) -> None:
    acode, at0, at1 = _retired(arena, close_cut, delta)
    da = dest[:cap]
    ka = da < cap
    _fold_times(out, da[ka], acode[ka], at0[ka], at1[ka])
    _fold_rows(spec, out, arena, da[ka], ka)


def session_step_ref(spec: SessionSpec, arena: Mapping[str, torch.Tensor],
                     out: dict[str, torch.Tensor], packed: torch.Tensor,
                     inputs, gap: int, close_cut: int, delta: int) -> None:
    """Plain record-mode step (session_step_kernel, lattice.py:1327-1429):
    fold the old arena and the packed batch into `out`, in place."""
    cap = arena["code"].shape[0]
    bcode, ts, flags = (packed[0].to(torch.int64), packed[1].to(torch.int64),
                        packed[2])
    valid = (flags & 1) != 0
    bcode = torch.where(valid, bcode, SESSION_SENT_CODE)
    acode, at0, at1 = _retired(arena, close_cut, delta)
    dest = chain_slots(torch.cat([acode, bcode]), torch.cat([at0, ts]),
                       torch.cat([at1, ts]), gap, cap)
    _fill_identities(spec, out)
    _fold_old_arena(spec, arena, out, dest, cap, close_cut, delta)
    db = dest[cap:]
    kb_ = db < cap
    d = db[kb_]
    _fold_times(out, d, bcode[kb_], ts[kb_], ts[kb_])
    bits = _null_bits(spec)
    for i, name, agg in _owners(spec):
        if agg.kind == AggKind.COUNT_ALL:
            out[name].index_add_(0, d, torch.ones_like(d, dtype=torch.int32))
            continue
        v = inputs[i][kb_]
        ok = ((flags[kb_] >> bits[i]) & 1) == 0 if bits[i] else \
            torch.ones_like(d, dtype=torch.bool)
        if v.dtype == torch.float32:
            ok &= torch.isfinite(v)
        vf = ftz(v.to(torch.float32))[ok]
        dk = d[ok]
        ones = torch.ones_like(dk, dtype=torch.int32)
        if agg.kind == AggKind.COUNT:
            out[name].index_add_(0, dk, ones)
        elif agg.kind in (AggKind.SUM, AggKind.AVG):
            out[name].index_add_(0, dk, vf)
            if agg.kind == AggKind.AVG:
                out[name + "_n"].index_add_(0, dk, ones)
        elif agg.kind in (AggKind.MIN, AggKind.MAX):
            out[name].scatter_reduce_(
                0, dk, vf, "amin" if agg.kind == AggKind.MIN else "amax")
        elif agg.kind == AggKind.APPROX_COUNT_DISTINCT:
            reg, rank = hll_update_indices(vf, spec.hll)
            out[name].view(-1).scatter_reduce_(
                0, dk * spec.hll.m + reg, rank.to(torch.int8), "amax")
        else:  # APPROX_QUANTILE
            b = quantile_bin(vf, spec.qcfg).to(torch.int64)
            out[name].view(-1).index_add_(0, dk * spec.qcfg.n_bins + b, ones)
    _flush_planes(spec, out)
    _empty_fixup(out)


def session_merge_ref(spec: SessionSpec, arena: Mapping[str, torch.Tensor],
                      out: dict[str, torch.Tensor],
                      seg: Mapping[str, torch.Tensor], gap: int,
                      close_cut: int, delta: int) -> None:
    """Plain segment-mode merge (session_merge_kernel, lattice.py:
    1432-1501): fold the old arena and the segment planes into `out`."""
    cap = arena["code"].shape[0]
    acode, at0, at1 = _retired(arena, close_cut, delta)
    scode = seg["code"].to(torch.int64)
    dest = chain_slots(torch.cat([acode, scode]),
                       torch.cat([at0, seg["t0"].to(torch.int64)]),
                       torch.cat([at1, seg["t1"].to(torch.int64)]), gap, cap)
    _fill_identities(spec, out)
    _fold_old_arena(spec, arena, out, dest, cap, close_cut, delta)
    db = dest[cap:]
    ks = db < cap
    _fold_times(out, db[ks], scode[ks], seg["t0"][ks], seg["t1"][ks])
    _fold_rows(spec, out, seg, db[ks], ks)
    _flush_planes(spec, out)
    _empty_fixup(out)


def session_extract_ref(spec: SessionSpec, arena: Mapping[str, torch.Tensor],
                        slots: torch.Tensor) -> torch.Tensor:
    """Plain extract (session_extract_kernel, lattice.py:1504-1550): the
    named slots (< 0 = padding) finalized into int32 [1 + n_aggs, P]."""
    ok = slots >= 0
    at = torch.where(ok, slots, 0).to(torch.int64)
    zero = torch.zeros((), dtype=torch.float32, device=slots.device)
    rows = [torch.where(ok, arena["code"][at], SESSION_SENT_CODE)]
    for name, agg in zip(session_plane_names(spec), spec.aggs):
        if agg.kind in (AggKind.COUNT_ALL, AggKind.COUNT):
            rows.append(torch.where(ok, arena[name][at], 0))
            continue
        if agg.kind == AggKind.APPROX_COUNT_DISTINCT:
            est = hll_estimate(arena[name][at], spec.hll)
            rows.append(torch.where(ok, torch.round(est).to(torch.int32), 0))
            continue
        if agg.kind == AggKind.AVG:
            n = arena[name + "_n"][at].to(torch.float32)
            v = ftz(arena[name][at] / torch.clamp(n, min=1.0))
        elif agg.kind in (AggKind.MIN, AggKind.MAX):
            v = arena[name][at]
            none = float("inf") if agg.kind == AggKind.MIN else float("-inf")
            v = torch.where(v == none, zero, v)
        elif agg.kind == AggKind.APPROX_QUANTILE:
            hist = arena[name][at]
            est = quantile_estimate(hist, agg.quantile or 0.5, spec.qcfg)
            v = torch.where(hist.to(torch.int64).sum(-1) > 0, est, zero)
        else:
            v = arena[name][at].to(torch.float32)
        rows.append(torch.where(ok, v, zero).contiguous().view(torch.int32))
    return torch.stack(rows)


def session_remap_ref(arena: dict[str, torch.Tensor],
                      lut: torch.Tensor, sent_above: bool = False) -> None:
    """Plain remap (session_remap_kernel, lattice.py:1553-1568), in place:
    code < lcap ? lut[clip(code)] : code. With `sent_above` (the interval
    join's remap, join.py:2092-2108) a code at or above lcap becomes the
    sentinel 2^22 instead."""
    code = arena["code"]
    lcap = lut.shape[0]
    mapped = lut[torch.clamp(code, 0, lcap - 1).to(torch.int64)]
    above = (torch.full_like(code, kb.SESSION_SENT) if sent_above
             else code)
    code.copy_(torch.where(code < lcap, mapped, above))


# ---- the kernels' wrappers --------------------------------------------------

def _null_bits(spec: SessionSpec) -> list[int]:
    """Flag bit of each aggregate's NULL mask (0 = none): 1 + its rank
    among the aggregates that have an input."""
    bits, j = [], 0
    for agg in spec.aggs:
        if agg.input is None:
            bits.append(0)
        else:
            j += 1
            bits.append(j)
    return bits


_DTYPE = {np.dtype(np.int8): torch.int8, np.dtype(np.int32): torch.int32,
          np.dtype(np.float32): torch.float32}


def _check_arena(spec: SessionSpec, arena, cap: int, device) -> None:
    """The planes the kernels will index: exactly the spec's, each a
    contiguous [cap, ...] tensor of the spec's dtype and row width on
    `device`."""
    want = session_plane_np(spec, 1)
    if set(arena) != set(want):
        raise ValueError(f"session arena planes {sorted(arena)} are not "
                         f"the spec's {sorted(want)}")
    for k, v in arena.items():
        w = want[k]
        if (v.device != device or not v.is_contiguous()
                or tuple(v.shape) != (cap,) + w.shape[1:]
                or v.dtype != _DTYPE[w.dtype]):
            raise ValueError(f"session arena plane {k}: not a contiguous "
                             f"{_DTYPE[w.dtype]} [{cap}, "
                             f"{list(w.shape[1:])}] tensor on {device}")


def _session_args(spec: SessionSpec, arena, out, nb: int, mode: int,
                  gap: int, close_cut: int, delta: int) -> kb.SessionArgs:
    cap = arena["code"].shape[0]
    dev = arena["code"].device
    _check_arena(spec, arena, cap, dev)
    _check_arena(spec, out, cap, dev)
    owners = _owners(spec)
    if len(owners) > kb.MAX_AGGS:
        raise ValueError(f"more than {kb.MAX_AGGS} session planes")
    a = kb.SessionArgs()
    a.cap, a.nb, a.mode = cap, nb, mode
    a.gap, a.close_cut, a.delta = int(gap), int(close_cut), int(delta)
    a.hll_p = spec.hll.precision
    a.q_min, a.q_gamma = spec.qcfg.min_value, spec.qcfg.gamma_log
    a.code, a.t0, a.t1 = (kb.ptr(arena[k]) for k in ("code", "t0", "t1"))
    a.out_code, a.out_t0, a.out_t1 = (kb.ptr(out[k])
                                      for k in ("code", "t0", "t1"))
    for q, (_i, name, agg) in enumerate(owners):
        p = a.p[q]
        p.kind = _KERNEL_KIND[agg.kind]
        p.width = (spec.hll.m if agg.kind == AggKind.APPROX_COUNT_DISTINCT
                   else spec.qcfg.n_bins
                   if agg.kind == AggKind.APPROX_QUANTILE else 1)
        p.src, p.out = kb.ptr(arena[name]), kb.ptr(out[name])
        if agg.kind == AggKind.AVG:
            p.src_n, p.out_n = (kb.ptr(arena[name + "_n"]),
                                kb.ptr(out[name + "_n"]))
    a.n_planes = len(owners)
    return a


def _launch_session(fn: str, a: kb.SessionArgs, dev) -> None:
    lib = kb.lib()
    scratch = torch.empty(lib.hs_session_scratch_bytes(a.cap, a.nb),
                          dtype=torch.uint8, device=dev)
    a.scratch = scratch.data_ptr()
    kb.check(getattr(lib, fn)(ctypes.byref(a), kb.stream_of(scratch)), fn)


def session_step(spec: SessionSpec, arena: Mapping[str, torch.Tensor],
                 out: dict[str, torch.Tensor], packed: torch.Tensor,
                 inputs, gap: int, close_cut: int, delta: int) -> None:
    """One record-mode micro-batch: fold the old `arena` and the packed
    batch (int32 [3 + n_cols, B]; `inputs` from session_inputs) into the
    fresh arena `out`, whose old contents are ignored. The session step
    kernel on the card (its sort passes, scan, init, folds and scatter on
    one stream, no sync), session_step_ref on the CPU."""
    if packed.device.type == "cpu":
        session_step_ref(spec, arena, out, packed, inputs, gap, close_cut,
                         delta)
        return
    if packed.dtype != torch.int32 or packed.dim() != 2 \
            or packed.shape[0] < 3:
        raise ValueError("session_step: packed must be int32 [3 + cols, B]")
    nb = packed.shape[1]
    a = _session_args(spec, arena, out, nb, kb.SESS_RECORD, gap, close_cut,
                      delta)
    a.b_code, a.b_t0, a.b_t1, a.b_flags = (kb.ptr(packed[0]),
                                           kb.ptr(packed[1]),
                                           kb.ptr(packed[1]),
                                           kb.ptr(packed[2]))
    bits = _null_bits(spec)
    for q, (i, _name, agg) in enumerate(_owners(spec)):
        if agg.kind == AggKind.COUNT_ALL:
            continue
        v = inputs[i]
        if v is None or v.dtype not in kb.VTYPES or v.shape != (nb,):
            raise ValueError(f"session_step: bad input for aggregate {i}")
        a.p[q].vtype, a.p[q].values = kb.VTYPES[v.dtype], kb.ptr(v)
        a.p[q].null_bit = bits[i]
    _launch_session("hs_session_step", a, packed.device)
    session_step.launches += 1


session_step.launches = 0  # wrapper calls that launched the kernels


def session_merge(spec: SessionSpec, arena: Mapping[str, torch.Tensor],
                  out: dict[str, torch.Tensor],
                  seg: Mapping[str, torch.Tensor], gap: int, close_cut: int,
                  delta: int) -> None:
    """One segment-mode micro-batch: fold the old `arena` and the segment
    planes `seg` (the arena's planes, [n_seg, ...]) into the fresh arena
    `out`. The session merge kernel on the card, session_merge_ref on
    the CPU."""
    if seg["code"].device.type == "cpu":
        session_merge_ref(spec, arena, out, seg, gap, close_cut, delta)
        return
    ns = seg["code"].shape[0]
    a = _session_args(spec, arena, out, ns, kb.SESS_SEGMENT, gap, close_cut,
                      delta)
    _check_arena(spec, seg, ns, arena["code"].device)
    a.b_code, a.b_t0, a.b_t1 = (kb.ptr(seg[k]) for k in ("code", "t0", "t1"))
    for q, (_i, name, agg) in enumerate(_owners(spec)):
        a.p[q].seg = kb.ptr(seg[name])
        if agg.kind == AggKind.AVG:
            a.p[q].seg_n = kb.ptr(seg[name + "_n"])
    _launch_session("hs_session_merge", a, seg["code"].device)
    session_merge.launches += 1


session_merge.launches = 0  # wrapper calls that launched the kernels


def session_extract(spec: SessionSpec, arena: Mapping[str, torch.Tensor],
                    slots: np.ndarray) -> torch.Tensor:
    """Finalize the arena slots named by the host vector `slots` (int32,
    < 0 = padding) into one int32 buffer [1 + n_aggs, P] on the arena's
    device, read-only: the session extract kernel on the card,
    session_extract_ref on the CPU."""
    cap = arena["code"].shape[0]
    slots = np.asarray(slots, np.int32)
    if (slots >= cap).any():
        raise ValueError("session_extract: slot index out of range")
    dev = arena["code"].device
    if dev.type == "cpu":
        return session_extract_ref(spec, arena, torch.from_numpy(slots))
    if spec.hll.precision < 2 or len(spec.aggs) > kb.MAX_AGGS:
        raise ValueError("session_extract: unsupported spec")
    _check_arena(spec, arena, cap, dev)
    a = kb.SessExtractArgs()
    a.cap, a.n_sel = cap, len(slots)
    # the vector up to its last named slot (the kernel takes what lies
    # past it as pads): by value in the kernel's parameters where it
    # fits, so nothing is copied before the launch; else uploaded
    named = np.flatnonzero(slots >= 0)
    a.n_live = int(named[-1]) + 1 if len(named) else 0
    if a.n_live <= kb.SESS_INLINE:
        head = np.ascontiguousarray(slots[:a.n_live])
        ctypes.memmove(ctypes.addressof(a) + kb.SessExtractArgs.sel.offset,
                       head.ctypes.data, head.nbytes)
    else:
        slots_t = torch.from_numpy(slots[:a.n_live]).to(dev)
        a.slots = kb.ptr(slots_t)
    a.code = kb.ptr(arena["code"])
    out = torch.empty((1 + len(spec.aggs), len(slots)), dtype=torch.int32,
                      device=dev)
    a.out = out.data_ptr()
    f = a.f
    m = spec.hll.m
    f.hll_p, f.hll_am2 = spec.hll.precision, _alpha(m) * m * m
    q = spec.qcfg
    f.q_min, f.q_gamma, f.q_half_gamma = (q.min_value, q.gamma_log,
                                          0.5 * q.gamma_log)
    for g, (name, agg) in enumerate(zip(session_plane_names(spec),
                                        spec.aggs)):
        fa = f.a[g]
        fa.kind, fa.width = _KERNEL_KIND[agg.kind], 1
        fa.plane_width = (m if agg.kind == AggKind.APPROX_COUNT_DISTINCT
                          else q.n_bins
                          if agg.kind == AggKind.APPROX_QUANTILE else 1)
        fa.q = agg.quantile or 0.5
        fa.row = g
        fa.plane = kb.ptr(arena[name])
        if agg.kind == AggKind.AVG:
            fa.plane_n = kb.ptr(arena[name + "_n"])
    f.n_aggs = len(spec.aggs)
    kb.check(kb.lib().hs_session_extract(ctypes.byref(a), kb.stream_of(out)),
             "session_extract")
    session_extract.launches += 1
    return out


session_extract.launches = 0  # wrapper calls that launched the kernel


def session_remap(arena: dict[str, torch.Tensor], lut: torch.Tensor,
                  sent_above: bool = False) -> None:
    """Remap the arena's codes through `lut` (int32 [lcap], on the arena's
    device), in place; with `sent_above`, codes at or above lcap become
    the sentinel (the interval join's stores). The remap kernel on the
    card, session_remap_ref on the CPU."""
    code = arena["code"]
    if lut.dtype != torch.int32 or lut.device != code.device:
        raise ValueError("session_remap: lut must be int32 on the arena's "
                         "device")
    if code.device.type == "cpu":
        session_remap_ref(arena, lut, sent_above)
        return
    kb.check(kb.lib().hs_session_remap(kb.ptr(code), code.shape[0],
                                       kb.ptr(lut), lut.shape[0],
                                       int(sent_above), kb.stream_of(code)),
             "session_remap")
    session_remap.launches += 1


session_remap.launches = 0  # wrapper calls that launched the kernel
